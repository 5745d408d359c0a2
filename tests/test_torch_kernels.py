"""The port's two kernels (ttcross_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels and references.

On the CPU the wrappers run their plain PyTorch versions; the kernels
themselves are held against those on the card by tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.ops.dense import _f32_split3, _pow2_rescale
from ttcross_tpu.ops.pallas_kernels import (score_residual_argmax_ref,
                                            small_table_lookup_limbs)
from ttcross_tpu_torch.ops import kernels as K

# f64 sums are taken in another order (Eigen vs torch matmul), so scores
# agree to a few ulps
SCORE_RTOL = 1e-13


def _score_case(name, rng):
    if name == "random":
        M, Kc, R = 48, 80, 6
        mask = rng.random((M, Kc)) > 0.2
    elif name == "col_fiber":
        M, Kc, R = 130, 1, 5
        mask = rng.random((M, Kc)) > 0.3
    elif name == "row_fiber":
        M, Kc, R = 1, 130, 5
        mask = rng.random((M, Kc)) > 0.3
    elif name == "one_entry":
        M, Kc, R = 20, 30, 4
        mask = np.zeros((M, Kc), bool)
        mask[13, 7] = True
    vals = rng.standard_normal((M, Kc))
    colf = rng.standard_normal((M, R))
    rowf = rng.standard_normal((R, Kc))
    return vals, colf, rowf, mask


def _plain(vals, colf, rowf, mask):
    return K.score_residual_argmax_plain(*map(torch.as_tensor, (vals, colf, rowf, mask)))


def _jax_ref(vals, colf, rowf, mask):
    flat, score = score_residual_argmax_ref(jnp.asarray(vals), jnp.asarray(colf),
                                            jnp.asarray(rowf), jnp.asarray(mask))
    return int(flat), float(score)


@pytest.mark.parametrize("case", ["random", "col_fiber", "row_fiber", "one_entry"])
def test_score_plain_matches_jax_ref(case, rng):
    args = _score_case(case, rng)
    flat, score, resid = _plain(*args)
    jflat, jscore = _jax_ref(*args)
    assert int(flat) == jflat
    np.testing.assert_allclose(float(score), jscore, rtol=SCORE_RTOL)
    vals, colf, rowf, _ = args
    want = (vals - colf @ rowf).reshape(-1)[jflat]
    np.testing.assert_allclose(float(resid), want, rtol=SCORE_RTOL)
    if case == "one_entry":
        assert jflat == 13 * 30 + 7


def test_score_tie_takes_first_index():
    M, Kc, R = 6, 7, 2
    vals = np.zeros((M, Kc))
    vals[1, 3] = -5.0
    vals[4, 0] = 5.0
    vals[0, 6] = 5.0            # the first of three tied maxima
    args = (vals, np.zeros((M, R)), np.zeros((R, Kc)), np.ones((M, Kc), bool))
    flat, score, resid = _plain(*args)
    assert int(flat) == _jax_ref(*args)[0] == 6
    assert float(score) == 5.0 and float(resid) == 5.0


def test_score_nan_ranks_first():
    M, Kc, R = 5, 4, 2
    vals = np.arange(M * Kc, dtype=float).reshape(M, Kc)
    vals[2, 1] = np.nan
    vals[3, 3] = np.nan
    args = (vals, np.zeros((M, R)), np.zeros((R, Kc)), np.ones((M, Kc), bool))
    flat, score, _ = _plain(*args)
    assert int(flat) == _jax_ref(*args)[0] == 2 * Kc + 1
    assert np.isnan(float(score))


def _lookup_case(rng, n=7, B=13, d=5):
    table = rng.standard_normal((2, n)) * 1e3
    ind = rng.integers(-2, n + 3, size=(B, d)).astype(np.int32)
    ind[0, :3] = (-1, n, 0)       # negative, one past the end, in range
    return table, ind


def test_lookup_plain_matches_take_fill(rng):
    """Against the CPU branch of ttcross_tpu's table_lookup.  jnp.take wraps
    negative indices NumPy-style before filling, unlike the Pallas kernel,
    so this case draws indices in [0, n + 3) only; negative indices are
    held against the Pallas kernel below."""
    table, ind = _lookup_case(rng)
    ind = np.abs(ind)
    got = K.small_table_lookup_plain(torch.from_numpy(table), torch.from_numpy(ind))
    for l in range(2):
        want = np.asarray(jnp.take(jnp.asarray(table[l]), jnp.asarray(ind), axis=0,
                                   mode="fill", fill_value=0))
        assert np.array_equal(got[l].numpy(), want)


def test_lookup_plain_matches_pallas_limbs(rng):
    """Bitwise equal to the Pallas kernel (interpret mode) recombined from
    its three f32 limbs as tests/test_pallas.py does."""
    table, ind = _lookup_case(rng)
    got = K.small_table_lookup_plain(torch.from_numpy(table), torch.from_numpy(ind))
    for l in range(2):
        tab = jnp.asarray(table[l])
        s, sinv = _pow2_rescale(tab)
        a, b, c = small_table_lookup_limbs(_f32_split3(tab * s), jnp.asarray(ind),
                                           interpret=True)
        want = (a.astype(jnp.float64) + b.astype(jnp.float64)
                + c.astype(jnp.float64)) * sinv
        assert np.array_equal(got[l].numpy(), np.asarray(want))


def test_cpu_wrappers_take_the_plain_path(rng):
    K.reset_launch_counts()
    table, ind = _lookup_case(rng)
    out = K.small_table_lookup(torch.from_numpy(table), torch.from_numpy(ind))
    assert out.shape == (2,) + ind.shape
    K.score_residual_argmax(*[torch.as_tensor(a) for a in _score_case("random", rng)])
    assert K.launch_counts() == {"score_residual_argmax": 0, "small_table_lookup": 0}
