"""The port's Ising problem (ttcross_tpu_torch/apps) against the JAX one."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import ising as jising
from ttcross_tpu.apps.truths import ising_truth as jtruth
from ttcross_tpu_torch.apps import ising_integrand, ising_truth, make_ising
from ttcross_tpu_torch.interop import ising_from_numpy

# the products and sums run in another order (XLA vs torch reductions), so
# values agree to a few ulps per operation
RTOL = 1e-13
# except the D/E a-term at large d: a product of d(d+1)/2 ratios (820 at
# d = 40, 5050 at d = 100), each a difference of nearby prefix products
# (which JAX forms by an associative scan above d = 32), multiplied in
# another order
RTOL_ATERM_LONG = 2e-12


@pytest.mark.parametrize("kind", ["C", "D", "E"])
@pytest.mark.parametrize("B,d", [(257, 5), (64, 40), (16, 100)])
def test_integrand_matches_jax(kind, B, d, rng):
    jp = jising.make_ising(kind, m=d + 1, n=33)
    ind = rng.integers(0, jp.n, size=(B, d)).astype(np.int32)
    want = np.asarray(jising.ising_integrand(jnp.asarray(ind), jnp.asarray(jp.nodes),
                                             jnp.asarray(jp.weights), kind))
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, kind, d + 1,
                          jp.truth, "cpu")
    got = ising_integrand(torch.from_numpy(ind), tp.tables, kind).numpy()
    assert np.all(np.isfinite(want)) and np.any(want != 0)
    rtol = RTOL_ATERM_LONG if (kind != "C" and d >= 40) else RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    np.testing.assert_allclose(tp.fun(torch.from_numpy(ind)).numpy(), want,
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("kind,m,n", [("C", 6, 64), ("C", 5, 17), ("D", 12, 33),
                                      ("E", 6, 65), ("C", 40, 17)])
def test_make_ising_tables_bitwise(kind, m, n):
    jp = jising.make_ising(kind, m, n)
    tp = make_ising(kind, m, n, device="cpu")
    assert (tp.kind, tp.m, tp.d, tp.n, tp.rescale) == (jp.kind, jp.m, jp.d, jp.n, jp.rescale)
    for name in ("nodes", "weights", "quad_weights"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    assert np.array_equal(tp.tables.numpy(), np.stack([jp.nodes, jp.weights]))
    assert tp.truth == jp.truth


def test_truths_bitwise():
    keys = [("C", m) for m in (2, 3, 4, 5, 6, 8, 16, 32, 64, 128, 256, 512, 1024)]
    keys += [(k, m) for k in ("D", "E") for m in (2, 3, 4, 5, 6)]
    for kind, m in keys:
        assert ising_truth(kind, m) == jtruth(kind, m), (kind, m)
    with pytest.raises(KeyError):
        ising_truth("C", 7)
