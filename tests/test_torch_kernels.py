"""The port's kernels (ttcross_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels and references, and their launch plans.

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


@pytest.mark.parametrize("P,M,Kc,R", [(9, 34, 1, 4), (9, 1, 34, 4), (254, 170, 1, 10),
                                      (254, 1, 170, 10), (1, 170, 1, 10), (3, 6, 5, 2)])
def test_score_batched_plain_matches_a_loop_of_the_single_plain(P, M, Kc, R, rng):
    """Per bond the batched plain version is the single one: the same index
    and, from the same batched product, scores to a few ulps; bonds with an
    all-false mask (a red-black phase's dead parity) among them."""
    vals, colf, rowf = (torch.as_tensor(rng.standard_normal(sh))
                        for sh in ((P, M, Kc), (P, M, R), (P, R, Kc)))
    mask = torch.as_tensor(rng.random((P, M, Kc)) > 0.3)
    mask[::2] = False
    flat, score, resid = K.score_residual_argmax_batched(vals, colf, rowf, mask)
    assert flat.shape == score.shape == resid.shape == (P,) and flat.dtype == torch.int64
    for p in range(P):
        f1, s1, r1 = K.score_residual_argmax_plain(vals[p], colf[p], rowf[p], mask[p])
        assert int(flat[p]) == int(f1)
        np.testing.assert_allclose(float(score[p]), float(s1), rtol=SCORE_RTOL)
        np.testing.assert_allclose(float(resid[p]), float(r1), rtol=SCORE_RTOL, atol=1e-15)
        if p % 2 == 0:
            assert int(flat[p]) == 0 and float(score[p]) == -1.0


def test_score_batched_first_maximum_all_masked_and_nan():
    """Per bond: the first of tied maxima wins, an all-false mask gives flat
    0 and score -1 (torch.argmax of all -1) with the residual at 0, and NaN
    ranks above every number."""
    P, M, R = 4, 12, 2
    vals = np.zeros((P, M, 1))
    vals[0, [3, 7, 9], 0] = (5.0, -5.0, 5.0)           # ties: the first wins
    vals[1, :, 0] = np.arange(M) + 1.0                 # all masked below
    vals[2, [4, 8], 0] = np.nan                        # NaN first
    vals[2, 2, 0] = 9.0
    vals[3, 11, 0] = -2.0                              # the only one unmasked
    mask = np.ones((P, M, 1), bool)
    mask[1] = False
    mask[3, :11] = False
    args = [torch.as_tensor(a) for a in (vals, np.zeros((P, M, R)), np.zeros((P, R, 1)), mask)]
    flat, score, resid = K.score_residual_argmax_batched_plain(*args)
    assert flat.tolist() == [3, 0, 4, 11]
    assert score[:2].tolist() == [5.0, -1.0] and float(score[3]) == 2.0
    assert resid[:2].tolist() == [5.0, 1.0] and float(resid[3]) == -2.0
    assert torch.isnan(score[2]) and torch.isnan(resid[2])
    # the same through a row fiber's layout
    rargs = [args[0].reshape(P, 1, M), torch.zeros((P, 1, R), dtype=torch.float64),
             torch.zeros((P, R, M), dtype=torch.float64), args[3].reshape(P, 1, M)]
    assert K.score_residual_argmax_batched_plain(*rargs)[0].tolist() == [3, 0, 4, 11]


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
    vals = K.ising_integrand_fused(torch.from_numpy(np.abs(table)), torch.from_numpy(ind), "D")
    assert vals.shape == (ind.shape[0],)
    K.score_residual_argmax_batched(*[torch.as_tensor(a)[None] for a in _score_case("col_fiber", rng)])
    # the dd kernels' wrappers (csrc/dd_kernels.cu) too
    from ttcross_tpu_torch.ops.dd import DD
    from ttcross_tpu_torch.tt.types import TT

    x = DD(torch.from_numpy(rng.normal(size=(6, 4))), torch.zeros(6, 4, dtype=torch.float64))
    r, flat, _ = K.dd_score_residual_argmax(None, x, x, None, torch.ones(6, dtype=torch.bool))
    assert r.hi.shape == (6,) and 0 <= int(flat) < 6
    assert K.dd_dot(DD(x.hi[None], x.lo[None]), DD(x.hi[None], x.lo[None])).hi.shape == (1, 6)
    t = TT(tuple(torch.from_numpy(rng.normal(size=s)) for s in ((1, 5, 3), (3, 5, 1))))
    assert K.dd_gather_tt_fused(K.pack_tt(t), torch.zeros((4, 2), dtype=torch.int32)).hi.shape == (4,)
    tables = torch.from_numpy(np.abs(rng.normal(size=(4, 5))))
    assert K.ising_c_integrand_dd_fused(tables, torch.from_numpy(ind[:, :3])).hi.shape == (len(ind),)
    # and the qd kernels' wrappers (csrc/qd_kernels.cu)
    from ttcross_tpu_torch.ops.qd import QD

    q = QD(x.hi, x.lo, x.lo, x.lo)
    r, flat = K.qd_score_residual_argmax(QD(*(e[:, 0] for e in q)), q, q)
    assert r.e0.shape == (6,) and 0 <= int(flat) < 6
    assert K.qd_dot(QD(*(e[None] for e in q)), QD(*(e[None] for e in q)), True).e0.shape == (1, 6)
    assert K.qd_dot(QD(*(e[None] for e in q)), QD(*(e[None] for e in q)), False).e0.shape == (1, 6)
    assert K.qd_gather_tt_fused(K.pack_tt(t), torch.zeros((4, 2), dtype=torch.int32)).e0.shape == (4,)
    qtables = torch.cat([tables[:1], torch.zeros(3, 5, dtype=torch.float64), tables[2:3],
                         torch.zeros(3, 5, dtype=torch.float64)])
    assert K.ising_c_integrand_qd_fused(qtables, torch.from_numpy(ind[:, :3])).e0.shape == (len(ind),)
    assert K.launch_counts() == {"score_residual_argmax": 0, "score_residual_argmax_batched": 0,
                                 "small_table_lookup": 0, "ising_integrand_fused": 0,
                                 "dd_score_residual_argmax": 0, "dd_dot": 0,
                                 "dd_gather_tt_fused": 0, "ising_c_integrand_dd_fused": 0,
                                 "qd_score_residual_argmax": 0, "qd_dot": 0,
                                 "qd_gather_tt_fused": 0, "ising_c_integrand_qd_fused": 0}
    assert K.launch_shapes() == {name: {} for name in K.launch_counts()}


_SMS = 132    # an H100 SXM; the plan takes the count of the card it runs on


def _coverage(plan, M, Kc):
    """How many times the kernel's walk over the plan's blocks visits each
    element (fibers) or each tile (2-D; the tiles partition the matrix)."""
    if plan.path == K.TWO_D:
        tm, tk = plan.tile
        tiles = -(-M // tm) * -(-Kc // tk)
        seen = np.zeros(tiles, np.int64)
        for b in range(plan.blocks):
            seen[b::plan.blocks] += 1
        return seen
    length = max(M, Kc)
    per = max(plan.tile)
    tiles = -(-length // per)
    seen = np.zeros(length, np.int64)
    for rank in range(plan.cluster):
        for tile in range(rank, tiles, plan.cluster):
            seen[tile * per:(tile + 1) * per] += 1
    return seen


@pytest.mark.parametrize("M,Kc,R", [
    (1950, 1, 30), (1, 1950, 30), (1, 1, 30), (100000, 1, 30), (1, 70001, 30),
    (1950, 1950, 30), (8192, 8192, 32), (129, 257, 17), (37, 1001, 3),
    (1950, 1, 1), (1950, 1, 17), (1950, 1, 64), (1, 1950, 64),
    (2, 1950, 1), (513, 3, 64), (4096, 1, 500)])
def test_plan_covers_each_element_once_within_the_card(M, Kc, R):
    plan = K._plan(M, Kc, R, _SMS)
    fiber = M == 1 or Kc == 1
    assert plan.path == ((K.COL if Kc == 1 else K.ROW) if fiber else K.TWO_D)
    assert np.all(_coverage(plan, M, Kc) == 1)
    assert plan.smem <= K.SMEM_OPTIN - 1024      # room for the static shared memory
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert 1 <= plan.cluster <= 16      # non-portable clusters above 8
    if fiber:      # one launch: the whole grid is one cluster, one partial per warp
        assert plan.cluster == plan.blocks and plan.nparts == plan.blocks * plan.threads // 32
        assert plan.tile == ((plan.threads, 1) if Kc == 1 else (1, plan.threads))
    else:          # persistent: at most one block per SM, one partial each
        assert plan.cluster == 1 and plan.blocks <= _SMS and plan.nparts == plan.blocks
    if (M, Kc) in ((1950, 1), (1, 1950)) and R <= 64:
        assert (plan.blocks, plan.threads) == (16, 128)  # the rook passes: 16 blocks


@pytest.mark.parametrize("P,M,Kc,R", [(254, 170, 1, 10), (254, 1, 170, 10), (1022, 170, 1, 10),
                                      (1022, 1, 170, 10), (1, 170, 1, 10), (30, 102, 1, 6),
                                      (7, 1, 1300, 30), (5, 3, 1, 2), (254, 170, 1, 500)])
def test_plan_batched_is_one_block_per_bond_over_whole_tiles(P, M, Kc, R):
    """The batched path: a block per bond and no cluster, the bond's fiber
    walked in tiles of `threads` elements that shared memory holds; the
    all-bonds sweeps' fiber of 170 is one tile of 192 threads."""
    plan = K._plan(M, Kc, R, _SMS, bonds=P)
    length = max(M, Kc)
    assert plan.path == (K.BATCH_COL if Kc == 1 else K.BATCH_ROW)
    assert (plan.blocks, plan.cluster, plan.nparts) == (P, 1, 0)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.tile == ((plan.threads, 1) if Kc == 1 else (1, plan.threads))
    assert plan.smem == 8 * R + 16 + 8 * plan.threads * R <= K.SMEM_OPTIN - 1024
    tiles = -(-length // plan.threads)
    assert (tiles - 1) * plan.threads < length <= tiles * plan.threads
    if length == 170 and R == 10:
        assert plan.threads == 192 and tiles == 1
    assert K._plan(M, Kc, R, _SMS) != plan          # the single-fiber plan stays its own


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        K._plan(1950, 1, 2000, _SMS)       # 32 rows of colf exceed shared memory
    with pytest.raises(ValueError):
        K._plan(0, 5, 3, _SMS)
    with pytest.raises(ValueError, match="fibers"):
        K._plan(6, 5, 3, _SMS, bonds=4)    # the batched path takes fibers only
    with pytest.raises(ValueError):
        K._plan(170, 1, 2000, _SMS, bonds=4)


@pytest.mark.parametrize("B,d,n", [
    (1950, 5, 65), (190, 5, 65), (520, 5, 65), (325, 5, 65), (1, 1, 65), (129, 8, 17),
    (1950, 9, 65), (4097, 31, 33), (100584, 255, 33), (7, 1023, 17), (3, 1024, 2000),
    (0, 5, 65)])
def test_integrand_plan_covers_each_row_once_within_shared_memory(B, d, n):
    plan = K._integrand_plan(B, d, n)
    assert plan.path == (K.ROWS if d <= K._ROWS_D_MAX else K.WARPS)
    assert (plan.blocks - 1) * plan.rows < B <= plan.blocks * plan.rows or B == plan.blocks == 0
    assert plan.threads == (plan.rows if plan.path == K.ROWS else 32 * plan.rows)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    static = K._ROWS_STATIC_SMEM if plan.path == K.ROWS else 0
    assert 16 * n <= plan.smem and plan.smem + static <= 48 * 1024
    if plan.path == K.WARPS:   # each warp: its row's indices at any offset, and P_0..P_d
        per_warp = (plan.smem - 16 * n) // plan.rows
        assert per_warp >= 4 * (d + 3) + 8 * (d + 1) and per_warp % 16 == 0
    if (B, d) == (1950, 5):
        assert (plan.blocks, plan.threads) == (16, 128)   # the rook fiber: 16 blocks


@pytest.mark.parametrize("B,d,n", [(5, 0, 65), (5, 1025, 33), (5, 5, 3000), (5, 700, 2800)])
def test_integrand_plan_refuses_what_the_kernel_does_not_take(B, d, n):
    with pytest.raises(ValueError):
        K._integrand_plan(B, d, n)
