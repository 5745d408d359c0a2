"""The dd tier's CUDA kernels (csrc/dd_kernels.cu) and the dd engine on
the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dd.py

Tolerance: none.  Each dd kernel computes in the operation order of
ops/dd.py with intrinsics nvcc does not contract, and eager torch rounds
every operation once, so a kernel equals its plain version on the card bit
for bit, hi and lo."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dd_kernel_cases as cases  # noqa: E402  (tests/dd_kernel_cases.py)
from dd_kernel_cases import bits_same as _bits_same, pair as _pair  # noqa: E402
from ttcross_tpu_torch.ops import kernels as K  # noqa: E402
from ttcross_tpu_torch.ops.dd import DD  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(4321)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _views(kind, x, y, B, T, R, N):
    """x, y (B, T) views of the dd engine's passes: a lottery (both
    gathered), a column pass (y a broadcast vector), a row pass (x a
    broadcast vector, y the transposed row factor (T, N, R) of B = N R)."""
    if kind == "col":
        y = DD(*(p[0].expand(B, T) for p in y))
    elif kind == "row":
        x = DD(*(p[0].expand(B, T) for p in x))
        y = DD(*(p.reshape(T, N * R)[:, :B].T for p in y))
    return x, y


@pytest.mark.parametrize("kind,B,T,N", [("lottery", 226, 48, 65), ("col", 3120, 48, 65),
                                        ("row", 3120, 48, 65), ("lottery", 98, 16, 33),
                                        ("col", 528, 16, 33), ("row", 528, 16, 33),
                                        ("col", 9000, 8, 17)])
@pytest.mark.parametrize("rank_frac", [0.0, 0.5, 1.0])
def test_dd_score_kernel_matches_plain(kind, B, T, N, rank_frac, gen, cuda_device):
    R = T
    x = _pair(gen, (B, T), cuda_device)
    y = _pair(gen, (T, N, R) if kind == "row" else (B, T), cuda_device)
    x, y = _views(kind, x, y, B, T, R, N)
    vals = _pair(gen, (B,), cuda_device)
    mask = torch.as_tensor(gen.random(B) > 0.3).to(cuda_device)
    rank = torch.tensor([int(rank_frac * T)], dtype=torch.int32, device=cuda_device)
    side = K.MASK_Y if kind == "col" else K.MASK_X
    n0 = K.dd_score_residual_argmax.launches
    got = K.dd_score_residual_argmax(vals, x, y, rank, mask, side)
    want = K.dd_score_residual_argmax_plain(vals, x, y, rank, mask, side)
    torch.cuda.synchronize()
    assert K.dd_score_residual_argmax.launches == n0 + 1
    assert _same(got[0], want[0])
    assert int(got[1]) == int(want[1])
    assert _same(got[2], want[2])


def test_dd_score_kernel_ties_and_empty_mask(gen, cuda_device):
    """Equal scores in different blocks: the smaller index wins; no mask
    (the accept's products): flat 0, r the sum itself."""
    B, T = 5000, 8
    x = _pair(gen, (B, T), cuda_device)
    y = DD(torch.zeros(B, T, dtype=torch.float64, device=cuda_device),
           torch.zeros(B, T, dtype=torch.float64, device=cuda_device))
    vals = DD(torch.ones(B, dtype=torch.float64, device=cuda_device),
              torch.zeros(B, dtype=torch.float64, device=cuda_device))
    vals.hi[[300, 2600, 4999]] = 7.0
    mask = torch.ones(B, dtype=torch.bool, device=cuda_device)
    r, flat, best = K.dd_score_residual_argmax(vals, x, y, None, mask, K.MASK_NONE)
    assert int(flat) == 300 and float(best.hi) == 7.0
    mask[:] = False
    r, flat, _ = K.dd_score_residual_argmax(vals, x, y, None, mask, K.MASK_NONE)
    want = K.dd_score_residual_argmax_plain(vals, x, y, None, mask, K.MASK_NONE)
    assert int(flat) == int(want[1]) == 0 and _same(r, want[0])
    r, flat, _ = K.dd_score_residual_argmax(None, x, _pair(gen, (B, T), cuda_device), None, None)
    assert int(flat) == 0


# D1's other plans (K.planned), (P rows a block, C
# terms a chunk): one row a block (all terms in one chunk, chunks of 5),
# several (P = 3: a last block partly empty; chunks longer than a producer
# pass loads), 8, 16 and 32
D1_PLANS = [(1, 896), (1, 5), (3, 74), (3, 300), (8, 112), (16, 14), (32, 7), (32, 28)]


def _d1_layout(kind, B, T, gen, dev):
    """(vals, x, y, rank, mask, side) as the dd engine gives D1: the lottery
    (y the transposed gathered columns), a column pass, a row pass, the
    accept's products (no vals, mask or rank)."""
    vals = _pair(gen, (B,), dev)
    mask = torch.as_tensor(gen.random(B) > 0.3).to(dev)
    rank = torch.tensor([max(T - 2, 0)], dtype=torch.int32, device=dev)
    x = _pair(gen, (B, T), dev)
    yt = DD(*(p.T for p in _pair(gen, (T, B), dev)))
    vec = _pair(gen, (T,), dev)
    if kind == "lottery":
        return vals, x, yt, rank, mask, K.MASK_X
    if kind == "col":
        return vals, x, DD(*(p.expand(B, T) for p in vec)), rank, mask, K.MASK_Y
    if kind == "row":
        return vals, DD(*(p.expand(B, T) for p in vec)), yt, rank, mask, K.MASK_X
    return None, x, yt, None, None, K.MASK_NONE


@pytest.mark.parametrize("B,T", [(3120, 48), (226, 48), (48, 48), (2080, 32), (194, 32),
                                 (32, 32), (528, 16), (98, 16), (16, 16), (1, 48)])
@pytest.mark.parametrize("kind", ["lottery", "col", "row", "products"])
def test_dd_score_every_plan(B, T, kind, gen, cuda_device):
    """D1 bit-equal to its plain version at the dd paths' shapes in each
    layout, in its own plan and in every other (hi, lo, the index, r at
    it)."""
    args = _d1_layout(kind, B, T, gen, cuda_device)
    want = K.dd_score_residual_argmax_plain(*args)
    for plan in [None] + D1_PLANS:
        got = (K.dd_score_residual_argmax(*args) if plan is None
               else K.planned(K.dd_score_residual_argmax, plan, *args))
        assert _same(got[0], want[0]) and int(got[1]) == int(want[1]), plan
        assert _same(got[2], want[2]), plan


def test_dd_score_plan_is_the_shape_s(cuda_device):
    """D1's launch at the paths' shapes (csrc/dd_kernels.cu::score_plan)."""
    assert K.dd_score_plan(3120, 48) == K.DdScorePlan(16, 48, 256, 195, 25088)
    assert K.dd_score_plan(226, 48)[:2] == (8, 48)
    assert K.dd_score_plan(32, 32)[:4] == (32, 28, 256, 1)


def test_dd_score_repeats_without_state(gen, cuda_device):
    """Back-to-back launches on one stream, of several blocks, each with
    its own scratch: the same result every time (the last block's counter
    is zeroed per launch, so no launch sees another's count)."""
    args = _d1_layout("col", 3120, 48, gen, cuda_device)
    first = K.dd_score_residual_argmax(*args)
    for _ in range(20):
        got = K.dd_score_residual_argmax(*args)
        assert _same(got[0], first[0]) and int(got[1]) == int(first[1])


def _d4_layout(layout, M, N, T, gen, dev):
    return cases.d4_operands(gen, layout, M, N, T, dev)


@pytest.mark.parametrize("M,N,T,layout", [(48, 65, 48, "mm"), (65, 48, 48, "mm"),
                                          (48, 3120, 48, "mm"), (3120, 48, 48, "mm"),
                                          (48, 48, 65, "value"), (1, 48, 48, "mm"),
                                          (16, 33, 16, "mm"), (1, 48, 48, "pairs"),
                                          (1, 16, 1, "pairs"), (32, 2080, 32, "strided")])
def test_dd_dot_kernel_matches_plain(M, N, T, layout, gen, cuda_device):
    x, y = _d4_layout(layout, M, N, T, gen, cuda_device)
    got, want = K.dd_dot(x, y), K.dd_dot_plain(x, y)
    assert _same(got, want)


# D4's regimes (K.planned), (regime, P, C): a thread per output in
# blocks of 256 and 64; the chain with 1 output a block (one chunk, chunks
# of 5), 3 (a last block partly empty), 8, 16 and 32
D4_PLANS = [("thread", 256, 0), ("thread", 64, 0), ("chain", 1, 896), ("chain", 1, 5),
            ("chain", 3, 74), ("chain", 8, 112), ("chain", 16, 56), ("chain", 32, 7),
            ("chain", 32, 28)]


@pytest.mark.parametrize("M,N,T", [(48, 65, 48), (65, 48, 48), (48, 3120, 48), (48, 48, 65),
                                   (1, 48, 48), (32, 65, 32), (65, 32, 32), (32, 2080, 32),
                                   (1, 16, 1), (16, 33, 16), (5, 7, 0)])
@pytest.mark.parametrize("layout", ["mm", "value", "strided"])
def test_dd_dot_every_regime(M, N, T, layout, gen, cuda_device):
    """D4 bit-equal to its plain version at the dd paths' shapes in each
    caller's layout, in its own regime and in every other plan."""
    x, y = _d4_layout(layout, M, N, T, gen, cuda_device)
    want = K.dd_dot_plain(x, y)
    for plan in [None] + D4_PLANS:
        got = K.dd_dot(x, y) if plan is None else K.planned(K.dd_dot, plan, x, y)
        assert _bits_same(got, want), plan


def test_dd_dot_plan_is_the_shape_s(cuda_device):
    """D4's launch at the paths' shapes (csrc/dd_kernels.cu::dot_plan)."""
    assert K.dd_dot_plan(48, 65, 48) == K.DdDotPlan("chain", 8, 28, 256, 390, 7936)
    assert K.dd_dot_plan(48, 3120, 48).regime == "thread"
    assert K.dd_dot_plan(1, 16, 1).regime == "thread"


def test_dd_dot_repeats_without_state(gen, cuda_device):
    """Back-to-back launches in each regime: the same result every time."""
    x, y = _d4_layout("mm", 48, 65, 48, gen, cuda_device)
    first = K.dd_dot(x, y)
    for _ in range(10):
        for plan in [None] + D4_PLANS:
            got = K.dd_dot(x, y) if plan is None else K.planned(K.dd_dot, plan, x, y)
            assert _same(got, first), plan


def test_dd_dot_special_values(gen, cuda_device):
    """Signed zeros, subnormals, inf, NaN and 2^+-1000 (a row of -0: +0
    after the scan's first add), in every regime."""
    x, y = cases.d4_specials(gen, cuda_device)
    want = K.dd_dot_plain(x, y)
    assert torch.isnan(want.hi).any() and (want.hi == 0).any()
    for plan in [None] + D4_PLANS:
        got = K.dd_dot(x, y) if plan is None else K.planned(K.dd_dot, plan, x, y)
        assert _bits_same(got, want), plan


def _d3_train(gen, ranks, n, dev, R=None, N=None):
    return cases.train(gen, ranks, n, dev, R, N)


@pytest.mark.parametrize("B,ranks,n", [(1560, (1, 24, 32, 32, 24, 1), 65),
                                       (3120, (1, 32, 32, 32, 32, 1), 65),
                                       (226, (1, 8, 8, 1), 17), (500, (1, 48, 64, 48, 1), 33)])
def test_dd_gather_tt_kernel_matches_plain(B, ranks, n, gen, cuda_device):
    packed = _d3_train(gen, ranks, n, cuda_device)
    ind = torch.as_tensor(gen.integers(0, n, (B, len(ranks) - 1)), dtype=torch.int32)
    ind = ind.to(cuda_device)
    got = K.dd_gather_tt_fused(packed, ind)
    want = K.dd_gather_tt_plain(packed, ind)
    assert _same(got, want)


# D3's plans (K.planned), (rows, threads) a block: one row (its
# lanes; more threads, idle), several (a last block partly empty), those a
# block can have at the train's rank
D3_PLANS = [(1, 32), (1, 256), (2, 64), (2, 256), (3, 96), (4, 128), (8, 256)]


def _every_plan(packed, ind):
    """(plan, D3's result) in its own plan (None) and in each of D3_PLANS
    that it takes for these rows of the train (it refuses the others)."""
    yield None, K.dd_gather_tt_fused(packed, ind)
    for plan in D3_PLANS:
        try:
            yield plan, K.planned(K.dd_gather_tt_fused, plan, packed, ind)
        except ValueError:      # a plan D3 does not take at this shape
            continue


@pytest.mark.parametrize("B,ranks,n", [(3120, (1, 16, 32, 32, 16, 1), 65),
                                       (226, (1, 16, 32, 32, 16, 1), 65),
                                       (520, (1, 16, 32, 32, 16, 1), 65),
                                       (325, (1, 16, 32, 32, 16, 1), 65),
                                       (390, (1, 1, 1, 1, 1), 65), (142, (1, 1, 1, 1, 1), 65),
                                       (61, (1, 5, 7, 3, 1), 33), (37, (1, 48, 64, 48, 1), 33)])
def test_dd_gather_every_plan(B, ranks, n, gen, cuda_device):
    """D3 bit-equal to its plain version at the defect's shapes, in its own
    plan and in every other that fits."""
    packed = _d3_train(gen, ranks, n, cuda_device)
    ind = torch.as_tensor(gen.integers(0, n, (B, len(ranks) - 1)), dtype=torch.int32)
    ind = ind.to(cuda_device)
    want = K.dd_gather_tt_plain(packed, ind)
    for plan, got in _every_plan(packed, ind):
        assert _same(got, want), plan


def test_dd_gather_padding_clamp_and_specials(gen, cuda_device):
    """A train packed with a larger rank and mode than its own (the padding
    never read); indices outside [0, N) clamped; signed zeros, subnormals,
    2^+-1000, inf and NaN in the cores."""
    packed = _d3_train(gen, (1, 7, 12, 5, 1), 17, cuda_device, R=32, N=20)
    ind = torch.as_tensor(gen.integers(0, 17, (300, 4)), dtype=torch.int32).to(cuda_device)
    want = K.dd_gather_tt_plain(packed, ind)
    for plan, got in _every_plan(packed, ind):
        assert _same(got, want), plan
    packed = cases.d3_specials(gen, cuda_device)
    ind = torch.as_tensor(gen.integers(-20, 30, (400, 4)), dtype=torch.int32).to(cuda_device)
    want = K.dd_gather_tt_plain(packed, ind.clamp(0, 6))
    assert torch.isnan(want.hi).any() and (want.hi == 0).any()
    for plan, got in _every_plan(packed, ind):
        assert _bits_same(got, want), plan


def test_dd_gather_plan_and_repeats(gen, cuda_device):
    """D3's launch at the defect's shapes (csrc/dd_kernels.cu::gather_plan)
    and back-to-back launches with the same result."""
    assert K.dd_gather_plan(3120, 5, 32, 65)[:2] == (8, 256)
    assert K.dd_gather_plan(390, 4, 1, 65)[:2] == (3, 32)
    packed = _d3_train(gen, (1, 16, 32, 32, 16, 1), 65, cuda_device)
    ind = torch.as_tensor(gen.integers(0, 65, (3120, 5)), dtype=torch.int32).to(cuda_device)
    first = K.dd_gather_tt_fused(packed, ind)
    for _ in range(10):
        assert _same(K.dd_gather_tt_fused(packed, ind), first)


@pytest.mark.parametrize("B,d,n", [(3120, 5, 65), (226, 5, 65), (2080, 3, 65), (98, 3, 33),
                                   (136, 3, 17), (1, 8, 17), (500, 15, 17), (70, 31, 33),
                                   (83, 1, 65), (83, 2, 65)])
def test_dd_ising_kernel_matches_plain(B, d, n, gen, cuda_device):
    """D2 in its own plan and in every other, the indices drawn from [-2, n
    + 2) (clamped), bit for bit against the plain version."""
    from ttcross_tpu_torch.apps.ising import make_ising_dd

    _, fun_dd, _, _ = make_ising_dd(m=d + 1, n=n, device=cuda_device)
    tables = fun_dd.tables
    ind = torch.as_tensor(gen.integers(-2, tables.shape[1] + 2, (B, d)), dtype=torch.int32)
    ind = ind.to(cuda_device)
    want = K.ising_c_integrand_dd_plain(tables, ind)
    assert _same(K.ising_c_integrand_dd_fused(tables, ind), want)
    for plan in cases.ROWS_PLANS:
        assert _same(K.planned(K.ising_c_integrand_dd_fused, plan, tables, ind), want), plan
    specials = cases.strew(gen, tables.clone())
    want = K.ising_c_integrand_dd_plain(specials, ind)
    for plan in [None] + cases.ROWS_PLANS:
        got = (K.ising_c_integrand_dd_fused(specials, ind) if plan is None
               else K.planned(K.ising_c_integrand_dd_fused, plan, specials, ind))
        assert _bits_same(got, want), plan


def test_dd_ising_plan(cuda_device):
    """D2's launch at the dd paths' shapes (csrc/ising_rows.cuh::rows_plan)."""
    assert K.ising_c_dd_plan(3120, 5, 65)[:3] == (40, 128, 78)
    assert K.ising_c_dd_plan(226, 5, 65)[:3] == (40, 128, 6)
    tables = torch.zeros((4, 65), dtype=torch.float64, device=cuda_device)
    rows = torch.zeros((10, 3), dtype=torch.int32, device=cuda_device)
    for plan in cases.ROWS_PLANS:     # D2 takes each (it refuses a plan with ValueError)
        K.planned(K.ising_c_integrand_dd_fused, plan, tables, rows)


def test_dd_contract_card_equals_cpu(gen, cuda_device):
    """dd_contract (two launches of D4 per core on the card) against its
    CPU run, the plain dd operations: bit for bit."""
    from ttcross_tpu_torch.ops.dd import dd_contract
    from ttcross_tpu_torch.tt.types import TT

    ranks, n = (1, 24, 48, 32, 1), 65
    cores = [gen.standard_normal((ranks[c], n, ranks[c + 1])) for c in range(len(ranks) - 1)]
    wh = [gen.random(n) for _ in cores]
    wl = [w * gen.standard_normal(n) * 2.0 ** -54 for w in wh]
    got = dd_contract(TT(tuple(torch.as_tensor(g).to(cuda_device) for g in cores)), wh, wl)
    want = dd_contract(TT(tuple(torch.as_tensor(g) for g in cores)), wh, wl)
    assert (float(got.hi), float(got.lo)) == (float(want.hi), float(want.lo))


def test_dd_kernels_refuse_wrong_input(gen, cuda_device):
    x = _pair(gen, (10, 4), cuda_device)
    with pytest.raises(ValueError):
        K.dd_score_residual_argmax(None, x, _pair(gen, (11, 4), cuda_device))
    with pytest.raises(TypeError):
        K.dd_dot(DD(*(p.float()[None] for p in x)), DD(*(p.float()[None] for p in x)))
    with pytest.raises(ValueError):
        K.ising_c_integrand_dd_fused(torch.zeros((2, 5), dtype=torch.float64, device=cuda_device),
                                     torch.zeros((3, 2), dtype=torch.int32, device=cuda_device))
    tables = torch.zeros((4, 5), dtype=torch.float64, device=cuda_device)
    rows = torch.zeros((10, 3), dtype=torch.int32, device=cuda_device)
    for plan in [0, -1, 41, 129]:
        with pytest.raises(ValueError):
            K.planned(K.ising_c_integrand_dd_fused, plan, tables, rows)
    with pytest.raises(TypeError):
        K.ising_c_integrand_dd_fused(tables, rows.long())
    xd, yd = _d4_layout("mm", 4, 5, 6, gen, cuda_device)
    for plan in [("chain", 33, 4), ("chain", 4, 0), ("thread", 48, 0), ("thread", 512, 0)]:
        with pytest.raises(ValueError):
            K.planned(K.dd_dot, plan, xd, yd)
    with pytest.raises(ValueError):
        K.dd_dot(xd, DD(*(p[:, :4] for p in yd)))
    packed = _d3_train(gen, (1, 3, 1), 5, cuda_device)
    ind = torch.zeros((10, 2), dtype=torch.int32, device=cuda_device)
    for plan in [(0, 64), (1, 16), (1, 512), (1, 48), (16, 32)]:
        with pytest.raises(ValueError):
            K.planned(K.dd_gather_tt_fused, plan, packed, ind)
    with pytest.raises(TypeError):
        K.dd_gather_tt_fused(packed, ind.long())
    with pytest.raises(ValueError):
        K.dd_gather_tt_fused(packed, ind[:, :1].contiguous())
    with pytest.raises(ValueError):
        K.dd_gather_tt_fused(_d3_train(gen, (1, 65, 1), 3, cuda_device),
                             torch.zeros((4, 2), dtype=torch.int32, device=cuda_device))


def test_cross_dd_card_equals_cpu(cuda_device):
    """cross_dd at C_4, n = 17, rank 8 on the card and on the CPU with the
    same key: the same draws, eager dd operations rounded once on both and
    kernels equal to their plain versions, so the value, the pivots, the
    ranks and the dd cores agree bit for bit."""
    from ttcross_tpu_torch.apps.ising import make_ising_dd
    from ttcross_tpu_torch.cross import cross_dd

    runs = []
    for where in (cuda_device, "cpu"):
        prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device=where)
        runs.append(cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8, pivoting=1,
                             device=where))
    card, cpu = runs
    assert card.value == cpu.value and card.ranks == cpu.ranks and card.neval == cpu.neval
    assert np.array_equal(card.vip, cpu.vip)
    for a, b in zip(card.cores_hi + card.cores_lo, cpu.cores_hi + cpu.cores_lo):
        assert np.array_equal(a, b)


def test_dd_sweeps_make_no_host_sync(cuda_device):
    """Two dd sweeps and a call of the defect's integrand under torch's sync
    debug mode set to raise: the lottery's integers, the pivot indices and
    the accept stay on the card (chip_smoke.py phase 15 runs the same)."""
    import chip_smoke

    row = chip_smoke.dd_sweeps_without_sync(cuda_device)
    assert row["sync_free_sweeps"] == 2 and row["ranks"][1] > 1
