"""The qd tier's CUDA kernels (csrc/qd_kernels.cu, Q1-Q5) on the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_qd.py

Tolerance: none.  Each qd kernel computes in the operation order of
ops/qd.py with intrinsics nvcc does not contract, and eager torch rounds
every operation once, so a kernel equals its plain version on the card bit
for bit, all four limbs (and Q2's index)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dd_kernel_cases import ROWS_PLANS  # noqa: E402  (tests/dd_kernel_cases.py)
from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.qd import QD

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(2468)


def _qd(gen, shape, dev, scale=1.0, tiny=False):
    """Random qd values with populated low limbs; tiny: e0 near 1e-300, so
    the lower limbs are subnormal."""
    e0 = gen.standard_normal(shape) * (1e-300 if tiny else scale)
    e1 = e0 * gen.standard_normal(shape) * 1e-17
    e2 = e1 * gen.standard_normal(shape) * 1e-17
    e3 = e2 * gen.standard_normal(shape) * 1e-17
    return QD(*(torch.as_tensor(e).to(dev) for e in (e0, e1, e2, e3)))


def _same(a, b):
    return all(torch.equal(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


@pytest.mark.parametrize("kind,B,T", [("lottery", 240, 55), ("col", 3575, 55), ("row", 3575, 55),
                                      ("lottery", 97, 33), ("col", 65, 7), ("row", 17, 1),
                                      ("accept", 1, 55), ("lottery", 300, 201)])
@pytest.mark.parametrize("tiny", [False, True])
def test_q2_is_its_plain_version(kind, B, T, tiny, cuda_device, gen):
    """Q2 at the qd engine's shapes and layouts: a lottery (both operands
    gathered), a column pass (y a broadcast vector), a row pass (x a
    broadcast vector, y a transposed view), a single row (B = 1)."""
    vals = _qd(gen, (B,), cuda_device, tiny=tiny)
    x = _qd(gen, (B, T), cuda_device, tiny=tiny)
    if kind in ("lottery", "accept"):
        y = _qd(gen, (B, T), cuda_device)
    elif kind == "col":
        y = QD(*(e.expand(B, T) for e in _qd(gen, (T,), cuda_device)))
    elif kind == "row":
        x = QD(*(e.expand(B, T) for e in _qd(gen, (T,), cuda_device)))
        y = QD(*(e.T for e in _qd(gen, (T, B), cuda_device, tiny=tiny)))
    r, flat = K.qd_score_residual_argmax(vals, x, y)
    want, wflat = K.qd_score_residual_argmax_plain(vals, x, y)
    assert _same(r, want)
    assert int(flat) == int(wflat)


Q2_PLANS = [("thread", 64), ("thread", 256), ("tree", 1), ("tree", 3), ("tree", 9), ("tree", 32)]


@pytest.mark.parametrize("B,T", [(3575, 54), (2080, 32), (240, 55), (404, 1), (201, 1), (1, 55),
                                 (715, 55), (30, 201)])
@pytest.mark.parametrize("kind", ["lottery", "col", "row"])
def test_q2_every_plan(B, T, kind, cuda_device, gen):
    """Q2 bit-equal to its plain version at the qd paths' shapes (C_4 rank
    55's rook fibers and lottery, two workers', stdnorm's rank 1) in each
    layout, in its own plan and in every other (four limbs and the index)."""
    vals, x = _qd(gen, (B,), cuda_device), _qd(gen, (B, T), cuda_device)
    if kind == "lottery":
        y = _qd(gen, (B, T), cuda_device)
    elif kind == "col":
        y = QD(*(e.expand(B, T) for e in _qd(gen, (T,), cuda_device)))
    else:
        x = QD(*(e.expand(B, T) for e in _qd(gen, (T,), cuda_device)))
        y = QD(*(e.T for e in _qd(gen, (T, B), cuda_device)))
    want, wflat = K.qd_score_residual_argmax_plain(vals, x, y)
    for plan in [None] + Q2_PLANS:
        r, flat = (K.qd_score_residual_argmax(vals, x, y) if plan is None
                   else K.planned(K.qd_score_residual_argmax, plan, vals, x, y))
        assert _same(r, want) and int(flat) == int(wflat), plan


def test_q2_plan_is_the_shape_s(cuda_device):
    """Q2's launch: Q4's tree rule for B outputs, one block where it holds
    every level-1 term, full blocks raised to one wave of two an SM."""
    assert K.qd_score_plan(3575, 54) == K.QdDotPlan("tree", 14, 27, 256, 256, 12096)
    assert K.qd_score_plan(404, 1)[:2] == ("tree", 4)
    assert K.qd_score_plan(201, 1)[:2] == ("tree", 201)
    assert K.qd_score_plan(1, 1 << 16).regime == "thread"


def test_q2_ties_and_nan_pick_torch_argmax(cuda_device, gen):
    """The first of equal maxima, and a NaN above every number."""
    x = _qd(gen, (600, 3), cuda_device)
    vals = QD(*(torch.zeros(600, dtype=torch.float64, device=cuda_device) for _ in range(4)))
    x = QD(*(e.clone() for e in x))
    for e in x:
        e[400] = e[7]
        e[599] = e[7]
    y = QD(*(e.clone() for e in x))
    r, flat = K.qd_score_residual_argmax(vals, x, y)
    want, wflat = K.qd_score_residual_argmax_plain(vals, x, y)
    assert _same(r, want) and int(flat) == int(wflat)
    x.e0[300] = float("nan")
    r, flat = K.qd_score_residual_argmax(vals, x, y)
    assert int(flat) == int(K.qd_score_residual_argmax_plain(vals, x, y)[1]) == 300


Q4_CASES = [(M, N, T, tree) for M, N, T in [(3575, 55, 55), (55, 3575, 55), (55, 55, 55),
                                              (1, 33, 33), (33, 33, 65), (1, 1, 201), (5, 7, 1),
                                              (4, 3, 0)]
            for tree in (False, True) if T > 0 or not tree]   # the tree takes T >= 1


@pytest.mark.parametrize("M,N,T,tree", Q4_CASES)
@pytest.mark.parametrize("tiny", [False, True])
def test_q4_is_its_plain_version(M, N, T, tree, tiny, cuda_device, gen):
    """Q4 as qd_matmul (the sequential k-loop) and as qd_vdot_axis (the
    tree), on GEMM views (a row broadcast over N, a transposed column
    broadcast over M)."""
    a = _qd(gen, (M, T), cuda_device, tiny=tiny)
    b = _qd(gen, (T, N), cuda_device)
    x = QD(*(e[:, None, :].expand(M, N, T) for e in a))
    y = QD(*(e.T[None].expand(M, N, T) for e in b))
    assert _same(K.qd_dot(x, y, tree), K.qd_dot_plain(x, y, tree))


# Q4 in each regime it can take at a shape (K.planned): a thread per
# output, 64 or 256 a block (the depth-first walk for the tree), chain warps with one output a
# block, several, and all 32, the shared tree with one output a block and with
# several; the shapes on each side of the sequential switch point
# (kChainOutputsMax = 23,552 outputs) and at it, the paths' shapes
REGIMES = {False: [("thread", 64, 0), ("thread", 256, 0), ("chain", 1, 224), ("chain", 5, 44),
                  ("chain", 32, 7)],
           True: [("thread", 64, 0), ("tree", 1, 0), ("tree", 3, 0), ("tree", 8, 0)]}
REGIME_SHAPES = [(91, 258, 55, False), (92, 256, 55, False), (93, 256, 55, False),
                 (24, 1560, 24, False), (1, 65 * 1024, 3, False),
                 (55, 65, 55, False), (33, 2145, 33, False), (1, 1, 201, False),
                 (33, 33, 33, True), (1, 1, 201, True), (1, 1, 101, True), (1, 33, 33, True),
                 (7, 9, 1000, True), (1, 1, 2, True), (4, 3, 0, False)]


@pytest.mark.parametrize("M,N,T,tree", REGIME_SHAPES)
def test_q4_every_regime(M, N, T, tree, cuda_device, gen):
    """Q4 bit-equal to its plain version in the regime its shape takes and
    in every other one it can take there."""
    a = _qd(gen, (M, T), cuda_device)
    b = _qd(gen, (T, N), cuda_device)
    x = QD(*(e[:, None, :].expand(M, N, T) for e in a))
    y = QD(*(e.T[None].expand(M, N, T) for e in b))
    want = K.qd_dot_plain(x, y, tree)
    assert _same(K.qd_dot(x, y, tree), want)
    for plan in REGIMES[tree]:
        assert _same(K.planned(K.qd_dot, plan, x, y, tree), want), plan


@pytest.mark.parametrize("tree", [False, True])
def test_q4_broadcast_vector(tree, cuda_device, gen):
    """qd_contract's layout: y one weight vector broadcast over both output
    axes (strides (0, 0, 1)), x a permuted f64 core with zero low limbs."""
    r1, r2, n = 33, 33, 33
    g = torch.as_tensor(gen.standard_normal((r1, n, r2))).to(cuda_device).permute(0, 2, 1)
    zero = torch.zeros_like(g)
    w = _qd(gen, (n,), cuda_device)
    x, y = QD(g, zero, zero, zero), QD(*(e[None, None].expand(r1, r2, n) for e in w))
    want = K.qd_dot_plain(x, y, tree)
    assert _same(K.qd_dot(x, y, tree), want)
    for plan in REGIMES[tree]:
        assert _same(K.planned(K.qd_dot, plan, x, y, tree), want), plan


def test_q4_plan_is_the_shape_s(cuda_device):
    """The regime at the paths' shapes (csrc/qd_kernels.cu::dot_plan)."""
    assert K.qd_dot_plan(55, 3575, 55, False).regime == "thread"
    assert K.qd_dot_plan(55, 65, 55, False).regime == "chain"
    assert K.qd_dot_plan(1, 1, 201, True) == K.QdDotPlan("tree", 1, 101, 128, 1, 32 * 101)
    assert K.qd_dot_plan(1, 1, 1 << 16, True).regime == "thread"


@pytest.mark.parametrize("ranks,B,N", [((1, 16, 16, 1), 1089, 33), ((1, 33, 33, 1), 1089, 33),
                                       ((1, 33, 33, 1), 136, 33), ((1, 7, 5, 1), 99, 17),
                                       ((1, 1, 1, 1, 1), 402, 201), ((1, 15, 14, 1), 1089, 33),
                                       ((1, 15, 14, 1), 132, 33), ((1, 33, 33, 1), 1, 33),
                                       ((1, 64, 64, 1), 300, 9), ((1, 64, 64, 1), 1, 9),
                                       ((1, 3, 64, 2, 1), 257, 5)])
def test_q3_is_its_plain_version(ranks, B, N, cuda_device, gen):
    """Q3 in its own launch and with other rows and threads a block (one
    row of 32 threads, 3 rows of 96, 7 of 256 where shared memory holds
    them)."""
    from ttcross_tpu_torch.tt.types import TT

    d = len(ranks) - 1
    t = TT(tuple(torch.as_tensor(gen.standard_normal((ranks[c], N, ranks[c + 1]))).to(cuda_device)
                 for c in range(d)))
    packed = K.pack_tt(t)
    ind = torch.as_tensor(gen.integers(0, N, (B, d)), dtype=torch.int32).to(cuda_device)
    want = K.qd_gather_tt_plain(packed, ind)
    assert _same(K.qd_gather_tt_fused(packed, ind), want)
    for rows, threads in ((1, 32), (3, 96), (7, 256) if max(ranks) < 64 else (2, 256)):
        assert _same(K.planned(K.qd_gather_tt_fused, (rows, threads), packed, ind), want), (
            rows, threads)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 15, 31])
@pytest.mark.parametrize("B", [3575, 240, 83, 1])
def test_q1_is_its_plain_version(d, B, cuda_device, gen):
    """Q1 in its own plan and in every other, the indices drawn from [-2, n
    + 2) (clamped), bit for bit against the plain version."""
    from ttcross_tpu_torch.apps import make_ising_qd

    _, fun_qd, _ = make_ising_qd(m=d + 1, n=65, device=cuda_device)
    ind = torch.as_tensor(gen.integers(-2, 67, (B, d)), dtype=torch.int32).to(cuda_device)
    want = K.ising_c_integrand_qd_plain(fun_qd.tables, ind)
    assert _same(K.ising_c_integrand_qd_fused(fun_qd.tables, ind), want)
    for plan in ROWS_PLANS:
        assert _same(K.planned(K.ising_c_integrand_qd_fused, plan, fun_qd.tables, ind),
                     want), plan


def test_q1_plan_and_refusals(cuda_device):
    """Q1's launch at the qd paths' shapes (csrc/ising_rows.cuh::rows_plan),
    and the plans and inputs its entry point refuses."""
    assert K.ising_c_qd_plan(65, 3, 65)[:3] == (40, 128, 2)
    assert K.ising_c_qd_plan(3575, 3, 65)[:3] == (40, 128, 90)
    rows = torch.zeros((10, 3), dtype=torch.int32, device=cuda_device)
    table65 = torch.zeros((8, 65), dtype=torch.float64, device=cuda_device)
    for plan in ROWS_PLANS:     # Q1 takes each (it refuses a plan with ValueError)
        K.planned(K.ising_c_integrand_qd_fused, plan, table65, rows)
    tables = torch.zeros((8, 5), dtype=torch.float64, device=cuda_device)
    for plan in [0, -1, 41, 129]:
        with pytest.raises(ValueError):
            K.planned(K.ising_c_integrand_qd_fused, plan, tables, rows)
    with pytest.raises(ValueError):
        K.ising_c_integrand_qd_fused(tables[:4], rows)
    with pytest.raises(TypeError):
        K.ising_c_integrand_qd_fused(tables, rows.long())


def test_wrappers_route_by_device(cuda_device, gen):
    """A CPU tensor runs the plain version (no launch counted); a card tensor
    launches the kernel, one launch per call."""
    v, x, y = _qd(gen, (5,), "cpu"), _qd(gen, (5, 4), "cpu"), _qd(gen, (5, 4), "cpu")
    K.reset_launch_counts()
    K.qd_score_residual_argmax(v, x, y)
    K.qd_dot(QD(*(e[None] for e in x)), QD(*(e[None] for e in y)), True)
    assert K.launch_counts()["qd_score_residual_argmax"] == 0
    assert K.launch_counts()["qd_dot"] == 0
    K.qd_div_fused(x, y)
    assert K.launch_counts()["qd_div"] == 0
    vc, xc, yc = (QD(*(e.to(cuda_device) for e in q)) for q in (v, x, y))
    K.qd_score_residual_argmax(vc, xc, yc)
    K.qd_dot(QD(*(e[None] for e in xc)), QD(*(e[None] for e in yc)), False)
    K.qd_div_fused(xc, yc)
    counts = K.launch_counts()
    assert counts["qd_score_residual_argmax"] == 1 and counts["qd_dot"] == 1
    assert counts["qd_div"] == 1


def _q5_operands(gen, shape, divisor, dev, tiny=False):
    """The engine's layouts: a 0-d quotient, refine_dd's strided column
    A[1:, 0], the accept's (r, n) fiber, init_state's (1, n, 1) core; the
    divisor one 0-d value (a view into a residual, as the pivot), its
    expand, or one of x's shape."""
    if shape == "col":
        x = QD(*(e[1:, 0] for e in _qd(gen, (56, 56), dev, tiny=tiny)))
        shape = (55,)
    else:
        x = QD(*(e.reshape(shape) for e in _qd(gen, (int(np.prod(shape)),), dev, tiny=tiny)))
    if divisor == "each":
        y = QD(*(e.reshape(shape) for e in _qd(gen, (int(np.prod(shape)),), dev)))
    else:
        y = QD(*(e[3, 2] for e in _qd(gen, (5, 4), dev)))
        if divisor == "expand":
            y = QD(*(e.expand(shape) for e in y))
    return x, y


@pytest.mark.parametrize("shape", [(), "col", (55, 65), (1, 65, 1), (33, 65), (1, 1)])
@pytest.mark.parametrize("divisor", ["one", "expand", "each"])
@pytest.mark.parametrize("tiny", [False, True])
def test_q5_is_its_plain_version(shape, divisor, tiny, cuda_device, gen):
    """Q5 at the qd engine's shapes and layouts, in its own block and in
    every other: four limbs bit for bit the plain long division on the
    card."""
    x, y = _q5_operands(gen, shape, divisor, cuda_device, tiny)
    want = K.qd_div_plain(x, y)
    got = K.qd_div_fused(x, y)
    assert _same(got, want) and got.e0.shape == want.e0.shape
    assert all(e.is_contiguous() for e in got)
    for threads in (32, 64, 128, 256):
        assert _same(K.planned(K.qd_div_fused, threads, x, y), want), threads


def test_q5_special_values(cuda_device):
    """Signed zeros, subnormals, inf and NaN in x, over tiny, huge, zero
    and infinite divisors: every limb bit-equal, NaN where the plain
    version has NaN."""
    rng = np.random.default_rng(17)
    v = rng.standard_normal((4, 9, 13))
    flat = v.reshape(4, -1)
    for k, s in enumerate([0.0, -0.0, 5e-324, -2.5e-310, np.inf, -np.inf, np.nan, 1e-300]):
        flat[:, 7 * k + 3] = s
    x = QD(*(torch.as_tensor(e).to(cuda_device) for e in v))
    for d in (1e-300, -5e-324, 1e300, -1.7976931348623157e308, 0.0, -0.0, np.inf, 3.0):
        lo = d * 1e-17 if np.isfinite(d) else 0.0
        y = QD(*(torch.tensor(e, dtype=torch.float64, device=cuda_device)
                 for e in (d, lo, 0.0, 0.0)))
        got, want = K.qd_div_fused(x, y), K.qd_div_plain(x, y)
        for g, w in zip(got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(w)), d
            keep = ~torch.isnan(w)
            assert torch.equal(g[keep].view(torch.int64), w[keep].view(torch.int64)), d


def test_q5_one_launch_per_qd_div(cuda_device, gen):
    """ops/qd.py::qd_div on card tensors is one launch of Q5, counted by
    shape, at each of the engine's calls; nothing of the plain division
    runs on the card."""
    from ttcross_tpu_torch.ops.qd import qd_div

    calls = [("col", "expand"), ((55, 65), "one"), ((1, 65, 1), "one"), ((), "one"),
             ((1, 1), "one"), ((54,), "one")]
    K.reset_launch_counts()
    for shape, divisor in calls:
        qd_div(*_q5_operands(gen, shape, divisor, cuda_device))
    assert K.launch_counts()["qd_div"] == len(calls)
    assert K.launch_shapes()["qd_div"] == {("each", 55): 1, ("one", 55, 65): 1,
                                           ("one", 1, 65, 1): 1, ("one",): 1, ("one", 1, 1): 1,
                                           ("one", 54): 1}
    from torch.profiler import ProfilerActivity, profile

    x, y = _q5_operands(gen, (55, 65), "one", cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            qd_div(x, y)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    if kernels:   # a sandbox's profiler may record no device activity
        assert {e.key for e in kernels} <= {e.key for e in kernels if "qd_div_kernel" in e.key}


def test_q5_refusals(cuda_device, gen):
    """Mixed devices, a limb not float64, limbs of unequal layout, more
    than four axes, a block the entry point refuses: each raises, nothing
    falls back to the plain division."""
    x, y = _q5_operands(gen, (5, 7), "each", cuda_device)
    with pytest.raises(ValueError):
        K.qd_div_fused(x, QD(*(e.cpu() for e in y)))
    with pytest.raises(ValueError):
        K.qd_div_fused(QD(*(e.cpu() for e in x)), y)
    with pytest.raises(TypeError):
        K.qd_div_fused(QD(x.e0, x.e1, x.e2, x.e3.float()), y)
    with pytest.raises(ValueError):
        K.qd_div_fused(QD(x.e0, x.e1, x.e2, x.e3.T.contiguous().T), y)
    five = QD(*(e.reshape(1, 1, 1, 5, 7) for e in x))
    with pytest.raises(ValueError):
        K.qd_div_fused(five, y)
    for threads in (0, 16, 48, 512):
        with pytest.raises(ValueError):
            K.planned(K.qd_div_fused, threads, x, y)


def test_q5_plan_is_the_count_s(cuda_device):
    """Q5's block at the engine's counts (csrc/qd_kernels.cu::div_block)."""
    assert K.qd_div_plan(1) == K.QdDivPlan(128, 1)
    assert K.qd_div_plan(3575) == K.QdDivPlan(128, 28)
    assert K.qd_div_plan(33792).threads == 256


def test_small_cross_qd_is_the_cpu_s(cuda_device):
    """cross_qd on C_4 (n = 17, rank 10, seed 0) on the card, every qd_div
    in Q5, gives the CPU run's four limbs, pivots, evaluations and sweeps."""
    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
    from ttcross_tpu_torch.cross import cross_qd

    out = {}
    for dev in (cuda_device, "cpu"):
        prob, fun_qd, wq = make_ising_qd(m=4, n=17, device=dev)
        K.reset_launch_counts()
        res = cross_qd(fun_qd, [prob.n] * prob.d, max_rank=10, pivoting=1, quad=wq,
                       truth=ISING_C_STR[4], seed=0, device=dev)
        out[str(dev)] = (res, K.launch_counts()["qd_div"])
    (card, launched), (cpu, none) = out[str(cuda_device)], out["cpu"]
    assert [float(e) for e in card.value] == [float(e) for e in cpu.value]
    assert np.array_equal(card.vip, cpu.vip)
    assert (card.neval, card.sweeps, card.ranks) == (cpu.neval, cpu.sweeps, cpu.ranks)
    # init_state: a core over delta and 1 / delta a bond; then 3 an accept
    bonds = len(card.ranks) - 2
    assert none == 0 and launched == 2 * bonds + 3 * sum(r - 1 for r in card.ranks[1:-1])
