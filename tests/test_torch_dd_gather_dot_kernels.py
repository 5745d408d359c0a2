"""D3 (the dd train gather) and D4 (the small dd GEMM) of
csrc/dd_kernels.cu, on the CPU.

The kernels run only on a card (tests/test_torch_cuda_dd.py holds them to
their plain versions there).  Their arithmetic and bookkeeping are written
once for both: compiled by a host C++ compiler with -DTTD_HOST and
-ffp-contract=off, the file gives ttd_host_d4, which runs D4's whole call
in either regime (the chain regime's row offsets, chunks of products in a
double buffer and chain lanes adding in order, block after block; the
thread regime output after output), ttd_host_d3, which runs D3's whole call
block after block (per core each lane's column: its groups of products and
their sum in order), and their launch rules ttd_dd_dot_plan and
ttd_dd_gather_plan.
Here every call is held to ops/kernels.py::dd_dot_plain /
dd_gather_tt_plain at the dd paths' shapes, in the callers' layouts and in
other plans.  Tolerance: none, hi and lo bit-equal (NaN where the plain
version has NaN).  Without a host C++ compiler the tests skip.  The plain
versions' parity with the JAX package is in tests/test_torch_dd.py."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dd_kernel_cases as cases  # noqa: E402  (tests/dd_kernel_cases.py)
from dd_kernel_cases import bits_same as _same  # noqa: E402
from ttcross_tpu_torch.ops import kernels as K  # noqa: E402
from ttcross_tpu_torch.ops.dd import DD  # noqa: E402

LL, VP = ctypes.c_longlong, ctypes.c_void_p
THREAD, CHAIN = 0, 1   # D4's regimes (kDotThread, kDotChain)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = cases.host_lib(tmp_path_factory)
    if lib is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    return lib


# ------------------------------------------------------------ D4
def _d4_plan(host_lib, M, N, T):
    plan = (LL * 6)()
    assert host_lib.ttd_dd_dot_plan(LL(M), LL(N), T, plan) == 0
    return tuple(plan)


def _d4(host_lib, x, y, plan=None):
    """D4's call through the host emulation in `plan` = (regime, P, C) or
    the card's own plan for the shape; -> DD (M, N)."""
    M, N, T = x.hi.shape
    plan = plan or _d4_plan(host_lib, M, N, T)[:3]
    out = torch.empty((2, M, N), dtype=torch.float64)
    rc = host_lib.ttd_host_d4(*(VP(p.data_ptr()) for p in (x.hi, x.lo, y.hi, y.lo)), LL(M),
                              LL(N), T, *(LL(s) for s in x.hi.stride() + y.hi.stride()), *plan,
                              VP(out[0].data_ptr()), VP(out[1].data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at {(M, N, T)}"
    return DD(out[0], out[1])


def _d4_case(gen, layout, M, N, T):
    return cases.d4_operands(gen, layout, M, N, T)


D4_SHAPES = [
    (48, 65, 48), (65, 48, 48),      # C_6 rank 48: _mm_left, _mm_right
    (48, 3120, 48),                  # its finalize
    (32, 65, 32), (65, 32, 32),      # C_4 n = 65 rank 32
    (48, 48, 65),                    # value_mat's (R, R, N)
    (1, 48, 48), (1, 16, 1),         # the quadrature's (1, r2, r)
    (16, 33, 16), (7, 3, 5),
]
D4_LAYOUTS = ["mm", "mm_t", "value", "strided"]


@pytest.mark.parametrize("M,N,T", D4_SHAPES)
@pytest.mark.parametrize("layout", D4_LAYOUTS)
def test_d4_arithmetic(M, N, T, layout, host_lib):
    """D4's call in the plan the card takes for the shape, at the dd paths'
    shapes, in each caller's layout."""
    x, y = _d4_case(np.random.default_rng(M * 31 + N + T), layout, M, N, T)
    assert _same(_d4(host_lib, x, y), K.dd_dot_plain(x, y))


@pytest.mark.parametrize("r,r2", [(1, 16), (16, 32), (32, 32), (32, 16), (16, 1), (48, 64)])
def test_d4_contract_pairs(r, r2, host_lib):
    """_contract_pairs' vector (1, r2, r) against m.T, every core's ranks."""
    x, y = _d4_case(np.random.default_rng(r * 100 + r2), "pairs", 1, r2, r)
    want = K.dd_dot_plain(x, y)
    for plan in [None] + D4_PLANS:
        assert _same(_d4(host_lib, x, y, plan), want), plan


# other plans: the chain with one output a block (all terms in one chunk,
# chunks of 5), several (P = 3, 5: a chunk that does not divide T, a last
# block partly empty; chunks longer than a producer pass loads), 8, 16 and
# 32 (chunks of 28, 7 and 1); the thread regime in blocks of 256 to 32
D4_PLANS = [(CHAIN, 1, 896), (CHAIN, 1, 5), (CHAIN, 3, 74), (CHAIN, 5, 11), (CHAIN, 5, 300),
            (CHAIN, 8, 112), (CHAIN, 16, 56), (CHAIN, 32, 28), (CHAIN, 32, 7), (CHAIN, 32, 1),
            (THREAD, 256, 0), (THREAD, 128, 0), (THREAD, 32, 0)]


@pytest.mark.parametrize("M,N,T", [(48, 65, 48), (32, 65, 32), (48, 48, 65), (1, 48, 48),
                                   (7, 3, 5)])
@pytest.mark.parametrize("layout", D4_LAYOUTS)
def test_d4_every_plan(M, N, T, layout, host_lib):
    """Every regime and plan of D4 bit-equal to the plain version."""
    x, y = _d4_case(np.random.default_rng(M + N + T), layout, M, N, T)
    want = K.dd_dot_plain(x, y)
    for plan in D4_PLANS:
        assert _same(_d4(host_lib, x, y, plan), want), plan


@pytest.mark.parametrize("T", [0, 1])
def test_d4_no_term_and_one_term(T, host_lib):
    """T = 0: every output (+0, +0), as dd_sum of nothing; T = 1: the
    product added to (0, 0) (a -0 product becomes +0, as in the scan)."""
    x, y = _d4_case(np.random.default_rng(T), "mm", 9, 13, T)
    if T == 1:
        x.hi[0, 0, 0] = -0.0
        x.lo[0, 0, 0] = -0.0
    want = K.dd_dot_plain(x, y)
    for plan in [None] + D4_PLANS:
        assert _same(_d4(host_lib, x, y, plan), want), plan


def test_d4_special_values(host_lib):
    """Signed zeros, subnormals, inf, NaN and 2^+-1000 in the left factor,
    the finite ones in the right; a row of -0 (its outputs +0 after the
    scan's first add from (0, 0))."""
    x, y = cases.d4_specials(np.random.default_rng(9))
    want = K.dd_dot_plain(x, y)
    assert torch.isnan(want.hi).any() and (want.hi == 0).any()
    for plan in [None] + D4_PLANS:
        assert _same(_d4(host_lib, x, y, plan), want), plan


@pytest.mark.parametrize("M,N,T,want", [
    (48, 65, 48, (CHAIN, 8, 28, 256, 390, 7936)),      # C_6 rank 48 _mm_left
    (65, 48, 48, (CHAIN, 8, 28, 256, 390, 7936)),      # _mm_right
    (48, 3120, 48, (THREAD, 128, 0, 128, 1170, 0)),    # finalize
    (3120, 48, 48, (THREAD, 128, 0, 128, 1170, 0)),
    (32, 65, 32, (CHAIN, 8, 28, 256, 260, 7936)),      # C_4 n = 65 rank 32
    (48, 48, 65, (CHAIN, 8, 28, 256, 288, 7936)),      # value_mat
    (1, 48, 48, (CHAIN, 4, 28, 160, 12, 4224)),        # the quadrature's vector
    (48, 130, 48, (CHAIN, 16, 28, 256, 390, 15360)),
    (48, 260, 48, (CHAIN, 32, 28, 256, 390, 30208)),
    (1, 1, 48, (CHAIN, 1, 28, 64, 1, 1440)),
    (1, 3, 8, (CHAIN, 3, 8, 64, 1, 1376)),              # fewer outputs than 4
    (1, 16, 7, (THREAD, 64, 0, 64, 1, 0)),             # too few terms for the chain
    (1, 16, 8, (CHAIN, 4, 8, 64, 4, 1664)),
    (1, 16383, 8, (CHAIN, 32, 8, 256, 512, 9728)),     # the last output count of the chain
    (1, 16384, 8, (THREAD, 128, 0, 128, 128, 0)),
    (48, 2080, 48, (THREAD, 256, 0, 256, 390, 0)),     # the larger block on a tie
    (5, 5, 0, (THREAD, 64, 0, 64, 1, 0)),
])
def test_d4_plan(M, N, T, want, host_lib):
    """The launch rule (csrc/dd_kernels.cu::dot_plan) at the dd paths'
    shapes and at its edges; every plan launchable (<= 256 threads).  The
    chain's shared memory: its chunks' double buffer and the outputs'
    offsets (512 bytes)."""
    plan = _d4_plan(host_lib, M, N, T)
    assert plan == want
    assert plan[3] <= 256 and plan[3] % 32 == 0


def test_d4_refuses_what_the_card_refuses(host_lib):
    x, y = _d4_case(np.random.default_rng(0), "mm", 4, 5, 6)
    for plan in [(CHAIN, 33, 4), (CHAIN, 4, 0), (CHAIN, 0, 4), (THREAD, 48, 0), (THREAD, 512, 0),
                 (2, 32, 4)]:
        with pytest.raises(AssertionError):
            _d4(host_lib, x, y, plan)
    assert host_lib.ttd_dd_dot_plan(LL(0), LL(4), 4, (LL * 6)()) == -1
    assert host_lib.ttd_dd_dot_plan(LL(3), LL(4), -1, (LL * 6)()) == -1


# ------------------------------------------------------------ D3
_train = cases.train


def _d3_plan(host_lib, B, d, R, N):
    plan = (LL * 4)()
    assert host_lib.ttd_dd_gather_plan(LL(B), d, R, N, plan) == 0
    return tuple(plan)


def _d3(host_lib, tt, ind, plan=None):
    """D3's call through the host emulation with `plan` = (rows, threads)
    or the card's own plan for the shape; -> DD (B,)."""
    d, R, N, _ = tt.cores.shape
    B = ind.shape[0]
    plan = plan or _d3_plan(host_lib, B, d, R, N)[:2]
    out = torch.empty((2, B), dtype=torch.float64)
    ranks = torch.tensor(tt.ranks, dtype=torch.int32)
    ind = ind.to(torch.int32).contiguous()
    rc = host_lib.ttd_host_d3(VP(tt.cores.data_ptr()), VP(ranks.data_ptr()), d, R, N,
                              VP(ind.data_ptr()), LL(B), *plan, VP(out[0].data_ptr()),
                              VP(out[1].data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at B={B}, R={R}"
    return DD(out[0], out[1])


_ind = cases.indices


D3_CASES = [   # (B, n, ranks): the defect's rows, lottery and init batches
    (3120, 65, (1, 16, 32, 32, 16, 1)), (226, 65, (1, 16, 32, 32, 16, 1)),
    (520, 65, (1, 16, 32, 32, 16, 1)), (325, 65, (1, 16, 32, 32, 16, 1)),
    (390, 65, (1, 1, 1, 1, 1)), (142, 65, (1, 1, 1, 1, 1)),   # defect stdnorm_d4's rank-1 train
    (1560, 65, (1, 24, 32, 32, 24, 1)), (226, 17, (1, 8, 8, 1)), (37, 33, (1, 48, 64, 48, 1)),
]


@pytest.mark.parametrize("B,n,ranks", D3_CASES)
def test_d3_arithmetic(B, n, ranks, host_lib):
    """D3's call in the plan the card takes for the shape."""
    gen = np.random.default_rng(B + len(ranks))
    tt = _train(gen, ranks, n)
    ind = _ind(gen, B, tt.n)
    assert _same(_d3(host_lib, tt, ind), K.dd_gather_tt_plain(tt, ind))


# rows and threads a block: one row (its lanes; more threads, idle), several
# rows (a last block partly empty), more rows than the call has; those a
# block can have at rank R
D3_PLANS = [(1, 32), (1, 256), (2, 64), (2, 96), (3, 128), (5, 256), (8, 256), (64, 96)]


def _plans(host_lib, tt, B):
    """The plans of D3_PLANS that D3 takes for B rows of tt
    (ttd_dd_gather_plan_ok, the entry point's own check)."""
    d, R, N, _ = tt.cores.shape
    return [p for p in D3_PLANS if host_lib.ttd_dd_gather_plan_ok(LL(B), d, R, N, *p) == 1]


@pytest.mark.parametrize("B,n,ranks", [(226, 65, (1, 16, 32, 32, 16, 1)),
                                       (61, 33, (1, 5, 7, 3, 1)), (30, 17, (1, 1, 1, 1)),
                                       (9, 17, (1, 48, 64, 48, 1))])
def test_d3_every_plan(B, n, ranks, host_lib):
    """Every plan of D3 bit-equal to the plain version."""
    gen = np.random.default_rng(B)
    tt = _train(gen, ranks, n)
    ind = _ind(gen, B, tt.n)
    want = K.dd_gather_tt_plain(tt, ind)
    for plan in _plans(host_lib, tt, B):
        assert _same(_d3(host_lib, tt, ind, plan), want), plan


def test_d3_ranks_below_the_packed_rank(host_lib):
    """A train packed with a larger R and N than its ranks and modes (the
    zero padding never read) and modes of several sizes."""
    gen = np.random.default_rng(4)
    tt = _train(gen, (1, 7, 12, 5, 1), [9, 17, 4, 11], R=32, N=20)
    ind = _ind(gen, 300, tt.n)
    want = K.dd_gather_tt_plain(tt, ind)
    for plan in [None] + _plans(host_lib, tt, 300):
        assert _same(_d3(host_lib, tt, ind, plan), want), plan


def test_d3_clamps_out_of_range_indices(host_lib):
    """An index below 0 or from N up is clamped into [0, N) (every mode N),
    as the gather of the JAX package clamps: the plain version at the
    clamped indices."""
    gen = np.random.default_rng(5)
    tt = _train(gen, (1, 6, 6, 1), 17)
    ind = torch.from_numpy(gen.integers(-40, 60, (200, 3))).to(torch.int32)
    want = K.dd_gather_tt_plain(tt, ind.clamp(0, 16))
    for plan in [None] + _plans(host_lib, tt, 200):
        assert _same(_d3(host_lib, tt, ind, plan), want), plan


def test_d3_special_values(host_lib):
    """Signed zeros, subnormals and 2^+-1000 in every core, inf and NaN in
    the last, and a slice of -0: the full dd_mul(v, (g, 0)) as the plain
    version's (a -0 product's lo, an inf times a zero)."""
    gen = np.random.default_rng(6)
    tt = cases.d3_specials(gen)
    ind = _ind(gen, 400, tt.n)
    want = K.dd_gather_tt_plain(tt, ind)
    assert torch.isnan(want.hi).any() and (want.hi == 0).any()
    for plan in [None] + _plans(host_lib, tt, 400):
        assert _same(_d3(host_lib, tt, ind, plan), want), plan


@pytest.mark.parametrize("B,R,want", [       # d = 5: v, then the ranks and indices
    (3120, 32, (8, 256, 390, 8376)),      # defect C_6 level 2: rook fibers
    (226, 32, (2, 64, 113, 2112)),        # its lottery
    (520, 32, (4, 128, 130, 4200)),       # its init batches
    (325, 32, (3, 96, 109, 3160)),
    (132, 32, (1, 32, 132, 1072)),
    (390, 1, (3, 32, 130, 184)),          # defect stdnorm_d4's rank-1 train
    (100000, 1, (256, 256, 391, 13336)),  # no more rows than a block's lanes
    (1000, 16, (8, 128, 125, 4280)),
    (500, 64, (4, 128, 125, 8296)),       # two columns a lane
])
def test_d3_plan(B, R, want, host_lib):
    """The launch rule (csrc/dd_kernels.cu::gather_plan)."""
    assert _d3_plan(host_lib, B, 5, R, 65) == want


@pytest.mark.parametrize("B,R,plan,ok", [
    (3120, 32, (8, 256), 1), (3120, 32, (8, 224), 0),   # 8 rows of 32 lanes: 8 warps
    (390, 1, (3, 32), 1), (390, 1, (64, 32), 0),        # rank 1: 32 rows a warp
    (100, 4, (8, 32), 1), (100, 4, (9, 32), 0),         # rank 4: 8 rows a warp
    (100, 5, (4, 32), 1), (100, 5, (5, 32), 0),         # rank 5: 8 lanes a row
    (10, 64, (1, 32), 1), (10, 64, (8, 256), 1),        # rank 64: two columns a lane
    (10, 32, (1, 48), 0), (10, 32, (1, 512), 0), (10, 32, (0, 32), 0),
    (0, 32, (1, 32), 0), (10, 65, (1, 32), 0),          # no rows; rank past 64
])
def test_d3_plan_ok(B, R, plan, ok, host_lib):
    """The entry point's check of a plan (ttd_dd_gather_plan_ok): the
    threads hold the rows' lanes, whole warps, at most 256."""
    assert host_lib.ttd_dd_gather_plan_ok(LL(B), 5, R, 65, *plan) == ok


def test_d3_refuses_what_the_card_refuses(host_lib):
    gen = np.random.default_rng(0)
    tt = _train(gen, (1, 3, 1), 5)
    ind = _ind(gen, 10, tt.n)
    for plan in [(0, 64), (1, 16), (1, 512), (1, 48), (64, 64), (300, 256)]:
        if plan == (300, 256):        # a block's shared memory past 227 KB at R = 64
            tt = _train(gen, (1, 64, 1), 5)
        with pytest.raises(AssertionError):
            _d3(host_lib, tt, ind, plan)
    assert host_lib.ttd_dd_gather_plan(LL(0), 3, 4, 5, (LL * 4)()) == -1
    assert host_lib.ttd_dd_gather_plan(LL(4), 3, 65, 5, (LL * 4)()) == -1
