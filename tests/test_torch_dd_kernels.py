"""D1, the dd residual argmax of csrc/dd_kernels.cu, and D2, the dd Ising
integrand, on the CPU.

The kernels run only on a card (tests/test_torch_cuda_dd.py holds them to
their plain versions there).  Their arithmetic and bookkeeping (the dd
operations, D1's masked terms, its chunks of products in a double buffer
and its chain lanes' sums in order, the blocks' best and the grid's argmax;
D2's staging, its lanes' scans and each group's tail with its neighbours'
results) are written once for both: compiled by a host C++ compiler with
-DTTD_HOST and -ffp-contract=off, the file gives ttd_host_d1 and
ttd_host_d2, which run the whole call block after block in one host
thread, each stage's items in turn, in any plan, and ttd_dd_score_plan and
ttd_dd_ising_plan, the launch rules.  Here every call is held to
ops/kernels.py::dd_score_residual_argmax_plain and
ising_c_integrand_dd_plain at the dd paths' shapes and layouts.
Tolerance: none, hi and lo bit-equal (NaN where the plain version has NaN),
D1's flat index and the pivot r[flat] equal.  Without a
host C++ compiler the build is not possible and the tests skip.  The plain
version's parity with the JAX package is in tests/test_torch_dd.py and the
dd engine tests."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dd_kernel_cases as cases  # noqa: E402  (tests/dd_kernel_cases.py)
from dd_kernel_cases import dd_map as _map, pair as _pair  # noqa: E402
from ttcross_tpu_torch.ops import kernels as K  # noqa: E402
from ttcross_tpu_torch.ops.dd import DD  # noqa: E402

LL, VP = ctypes.c_longlong, ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = cases.host_lib(tmp_path_factory)
    if lib is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    return lib


def _case(gen, layout, B, T):
    """(vals, x, y, rank, mask, mask_side) as the dd engine gives D1 in that
    layout (cross/engine_dd.py): the lottery (x gathered rows, y the
    transposed gathered columns, the rank mask on x), a column pass (x the
    column factor's rows, y a broadcast vector, the mask on y), a row pass
    (x a broadcast vector, y the transposed row factor, the mask on x), and
    the accept's products (no vals, no mask, no rank)."""
    vals = _pair(gen, (B,))
    mask = torch.from_numpy(gen.random(B) > 0.3)
    rank = torch.tensor([max(T - 2, 0)], dtype=torch.int32)
    x = _pair(gen, (B, T))
    if layout == "lottery":
        return vals, x, _map(lambda t: t.T, _pair(gen, (T, B))), rank, mask, K.MASK_X
    if layout == "col":
        return vals, x, _map(lambda t: t.expand(B, T), _pair(gen, (T,))), rank, mask, K.MASK_Y
    if layout == "row":
        return (vals, _map(lambda t: t.expand(B, T), _pair(gen, (T,))),
                _map(lambda t: t.T, _pair(gen, (T, B))), rank, mask, K.MASK_X)
    return None, x, _map(lambda t: t.T, _pair(gen, (T, B))), None, None, K.MASK_NONE


def _plan(host_lib, B, T):
    plan = (LL * 5)()
    assert host_lib.ttd_dd_score_plan(LL(B), T, plan) == 0
    return tuple(plan)


def _host(host_lib, args, plan=None):
    """D1's call through the host emulation, in `plan` = (P, C) or the
    card's own plan for the shape; -> (r DD (B,), flat, DD r[flat])."""
    vals, x, y, rank, mask, side = args
    B, T = x.hi.shape
    plan = plan or _plan(host_lib, B, T)[:2]
    out = torch.empty((2, B), dtype=torch.float64)
    words = torch.zeros(4, dtype=torch.int64)
    ptr = [VP(vals.hi.data_ptr()), VP(vals.lo.data_ptr())] if vals is not None else [None, None]
    rc = host_lib.ttd_host_d1(*ptr, *(VP(p.data_ptr()) for p in (x.hi, x.lo, y.hi, y.lo)),
                              LL(B), T, *(LL(s) for s in x.hi.stride() + y.hi.stride()),
                              VP(rank.data_ptr()) if rank is not None else None, side,
                              VP(mask.data_ptr()) if mask is not None else None, *plan,
                              VP(out.data_ptr()), VP(words.data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at {(B, T)}"
    best = words.view(torch.float64)
    return DD(out[0], out[1]), int(words[0]), DD(best[2], best[3])


def _same(got, want):
    """r's hi and lo bit-equal (a signed zero too, NaN where the other has
    NaN), the flat index and r at it equal."""
    (gr, gflat, gbest), (wr, wflat, wbest) = got, want
    return cases.bits_same(list(gr) + list(gbest), list(wr) + list(wbest)) and gflat == int(wflat)


SHAPES = [(3120, 48), (226, 48), (48, 48), (2080, 32), (528, 16), (16, 16), (1, 48), (1, 1)]
LAYOUTS = ["lottery", "col", "row", "products"]


@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_d1_arithmetic(B, T, layout, host_lib):
    """D1's call in the plan the card takes for the shape, at the dd paths'
    shapes (C_6 rank 48, C_4 n = 65 rank 32, C_4 n = 33 rank 16: the rook
    fibers, the lottery, the accept's (R, R) products) in each layout."""
    args = _case(np.random.default_rng(B * 7 + T), layout, B, T)
    assert _same(_host(host_lib, args), K.dd_score_residual_argmax_plain(*args))


# other plans at each shape: one row a block (all terms in one chunk, and
# chunks of 5), several rows (P = 3, 5: a chunk that does not divide T, a
# last block partly empty; chunks of more terms than a producer pass
# loads), 8, 16 and all 32 (chunks of 28, 7 and 1)
PLANS = [(1, 896), (1, 5), (3, 74), (5, 11), (5, 300), (8, 112), (16, 56), (32, 28), (32, 7),
         (32, 1)]


@pytest.mark.parametrize("B,T", [(3120, 48), (226, 48), (48, 48), (528, 16), (97, 7), (1, 1)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_d1_every_plan(B, T, layout, host_lib):
    """Every plan of D1 bit-equal to the plain version."""
    args = _case(np.random.default_rng(B + T), layout, B, T)
    want = K.dd_score_residual_argmax_plain(*args)
    for plan in PLANS:
        assert _same(_host(host_lib, args, plan), want), plan


@pytest.mark.parametrize("rank", [0, 1, 17, 48, 60])
@pytest.mark.parametrize("side", ["x", "y"])
def test_d1_rank_mask(rank, side, host_lib):
    """The rank mask t < rank on x and on y, from none of the terms to all."""
    gen = np.random.default_rng(rank)
    B, T = 300, 48
    vals, x, y = _pair(gen, (B,)), _pair(gen, (B, T)), _pair(gen, (B, T))
    args = (vals, x, y, torch.tensor([rank], dtype=torch.int32),
            torch.from_numpy(gen.random(B) > 0.5), K.MASK_X if side == "x" else K.MASK_Y)
    want = K.dd_score_residual_argmax_plain(*args)
    for plan in [None] + PLANS:
        assert _same(_host(host_lib, args, plan), want), plan


def test_d1_ties_and_empty_mask(host_lib):
    """Equal scores in different blocks: the smaller index wins; every score
    -1 (an all-false mask, or no mask): flat 0; a NaN above every number."""
    gen = np.random.default_rng(3)
    B, T = 5000, 8
    x = _pair(gen, (B, T))
    y = DD(torch.zeros(B, T, dtype=torch.float64), torch.zeros(B, T, dtype=torch.float64))
    vals = DD(torch.ones(B, dtype=torch.float64), torch.zeros(B, dtype=torch.float64))
    vals.hi[[300, 2600, 4999]] = 7.0
    mask = torch.ones(B, dtype=torch.bool)
    cases = [(vals, x, y, None, mask, K.MASK_NONE),
             (vals, x, y, None, torch.zeros(B, dtype=torch.bool), K.MASK_NONE),
             (vals, x, y, None, None, K.MASK_NONE)]
    nan_vals = DD(vals.hi.clone(), vals.lo.clone())
    nan_vals.hi[[1200, 3000]] = float("nan")
    cases.append((nan_vals, x, y, None, mask, K.MASK_NONE))
    flats = []
    for args in cases:
        want = K.dd_score_residual_argmax_plain(*args)
        for plan in [None] + PLANS:
            got = _host(host_lib, args, plan)
            assert _same(got, want), plan
        flats.append(got[1])
    assert flats == [300, 0, 0, 1200]


def test_d1_special_values(host_lib):
    """Signed zeros, subnormals, inf and NaN in the operands and vals."""
    gen = np.random.default_rng(9)
    B, T = 200, 12
    specials = [0.0, -0.0, 5e-324, -2.5e-310, np.inf, -np.inf, np.nan, 1e-300]

    def strew(t):
        flat = t.reshape(-1)
        for k, pick in enumerate(gen.choice(flat.numel(), size=8, replace=False)):
            flat[pick] = specials[k]
        return t

    vals, x, y = _pair(gen, (B,)), _pair(gen, (B, T)), _pair(gen, (B, T))
    x = DD(strew(x.hi), x.lo)
    y = DD(strew(y.hi), strew(y.lo))
    args = (DD(strew(vals.hi), vals.lo), x, y, torch.tensor([9], dtype=torch.int32),
            torch.from_numpy(gen.random(B) > 0.2), K.MASK_Y)
    want = K.dd_score_residual_argmax_plain(*args)
    for plan in [None] + PLANS:
        assert _same(_host(host_lib, args, plan), want), plan


@pytest.mark.parametrize("B,T,want", [
    (3120, 48, (16, 48, 256, 195, 25088)),     # C_6 rank 48: rook fibers, accept
    (226, 48, (8, 48, 256, 29, 12544)),        # its lottery
    (48, 48, (8, 48, 256, 6, 12544)),          # its accept's (R, R) products
    (2080, 32, (16, 32, 256, 130, 16896)),     # C_4 n = 65 rank 32
    (32, 32, (32, 28, 256, 1, 29696)),         # its products: one block
    (528, 16, (8, 16, 160, 66, 4352)),         # C_4 n = 33 rank 16
    (16, 16, (16, 16, 256, 1, 8704)),
    (1, 48, (1, 48, 96, 1, 1568)),
    (1, 2000, (1, 896, 256, 1, 28704)),        # chunks of what the producers load in a pass
    (33, 3, (8, 3, 64, 5, 768)),
    (1055, 48, (8, 48, 256, 132, 12544)),
    (1056, 48, (16, 48, 256, 66, 25088)),
    (4223, 48, (16, 48, 256, 264, 25088)),
    (4224, 48, (32, 28, 256, 132, 29696)),
    (1, 0, (1, 1, 64, 1, 32)),                 # no terms: r = vals
])
def test_d1_plan(B, T, want, host_lib):
    """The launch rule (csrc/dd_kernels.cu::score_plan) at the dd paths'
    shapes and at its edges; every plan launchable (<= 256 threads)."""
    plan = _plan(host_lib, B, T)
    assert plan == want
    assert plan[2] <= 256 and plan[2] % 32 == 0


def test_d1_refuses_what_the_card_refuses(host_lib):
    """A plan or shape the card's entry point refuses: the host emulation
    returns -1 and writes nothing."""
    args = _case(np.random.default_rng(0), "col", 10, 4)
    for plan in [(33, 4), (4, 0), (0, 4), (-1, 4)]:
        with pytest.raises(AssertionError):
            _host(host_lib, args, plan)
    assert host_lib.ttd_dd_score_plan(LL(0), 4, (LL * 5)()) == -1


def _d2_plan(host_lib, B, d, n):
    plan = (LL * 4)()
    assert host_lib.ttd_dd_ising_plan(LL(B), d, n, plan) == 0
    return tuple(plan)


def _d2_host(host_lib, tables, ind, plan=None):
    """D2's call through the host emulation with `plan` rows a block or in
    the card's own plan for the shape (ttd_dd_ising_plan); -> DD (B,)."""
    B, d = ind.shape
    n = tables.shape[1]
    plan = _d2_plan(host_lib, B, d, n)[0] if plan is None else plan
    out = torch.empty((2, B), dtype=torch.float64)
    rc = host_lib.ttd_host_d2(VP(tables.data_ptr()), n, VP(ind.data_ptr()), LL(B), d, plan,
                              VP(out[0].data_ptr()), VP(out[1].data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at {(B, d, n)}"
    return DD(out[0], out[1])


@pytest.fixture(scope="module")
def d2_tables():
    from ttcross_tpu_torch.apps import make_ising_dd

    return make_ising_dd(m=4, n=65, device="cpu")[1].tables


@pytest.mark.parametrize("d", [1, 2, 3, 5, 15, 31])
def test_d2_arithmetic(d, host_lib, d2_tables):
    """D2's whole call in the card's plan for the shape and in every other
    plan, at B = 1 and B = 83 (every plan's last block partly empty), the
    indices drawn from [-2, n + 2) (clamped): hi and lo bit-equal to the
    plain version."""
    for B in (1, 83):
        gen = np.random.default_rng(d * 100 + B)
        ind = torch.from_numpy(gen.integers(-2, 67, (B, d)).astype(np.int32))
        want = K.ising_c_integrand_dd_plain(d2_tables, ind)
        assert cases.bits_same(_d2_host(host_lib, d2_tables, ind), want), B
        for plan in cases.ROWS_PLANS:
            assert cases.bits_same(_d2_host(host_lib, d2_tables, ind, plan), want), (B, plan)


def test_d2_special_values(host_lib):
    """D2 where the table holds signed zeros, subnormals, inf and NaN, and
    the indices a view at an odd offset (the staging's 16-byte chunks start
    before the block's first index), in every plan."""
    gen = np.random.default_rng(13)
    n = 9
    tables = cases.strew(gen, torch.from_numpy(gen.standard_normal((4, n))))
    ind = torch.from_numpy(gen.integers(-3, n + 3, (61, 5)).astype(np.int32))[1:]
    want = K.ising_c_integrand_dd_plain(tables, ind)
    assert torch.isnan(want.hi).any()
    for plan in [None] + cases.ROWS_PLANS:
        assert cases.bits_same(_d2_host(host_lib, tables, ind, plan), want), plan


@pytest.mark.parametrize("B,d,n,want", [
    (3120, 5, 65, (40, 128, 78, 2912)),         # C_6: the rook fibers
    (226, 5, 65, (40, 128, 6, 2912)),           # its lottery
    (2080, 3, 65, (40, 128, 52, 2592)),         # C_4 n = 65
    (194, 3, 65, (40, 128, 5, 2592)),
    (528, 3, 33, (40, 128, 14, 1568)),          # C_4 n = 33
    (1, 5, 65, (1, 32, 1, 2144)),               # no more rows than B
    (5280, 5, 65, (40, 128, 132, 2912)),        # a block on each of the 132 SMs
    (10 ** 6, 5, 65, (40, 128, 25000, 2912)),
    (3, 50000, 65, (1, 32, 3, 202112)),         # one row's indices take the shared memory
])
def test_d2_plan(B, d, n, want, host_lib):
    """D2's launch rule (csrc/ising_rows.cuh::rows_plan) at the dd paths'
    shapes and at its edges: four warps' rows a block (10 a warp), no more
    rows than B nor than shared memory holds."""
    assert _d2_plan(host_lib, B, d, n) == want


def test_d2_refuses_what_the_card_refuses(host_lib, d2_tables):
    """A plan or shape the card's entry point refuses: the host emulation
    returns -1, the plan rule and its check say so."""
    ind = torch.zeros((10, 3), dtype=torch.int32)
    for plan in [0, -1, 41, 129]:
        with pytest.raises(AssertionError):
            _d2_host(host_lib, d2_tables, ind, plan)
        assert host_lib.ttd_dd_ising_plan_ok(LL(10), 3, 65, plan) == 0
    for P in cases.ROWS_PLANS:
        assert host_lib.ttd_dd_ising_plan_ok(LL(10), 3, 65, P) == 1
    out = (LL * 4)()
    for shape in [(0, 3, 65), (5, 0, 65), (5, 3, 0), (5, 3, 1537), (5, 60000, 65)]:
        assert host_lib.ttd_dd_ising_plan(LL(shape[0]), shape[1], shape[2], out) == -1, shape
