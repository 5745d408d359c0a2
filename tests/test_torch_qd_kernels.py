"""The qd kernels' arithmetic (csrc/qd_kernels.cu, Q1-Q4) on the CPU.

The kernels run only on a card (tests/test_torch_cuda_qd.py holds them to
their plain versions there, Q2's argmax too).  Their arithmetic (the
distill sweeps, the qd operations, the pairwise tree walked depth first or
level by level, each kernel's row, output or block stages) is written once
for both: compiled by a host C++ compiler with -DTTQ_HOST and
-ffp-contract=off, the file gives host entry points that run those
functions in one host thread: Q1's, Q2's, Q3's and Q4's whole call, block
after block, each stage's items in turn (Q1, Q2 and Q4 in any of their
plans: Q1's staging, its lanes' scans and each group's tail with its
neighbours' results, Q2's argmax over the blocks' best at the end).  Here every
output is held to the plain versions (ops/kernels.py::*_plain) at the
slice's shapes and layouts.  Tolerance: none, every limb bit-equal (where
an input holds inf or NaN: the same NaN positions and every other limb
bit-equal), and Q2's flat index equal.
Without a host C++ compiler the build is not possible and the tests skip.
The wrappers' routing by device and the plain versions' parity with the
JAX package are in tests/test_torch_qd.py and the engine tests."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dd_kernel_cases import ROWS_PLANS  # noqa: E402  (tests/dd_kernel_cases.py)
from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.qd import QD, qd_mul
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

SRC = Path(__file__).resolve().parent.parent / "ttcross_tpu_torch" / "csrc" / "qd_kernels.cu"
LL, VP = ctypes.c_longlong, ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    out = tmp_path_factory.mktemp("qdhost") / "libqdhost.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-DTTQ_HOST", "-x", "c++", str(SRC), "-o", str(out)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _qd(gen, shape, tiny=False):
    e0 = gen.standard_normal(shape) * (1e-300 if tiny else 1.0)
    e1 = e0 * gen.standard_normal(shape) * 1e-17
    e2 = e1 * gen.standard_normal(shape) * 1e-17
    e3 = e2 * gen.standard_normal(shape) * 1e-17
    return QD(*(torch.from_numpy(e) for e in (e0, e1, e2, e3)))


def _ptrs(x):
    return (VP * 4)(*(e.data_ptr() for e in x))


def _same(out, want):
    """out: (rows, 4) limbs of the host calls against a QD of those rows."""
    return all(torch.equal(out[:, k], w.reshape(-1)) for k, w in enumerate(want))


def _outs(rows, call):
    """call(r, pointer) for each output r, into a (rows, 4) tensor."""
    out = torch.empty((rows, 4), dtype=torch.float64)
    base = out.data_ptr()
    for r in range(rows):
        call(r, VP(base + 32 * r))
    return out


THREAD, CHAIN, TREE = 0, 1, 2    # Q2's and Q4's regimes (csrc/qd_kernels.cu::dot_plan)


def _q2_args(kind, B, T, tiny):
    gen = np.random.default_rng(B * 7 + T)
    vals, x, y = _qd(gen, (B,), tiny), _qd(gen, (B, T), tiny), _qd(gen, (B, T))
    if kind == "col":
        y = QD(*(e[0].expand(B, T) for e in y))
    elif kind == "row":
        x = QD(*(e[0].expand(B, T) for e in x))
        y = QD(*(e.T for e in _qd(gen, (T, B))))
    return vals, x, y


def _q2_plan(host_lib, B, T):
    plan = (LL * 6)()
    assert host_lib.ttq_score_plan(LL(B), T, plan) == 0
    return tuple(plan)


def _q2_host(host_lib, vals, x, y, plan=None):
    """Q2's call through the host emulation, in `plan` = (regime, P) or the
    card's own plan for the shape (ttq_score_plan); -> (QD (B,), flat)."""
    B, T = x[0].shape
    plan = plan or _q2_plan(host_lib, B, T)[:2]
    out = torch.empty((4, B), dtype=torch.float64)
    flat = LL(-1)
    rc = host_lib.ttq_host_q2(_ptrs(vals), _ptrs(x), _ptrs(y), LL(B), T,
                              *(LL(s) for s in x[0].stride()), *(LL(s) for s in y[0].stride()),
                              *plan, VP(out.data_ptr()), ctypes.byref(flat))
    assert rc == 0, f"the host emulation refused {plan} at {(B, T)}"
    return QD(*out), flat.value


def _same_q2(got, want):
    return _same_qd(got[0], want[0]) and got[1] == int(want[1])


# every plan Q2 can take: a thread per row (the depth-first walk), 32 / 64 /
# 256 a block; the shared tree with one row a block, 3 (a last block partly
# empty), 9 and 32
Q2_PLANS = [(THREAD, 32), (THREAD, 64), (THREAD, 256), (TREE, 1), (TREE, 3), (TREE, 9),
            (TREE, 32)]


@pytest.mark.parametrize("kind,B,T", [("lottery", 240, 55), ("col", 3575, 55), ("row", 715, 55),
                                      ("lottery", 97, 33), ("col", 65, 7), ("row", 17, 1),
                                      ("accept", 1, 55), ("lottery", 30, 201)])
@pytest.mark.parametrize("tiny", [False, True])
def test_q2_arithmetic(kind, B, T, tiny, host_lib):
    """Q2's whole call in the plan the card takes for the shape, and in every
    other plan: the residual's limbs and the flat argmax."""
    vals, x, y = _q2_args(kind, B, T, tiny)
    want = K.qd_score_residual_argmax_plain(vals, x, y)
    assert _same_q2(_q2_host(host_lib, vals, x, y), want)
    for plan in Q2_PLANS:
        assert _same_q2(_q2_host(host_lib, vals, x, y, plan), want), plan


def test_q2_ties_and_nan(host_lib):
    """The first of equal maxima in different blocks, and a NaN above every
    number, in every plan."""
    gen = np.random.default_rng(6)
    B, T = 600, 3
    vals = QD(*(torch.zeros(B, dtype=torch.float64) for _ in range(4)))
    x = _qd(gen, (B, T))
    for e in x:
        e[7] = e[7] * 10      # the largest residual, tied at rows 7, 400 and 599
        e[400] = e[7]
        e[599] = e[7]
    y = QD(*(e.clone() for e in x))
    flats = []
    for nan in (False, True):
        if nan:
            x.e0[300] = float("nan")
        want = K.qd_score_residual_argmax_plain(vals, x, y)
        for plan in [None] + Q2_PLANS:
            got = _q2_host(host_lib, vals, x, y, plan)
            assert _same_q2(got, want), plan
        flats.append(got[1])
    assert flats == [7, 300]


@pytest.mark.parametrize("B,T,want", [
    (3575, 54, (TREE, 14, 27, 256, 256, 12096)),   # C_4 rank 55: the rook fibers
    (2080, 32, (TREE, 16, 16, 256, 130, 8192)),    # 2 workers' fibers
    (240, 55, (TREE, 2, 28, 64, 120, 1792)),       # the lottery
    (404, 1, (TREE, 4, 1, 32, 101, 128)),          # stdnorm (rank 1)
    (201, 1, (TREE, 201, 1, 224, 1, 6432)),        # one block holds every row
    (1, 55, (TREE, 1, 28, 32, 1, 896)),
    (9, 55, (TREE, 9, 28, 256, 1, 8064)),
    (10, 55, (TREE, 1, 28, 32, 10, 896)),          # spread: a row a block
    (2376, 55, (TREE, 9, 28, 256, 264, 8064)),     # one wave of two blocks an SM
    (2377, 55, (TREE, 10, 28, 256, 238, 8960)),
    (10 ** 6, 55, (TREE, 228, 28, 256, 4386, 204288)),   # as many rows as shared memory holds
    (1, 1 << 16, (THREAD, 64, 0, 64, 1, 0)),       # longer than the tree's shared memory
])
def test_q2_plan(B, T, want, host_lib):
    """Q2's launch rule: Q4's tree rule for B outputs (dot_plan(1, B, T)),
    one block where its threads hold every level-1 term, and full blocks
    raised to one wave of two blocks an SM."""
    assert _q2_plan(host_lib, B, T) == want


def _q4_host(host_lib, x, y, tree, plan=None):
    """Q4's call through the host emulation, in `plan` = (regime, P, C) or
    the card's own plan for the shape (ttq_dot_plan); -> QD (M, N)."""
    M, N, T = x[0].shape
    if plan is None:
        plan = _q4_plan(host_lib, M, N, T, tree)[:3]
    out = torch.empty((4, M, N), dtype=torch.float64)
    rc = host_lib.ttq_host_q4(_ptrs(x), _ptrs(y), LL(M), LL(N), T,
                              *(LL(s) for s in x[0].stride()), *(LL(s) for s in y[0].stride()),
                              int(tree), *plan, VP(out.data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at {(M, N, T, tree)}"
    return QD(*out)


def _q4_plan(host_lib, M, N, T, tree):
    plan = (LL * 6)()
    assert host_lib.ttq_dot_plan(LL(M), LL(N), T, int(tree), plan) == 0
    return tuple(plan)


def _gemm(gen, M, N, T, tiny=False):
    """qd_matmul's operands as Q4 takes them: a row of A broadcast over N
    (stride 0), a transposed column of B broadcast over M."""
    a, b = _qd(gen, (M, T), tiny), _qd(gen, (T, N))
    return (QD(*(e[:, None, :].expand(M, N, T) for e in a)),
            QD(*(e.T[None].expand(M, N, T) for e in b)))


Q4_CASES = [(M, N, T, tree) for M, N, T in [(715, 55, 55), (55, 65, 55), (1, 33, 33),
                                              (33, 33, 65), (1, 1, 201), (5, 7, 1), (4, 3, 0)]
            for tree in (False, True) if T > 0 or not tree]   # the tree takes T >= 1


@pytest.mark.parametrize("M,N,T,tree", Q4_CASES)
def test_q4_arithmetic(M, N, T, tree, host_lib):
    """Q4's call in the plan the card takes for the shape."""
    x, y = _gemm(np.random.default_rng(M + N + T), M, N, T)
    assert _same_qd(_q4_host(host_lib, x, y, tree), K.qd_dot_plain(x, y, tree))


# every regime at each length: a thread per output, 32 a block (the depth-first
# walk for the tree), the chain with one output a block (chunks of 224), several (chunks of 7
# at P = 32, 44 at P = 5) and a chunk of 3, the tree with one output and with
# several a block
Q4_REGIMES = {False: [(THREAD, 32, 0), (CHAIN, 1, 224), (CHAIN, 5, 44), (CHAIN, 32, 7),
                      (CHAIN, 4, 3)],
              True: [(THREAD, 32, 0), (TREE, 1, 0), (TREE, 3, 0), (TREE, 8, 0)]}


@pytest.mark.parametrize("T", [1, 2, 3, 5, 31, 32, 33, 55, 101, 201, 1000])
@pytest.mark.parametrize("tree", [False, True])
def test_q4_regimes(T, tree, host_lib):
    """Every regime of Q4 bit-equal to the plain version, on 3 x 5 outputs
    (the last block of P = 4 or 8 partly empty)."""
    x, y = _gemm(np.random.default_rng(T), 3, 5, T)
    want = K.qd_dot_plain(x, y, tree)
    for plan in Q4_REGIMES[tree]:
        assert _same_qd(_q4_host(host_lib, x, y, tree, plan), want), plan


def test_q4_sequential_of_no_terms(host_lib):
    """T = 0 in the sequential mode: zeros, in every regime."""
    x, y = _gemm(np.random.default_rng(0), 4, 3, 0)
    for plan in Q4_REGIMES[False]:
        assert _same_qd(_q4_host(host_lib, x, y, False, plan), K.qd_dot_plain(x, y, False))


@pytest.mark.parametrize("M,N,T,tree,want", [
    (55, 3575, 55, False, (THREAD, 256, 0)),       # solve_core
    (33, 2145, 33, False, (THREAD, 64, 0)),        # the 2 workers' solve_core
    (92, 256, 55, False, (THREAD, 64, 0)),         # at kChainOutputsMax
    (91, 258, 55, False, (CHAIN, 32, 7)),          # just under it
    (55, 1040, 55, False, (THREAD, 64, 0)), (33, 1985, 33, False, (THREAD, 256, 0)),
    (55, 65, 55, False, (CHAIN, 32, 7)),           # apply_*_slice
    (33, 33, 33, False, (CHAIN, 16, 14)), (1, 65, 1, False, (CHAIN, 1, 1)),
    (1, 1, 33, False, (CHAIN, 1, 33)), (1, 1, 300, False, (CHAIN, 1, 224)),
    (3, 1, 2, False, (CHAIN, 1, 2)), (4, 3, 0, False, (CHAIN, 1, 1)),
    (1, 1, 201, True, (TREE, 1, 101)), (1, 1, 101, True, (TREE, 1, 51)),
    (33, 33, 33, True, (TREE, 9, 17)), (1, 33, 33, True, (TREE, 1, 17)),
    (1, 1, 1, True, (TREE, 1, 1)), (55, 3575, 55, True, (TREE, 9, 28)),
    (1, 1, 12800, True, (TREE, 1, 6400)), (1, 1, 12801, True, (THREAD, 64, 0)),
])
def test_q4_plan(M, N, T, tree, want, host_lib):
    """The regime rule (csrc/qd_kernels.cu::dot_plan) at the paths' shapes and
    at its edges; every plan launchable (<= 256 threads, the shared memory
    the kernel asks for within the card's 227 KB)."""
    plan = _q4_plan(host_lib, M, N, T, tree)
    regime, P, C, threads, blocks, smem = plan
    assert (regime, P, C) == want
    assert 32 <= threads <= 256 and threads % 32 == 0 and smem <= 227 * 1024
    assert blocks == -(-M * N // P)


def _special(gen, shape):
    """Finite values with special ones strewn in: signed zeros, subnormals,
    inf, -inf, NaN."""
    v = gen.standard_normal(shape)
    flat = v.reshape(-1)
    picks = gen.choice(flat.size, size=min(flat.size, 10), replace=False)
    for k, pick in enumerate(picks):
        flat[pick] = [0.0, -0.0, 5e-324, -2.5e-310, np.inf, -np.inf, np.nan, 1e-300, -0.0,
                      0.0][k]
    return v


def _bits(t):
    """NaN positions and the bits of every other entry."""
    nan = torch.isnan(t)
    return nan, torch.where(nan, torch.zeros_like(t), t).view(torch.int64)


def _same_qd(got, want):
    """Every limb bit-equal (a signed zero too), NaN where the other has NaN."""
    for g, w in zip(got, want):
        (gn, gb), (wn, wb) = _bits(g.reshape(-1)), _bits(w.reshape(-1))
        if not (torch.equal(gn, wn) and torch.equal(gb, wb)):
            return False
    return True


@pytest.mark.parametrize("tree", [False, True])
def test_q4_special_values(tree, host_lib):
    """Q4's regimes where the operands hold signed zeros, subnormals, inf and
    NaN."""
    gen = np.random.default_rng(11)
    M, N, T = 4, 5, 33
    a = QD(*(torch.from_numpy(_special(gen, (M, T))) for _ in range(4)))
    b = QD(*(torch.from_numpy(_special(gen, (T, N))) for _ in range(4)))
    x = QD(*(e[:, None, :].expand(M, N, T) for e in a))
    y = QD(*(e.T[None].expand(M, N, T) for e in b))
    want = K.qd_dot_plain(x, y, tree)
    for plan in Q4_REGIMES[tree]:
        assert _same_qd(_q4_host(host_lib, x, y, tree, plan), want), plan


def test_mul_by_f64_is_qd_mul(host_lib):
    """Q3's leaf, qd_mul_f64(v, g), against qd_mul(v, (g, 0, 0, 0)) (the
    plain version's) on every combination of limbs and factor drawn from
    signed zeros, subnormals, the extremes, inf, -inf, NaN and ordinary
    values: every limb bit-equal, NaN where the other has NaN."""
    vals = np.array([0.0, -0.0, 5e-324, -2.5e-310, 2.2250738585072014e-308, np.inf, -np.inf,
                     np.nan, 1.7976931348623157e308, -1e300, 1.0, -3.7, 1.3e-17, -2.2e-34])
    grid = np.stack(np.meshgrid(*[vals] * 5, indexing="ij")).reshape(5, -1)
    x = QD(*(torch.from_numpy(np.ascontiguousarray(grid[k])) for k in range(4)))
    g = torch.from_numpy(np.ascontiguousarray(grid[4]))
    n = g.numel()
    full, f64 = (torch.empty((4, n), dtype=torch.float64) for _ in range(2))
    host_lib.ttq_host_mul_by_f64(_ptrs(x), VP(g.data_ptr()), LL(n), VP(full.data_ptr()),
                                 VP(f64.data_ptr()))
    assert _same_qd(QD(*f64), QD(*full))
    zero = torch.zeros_like(g)
    assert _same_qd(QD(*full), qd_mul(x, QD(g, zero, zero, zero)))


def _q3_host(host_lib, packed, ind, rows=None):
    """Q3's call through the host emulation, `rows` per block (default: the
    card's, ttq_gather_rows)."""
    _, R, NN, _ = packed.cores.shape
    B, d = ind.shape
    rows = rows or host_lib.ttq_gather_rows(R, LL(B))
    ranks = torch.tensor(packed.ranks, dtype=torch.int32)
    out = torch.empty((4, B), dtype=torch.float64)
    host_lib.ttq_host_q3(VP(packed.cores.data_ptr()), VP(ranks.data_ptr()), d, R, NN,
                         VP(ind.data_ptr()), LL(B), rows, VP(out.data_ptr()))
    return QD(*out)


def _train(gen, ranks, N, values=None):
    from ttcross_tpu_torch.tt.types import TT

    values = values or gen.standard_normal
    return K.pack_tt(TT(tuple(torch.from_numpy(values((ranks[c], N, ranks[c + 1])))
                              for c in range(len(ranks) - 1))))


@pytest.mark.parametrize("ranks,N", [((1, 16, 16, 1), 33), ((1, 33, 33, 1), 33),
                                     ((1, 7, 5, 1), 17), ((1, 1, 1, 1, 1), 201),
                                     ((1, 15, 14, 1), 33), ((1, 32, 32, 1), 9),
                                     ((1, 64, 64, 1), 5), ((1, 3, 64, 2, 1), 4)])
def test_q3_arithmetic(ranks, N, host_lib):
    """Q3's call, rows per block as the card takes them, and one row a
    block, against the plain version."""
    gen = np.random.default_rng(N + sum(ranks))
    packed, B = _train(gen, ranks, N), 129
    ind = torch.from_numpy(gen.integers(0, N, (B, len(ranks) - 1)).astype(np.int32))
    want = K.qd_gather_tt_plain(packed, ind)
    assert _same_qd(_q3_host(host_lib, packed, ind), want)
    assert _same_qd(_q3_host(host_lib, packed, ind, rows=1), want)


@pytest.mark.parametrize("R,B,rows", [(33, 1089, 3), (33, 132, 1), (15, 1089, 3), (64, 1089, 1),
                                      (1, 402, 2), (33, 1, 1), (8, 100000, 57)])
def test_q3_rows_per_block(R, B, rows, host_lib):
    """Rows a block: what kGatherSmem holds, no more than spread B over
    kFillBlocks blocks."""
    assert host_lib.ttq_gather_rows(R, LL(B)) == rows


def test_q3_special_values(host_lib):
    """Q3 where the cores hold signed zeros, subnormals, inf and NaN (the
    full qd multiply, as the plain version)."""
    gen = np.random.default_rng(5)
    packed = _train(gen, (1, 6, 5, 1), 7, values=lambda shape: _special(gen, shape))
    ind = torch.from_numpy(gen.integers(0, 7, (50, 3)).astype(np.int32))
    assert _same_qd(_q3_host(host_lib, packed, ind), K.qd_gather_tt_plain(packed, ind))


def _q1_plan(host_lib, B, d, n):
    plan = (LL * 4)()
    assert host_lib.ttq_q1_plan(LL(B), d, n, plan) == 0
    return tuple(plan)


def _q1_host(host_lib, tables, ind, plan=None):
    """Q1's call through the host emulation with `plan` rows a block or in
    the card's own plan for the shape (ttq_q1_plan); -> QD (B,)."""
    B, d = ind.shape
    n = tables.shape[1]
    plan = _q1_plan(host_lib, B, d, n)[0] if plan is None else plan
    out = torch.empty((4, B), dtype=torch.float64)
    rc = host_lib.ttq_host_q1(VP(tables.data_ptr()), n, VP(ind.data_ptr()), LL(B), d, plan,
                              VP(out.data_ptr()))
    assert rc == 0, f"the host emulation refused {plan} at {(B, d, n)}"
    return QD(*out)


@pytest.fixture(scope="module")
def q1_tables():
    from ttcross_tpu_torch.apps import make_ising_qd

    return make_ising_qd(m=4, n=65, device="cpu")[1].tables


@pytest.mark.parametrize("d", [1, 2, 3, 5, 15, 31])
def test_q1_arithmetic(d, host_lib, q1_tables):
    """Q1's whole call in the card's plan for the shape and in every other
    plan, at B = 1 and B = 83 (every plan's last block partly empty), the
    indices drawn from [-2, n + 2) (clamped)."""
    for B in (1, 83):
        gen = np.random.default_rng(d * 100 + B)
        ind = torch.from_numpy(gen.integers(-2, 67, (B, d)).astype(np.int32))
        want = K.ising_c_integrand_qd_plain(q1_tables, ind)
        assert _same_qd(_q1_host(host_lib, q1_tables, ind), want), B
        for plan in ROWS_PLANS:
            assert _same_qd(_q1_host(host_lib, q1_tables, ind, plan), want), (B, plan)


def test_q1_special_values(host_lib):
    """Q1 where the table holds signed zeros, subnormals, inf and NaN, and
    the indices a view at an odd offset (the staging's 16-byte chunks start
    before the block's first index), in every plan."""
    gen = np.random.default_rng(12)
    n = 9
    tables = torch.from_numpy(_special(gen, (8, n)))
    ind = torch.from_numpy(gen.integers(-3, n + 3, (61, 5)).astype(np.int32))[1:]
    want = K.ising_c_integrand_qd_plain(tables, ind)
    assert any(torch.isnan(e).any() for e in want)
    for plan in [None] + ROWS_PLANS:
        assert _same_qd(_q1_host(host_lib, tables, ind, plan), want), plan


@pytest.mark.parametrize("B,d,n,want", [
    (65, 3, 65, (40, 128, 2, 4672)),            # C_4 n = 65: the smallest batch
    (3575, 3, 65, (40, 128, 90, 4672)),         # its largest
    (1089, 3, 33, (40, 128, 28, 2624)),         # the defect's (n = 33)
    (1, 3, 65, (1, 32, 1, 4208)),               # no more rows than B
    (5280, 3, 65, (40, 128, 132, 4672)),        # a block on each of the 132 SMs
    (5281, 3, 65, (40, 128, 133, 4672)),
    (10 ** 6, 3, 65, (40, 128, 25000, 4672)),
    (200, 31, 65, (40, 128, 5, 9152)),
    (3, 50000, 65, (1, 32, 3, 204192)),         # one row's indices take the shared memory
])
def test_q1_plan(B, d, n, want, host_lib):
    """Q1's launch rule (csrc/ising_rows.cuh::rows_plan): four warps' rows a
    block (10 a warp; a warp on each of an SM's sub-partitions), no more
    rows than B nor than shared memory holds."""
    assert _q1_plan(host_lib, B, d, n) == want


def test_q1_refuses_what_the_card_refuses(host_lib, q1_tables):
    """A plan or shape the card's entry point refuses: the host emulation
    returns -1, the plan rule and its check say so."""
    ind = torch.zeros((10, 3), dtype=torch.int32)
    for plan in [0, -1, 41, 129]:
        with pytest.raises(AssertionError):
            _q1_host(host_lib, q1_tables, ind, plan)
        assert host_lib.ttq_q1_plan_ok(LL(10), 3, 65, plan) == 0
    for P in ROWS_PLANS:
        assert host_lib.ttq_q1_plan_ok(LL(10), 3, 65, P) == 1
    out = (LL * 4)()
    for shape in [(0, 3, 65), (5, 0, 65), (5, 3, 0), (5, 3, 769), (5, 60000, 65)]:
        assert host_lib.ttq_q1_plan(LL(shape[0]), shape[1], shape[2], out) == -1, shape


def _q5_host(host_lib, x, y, threads=None):
    """Q5's call through the host emulation with `threads` a block (default:
    the card's, ttq_div_plan): the output's shape left-padded to four axes,
    each operand at its own strides along them; -> QD of the broadcast
    shape."""
    shape = torch.broadcast_shapes(x[0].shape, y[0].shape)
    lead = 4 - len(shape)
    size = (LL * 4)(*((1,) * lead + tuple(shape)))
    xs, ys = ((LL * 4)(*((0,) * lead + op[0].expand(shape).stride())) for op in (x, y))
    E = max(1, int(np.prod(shape)))
    if threads is None:
        plan = (LL * 2)()
        assert host_lib.ttq_div_plan(LL(E), plan) == 0
        threads = plan[0]
    out = torch.empty((4, *shape), dtype=torch.float64)
    rc = host_lib.ttq_host_q5(_ptrs(x), _ptrs(y), size, xs, ys, threads, VP(out.data_ptr()))
    assert rc == 0, f"the host emulation refused {threads} threads at {tuple(shape)}"
    return QD(*out)


def _q5_operands(gen, shape, divisor, tiny):
    """The engine's layouts: a 0-d quotient, the strided column A[1:, 0] of
    refine_dd's elimination, the accept's (r, n) fiber, init_state's (1, n,
    1) core; the divisor one 0-d value (the pivot, a view into the
    residual; or its expand) or one of x's shape."""
    if shape == "col":
        x = QD(*(e[1:, 0] for e in _qd(gen, (56, 56), tiny)))
        shape = (55,)
    elif shape == ():
        x = QD(*(e[0] for e in _qd(gen, (1,), tiny)))
    else:
        x = _qd(gen, shape, tiny)
    if divisor == "one":
        y = QD(*(e[3, 2] for e in _qd(gen, (5, 4))))
    elif divisor == "expand":
        y = QD(*(e[3, 2].expand(shape) for e in _qd(gen, (5, 4))))
    else:
        y = QD(*(e.reshape(shape) for e in _qd(gen, (max(1, int(np.prod(shape))),))))
    return x, y


Q5_BLOCKS = [32, 64, 128, 256]


@pytest.mark.parametrize("shape", [(), "col", (55, 65), (1, 65, 1), (3, 1, 2, 5)])
@pytest.mark.parametrize("divisor", ["one", "expand", "each"])
@pytest.mark.parametrize("tiny", [False, True])
def test_q5_arithmetic(shape, divisor, tiny, host_lib):
    """Q5's call at the engine's shapes and layouts, in the card's block and
    in every other: four limbs bit-equal to the plain long division."""
    x, y = _q5_operands(np.random.default_rng(len(str(shape)) * 10 + len(divisor)), shape,
                        divisor, tiny)
    want = K.qd_div_plain(x, y)
    assert _same_qd(_q5_host(host_lib, x, y), want)
    for threads in Q5_BLOCKS:
        assert _same_qd(_q5_host(host_lib, x, y, threads), want), threads


def test_q5_broadcast_dividend(host_lib):
    """The dividend broadcast against the divisor (init_state's 1 / delta:
    a (1, 1) one over a 0-d pivot; a row over a column)."""
    gen = np.random.default_rng(3)
    one = torch.ones((1, 1), dtype=torch.float64)
    z = torch.zeros_like(one)
    for x, y in [(QD(one, z, z, z), QD(*(e[0] for e in _qd(gen, (2,))))),
                 (_qd(gen, (1, 7)), _qd(gen, (5, 1)))]:
        assert _same_qd(_q5_host(host_lib, x, y), K.qd_div_plain(x, y))


@pytest.mark.parametrize("divisor", [1e-300, -5e-324, 2.2250738585072014e-308, 1e300,
                                     -1.7976931348623157e308, 3.0, 0.0, -0.0, np.inf, np.nan])
def test_q5_special_values(divisor, host_lib):
    """x holding signed zeros, subnormals, inf, -inf and NaN in every limb,
    over tiny, huge, zero, infinite and NaN divisors (with populated low
    limbs where finite): every limb bit-equal, NaN where the plain version
    has NaN, in every block."""
    gen = np.random.default_rng(17)
    x = QD(*(torch.from_numpy(_special(gen, (9, 13))) for _ in range(4)))
    lo = [divisor * 1e-17 if np.isfinite(divisor) else 0.0, 0.0, 0.0]
    y = QD(*(torch.tensor(v, dtype=torch.float64) for v in [divisor] + lo))
    want = K.qd_div_plain(x, y)
    for threads in [None] + Q5_BLOCKS:
        assert _same_qd(_q5_host(host_lib, x, y, threads), want), threads


@pytest.mark.parametrize("E,want", [
    (1, (128, 1)),              # a 0-d quotient, 1 / pivot (256 would put 2 warps on one)
    (55, (128, 1)),             # the inverse's new column at rank 55
    (65, (128, 1)),             # init_state's (1, 65, 1)
    (3575, (128, 28)),          # the accept's (55, 65): a warp on each sub-partition of 28 SMs
    (16896, (128, 132)),        # a warp on every sub-partition of the card
    (16897, (256, 67)),         # past it: two warps on the busiest, the largest block
    (33792, (256, 132)),        # a block of 256 on every SM
    (10 ** 6, (256, 3907)),
])
def test_q5_plan(E, want, host_lib):
    """Q5's block rule (csrc/qd_kernels.cu::div_block): the fewest warps on
    the busiest SM sub-partition, the larger block on a tie."""
    plan = (LL * 2)()
    assert host_lib.ttq_div_plan(LL(E), plan) == 0
    assert tuple(plan) == want


def test_q5_refuses_what_the_card_refuses(host_lib):
    """A block the card's entry point refuses, and no quotients."""
    x = _qd(np.random.default_rng(0), (4,))
    for threads in [0, 16, 48, 512]:
        with pytest.raises(AssertionError):
            _q5_host(host_lib, x, x, threads)
    assert host_lib.ttq_div_plan(LL(0), (LL * 2)()) == -1


def test_q5_wrapper_on_cpu_takes_the_plain_path():
    """qd_div (ops/qd.py) and qd_div_fused on CPU tensors: the plain long
    division, no launch counted; planned refuses them."""
    from ttcross_tpu_torch.ops.qd import qd_div

    x, y = _q5_operands(np.random.default_rng(9), (55, 65), "one", False)
    K.reset_launch_counts()
    want = K.qd_div_plain(x, y)
    assert _same_qd(K.qd_div_fused(x, y), want)
    assert _same_qd(qd_div(x, y), want)
    assert K.launch_counts()["qd_div"] == 0 and K.launch_shapes()["qd_div"] == {}
    with pytest.raises(ValueError):
        K.planned(K.qd_div_fused, 128, x, y)
