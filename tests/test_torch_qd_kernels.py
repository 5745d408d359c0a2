"""The qd kernels' arithmetic (csrc/qd_kernels.cu, Q1-Q4) on the CPU.

The kernels run only on a card (tests/test_torch_cuda_qd.py holds them to
their plain versions there, Q2's argmax too).  Their per-output functions
(the distill sweeps, the qd operations, the pairwise tree walked depth
first, each kernel's row or output) are written once for both: compiled by
a host C++ compiler with -DTTQ_HOST and -ffp-contract=off, the file gives
host entry points that compute one output each with those functions.  Here
every output is held to the plain versions (ops/kernels.py::*_plain) at
the slice's shapes and layouts.  Tolerance: none, every limb bit-equal.
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

from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.qd import QD
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


@pytest.mark.parametrize("kind,B,T", [("lottery", 240, 55), ("col", 3575, 55), ("row", 715, 55),
                                      ("lottery", 97, 33), ("col", 65, 7), ("row", 17, 1),
                                      ("accept", 1, 55), ("lottery", 30, 201)])
@pytest.mark.parametrize("tiny", [False, True])
def test_q2_arithmetic(kind, B, T, tiny, host_lib):
    gen = np.random.default_rng(B * 7 + T)
    vals, x, y = _qd(gen, (B,), tiny), _qd(gen, (B, T), tiny), _qd(gen, (B, T))
    if kind == "col":
        y = QD(*(e[0].expand(B, T) for e in y))
    elif kind == "row":
        x = QD(*(e[0].expand(B, T) for e in x))
        y = QD(*(e.T for e in _qd(gen, (T, B))))
    args = (_ptrs(vals), _ptrs(x), _ptrs(y), LL(B), T, *(LL(s) for s in x[0].stride()),
            *(LL(s) for s in y[0].stride()))
    out = _outs(B, lambda r, p: host_lib.ttq_host_q2_row(*args, LL(r), p))
    assert _same(out, K.qd_score_residual_argmax_plain(vals, x, y)[0])


Q4_CASES = [(M, N, T, tree) for M, N, T in [(715, 55, 55), (55, 65, 55), (1, 33, 33),
                                              (33, 33, 65), (1, 1, 201), (5, 7, 1), (4, 3, 0)]
            for tree in (False, True) if T > 0 or not tree]   # the tree takes T >= 1


@pytest.mark.parametrize("M,N,T,tree", Q4_CASES)
def test_q4_arithmetic(M, N, T, tree, host_lib):
    gen = np.random.default_rng(M + N + T)
    a, b = _qd(gen, (M, T)), _qd(gen, (T, N))
    x = QD(*(e[:, None, :].expand(M, N, T) for e in a))
    y = QD(*(e.T[None].expand(M, N, T) for e in b))
    args = (_ptrs(x), _ptrs(y), LL(M), LL(N), T, *(LL(s) for s in x[0].stride()),
            *(LL(s) for s in y[0].stride()), int(tree))
    out = _outs(M * N, lambda e, p: host_lib.ttq_host_q4_out(*args, LL(e // N), LL(e % N), p))
    assert _same(out, K.qd_dot_plain(x, y, tree))


@pytest.mark.parametrize("ranks,N", [((1, 16, 16, 1), 33), ((1, 33, 33, 1), 33),
                                     ((1, 7, 5, 1), 17), ((1, 1, 1, 1, 1), 201)])
def test_q3_arithmetic(ranks, N, host_lib):
    """Each core's step of every row: v' from v, the row's index and the
    packed core, v carried from core to core as the kernel carries it."""
    from ttcross_tpu_torch.tt.types import TT

    gen = np.random.default_rng(N)
    d, B = len(ranks) - 1, 129
    t = TT(tuple(torch.from_numpy(gen.standard_normal((ranks[c], N, ranks[c + 1])))
                 for c in range(d)))
    packed = K.pack_tt(t)
    ind = gen.integers(0, N, (B, d))
    _, R, NN, _ = packed.cores.shape
    cores, row_size = packed.cores.data_ptr(), 8
    out = torch.empty((B, 4), dtype=torch.float64)
    for row in range(B):
        v = torch.zeros((4, 1), dtype=torch.float64)
        v[0, 0] = 1.0
        for c in range(d):
            g0 = cores + row_size * (c * R * NN * R + int(ind[row, c]) * R)
            nxt = _outs(ranks[c + 1], lambda j, p: host_lib.ttq_host_q3_out(
                _ptrs(v), VP(g0 + row_size * j), ranks[c], NN, R, p))
            v = nxt.T.contiguous()
        out[row] = v[:, 0]
    want = K.qd_gather_tt_plain(packed, torch.from_numpy(ind.astype(np.int32)))
    assert _same(out, want)


@pytest.mark.parametrize("d", [3, 15, 31])
def test_q1_arithmetic(d, host_lib):
    from ttcross_tpu_torch.apps import make_ising_qd

    gen = np.random.default_rng(d)
    fun_qd = make_ising_qd(m=d + 1, n=65, device="cpu")[1]
    B = 200
    ind = torch.from_numpy(gen.integers(-2, 67, (B, d)).astype(np.int32))   # clamped
    tab, ip = VP(fun_qd.tables.data_ptr()), ind.data_ptr()
    out = _outs(B, lambda r, p: host_lib.ttq_host_q1_row(tab, 65, VP(ip + 4 * r * d), d, p))
    assert _same(out, K.ising_c_integrand_qd_plain(fun_qd.tables, ind))
