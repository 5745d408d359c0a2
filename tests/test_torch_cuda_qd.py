"""The qd tier's CUDA kernels (csrc/qd_kernels.cu, Q1-Q4) on the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_qd.py

Tolerance: none.  Each qd kernel computes in the operation order of
ops/qd.py with intrinsics nvcc does not contract, and eager torch rounds
every operation once, so a kernel equals its plain version on the card bit
for bit, all four limbs (and Q2's index)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("ranks,B,N", [((1, 16, 16, 1), 1089, 33), ((1, 33, 33, 1), 1089, 33),
                                       ((1, 33, 33, 1), 136, 33), ((1, 7, 5, 1), 99, 17),
                                       ((1, 1, 1, 1, 1), 402, 201)])
def test_q3_is_its_plain_version(ranks, B, N, cuda_device, gen):
    from ttcross_tpu_torch.tt.types import TT

    d = len(ranks) - 1
    t = TT(tuple(torch.as_tensor(gen.standard_normal((ranks[c], N, ranks[c + 1]))).to(cuda_device)
                 for c in range(d)))
    packed = K.pack_tt(t)
    ind = torch.as_tensor(gen.integers(0, N, (B, d)), dtype=torch.int32).to(cuda_device)
    assert _same(K.qd_gather_tt_fused(packed, ind), K.qd_gather_tt_plain(packed, ind))


@pytest.mark.parametrize("d", [3, 15, 31])
@pytest.mark.parametrize("B", [3575, 240, 1])
def test_q1_is_its_plain_version(d, B, cuda_device, gen):
    from ttcross_tpu_torch.apps import make_ising_qd

    _, fun_qd, _ = make_ising_qd(m=d + 1, n=65, device=cuda_device)
    ind = torch.as_tensor(gen.integers(0, 65, (B, d)), dtype=torch.int32).to(cuda_device)
    assert _same(K.ising_c_integrand_qd_fused(fun_qd.tables, ind),
                 K.ising_c_integrand_qd_plain(fun_qd.tables, ind))


def test_wrappers_route_by_device(cuda_device, gen):
    """A CPU tensor runs the plain version (no launch counted); a card tensor
    launches the kernel, one launch per call."""
    v, x, y = _qd(gen, (5,), "cpu"), _qd(gen, (5, 4), "cpu"), _qd(gen, (5, 4), "cpu")
    K.reset_launch_counts()
    K.qd_score_residual_argmax(v, x, y)
    K.qd_dot(QD(*(e[None] for e in x)), QD(*(e[None] for e in y)), True)
    assert K.launch_counts()["qd_score_residual_argmax"] == 0
    assert K.launch_counts()["qd_dot"] == 0
    vc, xc, yc = (QD(*(e.to(cuda_device) for e in q)) for q in (v, x, y))
    K.qd_score_residual_argmax(vc, xc, yc)
    K.qd_dot(QD(*(e[None] for e in xc)), QD(*(e[None] for e in yc)), False)
    counts = K.launch_counts()
    assert counts["qd_score_residual_argmax"] == 1 and counts["qd_dot"] == 1
