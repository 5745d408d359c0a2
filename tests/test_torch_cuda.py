"""The port's CUDA kernels and its engine on the card, against their plain
PyTorch versions and the CPU run.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX,
so that they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

# kernel A sums over r in order, cuBLAS in its own order
SCORE_RTOL = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(4321)


def _score_args(gen, M, Kc, R, dev, frac=0.2):
    arrs = (gen.standard_normal((M, Kc)), gen.standard_normal((M, R)),
            gen.standard_normal((R, Kc)), gen.random((M, Kc)) > frac)
    return [torch.as_tensor(a).to(dev) for a in arrs]


@pytest.mark.parametrize("shape", [(48, 80, 6), (130, 1, 5), (1, 130, 5), (1950, 1, 30),
                                   (1, 1950, 30), (700, 900, 30), (3, 5000, 17)])
def test_score_kernel_matches_plain(shape, gen, cuda_device):
    args = _score_args(gen, *shape, cuda_device)
    n0 = K.score_residual_argmax.launches
    flat, score, resid = K.score_residual_argmax(*args)
    pflat, pscore, presid = K.score_residual_argmax_plain(*args)
    torch.cuda.synchronize()
    assert K.score_residual_argmax.launches == n0 + 1
    assert int(flat) == int(pflat)
    np.testing.assert_allclose(float(score), float(pscore), rtol=SCORE_RTOL)
    np.testing.assert_allclose(float(resid), float(presid), rtol=SCORE_RTOL)


def test_score_kernel_one_entry_tie_and_nan(cuda_device):
    f64 = dict(dtype=torch.float64, device=cuda_device)
    vals = torch.zeros((6, 7), **f64)
    zc, zr = torch.zeros((6, 2), **f64), torch.zeros((2, 7), **f64)
    mask = torch.zeros((6, 7), dtype=torch.bool, device=cuda_device)
    mask[3, 2] = True
    assert int(K.score_residual_argmax(vals, zc, zr, mask)[0]) == 3 * 7 + 2
    mask[:] = True
    vals[4, 0] = vals[0, 6] = 5.0
    assert int(K.score_residual_argmax(vals, zc, zr, mask)[0]) == 6    # first of the ties
    vals[2, 1] = vals[3, 3] = float("nan")
    got = K.score_residual_argmax(vals, zc, zr, mask)
    assert int(got[0]) == int(K.score_residual_argmax_plain(vals, zc, zr, mask)[0]) == 15
    assert torch.isnan(got[1])


@pytest.mark.parametrize("B,d,n", [(1950, 5, 65), (190, 5, 65), (4097, 17, 33), (0, 5, 65)])
def test_lookup_kernel_matches_plain(B, d, n, gen, cuda_device):
    tables = torch.as_tensor(gen.standard_normal((2, n))).to(cuda_device)
    ind = torch.as_tensor(gen.integers(-2, n + 2, size=(B, d)).astype(np.int32)).to(cuda_device)
    got = K.small_table_lookup(tables, ind)
    assert torch.equal(got, K.small_table_lookup_plain(tables, ind))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    tables = torch.zeros((2, 9), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.small_table_lookup(tables, torch.zeros((4, 3), dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        K.small_table_lookup(torch.zeros((2, 4000), dtype=torch.float64, device=cuda_device),
                             torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    vals = torch.zeros((8, 6), dtype=torch.float64, device=cuda_device)
    colf = torch.zeros((8, 3), dtype=torch.float64, device=cuda_device)
    rowf = torch.zeros((6, 3), dtype=torch.float64, device=cuda_device).T    # not contiguous
    with pytest.raises(ValueError):
        K.score_residual_argmax(vals, colf, rowf, torch.ones((8, 6), dtype=torch.bool,
                                                             device=cuda_device))


def test_small_cross_on_the_card_matches_the_cpu(cuda_device):
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    runs = {}
    K.reset_launch_counts()
    for where in ("cpu", cuda_device):
        p = make_ising("C", 5, 17, device=where)
        runs[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=8, pivoting=1,
                                 quad=[p.quad_weights] * p.d, truth=p.truth,
                                 return_state=True, device=where)
    counts = K.launch_counts()
    c, g = runs["cpu"], runs[str(cuda_device)]
    assert min(counts.values()) > 0
    assert all(t.device.type == "cuda" for t in g.state)
    assert (g.ranks, g.neval, g.sweeps) == (c.ranks, c.neval, c.sweeps)
    np.testing.assert_allclose(g.values, c.values, rtol=1e-11)


def test_rounding_on_the_card_matches_the_host(cuda_device):
    """svd_round of the C_6 headline's rank-30 train on the card gives the
    same quadrature value as on the host (LAPACK) to 1e-14: cuSOLVER's
    Jacobi SVD, torch's default on CUDA, missed this by ~2.6e-14."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.tt.ops import contract
    from ttcross_tpu_torch.tt.ortho import svd_round
    from ttcross_tpu_torch.tt.types import TT

    p = make_ising("C", 6, 64, device=cuda_device)
    w = [p.quad_weights] * p.d
    res = cross(p.fun, [p.n] * p.d, max_rank=30, accuracy=500 * 2.2e-16, pivoting=1,
                key=7, device=cuda_device)
    host = TT(tuple(c.cpu() for c in res.tt.cores))
    on_card = float(contract(svd_round(res.tt, tol=0.0, rmax=24), w))
    on_host = float(contract(svd_round(host, tol=0.0, rmax=24), w))
    assert abs(on_card - on_host) <= 1e-14 * abs(on_host)


def test_a_sweep_makes_no_host_sync(cuda_device):
    """Every decision inside a sweep stays on the card: one sweep of the
    headline's engine runs under torch's sync debug mode set to raise."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine

    p = make_ising("C", 6, 64, device=cuda_device)
    se, sp = precision_thresholds(torch.float64)
    for piv in (1, 0, -1):
        cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=12, piv=piv,
                          small_element=se, small_pivot=sp)
        kit = make_engine(p.fun, cfg, cuda_device)
        st = kit.init_fn()
        U = torch.rand((2, p.d - 1, 2, 2 * (12 + p.n)), dtype=torch.float64,
                       device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for it in (1, 2):
                st = kit.sweep_fn(st, it, U[it - 1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert int(st.rk[1:-1].min()) >= 2
