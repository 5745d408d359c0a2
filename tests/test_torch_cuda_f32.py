"""The f32 instantiations of the port's CUDA kernels, and the capped,
adaptive and f32 sweeps, on the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_f32.py

Tolerances: an f32 kernel sums in its f64 twin's order, in f32; its plain
version on the card (cuBLAS sgemm without TF32, torch's cumprod) in
another order, so scores and values agree to a few f32 ulps of the
largest term (1e-5 relative)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

F32_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(8765)


def _score_args(gen, shape, dev):
    """f32 kernel-A inputs whose best score is clear of the second best by
    more than f32 rounding."""
    M, Kc, R = shape
    while True:
        arrs = [gen.standard_normal((M, Kc)), gen.standard_normal((M, R)),
                gen.standard_normal((R, Kc))]
        mask = gen.random((M, Kc)) > 0.2
        res = np.abs(arrs[0] - arrs[1] @ arrs[2])
        top = np.sort(np.where(mask, res, -1).ravel())[-2:]
        if top[1] - top[0] > 1e-4 * top[1]:
            break
    return [torch.as_tensor(a, dtype=torch.float32).to(dev) for a in arrs] + \
        [torch.as_tensor(mask).to(dev)]


@pytest.mark.parametrize("shape", [(1950, 1, 30), (1, 1950, 30), (1300, 1, 20), (1, 1300, 20),
                                   (792, 1, 24), (1, 96, 24), (48, 80, 6), (1950, 1950, 30),
                                   (129, 257, 17), (3, 5000, 17), (100000, 1, 30)])
def test_f32_score_kernel_matches_plain(shape, gen, cuda_device):
    args = _score_args(gen, shape, cuda_device)
    n0 = K.score_residual_argmax.launches
    flat, score, resid = K.score_residual_argmax(*args)
    pflat, pscore, presid = K.score_residual_argmax_plain(*args)
    torch.cuda.synchronize()
    assert K.score_residual_argmax.launches == n0 + 1
    assert score.dtype == resid.dtype == torch.float32
    assert int(flat) == int(pflat)
    np.testing.assert_allclose(float(score), float(pscore), rtol=F32_RTOL)
    np.testing.assert_allclose(float(resid), float(presid), rtol=F32_RTOL)
    shapes = K.launch_shapes()["score_residual_argmax"]
    assert shapes.get((*shape, "f32"), 0) >= 1


def test_f32_two_d_path_gives_the_fiber_paths_bits(gen, cuda_device):
    """The SIMT 2-D kernel sums each element as the fiber kernel does
    (fmaf over r in order from 0): a one-column matrix scored as (M, 2)
    with the second column masked gives the column fiber's residual."""
    vals, colf, rowf, mask = _score_args(gen, (777, 1, 13), cuda_device)
    _, _, r_fiber = K.score_residual_argmax(vals, colf, rowf, mask)
    vals2 = torch.cat([vals, torch.zeros_like(vals)], dim=1).contiguous()
    rowf2 = torch.cat([rowf, torch.zeros_like(rowf)], dim=1).contiguous()
    mask2 = torch.cat([mask, torch.zeros_like(mask)], dim=1).contiguous()
    _, _, r_2d = K.score_residual_argmax(vals2, colf, rowf2, mask2)
    assert float(r_2d) == float(r_fiber)


@pytest.mark.parametrize("P,M,Kc,R", [(254, 170, 1, 10), (254, 1, 170, 10), (4, 1300, 1, 20),
                                      (4, 1, 1300, 20)])
def test_f32_batched_kernel_matches_plain_and_single_launches(P, M, Kc, R, gen, cuda_device):
    vals, colf, rowf = (torch.as_tensor(gen.standard_normal(s), dtype=torch.float32).to(cuda_device)
                        for s in ((P, M, Kc), (P, M, R), (P, R, Kc)))
    mask = torch.as_tensor(gen.random((P, M, Kc)) > 0.2).to(cuda_device)
    got = K.score_residual_argmax_batched(vals, colf, rowf, mask)
    want = K.score_residual_argmax_batched_plain(vals, colf, rowf, mask)
    single = [K.score_residual_argmax(vals[p], colf[p], rowf[p], mask[p]) for p in range(P)]
    torch.cuda.synchronize()
    assert got[1].dtype == torch.float32
    for i in range(3):
        assert torch.equal(got[i], torch.stack([s[i] for s in single]))
    close = (got[0] == want[0]).float().mean()
    assert float(close) > 0.98       # f32 near-ties may go either way
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=F32_RTOL)


@pytest.mark.parametrize("L,B,d,n", [(1, 1300, 6, 65), (1, 170, 6, 65), (2, 1950, 5, 65),
                                     (1, 5200, 6, 65), (2, 0, 5, 65)])
def test_f32_lookup_kernel_is_the_table_entry(L, B, d, n, gen, cuda_device):
    tables = torch.as_tensor(gen.standard_normal((L, n)), dtype=torch.float32).to(cuda_device)
    ind = torch.as_tensor(gen.integers(-2, n + 2, size=(B, d)).astype(np.int32)).to(cuda_device)
    got = K.small_table_lookup(tables, ind)
    assert got.dtype == torch.float32
    assert torch.equal(got, K.small_table_lookup_plain(tables, ind))


@pytest.mark.parametrize("B", [1, 1950, 4097])
@pytest.mark.parametrize("d", [5, 8, 31, 97, 255])
@pytest.mark.parametrize("kind", ["C", "D", "E"])
def test_f32_integrand_kernel_matches_plain(kind, d, B, gen, cuda_device):
    """Both paths (a row per thread to d = 8, a row per warp above) in
    f32: against the plain version in f32 on the card and on the CPU.  The
    a-term's ratios of nearby prefix products magnify an ulp (as in f64):
    the f32 plain version is up to 1.8e-4 off the f64 one for D and E on
    the CPU (C: 1.3e-6), so D and E are held at 1e-3 and C at 1e-5; long
    prefix products of nodes in [0, 1] reach f32's subnormals, where the
    absolute tolerance takes over."""
    from ttcross_tpu_torch.apps import make_ising

    p = make_ising(kind, d + 1, 33, device=cuda_device, dtype=torch.float32)
    ind = gen.integers(0, p.n, size=(B, d)).astype(np.int32)
    ind[0, 0] = -1
    ind = torch.as_tensor(ind).to(cuda_device)
    got = K.ising_integrand_fused(p.tables, ind, kind)
    assert got.dtype == torch.float32 and float(got[0]) == 0.0
    rtol = 1e-5 if kind == "C" else 1e-3
    for want in (K.ising_integrand_plain(p.tables, ind, kind).cpu(),
                 K.ising_integrand_plain(p.tables.cpu(), ind.cpu(), kind)):
        g = got.cpu()
        assert bool(((g - want).abs() <= rtol * want.abs() + 1e-37).all())


def test_f32_wrappers_raise_and_never_convert(cuda_device):
    """Mixed dtypes, and dtypes no kernel is built for, raise: no input is
    converted and no call goes to the plain version."""
    f32 = dict(dtype=torch.float32, device=cuda_device)
    vals, colf, rowf = torch.zeros((8, 1), **f32), torch.zeros((8, 3), **f32), torch.zeros((3, 1), **f32)
    mask = torch.ones((8, 1), dtype=torch.bool, device=cuda_device)
    n0 = K.score_residual_argmax.launches
    with pytest.raises(TypeError):
        K.score_residual_argmax(vals, colf.double(), rowf, mask)
    with pytest.raises(TypeError):
        K.score_residual_argmax(vals.half(), colf.half(), rowf.half(), mask)
    with pytest.raises(TypeError):
        K.score_residual_argmax_batched(vals[None], colf[None], rowf[None].double(), mask[None])
    assert K.score_residual_argmax.launches == n0
    with pytest.raises(TypeError):
        K.small_table_lookup(torch.zeros((1, 9), dtype=torch.float16, device=cuda_device),
                             torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):    # 2 x 6200 f32 exceed the 48 KB table budget
        K.small_table_lookup(torch.zeros((2, 6200), **f32),
                             torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(TypeError):
        K.ising_integrand_fused(torch.zeros((2, 9), dtype=torch.float16, device=cuda_device),
                                torch.zeros((4, 5), dtype=torch.int32, device=cuda_device), "C")


@pytest.mark.parametrize("extra", [dict(caps=(6, 12, 12, 6)), dict(adaptive=4096.0),
                                   dict(dtype=torch.float32)])
def test_capped_adaptive_and_f32_sweeps_make_no_host_sync(extra, cuda_device):
    """The capped, the adaptive (its gate a tensor, the gated hunt dropped
    by torch.where) and the f32 sequential sweeps make no host sync."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine

    dt = extra.get("dtype", torch.float64)
    p = make_ising("C", 6, 64, device=cuda_device, dtype=dt)
    se, sp = precision_thresholds(dt)
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=12, piv=1, small_element=se,
                      small_pivot=sp, **{k: v for k, v in extra.items() if k != "dtype"})
    kit = make_engine(p.fun, cfg, cuda_device, dt)
    st = kit.init_fn()
    U = torch.rand((3, p.d - 1, 2, 2 * (12 + p.n)), dtype=torch.float64, device=cuda_device)
    st = kit.sweep_fn(st, 1, U[0])      # the first sweep builds the capped grids
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (2, 3):
            st = kit.sweep_fn(st, it, U[it - 1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.rk[1:-1].min()) >= 2 and st.cores.dtype == dt


@pytest.mark.parametrize("extra", [dict(rank_caps=[5, 8, 5]), dict(rank_chunks=[4, 8]),
                                   dict(adaptive=True), dict(dtype=torch.float32),
                                   dict(dtype=torch.float32, pivoting=-1)])
def test_small_capped_chunked_adaptive_f32_cross_matches_the_cpu(extra, cuda_device):
    """C_5 at n = 17: the card and the CPU take the same pivots (f32:
    within f32 ties, so ranks and evaluations within a few percent)."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    dt = extra.get("dtype", torch.float64)
    runs = []
    for dev in (cuda_device, "cpu"):
        p = make_ising("C", 5, 17, device=dev, dtype=dt)
        runs.append(cross(p.fun, [p.n] * p.d, max_rank=8, accuracy=1e-10, quad=[p.quad_weights] * p.d,
                          truth=p.truth, device=dev, **{"pivoting": 1, **extra}))
    card, host = runs
    if dt == torch.float64:
        assert (card.ranks, card.neval, card.padded_evals) == (host.ranks, host.neval,
                                                                host.padded_evals)
        np.testing.assert_allclose(card.values, host.values, rtol=1e-12)
    else:
        assert abs(card.neval - host.neval) <= 0.05 * host.neval
        assert abs(card.values[-1] / host.values[-1] - 1) < 1e-5
