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
                                   (1, 1950, 30), (700, 900, 30), (3, 5000, 17),
                                   (100000, 1, 30), (1, 70001, 30), (1950, 1950, 30),
                                   (129, 257, 17), (37, 1001, 3), (8192, 8192, 32)])
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


def _zero_factors(M, Kc, R, dev):
    f64 = dict(dtype=torch.float64, device=dev)
    return torch.zeros((M, R), **f64), torch.zeros((R, Kc), **f64)


@pytest.mark.parametrize("M,Kc", [(1950, 1), (1, 1950), (100000, 1), (1950, 1950), (129, 257)])
def test_score_kernel_ties_nan_and_all_masked_across_blocks(M, Kc, cuda_device):
    """Ties in different blocks (and cluster ranks) go to the first flat
    index, a NaN in the last block wins, and an all-masked matrix gives
    index 0 and score -1, as the plain version does."""
    colf, rowf = _zero_factors(M, Kc, 30, cuda_device)
    vals = torch.zeros((M, Kc), dtype=torch.float64, device=cuda_device)
    mask = torch.ones((M, Kc), dtype=torch.bool, device=cuda_device)
    n = M * Kc
    first, second = n // 7, n - 2          # several blocks / tiles apart
    vals.view(-1)[second] = -3.0
    vals.view(-1)[first] = 3.0
    got = K.score_residual_argmax(vals, colf, rowf, mask)
    assert int(got[0]) == int(K.score_residual_argmax_plain(vals, colf, rowf, mask)[0]) == first
    assert float(got[1]) == 3.0 and float(got[2]) == 3.0
    vals.view(-1)[n - 1] = float("nan")
    got = K.score_residual_argmax(vals, colf, rowf, mask)
    assert int(got[0]) == n - 1 and torch.isnan(got[1])
    mask.zero_()
    got = K.score_residual_argmax(vals, colf, rowf, mask)
    want = K.score_residual_argmax_plain(vals, colf, rowf, mask)
    assert int(got[0]) == int(want[0]) == 0 and float(got[1]) == float(want[1]) == -1.0


@pytest.mark.parametrize("shape", [(1950, 1, 30), (1, 1950, 30)])
def test_score_kernel_fiber_is_one_kernel(shape, gen, cuda_device):
    """A rook pass's call of kernel A is one launch on the card."""
    from torch.profiler import ProfilerActivity, profile

    args = _score_args(gen, *shape, cuda_device)
    K.score_residual_argmax(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            K.score_residual_argmax(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    assert [e.key for e in kern] and all("score_fiber_kernel" in e.key for e in kern)
    assert 0 < sum(e.count for e in kern) <= 10


@pytest.mark.parametrize("P,M,Kc,R", [(254, 170, 1, 10), (254, 1, 170, 10), (1022, 170, 1, 10),
                                      (1022, 1, 170, 10), (1, 170, 1, 10), (1, 1, 170, 10),
                                      (7, 1300, 1, 30), (7, 1, 1300, 30), (5, 3, 1, 2),
                                      (33, 171, 1, 9), (33, 1, 171, 9)])
def test_score_batched_kernel_matches_plain_and_the_single_kernel(P, M, Kc, R, gen, cuda_device):
    """One launch for all bonds, half of them fully masked: the plain
    version's indices and its residuals to 1e-14 relative of the largest
    (f64 sums in another order), and the bits of P single-fiber launches."""
    vals, colf, rowf = (torch.as_tensor(gen.standard_normal(sh)).to(cuda_device)
                        for sh in ((P, M, Kc), (P, M, R), (P, R, Kc)))
    mask = torch.as_tensor(gen.random((P, M, Kc)) > 0.2).to(cuda_device)
    mask[::2] = False
    n0, n1 = K.score_residual_argmax_batched.launches, K.score_residual_argmax.launches
    got = K.score_residual_argmax_batched(vals, colf, rowf, mask)
    want = K.score_residual_argmax_batched_plain(vals, colf, rowf, mask)
    torch.cuda.synchronize()
    assert K.score_residual_argmax_batched.launches == n0 + 1
    assert K.score_residual_argmax.launches == n1
    assert torch.equal(got[0], want[0])
    assert got[0][::2].abs().sum() == 0 and bool((got[1][::2] == -1.0).all())
    scale = float(want[2].abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-14 * scale
    single = [K.score_residual_argmax(vals[p], colf[p], rowf[p], mask[p]) for p in range(P)]
    for i in range(3):
        assert torch.equal(got[i], torch.stack([x[i] for x in single]))


def test_score_batched_kernel_first_maximum_nan_and_what_it_does_not_take(cuda_device):
    f64 = dict(dtype=torch.float64, device=cuda_device)
    P, M, R = 3, 400, 3
    vals = torch.zeros((P, M, 1), **f64)
    vals[0, 300, 0] = vals[0, 37, 0] = 4.0          # ties in different warps: the first
    vals[1, 399, 0] = float("nan")
    vals[1, 5, 0] = 9.0
    mask = torch.ones((P, M, 1), dtype=torch.bool, device=cuda_device)
    mask[2] = False
    colf, rowf = torch.zeros((P, M, R), **f64), torch.zeros((P, R, 1), **f64)
    got = K.score_residual_argmax_batched(vals, colf, rowf, mask)
    want = K.score_residual_argmax_batched_plain(vals, colf, rowf, mask)
    assert got[0].tolist() == want[0].tolist() == [37, 399, 0]
    assert float(got[1][0]) == 4.0 and torch.isnan(got[1][1]) and float(got[1][2]) == -1.0
    with pytest.raises(ValueError, match="fibers"):
        K.score_residual_argmax_batched(torch.zeros((2, 4, 5), **f64), torch.zeros((2, 4, 3), **f64),
                                        torch.zeros((2, 3, 5), **f64),
                                        torch.ones((2, 4, 5), dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        K.score_residual_argmax_batched(vals, colf, rowf.cpu(), mask)
    with pytest.raises(ValueError):
        K.score_residual_argmax_batched(vals, colf.transpose(0, 1).contiguous().transpose(0, 1),
                                        rowf, mask)            # not contiguous


# the shapes of the family (4 lanes), cross_batch(mesh=) (2 a rank) and the
# lane jacobi (4 lanes x 5 bonds), where the rule takes a cluster per fiber
BATCHED_LANE_SHAPES = [(P, M, Kc, 20) for P in (2, 4, 20) for M, Kc in ((1300, 1), (1, 1300))]


@pytest.mark.parametrize("cluster", [0, 1, 2, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("P,M,Kc,R", BATCHED_LANE_SHAPES + [(5, 1, 170, 10), (3, 4000, 1, 30)])
def test_score_batched_cluster_body_is_single_launches_bit_for_bit(P, M, Kc, R, dtype, cluster,
                                                                   gen, cuda_device):
    """Both bodies of the batched kernel A (cluster 1: a block per fiber;
    2, 16 or the rule's, 0) give the bits of one single-fiber launch per
    fiber, a fully masked fiber (0, -1) among them."""
    vals, colf, rowf = (torch.as_tensor(gen.standard_normal(sh), dtype=dtype).to(cuda_device)
                        for sh in ((P, M, Kc), (P, M, R), (P, R, Kc)))
    mask = torch.as_tensor(gen.random((P, M, Kc)) > 0.2).to(cuda_device)
    mask[1] = False
    args = (vals, colf, rowf, mask)
    if cluster:
        got = K.planned(K.score_residual_argmax_batched, cluster, *args)
    else:
        got = K.score_residual_argmax_batched(*args)
    single = [K.score_residual_argmax(*(a[p] for a in args)) for p in range(P)]
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(got[i], torch.stack([x[i] for x in single]))
    assert int(got[0][1]) == 0 and float(got[1][1]) == -1.0
    if not cluster and max(M, Kc) == 1300:
        assert K._plan(M, Kc, R, torch.cuda.get_device_properties(0).multi_processor_count,
                       bonds=P, esz=vals.element_size()).cluster >= 2


@pytest.mark.parametrize("cluster", [1, 4, 11])
def test_score_batched_cluster_body_first_maximum_and_nan(cluster, cuda_device):
    f64 = dict(dtype=torch.float64, device=cuda_device)
    P, M, R = 3, 1300, 3
    vals = torch.zeros((P, M, 1), **f64)
    vals[0, 1200, 0] = vals[0, 37, 0] = 4.0          # ties in different blocks: the first
    vals[1, 1299, 0] = float("nan")
    vals[1, 5, 0] = 9.0
    mask = torch.ones((P, M, 1), dtype=torch.bool, device=cuda_device)
    mask[2] = False
    colf, rowf = torch.zeros((P, M, R), **f64), torch.zeros((P, R, 1), **f64)
    got = K.planned(K.score_residual_argmax_batched, cluster, vals, colf, rowf, mask)
    assert got[0].tolist() == [37, 1299, 0]
    assert float(got[1][0]) == 4.0 and torch.isnan(got[1][1]) and float(got[1][2]) == -1.0


@pytest.mark.parametrize("shape", [(254, 170, 1, 10), (1022, 1, 170, 10)])
def test_score_batched_kernel_is_one_kernel(shape, gen, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    P, M, Kc, R = shape
    args = [torch.as_tensor(a).to(cuda_device) for a in
            (gen.standard_normal((P, M, Kc)), gen.standard_normal((P, M, R)),
             gen.standard_normal((P, R, Kc)), gen.random((P, M, Kc)) > 0.2)]
    K.score_residual_argmax_batched(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            K.score_residual_argmax_batched(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    assert [e.key for e in kern] and all("score_fiber_batched_kernel" in e.key for e in kern)
    assert 0 < sum(e.count for e in kern) <= 10


@pytest.mark.parametrize("B,d,n", [(1950, 5, 65), (190, 5, 65), (4097, 17, 33), (0, 5, 65)])
def test_lookup_kernel_matches_plain(B, d, n, gen, cuda_device):
    tables = torch.as_tensor(gen.standard_normal((2, n))).to(cuda_device)
    ind = torch.as_tensor(gen.integers(-2, n + 2, size=(B, d)).astype(np.int32)).to(cuda_device)
    got = K.small_table_lookup(tables, ind)
    assert torch.equal(got, K.small_table_lookup_plain(tables, ind))


def _integrand_rtol(kind, d, on_card=False):
    """Fused kernel vs plain, per value.  The row path (d <= 8) takes the
    order of the plain version on the CPU (prefix products left to right):
    a few ulps.  The plain version on the card forms its prefix products as
    a tree (torch's CUDA cumprod), and the a-term's ratios of nearby
    prefix products, (P_j - P_i) / (P_j + P_i) with P_j / P_i up to
    1 - 3e-4 at n = 65, magnify its one-ulp differences ~3000-fold: D and E
    against it to 1e-11.  The warp path scans and reduces as trees: C's
    sums of up to d prefix products to 1e-12; D's and E's products of
    ~d^2/2 such ratios to 1e-10."""
    if d <= 8:
        return 1e-11 if on_card and kind != "C" else 1e-14
    return 1e-12 if kind == "C" else 1e-10


# values in the subnormal range carry an absolute error of a few of its units
_SUBNORMAL_ATOL = 4 * 2.0 ** -1074


def _integrand_args(kind, B, d, dev, gen, n=33):
    """Tables from make_ising (m = d + 1) and indices in range, but for two
    out of it (their rows are 0)."""
    from ttcross_tpu_torch.apps import make_ising

    p = make_ising(kind, d + 1, n, device=dev)
    ind = gen.integers(0, p.n, size=(B, d)).astype(np.int32)
    if B:
        ind[0, 0] = -1
        ind[-1, -1] = p.n
    return p.tables, torch.as_tensor(ind).to(dev)


@pytest.mark.parametrize("B", [0, 1, 1950, 4097])
@pytest.mark.parametrize("d", [1, 5, 31, 32, 33, 97, 255])
@pytest.mark.parametrize("kind", ["C", "D", "E"])
def test_integrand_kernel_matches_plain(kind, d, B, gen, cuda_device):
    tables, ind = _integrand_args(kind, B, d, cuda_device, gen)
    n0 = K.ising_integrand_fused.launches
    got = K.ising_integrand_fused(tables, ind, kind)
    want = K.ising_integrand_plain(tables, ind, kind)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B,)
    assert K.ising_integrand_fused.launches == n0 + (B > 0)
    g = got.cpu().numpy()
    for w, on_card in ((want.cpu().numpy(), True),
                       (K.ising_integrand_plain(tables.cpu(), ind.cpu(), kind).numpy(), False)):
        rtol = _integrand_rtol(kind, d, on_card)
        assert np.all(np.abs(g - w) <= rtol * np.abs(w) + _SUBNORMAL_ATOL), on_card
        if B > 1:
            assert g[0] == w[0] == 0.0 and g[-1] == w[-1] == 0.0


@pytest.mark.parametrize("kind,d", [("C", 5), ("D", 5), ("E", 5), ("C", 255), ("D", 97)])
def test_integrand_kernel_is_one_kernel_per_call(kind, d, gen, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    tables, ind = _integrand_args(kind, 1950, d, cuda_device, gen)
    K.ising_integrand_fused(tables, ind, kind)
    torch.cuda.synchronize()
    # the profiler now and then records no device event for a window
    # (chip_smoke.py::device_per_call): such a window is profiled again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                K.ising_integrand_fused(tables, ind, kind)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
        if kern:
            break
    assert [e.key for e in kern] and all("integrand" in e.key for e in kern)
    assert 0 < sum(e.count for e in kern) <= 10


def test_integrand_wrapper_raises_on_what_the_kernel_does_not_take(gen, cuda_device):
    tables, ind = _integrand_args("C", 64, 5, cuda_device, gen)
    with pytest.raises(TypeError):
        K.ising_integrand_fused(tables, ind.long(), "C")
    with pytest.raises(ValueError):
        K.ising_integrand_fused(tables, ind.T, "C")                 # not contiguous
    with pytest.raises(ValueError):
        K.ising_integrand_fused(tables.cpu(), ind, "C")             # the table elsewhere
    with pytest.raises(ValueError):
        K.ising_integrand_fused(tables, torch.zeros((4, 1025), dtype=torch.int32,
                                                    device=cuda_device), "C")   # d too large


# the MVN path's batches (mvn_d6 at rank 20: rook fiber, lottery, init
# diagonals and fibers, the maxvol fiber cross; at rank 26 the same),
# each for one problem (L = 1) and for the 4-lane family; d = 1-16 has a
# kernel per d, d = 20 and 40 the generic one
MVN_SHAPES = [(L, B, 6, 65) for L in (1, 4) for B in (1300, 170, 520, 390, 26000)] + [
    (1, 43940, 6, 65), (1, 1690, 6, 65), (1, 612, 4, 17), (2, 100, 8, 33), (2, 100, 9, 33),
    (3, 500, 12, 33), (2, 300, 20, 33), (1, 200, 40, 17), (1, 1, 1, 5)]


def _mvn_args(gen, L, B, d, n, dtype, dev):
    """A random SPD inverse covariance and mean per lane, the MVN box's
    nodes, indices in range but for rows at the box's corners and rows
    past the table (and one at -1)."""
    from ttcross_tpu_torch.apps.mvn import _rule

    _, x, _ = _rule(n - 1 if n % 2 else n)
    A = gen.standard_normal((L, d, d)) * 0.3
    icov = A @ A.transpose(0, 2, 1) + np.eye(d) * 2.0
    mu = 4.5 + gen.standard_normal((L, d)) * 0.1
    norm = 1.0 + gen.random(L)
    ind = gen.integers(0, n, size=(L, B, d))
    ind[:, :min(B, 4)] = gen.integers(0, 2, size=(L, min(B, 4), d)) * (n - 1)
    if B > 6:
        ind[:, 4, 0], ind[:, 5, d - 1], ind[:, 6, :] = n, -1, n + 5
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)  # noqa: E731
    return (t(x), torch.as_tensor(ind, dtype=torch.int32).to(dev), t(mu), t(icov), t(norm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L,B,d,n", MVN_SHAPES)
def test_mvn_kernel_is_its_emulation_bit_for_bit_and_near_plain(L, B, d, n, dtype, gen,
                                                               cuda_device):
    args = _mvn_args(gen, L, B, d, n, dtype, cuda_device)
    n0, b0 = K.mvn_pdf_fused.launches, K.small_table_lookup.launches
    got = K.mvn_pdf_fused(*args)
    emulated = K.mvn_pdf_emulated(*args)
    plain = K.mvn_pdf_plain(*args)
    torch.cuda.synchronize()
    assert K.mvn_pdf_fused.launches == n0 + 1 and K.small_table_lookup.launches == b0
    assert got.shape == (L, B) and got.dtype == dtype
    assert torch.equal(got, emulated)
    err = (got.double() - plain.double()).abs().cpu()
    assert bool((err <= K.mvn_pdf_tolerance(*args[:4], plain)).all())
    one = K.mvn_pdf_fused(args[0], args[1][0], args[2][0], args[3][0], args[4][:1])
    assert torch.equal(one, got[0])          # a lane alone: the same bits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mvn_integrands_are_one_kernel_per_call(dtype, cuda_device):
    """MvnProblem.fun and MvnFamily.fun on the card: one launch of the fused
    kernel per call, no kernel B and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    from ttcross_tpu_torch.apps import make_mvn, make_mvn_family

    p = make_mvn(d=6, n=65, dtype=dtype)
    ind = torch.randint(0, 65, (4, 1300, 6), dtype=torch.int32, device=cuda_device)
    calls = [lambda: p.fun(ind[0])]
    if dtype == torch.float64:
        fam = make_mvn_family(d=6, n=65, corrs=(0.2, 0.4, 0.5, 0.6))
        calls += [lambda: fam.fun(ind, fam.params), lambda: fam.fun(ind[2], fam.lane(2))]
        assert torch.equal(fam.fun(ind, fam.params)[2], fam.fun(ind[2], fam.lane(2)))
    for call in calls:
        call()
        torch.cuda.synchronize()
        for _ in range(3):      # a window that records no device event is profiled again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
            if kern:
                break
        assert [e.key for e in kern] and all("mvn_pdf_kernel" in e.key for e in kern)
        assert 0 < sum(e.count for e in kern) <= 10


def test_mvn_wrapper_raises_on_what_the_kernel_does_not_take(gen, cuda_device):
    table, ind, mu, icov, norm = _mvn_args(gen, 2, 100, 6, 65, torch.float64, cuda_device)
    with pytest.raises(TypeError):
        K.mvn_pdf_fused(table, ind.long(), mu, icov, norm)
    with pytest.raises(TypeError):
        K.mvn_pdf_fused(table, ind, mu.float(), icov, norm)        # no input is converted
    with pytest.raises(ValueError):
        K.mvn_pdf_fused(table, ind, mu, icov.transpose(1, 2), norm)    # not contiguous
    with pytest.raises(ValueError):
        K.mvn_pdf_fused(table, ind, mu, icov, norm.cpu())          # elsewhere
    with pytest.raises(ValueError):
        K.mvn_pdf_fused(table, ind, mu[:1], icov, norm)            # a lane short
    big = torch.zeros((1, 4, 80), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        K.mvn_pdf_fused(table, big, torch.zeros((1, 80), dtype=torch.float64, device=cuda_device),
                        torch.zeros((1, 80, 80), dtype=torch.float64, device=cuda_device),
                        norm[:1])


# (sweeps, keys, d, nlot): the benchmark's 1024-lane family, a mesh rank's
# half of it, the 4-lane family, and the CPU tests' keys and shapes
# (tests/test_torch_lane_uniforms.py), odd row lengths among them
LANE_UNIFORM_CASES = [(19, ("lanes", 0, 1024), 6, 170), (19, ("lanes", 512, 1024), 6, 170),
                      (19, ("lanes", 0, 4), 6, 170), (1, [2**62 + 987654321], 2, 6),
                      (3, [0, 1, 2**32 - 1], 4, 7), (3, [2**32 + 5], 6, 170),
                      (1, ("lanes", 100, 117), 4, 7), (3, ("lanes", 5, 22), 2, 6)]


@pytest.mark.parametrize("sweeps,keys,d,nlot", LANE_UNIFORM_CASES)
def test_lane_uniforms_kernel_is_the_host_draws_bit_for_bit(sweeps, keys, d, nlot, cuda_device):
    """The MT19937 kernel draws every lane's block of uniforms, bit for bit
    the host's per-lane torch.Generator draws, in one launch a call."""
    from ttcross_tpu_torch.cross import lane_key

    if keys[0] == "lanes":
        keys = [lane_key(2**40 + 7, lane) for lane in range(keys[1], keys[2])]
    K.reset_launch_counts()
    got = K.lane_uniforms(keys, sweeps, d, nlot, cuda_device)
    shape = (sweeps, len(keys), d - 1, 2, nlot)
    assert got.device.type == "cuda" and got.dtype == torch.float64 and got.shape == shape
    assert K.lane_uniforms.launches == 1
    assert K.launch_shapes()["lane_uniforms"] == {shape: 1}
    assert torch.equal(got.cpu(), K.lane_uniforms_plain(keys, sweeps, d, nlot))


def test_lane_uniforms_wrapper_raises_on_what_has_no_uniforms(cuda_device):
    with pytest.raises(ValueError):
        K.lane_uniforms([], 2, 4, 7, cuda_device)
    with pytest.raises(ValueError):
        K.lane_uniforms([1], 2, 1, 7, cuda_device)
    with pytest.raises(ValueError, match="32-bit"):
        K.lane_uniforms([1], 2**22, 1025, 1024, cuda_device)


@pytest.mark.parametrize("mode", ["sequential", "jacobi"])
def test_cross_batch_draws_on_the_card_bit_for_bit(mode, cuda_device):
    """A small MVN family's cross_batch on the card draws its uniforms with
    one launch a call (drawn="card", the seeds' copy under entry.upload),
    and is the same run as the family fed the host's draws through
    _run_cross_batch(uniforms=): vip, ranks, n_evals and values equal."""
    from torch.profiler import ProfilerActivity, profile

    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.cross import cross_batch, lane_key
    from ttcross_tpu_torch.cross.batch import _cross_batch
    from ttcross_tpu_torch.utils import reset_spans, spans

    d, R, L = 4, 6, 3
    fam = make_mvn_family(d=d, n=17, corrs=np.linspace(0.2, 0.6, L), device=cuda_device)
    kw = dict(max_rank=R, key=3, pivoting=1, accuracy=500 * 2.2e-16,
              quad=[fam.quad_weights] * d, truth=1.0, device=cuda_device)
    K.reset_launch_counts()
    reset_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        res = cross_batch(fam.fun, [fam.n] * d, fam.params, sweep_mode=mode, **kw)
    recs = spans()
    up = [i for i, r in enumerate(recs) if r.name == "entry.uniforms"]
    assert len(up) == 1 and recs[up[0]].attrs == {"drawn": "card"}
    assert [(r.parent, r.attrs) for r in recs if r.name == "entry.upload"] == [(up[0],
                                                                                {"bytes": 4 * L})]
    assert K.lane_uniforms.launches == 1
    again = cross_batch(fam.fun, [fam.n] * d, fam.params, sweep_mode=mode, **kw)
    assert K.lane_uniforms.launches == 2 and again.neval == res.neval
    U = K.lane_uniforms_plain([lane_key(3, lane) for lane in range(L)], R - 1, d, 2 * (R + fam.n))
    base = dict(dtype=torch.float64, verbose=False, max_sweeps=None, small_element=None,
                small_pivot=None, sweep_mode=mode, mesh=None)
    fed = _cross_batch(fam.fun, [fam.n] * d, fam.params, uniforms=U, **base, **kw)
    assert K.lane_uniforms.launches == 2              # the injected draws launch nothing
    assert fed.neval == res.neval > 0 and fed.sweeps == res.sweeps
    for a, b in zip(fed.lanes, res.lanes):
        assert a.values == b.values and a.ranks == b.ranks and a.neval == b.neval
        assert np.array_equal(a.state.vip, b.state.vip)


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


@pytest.mark.parametrize("pivoting", [1, 0, -1])
def test_small_cross_on_the_card_matches_the_cpu(pivoting, cuda_device):
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    runs = {}
    K.reset_launch_counts()
    for where in ("cpu", cuda_device):
        p = make_ising("C", 5, 17, device=where)
        runs[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=8, pivoting=pivoting,
                                 quad=[p.quad_weights] * p.d, truth=p.truth,
                                 return_state=True, device=where)
    counts = K.launch_counts()
    c, g = runs["cpu"], runs[str(cuda_device)]
    assert counts["ising_integrand_fused"] > 0 and counts["small_table_lookup"] == 0
    assert (counts["score_residual_argmax"] > 0) == (pivoting != 0)   # piv 0 scores no fiber
    assert all(t.device.type == "cuda" for t in g.state)
    assert (g.ranks, g.neval, g.sweeps) == (c.ranks, c.neval, c.sweeps)
    np.testing.assert_allclose(g.values, c.values, rtol=1e-11)


@pytest.mark.parametrize("mode,chain", [("jacobi-rb", True), ("jacobi-rb", False),
                                        ("jacobi", True), ("jacobi", False)])
def test_small_long_chain_cross_on_the_card_matches_the_cpu(mode, chain, cuda_device):
    """C_32 (n = 17, rank 6) on the all-bonds sweeps: the card against the
    CPU run with the same uniforms; the batched kernel A and, by the path,
    kernel B (the chain's lift) or the fused integrand launched."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    runs = {}
    K.reset_launch_counts()
    for where in ("cpu", cuda_device):
        p = make_ising("C", 32, 17, device=where)
        runs[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=6, accuracy=500 * 2.2e-16,
                                 pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth,
                                 sweep_mode=mode, chain=p.chain if chain else None,
                                 return_state=True, device=where)
    counts, shapes = K.launch_counts(), K.launch_shapes()
    c, g = runs["cpu"], runs[str(cuda_device)]
    # the launches by shape add up to the counts; both fiber passes at all bonds
    assert {k: sum(v.values()) for k, v in shapes.items()} == counts
    P, RN = p.d - 1, 6 * p.n
    assert set(shapes["score_residual_argmax_batched"]) == {(P, RN, 1, 6), (P, 1, RN, 6)}
    assert counts["score_residual_argmax_batched"] > 0 and counts["score_residual_argmax"] == 0
    assert (counts["small_table_lookup"] > 0) == chain
    assert counts["ising_integrand_fused"] > (0 if chain else 10)
    assert all(t.device.type == "cuda" for t in g.state)
    assert (g.chain_states is not None) == chain
    if chain:
        assert all(t.device.type == "cuda" for t in g.chain_states)
    assert (g.ranks, g.neval, g.sweeps) == (c.ranks, c.neval, c.sweeps)
    np.testing.assert_allclose(g.values, c.values, rtol=1e-9)


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


@pytest.mark.parametrize("mode,chain", [("jacobi-rb", True), ("jacobi-rb", False),
                                        ("jacobi", True), ("jacobi", False)])
def test_an_all_bonds_sweep_makes_no_host_sync(mode, chain, cuda_device):
    """Hunt, apply and the chain states' update of the long-chain sweeps
    stay on the card: two sweeps at C_64 under torch's sync debug mode set
    to raise."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine

    p = make_ising("C", 64, 17, device=cuda_device)
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=8, piv=1, small_element=se,
                      small_pivot=sp, jacobi=True, rb=mode == "jacobi-rb")
    kit = make_engine(p.fun, cfg, cuda_device, chain=p.chain if chain else None)
    st = kit.init_fn()
    neval0 = int(st.neval)
    cs = kit.chain_ev.states_from_vip(st.vip) if chain else None
    U = torch.rand((2, p.d - 1, 2, 2 * (8 + p.n)), dtype=torch.float64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (1, 2):
            out = kit.sweep_fn(st, it, U[it - 1], cs)
            st, cs = out if chain else (out, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the end bonds accept in both sweeps (mid-chain entries of C_64 lie under
    # the small-element threshold until the ranks reach them), and each sweep
    # examines thousands of entries
    assert int(st.rk.max()) == 3 and int(st.rk[1]) == 3 and int(st.rk[-2]) == 3
    assert int(st.neval) > neval0 + 10_000


def test_spans_record_under_a_cuda_only_profiler_and_add_no_sync(cuda_device):
    """The port's spans record under torch.profiler with the CUDA activity
    alone (how the benchmark profiles its traced call): two all-bonds
    sweeps of C_64 with the chain under torch's sync debug mode set to
    raise give their hunts, accepts and state updates, and a small family
    call gives one root with a sweep span per sweep."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from ttcross_tpu_torch.apps import make_ising, make_mvn_family
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross import cross_batch
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine
    from ttcross_tpu_torch.utils import reset_spans, spans

    p = make_ising("C", 64, 17, device=cuda_device)
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=8, piv=1, small_element=se,
                      small_pivot=sp, jacobi=True, rb=True)
    kit = make_engine(p.fun, cfg, cuda_device, chain=p.chain)
    st = kit.init_fn()
    cs = kit.chain_ev.states_from_vip(st.vip)
    U = torch.rand((2, p.d - 1, 2, 2 * (8 + p.n)), dtype=torch.float64, device=cuda_device)
    torch.cuda.synchronize()
    reset_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for it in (1, 2):
                st, cs = kit.sweep_fn(st, it, U[it - 1], cs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert Counter(r.name for r in spans()) == {"engine.hunt": 4, "engine.accept": 4,
                                                 "chain.update": 4}
    fam = make_mvn_family(d=4, n=17, corrs=np.linspace(0.2, 0.6, 3), device=cuda_device)
    reset_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        res = cross_batch(fam.fun, [fam.n] * 4, fam.params, max_rank=6, key=3, pivoting=1,
                          accuracy=500 * 2.2e-16, quad=[fam.quad_weights] * 4, truth=1.0,
                          device=cuda_device)
    recs = spans()
    assert [r.name for r in recs if r.parent is None] == ["cross_batch"]
    assert sum(r.name == "engine.sweep" for r in recs) == res.sweeps > 0
    assert all(r.start <= r.end and r.call == 0 for r in recs)


@pytest.mark.parametrize("extra", [dict(), dict(refine_sweeps=1), dict(oversample=2),
                                   dict(weighted_lottery=True)],
                         ids=["greedy", "refine", "oversample", "weighted"])
def test_small_mvn_cross_on_the_card_matches_the_cpu(extra, cuda_device):
    """MVN d = 4, n = 17, rank 6 on the card against the CPU: the check is
    chip_smoke.py's own (ranks, n_evals and padded evals equal, values to
    1e-12, both kernels launched), run here one variant at a time."""
    import chip_smoke

    row, counts, _ = chip_smoke.small_mvn_against_cpu(cuda_device, extra)
    assert row["max_rel_value_diff"] <= 1e-11 and row["n_evals"] > 0
    assert counts["mvn_pdf_fused"] > 0 and counts["score_residual_argmax"] > 0
    assert counts["small_table_lookup"] == 0        # the MVN integrand is one fused launch


def test_mvn_sweep_and_maxvol_visit_make_no_host_sync(cuda_device):
    """Two weighted-lottery sweeps of the MVN engine, and one L->R and one
    R->L bond visit of the maxvol refinement (a fixed-trip selection on a
    (R N, R) fiber cross), under torch's sync debug mode set to raise."""
    from ttcross_tpu_torch.apps import make_mvn
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine
    from ttcross_tpu_torch.cross.maxvol import _refine_engine

    p = make_mvn(d=6, n=33, device=cuda_device)
    se, sp = precision_thresholds(torch.float64)
    R = 8
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=R, piv=1, small_element=se,
                      small_pivot=sp, wlot=True)
    kit = make_engine(p.fun, cfg, cuda_device)
    st = kit.init_fn()
    U = torch.rand((2, p.d - 1, 2, 2 * (R + p.n)), dtype=torch.float64, device=cuda_device)
    w = torch.from_numpy(np.tile(p.quad_weights, (p.d, 1))).to(cuda_device)
    lw = w / w.amax(dim=1, keepdim=True)
    mv = _refine_engine(p.fun, (p.n,) * p.d, R, 8, 1.01, cuda_device)
    LI = torch.randint(0, p.n, (p.d - 1, R, p.d), dtype=torch.int32, device=cuda_device)
    RJ = torch.randint(0, p.n, (p.d - 1, R, p.d), dtype=torch.int32, device=cuda_device)
    rr = torch.full((p.d - 1,), R, dtype=torch.int32, device=cuda_device)
    z = torch.zeros((), dtype=torch.int64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (1, 2):
            st = kit.sweep_fn(st, it, U[it - 1], lw=lw)
        LI, B, nev, _ = mv.visit_lr(2, LI, RJ, rr, z, z)
        RJ, core, nev, _ = mv.visit_rl(2, LI, RJ, rr, nev, z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.rk[1:-1].min()) >= 2
    assert int(nev) == 2 * R * p.n * R and bool(torch.isfinite(core).all())


def test_complex_chain_and_serialization_on_the_card(cuda_device, tmp_path):
    """basket_chf in complex128 on the card equals the CPU's to 1e-13, and a
    train saved from the card loads back onto it bit-equal."""
    from ttcross_tpu_torch.apps import basket_chf, make_mvn
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.tt import load_ttbin_ref, save_ttbin_ref

    p = make_mvn(d=4, n=17, device=cuda_device)
    res = cross(p.fun, [p.n] * p.d, max_rank=6, pivoting=1, device=cuda_device)
    phis = basket_chf(res.tt, p.nodes, p.quad_weights, 32)
    assert phis.device.type == "cuda" and phis.dtype == torch.complex128
    host = basket_chf(res.tt.to("cpu"), p.nodes, p.quad_weights, 32)
    np.testing.assert_allclose(phis.cpu().numpy(), host.numpy(), rtol=0, atol=1e-13)
    path = str(tmp_path / "t.tt")
    save_ttbin_ref(res.tt, path)
    back = load_ttbin_ref(path)                    # the card is the default
    assert back.device.type == "cuda"
    assert all(torch.equal(a, b) for a, b in zip(back.cores, res.tt.cores))
