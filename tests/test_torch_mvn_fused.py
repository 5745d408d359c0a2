"""The fused MVN density integrand (ops/kernels.py::mvn_pdf_fused) on the
CPU: its plain version and its emulation of the kernel's order against the
JAX package's MVN integrands, MvnProblem.fun and MvnFamily.fun, run on
JAX's CPU backend.

The same numpy indices from a seed go to both packages: random rows, rows
at the corners of the box (the largest quadratic forms) and rows with
indices past the table (the lookup's 0; JAX's CPU lookup wraps a negative
index, so those are held against the port's own contract).  The tolerance
(ops/kernels.py::mvn_pdf_tolerance), for d variables: |got - want| <=
(2d + 8) u (1 + 0.5 sum_jk |diff_j C_jk diff_k|) |want| + floor, with u = 2^-52 and floor 1e-300 in f64, u = 2^-23
and floor 1e-37 in f32 (a few roundings of each product and sum of the
form, of exp and of the division).  The f32 versions are held against the
JAX package's f64 integrand on the same f32-rounded nodes, mean and inverse
covariance.  On the card the kernel is held bit for bit against the
emulation by tests/test_torch_cuda.py and chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_mvn as jmake_mvn, make_mvn_family as jmake_family
from ttcross_tpu.apps.mvn import MvnDensity as JMvnDensity, MvnProblem as JMvnProblem
from ttcross_tpu_torch.apps import make_mvn, make_mvn_family
from ttcross_tpu_torch.ops import kernels as K

CORRS = (0.3, 0.5, 0.7)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indices(rng, L, B, d, n):
    """(L, B, d) int32: random rows, then rows at the box's corners (every
    index 0 or n - 1) and rows with indices n and n + 3 (outside the
    table, looked up as 0)."""
    ind = rng.integers(0, n, size=(L, B, d))
    ind[:, :8] = rng.integers(0, 2, size=(L, 8, d)) * (n - 1)
    ind[:, 8, 0] = n
    ind[:, 9, d - 1] = n + 3
    ind[:, 10, :] = n
    return ind.astype(np.int32)


def _within(got, want, table, ind, mu, inv_cov):
    """The stated tolerance (K.mvn_pdf_tolerance), value by value: got and
    want (..., B), the operands as mvn_pdf_plain's."""
    want = torch.from_numpy(np.array(want, np.float64))
    tol = K.mvn_pdf_tolerance(table, ind, mu, inv_cov, want)
    err = (torch.from_numpy(np.array(got, np.float64)) - want).abs()
    assert bool((err <= tol).all()), f"worst excess {float((err / tol).max())} of the tolerance"


def _round(a, dtype):
    return np.asarray(torch.as_tensor(a).to(dtype).double())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [4, 6, 12])
def test_family_plain_and_emulated_match_jax(d, dtype, rng):
    """Three lanes (corr 0.3, 0.5, 0.7): MvnFamily.fun's plain version (f64:
    the port's family itself) and the emulation against the JAX family's
    fun, lane by lane."""
    n, B = 33, 300
    jf = jmake_family(d=d, n=n, corrs=CORRS)
    ind = _indices(rng, len(CORRS), B, d, n)
    nodes = _round(jf.nodes, dtype)
    mu = _round(jf.params["mu"], dtype)
    icov = _round(jf.params["inv_cov"], dtype)
    norm = np.array(jf.params["norm"])
    if dtype == torch.float64:
        pf = make_mvn_family(d=d, n=n, corrs=CORRS, device="cpu")
        args = (pf.table, torch.from_numpy(ind), pf.params["mu"], pf.params["inv_cov"],
                pf.params["norm"])
        plain = pf.fun(torch.from_numpy(ind), pf.params)
    else:
        args = (torch.from_numpy(nodes).float(), torch.from_numpy(ind),
                torch.from_numpy(mu).float(), torch.from_numpy(icov).float(),
                torch.from_numpy(norm).float())
        plain = K.mvn_pdf_plain(*args)
    emulated = K.mvn_pdf_emulated(*args)
    assert plain.dtype == emulated.dtype == dtype and plain.shape == (len(CORRS), B)
    assert torch.equal(K.mvn_pdf_fused(*args), plain)       # the CPU takes the plain version
    for lane in range(len(CORRS)):
        par = {"mu": jnp.asarray(mu[lane]), "inv_cov": jnp.asarray(icov[lane]),
               "norm": jnp.asarray(norm[lane])}
        jfam = type(jf)(d=d, n=n, nodes=nodes, quad_weights=jf.quad_weights, corrs=jf.corrs,
                        params=jf.params)
        want = np.asarray(jfam.fun(jnp.asarray(ind[lane]), par))
        for got in (plain[lane], emulated[lane]):
            _within(got.numpy(), want, args[0], args[1][lane], args[2][lane], args[3][lane])
    assert np.all(np.isfinite(emulated.numpy())) and np.all(emulated.numpy() >= 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [4, 6, 12])
def test_problem_plain_and_emulated_match_jax(d, dtype, rng):
    """One problem (corr 0.5): MvnProblem.fun (its plain version on the CPU)
    and the emulation against the JAX problem's fun."""
    n, B = 65, 400
    jp = jmake_mvn(d=d, n=n)
    pp = make_mvn(d=d, n=n, device="cpu", dtype=dtype)
    ind = _indices(rng, 1, B, d, n)[0]
    dn = pp.density
    got = pp.fun(torch.from_numpy(ind))
    emulated = K.mvn_pdf_emulated(pp.table, torch.from_numpy(ind), dn.mu_t, dn.inv_cov_t,
                                  dn.norm_t)
    assert got.dtype == emulated.dtype == dtype and got.shape == emulated.shape == (B,)
    nodes, mu, icov = (_round(a, dtype) for a in (jp.nodes, jp.density.mu, jp.density.inv_cov))
    jd = JMvnDensity(mu=mu, cov=jp.density.cov, inv_cov=icov, det_cov=jp.density.det_cov)
    jprob = JMvnProblem(d=d, n=n, nodes=nodes, quad_weights=jp.quad_weights, density=jd,
                        truth=1.0)
    want = np.asarray(jprob.fun(jnp.asarray(ind)))
    for g in (got, emulated):
        _within(g.numpy(), want, pp.table, torch.from_numpy(ind), dn.mu_t, dn.inv_cov_t)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_family_of_one_lane_is_the_single_problem(dtype, rng):
    """The emulation of a family of one lane is the single problem's bit for
    bit (the kernel's row depends on its lane only, so a lane of
    cross_batch repeats its single run); the plain versions (a matmul for
    the problem, sums of products for the family) agree within the
    tolerance."""
    d, n, B = 6, 65, 500
    pp = make_mvn(d=d, n=n, device="cpu", dtype=dtype)
    dn = pp.density
    ind = torch.from_numpy(_indices(rng, 1, B, d, n))
    fam = (pp.table, ind, dn.mu_t[None], dn.inv_cov_t[None], dn.norm_t)
    one = (pp.table, ind[0], dn.mu_t, dn.inv_cov_t, dn.norm_t)
    assert torch.equal(K.mvn_pdf_emulated(*fam)[0], K.mvn_pdf_emulated(*one))
    plain_fam, plain_one = K.mvn_pdf_plain(*fam)[0], K.mvn_pdf_plain(*one)
    _within(plain_fam.numpy(), plain_one.double().numpy(), *one[:4])


def test_negative_indices_read_zero(rng):
    """The port's lookup contract (kernel B's): an index outside [0, n),
    negative ones too, reads 0, in the plain version and the emulation."""
    d, n = 6, 17
    pp = make_mvn(d=d, n=n, device="cpu")
    dn = pp.density
    ind = torch.from_numpy(_indices(rng, 1, 40, d, n)[0])
    neg = ind.clone()
    neg[ind >= n] = -1
    for f in (K.mvn_pdf_plain, K.mvn_pdf_emulated):
        assert torch.equal(f(pp.table, neg, dn.mu_t, dn.inv_cov_t, dn.norm_t),
                           f(pp.table, ind, dn.mu_t, dn.inv_cov_t, dn.norm_t))


@pytest.mark.parametrize("B,d,n,esz", [(1300, 6, 65, 8), (170, 6, 65, 8), (43940, 6, 65, 8),
                                       (26000, 6, 65, 4), (1, 1, 1, 8), (500, 12, 33, 8),
                                       (300, 40, 65, 8), (100, 60, 65, 4)])
def test_mvn_plan_covers_each_row_within_shared_memory(B, d, n, esz):
    plan = K._mvn_plan(B, d, n, esz)
    params = -(-(d * d + d + n + 1) * esz // 16) * 16
    assert plan.smem == params + 4 * (plan.rows * d + 8) <= 48 * 1024
    assert plan.rows in (32, 64, 128) and (plan.blocks - 1) * plan.rows < B <= plan.blocks * plan.rows
    if d <= 16:
        assert plan.rows == 128


@pytest.mark.parametrize("B,d,n,esz", [(100, 80, 65, 8), (10, 6, 7000, 8), (0, 6, 65, 8),
                                       (10, 0, 65, 8), (10, 6, 65, 2)])
def test_mvn_plan_refuses_what_the_kernel_does_not_take(B, d, n, esz):
    with pytest.raises(ValueError, match="fused MVN"):
        K._mvn_plan(B, d, n, esz)
