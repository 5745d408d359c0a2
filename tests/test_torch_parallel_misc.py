"""The rest of the port's distributed surface against the JAX package's (or
the port's one-device path), on the CPU, each on gloo ranks spawned once
per world size (parallel/launch.py::spawn_ranks): pcontract (real,
complex and a K-family of weights), maxvol_refine_parallel, accchk(mesh=),
cross_batch(mesh=) and cross_defect_corrected(mesh=).  The rank functions
are at module level and this module imports nothing of JAX at import
time: the spawned ranks import it."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.apps import make_mvn_family
from ttcross_tpu_torch.cross import accchk, cross_batch, cross_defect_corrected, maxvol_refine
from ttcross_tpu_torch.cross.engine_dd import cross_dd  # noqa: F401  (the dd tier loads)
from ttcross_tpu_torch.parallel import (BondMesh, bond_mesh, maxvol_refine_parallel, pcontract,
                                        spawn_ranks)
from ttcross_tpu_torch.tt.ops import contract, full, gather
from ttcross_tpu_torch.tt.types import TT

TIMEOUT = 240
PC_N, PC_R = (4, 5, 3, 6, 4), (1, 3, 4, 2, 3, 1)


def _pc_inputs():
    """A random train and three weight sets: real, complex, and a family of
    32 complex weight vectors per mode (the chf driver's shape)."""
    rng = np.random.default_rng(3)
    cores = [rng.standard_normal((PC_R[i], n, PC_R[i + 1])) for i, n in enumerate(PC_N)]
    real = [rng.standard_normal(n) for n in PC_N]
    cplx = [w + 1j * rng.standard_normal(n) for w, n in zip(real, PC_N)]
    omega = np.arange(32) * np.pi / 30.0
    family = [np.abs(w)[None, :] * np.exp(1j * omega[:, None] * np.arange(n)[None, :])
              for w, n in zip(real, PC_N)]
    return cores, {"real": real, "complex": cplx, "family": family}


def _family():
    """The 4-lane MVN family (d = 4, n = 17, corr 0.2-0.6), each lane's mean
    and covariance perturbed as tests/test_torch_batch.py perturbs them:
    the default family is symmetric under permutations of its modes, whose
    mirrored hunt candidates tie to the last bit, and kernel A's plain
    version batched over another number of lanes sums in another order."""
    d = 4
    fam = make_mvn_family(d=d, n=17, corrs=np.linspace(0.2, 0.6, 4), device="cpu")
    rng = np.random.default_rng(11)
    mu, inv_cov, norm = [], [], []
    for c in np.linspace(0.2, 0.6, 4):
        cov = np.full((d, d), 0.16 * c) + np.diag(np.full(d, 0.16 * (1 - c)))
        A = rng.normal(size=(d, d)) * 0.1
        cov = cov + A @ A.T
        mu.append(np.log(100.0) - 0.08 + rng.normal(size=d) * 0.1)
        inv_cov.append(np.linalg.inv(cov))
        norm.append(np.sqrt((2 * np.pi) ** d * np.linalg.det(cov)))
    params = {"mu": np.stack(mu), "inv_cov": np.stack(inv_cov), "norm": np.array(norm)}
    return dataclasses.replace(fam, params={k: torch.from_numpy(v) for k, v in params.items()})


def _exact_cores(seed, d, n, r):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1 if c == 0 else r, n, 1 if c == d - 1 else r))
            for c in range(d)]


# ------------------------------------------------------------ the ranks' work
def _rank_work(defect_uniforms, defect_tables):
    """Everything of this file on this rank, returned as numpy."""
    mesh = bond_mesh(device="cpu")
    out = {}
    cores, weights = _pc_inputs()
    t = TT(tuple(torch.from_numpy(c) for c in cores))
    out["pcontract"] = {k: pcontract(t, w, mesh) for k, w in weights.items()}

    ex = TT(tuple(torch.from_numpy(c) for c in _exact_cores(1, 6, 7, 3)))
    mv = maxvol_refine_parallel(lambda i: gather(ex, i), [7] * 6, ranks=3, sweeps=3, key=1,
                                mesh=mesh)
    out["maxvol"] = dict(full=full(mv.tt).numpy(), neval=mv.neval, padded=mv.padded_evals,
                         ranks=mv.ranks)

    def noisy(ind):
        return gather(t, ind) + 1e-9 * torch.sin(ind.sum(dim=1).double())

    out["accchk"] = accchk(t, noisy, nlot=4099, key=7, mesh=mesh)

    fam = _family()
    res = cross_batch(fam.fun, [fam.n] * 4, fam.params, max_rank=6, pivoting=1,
                      accuracy=500 * 2.2e-16, quad=[fam.quad_weights] * 4, truth=1.0, key=3,
                      mesh=mesh)
    out["batch"] = [dict(ranks=r.ranks, neval=r.neval, vip=r.state.vip, values=r.values,
                         sweeps=r.sweeps) for r in res]

    if defect_tables is not None:
        from ttcross_tpu_torch.apps.ising import ising_dd_problem
        from ttcross_tpu_torch.interop import dd_pair_from_numpy

        (xh, xl), (wh, wl) = defect_tables
        prob, fun_dd, pwh, pwl = ising_dd_problem(dd_pair_from_numpy(xh, xl, "cpu"),
                                                  dd_pair_from_numpy(wh, wl, "cpu"), 4, "cpu")
        U = [u[mesh.rank] for u in defect_uniforms]
        hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * 3, pwh, pwl,
                                              max_rank=8, levels=2, mesh=mesh, uniforms=U,
                                              device="cpu")
        out["defect"] = (hi, lo, info)
    return out


@pytest.fixture(scope="module")
def ranks2(defect_jax):
    """Two ranks' results of _rank_work."""
    return spawn_ranks(_rank_work, 2, args=(defect_jax["U"], defect_jax["tables"]),
                       timeout=TIMEOUT)


@pytest.fixture(scope="module")
def ranks4():
    """Four ranks' results of _rank_work (without the d = 3 defect)."""
    return spawn_ranks(_rank_work, 4, args=(None, None), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def defect_jax():
    """The JAX defect-corrected C_4 (n = 17, rank 8, two levels) on two
    devices, the dd tables, and each level's per-device uniforms
    (fold_in(key + level, device), one split per sweep)."""
    import jax
    import jax.numpy as jnp

    from test_torch_engine_dd import _jax_tables
    from ttcross_tpu import native
    from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
    from ttcross_tpu.cross.defect import cross_defect_corrected as jdefect
    from ttcross_tpu.parallel.mesh import bond_mesh as jbond_mesh

    if not native.available():
        pytest.skip("no native toolchain")
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=4, n=17)
    hi, lo, info = jdefect(jprob.fun, jfun, [17] * 3, jwh, jwl, max_rank=8, levels=2,
                           mesh=jbond_mesh(jax.devices()[:2]))
    U = []
    for lvl in range(2):
        per_dev = []
        for me in range(2):
            k, blocks = jax.random.fold_in(jax.random.PRNGKey(lvl), me), []
            for _ in range(7):
                k, sub = jax.random.split(k)
                blocks.append(np.asarray(jax.random.uniform(sub, (2, 2, 2 * (8 + 17)),
                                                            jnp.float64)))
            per_dev.append(np.stack(blocks))
        U.append(per_dev)
    return dict(hi=hi, lo=lo, info=info, U=U, tables=_jax_tables(17))


def _same_everywhere(values):
    """The value every rank returned (each rank's must be rank 0's)."""
    for v in values[1:]:
        assert np.array_equal(v, values[0])
    return values[0]


# ------------------------------------------------------------------ pcontract
@pytest.mark.parametrize("kind", ["real", "complex", "family"])
def test_pcontract_matches_jax(kind, ranks2, ranks4):
    """pcontract on 2 and 4 ranks (identity-padded slabs, the stride-
    doubling fold) against the JAX package's one-device contraction
    (tt.contract, the oracle the JAX pcontract is held to at 1e-12 in
    tests/test_parallel.py; the JAX pcontract itself compiles for 40-90 s
    per call on this CPU) and the port's: 1e-12 relative, complex weights
    in complex128, the 32-set family in one pass; every rank the same
    value."""
    import ttcross_tpu.tt as jtt

    cores, weights = _pc_inputs()
    w = weights[kind]
    jt = jtt.from_cores(cores)
    t = TT(tuple(torch.from_numpy(c) for c in cores))
    sets = [[x[k] for x in w] for k in range(32)] if kind == "family" else [w]
    want = np.array([complex(jtt.contract(jt, ws)) for ws in sets])
    one = np.array([complex(contract(t, ws)) for ws in sets])
    if kind != "family":
        want, one = want[0], one[0]
    for per_rank in (ranks2, ranks4):
        got = np.asarray(_same_everywhere([r["pcontract"][kind] for r in per_rank]))
        assert got.shape == np.shape(want) and (got.dtype.kind == "c") == (kind != "real")
        np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(got, one, rtol=1e-12)


def test_pcontract_rejects_complex_cores():
    mesh = BondMesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    t = TT((torch.ones(1, 2, 1, dtype=torch.complex128),) * 2)
    with pytest.raises(ValueError, match="REAL"):
        pcontract(t, [np.ones(2)] * 2, mesh)


# ------------------------------------------------------------------- maxvol
def test_maxvol_refine_parallel_matches_jax(ranks2, ranks4):
    """The slab-parallel maxvol (one all_reduce of the owner-masked index
    tables per half-sweep) on 2 and 4 ranks against the JAX package's on as
    many devices: the same evaluations, ranks, and recovered exact-rank
    train (d = 6, n = 7, rank 3, 3 sweeps)."""
    import jax
    from jax.sharding import Mesh

    import ttcross_tpu.tt as jtt
    from ttcross_tpu.parallel.maxvol import maxvol_refine_parallel as jmrp

    cores = _exact_cores(1, 6, 7, 3)
    jt = jtt.from_cores(cores)
    dense = np.asarray(jtt.full(jt))
    for ndev, per_rank in ((2, ranks2), (4, ranks4)):
        j = jmrp(lambda i: jtt.gather(jt, i), [7] * 6, ranks=3, sweeps=3, key=1,
                 mesh=Mesh(np.asarray(jax.devices()[:ndev]), ("bond",)))
        p = per_rank[0]["maxvol"]
        for other in per_rank[1:]:
            assert np.array_equal(other["maxvol"]["full"], p["full"])
        assert (p["neval"], p["padded"], p["ranks"]) == (j.neval, j.padded_evals,
                                                         tuple(j.ranks))
        np.testing.assert_allclose(p["full"], np.asarray(jtt.full(j.tt)), rtol=0,
                                   atol=1e-10 * np.abs(dense).max())
        assert np.abs(p["full"] - dense).max() < 1e-10 * np.abs(dense).max()


def _one_rank_maxvol():
    """maxvol_refine_parallel on one rank and maxvol_refine, same init."""
    ex = TT(tuple(torch.from_numpy(c) for c in _exact_cores(2, 4, 8, 3)))
    fun = lambda i: gather(ex, i)  # noqa: E731
    seq = maxvol_refine(fun, [8] * 4, ranks=3, sweeps=2, key=7, device="cpu")
    par = maxvol_refine_parallel(fun, [8] * 4, ranks=3, sweeps=2, key=7,
                                 mesh=bond_mesh(device="cpu"))
    return ([c.numpy() for c in seq.tt.cores], [c.numpy() for c in par.tt.cores],
            (seq.neval, seq.padded_evals), (par.neval, par.padded_evals))


def test_maxvol_one_rank_is_the_sequential_iteration():
    """On one rank the iteration is maxvol_refine's (the same index
    tables); the cores come from the frozen-table emit pass, equal to the
    sweep's to solve rounding, for one more half-sweep of evaluations
    (tests/test_parallel.py's property)."""
    seq, par, sc, pc = spawn_ranks(_one_rank_maxvol, 1, timeout=TIMEOUT)[0]
    for a, b in zip(seq, par):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert pc[0] > sc[0] and pc[1] > sc[1]


# ------------------------------------------------------------------- accchk
def test_accchk_on_mesh(ranks2, ranks4):
    """accchk(mesh=) over 2 and 4 ranks (4099 samples padded to a multiple
    of the ranks, one contiguous shard each) against the one-device accchk
    of the same samples: the maxima and the worst index exactly, the
    Frobenius norms to 1e-12 (tests/test_parallel.py's test_accchk_on_mesh)."""
    cores, _ = _pc_inputs()
    t = TT(tuple(torch.from_numpy(c) for c in cores))

    def noisy(ind):
        return gather(t, ind) + 1e-9 * torch.sin(ind.sum(dim=1).double())

    for ndev, per_rank in ((2, ranks2), (4, ranks4)):
        par = per_rank[0]["accchk"]
        assert all(r["accchk"] == par for r in per_rank)
        ref = accchk(t, noisy, nlot=-(-4099 // ndev) * ndev, key=7, device="cpu")
        assert (par["einf"], par["ainf"], par["worst_index"]) == (ref["einf"], ref["ainf"],
                                                                  ref["worst_index"])
        for k in ("efro", "afro"):
            assert abs(par[k] - ref[k]) <= 1e-12 * max(1.0, ref[k])


# --------------------------------------------------------------- cross_batch
def test_cross_batch_on_mesh_lanes_are_the_family(ranks2, ranks4):
    """cross_batch(mesh=): the 4-lane MVN family sharded over 2 and 4 ranks
    (no collective while the lanes run, their results gathered) returns on
    every rank each lane of the one-process family: ranks, sweeps, n_evals
    and pivots equal, values to 1e-12 (kernel A's plain version batched
    over another number of lanes sums in another order)."""
    fam = _family()
    ref = cross_batch(fam.fun, [fam.n] * 4, fam.params, max_rank=6, pivoting=1,
                      accuracy=500 * 2.2e-16, quad=[fam.quad_weights] * 4, truth=1.0, key=3,
                      device="cpu")
    for per_rank in (ranks2, ranks4):
        for r in per_rank:
            assert len(r["batch"]) == 4
            for got, want in zip(r["batch"], ref):
                assert (got["ranks"], got["neval"], got["sweeps"]) == (want.ranks, want.neval,
                                                                       want.sweeps)
                assert np.array_equal(got["vip"], want.state.vip)
                np.testing.assert_allclose(got["values"], want.values, rtol=1e-12)
    mesh3 = BondMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divisible"):
        cross_batch(fam.fun, [fam.n] * 4, fam.params, max_rank=4, mesh=mesh3)


# ------------------------------------------------------------------- defect
def test_defect_corrected_on_mesh_matches_jax(ranks2, defect_jax):
    """cross_defect_corrected(mesh=): both levels' crosses on 2 ranks, fed
    each JAX device's uniforms, against the JAX package's on two devices:
    the same evaluations and ranks per level; the totals as the one-device
    comparison holds them (tests/test_torch_defect.py: the f64 engines
    agree to rounding, not bit for bit)."""
    j = defect_jax
    hi, lo, info = ranks2[0]["defect"]
    assert repr(ranks2[1]["defect"]) == repr(ranks2[0]["defect"])
    assert info["nevals"] == j["info"]["nevals"]
    assert info["ranks"] == [tuple(r) for r in j["info"]["ranks"]]
    q1, jq1 = info["q1"], j["info"]["q1"]
    assert abs((q1[0] - jq1[0]) + (q1[1] - jq1[1])) <= 1e-15 * abs(jq1[0])
    assert abs((hi - j["hi"]) + (lo - j["lo"])) <= 1e-15 * abs(j["hi"])
    assert 1e-13 < abs(info["q2"][0]) < 1e-8
