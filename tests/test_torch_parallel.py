"""The port's distributed engine (ttcross_tpu_torch/parallel/engine.py)
against the JAX package's, on the CPU.

The JAX engine runs on 2 or 4 devices of the conftest's virtual CPU mesh;
the port on as many gloo ranks, spawned once per world size for all the
cases of this file (parallel/launch.py::spawn_ranks, each rank joined with
a time limit).  Every port rank is fed the uniforms that the JAX device of
its index draws (fold_in(key, device), then one split per sweep,
ttcross_tpu/parallel/engine.py:126-127, 331-332), so the candidates are the
same integers.  The sequential sweeps are compared pivot for pivot; the
all-bonds sweeps as tests/test_torch_jacobi.py compares them (the JAX hunt
ranks its residuals in f32).

The rank functions are at module level and this module imports nothing of
JAX at import time: the spawned ranks import it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.cross.engine import _cross
from ttcross_tpu_torch.parallel import (bond_mesh, cross_mp_parallel, cross_parallel, share,
                                        spawn_ranks)
from ttcross_tpu_torch.parallel.engine import rank_uniforms, slab_bounds
from ttcross_tpu_torch.tt.ops import full as pfull
from ttcross_tpu_torch.tt.ops import gather as pgather
from ttcross_tpu_torch.tt.types import TT

TIMEOUT = 240          # seconds per spawned group
ACC = 500 * 2.2e-16


def _cores(seed, ns, ranks):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i, n in enumerate(ns)]


# name: (problem, run kwargs, ranks).  "tt": the gather of an exact-rank
# train (tests/test_parallel.py's targets); "ising": C_m on a 17-point rule.
# One JAX compile per case; the all-bonds sweeps' cases are in
# tests/test_torch_parallel_jacobi.py.
CASES = {
    "exact_4": (("tt", 0, (5,) * 5, (1, 2, 2, 2, 2, 1)),
                dict(max_rank=3, pivoting=1, accuracy=1e-12, quad=True), 4),
    "ragged": (("tt", 1, (5, 7, 6, 5, 6), (1, 2, 2, 2, 2, 1)),
               dict(max_rank=3, pivoting=1, accuracy=1e-12), 2),
    "mybonds": (("ising", 7, 17),
                dict(max_rank=6, pivoting=1, accuracy=ACC, mybonds=[0, 1, 5], quad=True), 2),
    "piv0": (("tt", 3, (5,) * 5, (1, 2, 2, 2, 2, 1)),
             dict(max_rank=3, pivoting=0, accuracy=1e-12), 2),
    "full_piv": (("tt", 4, (5,) * 5, (1, 2, 2, 2, 2, 1)),
                 dict(max_rank=3, pivoting=-1, accuracy=1e-12), 2),
    "oversample": (("tt", 5, (7,) * 5, (1, 2, 3, 3, 2, 1)),
                   dict(max_rank=3, pivoting=1, accuracy=1e-12, oversample=2, quad=True), 2),
}


# ------------------------------------------------------------ the port's ranks
def _port_problem(problem, tables=None):
    """(fun, n, quad weights, truth, chain) of the port on the CPU."""
    if problem[0] == "tt":
        _, seed, ns, ranks = problem
        t = TT(tuple(torch.from_numpy(c) for c in _cores(seed, ns, ranks)))
        top = torch.tensor(ns) - 1      # the padded fibers index past a short mode; JAX clamps

        def fun(ind):
            return pgather(t, torch.minimum(ind, top))

        return fun, list(ns), [np.full(n, 1.0 / n) for n in ns], float(pfull(t).mean()), None
    from ttcross_tpu_torch.interop import ising_from_numpy

    nodes, weights, qw, truth = tables
    p = ising_from_numpy(nodes, weights, qw, "C", problem[1], truth, "cpu")
    return p.fun, [p.n] * p.d, [p.quad_weights] * p.d, p.truth, p.chain


def _port_case(problem, kw, uniforms, tables=None):
    """One cross_parallel run on this rank; the final pivots (vip) are
    read where the run finalizes its train."""
    import ttcross_tpu_torch.parallel.engine as E

    fun, n, quad, truth, chain = _port_problem(problem, tables)
    kw = dict(kw)
    use_quad, use_chain = kw.pop("quad", False), kw.pop("chain", False)
    mesh = bond_mesh(device="cpu")
    seen, orig = {}, E.finalize

    def finalize(st, kit):
        seen.update(vip=st.vip.numpy().copy(), rk=st.rk.numpy().copy())
        return orig(st, kit)

    E.finalize = finalize
    try:
        res = cross_parallel(fun, n, quad=quad if use_quad else None,
                             truth=truth if use_quad else None, mesh=mesh,
                             chain=chain if use_chain else None,
                             uniforms=uniforms[mesh.rank], **kw)
    finally:
        E.finalize = orig
    return dict(ranks=res.ranks, neval=res.neval, padded=res.padded_evals, sweeps=res.sweeps,
                values=list(res.values), vip=seen["vip"], full=pfull(res.tt).numpy())


def _port_cases(jobs):
    return [_port_case(*job) for job in jobs]


# ------------------------------------------------------------ the JAX side
_MESHES = {}


def _jax_problem(problem):
    import jax.numpy as jnp

    import ttcross_tpu.tt as jtt

    if problem[0] == "tt":
        _, seed, ns, ranks = problem
        t = jtt.from_cores([jnp.asarray(c) for c in _cores(seed, ns, ranks)])
        return ((lambda ind: jtt.gather(t, ind)), list(ns), [np.full(n, 1.0 / n) for n in ns],
                float(np.asarray(jtt.full(t)).mean()), None, None)
    from ttcross_tpu.apps import make_ising

    p = make_ising("C", problem[1], problem[2])
    return p.fun, [p.n] * p.d, [p.quad_weights] * p.d, p.truth, p.chain, (
        p.nodes, p.weights, p.quad_weights, p.truth)


def jax_parallel(problem, kw, ndev, key=0):
    """The JAX engine's run of a case on ndev virtual devices (its
    shard_map'd runner, for the final pivots), its train as the JAX
    cross_parallel builds it (rounded after an oversampled run), and the
    uniforms each device drew, (ndev, sweeps, rows, 2, NLOT)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import ttcross_tpu.tt as jtt
    from ttcross_tpu.config import precision_thresholds
    from ttcross_tpu.cross.engine import CrossConfig, CrossResult, finalize, round_and_revalue
    from ttcross_tpu.parallel.engine import get_parallel_engine

    fun, n, quad, truth, chain, tables = _jax_problem(problem)
    kw = dict(kw)
    use_quad, use_chain = kw.pop("quad", False), kw.pop("chain", False)
    d, N = len(n), max(n)
    R = kw["max_rank"] + kw.get("oversample", 0)
    mode = kw.get("sweep_mode", "sequential")
    se, sp = precision_thresholds(jnp.float64)
    cfg = CrossConfig(d=d, n=tuple(n), N=N, R=R, piv=kw["pivoting"], small_element=se,
                      small_pivot=sp, jacobi=mode != "sequential", rb=mode == "jacobi-rb",
                      adaptive=0.0)
    mesh = _MESHES.setdefault(ndev, Mesh(np.asarray(jax.devices()[:ndev]), ("bond",)))
    kit, make_run_fn = get_parallel_engine(fun, cfg, mesh, kw.get("mybonds"),
                                           chain=chain if use_chain else None)
    st0 = kit.init_fn(jax.random.PRNGKey(key))
    w = np.zeros((d, N))
    if use_quad:
        for c in range(d):
            w[c, :n[c]] = quad[c]
    st, last, vals, _, _ = make_run_fn(R - 1, use_quad, kw["accuracy"])(st0, jnp.asarray(w))
    last = int(last)
    res = CrossResult(tt=finalize(st, cfg, kit), neval=int(st.neval), sweeps=last,
                      ranks=tuple(int(x) for x in np.asarray(st.rk)),
                      values=[float(v) for v in np.asarray(vals)[:last + 1]] if use_quad else [],
                      errors=[], time=0.0, converged=False, padded_evals=int(st.padded))
    if kw.get("oversample"):
        res = round_and_revalue(res, kw["max_rank"], quad if use_quad else None,
                                truth if use_quad else None)
    own = slab_bounds(d, ndev, kw.get("mybonds"))
    rows = int(np.max(np.diff(own))) if cfg.jacobi else d - 1
    U = []
    for me in range(ndev):
        k, blocks = jax.random.fold_in(st0.key, me), []
        for _ in range(R - 1):
            k, sub = jax.random.split(k)
            blocks.append(np.asarray(jax.random.uniform(sub, (rows, 2, 2 * (R + N)), jnp.float64)))
        U.append(np.stack(blocks))
    return dict(ranks=res.ranks, neval=res.neval, padded=res.padded_evals, sweeps=res.sweeps,
                values=list(res.values), vip=np.asarray(st.vip),
                full=np.asarray(jtt.full(res.tt)), U=np.stack(U), tables=tables)


def run_cases(cases):
    """Every case through the JAX engine, then through the port: one spawn
    of gloo ranks per world size for all its cases; every rank's result
    must be rank 0's.  Returns ({name: JAX run}, {name: port run})."""
    jres = {name: jax_parallel(prob, kw, ndev) for name, (prob, kw, ndev) in cases.items()}
    pres = {}
    for world in sorted({c[2] for c in cases.values()}):
        names = [nm for nm, c in cases.items() if c[2] == world]
        jobs = [(cases[nm][0], cases[nm][1], jres[nm]["U"], jres[nm]["tables"]) for nm in names]
        per_rank = spawn_ranks(_port_cases, world, args=(jobs,), timeout=TIMEOUT)
        for i, nm in enumerate(names):
            for r in range(1, world):     # every rank returns the same result
                for k, v in per_rank[0][i].items():
                    assert np.array_equal(np.asarray(v), np.asarray(per_rank[r][i][k])), (nm, r, k)
            pres[nm] = per_rank[0][i]
    return jres, pres


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_sequential_matches_jax(name, runs):
    """The sequential distributed sweep, pivot for pivot: ranks, vip,
    n_evals, padded evals and sweeps equal; per-sweep values within 1e-13
    relative; the trains within 1e-12 of their largest entry; and for the
    exact-rank targets the dense tensor recovered."""
    jres, pres = runs
    j, p = jres[name], pres[name]
    assert (p["ranks"], p["neval"], p["padded"], p["sweeps"]) == \
        (j["ranks"], j["neval"], j["padded"], j["sweeps"]), name
    assert np.array_equal(p["vip"], j["vip"]), name
    np.testing.assert_allclose(p["values"], j["values"], rtol=1e-13, atol=0)
    scale = np.abs(j["full"]).max()
    np.testing.assert_allclose(p["full"], j["full"], rtol=0, atol=1e-12 * scale)
    prob = CASES[name][0]
    if prob[0] == "tt":
        t = TT(tuple(torch.from_numpy(c) for c in _cores(*prob[1:])))
        assert np.abs(p["full"] - pfull(t).numpy()).max() < 1e-10 * scale


def _one_rank_vs_cross(problem, tables, U, modes):
    """cross_parallel on one rank against cross() with the same uniforms:
    bit for bit (values, ranks, counts, cores)."""
    fun, n, quad, truth, chain = _port_problem(problem, tables)
    out = []
    for mode, use_chain in modes:
        kw = dict(max_rank=6, accuracy=ACC, pivoting=1, quad=quad, truth=truth,
                  chain=chain if use_chain else None, sweep_mode=mode)
        a = cross_parallel(fun, n, mesh=bond_mesh(device="cpu"), uniforms=U, **kw)
        b = _cross(fun, n, key=0, dtype=torch.float64, verbose=False, return_state=False,
                   max_sweeps=None, small_element=None, small_pivot=None, oversample=0,
                   device="cpu", uniforms=U, **kw)
        out.append(a.values == b.values and a.ranks == b.ranks and a.neval == b.neval
                   and a.padded_evals == b.padded_evals and a.sweeps == b.sweeps
                   and all(torch.equal(x, y) for x, y in zip(a.tt.cores, b.tt.cores)))
    return out


def test_one_rank_is_cross(runs):
    """One rank owns every bond: no replay, no fixup, the folds are
    identities, and the run is cross()'s with the same uniforms, bit for
    bit, for the sequential and the all-bonds sweeps (with the chain)."""
    jres, _ = runs
    tables = jres["mybonds"]["tables"]
    U = rank_uniforms(3, 0, 5, 5, 2 * (6 + 17))
    modes = [("sequential", False), ("jacobi", False), ("jacobi-rb", True)]
    got = spawn_ranks(_one_rank_vs_cross, 1, args=(("ising", 7, 17), tables, U, modes),
                      timeout=TIMEOUT)[0]
    assert got == [True] * len(modes)


def test_share_and_surface():
    """share is the JAX package's block distribution; slab checks, the
    stream of each rank, and cross_mp_parallel's worker-count check."""
    from ttcross_tpu.parallel.mesh import share as jshare

    for nb, nd in [(10, 4), (5, 5), (7, 2), (254, 4), (3, 1)]:
        assert share(nb, nd).tolist() == jshare(nb, nd).tolist()
    with pytest.raises(ValueError):
        share(3, 4)
    assert slab_bounds(6, 2, [0, 1, 5]).tolist() == [0, 1, 5]
    for ndev, bad in ((2, [0, 5]), (3, [0, 3, 3, 5]), (2, [1, 2, 5])):
        with pytest.raises(ValueError, match="mybonds"):
            slab_bounds(6, ndev, bad)
    a, b = rank_uniforms(0, 0, 2, 3, 4), rank_uniforms(0, 1, 2, 3, 4)
    assert a.shape == (2, 3, 2, 4) and not torch.equal(a, b)
    assert torch.equal(a, rank_uniforms(0, 0, 2, 3, 4))
    # cross_mp_parallel is ported (tests/test_torch_parallel_mp.py): too
    # many workers for the bonds is rejected before any worker starts
    with pytest.raises(ValueError, match="n_workers"):
        cross_mp_parallel(None, [3, 3], n_workers=2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        bond_mesh(device="cpu")


# ------------------------------------------------- digits over keys (not a test)
DIGIT_CONFIGS = {   # name: (m, n, max_rank, sweep_mode, chain)
    "c32_sequential": (32, 16, 8, "sequential", False),
    "c32_jacobi_rb": (32, 16, 8, "jacobi-rb", False),
    "c256_jacobi_rb_chain": (256, 17, 10, "jacobi-rb", True),
}


def _port_digits(name, keys):
    from ttcross_tpu_torch.apps import make_ising

    m, n, R, mode, chain = DIGIT_CONFIGS[name]
    p = make_ising("C", m, n, device="cpu")
    out = []
    for key in keys:
        r = cross_parallel(p.fun, [p.n] * p.d, max_rank=R, accuracy=ACC, pivoting=1,
                           quad=[p.quad_weights] * p.d, truth=p.truth, key=key,
                           sweep_mode=mode, chain=p.chain if chain else None,
                           mesh=bond_mesh(device="cpu"))
        out.append((float(-np.log10(r.errors[-1])), r.neval, r.sweeps))
    return out


def parallel_digits_over_keys(names=tuple(DIGIT_CONFIGS), keys=range(4), ndev=2):
    """Not a test: both packages' digits of chip_smoke.py's distributed
    configurations (bench.py's C_32 line, n = 16, rank 8, and the long
    chain, C_256, n = 17, rank 10, jacobi-rb + chain) on `ndev` ranks of
    the CPU over lottery keys; the floors of chip_smoke.py's phase 16 stand
    on them.  Each package draws its own stream per rank (JAX: fold_in of
    the key; the port: rank_key).

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parallel.py [name ...]
    """
    import json

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.config import precision_thresholds
    from ttcross_tpu.cross.engine import CrossConfig
    from ttcross_tpu.parallel.engine import get_parallel_engine

    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("bond",))
    for name in names:
        m, n, R, mode, chain = DIGIT_CONFIGS[name]
        port = spawn_ranks(_port_digits, ndev, args=(name, list(keys)), timeout=3600)[0]
        p = make_ising("C", m, n)
        se, sp = precision_thresholds(jnp.float64)
        cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=R, piv=1, small_element=se,
                          small_pivot=sp, jacobi=mode != "sequential", rb=mode == "jacobi-rb",
                          adaptive=0.0)
        kit, make_run_fn = get_parallel_engine(p.fun, cfg, mesh, chain=p.chain if chain else None)
        run = make_run_fn(R - 1, True, ACC)
        w = jnp.asarray(np.tile(p.quad_weights, (p.d, 1)))
        jd = []
        for key in keys:
            _, last, vals, _, _ = run(kit.init_fn(jax.random.PRNGKey(key)), w)
            jd.append(float(-np.log10(abs(1 - float(np.asarray(vals)[int(last)]) / p.truth))))
        print(json.dumps({"config": name, "ranks": ndev, "keys": list(keys),
                          "port": port, "jax": jd}), flush=True)


if __name__ == "__main__":
    import sys

    parallel_digits_over_keys(tuple(sys.argv[1:]) or tuple(DIGIT_CONFIGS))
