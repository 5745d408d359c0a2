"""The port's distributed dd cross (ttcross_tpu_torch/parallel/engine_dd.py)
against the JAX package's, on the CPU, at C_4 on a 17-point rule, rank 8
(d = 3: two ranks at most).

Each JAX device draws its lottery integers from its own key chain,
fold_in(key, device), split once per bond visit of its slab
(ttcross_tpu/parallel/engine_dd.py:259 and the one-device engine's
:249-259); every port rank replays its device's chain through
cross_dd_parallel's test-only ``draws`` hook, which needs JAX in the
spawned ranks (imported there, on the CPU).  With the same draws the two
runs take the same pivots, ranks and evaluations.  Their values agree to
3e-17 relative, not to the ~1e-31 per dd operation of the one-device
engines (tests/test_torch_engine_dd.py): the jitted JAX distributed engine
keeps its maintained inverse L^-1 to f64, not dd, precision (its bond-0
recurrence L_s = -c_s L_{<s} off by 1.8e-16 at C_4, n = 17, rank 8, checked
in exact rationals from its own state), where the port's holds it to 2e-32;
both runs are 10.14 digits from the truth, where the 17-point rule
limits them."""

from fractions import Fraction

import contextlib
import io
from decimal import Decimal, localcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.cross.engine_dd import cross_dd
from ttcross_tpu_torch.parallel import bond_mesh, cross_dd_parallel, spawn_ranks

M, NQ, R = 4, 17, 8
TIMEOUT = 240


def _digits(value, tru_str):
    with localcontext() as ctx:
        ctx.prec = 60
        rel = abs(1 - (Decimal(value[0]) + Decimal(value[1])) / Decimal(tru_str))
        return float(-rel.log10()) if rel != 0 else 60.0


def _problem(tables):
    """The port's dd problem on the JAX maker's dd tables, on the CPU."""
    from ttcross_tpu_torch.apps.ising import ising_dd_problem
    from ttcross_tpu_torch.interop import dd_pair_from_numpy

    (xh, xl), (wh, wl) = tables
    return ising_dd_problem(dd_pair_from_numpy(xh, xl, "cpu"), dd_pair_from_numpy(wh, wl, "cpu"),
                            M, "cpu")


class _KeyChain:
    """A JAX device's lottery integers: visit v splits the key of visit
    v - 1 (the first, the device's key) into (key, sub1, sub2) and draws
    randint(sub, (NLOT,), 0, max(count, 1)) from each sub.  JAX is imported
    where the chain is first called (a spawned rank)."""

    def __init__(self, key_data, nlot):
        self.key_data, self.nlot, self.keys, self.subs = key_data, nlot, None, []

    def __call__(self, visit, count_c, count_r):
        import jax

        jax.config.update("jax_enable_x64", True)
        if self.keys is None:
            self.keys = [jax.numpy.asarray(self.key_data, dtype=jax.numpy.uint32)]
        while len(self.subs) <= visit:
            k, s1, s2 = jax.random.split(self.keys[-1], 3)
            self.keys.append(k)
            self.subs.append((s1, s2))
        return tuple(torch.from_numpy(np.asarray(
            jax.random.randint(sub, (self.nlot,), 0, max(int(c), 1))).astype(np.int64))
            for sub, c in zip(self.subs[visit], (count_c, count_r)))


class _Draws:
    """Deterministic lottery integers of visit v: floor(u * count) from a
    generator seeded by (seed, v) (picklable, for the spawned ranks)."""

    def __init__(self, seed, nlot):
        self.seed, self.nlot = seed, nlot

    def __call__(self, visit, count_c, count_r):
        gen = torch.Generator().manual_seed(self.seed * 100003 + visit)
        u = torch.rand((2, self.nlot), generator=gen, dtype=torch.float64)
        return tuple(torch.minimum(torch.floor(u[i] * max(int(c), 1)).long(), torch.tensor(
            max(int(c), 1) - 1)) for i, c in enumerate((count_c, count_r)))


def _recurrence_error(itl, colf, vip, rk) -> float:
    """The largest |L[s, c] + sum_t c_s[t] L[t, c]| over bond 0's slots:
    the dd maintained inverse against its bordered recurrence (c_s the
    column factor's row at pivot s), in exact rationals."""
    def q(pair, idx):
        return Fraction(float(pair[0][idx])) + Fraction(float(pair[1][idx]))

    worst = 0.0
    for s in range(1, int(rk[1])):
        ii, jj = int(vip[0, s, 0]), int(vip[0, s, 1])
        c = [q(colf, (0, ii, jj, t)) for t in range(s)]
        for col in range(s):
            rec = -sum(c[t] * q(itl, (0, t, col)) for t in range(s))
            worst = max(worst, abs(float(q(itl, (0, s, col)) - rec)))
    return worst


def _result(res):
    return dict(value=res.value, ranks=res.ranks, neval=res.neval, sweeps=res.sweeps,
                vip=res.vip, cores=res.cores_hi + res.cores_lo)


def _same(a, b) -> bool:
    """Two runs' results equal: value, ranks, counts, pivots and dd cores."""
    return ((a["value"], a["ranks"], a["neval"], a["sweeps"]) == (b["value"], b["ranks"],
                                                                  b["neval"], b["sweeps"])
            and np.array_equal(a["vip"], b["vip"])
            and all(np.array_equal(x, y) for x, y in zip(a["cores"], b["cores"])))


def _rank_jax_draws(tables, key_data, truth):
    """One rank: the run fed its JAX device's draws (with this rank's final
    state's bond-0 recurrence error), then a verbose run (the per-sweep
    distributed dd value) with the same draws."""
    import ttcross_tpu_torch.parallel.engine_dd as E

    prob, fun_dd, wh, wl = _problem(tables)
    rank = torch.distributed.get_rank()
    kw = dict(max_rank=R, pivoting=1, mesh=bond_mesh(device="cpu"))
    seen, orig = {}, E.make_parallel_dd_engine

    def make(*args, **kwargs):      # reads the final state where it is gathered
        pk = orig(*args, **kwargs)

        def gather_fn(st):
            seen["err"] = _recurrence_error(st.itl, st.colf, st.vip.numpy(), st.rk.numpy())
            return pk.gather_fn(st)

        return pk._replace(gather_fn=gather_fn)

    E.make_parallel_dd_engine = make
    try:
        res = cross_dd_parallel(fun_dd, [NQ] * (M - 1), wh, wl,
                                draws=_KeyChain(key_data[rank], 2 * (R + NQ)), **kw)
    finally:
        E.make_parallel_dd_engine = orig
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res_v = cross_dd_parallel(fun_dd, [NQ] * (M - 1), wh, wl, verbose=True, truth=truth,
                                  draws=_KeyChain(key_data[rank], 2 * (R + NQ)), **kw)
    return _result(res), _result(res_v), out.getvalue(), seen["err"]


def _rank_one_vs_dd(tables):
    """One rank against cross_dd with the same draws."""
    prob, fun_dd, wh, wl = _problem(tables)
    draws = _Draws(5, 2 * (R + NQ))
    a = cross_dd_parallel(fun_dd, [NQ] * (M - 1), wh, wl, max_rank=R, pivoting=1,
                          mesh=bond_mesh(device="cpu"), draws=draws)
    b = cross_dd(fun_dd, [NQ] * (M - 1), wh, wl, max_rank=R, pivoting=1, device="cpu",
                 draws=draws)
    return _result(a), _result(b)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX dd tables; the JAX distributed dd run on two devices (its
    runner, for the final state, then cross_dd_parallel's finalization):
    value, ranks, sweeps, evaluations, pivots and its bond-0 recurrence
    error; and each device's first key."""
    import jax

    from test_torch_engine_dd import _jax_tables
    from ttcross_tpu import native
    from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
    from ttcross_tpu.cross.engine_dd import DDConfig, dd_quad_cores
    from ttcross_tpu.parallel.engine_dd import get_parallel_dd_engine
    from ttcross_tpu.parallel.mesh import bond_mesh as jbond_mesh

    if not native.available():
        pytest.skip("no native toolchain")
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=M, n=NQ)
    d = M - 1
    cfg = DDConfig(d=d, n=(NQ,) * d, N=NQ, R=R, piv=1, small_element=1e-30, small_pivot=1e-12)
    kit, make_run_fn = get_parallel_dd_engine(jfun, cfg, jbond_mesh(jax.devices()[:2]))
    st, last, _, _, _, _ = make_run_fn(R - 1, 1e-28)(kit.init_fn(jax.random.PRNGKey(0)),
                                                     np.zeros((d, NQ)), np.zeros((d, NQ)))
    solved, rk = kit.finalize_fn(st), np.asarray(st.rk)
    sh, sl = np.asarray(solved.hi), np.asarray(solved.lo)
    value = dd_quad_cores([sh[c][:rk[c], :, :rk[c + 1]] for c in range(d)],
                          [sl[c][:rk[c], :, :rk[c + 1]] for c in range(d)], jwh, jwl)
    pair = (lambda x: (np.asarray(x.hi), np.asarray(x.lo)))  # noqa: E731
    jres = dict(value=value, ranks=tuple(int(x) for x in rk), sweeps=int(last),
                neval=int(st.neval), vip=np.asarray(st.vip),
                err=_recurrence_error(pair(st.itl), pair(st.colf), np.asarray(st.vip), rk))
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), me))
                     for me in range(2)])
    return _jax_tables(NQ), jres, keys


def test_two_ranks_match_jax(jax_side):
    """Two gloo ranks fed the JAX devices' draws: both ranks the same
    result, and the pivots, ranks, sweeps and evaluations of the JAX run;
    the port's maintained inverse at dd precision (its recurrence within
    1e-30), the JAX run's at f64's (so the values agree to 1e-16 relative,
    and their digits within 0.01); the per-sweep distributed value of the
    verbose run (an all_gather of each rank's partial chain, folded in rank
    order) ends at the finalized train's value."""
    from ttcross_tpu_torch.apps.truths import ISING_C_STR

    tables, jres, keys = jax_side
    per_rank = spawn_ranks(_rank_jax_draws, 2, args=(tables, keys, ISING_C_STR[M]),
                           timeout=TIMEOUT)
    (res, res_v, text, err), other = per_rank[0], per_rank[1]
    assert _same(res, other[0])
    assert (res["ranks"], res["sweeps"], res["neval"]) == (jres["ranks"], jres["sweeps"],
                                                           jres["neval"])
    assert np.array_equal(res["vip"], jres["vip"])
    assert err <= 1e-30 and jres["err"] <= 1e-15, (err, jres["err"])
    dv = (res["value"][0] - jres["value"][0]) + (res["value"][1] - jres["value"][1])
    assert abs(dv) <= 1e-16 * abs(jres["value"][0]), dv
    assert _digits(res["value"], ISING_C_STR[M]) == pytest.approx(
        _digits(jres["value"], ISING_C_STR[M]), abs=0.01)
    assert res_v["value"] == res["value"] and other[2] == ""
    lines = [ln for ln in text.splitlines() if "err" in ln and "val" in ln]
    assert len(lines) == res["sweeps"]
    assert abs(float(lines[-1].split("val")[-1]) - sum(res["value"])) < 1e-12 * abs(
        sum(res["value"]))


def test_one_rank_is_cross_dd(jax_side):
    """One rank owns both bonds: the run is cross_dd's with the same draws,
    bit for bit (value, ranks, evaluations, pivots, dd cores)."""
    tables, _, _ = jax_side
    a, b = spawn_ranks(_rank_one_vs_dd, 1, args=(tables,), timeout=TIMEOUT)[0]
    assert _same(a, b)


def _port_dd_digits(keys, m, n, rank):
    from ttcross_tpu_torch.apps import make_ising_dd
    from ttcross_tpu_torch.apps.truths import ISING_C_STR

    prob, fun_dd, wh, wl = make_ising_dd(m=m, n=n, device="cpu")
    return [_digits(cross_dd_parallel(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=rank,
                                      pivoting=1, key=key, mesh=bond_mesh(device="cpu")).value,
                    ISING_C_STR[m]) for key in keys]


def dd_parallel_digits_over_keys(keys=range(4), m=4, n=33, rank=16):
    """Not a test: both packages' digits of cross_dd_parallel on two ranks
    of the CPU at bench.py's ising_c4_dd_tier (C_4, n = 33, rank 16) over
    lottery keys; the dd floor of chip_smoke.py's phase 16 stands on them.

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parallel_dd.py
    """
    import json

    import jax

    from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
    from ttcross_tpu.apps.truths import ISING_C_STR
    from ttcross_tpu.parallel import cross_dd_parallel as jcross_dd_parallel
    from ttcross_tpu.parallel.mesh import bond_mesh as jbond_mesh

    port = spawn_ranks(_port_dd_digits, 2, args=(list(keys), m, n, rank), timeout=3600)[0]
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=m, n=n)
    mesh = jbond_mesh(jax.devices()[:2])
    jd = [_digits(jcross_dd_parallel(jfun, [n] * (m - 1), jwh, jwl, max_rank=rank, pivoting=1,
                                     key=key, mesh=mesh).value, ISING_C_STR[m]) for key in keys]
    print(json.dumps({"config": f"cross_dd_parallel C_{m} n={n} rank {rank}, 2 ranks, CPU",
                      "keys": list(keys), "port": port, "jax": jd}), flush=True)


if __name__ == "__main__":
    dd_parallel_digits_over_keys()
