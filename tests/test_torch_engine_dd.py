"""The port's dd cross engine (cross/engine_dd.py) against the JAX dd engine.

The JAX engine splits its PRNG key once per bond visit and draws the
lottery's integers with a bound that depends on the state; the port is fed
those integers through cross_dd's test-only ``draws`` hook (and the
per-sweep test through sweep_fn's draw), recomputed here from the same key
chain.  The JAX engine is jitted and XLA:CPU contracts multiply-adds into
FMAs there, so the two agree to ~1e-31 per dd operation, not bit for bit:
pivots chosen deep in the dd noise may differ, and the comparisons hold
what the noise cannot move."""

from decimal import Decimal, localcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import ttcross_tpu  # noqa: F401  (x64)
from ttcross_tpu import native
from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
from ttcross_tpu.cross.engine_dd import DDConfig as JDDConfig
from ttcross_tpu.cross.engine_dd import get_dd_engine as jget_dd_engine
from ttcross_tpu_torch.apps.ising import ising_dd_problem, make_ising_dd
from ttcross_tpu_torch.apps.truths import ISING_C_STR
from ttcross_tpu_torch.cross.engine_dd import DDConfig, cross_dd, get_dd_engine
from ttcross_tpu_torch.interop import dd_pair_from_numpy, dd_state_from_numpy
from ttcross_tpu_torch.ops.dd import DD

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")

M, NQ, R = 4, 17, 8          # C_4 on a 17-point rule: d = 3, rank 8


def _digits(value, tru_str):
    with localcontext() as ctx:
        ctx.prec = 60
        rel = abs(1 - (Decimal(value[0]) + Decimal(value[1])) / Decimal(tru_str))
        return float(-rel.log10()) if rel != 0 else 60.0


class _KeyChain:
    """The JAX engine's lottery integers: visit v splits the key of visit
    v - 1 (the first, `key`) into (key, sub1, sub2) and draws
    randint(sub, (NLOT,), 0, max(count, 1)) from each sub (ttcross_tpu/
    cross/engine_dd.py:249-259).  Synchronizes per visit on the CPU."""

    def __init__(self, key, nlot):
        self.keys, self.subs, self.nlot = [key], [], nlot

    def __call__(self, visit, count_c, count_r):
        while len(self.subs) <= visit:
            k, s1, s2 = jax.random.split(self.keys[-1], 3)
            self.keys.append(k)
            self.subs.append((s1, s2))
        return tuple(torch.from_numpy(np.asarray(
            jax.random.randint(sub, (self.nlot,), 0, max(int(c), 1))).astype(np.int64))
            for sub, c in zip(self.subs[visit], (count_c, count_r)))


def _jax_tables(n):
    """The JAX maker's dd nodes Xn and weights Wn (ttcross_tpu/apps/
    ising.py:226-230), as numpy (hi, lo) pairs."""
    import ttcross_tpu.ops.dd as jdd

    (xh, xl), (gwh, gwl) = native.gauss_legendre_dd(n)
    Xn = jdd.dd_mul(jdd.dd_add(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)), jdd.dd(1.0)), jdd.dd(0.5))
    Wn = jdd.dd_mul(jdd.DD(jnp.asarray(gwh), jnp.asarray(gwl)), jdd.dd(0.5 * (n // 2)))
    return (np.asarray(Xn.hi), np.asarray(Xn.lo)), (np.asarray(Wn.hi), np.asarray(Wn.lo))


@pytest.fixture(scope="module")
def problems():
    """The JAX maker's problem and the port's on the same dd tables."""
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=M, n=NQ)
    (xh, xl), (wh, wl) = _jax_tables(NQ)
    assert np.array_equal(xh, jprob.nodes) and np.array_equal(wh, jprob.weights)
    pprob = ising_dd_problem(dd_pair_from_numpy(xh, xl, "cpu"), dd_pair_from_numpy(wh, wl, "cpu"),
                             M, "cpu")
    return (jprob, jfun, jwh, jwl), pprob


def _np_state(st):
    out = {}
    for k, v in st._asdict().items():
        out[k] = (np.asarray(v.hi), np.asarray(v.lo)) if hasattr(v, "hi") else np.asarray(v)
    return out


def _jax_sweeps(jfun, n, R, piv=1, key=0, accuracy=1e-28):
    """The JAX engine's states before and after each sweep of cross_dd's
    loop (its stop rule), as numpy."""
    cfg = JDDConfig(d=len(n), n=tuple(n), N=max(n), R=R, piv=piv, small_element=1e-30,
                    small_pivot=1e-12)
    kit = jget_dd_engine(jfun, cfg)
    st = kit.init_fn(jax.random.PRNGKey(key))
    out, strike, it = [], 0, 0
    lacc = float(np.log10(accuracy))
    while it + 1 < R:
        it += 1
        pre = st
        st = kit.sweep_fn(st, jnp.asarray(it))
        out.append((it, _np_state(pre), pre.key, _np_state(st)))
        strike = strike + 1 if float(st.pivotmax) <= lacc + float(st.amax) else 0
        if strike >= 3:
            break
    return kit, out


@pytest.fixture(scope="module")
def jax_sweeps(problems):
    (_, jfun, _, _), _ = problems
    return _jax_sweeps(jfun, [NQ] * (M - 1), R)


@pytest.fixture(scope="module")
def port_kit(problems):
    _, (_, pfun, _, _) = problems
    cfg = DDConfig(d=M - 1, n=(NQ,) * (M - 1), N=NQ, R=R, piv=1, small_element=1e-30,
                   small_pivot=1e-12)
    return get_dd_engine(pfun, cfg, "cpu")


def test_per_sweep_parity(jax_sweeps, port_kit):
    """From each JAX pre-sweep DDState, one port sweep with JAX's draws
    gives the same ranks, evaluations and amax, the same accepted pivots
    wherever |pivot| is above the dd noise (log10|pivot| > amax - 26), the
    raw fibers (cores, rowf) and itl within 1e-28 of the largest entry;
    colf and itt are divided by the pivots, which magnify the jitted JAX
    engine's ~1e-32 contraction noise by amax / min |pivot| (up to 3e8
    here; 3.7e-25 of colf's largest entry measured at sweep 7): within
    1e-28 of the largest entry times that factor."""
    _, sweeps = jax_sweeps
    assert len(sweeps) >= 5
    nlot = 2 * (R + NQ)
    for it, pre, key, post in sweeps:
        st = port_kit.sweep_fn(dd_state_from_numpy(pre, "cpu"), it, _KeyChain(key, nlot))
        assert np.array_equal(st.rk.numpy(), post["rk"]), it
        assert int(st.neval) == int(post["neval"]), it
        assert float(st.amax) == pytest.approx(float(post["amax"]), rel=1e-15, abs=1e-15)
        assert float(st.pivotmax) == pytest.approx(float(post["pivotmax"]), rel=1e-12, abs=1e-12)
        # accepted pivots: |pivot| = 1 / |itt[p][s, s]|
        amax = float(post["amax"])
        lpivs = [(p, s, -np.log10(abs(post["itt"][0][p, s, s])))
                 for p in range(M - 2) for s in range(int(post["rk"][p + 1]))]
        for p, s, lpiv in lpivs:
            if lpiv > amax - 26:
                assert np.array_equal(st.vip[p, s].numpy(), post["vip"][p, s]), (it, p, s)
        magnify = 10.0 ** (amax - min(lp for _, _, lp in lpivs))
        for name in ("cores", "colf", "rowf", "itl", "itt"):
            ph, pl = (getattr(st, name).hi.numpy(), getattr(st, name).lo.numpy())
            jh, jl = post[name]
            err = np.abs((ph - jh) + (pl - jl)).max()
            tol = 1e-28 * np.abs(jh).max() * (magnify if name in ("colf", "itt") else 1.0)
            assert err <= tol, (it, name, err, tol)


def test_sweeps_bit_equal_eager_jax(problems, jax_sweeps, port_kit):
    """Against the JAX engine run EAGERLY (jax.disable_jit: every dd
    operation rounded once, as eager torch rounds it), a port sweep from the
    same pre-sweep state with the same draws is the same state bit for
    bit: every difference from the jitted engine is XLA's contraction."""
    from ttcross_tpu.cross.engine_dd import DDState as JDDState
    from ttcross_tpu.ops.dd import DD as JDD

    kit, sweeps = jax_sweeps
    nlot = 2 * (R + NQ)
    for it, pre, key, _ in sweeps[:4]:
        st = port_kit.sweep_fn(dd_state_from_numpy(pre, "cpu"), it, _KeyChain(key, nlot))
        jst = JDDState(key=key, **{k: (JDD(jnp.asarray(v[0]), jnp.asarray(v[1]))
                                       if isinstance(v, tuple) else jnp.asarray(v))
                                   for k, v in pre.items() if k != "key"})
        with jax.disable_jit():
            eager = _np_state(kit.sweep_fn(jst, jnp.asarray(it)))
        for name in ("cores", "colf", "rowf", "itl", "itt"):
            part = getattr(st, name)
            assert np.array_equal(part.hi.numpy(), eager[name][0]), (it, name)
            assert np.array_equal(part.lo.numpy(), eager[name][1]), (it, name)
        for name in ("rk", "vip", "neval", "amax", "pivotmax", "pivotmax_prev"):
            assert np.array_equal(getattr(st, name).numpy(), eager[name]), (it, name)


def test_whole_run_matches_jax(problems):
    """cross_dd with JAX's draws: the ranks, sweeps and evaluations of the
    JAX run, and its value within 1e-26 (the solved cores carry 1/pivot
    factors that magnify the jitted engine's noise, as
    test_per_sweep_parity's colf and itt; the value does not)."""
    from ttcross_tpu.cross.engine_dd import cross_dd as jcross_dd

    (jprob, jfun, jwh, jwl), (pprob, pfun, wh, wl) = problems
    n = [NQ] * (M - 1)
    jres = jcross_dd(jfun, n, jwh, jwl, max_rank=R, pivoting=1)
    res = cross_dd(pfun, n, wh, wl, max_rank=R, pivoting=1, device="cpu",
                   draws=_KeyChain(jax.random.PRNGKey(0), 2 * (R + NQ)))
    assert (res.ranks, res.sweeps, res.neval) == (tuple(jres.ranks), jres.sweeps, jres.neval)
    dv = (res.value[0] - jres.value[0]) + (res.value[1] - jres.value[1])
    assert abs(dv) < 1e-26, dv
    assert _digits(res.value, ISING_C_STR[M]) == pytest.approx(_digits(jres.value, ISING_C_STR[M]),
                                                               abs=0.05)


def test_log_domain_thresholds_wide_range():
    """A D/E-style wide-dynamic-range integrand (values ~1e-280) crosses
    correctly (tests/test_engine_dd.py:50-76): acceptance and stopping
    compare log10 magnitudes, so no threshold product underflows, the
    quiet-strike stop fires and the value has >= 9 digits."""
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33, device="cpu")
    s = 2.0 ** -930                       # ~1.12e-280, exact in binary64

    def fun_scaled(ind):
        v = fun_dd(ind)
        return DD(v.hi * s, v.lo * s)     # exact power-of-2 scaling

    res = cross_dd(fun_scaled, [prob.n] * prob.d, wh, wl, max_rank=16, pivoting=1,
                   accuracy=1e-8, device="cpu")
    assert res.sweeps < 15                # the quiet-strike stop FIRED
    with localcontext() as ctx:
        ctx.prec = 60
        got = Decimal(res.value[0]) + Decimal(res.value[1])
        tru = Decimal(ISING_C_STR[4]) * (Decimal(2) ** -930)
        rel = abs(1 - got / tru)
        digits = float(-rel.log10()) if rel != 0 else 60.0
    assert digits >= 9, digits


def test_per_sweep_value_line_matches_final(capsys):
    """The in-loop dd value line (dmrggmp.f90:655-672) converges to the
    finalized train's quadrature value (tests/test_engine_dd.py:79-90), in
    the JAX package's format."""
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device="cpu")
    res = cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8, pivoting=1, verbose=True,
                   truth=ISING_C_STR[4], device="cpu")
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "err" in ln and "val" in ln]
    assert len(lines) == res.sweeps >= 5          # one line per sweep
    assert lines[0].startswith("  1>> dd lg(pivotmax)")
    last_val = float(lines[-1].split("val")[-1])
    assert abs(last_val - (res.value[0] + res.value[1])) < 1e-12


def test_default_draws_are_the_keys(problems):
    """Without the hook the port draws its own integers from `key`: the same
    key repeats the run, another key takes other pivots; both above 9
    digits at rank 8."""
    _, (pprob, pfun, wh, wl) = problems
    n = [NQ] * (M - 1)
    a = cross_dd(pfun, n, wh, wl, max_rank=R, device="cpu", key=3)
    b = cross_dd(pfun, n, wh, wl, max_rank=R, device="cpu", key=3)
    assert a.value == b.value and a.neval == b.neval
    for res in (a, cross_dd(pfun, n, wh, wl, max_rank=R, device="cpu", key=4)):
        assert _digits(res.value, ISING_C_STR[M]) > 9


# The CPU runs of both packages that chip_smoke.py's dd floors (DD_FLOORS)
# stand on, at its configurations and keys (DD_RUNS):
# PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_engine_dd.py [name ...]
# prints each configuration's digits over its keys, port / JAX package
# (each package draws its own lottery from the key).
def _run_pair(name, key):
    from decimal import getcontext

    from ttcross_tpu.apps.stdnorm import make_stdnorm_dd as jmake_stdnorm_dd
    from ttcross_tpu.cross.defect import cross_defect_corrected as jdefect
    from ttcross_tpu.cross.engine_dd import cross_dd as jcross_dd
    from ttcross_tpu_torch.apps.stdnorm import make_stdnorm_dd
    from ttcross_tpu_torch.apps.truths import TPI_STR
    from ttcross_tpu_torch.cross.defect import cross_defect_corrected

    from chip_smoke import DD_RUNS

    getcontext().prec = 60
    maker, m, n, kind, ranks, _ = DD_RUNS[name]
    if maker == "ising":
        jp, jf, jwh, jwl = jmake_ising_dd(m=m, n=n)
        pp, pf, wh, wl = make_ising_dd(m=m, n=n, device="cpu")
        truth = ISING_C_STR[m]
    else:
        jp, jf, jwh, jwl = jmake_stdnorm_dd(d=m, n=n)
        pp, pf, wh, wl = make_stdnorm_dd(d=m, n=n, device="cpu")
        truth = str((Decimal(TPI_STR) / 2) ** (m // 2))
    nn = [pp.n] * pp.d
    if kind == "dd":
        p = cross_dd(pf, nn, wh, wl, max_rank=ranks[0], pivoting=1, key=key, device="cpu").value
        j = jcross_dd(jf, nn, jwh, jwl, max_rank=ranks[0], pivoting=1, key=key).value
    else:
        acc = 5 * 2.2e-16 if maker == "stdnorm" else 1e-13
        p = cross_defect_corrected(pp.fun, pf, nn, wh, wl, max_rank=ranks[0], max_rank2=ranks[1],
                                   accuracy=acc, pivoting=1, key=key, device="cpu")[:2]
        j = jdefect(jp.fun, jf, nn, jwh, jwl, max_rank=ranks[0], max_rank2=ranks[1],
                    accuracy=acc, pivoting=1, key=key)[:2]
    return _digits(p, truth), _digits(j, truth)


if __name__ == "__main__":
    import sys
    import time

    from chip_smoke import DD_RUNS

    for name in sys.argv[1:] or DD_RUNS:
        t0 = time.perf_counter()
        pairs = [_run_pair(name, key) for key in DD_RUNS[name][5]]
        port, jaxp = ([round(x[i], 2) for x in pairs] for i in (0, 1))
        print(f"{name}: port {port} (min {min(port)}, median {np.median(port):.2f}); "
              f"JAX {jaxp} (min {min(jaxp)}, median {np.median(jaxp):.2f}); "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
