"""The port's all-bonds-batched sweeps (cross/engine_jacobi.py) against the
JAX engine's, on the CPU.

The port is fed the JAX engine's lottery uniforms (one split of the state
key per sweep, ttcross_tpu/cross/engine_jacobi.py:521-522; both red-black
phases of a sweep use the same draw), so the candidates are the same
integers.  The JAX hunt ranks the fiber residuals in f32 and recomputes the
chosen pivot in f64; the port ranks them in f64.  The two can therefore
pick differently only at an f32 near-tie, and the hunt test holds a
differing pick to exactly that."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_ising as jmake_ising
from ttcross_tpu.config import precision_thresholds
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu.cross.chain_eval import ChainEvaluator as JChainEvaluator
from ttcross_tpu.cross.engine import CrossConfig as JCrossConfig
from ttcross_tpu.cross.engine import make_engine as jmake_engine
from ttcross_tpu_torch.apps import make_ising
from ttcross_tpu_torch.cross import cross
from ttcross_tpu_torch.cross.engine import CrossConfig, _cross, make_engine
from ttcross_tpu_torch.interop import (chain_states_from_numpy, ising_from_numpy,
                                       state_from_numpy)

M, NQ, R = 16, 17, 8          # C_16 on a 17-point rule: d = 15, rank 8
NLOT = 2 * (R + NQ)
SWEEPS = R - 1
ACC = 500 * 2.2e-16
MODES = [("jacobi", False), ("jacobi", True), ("jacobi-rb", False), ("jacobi-rb", True)]
MODE_IDS = ["jacobi", "jacobi+chain", "rb", "rb+chain"]


@pytest.fixture(scope="module")
def problems():
    jp = jmake_ising("C", M, NQ)
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", M, jp.truth, "cpu")
    return jp, tp


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _kits(problems, mode, chain, piv=1):
    jp, tp = problems
    d, N = jp.d, jp.n
    se, sp = precision_thresholds(jnp.float64)
    kw = dict(d=d, n=(N,) * d, N=N, R=R, piv=piv, small_element=se, small_pivot=sp,
              jacobi=True, rb=mode == "jacobi-rb")
    jkit = jmake_engine(jp.fun, JCrossConfig(**kw), chain=jp.chain if chain else None)
    pkit = make_engine(tp.fun, CrossConfig(**kw), "cpu", chain=tp.chain if chain else None)
    return jkit, pkit


@pytest.fixture(scope="module")
def trajectories(problems):
    """Per (mode, chain): the two engines and the JAX run's pre-sweep
    states, carried chain states and uniforms, sweep by sweep (one JAX
    engine per configuration, shared by the tests of this file)."""
    jp, _ = problems
    d = jp.d
    out = {}
    for mode, chain in MODES:
        jkit, pkit = _kits(problems, mode, chain)
        jev = JChainEvaluator(jp.chain, d) if chain else None
        jst = jkit.init_fn(jax.random.PRNGKey(0))
        cs = jev.states_from_vip(jst.vip) if chain else None
        steps = []
        for it in range(1, SWEEPS + 1):
            _, sub = jax.random.split(jst.key)     # what the JAX sweep draws
            U = np.asarray(jax.random.uniform(sub, (d - 1, 2, NLOT), jnp.float64))
            steps.append((it, jst, cs, U))
            if chain:
                jst, cs = jkit.sweep_fn(jst, it, None, cs)
            else:
                jst = jkit.sweep_fn(jst, it)
        out[mode, chain] = (jkit, pkit, steps, jst, cs)
    return out


def _port_inputs(jst, cs, U):
    pst = state_from_numpy(_np_state(jst), "cpu")
    pcs = None if cs is None else chain_states_from_numpy(np.asarray(cs[0]), np.asarray(cs[1]), "cpu")
    return pst, pcs, torch.from_numpy(U.copy())


def _assert_state_close(pst, js, tag):
    """rk, vip, neval and padded exactly; cores, rowf, its rows lu_u and the
    pivots lu_d to 1e-12 * amax (sampled values and their L-solves: rounding
    only); colf, its rows lu_c and L^-1 (built from them) to 1e-12 * amax /
    min|pivot| (colf divides a residual's rounding difference by the
    accepted pivots); T^-1, whose entries grow like the inverse pivots, to
    1e-9 relative beside that."""
    for f in ("rk", "vip", "neval", "padded"):
        assert np.array_equal(getattr(pst, f).numpy(), js[f]), (tag, f)
    amax = js["amax"]
    np.testing.assert_allclose(float(pst.amax), amax, rtol=1e-15)
    np.testing.assert_allclose(float(pst.pivotmax), js["pivotmax"], rtol=1e-10)
    np.testing.assert_allclose(float(pst.pivotmin), js["pivotmin"], rtol=1e-8)
    np.testing.assert_allclose(float(pst.pivotmax_prev), js["pivotmax_prev"], rtol=1e-10)
    for f in ("cores", "rowf", "lu_u", "lu_d"):
        np.testing.assert_allclose(getattr(pst, f).numpy(), js[f], rtol=0,
                                   atol=1e-12 * amax, err_msg=f"{tag} {f}")
    pivmin = np.min(np.abs(js["lu_d"]))
    for f, rtol in (("colf", 0), ("lu_c", 0), ("itl", 0), ("itt", 1e-9)):
        np.testing.assert_allclose(getattr(pst, f).numpy(), js[f], rtol=rtol,
                                   atol=1e-12 * amax / pivmin, err_msg=f"{tag} {f}")


def _compare_hunts(jh, ph, jout, pout, fwd, tag):
    """The hunt dicts and (amax, neval, padded) of the two packages on live
    bonds.  Equal picks: fibers to 1e-13 relative, pivots to 1e-9 relative
    of amax-scale rounding.  A differing pick must be an f32 near-tie of
    the reference: the JAX pick's f64 residual within 2^-20 relative of the
    port's (the port's is the f64 maximum)."""
    assert int(pout[1]) == int(jout[1]) and int(pout[2]) == int(jout[2]), tag
    np.testing.assert_allclose(float(pout[0]), float(jout[0]), rtol=1e-15)
    same = np.ones(len(np.asarray(jh["ii"])), bool)
    for k in ("ii", "jj", "kk", "qq"):
        same &= np.asarray(jh[k]) == ph[k].numpy()
    pj, pp = np.asarray(jh["pivot"]), ph["pivot"].numpy()
    first, second = ("acol", "arow") if fwd else ("arow", "acol")
    fmax = np.abs(np.asarray(jh[first])).reshape(len(same), -1).max(axis=1)
    for b in np.flatnonzero(~same):
        assert abs(pp[b]) >= abs(pj[b]) * (1 - 1e-12), (tag, b, pj[b], pp[b])
        assert abs(pp[b]) - abs(pj[b]) <= 2.0 ** -20 * fmax[b], (tag, b, pj[b], pp[b], fmax[b])
    scale = np.abs(np.asarray(jh["acol"])).max()
    np.testing.assert_allclose(pp[same], pj[same], rtol=0, atol=1e-13 * scale, err_msg=tag)
    # the first pass's fiber is evaluated before any pick can differ
    np.testing.assert_allclose(ph[first].numpy(), np.asarray(jh[first]), rtol=1e-13, err_msg=tag)
    np.testing.assert_allclose(ph[second].numpy()[same], np.asarray(jh[second])[same],
                               rtol=1e-13, err_msg=tag)
    return int((~same).sum())


@pytest.mark.parametrize("mode,chain", MODES, ids=MODE_IDS)
def test_hunt_parity(mode, chain, trajectories):
    """From each JAX pre-sweep state and its uniforms: the same n_evals and
    padded exactly, the same seeds and picks (ii, jj, kk, qq) and fibers
    (1e-13), over the full window and over a red-black parity."""
    jkit, pkit, steps, _, _ = trajectories[mode, chain]
    nb = M - 2
    differing = 0
    for it, jst, cs, U in steps:
        fwd = it % 2 == 1
        # a red-black parity as the live mask on two of the sweeps
        for live in (np.ones(nb, bool), np.arange(nb) % 2 == 1)[:1 + (it in (2, 5))]:
            jh, *jout = jkit.jacobi_hunt(jst, jnp.asarray(U), fwd, 0, nb, jnp.asarray(live),
                                         None, cs)
            pst, pcs, pU = _port_inputs(jst, cs, U)
            ph, *pout = pkit.jacobi_hunt(pst, pU, fwd, 0, nb, torch.from_numpy(live), cs=pcs)
            lv = torch.from_numpy(live)
            jh = {k: np.asarray(v)[live] for k, v in jh.items()}
            ph = {k: v[lv] for k, v in ph.items()}
            differing += _compare_hunts(jh, ph, jout, pout, fwd, (it, live[0]))
    assert differing <= 20


def test_hunt_parity_lottery_only_and_window(problems):
    """pivoting = 0 returns the lottery's seed and its two fibers, so the
    candidates themselves are compared; and a window (base, mc) of the bonds
    gives the full hunt's rows."""
    jkit, pkit = _kits(problems, "jacobi", True, piv=0)
    jp, _ = problems
    d, nb = jp.d, jp.d - 1
    jev = JChainEvaluator(jp.chain, d)
    jst = jkit.init_fn(jax.random.PRNGKey(1))
    cs = jev.states_from_vip(jst.vip)
    for it in (1, 2, 3):
        _, sub = jax.random.split(jst.key)
        U = np.asarray(jax.random.uniform(sub, (nb, 2, NLOT), jnp.float64))
        live = np.ones(nb, bool)
        jh, *jout = jkit.jacobi_hunt(jst, jnp.asarray(U), it % 2 == 1, 0, nb, jnp.asarray(live),
                                     None, cs)
        pst, pcs, pU = _port_inputs(jst, cs, U)
        ph, *pout = pkit.jacobi_hunt(pst, pU, it % 2 == 1, 0, nb, torch.from_numpy(live), cs=pcs)
        for k in ("ii", "jj", "kk", "qq"):
            assert np.array_equal(np.asarray(jh[k]), ph[k].numpy()), (it, k)
        assert int(pout[1]) == int(jout[1]) and int(pout[2]) == int(jout[2])
        for k in ("acol", "arow", "pivot"):
            np.testing.assert_allclose(ph[k].numpy(), np.asarray(jh[k]), rtol=1e-13,
                                       atol=1e-13 * float(jout[0]))
        base, mc = 3, 5
        wh, *_ = pkit.jacobi_hunt(pst, pU[base:base + mc], it % 2 == 1, base, mc,
                                  torch.ones(mc, dtype=torch.bool), cs=pcs)
        for k, v in wh.items():
            assert torch.equal(v, ph[k][base:base + mc]), (it, k)
        jst, cs = jkit.sweep_fn(jst, it, None, cs)


@pytest.mark.parametrize("skip_corners,use_live", [(False, False), (True, True), (False, True)],
                         ids=["corners", "rb-phase", "corners+live"])
@pytest.mark.parametrize("chain", [False, True], ids=["plain", "chain"])
def test_apply_parity(chain, skip_corners, use_live, trajectories):
    """The JAX hunt dict fed to both jacobi_apply: the same accepts, vip and
    rk exactly, the factors to rounding (see _assert_state_close), with and
    without the corner batch and with a live mask; the accept mask and the
    slots of ret_accept equal."""
    jkit, pkit, steps, _, _ = trajectories["jacobi", chain]
    nb = M - 2
    for it, jst, cs, U in steps[:5]:
        live = jnp.ones((nb,), bool)
        hunt, amax, neval, padded = jkit.jacobi_hunt(jst, jnp.asarray(U), it % 2 == 1, 0, nb,
                                                     live, None, cs)
        jst2 = jst._replace(amax=amax, neval=neval, padded=padded)
        lv = (np.arange(nb) % 2 == 0) if use_live else None
        jnew, jupd, jslots = jkit.jacobi_apply(
            jst2, hunt, live=None if lv is None else jnp.asarray(lv),
            skip_corners=skip_corners, ret_accept=True)
        pst = state_from_numpy(_np_state(jst2), "cpu")
        phunt = {k: torch.from_numpy(np.array(v)) for k, v in hunt.items()}
        pnew, pupd, pslots = pkit.jacobi_apply(
            pst, phunt, live=None if lv is None else torch.from_numpy(lv),
            skip_corners=skip_corners, ret_accept=True)
        assert np.array_equal(pupd.numpy(), np.asarray(jupd))
        assert np.array_equal(pslots.numpy(), np.asarray(jslots))
        assert pupd.any()
        _assert_state_close(pnew, _np_state(jnew), (it, chain, skip_corners, use_live))


@pytest.mark.parametrize("mode,chain", MODES, ids=MODE_IDS)
def test_per_sweep_parity(mode, chain, trajectories):
    """From each JAX pre-sweep (st, cs), one port sweep with the same
    uniforms reproduces the JAX sweep (see _assert_state_close), and the
    carried chain states to 1e-13.  Once the residuals fall to f32's
    rounding of the sampled values (~1e-7 of them: sweep 4 on, here), the
    reference's f32 ranking picks among near-ties (test_hunt_parity holds
    each such pick to that), and a sweep with a differing pick is held to
    the same ranks, n_evals and padded evals only."""
    jkit, pkit, steps, jlast, cslast = trajectories[mode, chain]
    after = [(s[1], s[2]) for s in steps[1:]] + [(jlast, cslast)]
    matched = []
    for (it, jst, cs, U), (jnext, csnext) in zip(steps, after):
        pst, pcs, pU = _port_inputs(jst, cs, U)
        out = pkit.sweep_fn(pst, it, pU, pcs)
        pnew, pcs2 = out if chain else (out, None)
        js = _np_state(jnext)
        if not np.array_equal(pnew.vip.numpy(), js["vip"]):
            for f in ("rk", "neval", "padded"):
                assert np.array_equal(getattr(pnew, f).numpy(), js[f]), (mode, chain, it, f)
            continue
        matched.append(it)
        _assert_state_close(pnew, js, (mode, chain, it))
        if chain:
            for got, want in zip(pcs2, csnext):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                                           err_msg=str((mode, it)))
    assert matched[:3] == [1, 2, 3], matched


def _port_run(tp, mode, chain, uniforms=None, accuracy=ACC, **kw):
    return _cross(tp.fun, [tp.n] * tp.d, max_rank=R, accuracy=accuracy, pivoting=1,
                  quad=[tp.quad_weights] * tp.d, truth=tp.truth, key=0, dtype=torch.float64,
                  verbose=False, max_sweeps=None, small_element=None, small_pivot=None,
                  oversample=0, sweep_mode=mode, device="cpu",
                  chain=tp.chain if chain else None, uniforms=uniforms,
                  **{"return_state": False, **kw})


@pytest.mark.parametrize("mode,chain", MODES, ids=MODE_IDS)
def test_whole_run_parity(mode, chain, problems, trajectories):
    """A whole run of the port at C_16 (n = 17, rank 8, all R - 1 sweeps)
    fed the JAX uniforms, against the JAX engine's run of the same sweeps:
    ranks, n_evals and padded evals equal; the final digits within 0.5 (the
    late f32 near-ties of the reference swap pivots for equally good ones,
    and a rank-8 train's last digit moves with them; the JAX package's own
    chain and black-box runs are held to the same 0.5)."""
    jp, tp = problems
    jkit, _, steps, jlast, _ = trajectories[mode, chain]
    pres = _port_run(tp, mode, chain, uniforms=np.stack([s[3] for s in steps]), accuracy=None)
    assert pres.sweeps == SWEEPS
    assert list(pres.ranks) == np.asarray(jlast.rk).tolist()
    assert pres.neval == int(jlast.neval)
    assert pres.padded_evals == int(jlast.padded)
    w = jnp.asarray(np.tile(jp.quad_weights, (jp.d, 1)))
    jdig = -np.log10(abs(1.0 - float(jkit.value_fn(jlast, w)) / jp.truth))
    pdig = -np.log10(pres.errors[-1])
    assert abs(pdig - jdig) <= 0.5
    assert [h.direction for h in pres.history] == [">>", "<<"] * 3 + [">>"]


@pytest.mark.parametrize("mode", ["jacobi", "jacobi-rb"])
def test_chain_run_matches_plain_run(mode, problems):
    """The port's chain and black-box runs examine the same entries: equal
    n_evals, sweeps and ranks, values to 1e-9 (the interface states merge in
    another order than the integrand's products)."""
    _, tp = problems
    plain = _port_run(tp, mode, False)
    chained = _port_run(tp, mode, True, return_state=True)
    assert (chained.neval, chained.sweeps, chained.ranks) == (plain.neval, plain.sweeps,
                                                               plain.ranks)
    np.testing.assert_allclose(chained.values, plain.values, rtol=1e-9)
    assert plain.chain_states is None
    # the carried states equal a rebuild from the final pivot chains
    kit = make_engine(tp.fun, CrossConfig(d=tp.d, n=(tp.n,) * tp.d, N=tp.n, R=R, piv=1,
                                          small_element=0.0, small_pivot=0.0, jacobi=True),
                      "cpu", chain=tp.chain)
    for got, want in zip(chained.chain_states, kit.chain_ev.states_from_vip(chained.state.vip)):
        rk = chained.state.rk[1:-1]
        live = torch.arange(R)[None, :] < rk[:, None]       # rows of accepted pivots
        live_l = torch.cat([torch.ones(1, R, dtype=torch.bool), live[:-1]])
        live_r = torch.cat([live[1:], torch.ones(1, R, dtype=torch.bool)])
        m = live_l if got is chained.chain_states[0] else live_r
        np.testing.assert_allclose(got[m].numpy(), want[m].numpy(), rtol=1e-13)


def test_public_cross_runs_the_long_chain_path_and_rejects_full_pivoting(problems):
    _, tp = problems
    res = cross(tp.fun, [tp.n] * tp.d, max_rank=6, accuracy=ACC, pivoting=1,
                quad=[tp.quad_weights] * tp.d, truth=tp.truth, sweep_mode="jacobi-rb",
                chain=tp.chain, return_state=True, device="cpu")
    assert -np.log10(res.errors[-1]) > 5.5 and max(res.ranks) <= 6
    assert res.chain_states[0].shape == (tp.d - 1, 6, 4)
    for mode in ("jacobi", "jacobi-rb"):
        with pytest.raises(ValueError, match="pivoting >= 0"):
            cross(tp.fun, [tp.n] * tp.d, max_rank=4, pivoting=-1, sweep_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep_mode"):
        cross(tp.fun, [tp.n] * tp.d, max_rank=4, sweep_mode="gauss-seidel", device="cpu")
    with pytest.raises(ValueError, match="sequential sweeps"):
        cross(tp.fun, [tp.n] * tp.d, max_rank=4, sweep_mode="jacobi", adaptive=True,
              device="cpu")
    # the weighted lottery runs on the all-bonds hunt too, and needs the weights
    with pytest.raises(ValueError, match="quad"):
        cross(tp.fun, [tp.n] * tp.d, max_rank=4, sweep_mode="jacobi", weighted_lottery=True,
              device="cpu")
    res = cross(tp.fun, [tp.n] * tp.d, max_rank=4, quad=[tp.quad_weights] * tp.d,
                truth=tp.truth, sweep_mode="jacobi", weighted_lottery=True, device="cpu")
    assert res.tt.ready() and -np.log10(res.errors[-1]) > 3.0


def long_chain_digits_over_keys(m=256, mode="jacobi-rb", chain=True, keys=range(8),
                                packages=("port", "jax")):
    """Not a test: the digits and n_evals of a long-chain configuration
    (C_m, n = 17, rank 10, the sweep mode, with or without the chain) over
    lottery keys on the CPU, for either package; chip_smoke.py's digit
    floors stand on these.

        JAX_PLATFORMS=cpu python tests/test_torch_jacobi.py [m [mode [chain|plain]]]
    """
    import json
    import statistics

    rows = {}
    for which in packages:
        make, run, kw = ((make_ising, cross, dict(device="cpu")) if which == "port"
                         else (jmake_ising, jcross, {}))
        p = make("C", m, 17, **kw)
        rows[which] = []
        for key in keys:
            r = run(p.fun, [p.n] * p.d, max_rank=10, accuracy=ACC, pivoting=1,
                    quad=[p.quad_weights] * p.d, truth=p.truth, sweep_mode=mode,
                    chain=p.chain if chain else None, key=key, **kw)
            rows[which].append({"key": key, "digits": float(-np.log10(r.errors[-1])),
                                "n_evals": int(r.neval), "sweeps": int(r.sweeps)})
        rows[which + "_median_digits"] = statistics.median(x["digits"] for x in rows[which])
    print(json.dumps({"config": f"C_{m} n=17 rank 10 {mode} {'chain' if chain else 'plain'}, CPU",
                      **rows}))
    return rows


if __name__ == "__main__":
    import sys

    argv = sys.argv[1:] + ["256", "jacobi-rb", "chain"][len(sys.argv) - 1:]
    long_chain_digits_over_keys(int(argv[0]), argv[1], argv[2] == "chain")
