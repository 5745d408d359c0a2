"""The port's sequential cross engine against the JAX engine.

The two packages draw different random numbers, so the port is fed the
JAX engine's lottery uniforms, recomputed here from the same key chain
(ttcross_tpu/cross/engine.py:798-799: one split of the state key per
sweep).  With the same uniforms the pivot choices, ranks and evaluation
counts agree exactly; floating-point values agree to rounding."""

import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_ising as jmake_ising
from ttcross_tpu.config import precision_thresholds
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu.cross.engine import CrossConfig as JCrossConfig
from ttcross_tpu.cross.engine import make_engine as jmake_engine
from ttcross_tpu_torch.apps import make_ising
from ttcross_tpu_torch.cross import cross
from ttcross_tpu_torch.cross.engine import CrossConfig, _cross, make_engine
from ttcross_tpu_torch.interop import ising_from_numpy, state_from_numpy

M, NQ, R = 5, 17, 8     # C_5 on a 17-point rule: d = 4, rank 8


def _jax_uniforms(key, sweeps, d, nlot):
    """The JAX sequential sweep's U (d-1, 2, NLOT) for sweeps 1..sweeps,
    from the key chain that starts at PRNGKey(key)."""
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(sweeps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
    return np.stack(out)


@pytest.fixture(scope="module")
def problems():
    jp = jmake_ising("C", M, NQ)
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", M, jp.truth, "cpu")
    return jp, tp


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("piv", [1, 0, -1])
def test_per_sweep_parity(piv, problems):
    """From each JAX pre-sweep state, one port sweep with the same uniforms
    reproduces the JAX sweep: rk, vip, neval and padded exactly; cores and
    rowf to 1e-12 * amax (the sampled values and their L-solves, rounding
    only); colf to 1e-12 * amax / min|pivot| (colf = C T^-1 divides a
    residual's rounding difference by the accepted pivots)."""
    jp, tp = problems
    d, N = jp.d, jp.n
    se, sp = precision_thresholds(jnp.float64)
    kw = dict(d=d, n=(N,) * d, N=N, R=R, piv=piv, small_element=se, small_pivot=sp)
    jkit = jmake_engine(jp.fun, JCrossConfig(**kw))
    pkit = make_engine(tp.fun, CrossConfig(**kw), "cpu")
    for seed in range(3):
        jst = jkit.init_fn(jax.random.PRNGKey(seed))
        if seed == 0:
            init = pkit.init_fn()
            js = _np_state(jst)
            for f in init._fields:
                if f not in js:          # the port's sweep count, which the JAX state lacks
                    assert f == "sweeps" and int(init.sweeps) == 0
                    continue
                np.testing.assert_allclose(getattr(init, f).numpy(), js[f], rtol=1e-14,
                                           atol=1e-15 * js["amax"], err_msg=f)
        for it in range(1, R):
            _, sub = jax.random.split(jst.key)    # what the JAX sweep draws
            U = np.asarray(jax.random.uniform(sub, (d - 1, 2, 2 * (R + N)), jnp.float64))
            pst = pkit.sweep_fn(state_from_numpy(_np_state(jst), "cpu"), it,
                                torch.from_numpy(U.copy()))
            jst = jkit.sweep_fn(jst, it)
            js = _np_state(jst)
            for f in ("rk", "vip", "neval", "padded"):
                assert np.array_equal(getattr(pst, f).numpy(), js[f]), (seed, it, f)
            amax = js["amax"]
            np.testing.assert_allclose(float(pst.amax), amax, rtol=1e-15)
            np.testing.assert_allclose(float(pst.pivotmax), js["pivotmax"], rtol=1e-10)
            for f in ("cores", "rowf"):
                np.testing.assert_allclose(getattr(pst, f).numpy(), js[f], rtol=0,
                                           atol=1e-12 * amax, err_msg=f"{seed} {it} {f}")
            pivmin = np.min(np.abs(js["lu_d"]))
            np.testing.assert_allclose(pst.colf.numpy(), js["colf"], rtol=0,
                                       atol=1e-12 * amax / pivmin,
                                       err_msg=f"{seed} {it} colf")


def test_headline_per_sweep_parity():
    """The C_6 headline's rank-30 cross (n = 65, pivoting 1, key 0): from
    each of the JAX engine's 29 pre-sweep states, one port sweep with the
    same uniforms makes the same pivot choices (rk, vip, neval, padded
    exactly; cores to 1e-12 * amax, rounding only).  Whole runs of the two
    packages still part after a few sweeps, because a late residual is
    ~1e-13 * amax and its last bits decide a near-tie; their digits over
    many keys agree in distribution (PERF.md)."""
    jp = jmake_ising("C", 6, 64)
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", 6, jp.truth, "cpu")
    d, N, R = jp.d, jp.n, 30
    se, sp = precision_thresholds(jnp.float64)
    kw = dict(d=d, n=(N,) * d, N=N, R=R, piv=1, small_element=se, small_pivot=sp)
    jkit = jmake_engine(jp.fun, JCrossConfig(**kw))
    pkit = make_engine(tp.fun, CrossConfig(**kw), "cpu")
    jst = jkit.init_fn(jax.random.PRNGKey(0))
    for it in range(1, R):
        _, sub = jax.random.split(jst.key)
        U = np.asarray(jax.random.uniform(sub, (d - 1, 2, 2 * (R + N)), jnp.float64))
        pst = pkit.sweep_fn(state_from_numpy(_np_state(jst), "cpu"), it,
                            torch.from_numpy(U.copy()))
        jst = jkit.sweep_fn(jst, it)
        js = _np_state(jst)
        for f in ("rk", "vip", "neval", "padded"):
            assert np.array_equal(getattr(pst, f).numpy(), js[f]), (it, f)
        np.testing.assert_allclose(pst.cores.numpy(), js["cores"], rtol=0,
                                   atol=1e-12 * js["amax"], err_msg=str(it))
    assert int(js["neval"]) == 182113 and js["rk"].tolist() == [1, 17, 30, 30, 16, 1]


def test_whole_slice_parity(problems):
    """cross() in both packages, oversampled and rounded, the port fed the
    JAX uniforms: ranks, sweeps, n_evals and padded evals equal; the
    per-sweep and rounded values to rtol 1e-11 (f64 rounding through the
    LU chain and the SVD)."""
    jp, tp = problems
    d, N, os_ = jp.d, jp.n, 2
    kw = dict(max_rank=R, pivoting=1, quad=[jp.quad_weights] * d, truth=jp.truth,
              oversample=os_)
    jres = jcross(jp.fun, [N] * d, key=0, **kw)
    U = _jax_uniforms(0, R + os_ - 1, d, 2 * (R + os_ + N))
    pres = _cross(tp.fun, [N] * d, accuracy=None, key=0, dtype=torch.float64,
                verbose=False, return_state=False, max_sweeps=None,
                small_element=None, small_pivot=None, sweep_mode="sequential",
                device="cpu", uniforms=U, **kw)
    assert pres.ranks == jres.ranks
    assert pres.sweeps == jres.sweeps
    assert pres.neval == jres.neval
    assert pres.padded_evals == jres.padded_evals
    assert len(pres.values) == len(jres.values)
    np.testing.assert_allclose(pres.values, jres.values, rtol=1e-11)
    pdig, jdig = -np.log10(pres.errors[-1]), -np.log10(jres.errors[-1])
    assert abs(pdig - jdig) <= 0.2
    assert [h.direction for h in pres.history] == [h.direction for h in jres.history]


def test_public_cross_runs_and_rejects_unported(problems):
    _, tp = problems
    res = cross(tp.fun, [tp.n] * tp.d, max_rank=6, accuracy=1e-10, pivoting=1,
                quad=[tp.quad_weights] * tp.d, truth=tp.truth, key=3,
                use_pallas=True, return_state=True, device="cpu")
    assert res.tt.ready() and res.tt.r == res.ranks and max(res.ranks) <= 6
    assert res.state.cores.device.type == "cpu"
    assert -np.log10(res.errors[-1]) > 4.0
    # ported since: the maxvol post-pass, the weighted lottery, the resume,
    # the host re-evaluation, the pivot shim, and the rank chunks, the caps
    # and the adaptive gate (tests/test_torch_caps.py holds them to JAX)
    kw = dict(max_rank=4, quad=[tp.quad_weights] * tp.d, truth=tp.truth, device="cpu")
    for extra in (dict(rank_chunks=[2, 4]), dict(adaptive=True), dict(rank_caps=[4, 4, 4])):
        assert max(cross(tp.fun, [tp.n] * tp.d, **kw, **extra).ranks) <= 4
    assert cross(tp.fun, [tp.n] * tp.d, host_reeval=True, **kw).history[-1].direction == "hr"
    assert cross(tp.fun, [tp.n] * tp.d, return_pivots=True, **kw).state.vip.shape == (3, 4, 4)
    ref = cross(tp.fun, [tp.n] * tp.d, refine_sweeps=1, **kw)
    assert ref.history[-1].direction == "mv" and ref.tt.ready()
    assert cross(tp.fun, [tp.n] * tp.d, weighted_lottery=True, **kw).tt.ready()
    again = cross(tp.fun, [tp.n] * tp.d, init_state=res.state, max_sweeps=1, **{**kw, "max_rank": 6})
    assert again.sweeps == 1 and again.neval > res.neval


@pytest.mark.parametrize("entry", [
    "cross.cross", "apps.make_ising", "apps.make_mvn", "apps.make_mvn_density",
    "apps.make_mvn_family", "apps.make_stdnorm", "apps.make_cos_coefficients",
    "cross.maxvol_refine", "cross.cross_maxvol", "cross.accchk", "tt.load_ttbin",
    "tt.load_ttbin_ref", "tt.load_npz", "tt.load_hdf5", "tt.load_state", "cross.cross_batch",
    "cross.extract_skeleton", "cross.derive_host_fun", "apps.make_quantics",
    "apps.quantics_cross", "cross.cross_dd", "cross.cross_defect_corrected",
    "apps.make_ising_dd", "apps.make_stdnorm_dd", "parallel.cross_parallel",
    "parallel.cross_dd_parallel", "parallel.maxvol_refine_parallel", "cross.cross_qd",
    "cross.cross_defect_corrected_qd", "apps.make_ising_qd", "apps.make_stdnorm_qd",
    "cross.refine_dd", "parallel.cross_qd_parallel", "drivers.crs_ising_dd.main",
    "drivers.crs_ising_mp.main", "drivers.crs_stdnorm_dd.main", "drivers.crs_ising_qd.main",
    "drivers.crs_ising_qde.main", "drivers.chf_equal.main"])
def test_entry_points_default_to_the_card(entry):
    module, name = entry.rsplit(".", 1)
    entry = getattr(importlib.import_module("ttcross_tpu_torch." + module), name)
    assert inspect.signature(entry).parameters["device"].default == "cuda"


# The mp tier is host code by design, as in the JAX package and the
# reference's MPFUN tier (ttcross_tpu/ops/mp.py:1-17): these take no device.
HOST_ONLY = ("cross.cross_mp", "parallel.cross_mp_parallel", "cross.cross_mp_native",
             "cross.ising_cross_mp_native")


@pytest.mark.parametrize("entry", HOST_ONLY + ("drivers.crs_ising_mpf.main",
                                               "drivers.crs_ising_mpn.main"))
def test_host_only_entry_points_take_no_device(entry):
    module, name = entry.rsplit(".", 1)
    entry = getattr(importlib.import_module("ttcross_tpu_torch." + module), name)
    assert "device" not in inspect.signature(entry).parameters


def test_no_card_and_no_device_raises(problems):
    """Without a card, the default device fails at its first allocation
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        make_ising("C", 5, 17)
    _, tp = problems
    with pytest.raises((RuntimeError, AssertionError)):
        cross(tp.fun, [tp.n] * tp.d, max_rank=4, pivoting=1)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX or
    the JAX package being loaded."""
    import ttcross_tpu_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(ttcross_tpu_torch.__path__,
                                                        "ttcross_tpu_torch."))
    assert "ttcross_tpu_torch.ops.kernels" in mods and len(mods) > 15
    for new in ("apps.mvn", "apps.stdnorm", "apps.cos", "apps.chf", "cross.maxvol", "cross.accchk",
                "ops.sampling", "tt.serialize", "utils.indexing", "utils.guards", "utils.printing",
                "cross.batch", "cross.skeleton", "apps.quantics", "utils.cli", "ops.dd",
                "cross.engine_dd", "cross.defect", "parallel", "parallel.mesh", "parallel.engine",
                "parallel.engine_dd", "parallel.maxvol", "parallel.quad", "parallel.launch",
                "ops.qd", "cross.engine_qd", "cross.hostwalk", "cross.refine", "parallel._hub",
                "parallel.engine_qd", "ops.mp", "cross.engine_mp", "cross.engine_mp_native",
                "parallel.engine_mp", "native", "native._mpfr", "native._gxx", "drivers",
                "drivers.crs_ising_dd", "drivers.crs_ising_mp", "drivers.crs_stdnorm_dd",
                "drivers.crs_ising_qd", "drivers.crs_ising_qde", "drivers.crs_ising_mpf",
                "drivers.crs_ising_mpn", "drivers.chf_equal"):
        assert "ttcross_tpu_torch." + new in mods
    code = ("import sys, importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ttcross_tpu.'))"
            " or m == 'ttcross_tpu']\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
