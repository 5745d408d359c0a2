"""The port's f32 tier against the JAX package's.

The JAX package runs its f32 tier under TTCROSS_NO_X64=1 (a process-wide
switch, ttcross_tpu/config.py:17-18), so its runs happen in one subprocess,
as tests/test_f32_tier.py runs them, and come back as numpy: the Ising C_5
cross (n = 32, rank 12, rook, accuracy 1e-6) with its lottery uniforms
(f32 draws under no-x64) and the tt-gather toy of test_f32_tier.py.  The
port runs the same crosses with cross(dtype=torch.float32) on those
uniforms.

Tolerances.  The toy's values are exact products of f32 cores: every pick,
rank and count is equal, the trains within 1e-5 of each other.  On C_5 the
integrand rounds in f32 in another order than the JAX package's (~1e-7
relative), so picks whose residuals are within a few f32 ulps of each
other may go either way: the first 8 sweeps are equal pivot for pivot
(values to 2e-6), the later ones accept pivots near 1e-6 amax, where the
residuals' f32 rounding decides; the whole run's value is within 5e-6 of
the JAX package's and its n_evals within 2 %, and both reach >= 6 digits
against Bailey's C_5."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch import tt as ptt
from ttcross_tpu_torch.apps import make_ising, make_mvn, make_stdnorm
from ttcross_tpu_torch.cross import cross, cross_batch
from ttcross_tpu_torch.cross.engine import _cross
from ttcross_tpu_torch.ops import kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C5 = dict(max_rank=12, pivoting=1, accuracy=1e-6)
EARLY = 8           # sweeps of C_5 held pivot for pivot

JAX_F32 = textwrap.dedent("""
    import os, sys
    os.environ["TTCROSS_NO_X64"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ttcross_tpu
    import jax.numpy as jnp
    assert jnp.asarray(1.0).dtype == jnp.float32
    import ttcross_tpu.tt as tt
    from ttcross_tpu.apps import make_ising
    from ttcross_tpu.cross import cross

    def uniforms(key, sweeps, d, nlot):
        k, us = jax.random.PRNGKey(key), []
        for _ in range(sweeps):
            k, sub = jax.random.split(k)
            us.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float32)))
        return np.stack(us)

    out = {}
    p = make_ising("C", 5, 32)
    kw = dict(max_rank=12, pivoting=1, accuracy=1e-6, quad=[p.quad_weights] * p.d,
              truth=p.truth, dtype=jnp.float32, key=0, return_state=True)
    for tag, ms in (("early", %(early)d), ("whole", None)):
        r = cross(p.fun, [p.n] * p.d, max_sweeps=ms, **kw)
        out[tag + "_vip"] = np.asarray(r.state.vip)
        out[tag + "_meta"] = np.array([r.neval, r.padded_evals, r.sweeps] + list(r.ranks))
        out[tag + "_values"] = np.asarray(r.values, np.float64)
        out[tag + "_amax"] = np.asarray(r.state.amax, np.float64)
    out["U"] = uniforms(0, 11, p.d, 2 * (12 + p.n))

    rng = np.random.default_rng(0)
    cores = [rng.standard_normal((r1, 7, r2)).astype(np.float32)
             for (r1, r2) in [(1, 2), (2, 2), (2, 1)]]
    T = tt.from_cores(cores)
    res = cross(lambda ind: tt.gather(T, ind), [7] * 3, max_rank=4, pivoting=1,
                accuracy=1e-5, dtype=jnp.float32, return_state=True)
    out["toy_U"] = uniforms(0, res.sweeps, 3, 2 * (4 + 7))
    out["toy_vip"] = np.asarray(res.state.vip)
    out["toy_meta"] = np.array([res.neval, res.padded_evals, res.sweeps] + list(res.ranks))
    out["toy_full"] = np.asarray(tt.full(res.tt))
    for i, c in enumerate(cores):
        out["core%%d" %% i] = c
    np.savez(sys.argv[1], **out)
    print("JAXF32OK")
""") % {"early": EARLY}


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f32") / "jax_f32.npz")
    env = dict(os.environ, TTCROSS_NO_X64="1", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", JAX_F32, path], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0 and "JAXF32OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


def _port_c5(z, max_sweeps=None):
    p = make_ising("C", 5, 32, device="cpu", dtype=torch.float32)
    U = z["U"][:max_sweeps] if max_sweeps else z["U"]
    return p, _cross(p.fun, [p.n] * p.d, quad=[p.quad_weights] * p.d, truth=p.truth, key=0,
                     dtype=torch.float32, verbose=False, return_state=True,
                     max_sweeps=max_sweeps, small_element=None, small_pivot=None,
                     oversample=0, sweep_mode="sequential", device="cpu", uniforms=U, **C5)


def test_toy_matches_jax_f32(jax_f32):
    z = jax_f32
    T = ptt.from_cores([torch.from_numpy(z[f"core{i}"]) for i in range(3)], device="cpu")
    res = _cross(lambda ind: ptt.gather(T, ind), [7] * 3, max_rank=4, pivoting=1,
                 accuracy=1e-5, quad=None, truth=None, key=0, dtype=torch.float32,
                 verbose=False, return_state=True, max_sweeps=None, small_element=None,
                 small_pivot=None, oversample=0, sweep_mode="sequential", device="cpu",
                 uniforms=z["toy_U"])
    assert [res.neval, res.padded_evals, res.sweeps, *res.ranks] == z["toy_meta"].tolist()
    assert np.array_equal(res.state.vip.numpy(), z["toy_vip"])
    assert res.tt.dtype == torch.float32
    np.testing.assert_allclose(ptt.full(res.tt).numpy(), z["toy_full"], rtol=0, atol=1e-5)
    dense = ptt.full(T).numpy()
    assert np.abs(ptt.full(res.tt).numpy() - dense).max() < 1e-4     # f32-level recovery


def test_c5_f32_first_sweeps_pivot_for_pivot(jax_f32):
    z = jax_f32
    _, res = _port_c5(z, EARLY)
    assert [res.neval, res.padded_evals, res.sweeps, *res.ranks] == z["early_meta"].tolist()
    assert np.array_equal(res.state.vip.numpy(), z["early_vip"])
    assert res.state.cores.dtype == torch.float32
    np.testing.assert_allclose(res.values, z["early_values"], rtol=2e-6)


def test_c5_f32_whole_run_within_the_f32_tolerance(jax_f32):
    z = jax_f32
    p, res = _port_c5(z)
    jmeta = z["whole_meta"]
    assert res.sweeps == jmeta[2] and res.padded_evals == jmeta[1]
    assert abs(res.neval - jmeta[0]) <= 0.02 * jmeta[0]
    assert abs(res.values[-1] / z["whole_values"][-1] - 1) < 5e-6
    for v in (res.values[-1], z["whole_values"][-1]):
        assert -np.log10(abs(1 - v / p.truth)) >= 6.0


def test_f32_plain_kernels_round_in_f32():
    """On CPU tensors the kernels' plain versions run in the inputs' dtype:
    f32 in, f32 out, within f32 rounding of the f64 results."""
    g = torch.Generator().manual_seed(0)
    vals, colf, rowf = (torch.randn(s, generator=g, dtype=torch.float64)
                        for s in ((300, 1), (300, 12), (12, 1)))
    mask = torch.rand((300, 1), generator=g) > 0.2
    i64, s64, r64 = K.score_residual_argmax(vals, colf, rowf, mask)
    i32, s32, r32 = K.score_residual_argmax(vals.float(), colf.float(), rowf.float(), mask)
    assert s32.dtype == r32.dtype == torch.float32 and int(i32) == int(i64)
    assert abs(float(r32) - float(r64)) < 1e-5 * abs(float(r64))
    tables = torch.rand((2, 33), generator=g, dtype=torch.float64)
    ind = torch.randint(-2, 35, (50, 5), generator=g, dtype=torch.int32)
    assert torch.equal(K.small_table_lookup(tables.float(), ind),
                       K.small_table_lookup(tables, ind).float())
    p64 = make_ising("C", 6, 32, device="cpu")
    p32 = make_ising("C", 6, 32, device="cpu", dtype=torch.float32)
    ind = torch.randint(0, p64.n, (200, p64.d), generator=g, dtype=torch.int32)
    f32, f64 = p32.fun(ind), p64.fun(ind)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), rtol=2e-6)


@pytest.mark.parametrize("extra", [dict(rank_chunks="auto"), dict(rank_caps=[7, 12, 7]),
                                   dict(adaptive=True), dict(oversample=2),
                                   dict(sweep_mode="jacobi-rb", chain=True),
                                   dict(refine_sweeps=1), dict(pivoting=-1)])
def test_f32_tier_runs_every_path(extra):
    """Every path of cross() in f32: the train and the values in f32, and
    f32-level digits on C_5."""
    p = make_ising("C", 5, 32, device="cpu", dtype=torch.float32)
    kw = {**C5, **extra}
    if kw.get("chain"):
        kw["chain"] = p.chain
    res = cross(p.fun, [p.n] * p.d, quad=[p.quad_weights] * p.d, truth=p.truth,
                dtype=torch.float32, device="cpu", **kw)
    assert res.tt.dtype == torch.float32 and max(res.ranks) <= 12
    assert -np.log10(res.errors[-1]) > 5.0


def test_f32_makers_and_cross_batch():
    """make_mvn / make_stdnorm in f32: the integrands within f32 rounding
    of the f64 ones, the rank-8 d = 4 MVN cross in f32 as accurate as its
    33-point rule lets the f64 one be (~2 digits of the mass), and a
    cross_batch in f32."""
    ind = torch.randint(0, 33, (500, 4), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32)
    m32, m64 = (make_mvn(d=4, n=33, device="cpu", dtype=dt) for dt in (torch.float32,
                                                                      torch.float64))
    np.testing.assert_allclose(m32.fun(ind).numpy(), m64.fun(ind).numpy(), rtol=2e-5,
                               atol=1e-6 * float(m64.fun(ind).abs().max()))
    res = cross(m32.fun, [m32.n] * m32.d, max_rank=8, quad=[m32.quad_weights] * m32.d,
                truth=1.0, dtype=torch.float32, device="cpu")
    assert res.tt.dtype == torch.float32 and -np.log10(res.errors[-1]) > 1.8
    s = make_stdnorm(d=4, n=17, device="cpu", dtype=torch.float32)
    assert s.fun(torch.zeros((3, 4), dtype=torch.int32)).dtype == torch.float32
    params = {"shift": torch.tensor([[0.0], [1e-3]], dtype=torch.float32)}
    br = cross_batch(lambda ind, par: s.fun(ind) + par["shift"][0], [s.n] * s.d, params,
                     max_rank=4, quad=[s.quad_weights] * s.d, dtype=torch.float32,
                     device="cpu")
    assert all(r.tt.dtype == torch.float32 for r in br)
    with pytest.raises(ValueError, match="float32"):
        cross(s.fun, [s.n] * s.d, max_rank=4, dtype=torch.float16, device="cpu")


F32_RUNS = {   # the f32 runs of chip_smoke.py's f32 phase
    "C_6": dict(maker="ising", max_rank=24, pivoting=1, accuracy=1e-6),
    "mvn_d6": dict(maker="mvn", max_rank=20, pivoting=1, accuracy=1e-6),
}

JAX_F32_DIGITS = textwrap.dedent("""
    import os, sys, json
    os.environ["TTCROSS_NO_X64"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ttcross_tpu
    import jax.numpy as jnp
    from ttcross_tpu.apps import make_ising, make_mvn
    from ttcross_tpu.cross import cross
    runs, keys = json.loads(sys.argv[1]), int(sys.argv[2])
    out = {}
    for name, r in runs.items():
        p = make_ising("C", 6, 64) if r["maker"] == "ising" else make_mvn(d=6, n=65)
        truth = p.truth if r["maker"] == "ising" else 1.0
        digits = []
        for key in range(keys):
            res = cross(p.fun, [p.n] * p.d, max_rank=r["max_rank"], pivoting=r["pivoting"],
                        accuracy=r["accuracy"], quad=[p.quad_weights] * p.d, truth=truth,
                        dtype=jnp.float32, key=key)
            digits.append(float(-np.log10(abs(1 - float(res.values[-1]) / truth))))
        out[name] = digits
    print(json.dumps(out))
""")


def f32_digits(keys=range(8)):
    """Both packages' f32 digits over keys 0-7 for chip_smoke.py's f32 runs
    (C_6 n = 64 rank 24, mvn_d6 n = 65 rank 20, rook, accuracy 1e-6), on
    the CPU: the port with its own uniforms, the JAX package in a
    TTCROSS_NO_X64=1 subprocess (values taken to f64 before the error)."""
    import json

    env = dict(os.environ, TTCROSS_NO_X64="1", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", JAX_F32_DIGITS, json.dumps(F32_RUNS),
                          str(len(keys))], capture_output=True, text=True, env=env, cwd=ROOT)
    jax_digits = json.loads(out.stdout.strip().splitlines()[-1])
    for name, r in F32_RUNS.items():
        if r["maker"] == "ising":
            p, truth = make_ising("C", 6, 64, device="cpu", dtype=torch.float32), None
        else:
            p, truth = make_mvn(d=6, n=65, device="cpu", dtype=torch.float32), 1.0
        truth = p.truth if truth is None else truth
        port = []
        for key in keys:
            res = cross(p.fun, [p.n] * p.d, max_rank=r["max_rank"], pivoting=r["pivoting"],
                        accuracy=r["accuracy"], quad=[p.quad_weights] * p.d, truth=truth,
                        dtype=torch.float32, key=key, device="cpu")
            port.append(float(-np.log10(res.errors[-1])))
        for who, dg in (("port", port), ("JAX", jax_digits[name])):
            print(f"{name} f32 {who}: min {min(dg):.2f} median {np.median(dg):.2f} "
                  f"max {max(dg):.2f} by key {[round(x, 2) for x in dg]}")


if __name__ == "__main__":
    f32_digits()
