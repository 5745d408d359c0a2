"""The port's f64 cross drivers (ttcross_tpu_torch/drivers/) on the CPU:
crs_ising (with the rescaled D path at m = 10), crs_stdnorm, crs_mvn,
crs_batch, crs_greeks and crs_quantics.

Each driver's main(argv, device="cpu") runs at a small configuration; its
printed value equals the port's API call with the same arguments bit for
bit, and its correct digits are at or above the JAX driver's CPU run at
those arguments (drivers/<name>.py, whose cross draws key 0) less a
lottery margin.  The two packages draw their lottery uniforms from
different streams, so the margin is set from both packages' spreads over
keys 0-7 at the same arguments (port / JAX package; CPU runs):

    crs_ising c 3 33 6 1      JAX key 0: 9.70   keys 0-7: 8.61-9.82 / 8.49-9.97
    crs_stdnorm 4 33 4 1      3.83 (the 33-point rule's own error; rank 1,
                              no lottery: every key of both packages)
    crs_mvn 4 33 16 1         JAX key 0: 5.71   keys 0-7: 5.67-7.71 / 5.27-7.45
    crs_batch 4 17 8 2        JAX lanes 1.67 / 0.49 (the 17-point rule limits
                              lane 0; lane 1, corr 0.7, is the lottery's)
    crs_quantics 12 8 1 1     JAX 14.75 (port 15.35)

so the floor sits under both packages' minima over keys 0-7: c 3 at
9.70 - 1.3, mvn at 5.71 - 0.5, batch lane 1 at 0.49 - 0.2.

crs_ising D 10 17 8 1 runs the rescaled D / E path (make_ising scales the
weights by 5 (n // 2) at m >= 10, test_crs_ising.f90:135-144).  D_10 has no
truth, so it prints no digits.  The JAX driver gives 7.34923491398257e-07
after 7 sweeps, 10,383 evaluations and a last cnv of 3.0e-7.  Over keys
0-31 the port's values lie -2.6e-7 to +7.8e-7 relative from it and the JAX
package's -9.7e-8 to +5.2e-7: every key of each package is within
D10_RTOL = 1e-6 of the JAX driver's value.  The last sweep's cnv is a
lottery variable with the same law in both packages over keys 0-31: port
median 4.6e-7, largest 1.83e-6; JAX median 5.3e-7, largest 1.82e-6; 7 of
32 keys above 1e-6 in each (the port's key 0: 1.39e-6).  The bound
D10_CNV = 2e-6 lies above both packages' largest."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ttcross_tpu_torch.drivers import (crs_batch, crs_greeks, crs_ising, crs_mvn, crs_quantics,
                                       crs_stdnorm)
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

ACC = 500 * np.finfo(np.float64).eps
JAX_DIGITS = {"crs_ising c 3": 9.70, "crs_stdnorm": 3.83, "crs_mvn": 5.71, "crs_quantics": 14.75}
LOTTERY_MARGIN = {"crs_ising c 3": 1.3, "crs_stdnorm": 0.0, "crs_mvn": 0.5, "crs_quantics": 0.5}
JAX_D10_VALUE = 7.34923491398257e-07
D10_RTOL = 1e-6
D10_CNV = 2e-6
JAX_BATCH_DIGITS, BATCH_MARGIN = (1.67, 0.49), 0.2
GREEK_FD_RTOL = 1e-6


def run(mod, argv, end="Good bye."):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = mod.main(argv, device="cpu")
    out = buf.getvalue()
    assert rc == 0, out
    assert end is None or out.rstrip().endswith(end), out
    return out


def field(out, label):
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return line[len(label):].strip()


def held(name, out):
    digits = float(field(out, "correct digits:"))
    floor = JAX_DIGITS[name] - LOTTERY_MARGIN[name]
    assert digits >= floor, (name, digits, floor)


def test_crs_ising_c():
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    out = run(crs_ising, ["c", "3", "33", "6", "1"])
    p = make_ising("C", 3, 33, device="cpu")
    res = cross(p.fun, [p.n] * p.d, max_rank=6, accuracy=ACC, pivoting=1,
                quad=[p.quad_weights] * p.d, truth=p.truth, device="cpu")
    assert float(field(out, "computed value:")) == res.values[-1]
    assert float(field(out, "analytic value:")) == p.truth
    assert f"...with {res.neval} evaluations" in out
    assert out.count(" n_evals:") == res.sweeps          # the per-sweep lines (verbose)
    held("crs_ising c 3", out)


def test_crs_ising_d10_runs_the_rescaled_path():
    """D_10: the weights rescaled against underflow, no truth and so no
    digits; the value within D10_RTOL of the JAX driver's, the last
    sweep's cnv under D10_CNV."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    out = run(crs_ising, ["D", "10", "17", "8", "1"])
    p = make_ising("D", 10, 17, device="cpu")
    assert p.rescale and p.truth is None and np.all(p.quad_weights == 1.0 / (5.0 * (17 // 2)))
    res = cross(p.fun, [p.n] * p.d, max_rank=8, accuracy=ACC, pivoting=1,
                quad=[p.quad_weights] * p.d, device="cpu")
    val = float(field(out, "computed value:"))
    assert val == res.values[-1]
    assert "correct digits" not in out and "analytic value" not in out
    assert abs(val / JAX_D10_VALUE - 1) <= D10_RTOL, val
    assert res.history[-1].cnv <= D10_CNV and res.sweeps == 7 and res.neval == 10383
    last_sweep = [ln for ln in out.splitlines() if " n_evals:" in ln][-1]
    assert f"cnv {res.history[-1].cnv:9.3e}" in last_sweep


def test_crs_stdnorm():
    from ttcross_tpu_torch.apps import make_stdnorm
    from ttcross_tpu_torch.cross import cross

    out = run(crs_stdnorm, ["4", "33", "4", "1"])
    p = make_stdnorm(d=4, n=33, device="cpu")
    res = cross(p.fun, [p.n] * 4, max_rank=4, accuracy=5 * np.finfo(np.float64).eps, pivoting=1,
                quad=[p.quad_weights] * 4, truth=p.truth, device="cpu")
    assert float(field(out, "computed value:")) == res.values[-1]
    held("crs_stdnorm", out)


def test_crs_mvn_prints_the_density():
    from ttcross_tpu_torch.apps import make_mvn
    from ttcross_tpu_torch.cross import cross

    out = run(crs_mvn, ["4", "33", "16", "1"])
    p = make_mvn(d=4, n=33, device="cpu")
    res = cross(p.fun, [p.n] * 4, max_rank=16, accuracy=ACC, pivoting=1,
                quad=[p.quad_weights] * 4, truth=1.0, device="cpu")
    assert float(field(out, "computed value:")) == res.values[-1]
    assert "Mean vector (mu):\n" + str(p.density.mu) in out
    assert "Covariance matrix:\n" + str(p.density.cov) in out
    held("crs_mvn", out)
    wide = run(crs_mvn, ["10", "5", "2", "1"])        # d >= 10: no mu / cov
    assert "Mean vector" not in wide


@pytest.mark.parametrize("compare", ["0", "1"])
def test_crs_batch_lanes_are_the_cross_batch(compare):
    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.cross import cross_batch

    out = run(crs_batch, ["4", "17", "8", "2", compare])
    corrs = np.linspace(0.2, 0.7, 2)
    fam = make_mvn_family(d=4, n=17, corrs=corrs, device="cpu")
    res = cross_batch(fam.fun, [fam.n] * 4, fam.params, max_rank=8, accuracy=ACC, pivoting=1,
                      quad=[fam.quad_weights] * 4, truth=1.0, device="cpu")
    assert f"family: 2 lanes, {res.neval} evaluations" in out
    for lane, r in enumerate(res):
        digits = -np.log10(abs(1.0 - r.values[-1]))
        line = (f"  corr {corrs[lane]:.3f}: value {r.values[-1]:.12e} "
                f"correct digits {digits:6.2f} ranks {r.ranks}")
        assert line in out.splitlines()
        assert digits >= JAX_BATCH_DIGITS[lane] - BATCH_MARGIN, (lane, digits)
    assert ("family speedup" in out) == (compare == "1")


def test_crs_greeks_grad_is_its_central_difference():
    from ttcross_tpu_torch.apps.mvn import MVN_BOX
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops.quadrature import lgwt, map_to_interval

    out = run(crs_greeks, ["4", "17", "6", "3"], end=None)
    x, w = map_to_interval(*lgwt(17), *MVN_BOX)
    fun = crs_greeks.mvn_rho_fun(torch.from_numpy(x), 4)
    rho = torch.tensor(0.5, dtype=torch.float64)
    res = cross(lambda i: fun(i, rho), [17] * 4, max_rank=6, accuracy=ACC, pivoting=1,
                quad=[w] * 4, truth=1.0, key=5, device="cpu")
    line = field(out, "mass(0.5) =")
    assert f"(cross value {res.values[-1]:.12e}," in line
    mass, cross_value = float(line.split()[0]), float(line.split("cross value")[1].split(",")[0])
    assert abs(mass / cross_value - 1) < 1e-10
    g, fd = (float(v) for v in field(out, "d mass / d rho =").split("central-FD check"))
    assert abs(g - fd) <= GREEK_FD_RTOL * abs(g), (g, fd)
    sweep = [ln for ln in out.splitlines() if ln.startswith("  rho ")]
    assert len(sweep) == 3 and sweep[1].startswith("  rho 0.500: mass ")
    assert float(sweep[1].split("mass")[1].split()[0]) == pytest.approx(mass, rel=1e-9)


def test_crs_quantics():
    from ttcross_tpu_torch.apps import quantics_cross

    out = run(crs_quantics, ["12", "8", "1", "1"])

    def f(x):
        return torch.exp(x) * torch.sin(6 * np.pi * x)

    _, res = quantics_cross(f, 12, max_rank=8, pivoting=1, accuracy=1e-13, refine_sweeps=1,
                            device="cpu")
    assert field(out, "computed value:") == f"{res.values[-1]:.15e}"
    assert field(out, "TT ranks:") == str(res.ranks)
    held("crs_quantics", out)
    assert float(field(out, "max point-eval error on the 64-point dyadic probe:")) < 1e-12
