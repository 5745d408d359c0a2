"""The port's drivers (ttcross_tpu_torch/drivers/) on the CPU.

Each driver's main(argv, device="cpu") runs at a small configuration; its
printed value equals the port's API call with the same arguments, and its
correct digits are at or above the floor of the JAX driver's CPU run at
that configuration (drivers/<name>.py with the same arguments):

    crs_ising_dd 4 17 8 12         13.92      crs_ising_qde 4 17 10 1 1   12.38
    crs_ising_mp 4 17 8            9.79       crs_ising_mpf C 4 17 8 40 1 10.28
    crs_stdnorm_dd 4 65 4          20.96      crs_ising_mpn C 4 17 8 1 60 9.33
    crs_ising_qd 4 17 8 12 2       13.92      chf_equal 3 3               EQUAL

The qd engine and the mp tier give the JAX package's runs exactly, so
their floor is the JAX digits; the dd engine, the defect pipelines and the
f64 cross of crs_stdnorm_dd draw their lotteries from the port's own
streams (the JAX package's are its key draws), so theirs sits 0.5 below."""

import io
import subprocess
import sys
from contextlib import redirect_stdout
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest

from ttcross_tpu_torch import drivers
from ttcross_tpu_torch.drivers import (chf_equal, crs_ising_dd, crs_ising_mp, crs_ising_mpf,
                                       crs_ising_mpn, crs_ising_qd, crs_ising_qde, crs_stdnorm_dd)
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

JAX_DIGITS = {"crs_ising_dd": 13.92, "crs_ising_mp": 9.79, "crs_stdnorm_dd": 20.96,
              "crs_ising_qd": 13.92, "crs_ising_qde": 12.38, "crs_ising_mpf": 10.28,
              "crs_ising_mpn": 9.33}
LOTTERY_MARGIN = {"crs_ising_dd": 0.5, "crs_ising_mp": 0.5, "crs_stdnorm_dd": 0.5,
                  "crs_ising_qd": 0.5}


def run(mod, argv, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = mod.main(argv, **kw)
    out = buf.getvalue()
    assert rc == 0, out
    assert out.rstrip().endswith("Good bye."), out
    return out


def field(out, label):
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return line[len(label):].strip()


def digits(out):
    return float(field(out, "correct digits:").split()[0])


def held(name, out):
    floor = JAX_DIGITS[name] - LOTTERY_MARGIN.get(name, 0.0)
    assert digits(out) >= floor, (name, digits(out), floor)


def dd_value(hi, lo):
    with localcontext() as ctx:
        ctx.prec = 60
        return Decimal(hi) + Decimal(lo)


def test_the_drivers_package_lists_its_drivers():
    import importlib

    jax_drivers = Path(__file__).resolve().parent.parent / "drivers"
    assert len(drivers.DRIVERS) == 8
    for name in drivers.DRIVERS:
        mod = importlib.import_module(f"ttcross_tpu_torch.drivers.{name}")
        assert callable(mod.main) and (jax_drivers / f"{name}.py").is_file()


def test_crs_ising_dd():
    from ttcross_tpu_torch.apps import make_ising_dd
    from ttcross_tpu_torch.cross import cross_defect_corrected

    out = run(crs_ising_dd, ["4", "17", "8", "12"], device="cpu")
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device="cpu")
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * prob.d, wh, wl,
                                          max_rank=8, max_rank2=12, device="cpu")
    assert Decimal(field(out, "computed value:")) == dd_value(hi, lo)
    assert f"{info['neval1']} + {info['neval2']}" in out
    held("crs_ising_dd", out)


def test_crs_ising_mp_is_the_dd_engine():
    from ttcross_tpu_torch.apps import make_ising_dd
    from ttcross_tpu_torch.cross import cross_dd

    out = run(crs_ising_mp, ["4", "17", "8"], device="cpu")
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device="cpu")
    res = cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8, pivoting=1, device="cpu")
    assert Decimal(field(out, "computed value:")) == dd_value(*res.value)
    assert f"...with {res.neval} dd evaluations, ranks {res.ranks}" in out
    held("crs_ising_mp", out)


def test_crs_stdnorm_dd():
    import torch

    from ttcross_tpu_torch.apps import make_stdnorm
    from ttcross_tpu_torch.apps.stdnorm import StdnormDD
    from ttcross_tpu_torch.cross import cross, refine_dd
    from ttcross_tpu_torch.ops.dd import DD, dd, dd_mul
    from ttcross_tpu_torch.ops.quadrature import gauss_legendre_dd

    out = run(crs_stdnorm_dd, ["4", "64", "4"], device="cpu")     # an even n becomes 65
    (xh, xl), (wh, wl) = gauss_legendre_dd(65)
    X = dd_mul(DD(torch.from_numpy(xh), torch.from_numpy(xl)), dd(8.5))
    W = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), dd(8.5))
    prob = make_stdnorm(d=4, n=65, a=-8.5, b=8.5, device="cpu")
    res = cross(prob.fun, [65] * 4, max_rank=4, pivoting=1, accuracy=25e-16, return_state=True,
                device="cpu")
    hi, lo, nev = refine_dd(res.state, [65] * 4, StdnormDD(X, "cpu"), [W.hi.numpy()] * 4,
                            [W.lo.numpy()] * 4, device="cpu")
    assert Decimal(field(out, "refined value :")) == dd_value(hi, lo)
    assert f"(+{nev} extended-precision evals)" in out
    held("crs_stdnorm_dd", out)


def test_crs_ising_qd():
    from ttcross_tpu_torch.apps import make_ising_qd
    from ttcross_tpu_torch.cross import cross_defect_corrected_qd
    from ttcross_tpu_torch.ops.qd import qd_to_mp

    out = run(crs_ising_qd, ["4", "17", "8", "12", "2"], device="cpu")
    prob, fun_qd, wq = make_ising_qd(m=4, n=17, device="cpu")
    limbs, info = cross_defect_corrected_qd(prob.fun, fun_qd, [prob.n] * prob.d, wq, max_rank=8,
                                            max_rank2=12, levels=2, device="cpu")
    got = qd_to_mp(*(float(e) for e in limbs))
    with localcontext() as ctx:
        ctx.prec = 60
        assert field(out, "computed value:") == str(+got)
    held("crs_ising_qd", out)


@pytest.mark.parametrize("workers", [1, 2])
def test_crs_ising_qde(workers):
    """The qd engine, and with WORKERS = 2 the spawned workers: the same
    limbs as the API call, the JAX driver's digits exactly (one worker)."""
    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
    from ttcross_tpu_torch.cross import cross_qd
    from ttcross_tpu_torch.ops.qd import qd_to_string
    from ttcross_tpu_torch.parallel import cross_qd_parallel

    args = ["4", "17", "10", "1", str(workers)] if workers == 1 else ["4", "9", "6", "1", "2"]
    out = run(crs_ising_qde, args, device="cpu")
    m, n, rank = 4, int(args[1]), int(args[2])
    prob, fun_qd, wq = make_ising_qd(m=m, n=n, device="cpu")
    kw = dict(max_rank=rank, pivoting=1, quad=wq, truth=ISING_C_STR[m], device="cpu")
    res = (cross_qd(fun_qd, [prob.n] * prob.d, **kw) if workers == 1
           else cross_qd_parallel(fun_qd, [prob.n] * prob.d, n_workers=2, **kw))
    assert field(out, "computed value:") == qd_to_string(res.value, 65)
    assert f"...with {res.neval} qd evaluations, ranks {res.ranks}" in out
    if workers == 1:
        held("crs_ising_qde", out)


@pytest.mark.parametrize("workers", [1, 2])
def test_crs_ising_mpf(workers):
    from mpmath import mp

    from ttcross_tpu_torch.apps import make_ising_mp
    from ttcross_tpu_torch.cross import cross_mp
    from ttcross_tpu_torch.ops.mp import workdps
    from ttcross_tpu_torch.parallel import cross_mp_parallel

    out = run(crs_ising_mpf, ["C", "4", "17", "8", "40", str(workers)])
    d, n, f, q, t = make_ising_mp("C", m=4, n=17, dps=40)
    kw = dict(max_rank=8, pivoting=1, quad=q, truth=t, dps=40)
    res = (cross_mp(f, [n] * d, **kw) if workers == 1
           else cross_mp_parallel(f, [n] * d, n_workers=2, **kw))
    with workdps(40):
        assert field(out, "computed value:") == mp.nstr(res.value, 40)
    assert f"...with {res.neval} mp evaluations, ranks {res.ranks}" in out
    if workers == 1:
        held("crs_ising_mpf", out)


def test_crs_ising_mpn():
    from ttcross_tpu_torch import native
    from ttcross_tpu_torch.cross import ising_cross_mp_native

    if not native.mpfr_available():
        pytest.skip("libmpfr/g++ unavailable")
    out = run(crs_ising_mpn, ["C", "4", "17", "8", "1", "60"])
    res = ising_cross_mp_native("C", m=4, n=17, max_rank=8, pivoting=1, dps=60)
    assert field(out, "computed value:") == res.value_str[:60 // 2 + 8]
    held("crs_ising_mpn", out)


def test_chf_equal():
    from ttcross_tpu_torch import native

    if not native.available():
        pytest.skip("g++ / libquadmath unavailable")
    out = io.StringIO()
    with redirect_stdout(out):
        assert chf_equal.main(["3", "3"], device="cpu") == 0
    assert "compared 27 CHF values" in out.getvalue() and "EQUAL" in out.getvalue()


def test_python_dash_m_entry_point():
    """`python -m ttcross_tpu_torch.drivers.<name> ARGS` from the checkout."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-m", "ttcross_tpu_torch.drivers.crs_ising_mpf", "C",
                           "3", "9", "4", "30"], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "correct digits" in proc.stdout and np.isfinite(digits(proc.stdout))
