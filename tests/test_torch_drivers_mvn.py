"""The port's MVN / COS drivers (ttcross_tpu_torch/drivers/) on the CPU:
crs_mvn_complex, crs_chf (also under TTCROSS_MESH=2 on two gloo ranks),
crs_pdf, crs_store, crs_coscoeff and print_cos_coeff.

Each driver's main(argv, device="cpu") runs at d = 4 (drivers that write
out/ in a temporary working directory); what it prints or writes equals
the port's API calls with the same arguments bit for bit, and its correct
digits are at or above the JAX driver's CPU run at those arguments less a
lottery margin.  At 4 33 16 1 the JAX drivers give 5.71 digits
(crs_mvn_complex's complex contraction; crs_chf's phi_0, the mass); over
keys 0-7 the MVN mass at these arguments has 5.67-7.71 digits in the port
and 5.27-7.45 in the JAX package (tests/test_torch_drivers_f64.py), so the
floor is 5.71 - 0.5, under both minima."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ttcross_tpu_torch.drivers import (crs_chf, crs_coscoeff, crs_mvn_complex, crs_pdf, crs_store,
                                       print_cos_coeff)
from ttcross_tpu_torch.parallel import spawn_ranks
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

ACC = 500 * np.finfo(np.float64).eps
ARGS = ["4", "33", "16", "1"]
JAX_DIGITS, LOTTERY_MARGIN = 5.71, 0.5
MESH_ATOL = 1e-13


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


def fields(out, label):
    return [ln[len(label):].strip() for ln in out.splitlines() if ln.startswith(label)]


@pytest.fixture(scope="module")
def mvn_run():
    """The cross that the drivers run at ARGS (no quadrature: their cross()
    passes none), through the API."""
    from ttcross_tpu_torch.apps import make_mvn
    from ttcross_tpu_torch.cross import cross

    p = make_mvn(d=4, n=33, device="cpu")
    return p, cross(p.fun, [p.n] * 4, max_rank=16, accuracy=ACC, pivoting=1, device="cpu")


def same_train(a, b):
    return a.r == b.r and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.cores, b.cores))


def test_crs_mvn_complex(mvn_run):
    from ttcross_tpu_torch.tt import contract

    p, res = mvn_run
    out = run(crs_mvn_complex, ARGS)
    val = complex(contract(res.tt, [p.quad_weights.astype(np.complex128)] * 4))
    re, im = (float(v) for v in field(out, "computed value:").split())
    assert (re, im) == (val.real, val.imag) and im == 0.0
    assert f"...with {res.neval} evaluations" in out
    assert float(field(out, "correct digits:")) >= JAX_DIGITS - LOTTERY_MARGIN


def _chf_values(out):
    return np.array([complex(*(float(v) for v in s.split()))
                     for s in fields(out, "computed value:")])


def test_crs_chf(mvn_run):
    from ttcross_tpu_torch.apps import basket_chf

    p, res = mvn_run
    out = run(crs_chf, ARGS)
    phis = _chf_values(out)
    want = basket_chf(res.tt, p.nodes, p.quad_weights, 32).numpy()
    assert len(phis) == 32 and np.array_equal(phis, want)
    assert "golden" not in out                     # the goldens are d = 6 values
    assert -np.log10(abs(1 - phis[0].real)) >= JAX_DIGITS - LOTTERY_MARGIN
    assert field(out, "phi_0 (mass) =").startswith(f"{want[0].real:.8f}")


def test_crs_chf_d6_prints_the_goldens():
    from ttcross_tpu_torch.apps import CHF_RHO05

    out = run(crs_chf, ["6", "17", "6", "1"])
    golden = fields(out, "golden  value:")
    assert len(golden) == 32 and len(fields(out, "agreement digits:")) == 32
    assert [complex(*(float(v) for v in g.split())) for g in golden] == [
        complex(float(f"{c.real:.16e}"), float(f"{c.imag:.16e}")) for c in CHF_RHO05[:32]]


def _chf_rank(argv):
    """One rank of crs_chf under TTCROSS_MESH: a mesh size that is not the
    group's raises, the group's size runs; returns (rc, rank 0's output or
    this rank's, which must be empty)."""
    from ttcross_tpu_torch.drivers import crs_chf as drv

    os.environ["TTCROSS_MESH"] = "3"
    try:
        drv.main(argv, device="cpu")
        raise AssertionError("TTCROSS_MESH=3 ran on a group of 2")
    except RuntimeError as e:
        assert "TTCROSS_MESH=3" in str(e)
    os.environ["TTCROSS_MESH"] = "2"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = drv.main(argv, device="cpu")
    return rc, buf.getvalue()


def test_crs_chf_on_a_mesh_of_two_ranks():
    """TTCROSS_MESH=2 on two gloo ranks (spawn_ranks in place of torchrun):
    rank 0 prints the meshless run's 32 coefficients to MESH_ATOL (the
    pcontract fold sums in another order), rank 1 prints nothing."""
    outs = spawn_ranks(_chf_rank, 2, args=(ARGS,), timeout=240)
    (rc0, out0), (rc1, out1) = outs
    assert rc0 == rc1 == 0 and out1 == "" and out0.rstrip().endswith("Good bye.")
    meshless = _chf_values(run(crs_chf, ARGS))
    assert np.abs(_chf_values(out0) - meshless).max() <= MESH_ATOL


def _pdf_lines(tt, p):
    from ttcross_tpu_torch.apps import basket_pdf

    xs = np.linspace(0.0, 300.0, 200)
    pdf = basket_pdf(tt, p.nodes, p.quad_weights, xs, n_terms=32).numpy()
    return [f"{x:.10e} {y:.10e}" for x, y in zip(xs, pdf)]


def test_crs_pdf_writes_the_density(mvn_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p, res = mvn_run
    out = run(crs_pdf, ARGS)
    assert "wrote out/tt-cross-pdf.txt" in out
    assert (tmp_path / "out/tt-cross-pdf.txt").read_text().splitlines() == _pdf_lines(res.tt, p)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "(plotting skipped: " in out
    else:
        assert "wrote out/tt-cross-pdf.png" in out and (tmp_path / "out/tt-cross-pdf.png").is_file()


def test_crs_store_files_read_back(mvn_run, tmp_path, monkeypatch):
    from ttcross_tpu_torch.tt import load_hdf5, load_ttbin

    monkeypatch.chdir(tmp_path)
    p, res = mvn_run
    out = run(crs_store, ARGS)
    assert same_train(load_ttbin("out/tensor_train.ttx", device="cpu"), res.tt)
    assert (tmp_path / "out/tt-cross-pdf.txt").read_text().splitlines() == _pdf_lines(res.tt, p)
    try:
        import h5py  # noqa: F401
    except ImportError:
        assert "(h5py unavailable; skipping HDF5)" in out
    else:
        assert "wrote out/tensor_train.h5" in out
        assert same_train(load_hdf5("out/tensor_train.h5", device="cpu"), res.tt)


def test_crs_coscoeff(tmp_path, monkeypatch):
    from ttcross_tpu_torch.apps import make_cos_coefficients, make_mvn_density
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.tt import load_hdf5

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TTCROSS_ACCCHK", "1")
    out = run(crs_coscoeff, ["4", "17", "6", "1", "0.5"])
    dens = make_mvn_density(4, corr=0.5, device="cpu")
    cc = make_cos_coefficients(4, dens.mu, dens.cov, 0.52517, 8.52517, device="cpu")
    res = cross(cc.fun, [17] * 4, max_rank=6, accuracy=ACC, pivoting=1, device="cpu")
    assert f"...with {res.neval} evaluations" in out and out.count(" n_evals:") == res.sweeps
    assert len(fields(out, "accchk: einf")) == 1
    try:
        import h5py  # noqa: F401
    except ImportError:
        assert "(h5py unavailable; skipping HDF5)" in out
    else:
        assert same_train(load_hdf5("out/coeff-tt-4-17-10-0.5.h5", device="cpu"), res.tt)


def test_print_cos_coeff():
    from ttcross_tpu_torch.apps import make_cos_coefficients, make_mvn_density

    out = run(print_cos_coeff, ["3", "5"], end=None)
    dens = make_mvn_density(3, device="cpu")
    cc = make_cos_coefficients(3, dens.mu, dens.cov, 0.52517, 8.52517, device="cpu")
    ind = torch.zeros((5, 3), dtype=torch.int32)
    ind[:, -1] = torch.arange(5)
    want = cc.fun(ind).numpy()
    got = [float(s.split("coeff=")[1]) for s in out.splitlines()]
    assert got == list(want)
    assert out.splitlines()[2].startswith("  ind=(0, 0, 2)  coeff=")
