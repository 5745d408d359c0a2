"""The port's drivers against the JAX package's scripts where the lottery
plays no part: each JAX script's main() runs in this process (its module
loaded from drivers/<name>.py, sys.argv set, stdout captured, JAX on its
CPU backend) beside the port's main(argv, device="cpu").

print_s_vectors prints the same text; print_cos_coeff the same indices
and every coefficient within 1e-14 relative; crs_quantics the same
analytic value (the closed-form geometric sum); plot_ttcross_data.plot_pdf
writes a PNG from the same text file and prints the same mean absolute
error against a TT-SVD file."""

import importlib.util
import io
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from ttcross_tpu_torch.drivers import (crs_quantics, plot_ttcross_data, print_cos_coeff,
                                       print_s_vectors)
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent
COS_RTOL = 1e-14


def jax_script(name):
    """drivers/<name>.py as a module (its main() reads sys.argv)."""
    path = ROOT / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def jax_main(name, argv, monkeypatch):
    mod, path = jax_script(name)
    monkeypatch.setattr(sys, "argv", [str(path)] + list(argv))
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def port_main(mod, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert mod.main(argv, device="cpu") == 0
    return buf.getvalue()


@pytest.mark.parametrize("d", ["3", "4"])
def test_print_s_vectors_is_the_jax_script(d, monkeypatch):
    got = port_main(print_s_vectors, [d])
    assert got == jax_main("print_s_vectors", [d], monkeypatch)
    assert len(got.splitlines()) == 2 ** (int(d) - 1)


def test_print_cos_coeff_is_the_jax_script(monkeypatch):
    got = port_main(print_cos_coeff, ["2", "3"]).splitlines()
    want = jax_main("print_cos_coeff", ["2", "3"], monkeypatch).splitlines()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.split("coeff=")[0] == w.split("coeff=")[0]
        gv, wv = float(g.split("coeff=")[1]), float(w.split("coeff=")[1])
        assert abs(gv - wv) <= COS_RTOL * abs(wv), (g, w)


def test_crs_quantics_analytic_value_is_the_jax_script(monkeypatch):
    argv = ["10", "8", "1", "1"]
    got, want = port_main(crs_quantics, argv), jax_main("crs_quantics", argv, monkeypatch)

    def line(out, label):
        return next(ln for ln in out.splitlines() if ln.startswith(label))

    assert line(got, "analytic value:") == line(want, "analytic value:")
    assert line(got, "   bits") == line(want, "   bits")


def _pdf_files(tmp_path):
    xs = np.linspace(0.0, 300.0, 200)
    pdf = np.exp(-0.5 * ((xs - 100.0) / 20.0) ** 2) / (20.0 * np.sqrt(2 * np.pi))
    path, svd = tmp_path / "tt-cross-pdf.txt", tmp_path / "tt-svd-pdf.txt"
    np.savetxt(path, np.stack([xs, pdf], axis=1), fmt="%.10e")
    np.savetxt(svd, np.stack([xs, pdf * (1 + 1e-3 * np.sin(xs))], axis=1), fmt="%.10e")
    return str(path), str(svd)


def test_plot_pdf_is_the_jax_script(tmp_path):
    pytest.importorskip("matplotlib")
    path, svd = _pdf_files(tmp_path)
    jax_plot, _ = jax_script("plot_ttcross_data")
    outs = []
    for fn, png in ((plot_ttcross_data.plot_pdf, "port.png"), (jax_plot.plot_pdf, "jax.png")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(path, str(tmp_path / png), svd)
        outs.append(buf.getvalue())
        assert (tmp_path / png).stat().st_size > 0
    assert outs[0] == outs[1] and outs[0].startswith("mean abs error:")


def test_plot_pdf_python_dash_m(tmp_path):
    """`python -m ttcross_tpu_torch.drivers.plot_ttcross_data PATH OUT` from
    the checkout: a PNG, or matplotlib's ImportError where it is absent."""
    path, _ = _pdf_files(tmp_path)
    out = tmp_path / "dash_m.png"
    proc = subprocess.run([sys.executable, "-m", "ttcross_tpu_torch.drivers.plot_ttcross_data",
                           path, str(out)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if importlib.util.find_spec("matplotlib") is None:
        assert proc.returncode != 0 and "matplotlib" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert out.stat().st_size > 0
