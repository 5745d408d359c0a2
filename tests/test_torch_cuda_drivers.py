"""The dd / qd drivers of ttcross_tpu_torch/drivers/ on the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_drivers.py

Each driver runs in process at the small configuration of
tests/test_torch_drivers.py with its default device (the card): exit code
0, its digits at or above that file's floors, and the hand kernels of its
path launched.  The dd engine's driver prints the CPU run's value (the dd
engine on the card equals its CPU run bit for bit)."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.drivers import (chf_equal, crs_ising_dd, crs_ising_mp, crs_ising_qd,
                                       crs_ising_qde, crs_stdnorm_dd)
from ttcross_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

RUNS = {   # driver: (module, argv, floor, the kernels its path must launch)
    "crs_ising_dd": (crs_ising_dd, ["4", "17", "8", "12"], 13.42,
                     ("score_residual_argmax", "ising_integrand_fused",
                      "ising_c_integrand_dd_fused", "dd_gather_tt_fused", "dd_dot")),
    "crs_ising_mp": (crs_ising_mp, ["4", "17", "8"], 9.29,
                     ("dd_score_residual_argmax", "dd_dot", "ising_c_integrand_dd_fused")),
    "crs_stdnorm_dd": (crs_stdnorm_dd, ["4", "65", "4"], 20.46,
                       ("score_residual_argmax", "small_table_lookup", "qd_dot")),
    "crs_ising_qd": (crs_ising_qd, ["4", "17", "8", "12", "2"], 13.42,
                     ("score_residual_argmax", "ising_integrand_fused",
                      "ising_c_integrand_qd_fused", "qd_gather_tt_fused", "qd_dot")),
    "crs_ising_qde": (crs_ising_qde, ["4", "17", "10", "1", "1"], 12.38,
                      ("qd_score_residual_argmax", "qd_dot", "ising_c_integrand_qd_fused")),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _run(mod, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv, **kw)
    return rc, buf.getvalue()


def _field(out, label):
    return next(ln for ln in out.splitlines() if ln.startswith(label))[len(label):].strip()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_driver_runs_on_the_card_through_its_kernels(name, cuda_device):
    mod, argv, floor, need = RUNS[name]
    K.reset_launch_counts()
    rc, out = _run(mod, argv)        # the default device: the card
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert rc == 0, out
    assert float(_field(out, "correct digits:").split()[0]) >= floor, out
    assert all(counts.get(k, 0) > 0 for k in need), counts


def test_dd_engine_driver_prints_the_cpu_value(cuda_device):
    _, card = _run(crs_ising_mp, ["4", "17", "8"])
    _, cpu = _run(crs_ising_mp, ["4", "17", "8"], device="cpu")
    assert _field(card, "computed value:") == _field(cpu, "computed value:")


def test_chf_equal_on_the_card(cuda_device):
    rc, out = _run(chf_equal, [])
    assert rc == 0 and "EQUAL" in out, out
