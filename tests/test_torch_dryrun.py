"""The port's multi-rank dry run (ttcross_tpu_torch/parallel/dryrun.py::
dryrun_multichip) on four gloo ranks of the CPU: every distributed mode
(cross_parallel sequential, jacobi, refine_sweeps=1, jacobi-rb with a
product chain, the lane-sharded cross_batch) reconstructs its tensor to
err < 1e-8 on every rank, every rank returns the same result, and the
sequential run's ranks are those of the JAX function at four devices.

The JAX package's dry run (__graft_entry__.dryrun_multichip(4), its forced
CPU platform with four host devices) prints

    dryrun_multichip(4): OK  ranks=(1, 2, 2, 2, 2, 1) err=1.42e-14 neval=337
    dryrun_multichip(4): jacobi err=1.42e-14, maxvol-refine err=8.88e-15,
        rb-chain err=7.77e-16 — all distributed modes OK
    dryrun_multichip(4): lane-sharded cross_batch (4 lanes) worst err=1.42e-14 — OK

and MULTICHIP_r05.json records the same three lines at eight devices."""

import io
from contextlib import redirect_stdout

import pytest

from ttcross_tpu_torch.parallel import dryrun_multichip
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

JAX_SEQUENTIAL_RANKS = (1, 2, 2, 2, 2, 1)
MODES = ("sequential", "jacobi", "maxvol-refine", "rb-chain")


@pytest.fixture(scope="module")
def dryrun4():
    buf = io.StringIO()
    with redirect_stdout(buf):
        outs = dryrun_multichip(4, device="cpu", timeout=240)
    return outs, buf.getvalue()


def test_every_mode_reconstructs_its_tensor(dryrun4):
    outs, _ = dryrun4
    assert len(outs) == 4
    for o in outs:
        assert all(o[m]["err"] < 1e-8 for m in MODES), o
        assert max(o["lanes"]["errs"]) < 1e-8 and len(o["lanes"]["errs"]) == 4
        assert o["device"] == "cpu" and not any(o["launch_shapes"].values())
    for m in MODES:     # every rank returns the run's one result
        assert len({(o[m]["ranks"], o[m]["neval"]) for o in outs}) == 1, m


def test_sequential_ranks_are_the_jax_dry_runs(dryrun4):
    outs, _ = dryrun4
    assert outs[0]["sequential"]["ranks"] == JAX_SEQUENTIAL_RANKS
    assert outs[0]["rb-chain"]["ranks"] == (1,) * 6        # a product: rank 1


def test_prints_the_jax_functions_three_lines(dryrun4):
    outs, out = dryrun4
    lines = out.splitlines()
    seq = outs[0]["sequential"]
    assert lines[0] == (f"dryrun_multichip(4): OK  ranks={JAX_SEQUENTIAL_RANKS} "
                        f"err={seq['err']:.2e} neval={seq['neval']}")
    assert lines[1].endswith("— all distributed modes OK") and "rb-chain err=" in lines[1]
    assert lines[2].startswith("dryrun_multichip(4): lane-sharded cross_batch (4 lanes) worst err=")
    assert len(lines) == 3
