"""Small public names of the port against the JAX package's: tt.from_dense,
the 1/t quadrature, the metrics helpers, the driver CLI helpers and the
default dtypes.  All host-side (numpy) or CPU tensors; results compared
bit for bit where both packages run the same numpy code."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import ttcross_tpu.tt as jtt
from ttcross_tpu import config as jconfig
from ttcross_tpu.ops import quadrature as jquad
from ttcross_tpu.utils import cli as jcli
from ttcross_tpu.utils import metrics as jmetrics
from ttcross_tpu_torch import config as pconfig
from ttcross_tpu_torch import tt as ptt
from ttcross_tpu_torch.ops import quadrature as pquad
from ttcross_tpu_torch.utils import cli as pcli
from ttcross_tpu_torch.utils import metrics as pmetrics


@pytest.mark.parametrize("tol,rmax", [(1e-14, None), (1e-6, None), (0.0, 2), (1e-3, 3)])
def test_from_dense_matches_jax(tol, rmax):
    """The same numpy SVDs and chop rule: the same ranks and cores."""
    rng = np.random.default_rng(1)
    a = np.einsum("i,j,k,l->ijkl", *(rng.normal(size=m) for m in (3, 4, 5, 2)))
    a = a + 1e-4 * rng.normal(size=a.shape)
    jt = jtt.from_dense(a, tol=tol, rmax=rmax)
    pt = ptt.from_dense(a, tol=tol, rmax=rmax, device="cpu")
    assert list(pt.r) == [int(x) for x in jt.r]
    for pc, jc in zip(pt.cores, jt.cores):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    flat = ptt.from_dense(a.reshape(-1), n=a.shape, tol=tol, rmax=rmax, device="cpu")
    assert flat.r == pt.r


def test_from_dense_keeps_a_tensor_where_it_lies():
    a = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
    t = ptt.from_dense(a)
    assert t.device.type == "cpu" and tuple(t.r) == (1, 2, 2, 1)
    np.testing.assert_allclose(ptt.full(t).numpy(), a.numpy(), atol=1e-12)


@pytest.mark.parametrize("n", [9, 33, 101])
def test_quad_rinv_matches_jax(n):
    q = pquad.quad_rinv(n)
    np.testing.assert_array_equal(q, jquad.quad_rinv(n))
    for a, b in [(1e-2, 1.0), (0.5, 20.0)]:
        assert pquad.quad_rinv_error(q, a, b, 200) == jquad.quad_rinv_error(q, a, b, 200)
    with pytest.raises(ValueError, match="illegal interval"):
        pquad.quad_rinv_error(q, 0.0, 1.0, 10)


def test_quad_rinv_converges():
    """More nodes, a smaller relative error of 1/t on [1e-2, 1]."""
    errs = [pquad.quad_rinv_error(pquad.quad_rinv(n), 1e-2, 1.0, 100) for n in (17, 65, 257)]
    assert errs[0] > errs[1] > errs[2] and errs[2] < 1e-8


def test_write_jsonl_matches_jax(tmp_path):
    recs = [dict(it=1, direction=">>", n_evals=10, pivotmax=0.5, value=1.25, err=1e-3),
            dict(it=2, direction="<<", n_evals=25, pivotmax=0.125, value=1.5, cnv=2e-4)]
    pmetrics.write_jsonl([pmetrics.SweepRecord(**r) for r in recs], str(tmp_path / "p.jsonl"))
    jmetrics.write_jsonl([jmetrics.SweepRecord(**r) for r in recs], str(tmp_path / "j.jsonl"))
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    back = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert back == recs


def test_timer_and_profile_trace(tmp_path):
    t = pmetrics.Timer()
    with pmetrics.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64, dtype=torch.float64) @ torch.ones(64, 64, dtype=torch.float64)
    assert 0.0 < t() < 60.0 and t() >= 0.0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_readarg_matches_jax(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["crs_ising.py", "D", "7", "0.5"])
    for pos, default in [(1, "C"), (2, 6), (3, 1.0), (4, 24), (5, "x")]:
        assert pcli.readarg(pos, default) == jcli.readarg(pos, default)
    assert pcli.readarg(2, 6, cast=float) == 7.0


def test_maybe_accchk_and_print_config(monkeypatch, capsys):
    from ttcross_tpu_torch.apps import make_stdnorm
    from ttcross_tpu_torch.cross import cross

    p = make_stdnorm(d=3, n=9, device="cpu")
    res = cross(p.fun, [p.n] * p.d, max_rank=3, device="cpu")
    monkeypatch.delenv("TTCROSS_ACCCHK", raising=False)
    pcli.maybe_accchk(res, p.fun, nlot=64)
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("TTCROSS_ACCCHK", "1")
    pcli.maybe_accchk(res, p.fun, nlot=64)
    line = capsys.readouterr().out
    assert line.startswith("accchk: einf") and "worst" in line
    pcli.print_config(kind="C", m=6)
    out = capsys.readouterr().out.splitlines()
    assert [o.split(":")[0].strip() for o in out] == ["kind", "m", "device", "n devices"]
    if not torch.cuda.is_available():
        assert out[-1].split(":")[1].strip() == "0"


def test_default_dtypes_and_thresholds():
    """float64 / complex128 as the JAX package's defaults under x64 (its
    default); the f32 tier's thresholds are the real*4 row."""
    assert pconfig.default_dtype() == torch.float64
    assert pconfig.default_complex_dtype() == torch.complex128
    assert jconfig.default_dtype() == jnp.float64
    assert jconfig.default_complex_dtype() == jnp.complex128
    for pdt, jdt in [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]:
        assert pconfig.precision_thresholds(pdt) == jconfig.precision_thresholds(jdt)
    assert pconfig.precision_thresholds(torch.float32)[1] == 1e-3
