"""One Ising C_m integral per call through ttcross_tpu_torch.cross.cross_dd,
the double-double tier, judged in decimal (reference/tt_check_qd.py reads
any number of limbs).  Where the harness asks for a dtype other than the
configuration's, the tier below runs in its place at the same m, n, rank and
pivoting: the float64 cross on make_ising("C", m, n), its cores as one limb,
stopped by the float64 tier's own accuracy (the check's control).  The
check is drive/ising_qd.py's: it reads (hi, lo) cores and one-limb cores
alike, at the same decimal precision."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from . import Summary
from .ising_qd import check

__all__ = ["setup", "call", "summarize", "keep", "check"]

F64_ACCURACY = 1.1e-13      # the float64 tier's stop: 500 ulps of 1 (bench.py's)


def setup(config, traffic, device, dtype):
    m, n = int(config["m"]), int(config["n"])
    control = dtype != getattr(torch, config["dtype"])
    kw = dict(max_rank=int(config["max_rank"]), pivoting=int(config["pivoting"]), device=device)
    if control:
        from ttcross_tpu_torch.apps import make_ising

        prob = make_ising("C", m=m, n=n, device=device)
        fun = prob.fun
        kw.update(accuracy=F64_ACCURACY, quad=[prob.quad_weights] * prob.d, return_pivots=True)
    else:
        import dataclasses

        from ttcross_tpu_torch.apps import make_ising_dd
        from ttcross_tpu_torch.cross import DDCrossResult

        if "vip" not in {f.name for f in dataclasses.fields(DDCrossResult)}:
            raise RuntimeError("this port's cross_dd reports no pivots (DDCrossResult.vip): "
                               "its trains cannot be checked")
        prob, fun, wh, wl = make_ising_dd(m=m, n=n, device=device)
        kw.update(weights_hi=wh, weights_lo=wl, accuracy=float(config["accuracy"]),
                  small_element=float(config["small_element"]),
                  small_pivot=float(config["small_pivot"]))
    chk = traffic["check"]
    return SimpleNamespace(integrals_per_call=1, control=control, fun=fun,
                           shape=[prob.n] * prob.d, kw=kw, call_share=float(chk["call_share"]),
                           budget=int(chk["mults_per_core"]), calls=0, trains=0)


def call(prob, key):
    if prob.control:
        from ttcross_tpu_torch.cross import cross

        return cross(prob.fun, prob.shape, key=key, **prob.kw)
    from ttcross_tpu_torch.cross import cross_dd

    return cross_dd(prob.fun, prob.shape, key=key, **prob.kw)


def _limbs(prob, res) -> list:
    """The reported value's limbs as floats, the leading limb first."""
    if prob.control:
        return [float(res.values[-1]) if res.values else math.nan]
    return [float(e) for e in res.value]


def summarize(prob, res) -> Summary:
    return Summary(integrals=1, neval=int(res.neval), sweeps=int(res.sweeps),
                   values=[_limbs(prob, res)[0]])


def keep(prob, res, rng):
    """Every solve's value limbs; the train (cores as limbs, vip, ranks) of
    the first solve and of a share of the others drawn from the seed, with
    the seed of the rows its check samples."""
    item = SimpleNamespace(index=prob.calls, limbs=_limbs(prob, res), cores=None)
    prob.calls += 1
    if not prob.trains or rng.random() < prob.call_share:
        prob.trains += 1
        if prob.control:
            item.cores = [(g.cpu().numpy(),) for g in res.tt.cores]
            item.vip, item.rk = np.asarray(res.state.vip), np.asarray(res.state.rk)
        else:
            item.cores = list(zip(res.cores_hi, res.cores_lo))
            item.vip, item.rk = res.vip, res.ranks
        item.rows_seed = int(rng.integers(2 ** 63))
    return [item]
