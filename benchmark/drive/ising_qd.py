"""One Ising C_m integral per call through ttcross_tpu_torch.cross.cross_qd,
the quad-double tier, judged in decimal (reference/tt_check_qd.py).  Where the
harness asks for a dtype other than the configuration's, the tier below runs
in its place at the same m, n, rank and pivoting: cross_dd on make_ising_dd
(the check's control)."""

from __future__ import annotations

import math
import sys
from decimal import localcontext
from types import SimpleNamespace

import numpy as np
import torch

from ..reference import tt_check_qd
from ..reference.ising_c4_qd import PREC
from . import Summary

__all__ = ["setup", "call", "summarize", "keep", "check"]


def setup(config, traffic, device, dtype):
    m, n = int(config["m"]), int(config["n"])
    control = dtype != getattr(torch, config["dtype"])
    if control:
        from ttcross_tpu_torch.apps import make_ising_dd

        prob, fun, wh, wl = make_ising_dd(m=m, n=n, device=device)
        kw = dict(weights_hi=wh, weights_lo=wl)
    else:
        import dataclasses

        from ttcross_tpu_torch.apps import make_ising_qd
        from ttcross_tpu_torch.cross import QdCrossResult

        if "vip" not in {f.name for f in dataclasses.fields(QdCrossResult)}:
            raise RuntimeError("this port's cross_qd reports no pivots (QdCrossResult.vip): "
                               "its trains cannot be checked")
        prob, fun, wq = make_ising_qd(m=m, n=n, device=device)
        kw = dict(quad=wq, accuracy_log10=float(config["accuracy_log10"]))
    kw.update(max_rank=int(config["max_rank"]), pivoting=int(config["pivoting"]), device=device)
    chk = traffic["check"]
    return SimpleNamespace(integrals_per_call=1, control=control, fun=fun, shape=[prob.n] * prob.d,
                           kw=kw, call_share=float(chk["call_share"]),
                           budget=int(chk["mults_per_core"]), calls=0, trains=0)


def call(prob, key):
    if prob.control:
        from ttcross_tpu_torch.cross import cross_dd

        return cross_dd(prob.fun, prob.shape, key=key, **prob.kw)
    from ttcross_tpu_torch.cross import cross_qd

    return cross_qd(prob.fun, prob.shape, seed=key, **prob.kw)


def _limbs(res) -> list:
    """The reported value's limbs as floats, the leading limb first."""
    return torch.stack([torch.as_tensor(e, dtype=torch.float64) for e in res.value]).cpu().tolist()


def summarize(prob, res) -> Summary:
    return Summary(integrals=1, neval=int(res.neval), sweeps=int(res.sweeps),
                   values=[_limbs(res)[0]])


def keep(prob, res, rng):
    """Every solve's value limbs; the train (cores as limbs, vip, ranks) of
    the first solve and of a share of the others drawn from the seed, with
    the seed of the rows its check samples."""
    item = SimpleNamespace(index=prob.calls, limbs=_limbs(res), cores=None)
    prob.calls += 1
    if not prob.trains or rng.random() < prob.call_share:
        prob.trains += 1
        if prob.control:
            item.cores = list(zip(res.cores_hi, res.cores_lo))
        else:
            item.cores = list(res.cores)
        item.vip, item.rk = res.vip, res.ranks
        item.rows_seed = int(rng.integers(2 ** 63))
    return [item]


def _decimal_cores(cores):
    return [tt_check_qd.to_decimal([torch.as_tensor(e).cpu().numpy() for e in g]) for g in cores]


def check(prob, kept, values, ref):
    """In decimal at the reference's digits: interp_gap at the kept
    trains' cross points on every core (rows sampled where a core's rows
    cost more than the traffic's mults_per_core); value_gap, the reported
    limbs against the reference's contraction of the train; err_worst,
    the largest |1 - value / truth| over every solve of the window."""
    interp, value, err = 0.0, 0.0, 0.0
    with localcontext() as ctx:
        ctx.prec = PREC
        for item in kept:
            v = tt_check_qd.to_decimal([np.asarray(x) for x in item.limbs])[()]
            rel = abs(1 - v / ref.truth)
            err = max(err, float(rel))
            print(f"digits call {item.index}: {float(-rel.log10()) if rel else math.inf:.4f} "
                  f"(decimal, {len(item.limbs)} limbs)", file=sys.stderr)
            if item.cores is None:
                continue
            cores = _decimal_cores(item.cores)
            interp = max(interp, tt_check_qd.interp_gap(
                cores, item.vip, item.rk, ref.integrand,
                rng=np.random.default_rng(item.rows_seed), budget=prob.budget))
            want = tt_check_qd.contract(cores, ref.quad)
            value = max(value, float(abs(v - want) / abs(want)))
    return {"interp_gap": interp, "value_gap": value, "err_worst": err}
