"""One Ising C_m integral per call through ttcross_tpu_torch.cross.cross,
with the sweep mode and the chain evaluator that the traffic names."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..reference import tt_check
from . import Summary

__all__ = ["setup", "call", "summarize", "keep", "check"]


def setup(config, traffic, device, dtype):
    from ttcross_tpu_torch.apps import make_ising

    prob = make_ising(str(config["kind"]), m=int(config["m"]), n=int(config["n"]), device=device,
                      dtype=dtype)
    kw = dict(max_rank=int(config["max_rank"]), accuracy=float(config["accuracy"]),
              pivoting=int(config["pivoting"]), quad=[prob.quad_weights] * prob.d,
              truth=float(config["truth"]), max_sweeps=int(config["max_sweeps"]),
              sweep_mode=traffic["sweep_mode"], chain=prob.chain if traffic["chain"] else None,
              return_pivots=True, dtype=dtype, device=device)
    chk = traffic["check"]
    return SimpleNamespace(integrals_per_call=1, prob=prob, kw=kw, call_share=float(chk["call_share"]),
                           cores_per_solve=int(chk["cores_per_solve"]), kept_calls=0)


def call(prob, key):
    from ttcross_tpu_torch.cross import cross

    p = prob.prob
    return cross(p.fun, [p.n] * p.d, key=key, **prob.kw)


def summarize(prob, res) -> Summary:
    return Summary(integrals=1, neval=int(res.neval), sweeps=int(res.sweeps),
                   values=[res.values[-1] if res.values else float("nan")])


def keep(prob, res, rng):
    """The whole train of a sample of the solves, drawn from the seed (the
    first solve always), with the cores whose cross points the check reads."""
    draw = rng.random()
    if prob.kept_calls and draw >= prob.call_share:
        return []
    prob.kept_calls += 1
    d = len(res.tt.cores)
    inner = rng.choice(np.arange(1, d - 1), size=min(prob.cores_per_solve, d - 2), replace=False)
    return [SimpleNamespace(cores=res.tt.cores, vip=res.state.vip, rk=res.state.rk,
                            value=res.values[-1], check_cores=[0, d - 1, *sorted(inner)])]


def check(prob, kept, values, ref):
    """interp_gap at the sampled cores' cross points; value_gap: the
    reported integral against the reference's contraction of the train;
    err_worst: the largest |1 - value / truth| over every solve of the
    window."""
    interp, value = 0.0, 0.0
    for item in kept:
        cores = [c.to(ref.device, torch.float64) for c in item.cores]
        interp = max(interp, tt_check.interp_gap(cores, item.vip, item.rk, ref.integrand,
                                                 check_cores=item.check_cores))
        want = tt_check.contract(cores, ref.quad)
        value = max(value, abs(item.value - want) / abs(want))
    err = np.abs(1.0 - np.asarray(values, np.float64) / ref.truth)
    return {"interp_gap": interp, "value_gap": value, "err_worst": float(err.max())}
