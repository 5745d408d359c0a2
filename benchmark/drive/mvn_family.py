"""A family of MVN basket integrals, one lane per correlation scenario,
through one ttcross_tpu_torch.cross.cross_batch call (sequential or
all-bonds jacobi sweeps, as the traffic says)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from ..reference import tt_check
from . import Summary

__all__ = ["setup", "call", "summarize", "keep", "check"]


def setup(config, traffic, device, dtype):
    from ttcross_tpu_torch.apps import make_mvn_family

    corrs = np.linspace(float(traffic["corr_lo"]), float(traffic["corr_hi"]), int(traffic["lanes"]))
    fam = make_mvn_family(d=int(config["d"]), n=int(config["n"]), corrs=corrs, r=float(config["r"]),
                          T=float(config["T"]), sigma=float(config["sigma"]), device=device)
    if dtype != torch.float64:
        # the port's lower tier: its f32 MVN kernel and an f32 engine state
        fam = dataclasses.replace(fam, table=fam.table.to(dtype),
                                  params={k: v.to(dtype) for k, v in fam.params.items()})
    kw = dict(max_rank=int(config["max_rank"]), accuracy=float(config["accuracy"]),
              pivoting=int(config["pivoting"]), quad=[fam.quad_weights] * fam.d,
              truth=float(config["truth"]), max_sweeps=int(config["max_sweeps"]),
              sweep_mode=traffic["sweep_mode"], dtype=dtype, device=device)
    return SimpleNamespace(integrals_per_call=len(corrs), fam=fam, corrs=corrs, kw=kw,
                           lanes_per_call=int(traffic["check"]["lanes_per_call"]))


def call(prob, key):
    from ttcross_tpu_torch.cross import cross_batch

    return cross_batch(prob.fam.fun, [prob.fam.n] * prob.fam.d, prob.fam.params, key=key,
                       **prob.kw)


def summarize(prob, res) -> Summary:
    return Summary(integrals=len(res.lanes), neval=int(res.neval), sweeps=int(res.sweeps),
                   values=[lane.values[-1] if lane.values else float("nan") for lane in res.lanes])


def keep(prob, res, rng):
    """A sample of the call's lanes, drawn from the seed: each lane's train
    (on the device), pivots, correlation and reported value."""
    L = len(res.lanes)
    pick = rng.choice(L, size=min(prob.lanes_per_call, L), replace=False)
    return [SimpleNamespace(corr=float(prob.corrs[i]), cores=res.lanes[i].tt.cores,
                            vip=res.lanes[i].state.vip, rk=res.lanes[i].state.rk,
                            value=res.lanes[i].values[-1]) for i in sorted(pick)]


def check(prob, kept, values, ref):
    """interp_gap: the train against the reference density at its cross
    points; value_gap: the reported integral against the reference's
    contraction of the train; err_geomean: the geometric mean over every
    integral of the window of |1 - value / truth| (each at least 1e-16, so
    that an exact answer counts as a rounding), the family's digits."""
    interp, value = 0.0, 0.0
    for item in kept:
        cores = [c.to(ref.device, torch.float64) for c in item.cores]
        interp = max(interp, tt_check.interp_gap(cores, item.vip, item.rk, ref.integrand(item.corr)))
        want = tt_check.contract(cores, ref.quad)
        value = max(value, abs(item.value - want) / abs(want))
    err = np.maximum(np.abs(1.0 - np.asarray(values, np.float64) / ref.truth), 1e-16)
    return {"interp_gap": interp, "value_gap": value,
            "err_geomean": float(np.exp(np.log(err).mean()))}
