"""How the benchmark drives the port for each kind of configuration.

A configuration names its drive module (config["drive"]); a drive module has

    setup(config, traffic, device, dtype) -> problem on the device, with
        .integrals_per_call, the integrals a call answers
    call(problem, key) -> the port's result of one call
    summarize(problem, result) -> Summary of that call
    keep(problem, result, rng) -> what the check keeps of it (a list)
    check(problem, kept, values, reference) -> {number name: value}

and nothing else.  Only the port (ttcross_tpu_torch) is imported here.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Summary"]


@dataclass
class Summary:
    """What one call completed: integrals, the port's counts and its answers."""

    integrals: int        # integrals answered
    neval: int            # integrand evaluations of the call (CrossResult.neval)
    sweeps: int           # sweeps the call ran (a family: its longest lane's)
    values: list          # each integral's value, as the port reports it
