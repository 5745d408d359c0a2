"""evals_per_integral.dd: integrand evaluations (DDCrossResult.neval) over
the integrals completed, summed over the window's cross_dd calls."""


def read(run):
    done = sum(c.integrals for c in run.calls)
    return sum(c.neval for c in run.calls) / done if done else None
