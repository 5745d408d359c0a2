"""sweep_ms.solve: milliseconds in calls (host clock) over the sweeps they
ran, summed over the window's calls; a family's call counts the sweeps of
its longest lane."""


def read(run):
    sweeps = sum(c.sweeps for c in run.calls)
    return 1e3 * sum(c.wall for c in run.calls) / sweeps if sweeps else None
