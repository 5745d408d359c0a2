"""solve_s: the window's whole time (host clock, from its start to the end
of its last call) over the solves it completed."""


def read(run):
    done = sum(c.integrals for c in run.calls)
    return run.window_s / done if done else None
