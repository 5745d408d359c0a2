"""integrals_per_s: every integral that the window's calls completed, over the
window's whole time (host clock, from its start to the end of its last call)."""


def read(run):
    done = sum(c.integrals for c in run.calls)
    return done / run.window_s if done else None
