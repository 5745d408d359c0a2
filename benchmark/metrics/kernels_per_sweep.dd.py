"""kernels_per_sweep.dd: device ops (every kernel, copy and set, not only
the hand kernels) of the traced cross_dd call over the sweeps it ran, from
torch.profiler."""


def read(run):
    tr = run.trace
    return len(tr.ops) / tr.sweeps if tr is not None and tr.sweeps else None
