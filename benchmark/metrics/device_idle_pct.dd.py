"""device_idle_pct.dd: the share of the traced cross_dd call's window (the
call and its result handling) in which no op ran on the device, from
torch.profiler."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr is not None and tr.window_s > 0 else None
