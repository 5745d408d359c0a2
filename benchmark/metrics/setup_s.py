"""setup_s: from the start of the process to the start of the window (host
clock): imports, the kernels built or loaded, the problem made on the card
and the warm-up call."""


def read(run):
    return run.setup_s
