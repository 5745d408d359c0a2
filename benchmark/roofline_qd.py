"""The yardstick of the quad-double kernels' roofline shares, frozen here.

The least time the card could take for one launch of Q1, Q2 or Q4, from the
launch's shape alone: f64 flops (508 a qd multiply, 172 a qd add, 1586 a qd
divide, counted from ops/qd.py's operations) over the card's f64 rate
outside the tensor cores (qd arithmetic cannot use them), or bytes (each
input read once, four limbs of every qd value, each output written once)
over the memory rate, whichever is larger.  Copied from chip_smoke.py: the
flop counts from QD_MUL_FLOPS / QD_ADD_FLOPS / QD_DIV_FLOPS (:3372), the
f64 vector rate from F64_VECTOR_FLOPS (:422), the memory rate from :429
(NVIDIA's H100 SXM data sheet at 700 W), the bounds from _qd_bound
(:3397-3425).  Later changes to the program cannot move them.

A kernel's share of its roofline over a traced call follows
roofline.share's rule: the sum of its launches' bounds (launches and their
shapes by the program's counter, ops/kernels.py::launch_shapes()) over the
sum of the device time of its kernels (by kernel name, from the profiler),
both from the same call.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F64_VECTOR_FLOPS", "QD_MUL_FLOPS", "QD_ADD_FLOPS",
           "QD_DIV_FLOPS", "score_bound", "dot_bound", "ising_bound", "KERNELS", "share"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W
F64_VECTOR_FLOPS = 33.5e12     # ... f64 outside the tensor cores
QD_MUL_FLOPS, QD_ADD_FLOPS, QD_DIV_FLOPS = 508, 172, 1586


def _bound_us(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F64_VECTOR_FLOPS) * 1e6


def score_bound(B, T):
    # Q2: vals (B,), x and y (B, T) read, r (B,) and the index written; per
    # row T products, T - 1 tree adds and the subtraction
    return _bound_us(32 * (2 * B * T + B) + 32 * B, B * (T * QD_MUL_FLOPS + T * QD_ADD_FLOPS))


def dot_bound(M, N, T):
    # Q4: x (M, T), y (T, N) read once, out (M, N) written; per output T
    # products and T - 1 adds
    return _bound_us(32 * (M * T + T * N + M * N),
                     M * N * (T * QD_MUL_FLOPS + max(T - 1, 0) * QD_ADD_FLOPS))


def ising_bound(B, d, n):
    # Q1: the int32 indices and the (8, n) table read, one qd value a row
    # written; per row 3d + 2 multiplies, 2d adds and one divide
    return _bound_us(4 * B * d + 64 * n + 32 * B,
                     B * ((3 * d + 2) * QD_MUL_FLOPS + 2 * d * QD_ADD_FLOPS + QD_DIV_FLOPS))


# kernel -> (the launch counter's wrapper name, the device kernels' names,
# the bound of one launch from its counted shape)
KERNELS = {
    "qd_score": ("qd_score_residual_argmax", ("qd_score_kernel", "qd_score_tree_kernel"),
                 lambda s: score_bound(*s)),
    "qd_dot": ("qd_dot", ("qd_dot_kernel", "qd_dot_chain_kernel", "qd_dot_tree_kernel"),
               lambda s: dot_bound(*s[:3])),
    "ising_qd": ("ising_c_integrand_qd_fused", ("ising_c_qd_kernel",),
                 lambda s: ising_bound(*s)),
}


def share(trace, kernel: str):
    """The kernel's share of its roofline in percent over the traced call,
    or None where the call launched it not at all or the profiler recorded
    none of its kernels.  Where the profiler recorded fewer of its kernels
    than the counter counted launches, the bound is taken for the recorded
    share of the launches (their mean bound times the recorded count)."""
    wrapper, names, bound = KERNELS[kernel]
    shapes = trace.launch_shapes.get(wrapper, {})
    launches = sum(shapes.values())
    total_bound = sum(bound(s) * c for s, c in shapes.items())
    durs = [e.seconds for e in trace.ops if e.base in names]
    if not launches or not durs or sum(durs) <= 0:
        return None
    if len(durs) < launches:
        total_bound *= len(durs) / launches
    return 100.0 * total_bound * 1e-6 / sum(durs)
