"""The yardstick of the double-double kernels' roofline shares, frozen here.

The least time the card could take for one launch of D1, D4 or D2, from the
launch's shape alone: f64 flops (24 a dd multiply, 11 a dd add, counted from
ops/dd.py's operations) over the card's f64 rate outside the tensor cores
(dd arithmetic cannot use them), or bytes (each input read once, hi and lo of
every dd value, each output written once) over the memory rate, whichever is
larger.  Copied from chip_smoke.py: the flop counts from DD_MUL_FLOPS /
DD_ADD_FLOPS (:392), the f64 vector rate from F64_VECTOR_FLOPS (:427), the
memory rate from HBM_BYTES_PER_S (:434, NVIDIA's H100 SXM data sheet at
700 W), the bounds from _dd_bound (:2479-2503).  Later changes to the program
cannot move them.

A kernel's share of its roofline over a traced call follows
roofline.share's rule: the sum of its launches' bounds (launches and their
shapes by the program's counter, ops/kernels.py::launch_shapes()) over the
sum of the device time of its kernels (by kernel name, from the profiler),
both from the same call.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F64_VECTOR_FLOPS", "DD_MUL_FLOPS", "DD_ADD_FLOPS",
           "score_bound", "dot_bound", "ising_bound", "KERNELS", "share"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W
F64_VECTOR_FLOPS = 33.5e12     # ... f64 outside the tensor cores
DD_MUL_FLOPS, DD_ADD_FLOPS = 24, 11
_MADD = DD_MUL_FLOPS + DD_ADD_FLOPS


def _bound_us(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F64_VECTOR_FLOPS) * 1e6


def score_bound(B, T):
    # D1: vals (B,), x and y (B, T) read, the mask, r (B,) and the best
    # written; per row T products and adds, and the subtraction
    return _bound_us(16 * (2 * B * T + B) + B + 16 * B + 32, B * T * _MADD + B * DD_ADD_FLOPS)


def dot_bound(M, N, T):
    # D4: x (M, T), y (T, N) read once, out (M, N) written; per output T
    # products and adds
    return _bound_us(16 * (M * T + T * N + M * N), M * N * T * _MADD)


def ising_bound(B, d, n):
    # D2: the int32 indices and the (4, n) table read, one dd value a row
    # written; per row 2d scan steps, the product, dd_div, d weights and one
    # more multiply
    div = 3 + 2 * DD_MUL_FLOPS + 2 * DD_ADD_FLOPS + 6
    return _bound_us(4 * B * d + 32 * n + 16 * B,
                     B * (2 * d * _MADD + DD_MUL_FLOPS + div + d * DD_MUL_FLOPS + DD_MUL_FLOPS))


# kernel -> (the launch counter's wrapper name, the device kernels' names,
# the bound of one launch from its counted shape)
KERNELS = {
    "dd_score": ("dd_score_residual_argmax", ("dd_score_kernel",), lambda s: score_bound(*s)),
    "dd_dot": ("dd_dot", ("dd_dot_chain_kernel", "dd_dot_kernel"), lambda s: dot_bound(*s)),
    "ising_dd": ("ising_c_integrand_dd_fused", ("ising_c_dd_kernel",),
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
