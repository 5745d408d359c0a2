"""The yardstick of the hand kernels' roofline shares, frozen here.

The least time the card could take for one launch, from the launch's shape
alone: its bytes (each input read once, each output written once) over the
memory rate, or its operations over the peak rate of its element type,
whichever is larger.  Copied from chip_smoke.py: the peaks from :415-417
(NVIDIA's H100 SXM data sheet at 700 W), bound_us from _bound_us (:469-474),
batched_bound from _batched_bound (:482-484), lookup_bound from
_lookup_bound (:487-489), integrand_bound from _integrand_bound (:492-500),
mvn_bound from _mvn_bound (:812-817).  Later changes to the program cannot
move them; a PR that needs another yardstick adds it beside these.

A kernel's share of its roofline over a traced call is the sum of its
launches' bounds over the sum of the device time of its kernels, both from
the same call: launches and their shapes by the program's counter
(ops/kernels.py::launch_shapes()), device time by kernel name from the
profiler.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F64_FLOPS", "F32_FLOPS", "bound_us", "batched_bound",
           "lookup_bound", "integrand_bound", "mvn_bound", "KERNELS", "share"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
F64_FLOPS = 67e12           # ... f64 on the tensor cores, the card's f64 peak
F32_FLOPS = 67e12           # ... f32 outside the tensor cores


def bound_us(nbytes: int, flops: int, esz: int = 8) -> float:
    """Bytes over the memory rate or flops over the element type's peak,
    whichever is larger, in microseconds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (F64_FLOPS if esz == 8 else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e6


def batched_bound(P, M, K, R, esz=8):
    # per fiber: vals, colf, rowf and the mask read once, three 8-byte result words written
    return bound_us(P * (esz * (M * K + M * R + R * K) + M * K + 24), 2 * P * M * K * R, esz)


def lookup_bound(L, E, n, esz=8):
    # the tables and the int32 indices read once, L outputs per index
    return bound_us(esz * L * n + 4 * E + esz * L * E, 0, esz)


def integrand_bound(kind, B, d, n, esz=8):
    # the int32 indices and the (2, n) table read once, one value per row
    # written; per variable a prefix product and a weight product, for C
    # and D also the prefix sum and the suffix product and sum; for D and
    # E five operations per pair i < j; four per row to combine
    per_row = 2 * d + (3 * d if kind in "CD" else 0) + (5 * d * (d + 1) // 2 if kind in "DE" else 0)
    return bound_us(4 * B * d + 2 * esz * n + esz * B, B * (per_row + 4), esz)


def mvn_bound(L, B, d, n, esz=8):
    # the int32 indices, the table and each lane's mu, C and norm read once,
    # one value per row written; per row d differences, d^2 products and
    # sums for t, d of each for q, the scale, exp and the division
    nbytes = 4 * L * B * d + esz * (n + L * (d * d + d + 1)) + esz * L * B
    return bound_us(nbytes, L * B * (2 * d * d + 3 * d + 3), esz)


def _split(shape):
    """A launch_shapes() key: its numbers and its element size (an f32
    launch's key ends in "f32")."""
    shape = tuple(shape)
    if shape and shape[-1] == "f32":
        return shape[:-1], 4
    return shape, 8


def _batched(shape):
    (P, M, K, R), esz = _split(shape)
    return batched_bound(P, M, K, R, esz)


def _lookup(shape):
    (L, B, d, n), esz = _split(shape)
    return lookup_bound(L, B * d, n, esz)


def _mvn(shape):
    (L, B, d, n), esz = _split(shape)
    return mvn_bound(L, B, d, n, esz)


# kernel -> (the launch counter's wrapper name, the device kernels' names,
# the bound of one launch from its counted shape)
KERNELS = {
    "score_batched": ("score_residual_argmax_batched",
                      ("score_fiber_batched_kernel", "score_fiber_batched_cluster_kernel"), _batched),
    "table_lookup": ("small_table_lookup", ("lookup_kernel",), _lookup),
    "mvn_pdf_fused": ("mvn_pdf_fused", ("mvn_pdf_kernel",), _mvn),
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
