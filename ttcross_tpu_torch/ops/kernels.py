"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their launch counters: kernel A (the masked residual argmax), kernel B
(the small-table lookup) and kernel B's redesign, the fused Ising
integrand.

Counterpart of ttcross_tpu/ops/pallas_kernels.py.  The CUDA sources are in
``csrc/kernels.cu`` (built by ``ops/_build.py``).  Each wrapper routes a
tensor that lies on the CPU to the plain version and a CUDA tensor to the
kernel; on a CUDA tensor it launches the kernel or raises, never falling
back.  ``<wrapper>.launches`` counts the kernel launches of that wrapper,
and ``launch_shapes()`` breaks them down by the shape of the call.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["score_residual_argmax", "score_residual_argmax_plain",
           "score_residual_argmax_batched", "score_residual_argmax_batched_plain",
           "small_table_lookup", "small_table_lookup_plain",
           "ising_integrand_fused", "ising_integrand_plain",
           "launch_counts", "launch_shapes", "reset_launch_counts"]

_THREADS = 256             # kThreads: a block of kernel B
_TILE_THREADS = 512        # kTileThreads: a block of the 2-D kernel
_FIBER_THREADS = 128       # a fiber block, unless the fiber is longer than a cluster's pass
_FIBER_THREADS_MAX = 512   # kFiberThreadsMax
_CLUSTER_MAX = 16          # blocks of a (non-portable) thread block cluster
SMEM_OPTIN = 232_448       # shared memory one block may use on Hopper (227 KB)
_FIBER_SMEM = SMEM_OPTIN - 1024   # dynamic shared memory budget of a fiber block
TILE = (64, 64)            # kBM x kBN of the 2-D kernel
_TILE_KC = 32              # kKC: R is walked in chunks of 32
# kTileSmem: three stages of colf (64 x 36), rowf (32 x 68) and vals
# (64 x 68) doubles and of the mask (64 x 80 bytes)
_TILE_SMEM = 3 * ((64 * 36 + 32 * 68 + 64 * 68) * 8 + 64 * 80)
_LOOKUP_SMEM = 48 * 1024   # static limit of dynamic shared memory per block
_LOOKUP_BLOCKS_PER_SM = 8
_ROWS_THREADS = 128        # kRowsThreads: rows of a block of the integrand's row path
_ROWS_D_MAX = 8            # kRowsDMax: the row path takes d up to this
_WARP_D_MAX = 1024         # kWarpDMax: the warp path takes d up to this
_WARPS = 8                 # warps of a block of the warp path, fewer if shared memory asks
_ROWS_STATIC_SMEM = 4 * (_ROWS_THREADS * _ROWS_D_MAX + 4)   # the row path's index tile
_ATERM_LOOP_D = 96         # above this d the plain a-term loops over columns
ISING_KINDS = {"C": 1, "D": 2, "E": 3}   # test_crs_ising.f90:206-212
_F64 = (torch.float64,)
_MASK = (torch.bool, torch.uint8)
_I32 = (torch.int32,)

_SHAPES = collections.Counter()   # launches by (wrapper name, shape of the call)

COL, ROW, TWO_D = 0, 1, 2  # kernel A's paths (`path` of csrc's entry point)
BATCH_COL, BATCH_ROW = 3, 4  # ... and of its entry point batched over bonds


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load()
    if ((lib.ttc_threads_per_block(), lib.ttc_tile_threads(), lib.ttc_tile_smem(),
         lib.ttc_integrand_rows_threads(), lib.ttc_integrand_rows_d_max(),
         lib.ttc_integrand_warp_d_max())
            != (_THREADS, _TILE_THREADS, _TILE_SMEM, _ROWS_THREADS, _ROWS_D_MAX, _WARP_D_MAX)):
        raise RuntimeError("the constants of csrc/kernels.cu disagree with ops/kernels.py")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """Streaming multiprocessors of device `index`, after allowing the
    kernels there the shared memory that _plan may ask for (once per
    device)."""
    with torch.cuda.device(index):
        _raise_on(_lib().ttc_configure(_FIBER_SMEM), "ttc_configure")
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _call(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) on dev's current stream, switching the current
    device only when it is another."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


# ------------------------------------------------------------ kernel A
class Plan(NamedTuple):
    """Kernel A's launch for one shape (see csrc/kernels.cu)."""
    path: int               # COL (K = 1), ROW (M = 1), TWO_D, or BATCH_COL / BATCH_ROW
    blocks: int             # grid size
    threads: int            # block size
    cluster: int            # blocks per cluster: the whole grid of a fiber, else 1
    smem: int               # dynamic shared memory per block, bytes
    tile: tuple[int, int]   # (rows, cols) one block scores per step
    nparts: int             # partials in the scratch buffer (per warp / per block)


@functools.lru_cache(maxsize=1024)
def _plan(M: int, K: int, R: int, sms: int, bonds: int = 0) -> Plan:
    """Launch geometry of kernel A for vals (M, K) and rank R on a card
    with `sms` streaming multiprocessors; with bonds > 0, for `bonds` such
    fibers in one launch.

    A fiber (K = 1 or M = 1) is one cluster of up to _CLUSTER_MAX blocks
    with one partial per warp; block b scores tiles b, b + blocks, ... of
    `threads` elements (one per thread).  A block holds its tile's factor
    in shared memory (`threads` rows of colf, or R rows of `threads`
    columns of rowf), so a large R gets fewer threads.  The 2-D path is a
    persistent grid of at most one block per SM; block b scores tiles b,
    b + blocks, ... of the row-major grid of TILE tiles.

    Batched over bonds (the all-bonds sweeps: 254 or 1022 fibers of 170
    elements): one block per bond and no cluster; the block walks its
    bond's fiber in tiles of `threads` elements, staged as a fiber block
    stages them, and reduces it alone (no scratch partials)."""
    if M < 1 or K < 1 or R < 0 or bonds < 0:
        raise ValueError(f"no kernel-A launch for ({M}, {K}) at rank {R}")
    if bonds:
        if M != 1 and K != 1:
            raise ValueError(f"the batched kernel A takes fibers (K = 1 or M = 1), not ({M}, {K})")
        col = K == 1
        length = M if col else K
        fit = (_FIBER_SMEM - 8 * R - 16) // max(8 * R, 1) // 32 * 32
        threads = min(-(-length // 32) * 32, _FIBER_THREADS_MAX, fit)
        if threads < 32:
            raise ValueError(f"rank {R} exceeds the fiber kernel's shared memory")
        return Plan(BATCH_COL if col else BATCH_ROW, bonds, threads, 1,
                    8 * R + 16 + 8 * threads * R,
                    (threads, 1) if col else (1, threads), 0)
    if M == 1 or K == 1:
        col = K == 1
        length = M if col else K
        # enough threads that one cluster covers the fiber in a pass, at
        # least _FIBER_THREADS, at most what shared memory holds: the tile's
        # R doubles per element, the R-vector and 16 bytes of alignment slack
        want = max(_FIBER_THREADS, -(-length // (32 * _CLUSTER_MAX)) * 32)
        fit = (_FIBER_SMEM - 8 * R - 16) // max(8 * R, 1) // 32 * 32
        threads = min(want, _FIBER_THREADS_MAX, fit)
        smem = 8 * R + 16 + 8 * threads * R
        if threads < 32:
            raise ValueError(f"rank {R} exceeds the fiber kernel's shared memory")
        blocks = min(_CLUSTER_MAX, -(-length // threads))
        return Plan(COL if col else ROW, blocks, threads, blocks, smem,
                    (threads, 1) if col else (1, threads), blocks * threads // 32)
    tiles = -(-M // TILE[0]) * -(-K // TILE[1])
    if tiles * max(1, -(-R // _TILE_KC)) >= 2 ** 31:
        raise ValueError(f"matrix {M} x {K} at rank {R} exceeds the 2-D kernel's 32-bit walk")
    blocks = min(tiles, sms)
    return Plan(TWO_D, blocks, _TILE_THREADS, 1, _TILE_SMEM, TILE, blocks)


def score_residual_argmax_plain(vals, colf, rowf, mask):
    """Flat argmax of the masked |vals - colf @ rowf|.

    vals (M, K), colf (M, R), rowf (R, K) float64; mask (M, K) bool or
    uint8.  Returns 0-d tensors (flat int64, score, signed residual at
    flat); masked entries score -1, the first maximum wins and NaN ranks
    above every number (torch.argmax semantics)."""
    resid = (vals - colf @ rowf).reshape(-1)
    score = torch.where(mask.reshape(-1).bool(), resid.abs(), -1.0)
    flat = torch.argmax(score)
    sel = flat.view(1)
    return flat, score.index_select(0, sel)[0], resid.index_select(0, sel)[0]


def score_residual_argmax(vals, colf, rowf, mask):
    """Masked |residual| argmax, (flat int64, score, residual) as 0-d tensors.

    Replaces ttcross_tpu/ops/pallas_kernels.py::score_residual_argmax
    (:62-120; Pallas body :39-59).  On a CPU tensor this is
    score_residual_argmax_plain; on a CUDA tensor it launches kernel A of
    csrc/kernels.cu as _plan lays it out (a fiber: one cluster launch; a
    2-D shape: the DMMA kernel and its one-block reduction) and adds one to
    ``score_residual_argmax.launches``.  The results are views of one
    buffer allocated per call."""
    if vals.device.type == "cpu":
        return score_residual_argmax_plain(vals, colf, rowf, mask)
    dev = vals.device
    _check_cuda("vals", vals, _F64, 2, dev)
    _check_cuda("colf", colf, _F64, 2, dev)
    _check_cuda("rowf", rowf, _F64, 2, dev)
    _check_cuda("mask", mask, _MASK, 2, dev)
    M, K = vals.shape
    R = colf.shape[1]
    if colf.shape[0] != M or rowf.shape != (R, K) or mask.shape != (M, K):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, colf "
                         f"{tuple(colf.shape)}, rowf {tuple(rowf.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if M * K == 0:
        raise ValueError("score_residual_argmax of an empty matrix")
    plan = _plan(M, K, R, _sms(dev.index))
    # 8-byte words: [index, score, residual, nparts scores, indices, residuals]
    buf = torch.empty(3 + 3 * plan.nparts, dtype=torch.int64, device=dev)
    rc = _call(dev, _lib().ttc_score_residual_argmax, vals.data_ptr(),
               colf.data_ptr(), rowf.data_ptr(), mask.data_ptr(), M, K, R,
               plan.path, plan.blocks, plan.threads, plan.smem, buf.data_ptr())
    _raise_on(rc, "score_residual_argmax launch")
    score_residual_argmax.launches += 1
    _SHAPES["score_residual_argmax", (M, K, R)] += 1
    f64 = buf[:3].view(torch.float64)
    return buf[0], f64[1], f64[2]


score_residual_argmax.launches = 0


def score_residual_argmax_batched_plain(vals, colf, rowf, mask):
    """score_residual_argmax_plain for every bond of a stack.

    vals (P, M, K), colf (P, M, R), rowf (P, R, K) float64; mask (P, M, K)
    bool or uint8.  Returns three (P,) tensors (flat int64 in each bond's
    row-major (M, K), score, signed residual at flat): per bond, masked
    entries score -1, the first maximum wins, NaN ranks above every
    number, and a bond whose mask is all false gives flat 0 and score -1."""
    P = vals.shape[0]
    resid = (vals - colf @ rowf).reshape(P, -1)
    score = torch.where(mask.reshape(P, -1).bool(), resid.abs(), -1.0)
    flat = torch.argmax(score, dim=1)
    sel = flat[:, None]
    return flat, score.gather(1, sel)[:, 0], resid.gather(1, sel)[:, 0]


def score_residual_argmax_batched(vals, colf, rowf, mask):
    """Masked |residual| argmax of P fibers at once, three (P,) tensors
    (flat int64, score, residual): kernel A batched over bonds, for the
    all-bonds sweeps (ttcross_tpu/cross/engine_jacobi.py:237-242, 269-274
    compute it per bond with XLA ops in f32 and recompute the pivot in f64).

    Only fibers: vals (P, M, 1) with colf (P, M, R), rowf (P, R, 1), or
    vals (P, 1, K) with colf (P, 1, R), rowf (P, R, K).  On a CPU tensor
    this is score_residual_argmax_batched_plain; on a CUDA tensor it is ONE
    launch of csrc/kernels.cu's batched fiber kernel as _plan lays it out
    (a block per bond), and adds one to
    ``score_residual_argmax_batched.launches``.  Each element's sum runs
    in the single-fiber kernel's order, so the result equals P calls of
    score_residual_argmax bit for bit.  The results are views of one
    buffer allocated per call."""
    if vals.device.type == "cpu":
        return score_residual_argmax_batched_plain(vals, colf, rowf, mask)
    dev = vals.device
    _check_cuda("vals", vals, _F64, 3, dev)
    _check_cuda("colf", colf, _F64, 3, dev)
    _check_cuda("rowf", rowf, _F64, 3, dev)
    _check_cuda("mask", mask, _MASK, 3, dev)
    P, M, K = vals.shape
    R = colf.shape[2]
    if colf.shape != (P, M, R) or rowf.shape != (P, R, K) or mask.shape != (P, M, K):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, colf "
                         f"{tuple(colf.shape)}, rowf {tuple(rowf.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if P * M * K == 0:
        raise ValueError("score_residual_argmax_batched of an empty stack")
    plan = _plan(M, K, R, _sms(dev.index), bonds=P)
    buf = torch.empty(3 * P, dtype=torch.int64, device=dev)   # [indices, scores, residuals]
    rc = _call(dev, _lib().ttc_score_residual_argmax_batched, vals.data_ptr(),
               colf.data_ptr(), rowf.data_ptr(), mask.data_ptr(), P, M * K, R,
               int(plan.path == BATCH_COL), plan.threads, plan.smem, buf.data_ptr())
    _raise_on(rc, "score_residual_argmax_batched launch")
    score_residual_argmax_batched.launches += 1
    _SHAPES["score_residual_argmax_batched", (P, M, K, R)] += 1
    f64 = buf.view(torch.float64)
    return buf[:P], f64[P:2 * P], f64[2 * P:]


score_residual_argmax_batched.launches = 0


# ------------------------------------------------------------ kernel B
def small_table_lookup_plain(tables, ind):
    """out[l, b, j] = tables[l, ind[b, j]], 0 where ind is outside [0, n).

    tables (L, n) float64, ind (B, d) int32 -> (L, B, d) float64."""
    n = tables.shape[1]
    ok = (ind >= 0) & (ind < n)
    vals = tables[:, ind.clamp(0, n - 1).long()]
    return torch.where(ok, vals, torch.zeros((), dtype=tables.dtype,
                                             device=tables.device))


def small_table_lookup(tables, ind):
    """Gather from L small f64 tables with one launch, (L, B, d) float64.

    Replaces ttcross_tpu/ops/pallas_kernels.py::small_table_lookup_limbs
    (:151-197; Pallas body :127-148).  On a CPU tensor this is
    small_table_lookup_plain; on a CUDA tensor it launches the
    shared-memory gather of csrc/kernels.cu and adds one to
    ``small_table_lookup.launches``."""
    if tables.device.type == "cpu":
        return small_table_lookup_plain(tables, ind)
    dev = tables.device
    _check_cuda("tables", tables, _F64, 2, dev)
    _check_cuda("ind", ind, _I32, 2, dev)
    L, n = tables.shape
    if L * n * 8 > _LOOKUP_SMEM:
        raise ValueError(f"tables ({L}, {n}) exceed the kernel's "
                         f"{_LOOKUP_SMEM}-byte shared-memory budget")
    B, d = ind.shape
    E = B * d
    out = torch.empty((L, B, d), dtype=torch.float64, device=dev)
    if E == 0:
        return out
    blocks = min(-(-E // _THREADS), _LOOKUP_BLOCKS_PER_SM * _sms(dev.index))
    rc = _call(dev, _lib().ttc_small_table_lookup, tables.data_ptr(), L, n,
               ind.data_ptr(), E, out.data_ptr(), blocks)
    _raise_on(rc, "small_table_lookup launch")
    small_table_lookup.launches += 1
    _SHAPES["small_table_lookup", (L, B, d, n)] += 1
    return out


small_table_lookup.launches = 0


# ------------------------------------------------- the fused Ising integrand
ROWS, WARPS = 0, 1          # the integrand kernel's paths (`path` of csrc's entry point)


class IntegrandPlan(NamedTuple):
    """The fused integrand's launch for one shape (see csrc/kernels.cu)."""
    path: int               # ROWS (a row per thread) or WARPS (a row per warp)
    blocks: int             # grid size
    threads: int            # block size
    smem: int               # dynamic shared memory per block, bytes
    rows: int               # rows one block evaluates (a thread's or a warp's each)


@functools.lru_cache(maxsize=1024)
def _integrand_plan(B: int, d: int, n: int) -> IntegrandPlan:
    """Launch geometry of the fused integrand for ind (B, d) and an n-point
    table.  Up to _ROWS_D_MAX variables a thread takes a row, else a warp
    does; a block's shared memory holds the n (node, weight) pairs and, on
    the warp path, each warp's row of indices and its prefix products with
    the pitches csrc computes, within the 48 KB a block gets without
    opting in."""
    if B < 0 or not 1 <= d <= _WARP_D_MAX or n < 1:
        raise ValueError(f"no fused-integrand launch for ({B}, {d}) with n = {n}: "
                         f"the kernel takes 1 <= d <= {_WARP_D_MAX}")
    table = 16 * n
    if d <= _ROWS_D_MAX:
        if table + _ROWS_STATIC_SMEM > _LOOKUP_SMEM:
            raise ValueError(f"a table of {n} points exceeds the kernel's shared memory")
        return IntegrandPlan(ROWS, -(-B // _ROWS_THREADS), _ROWS_THREADS, table,
                             _ROWS_THREADS)
    per_warp = 4 * (4 * ((d + 6) // 4)) + 8 * (2 * ((d + 2) // 2))   # ipitch ints, ppitch doubles
    warps = min(_WARPS, (_LOOKUP_SMEM - table) // per_warp)
    if warps < 1:
        raise ValueError(f"a table of {n} points and rows of {d} exceed the kernel's "
                         "shared memory")
    return IntegrandPlan(WARPS, -(-B // warps), 32 * warps, table + warps * per_warp, warps)


def ising_integrand_plain(tables, ind, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    tables (2, n): the nodes and the rescaled weights, looked up with
    small_table_lookup_plain (0 outside [0, n)).  kind 'C' -> 2b,
    'D' -> 2ab, 'E' -> 2a, each times the product of weights."""
    kid = ISING_KINDS[kind.upper()]
    x, w = small_table_lookup_plain(tables, ind)       # (B, d) each
    B, d = x.shape
    f = torch.full((B,), 2.0, dtype=x.dtype, device=x.device)
    if kid in (2, 3):  # a-term
        one = torch.ones((B, 1), dtype=x.dtype, device=x.device)
        P = torch.cat([one, torch.cumprod(x, dim=1)], dim=1)    # (B, d+1)
        if d <= _ATERM_LOOP_D:
            num = P[:, None, :] - P[:, :, None]   # P_j - P_i at [b, i, j]
            den = P[:, None, :] + P[:, :, None]
            ratio = torch.where(den == 0, 0.0, num / den) ** 2
            iu = torch.triu(torch.ones((d + 1, d + 1), dtype=torch.bool,
                                       device=x.device), diagonal=1)
            a = torch.where(iu, ratio, 1.0).reshape(B, (d + 1) ** 2).prod(dim=1)
        else:
            # large d: a loop over j keeps memory at O(B d), not O(B d^2)
            jdx = torch.arange(d + 1, device=x.device)
            a = torch.ones((B,), dtype=x.dtype, device=x.device)
            for j in range(d + 1):
                col = P[:, j:j + 1]
                r = torch.where((jdx[None, :] < j) & (col + P != 0),
                                (col - P) / (col + P), 1.0)
                a = a * (r * r).prod(dim=1)
        f = f * a
    if kid in (1, 2):  # b-term
        pre = torch.cumprod(x, dim=1)              # prefix products
        suf = torch.cumprod(x.flip(1), dim=1)      # suffix products
        v = 1.0 + suf.sum(dim=1)
        wv = 1.0 + pre.sum(dim=1)
        f = f / (v * wv)
    return f * w.prod(dim=1)


def ising_integrand_fused(tables, ind, kind: str):
    """The Ising integrand in one launch, (B,) float64.

    Kernel B's redesign: replaces ttcross_tpu/ops/pallas_kernels.py::
    small_table_lookup_limbs (:151-197) on the integrand's path, with the
    chain of ttcross_tpu/apps/ising.py::ising_integrand (:50-90) fused in.
    On a CPU tensor this is ising_integrand_plain; on a CUDA tensor it
    launches the fused kernel of csrc/kernels.cu as _integrand_plan lays it
    out and adds one to ``ising_integrand_fused.launches``."""
    if ind.device.type == "cpu":
        return ising_integrand_plain(tables, ind, kind)
    kid = ISING_KINDS[kind.upper()]
    dev = ind.device
    _check_cuda("ind", ind, _I32, 2, dev)
    _check_cuda("tables", tables, _F64, 2, dev)
    if tables.shape[0] != 2:
        raise ValueError(f"tables must be (2, n): nodes and weights, got {tuple(tables.shape)}")
    B, d = ind.shape
    n = tables.shape[1]
    plan = _integrand_plan(B, d, n)
    out = torch.empty((B,), dtype=torch.float64, device=dev)
    if B == 0:
        return out
    den0 = 0.0 if d <= _ATERM_LOOP_D else 1.0   # the plain a-term's ratio where P_j + P_i = 0
    rc = _call(dev, _lib().ttc_ising_integrand, tables.data_ptr(), n, ind.data_ptr(), B, d,
               kid, plan.path, plan.blocks, plan.threads, plan.smem, den0, out.data_ptr())
    _raise_on(rc, "ising_integrand_fused launch")
    ising_integrand_fused.launches += 1
    _SHAPES["ising_integrand_fused", (B, d, n)] += 1
    return out


ising_integrand_fused.launches = 0

_WRAPPERS = (score_residual_argmax, score_residual_argmax_batched, small_table_lookup,
             ising_integrand_fused)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def launch_shapes() -> dict[str, dict[tuple, int]]:
    """The launches since the last reset by the shape of the call, per
    wrapper: kernel A (M, K, R), batched (P, M, K, R), the lookup
    (L, B, d, n), the fused integrand (B, d, n)."""
    out = {f.__name__: {} for f in _WRAPPERS}
    for (name, shape), count in _SHAPES.items():
        out[name][shape] = count
    return out


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0
    _SHAPES.clear()
