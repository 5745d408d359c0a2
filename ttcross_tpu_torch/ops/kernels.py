"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their launch counters: kernel A (the masked residual argmax), kernel B
(the small-table lookup) and kernel B's redesign, the fused Ising
integrand; the dd tier's kernels (csrc/dd_kernels.cu): D1 the dd
residual argmax, D2 the dd Ising integrand, D3 the dd train gather, D4 the
small dd GEMM; and the qd tier's (csrc/qd_kernels.cu): Q1 the qd Ising
integrand, Q2 the qd residual argmax, Q3 the qd train gather, Q4 the small
qd product.

Counterpart of ttcross_tpu/ops/pallas_kernels.py.  The CUDA sources are
``csrc/kernels.cu``, ``csrc/dd_kernels.cu`` and ``csrc/qd_kernels.cu`` (built into one library by
``ops/_build.py``).  Each wrapper routes a
tensor that lies on the CPU to the plain version and a CUDA tensor to the
kernel; on a CUDA tensor it launches the kernel or raises, never falling
back.  Every kernel has a float64 and a float32 instantiation (the f32
tier): a wrapper launches the one of its inputs' dtype, which must be one
of the two and the same for every floating input (TypeError otherwise; no
input is converted).  ``<wrapper>.launches`` counts the kernel launches of
that wrapper, and ``launch_shapes()`` breaks them down by the shape of the
call, an f32 launch's shape ending in "f32".
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["score_residual_argmax", "score_residual_argmax_plain",
           "score_residual_argmax_batched", "score_residual_argmax_batched_plain",
           "small_table_lookup", "small_table_lookup_plain",
           "ising_integrand_fused", "ising_integrand_plain",
           "dd_score_residual_argmax", "dd_score_residual_argmax_plain", "dd_dot", "dd_dot_plain",
           "dd_gather_tt_fused", "dd_gather_tt_plain", "PackedTT", "pack_tt",
           "ising_c_integrand_dd_fused", "ising_c_integrand_dd_plain",
           "qd_score_residual_argmax", "qd_score_residual_argmax_plain", "qd_dot", "qd_dot_plain",
           "qd_gather_tt_fused", "qd_gather_tt_plain", "ising_c_integrand_qd_fused",
           "ising_c_integrand_qd_plain",
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
_SIMT_THREADS = 256        # kSimtThreads: a block of the f32 2-D kernel (static shared memory)
_SIMT_BLOCKS_PER_SM = 4
_LOOKUP_SMEM = 48 * 1024   # static limit of dynamic shared memory per block
_LOOKUP_BLOCKS_PER_SM = 8
_ROWS_THREADS = 128        # kRowsThreads: rows of a block of the integrand's row path
_ROWS_D_MAX = 8            # kRowsDMax: the row path takes d up to this
_WARP_D_MAX = 1024         # kWarpDMax: the warp path takes d up to this
_WARPS = 8                 # warps of a block of the warp path, fewer if shared memory asks
_ROWS_STATIC_SMEM = 4 * (_ROWS_THREADS * _ROWS_D_MAX + 4)   # the row path's index tile
_ATERM_LOOP_D = 96         # above this d the plain a-term loops over columns
ISING_KINDS = {"C": 1, "D": 2, "E": 3}   # test_crs_ising.f90:206-212
_REAL = (torch.float64, torch.float32)
_MASK = (torch.bool, torch.uint8)
_I32 = (torch.int32,)

_SHAPES = collections.Counter()   # launches by (wrapper name, shape of the call)

COL, ROW, TWO_D = 0, 1, 2  # kernel A's paths (`path` of csrc's entry point)
BATCH_COL, BATCH_ROW = 3, 4  # ... and of its entry point batched over bonds


def _launchable(*tensors):
    """The tensors a kernel launches on.  Under torch.func.grad every tensor
    an op makes is wrapped, also a constant of the differentiated function
    (no gradient flows through it): such a wrapper is taken off, and the
    wrapper's launch then runs outside the transforms
    (torch._C._DisableFuncTorch), so that its output is a plain tensor the
    transform takes as a constant.  A tensor that torch.func.vmap batches,
    or that carries a gradient, raises a TypeError: the kernel computes
    neither a batch rule nor a derivative."""
    out = []
    for t in tensors:
        while torch._C._functorch.is_functorch_wrapped_tensor(t):
            if torch._C._functorch.is_batchedtensor(t) or t.requires_grad:
                raise TypeError("a hand kernel cannot run on a tensor that torch.func.vmap "
                                "batches or that carries a gradient; give the integrand a "
                                "lane-batched form (cross/batch.py::lane_batched) and keep "
                                "the kernel's inputs free of the differentiated parameters")
            t = torch._C._functorch.get_unwrapped(t)
        out.append(t)
    return out


def _tag(dtype) -> tuple:
    """What an f32 launch appends to its shape in launch_shapes()."""
    return ("f32",) if dtype == torch.float32 else ()


def _entry(name: str, dtype):
    """The library's entry point `name` for this scalar type."""
    return getattr(_lib(), name + ("_f32" if dtype == torch.float32 else ""))


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
         lib.ttc_simt_threads(), lib.ttc_integrand_rows_threads(), lib.ttc_integrand_rows_d_max(),
         lib.ttc_integrand_warp_d_max())
            != (_THREADS, _TILE_THREADS, _TILE_SMEM, _SIMT_THREADS, _ROWS_THREADS, _ROWS_D_MAX,
                _WARP_D_MAX)):
        raise RuntimeError("the constants of csrc/kernels.cu disagree with ops/kernels.py")
    if ((lib.ttd_threads(), lib.ttd_cluster_max(), lib.ttd_gather_rmax())
            != (_DD_THREADS, _DD_CLUSTER_MAX, _DD_GATHER_RMAX)):
        raise RuntimeError("the constants of csrc/dd_kernels.cu disagree with ops/kernels.py")
    if ((lib.ttq_threads(), lib.ttq_rows_threads(), lib.ttq_gather_rmax(), lib.ttq_tree_max())
            != (_QD_THREADS, _QD_ROWS_THREADS, _QD_GATHER_RMAX, _QD_TREE_MAX)):
        raise RuntimeError("the constants of csrc/qd_kernels.cu disagree with ops/kernels.py")
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
def _plan(M: int, K: int, R: int, sms: int, bonds: int = 0, esz: int = 8) -> Plan:
    """Launch geometry of kernel A for vals (M, K) and rank R on a card
    with `sms` streaming multiprocessors; with bonds > 0, for `bonds` such
    fibers in one launch; esz: the bytes of an element (8: f64, 4: f32).

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
    stages them, and reduces it alone (no scratch partials).  A fiber
    block's shared memory is its tile's factor (`threads` x R elements),
    the R-vector and the slack of a COL tile's 16-byte copies (2 * 16 - 2 *
    esz bytes).  The f32 2-D path is the SIMT kernel: a persistent grid of
    up to _SIMT_BLOCKS_PER_SM blocks per SM over the same tiles, its
    shared memory static."""
    if esz not in (4, 8):
        raise ValueError(f"no kernel-A instantiation for {esz}-byte elements")
    slack = 2 * 16 - 2 * esz
    if M < 1 or K < 1 or R < 0 or bonds < 0:
        raise ValueError(f"no kernel-A launch for ({M}, {K}) at rank {R}")
    if bonds:
        if M != 1 and K != 1:
            raise ValueError(f"the batched kernel A takes fibers (K = 1 or M = 1), not ({M}, {K})")
        col = K == 1
        length = M if col else K
        fit = (_FIBER_SMEM - esz * R - slack) // max(esz * R, 1) // 32 * 32
        threads = min(-(-length // 32) * 32, _FIBER_THREADS_MAX, fit)
        if threads < 32:
            raise ValueError(f"rank {R} exceeds the fiber kernel's shared memory")
        return Plan(BATCH_COL if col else BATCH_ROW, bonds, threads, 1,
                    esz * R + slack + esz * threads * R,
                    (threads, 1) if col else (1, threads), 0)
    if M == 1 or K == 1:
        col = K == 1
        length = M if col else K
        # enough threads that one cluster covers the fiber in a pass, at
        # least _FIBER_THREADS, at most what shared memory holds: the tile's
        # R elements per element, the R-vector and the alignment slack
        want = max(_FIBER_THREADS, -(-length // (32 * _CLUSTER_MAX)) * 32)
        fit = (_FIBER_SMEM - esz * R - slack) // max(esz * R, 1) // 32 * 32
        threads = min(want, _FIBER_THREADS_MAX, fit)
        smem = esz * R + slack + esz * threads * R
        if threads < 32:
            raise ValueError(f"rank {R} exceeds the fiber kernel's shared memory")
        blocks = min(_CLUSTER_MAX, -(-length // threads))
        return Plan(COL if col else ROW, blocks, threads, blocks, smem,
                    (threads, 1) if col else (1, threads), blocks * threads // 32)
    tiles = -(-M // TILE[0]) * -(-K // TILE[1])
    if esz == 4:
        blocks = min(tiles, _SIMT_BLOCKS_PER_SM * sms)
        return Plan(TWO_D, blocks, _SIMT_THREADS, 1, 0, TILE, blocks)
    if tiles * max(1, -(-R // _TILE_KC)) >= 2 ** 31:
        raise ValueError(f"matrix {M} x {K} at rank {R} exceeds the 2-D kernel's 32-bit walk")
    blocks = min(tiles, sms)
    return Plan(TWO_D, blocks, _TILE_THREADS, 1, _TILE_SMEM, TILE, blocks)


def score_residual_argmax_plain(vals, colf, rowf, mask):
    """Flat argmax of the masked |vals - colf @ rowf|.

    vals (M, K), colf (M, R), rowf (R, K) float64 or float32; mask (M, K)
    bool or uint8.  Returns 0-d tensors (flat int64, score, signed residual
    at flat); masked entries score -1, the first maximum wins and NaN ranks
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
    2-D shape: the DMMA kernel in f64, the SIMT kernel in f32, then a
    one-block reduction) and adds one to ``score_residual_argmax.launches``.
    The results are views of one buffer allocated per call, the score and
    the residual of the inputs' dtype."""
    if vals.device.type == "cpu":
        return score_residual_argmax_plain(vals, colf, rowf, mask)
    vals, colf, rowf, mask = _launchable(vals, colf, rowf, mask)
    with torch._C._DisableFuncTorch():     # plain tensors from here on
        dev = vals.device
        dt = vals.dtype
        _check_cuda("vals", vals, _REAL, 2, dev)
        _check_cuda("colf", colf, (dt,), 2, dev)
        _check_cuda("rowf", rowf, (dt,), 2, dev)
        _check_cuda("mask", mask, _MASK, 2, dev)
        M, K = vals.shape
        R = colf.shape[1]
        if colf.shape[0] != M or rowf.shape != (R, K) or mask.shape != (M, K):
            raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, colf "
                             f"{tuple(colf.shape)}, rowf {tuple(rowf.shape)}, "
                             f"mask {tuple(mask.shape)}")
        if M * K == 0:
            raise ValueError("score_residual_argmax of an empty matrix")
        plan = _plan(M, K, R, _sms(dev.index), esz=vals.element_size())
        # 8-byte words: [index, score, residual, nparts scores, indices,
        # residuals]; an f32 score or residual at the start of its word
        buf = torch.empty(3 + 3 * plan.nparts, dtype=torch.int64, device=dev)
        rc = _call(dev, _entry("ttc_score_residual_argmax", dt), vals.data_ptr(),
                   colf.data_ptr(), rowf.data_ptr(), mask.data_ptr(), M, K, R,
                   plan.path, plan.blocks, plan.threads, plan.smem, buf.data_ptr())
        _raise_on(rc, "score_residual_argmax launch")
        score_residual_argmax.launches += 1
        _SHAPES["score_residual_argmax", (M, K, R) + _tag(dt)] += 1
        per = 8 // vals.element_size()     # elements of the dtype per word
        v = buf[:3].view(dt)
        return buf[0], v[per], v[2 * per]


score_residual_argmax.launches = 0


def score_residual_argmax_batched_plain(vals, colf, rowf, mask):
    """score_residual_argmax_plain for every bond of a stack.

    vals (P, M, K), colf (P, M, R), rowf (P, R, K) float64 or float32;
    mask (P, M, K) bool or uint8.  Returns three (P,) tensors (flat int64 in each bond's
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
    vals, colf, rowf, mask = _launchable(vals, colf, rowf, mask)
    with torch._C._DisableFuncTorch():     # plain tensors from here on
        dev = vals.device
        dt = vals.dtype
        _check_cuda("vals", vals, _REAL, 3, dev)
        _check_cuda("colf", colf, (dt,), 3, dev)
        _check_cuda("rowf", rowf, (dt,), 3, dev)
        _check_cuda("mask", mask, _MASK, 3, dev)
        P, M, K = vals.shape
        R = colf.shape[2]
        if colf.shape != (P, M, R) or rowf.shape != (P, R, K) or mask.shape != (P, M, K):
            raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, colf "
                             f"{tuple(colf.shape)}, rowf {tuple(rowf.shape)}, "
                             f"mask {tuple(mask.shape)}")
        if P * M * K == 0:
            raise ValueError("score_residual_argmax_batched of an empty stack")
        plan = _plan(M, K, R, _sms(dev.index), bonds=P, esz=vals.element_size())
        # 8-byte words: [P indices, P scores, P residuals]; f32 scores and
        # residuals packed from the start of their P words
        buf = torch.empty(3 * P, dtype=torch.int64, device=dev)
        rc = _call(dev, _entry("ttc_score_residual_argmax_batched", dt), vals.data_ptr(),
                   colf.data_ptr(), rowf.data_ptr(), mask.data_ptr(), P, M * K, R,
                   int(plan.path == BATCH_COL), plan.threads, plan.smem, buf.data_ptr())
        _raise_on(rc, "score_residual_argmax_batched launch")
        score_residual_argmax_batched.launches += 1
        _SHAPES["score_residual_argmax_batched", (P, M, K, R) + _tag(dt)] += 1
        per = 8 // vals.element_size()
        v = buf.view(dt)
        return buf[:P], v[per * P:per * P + P], v[2 * per * P:2 * per * P + P]


score_residual_argmax_batched.launches = 0


# ------------------------------------------------------------ kernel B
def small_table_lookup_plain(tables, ind):
    """out[l, b, j] = tables[l, ind[b, j]], 0 where ind is outside [0, n).

    tables (L, n) float64 or float32, ind (B, d) int32 -> (L, B, d) of the
    tables' dtype."""
    n = tables.shape[1]
    ok = (ind >= 0) & (ind < n)
    vals = tables[:, ind.clamp(0, n - 1).long()]
    return torch.where(ok, vals, torch.zeros((), dtype=tables.dtype,
                                             device=tables.device))


def small_table_lookup(tables, ind):
    """Gather from L small tables with one launch, (L, B, d) of the tables'
    dtype (float64 or float32).

    Replaces ttcross_tpu/ops/pallas_kernels.py::small_table_lookup_limbs
    (:151-197; Pallas body :127-148).  On a CPU tensor this is
    small_table_lookup_plain; on a CUDA tensor it launches the
    shared-memory gather of csrc/kernels.cu and adds one to
    ``small_table_lookup.launches``."""
    if tables.device.type == "cpu":
        return small_table_lookup_plain(tables, ind)
    tables, ind = _launchable(tables, ind)
    with torch._C._DisableFuncTorch():     # plain tensors from here on
        dev = tables.device
        dt = tables.dtype
        _check_cuda("tables", tables, _REAL, 2, dev)
        _check_cuda("ind", ind, _I32, 2, dev)
        L, n = tables.shape
        if L * n * tables.element_size() > _LOOKUP_SMEM:
            raise ValueError(f"tables ({L}, {n}) exceed the kernel's "
                             f"{_LOOKUP_SMEM}-byte shared-memory budget")
        B, d = ind.shape
        E = B * d
        out = torch.empty((L, B, d), dtype=dt, device=dev)
        if E == 0:
            return out
        blocks = min(-(-E // _THREADS), _LOOKUP_BLOCKS_PER_SM * _sms(dev.index))
        rc = _call(dev, _entry("ttc_small_table_lookup", dt), tables.data_ptr(), L, n,
                   ind.data_ptr(), E, out.data_ptr(), blocks)
        _raise_on(rc, "small_table_lookup launch")
        small_table_lookup.launches += 1
        _SHAPES["small_table_lookup", (L, B, d, n) + _tag(dt)] += 1
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
def _integrand_plan(B: int, d: int, n: int, esz: int = 8) -> IntegrandPlan:
    """Launch geometry of the fused integrand for ind (B, d) and an n-point
    table of esz-byte elements (8: f64, 4: f32).  Up to _ROWS_D_MAX
    variables a thread takes a row, else a warp does; a block's shared
    memory holds the n (node, weight) pairs (rounded up to 16 bytes) and,
    on the warp path, each warp's row of indices and its prefix products
    with the pitches csrc computes, within the 48 KB a block gets without
    opting in."""
    if B < 0 or not 1 <= d <= _WARP_D_MAX or n < 1 or esz not in (4, 8):
        raise ValueError(f"no fused-integrand launch for ({B}, {d}) with n = {n} of "
                         f"{esz}-byte elements: the kernel takes 1 <= d <= {_WARP_D_MAX}")
    table = -(-2 * esz * n // 16) * 16
    if d <= _ROWS_D_MAX:
        if table + _ROWS_STATIC_SMEM > _LOOKUP_SMEM:
            raise ValueError(f"a table of {n} points exceeds the kernel's shared memory")
        return IntegrandPlan(ROWS, -(-B // _ROWS_THREADS), _ROWS_THREADS, table,
                             _ROWS_THREADS)
    k = 16 // esz                                     # elements per 16 bytes
    per_warp = 4 * (4 * ((d + 6) // 4)) + esz * (k * ((d + k) // k))   # ipitch ints, ppitch elements
    warps = min(_WARPS, (_LOOKUP_SMEM - table) // per_warp)
    if warps < 1:
        raise ValueError(f"a table of {n} points and rows of {d} exceed the kernel's "
                         "shared memory")
    return IntegrandPlan(WARPS, -(-B // warps), 32 * warps, table + warps * per_warp, warps)


def ising_integrand_plain(tables, ind, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    tables (2, n): the nodes and the rescaled weights, float64 or float32
    (the values' dtype), looked up with small_table_lookup_plain (0 outside
    [0, n)).  kind 'C' -> 2b, 'D' -> 2ab, 'E' -> 2a, each times the product
    of weights."""
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
    """The Ising integrand in one launch, (B,) of the tables' dtype
    (float64, or float32: the whole chain in f32).

    Kernel B's redesign: replaces ttcross_tpu/ops/pallas_kernels.py::
    small_table_lookup_limbs (:151-197) on the integrand's path, with the
    chain of ttcross_tpu/apps/ising.py::ising_integrand (:50-90) fused in.
    On a CPU tensor this is ising_integrand_plain; on a CUDA tensor it
    launches the fused kernel of csrc/kernels.cu as _integrand_plan lays it
    out and adds one to ``ising_integrand_fused.launches``."""
    if ind.device.type == "cpu":
        return ising_integrand_plain(tables, ind, kind)
    tables, ind = _launchable(tables, ind)
    with torch._C._DisableFuncTorch():     # plain tensors from here on
        kid = ISING_KINDS[kind.upper()]
        dev = ind.device
        dt = tables.dtype
        _check_cuda("ind", ind, _I32, 2, dev)
        _check_cuda("tables", tables, _REAL, 2, dev)
        if tables.shape[0] != 2:
            raise ValueError(f"tables must be (2, n): nodes and weights, got {tuple(tables.shape)}")
        B, d = ind.shape
        n = tables.shape[1]
        plan = _integrand_plan(B, d, n, tables.element_size())
        out = torch.empty((B,), dtype=dt, device=dev)
        if B == 0:
            return out
        den0 = 0.0 if d <= _ATERM_LOOP_D else 1.0   # the plain a-term's ratio where P_j + P_i = 0
        rc = _call(dev, _entry("ttc_ising_integrand", dt), tables.data_ptr(), n, ind.data_ptr(),
                   B, d, kid, plan.path, plan.blocks, plan.threads, plan.smem, den0,
                   out.data_ptr())
        _raise_on(rc, "ising_integrand_fused launch")
        ising_integrand_fused.launches += 1
        _SHAPES["ising_integrand_fused", (B, d, n) + _tag(dt)] += 1
        return out


ising_integrand_fused.launches = 0

# ------------------------------------------------------------ the dd kernels
# csrc/dd_kernels.cu, linked into the one library.  Each kernel computes in the
# operation order of ops/dd.py with intrinsics nvcc does not contract, so
# it is bit for bit its plain version (the plain versions below are
# ops/dd.py's functions, which the CPU tests hold against the JAX
# package's).
_DD_THREADS = 256          # kThreads: a block of D1, D3, D4
_DD_CLUSTER_MAX = 16       # kClusterMax: D1's cluster
_DD_GATHER_RMAX = 64       # kGatherRMax: D3 takes ranks up to this
_F64 = (torch.float64,)
MASK_NONE, MASK_X, MASK_Y = 0, 1, 2   # the side of the dot that D1's rank mask multiplies


def _check_pair(name: str, x, ndim: int, device) -> None:
    """A dd operand on the card: hi and lo float64 of one shape and one
    layout (strides may be anything, a broadcast's 0 too)."""
    for part in x:
        if part.device != device:
            raise ValueError(f"{name} must lie on {device}, got {part.device}")
        if part.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 (hi, lo), got {part.dtype}")
        if part.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(part.shape)}")
    if x[0].shape != x[1].shape or x[0].stride() != x[1].stride():
        raise ValueError(f"{name}'s hi and lo must share shape and strides")


def _dd_mod():
    from . import dd as ddm        # ops/dd.py imports ops/dense.py, which imports this module
    return ddm


def _rank_masked(x, rank, T: int):
    ddm = _dd_mod()
    m = (torch.arange(T, device=x[0].device) < rank).to(torch.float64)
    return ddm.DD(x[0] * m, x[1] * m)


def dd_score_residual_argmax_plain(vals, x, y, rank=None, mask=None, mask_side: int = MASK_NONE):
    """r = vals - sum_t x[:, t] y[:, t] in dd (r = the sum when vals is
    None), over t in order from zero (ops/dd.py::dd_sum), the rank mask
    (t < rank) multiplied into x (mask_side MASK_X) or y (MASK_Y); then the
    first maximum of mask ? |r.hi| : -1 (torch.argmax; all -1 without a
    mask).  vals DD (B,) or None, x and y DD (B, T) of any strides, rank an
    int tensor, mask (B,) bool or None.  Returns (r DD (B,), flat int64 0-d,
    DD of 0-d tensors r[flat])."""
    ddm = _dd_mod()
    T = x[0].shape[1]
    if rank is not None and mask_side == MASK_X:
        x = _rank_masked(x, rank, T)
    elif rank is not None and mask_side == MASK_Y:
        y = _rank_masked(y, rank, T)
    r = ddm.dd_sum(ddm.dd_mul(ddm.DD(*x), ddm.DD(*y)), axis=1)
    if vals is not None:
        r = ddm.dd_sub(ddm.DD(*vals), r)
    if mask is None:
        score = torch.full_like(r.hi, -1.0)
    else:
        score = torch.where(mask.bool(), r.hi.abs(), -1.0)
    flat = torch.argmax(score)
    return r, flat, ddm.DD(r.hi[flat], r.lo[flat])


def dd_score_residual_argmax(vals, x, y, rank=None, mask=None, mask_side: int = MASK_NONE):
    """D1, the dd kernel A: dd_score_residual_argmax_plain in one launch.

    The dd variant of ttcross_tpu/ops/pallas_kernels.py::
    score_residual_argmax (:62-120), for the dd engine's lottery, rook
    passes and accept (ttcross_tpu/cross/engine_dd.py:274-283, :306-334,
    :378-394).  On a CPU tensor this is the plain version; on a CUDA tensor
    it launches csrc/dd_kernels.cu's dd_score_kernel (a cluster of up to 16
    blocks, a thread per row) and adds one to
    ``dd_score_residual_argmax.launches``.  rank: a one-element int32 CUDA
    tensor (it may be a slice of the state's ranks; read on the card).  r
    is a view of one buffer allocated per call, flat and r[flat] of
    another."""
    ddm = _dd_mod()
    if x[0].device.type == "cpu":
        return dd_score_residual_argmax_plain(vals, x, y, rank, mask, mask_side)
    dev = x[0].device
    _check_pair("x", x, 2, dev)
    _check_pair("y", y, 2, dev)
    B, T = x[0].shape
    if tuple(y[0].shape) != (B, T):
        raise ValueError(f"shape mismatch: x {tuple(x[0].shape)}, y {tuple(y[0].shape)}")
    if B == 0:
        raise ValueError("dd_score_residual_argmax of an empty batch")
    if vals is not None:
        _check_pair("vals", vals, 1, dev)
        if vals[0].shape[0] != B or not (vals[0].is_contiguous() and vals[1].is_contiguous()):
            raise ValueError(f"vals must be ({B},) contiguous, got {tuple(vals[0].shape)}")
    if mask is not None:
        _check_cuda("mask", mask, _MASK, 1, dev)
        if mask.shape[0] != B:
            raise ValueError(f"mask must be ({B},), got {tuple(mask.shape)}")
    if rank is not None:
        _check_cuda("rank", rank.reshape(-1), _I32, 1, dev)
        if rank.numel() != 1:
            raise ValueError("rank must hold one int32")
    if mask_side not in (MASK_NONE, MASK_X, MASK_Y):
        raise ValueError(f"mask_side must be MASK_NONE, MASK_X or MASK_Y, got {mask_side}")
    blocks = min(_DD_CLUSTER_MAX, -(-B // _DD_THREADS))
    threads = _DD_THREADS if blocks > 1 else min(_DD_THREADS, -(-B // 32) * 32)
    out = torch.empty((2, B), dtype=torch.float64, device=dev)
    words = torch.empty(4 + 4 * blocks * (threads // 32), dtype=torch.int64, device=dev)
    null = 0
    rc = _call(dev, _lib().ttd_score_residual_argmax,
               vals[0].data_ptr() if vals is not None else null,
               vals[1].data_ptr() if vals is not None else null,
               x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(), B, T,
               x[0].stride(0), x[0].stride(1), y[0].stride(0), y[0].stride(1),
               rank.data_ptr() if rank is not None else null, mask_side,
               mask.data_ptr() if mask is not None else null, out.data_ptr(), words.data_ptr(),
               blocks, threads)
    _raise_on(rc, "dd_score_residual_argmax launch")
    dd_score_residual_argmax.launches += 1
    _SHAPES["dd_score_residual_argmax", (B, T)] += 1
    best = words[:4].view(torch.float64)
    return ddm.DD(out[0], out[1]), words[0], ddm.DD(best[2], best[3])


dd_score_residual_argmax.launches = 0


def dd_dot_plain(x, y):
    """out[i, j] = sum_t x[i, j, t] y[i, j, t] in dd, over t in order from
    zero: x and y DD (M, N, T) of any strides -> DD (M, N)."""
    ddm = _dd_mod()
    return ddm.dd_sum(ddm.dd_mul(ddm.DD(*x), ddm.DD(*y)), axis=2)


def dd_dot(x, y):
    """D4, the small dd GEMM: dd_dot_plain in one launch.

    x and y DD (M, N, T) views of any strides (a stride 0 broadcasts), x
    the left factor of every product: A @ B is dd_dot(A[:, None, :]
    expanded over N, B.T[None] expanded over M).  It serves the dd engine's
    _mm_left / _mm_right, value_mat and finalize (ttcross_tpu/cross/
    engine_dd.py:135-147, :443-504) and its quadrature.  On a CPU tensor
    this is the plain version; on a CUDA tensor it launches
    csrc/dd_kernels.cu's dd_dot_kernel (a thread per output) and adds one
    to ``dd_dot.launches``."""
    ddm = _dd_mod()
    if x[0].device.type == "cpu":
        return dd_dot_plain(x, y)
    dev = x[0].device
    _check_pair("x", x, 3, dev)
    _check_pair("y", y, 3, dev)
    M, N, T = x[0].shape
    if tuple(y[0].shape) != (M, N, T):
        raise ValueError(f"shape mismatch: x {tuple(x[0].shape)}, y {tuple(y[0].shape)}")
    if M * N == 0:
        raise ValueError("dd_dot of an empty output")
    out = torch.empty((2, M, N), dtype=torch.float64, device=dev)
    rc = _call(dev, _lib().ttd_dot, x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(),
               y[1].data_ptr(), M, N, T, *x[0].stride(), *y[0].stride(), out[0].data_ptr(),
               out[1].data_ptr())
    _raise_on(rc, "dd_dot launch")
    dd_dot.launches += 1
    _SHAPES["dd_dot", (M, N, T)] += 1
    return ddm.DD(out[0], out[1])


dd_dot.launches = 0


class PackedTT(NamedTuple):
    """An f64 train for D3: cores (d, R, N, R) zero-padded, R = the largest
    rank, N = the largest mode; ranks (d + 1,) as host ints and as an int32
    tensor beside the cores."""
    cores: torch.Tensor
    ranks: tuple
    ranks_t: torch.Tensor
    n: tuple


def pack_tt(t) -> PackedTT:
    """Pack a TT's cores (one copy to their device) for dd_gather_tt_fused."""
    ranks, n = tuple(t.r), tuple(t.n)
    R, N = max(ranks), max(n)
    dev = t.device
    cores = torch.zeros((t.d, R, N, R), dtype=torch.float64, device=dev)
    for c, g in enumerate(t.cores):
        cores[c, : ranks[c], : n[c], : ranks[c + 1]] = g
    return PackedTT(cores, ranks, torch.tensor(ranks, dtype=torch.int32).to(dev), n)


def dd_gather_tt_plain(tt: PackedTT, ind):
    """ops/dd.py::dd_gather_tt of the packed train: each core's active block."""
    ddm = _dd_mod()
    from ..tt.types import TT

    r = tt.ranks
    cores = tuple(tt.cores[c, : r[c], : tt.n[c], : r[c + 1]] for c in range(len(tt.n)))
    return ddm.dd_gather_tt(TT(cores), ind)


def dd_gather_tt_fused(tt: PackedTT, ind):
    """D3: the f64 train evaluated at (B, d) int32 indices with dd
    accumulation, DD (B,), in one launch.

    The defect integrand's whole cost (ttcross_tpu/cross/defect.py:33-49,
    ops/dd.py:319-335).  On a CPU tensor this is dd_gather_tt_plain; on a
    CUDA tensor it launches csrc/dd_kernels.cu's dd_gather_tt_kernel
    (W = the ranks rounded up to 32 threads per row) and adds one to
    ``dd_gather_tt_fused.launches``."""
    ddm = _dd_mod()
    if ind.device.type == "cpu":
        return dd_gather_tt_plain(tt, ind)
    dev = ind.device
    _check_cuda("ind", ind, _I32, 2, dev)
    _check_cuda("cores", tt.cores, _F64, 4, dev)
    _check_cuda("ranks", tt.ranks_t, _I32, 1, dev)
    d, R, N, _ = tt.cores.shape
    B = ind.shape[0]
    if ind.shape[1] != d:
        raise ValueError(f"ind must be (B, {d}), got {tuple(ind.shape)}")
    W = -(-R // 32) * 32
    if W > _DD_GATHER_RMAX:
        raise ValueError(f"rank {R} exceeds the dd gather kernel's {_DD_GATHER_RMAX}")
    out = torch.empty((2, B), dtype=torch.float64, device=dev)
    if B == 0:
        return ddm.DD(out[0], out[1])
    rc = _call(dev, _lib().ttd_gather_tt, tt.cores.data_ptr(), tt.ranks_t.data_ptr(), d, R, N,
               ind.data_ptr(), B, out[0].data_ptr(), out[1].data_ptr(), W)
    _raise_on(rc, "dd_gather_tt_fused launch")
    dd_gather_tt_fused.launches += 1
    _SHAPES["dd_gather_tt_fused", (B, N) + tt.ranks] += 1
    return ddm.DD(out[0], out[1])


dd_gather_tt_fused.launches = 0


def ising_c_integrand_dd_plain(tables, ind):
    """The C-kind Ising integrand in dd, DD (B,): tables (4, n) f64 (node
    hi, node lo, weight hi, weight lo), ind (B, d) int32, clamped into
    [0, n).  The order of ttcross_tpu/apps/ising.py:172-210: w = 1 + the
    prefix-product sums from the left, v the same from the right, each a
    scan of dd_mul / dd_add; b = dd_div(2, v w); then the weight product."""
    ddm = _dd_mod()
    i = ind.long().clamp(0, tables.shape[1] - 1)
    xh, xl, gh, gl = (tables[k][i] for k in range(4))            # (B, d) each
    B, d = i.shape

    def one():
        return ddm.DD(torch.ones(B, dtype=torch.float64, device=ind.device),
                      torch.zeros(B, dtype=torch.float64, device=ind.device))

    def cum_sum_of_prods(cols):
        pk, s = one(), one()
        for c in cols:
            pk = ddm.dd_mul(pk, ddm.DD(xh[:, c], xl[:, c]))
            s = ddm.dd_add(s, pk)
        return s

    w_sum = cum_sum_of_prods(range(d))
    v_sum = cum_sum_of_prods(range(d - 1, -1, -1))
    two = ddm.DD(torch.full((B,), 2.0, dtype=torch.float64, device=ind.device),
                 torch.zeros(B, dtype=torch.float64, device=ind.device))
    b = ddm.dd_div(two, ddm.dd_mul(v_sum, w_sum))
    prodw = one()
    for c in range(d):
        prodw = ddm.dd_mul(prodw, ddm.DD(gh[:, c], gl[:, c]))
    return ddm.dd_mul(b, prodw)


def ising_c_integrand_dd_fused(tables, ind):
    """D2: the dd Ising integrand with its table lookup, DD (B,), in one
    launch.

    The dd variant of ttcross_tpu/ops/pallas_kernels.py::
    small_table_lookup_limbs (:151-197) on the dd integrand's path
    (ttcross_tpu/apps/ising.py:172-210).  On a CPU tensor this is
    ising_c_integrand_dd_plain; on a CUDA tensor it launches
    csrc/dd_kernels.cu's ising_c_dd_kernel (a row per thread, any d) and
    adds one to ``ising_c_integrand_dd_fused.launches``."""
    ddm = _dd_mod()
    if ind.device.type == "cpu":
        return ising_c_integrand_dd_plain(tables, ind)
    dev = ind.device
    _check_cuda("ind", ind, _I32, 2, dev)
    _check_cuda("tables", tables, _F64, 2, dev)
    if tables.shape[0] != 4:
        raise ValueError(f"tables must be (4, n): node hi, lo, weight hi, lo; got "
                         f"{tuple(tables.shape)}")
    B, d = ind.shape
    n = tables.shape[1]
    if d < 1:
        raise ValueError(f"the dd integrand kernel takes d >= 1, got {d}")
    if 4 * n * 8 > _LOOKUP_SMEM:
        raise ValueError(f"a table of {n} points exceeds the kernel's shared memory")
    out = torch.empty((2, B), dtype=torch.float64, device=dev)
    if B == 0:
        return ddm.DD(out[0], out[1])
    rc = _call(dev, _lib().ttd_ising_c_integrand, tables.data_ptr(), n, ind.data_ptr(), B, d,
               out[0].data_ptr(), out[1].data_ptr())
    _raise_on(rc, "ising_c_integrand_dd_fused launch")
    ising_c_integrand_dd_fused.launches += 1
    _SHAPES["ising_c_integrand_dd_fused", (B, d, n)] += 1
    return ddm.DD(out[0], out[1])


ising_c_integrand_dd_fused.launches = 0

# ------------------------------------------------------------ the qd kernels
# csrc/qd_kernels.cu, linked into the one library: Q1 the qd Ising integrand,
# Q2 the qd residual argmax, Q3 the qd train gather, Q4 the small qd product.
# Each computes in the operation order of ops/qd.py with intrinsics nvcc does
# not contract, so it is bit for bit its plain version (the plain versions
# below are ops/qd.py's functions, which the CPU tests hold against the JAX
# package's numpy path).
_QD_THREADS = 256          # kThreads: a block of Q2, Q3, Q4
_QD_ROWS_THREADS = 128     # kRowsThreads: a block of Q1
_QD_GATHER_RMAX = 64       # kGatherRMax: Q3 takes ranks up to this
_QD_TREE_MAX = 1 << 16     # the pairwise tree's terms at most


def _qd_mod():
    from . import qd as qdm        # ops/qd.py imports this module
    return qdm


def _check_limbs(name, x, ndim, device) -> None:
    """A qd operand on the card: four float64 limbs of one shape and one
    layout (strides may be anything, a broadcast's 0 too)."""
    if len(x) != 4:
        raise ValueError(f"{name} must be a QD of 4 limbs")
    for part in x:
        if part.device != device:
            raise ValueError(f"{name} must lie on {device}, got {part.device}")
        if part.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 limbs, got {part.dtype}")
        if part.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(part.shape)}")
    if any(p.shape != x[0].shape or p.stride() != x[0].stride() for p in x[1:]):
        raise ValueError(f"{name}'s limbs must share shape and strides")


def _limb_ptrs(x):
    return (ctypes.c_void_p * 4)(*(e.data_ptr() for e in x))


def qd_score_residual_argmax_plain(vals, x, y):
    """r = vals - qd_sum(qd_mul(x, y), axis=1) in qd (ops/qd.py's tree),
    then the first maximum of |r.e0| (torch.argmax).  vals QD (B,), x and y
    QD (B, T) of any strides, x the left factor.  Returns (r QD (B,), flat
    int64 0-d)."""
    qdm = _qd_mod()
    r = qdm.qd_sub(qdm.QD(*vals), qdm.qd_sum(qdm.qd_mul(qdm.QD(*x), qdm.QD(*y)), axis=1))
    return r, torch.argmax(r.e0.abs())


def qd_score_residual_argmax(vals, x, y):
    """Q2, the qd kernel A: qd_score_residual_argmax_plain in one launch.

    The qd variant of ttcross_tpu/ops/pallas_kernels.py::
    score_residual_argmax (:62-120), for the qd engine's lottery, rook
    passes and accept (ttcross_tpu/cross/engine_qd.py:175-290).  On a CPU
    tensor this is the plain version; on a CUDA tensor it launches
    csrc/qd_kernels.cu's qd_score_kernel (a thread per row, the last block
    reduces the blocks' best) and adds one to
    ``qd_score_residual_argmax.launches``."""
    qdm = _qd_mod()
    if x[0].device.type == "cpu":
        return qd_score_residual_argmax_plain(vals, x, y)
    dev = x[0].device
    _check_limbs("x", x, 2, dev)
    _check_limbs("y", y, 2, dev)
    B, T = x[0].shape
    if tuple(y[0].shape) != (B, T):
        raise ValueError(f"shape mismatch: x {tuple(x[0].shape)}, y {tuple(y[0].shape)}")
    if B == 0 or T == 0 or T > _QD_TREE_MAX:
        raise ValueError(f"qd_score_residual_argmax takes B >= 1 and 1 <= T <= {_QD_TREE_MAX}, "
                         f"got ({B}, {T})")
    _check_limbs("vals", vals, 1, dev)
    if vals[0].shape[0] != B or not vals[0].is_contiguous():
        raise ValueError(f"vals must be ({B},) contiguous, got {tuple(vals[0].shape)}")
    blocks = -(-B // _QD_THREADS)
    out = torch.empty((4, B), dtype=torch.float64, device=dev)
    # the index, the blocks' best scores and indices, and the block counter:
    # zeroed per call, so no state outlives a launch
    words = torch.zeros(2 + 2 * blocks, dtype=torch.int64, device=dev)
    rc = _call(dev, _lib().ttq_score_residual_argmax, _limb_ptrs(vals), _limb_ptrs(x),
               _limb_ptrs(y), B, T, x[0].stride(0), x[0].stride(1), y[0].stride(0),
               y[0].stride(1), out.data_ptr(), words.data_ptr())
    _raise_on(rc, "qd_score_residual_argmax launch")
    qd_score_residual_argmax.launches += 1
    _SHAPES["qd_score_residual_argmax", (B, T)] += 1
    return qdm.QD(out[0], out[1], out[2], out[3]), words[0]


qd_score_residual_argmax.launches = 0


def qd_dot_plain(x, y, tree: bool):
    """out[i, j] = sum_t x[i, j, t] y[i, j, t] in qd: x and y QD (M, N, T)
    of any strides, x the left factor; the sum by qd_sum's tree (tree=True,
    qd_vdot_axis) or from term 0 by qd_add of each next term in order
    (tree=False, qd_matmul's k-loop; zeros when T = 0) -> QD (M, N)."""
    qdm = _qd_mod()
    if tree:
        return qdm.qd_sum(qdm.qd_mul(qdm.QD(*x), qdm.QD(*y)), axis=2)
    M, N, T = x[0].shape
    acc = None
    for t in range(T):
        term = qdm.qd_mul(qdm.QD(*(e[:, :, t] for e in x)), qdm.QD(*(e[:, :, t] for e in y)))
        acc = term if acc is None else qdm.qd_add(acc, term)
    return acc if acc is not None else qdm.qd_zeros((M, N), x[0].device)


def qd_dot(x, y, tree: bool):
    """Q4, the small qd product: qd_dot_plain in one launch.

    x and y QD (M, N, T) views of any strides (a stride 0 broadcasts): A @
    B is qd_dot(A[:, None, :] expanded over N, B.T[None] expanded over M,
    tree=False).  It serves qd_matmul and qd_vdot_axis (ops/qd.py), so the
    qd engine's apply_*_slice, solve_core, _extend_inverses and value chain,
    qd_contract, qd_tt_value and refine_dd.  On a CPU tensor this is the
    plain version; on a CUDA tensor it launches csrc/qd_kernels.cu's
    qd_dot_kernel (a thread per output) and adds one to
    ``qd_dot.launches``."""
    qdm = _qd_mod()
    if x[0].device.type == "cpu":
        return qd_dot_plain(x, y, tree)
    dev = x[0].device
    _check_limbs("x", x, 3, dev)
    _check_limbs("y", y, 3, dev)
    M, N, T = x[0].shape
    if tuple(y[0].shape) != (M, N, T):
        raise ValueError(f"shape mismatch: x {tuple(x[0].shape)}, y {tuple(y[0].shape)}")
    if M * N == 0 or T > _QD_TREE_MAX or (tree and T == 0):
        raise ValueError(f"qd_dot takes a non-empty output and T <= {_QD_TREE_MAX} (T >= 1 for "
                         f"the tree), got ({M}, {N}, {T})")
    out = torch.empty((4, M, N), dtype=torch.float64, device=dev)
    rc = _call(dev, _lib().ttq_dot, _limb_ptrs(x), _limb_ptrs(y), M, N, T, *x[0].stride(),
               *y[0].stride(), int(tree), out.data_ptr())
    _raise_on(rc, "qd_dot launch")
    qd_dot.launches += 1
    _SHAPES["qd_dot", (M, N, T, "tree" if tree else "seq")] += 1
    return qdm.QD(out[0], out[1], out[2], out[3])


qd_dot.launches = 0


def qd_gather_tt_plain(tt: PackedTT, ind):
    """ops/qd.py::qd_gather_tt of the packed train: each core's active block."""
    r = tt.ranks
    cores = tuple(tt.cores[c, : r[c], : tt.n[c], : r[c + 1]] for c in range(len(tt.n)))
    return _qd_mod()._qd_gather_tt_plain(cores, ind)


def qd_gather_tt_fused(tt: PackedTT, ind):
    """Q3: the f64 train evaluated at (B, d) int32 indices with qd
    accumulation, QD (B,), in one launch.

    The qd defect integrand's train gather (ttcross_tpu/cross/defect.py:
    164-173, ops/qd.py:384-403).  On a CPU tensor this is
    qd_gather_tt_plain; on a CUDA tensor it launches csrc/qd_kernels.cu's
    qd_gather_tt_kernel (W = the ranks rounded up to 32 threads per row) and
    adds one to ``qd_gather_tt_fused.launches``."""
    qdm = _qd_mod()
    if ind.device.type == "cpu":
        return qd_gather_tt_plain(tt, ind)
    dev = ind.device
    _check_cuda("ind", ind, _I32, 2, dev)
    _check_cuda("cores", tt.cores, _F64, 4, dev)
    _check_cuda("ranks", tt.ranks_t, _I32, 1, dev)
    d, R, N, _ = tt.cores.shape
    B = ind.shape[0]
    if ind.shape[1] != d:
        raise ValueError(f"ind must be (B, {d}), got {tuple(ind.shape)}")
    W = -(-R // 32) * 32
    if W > _QD_GATHER_RMAX:
        raise ValueError(f"rank {R} exceeds the qd gather kernel's {_QD_GATHER_RMAX}")
    out = torch.empty((4, B), dtype=torch.float64, device=dev)
    if B == 0:
        return qdm.QD(out[0], out[1], out[2], out[3])
    rc = _call(dev, _lib().ttq_gather_tt, tt.cores.data_ptr(), tt.ranks_t.data_ptr(), d, R, N,
               ind.data_ptr(), B, out.data_ptr(), W)
    _raise_on(rc, "qd_gather_tt_fused launch")
    qd_gather_tt_fused.launches += 1
    _SHAPES["qd_gather_tt_fused", (B, N) + tt.ranks] += 1
    return qdm.QD(out[0], out[1], out[2], out[3])


qd_gather_tt_fused.launches = 0


def ising_c_integrand_qd_plain(tables, ind):
    """The C-kind Ising integrand in qd, QD (B,): tables (8, n) f64 (node
    limbs e0..e3, weight limbs e0..e3), ind (B, d) int, clamped into [0, n).
    The order of ttcross_tpu/apps/ising.py:246-278: w = 1 + the
    prefix-product sums from the left, v the same from the right; b =
    qd_div(2, v w); then the weight product."""
    qdm = _qd_mod()
    i = ind.long().clamp(0, tables.shape[1] - 1)
    x = qdm.QD(*(tables[k][i] for k in range(4)))                # (B, d) each
    g = qdm.QD(*(tables[4 + k][i] for k in range(4)))
    B, d = i.shape

    def one():
        return qdm.qd(torch.ones(B, dtype=torch.float64, device=ind.device))

    def cum_sum_of_prods(cols):
        pk, s = one(), one()
        for c in cols:
            pk = qdm.qd_mul(pk, qdm.QD(*(e[:, c] for e in x)))
            s = qdm.qd_add(s, pk)
        return s

    w_sum = cum_sum_of_prods(range(d))
    v_sum = cum_sum_of_prods(range(d - 1, -1, -1))
    b = qdm.qd_div(qdm.qd(torch.full((B,), 2.0, dtype=torch.float64, device=ind.device)),
                   qdm.qd_mul(v_sum, w_sum))
    prodw = one()
    for c in range(d):
        prodw = qdm.qd_mul(prodw, qdm.QD(*(e[:, c] for e in g)))
    return qdm.qd_mul(b, prodw)


def ising_c_integrand_qd_fused(tables, ind):
    """Q1: the qd Ising integrand with its table lookup, QD (B,), in one
    launch.

    The qd variant of ttcross_tpu/ops/pallas_kernels.py::
    small_table_lookup_limbs (:151-197) on the qd integrand's path
    (ttcross_tpu/apps/ising.py:246-278).  On a CPU tensor this is
    ising_c_integrand_qd_plain; on a CUDA tensor it launches
    csrc/qd_kernels.cu's ising_c_qd_kernel (a row per thread, any d) and adds
    one to ``ising_c_integrand_qd_fused.launches``."""
    qdm = _qd_mod()
    if ind.device.type == "cpu":
        return ising_c_integrand_qd_plain(tables, ind)
    dev = ind.device
    _check_cuda("ind", ind, _I32, 2, dev)
    _check_cuda("tables", tables, _F64, 2, dev)
    if tables.shape[0] != 8:
        raise ValueError(f"tables must be (8, n): node limbs, weight limbs; got "
                         f"{tuple(tables.shape)}")
    B, d = ind.shape
    n = tables.shape[1]
    if d < 1:
        raise ValueError(f"the qd integrand kernel takes d >= 1, got {d}")
    if 8 * n * 8 > _LOOKUP_SMEM:
        raise ValueError(f"a table of {n} points exceeds the kernel's shared memory")
    out = torch.empty((4, B), dtype=torch.float64, device=dev)
    if B == 0:
        return qdm.QD(out[0], out[1], out[2], out[3])
    rc = _call(dev, _lib().ttq_ising_c_integrand, tables.data_ptr(), n, ind.data_ptr(), B, d,
               out.data_ptr())
    _raise_on(rc, "ising_c_integrand_qd_fused launch")
    ising_c_integrand_qd_fused.launches += 1
    _SHAPES["ising_c_integrand_qd_fused", (B, d, n)] += 1
    return qdm.QD(out[0], out[1], out[2], out[3])


ising_c_integrand_qd_fused.launches = 0

_WRAPPERS = (score_residual_argmax, score_residual_argmax_batched, small_table_lookup,
             ising_integrand_fused, dd_score_residual_argmax, dd_dot, dd_gather_tt_fused,
             ising_c_integrand_dd_fused, qd_score_residual_argmax, qd_dot, qd_gather_tt_fused,
             ising_c_integrand_qd_fused)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def launch_shapes() -> dict[str, dict[tuple, int]]:
    """The launches since the last reset by the shape of the call, per
    wrapper: kernel A (M, K, R), batched (P, M, K, R), the lookup
    (L, B, d, n), the fused integrand (B, d, n); an f32 launch's shape
    ends in "f32"; the dd kernels: D1 (B, T), D4 (M, N, T), D3 (B, N) + the
    train's ranks (N its largest mode), D2 (B, d, n); the qd kernels: Q2
    (B, T), Q4 (M, N, T, "tree" | "seq"), Q3 (B, N) + the train's ranks,
    Q1 (B, d, n)."""
    out = {f.__name__: {} for f in _WRAPPERS}
    for (name, shape), count in _SHAPES.items():
        out[name][shape] = count
    return out


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0
    _SHAPES.clear()
