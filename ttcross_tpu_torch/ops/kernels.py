"""The port's two hand-written CUDA kernels, their plain PyTorch versions
and their launch counters.

Counterpart of ttcross_tpu/ops/pallas_kernels.py.  The CUDA sources are in
``csrc/kernels.cu`` (built by ``ops/_build.py``).  Each wrapper routes a
tensor that lies on the CPU to the plain version and a CUDA tensor to the
kernel; on a CUDA tensor it launches the kernel or raises, never falling
back.  ``<wrapper>.launches`` counts the kernel launches of that wrapper.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["score_residual_argmax", "score_residual_argmax_plain",
           "small_table_lookup", "small_table_lookup_plain",
           "launch_counts", "reset_launch_counts"]

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
_F64 = (torch.float64,)
_MASK = (torch.bool, torch.uint8)
_I32 = (torch.int32,)

COL, ROW, TWO_D = 0, 1, 2  # kernel A's paths (`path` of csrc's entry point)


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
    if ((lib.ttc_threads_per_block(), lib.ttc_tile_threads(), lib.ttc_tile_smem())
            != (_THREADS, _TILE_THREADS, _TILE_SMEM)):
        raise RuntimeError("kThreads/kTileThreads/kTileSmem in csrc/kernels.cu "
                           "disagree with ops/kernels.py")
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
    path: int               # COL (K = 1), ROW (M = 1) or TWO_D
    blocks: int             # grid size
    threads: int            # block size
    cluster: int            # blocks per cluster: the whole grid of a fiber, else 1
    smem: int               # dynamic shared memory per block, bytes
    tile: tuple[int, int]   # (rows, cols) one block scores per step
    nparts: int             # partials in the scratch buffer (per warp / per block)


@functools.lru_cache(maxsize=1024)
def _plan(M: int, K: int, R: int, sms: int) -> Plan:
    """Launch geometry of kernel A for vals (M, K) and rank R on a card
    with `sms` streaming multiprocessors.

    A fiber (K = 1 or M = 1) is one cluster of up to _CLUSTER_MAX blocks
    with one partial per warp; block b scores tiles b, b + blocks, ... of
    `threads` elements (one per thread).  A block holds its tile's factor
    in shared memory (`threads` rows of colf, or R rows of `threads`
    columns of rowf), so a large R gets fewer threads.  The 2-D path is a
    persistent grid of at most one block per SM; block b scores tiles b,
    b + blocks, ... of the row-major grid of TILE tiles."""
    if M < 1 or K < 1 or R < 0:
        raise ValueError(f"no kernel-A launch for ({M}, {K}) at rank {R}")
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
    f64 = buf[:3].view(torch.float64)
    return buf[0], f64[1], f64[2]


score_residual_argmax.launches = 0


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
    return out


small_table_lookup.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {"score_residual_argmax": score_residual_argmax.launches,
            "small_table_lookup": small_table_lookup.launches}


def reset_launch_counts() -> None:
    score_residual_argmax.launches = 0
    small_table_lookup.launches = 0
