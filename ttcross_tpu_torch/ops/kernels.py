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

import torch

from . import _build

__all__ = ["score_residual_argmax", "score_residual_argmax_plain",
           "small_table_lookup", "small_table_lookup_plain",
           "launch_counts", "reset_launch_counts"]

_THREADS = 256            # kThreads in csrc/kernels.cu
_TILE = 64                # kTile in csrc/kernels.cu
_MAX_GRID_Y = 65535
_LOOKUP_SMEM = 48 * 1024  # static limit of dynamic shared memory per block
_LOOKUP_BLOCKS_PER_SM = 8


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device.type != "cuda" or t.device != device:
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
    if (lib.ttc_threads_per_block(), lib.ttc_tile()) != (_THREADS, _TILE):
        raise RuntimeError("kThreads/kTile in csrc/kernels.cu disagree with ops/kernels.py")
    return lib


@functools.lru_cache(maxsize=None)
def _lookup_max_blocks(index: int) -> int:
    """Grid cap of kernel B on device `index`: a few blocks per
    streaming multiprocessor, so each block stages the tables once and
    grid-strides over the rest."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _LOOKUP_BLOCKS_PER_SM * sms


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ------------------------------------------------------------ kernel A
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
    score_residual_argmax_plain; on a CUDA tensor it launches the two-pass
    f64 kernel of csrc/kernels.cu (see the note there for what bounds it)
    and adds one to ``score_residual_argmax.launches``."""
    if vals.device.type == "cpu":
        return score_residual_argmax_plain(vals, colf, rowf, mask)
    dev = vals.device
    f64 = (torch.float64,)
    _check_cuda("vals", vals, f64, 2, dev)
    _check_cuda("colf", colf, f64, 2, dev)
    _check_cuda("rowf", rowf, f64, 2, dev)
    _check_cuda("mask", mask, (torch.bool, torch.uint8), 2, dev)
    M, K = vals.shape
    R = colf.shape[1]
    if colf.shape[0] != M or rowf.shape != (R, K) or mask.shape != (M, K):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, colf "
                         f"{tuple(colf.shape)}, rowf {tuple(rowf.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if M * K == 0:
        raise ValueError("score_residual_argmax of an empty matrix")
    if K == 1 or M == 1:     # a fiber: one element per thread
        tk = 1 if K == 1 else _THREADS
        gx, gy = -(-K // tk), -(-M // (_THREADS // tk))
    else:                    # tiled: _TILE x _TILE elements per block
        tk = 0
        gx, gy = -(-K // _TILE), -(-M // _TILE)
    if gy > _MAX_GRID_Y or gx >= 2 ** 31:
        raise ValueError(f"matrix {M} x {K} exceeds the kernel's grid")
    lib = _lib()
    nparts = gx * gy
    # one f64 buffer: [score (1), resid (1), part_score (nparts),
    # part_resid (nparts)]; one int64 buffer: [index (1), part_idx (nparts)]
    fbuf = torch.empty(2 + 2 * nparts, dtype=torch.float64, device=dev)
    ibuf = torch.empty(1 + nparts, dtype=torch.int64, device=dev)
    f0, i0 = fbuf.data_ptr(), ibuf.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ttc_score_residual_argmax(
            vals.data_ptr(), colf.data_ptr(), rowf.data_ptr(), mask.data_ptr(),
            M, K, R, tk, gx, gy, f0 + 16, i0 + 8, f0 + 16 + 8 * nparts,
            i0, f0, f0 + 8, stream)
    _raise_on(rc, "score_residual_argmax launch")
    score_residual_argmax.launches += 1
    return ibuf[0], fbuf[0], fbuf[1]


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
    _check_cuda("tables", tables, (torch.float64,), 2, dev)
    _check_cuda("ind", ind, (torch.int32,), 2, dev)
    L, n = tables.shape
    if L * n * 8 > _LOOKUP_SMEM:
        raise ValueError(f"tables ({L}, {n}) exceed the kernel's "
                         f"{_LOOKUP_SMEM}-byte shared-memory budget")
    B, d = ind.shape
    E = B * d
    out = torch.empty((L, B, d), dtype=torch.float64, device=dev)
    if E == 0:
        return out
    blocks = min(-(-E // _THREADS), _lookup_max_blocks(dev.index))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ttc_small_table_lookup(tables.data_ptr(), L, n, ind.data_ptr(),
                                        E, out.data_ptr(), blocks, stream)
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
