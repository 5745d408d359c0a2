"""TT serialization: binary stream formats, npz, and HDF5 export.

Counterpart of ttcross_tpu/tt/serialize.py (ttio.f90's 'TT' stream format
with header and version check, ttio.f90:10-17, 29-399; utils.f90's HDF5
export schema, utils.f90:8-57: group "TT" with int datasets modes / ranks
and double datasets core_0..core_{d-1}), byte-compatible with it: a file
written by either package loads in the other.  Also the engine-state
checkpoint (save_state / load_state).  Savers read the cores from their
device; loaders take ``device`` and place them there (the card unless the
caller asks for ``device="cpu"``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .types import TT, from_cores

__all__ = ["save_ttbin", "load_ttbin", "save_ttbin_ref", "load_ttbin_ref",
           "save_npz", "load_npz", "save_hdf5", "load_hdf5", "save_state", "load_state"]

_MAGIC = b"TTX1"
_VERSION = (1, 0)

# the reference stream format's compile-time constants (ttio.f90:5-17)
_REF_TT_SIZE = 2048
_REF_HEAD = struct.Struct("<8s2i4i64s8i")   # txt, ver(2), inf(4), comment, i(8)


def _host_cores(t: TT) -> tuple[list[np.ndarray], bool]:
    """The cores as little-endian numpy arrays, and whether they are complex."""
    is_complex = t.cores[0].is_complex()
    dt = "<c16" if is_complex else "<f8"
    return [np.asarray(c.detach().cpu().numpy(), dtype=dt) for c in t.cores], is_complex


def _on_device(cores, device) -> TT:
    return from_cores([np.ascontiguousarray(c) for c in cores], device=device)


def save_ttbin(t: TT, path: str) -> None:
    """Binary stream format: magic 'TTX1', version, flags (bit0 = complex),
    d, modes, ranks, then cores in C order (the design follows the
    reference's header + payload stream, ttio.f90:29-109)."""
    cores, is_complex = _host_cores(t)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<4i", *_VERSION, 1 if is_complex else 0, t.d))
        f.write(np.asarray(t.n, dtype="<i8").tobytes())
        f.write(np.asarray(t.r, dtype="<i8").tobytes())
        for arr in cores:
            f.write(arr.tobytes())


def load_ttbin(path: str, device: str | torch.device = "cuda") -> TT:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"not a ttcross binary TT file (magic {magic!r})")
        vmaj, vmin, flags, d = struct.unpack("<4i", f.read(16))
        if vmaj != _VERSION[0]:
            raise ValueError(f"unsupported TT file version {vmaj}.{vmin}")
        n = np.frombuffer(f.read(8 * d), dtype="<i8")
        r = np.frombuffer(f.read(8 * (d + 1)), dtype="<i8")
        dt = "<c16" if flags & 1 else "<f8"
        cores = []
        for c in range(d):
            count = int(r[c] * n[c] * r[c + 1])
            buf = np.frombuffer(f.read(count * np.dtype(dt).itemsize), dtype=dt)
            cores.append(buf.reshape(r[c], n[c], r[c + 1]))
    return _on_device(cores, device)


def save_ttbin_ref(t: TT, path: str, comment: str = "") -> None:
    """Write the reference's binary 'TT' stream format (ttio.f90:10-17,
    29-109; gfortran unformatted stream access = raw bytes, no record
    markers), byte-compatible with dtt_read / ztt_read:

      tthead {txt 'TT      ', ver (1,0) i4x2, inf (tt_size, complex?, 0, 0)
              i4x4, comment char(64), i i4x8 with i(1)=l, i(2)=m}
      l, m                      i4x2          (l=1, m=d here)
      n(l:m), r(l-1:m)          i4
      cores                     f8 (c16 if complex), Fortran column-major
                                (r_{b-1}, n_b, r_b) per core, concatenated

    A TT written here loads in the Fortran with `call read(tt, fnam)`."""
    cores, is_complex = _host_cores(t)
    l, m = 1, t.d
    head = _REF_HEAD.pack(
        b"TT      ", 1, 0, _REF_TT_SIZE, 1 if is_complex else 0, 0, 0,
        comment.encode()[:64].ljust(64), l, m, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack("<2i", l, m))
        f.write(np.asarray(t.n, dtype="<i4").tobytes())
        f.write(np.asarray(t.r, dtype="<i4").tobytes())
        for arr in cores:
            # a (r1, n, r2) C-order core is the Fortran (r1, n, r2)
            # column-major one after axis reversal
            f.write(arr.transpose(2, 1, 0).tobytes())


def load_ttbin_ref(path: str, device: str | torch.device = "cuda") -> TT:
    """Read a reference-written 'TT' stream (dtt_write / ztt_write,
    ttio.f90:29-192), applying the reference reader's own validation:
    txt starts with 'TT' and ver(1) == 1 (ttio.f90:240-248)."""
    with open(path, "rb") as f:
        head = f.read(_REF_HEAD.size)
        if len(head) < _REF_HEAD.size:
            raise ValueError("truncated TT header")
        fields = _REF_HEAD.unpack(head)
        txt, vmaj, vmin = fields[0], fields[1], fields[2]
        inf = fields[3:7]
        if txt[:2] != b"TT":
            raise ValueError(f"not a TT header: {txt!r}")
        if vmaj != 1:
            raise ValueError(f"unsupported TT file version {vmaj}.{vmin}")
        is_complex = inf[1] == 1
        l, m = struct.unpack("<2i", f.read(8))
        d = m - l + 1
        if d < 1:
            raise ValueError(f"strange l,m: {l},{m}")
        n = np.frombuffer(f.read(4 * d), dtype="<i4")
        r = np.frombuffer(f.read(4 * (d + 1)), dtype="<i4")
        dt = np.dtype("<c16" if is_complex else "<f8")
        cores = []
        for b in range(d):
            count = int(r[b] * n[b] * r[b + 1])
            buf = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
            if buf.size != count:
                raise ValueError(f"truncated core {b}")
            # Fortran column-major (r1, n, r2) -> C order via the reversed
            # shape and axis reversal
            cores.append(buf.reshape(int(r[b + 1]), int(n[b]), int(r[b])).transpose(2, 1, 0))
    return _on_device(cores, device)


def save_npz(t: TT, path: str) -> None:
    np.savez(path, d=t.d, **{f"core_{c}": g for c, g in enumerate(_host_cores(t)[0])})


def load_npz(path: str, device: str | torch.device = "cuda") -> TT:
    data = np.load(path)
    return _on_device([data[f"core_{c}"] for c in range(int(data["d"]))], device)


def save_hdf5(t: TT, path: str) -> None:
    """HDF5 export with the reference's schema (utils.f90:8-57): group "TT",
    datasets modes (int), ranks (int), core_0..core_{d-1} (float).  Needs
    h5py."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("TT")
        g.create_dataset("modes", data=np.asarray(t.n, dtype=np.int64))
        g.create_dataset("ranks", data=np.asarray(t.r, dtype=np.int64))
        for c, arr in enumerate(_host_cores(t)[0]):
            g.create_dataset(f"core_{c}", data=arr)


def load_hdf5(path: str, device: str | torch.device = "cuda") -> TT:
    """HDF5 reader (the reference only writes).  Needs h5py."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f["TT"]
        return _on_device([g[f"core_{c}"][...] for c in range(g["modes"].shape[0])], device)


def save_state(state, path: str) -> None:
    """Checkpoint a running cross (cross/state.py::CrossState) for
    cross(init_state=...)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state._asdict().items()})


def load_state(path: str, device: str | torch.device = "cuda"):
    """A CrossState from a checkpoint of either package (the JAX package's
    PRNG key is dropped; counters a checkpoint lacks start at 0)."""
    from ..interop import state_from_numpy

    data = np.load(path)
    arrays = {k: data[k] for k in data.files}
    arrays.setdefault("padded", np.zeros((), np.int64))
    missing = [k for k in ("cores", "colf", "rowf", "rk", "vip", "lu_c", "lu_u", "lu_d", "itl",
                           "itt", "amax", "pivotmax", "pivotmin", "pivotmax_prev", "neval")
               if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing CrossState field {missing[0]!r}")
    return state_from_numpy(arrays, device)
