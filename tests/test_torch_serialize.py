"""The port's TT serialization against the JAX package's: the same bytes.

A file written by one package is read by the other with bit-equal cores,
for every format both have, real and complex; the reference's own 'TT'
stream layout is rebuilt here byte by byte and read by the port."""

import struct

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import ttcross_tpu.tt as jtt
from ttcross_tpu.cross.state import empty_state as jempty_state
from ttcross_tpu.tt import TT as JTT
import ttcross_tpu_torch.tt as ptt
from ttcross_tpu_torch.cross.state import CrossState, empty_state, pad_state
from ttcross_tpu_torch.tt import TT

FORMATS = ["ttbin", "ttbin_ref", "npz", "hdf5"]


def _cores(seed, cplx):
    rng = np.random.default_rng(seed)
    n, r = (4, 5, 3), (1, 3, 2, 1)
    cores = [rng.standard_normal((r[c], n[c], r[c + 1])) for c in range(3)]
    if cplx:
        cores = [c + 1j * rng.standard_normal(c.shape) for c in cores]
    return cores


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_files_cross_between_the_packages(fmt, cplx, tmp_path):
    """Port -> file -> JAX package and back: bit-equal cores, and the two
    packages write the same bytes (npz and hdf5: the same arrays)."""
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    cores = _cores(3, cplx)
    pt = TT(tuple(torch.from_numpy(c) for c in cores))
    jt = JTT(tuple(jnp.asarray(c) for c in cores))
    pfile, jfile = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"j.{fmt}")
    if fmt == "npz":
        pfile, jfile = pfile + ".npz", jfile + ".npz"
    getattr(ptt, f"save_{fmt}")(pt, pfile)
    getattr(jtt, f"save_{fmt}")(jt, jfile)
    if fmt.startswith("ttbin"):
        assert open(pfile, "rb").read() == open(jfile, "rb").read()
    from_port = getattr(jtt, f"load_{fmt}")(pfile)              # the JAX package reads the port's file
    from_jax = getattr(ptt, f"load_{fmt}")(jfile, device="cpu")  # and the other way round
    assert from_jax.r == pt.r and from_jax.n == pt.n and from_jax.device.type == "cpu"
    for c in range(3):
        assert np.array_equal(np.asarray(from_port.cores[c]), cores[c])
        assert np.array_equal(from_jax.cores[c].numpy(), cores[c])
        assert from_jax.cores[c].dtype == (torch.complex128 if cplx else torch.float64)
        assert from_jax.cores[c].is_contiguous()


def test_ttbin_ref_loads_synthetic_reference_layout(tmp_path):
    """A file laid out byte for byte as gfortran's dtt_write emits it
    (unformatted stream access = raw bytes; tthead sequence {txt char8, ver
    2xi4, inf 4xi4, comment char64, i 8xi4}, then l, m, n(l:m), r(l-1:m) as
    i4, then cores in Fortran column-major (r_{b-1}, n_b, r_b) order:
    ttio.f90:10-17, 29-109), read by the port; and the port writes those
    bytes back."""
    rng = np.random.default_rng(7)
    n, r = [2, 3], [1, 2, 1]
    cores = [rng.standard_normal((r[b], n[b], r[b + 1])) for b in range(2)]
    blob = b"TT      "                                 # txt
    blob += struct.pack("<2i", 1, 0)                   # ver
    blob += struct.pack("<4i", 2048, 0, 0, 0)          # inf (tt_size, real)
    blob += b" " * 64                                  # comment
    blob += struct.pack("<8i", 1, 2, 0, 0, 0, 0, 0, 0)  # i(1)=l, i(2)=m
    blob += struct.pack("<2i", 1, 2)                   # l, m
    blob += np.asarray(n, "<i4").tobytes()             # n(l:m)
    blob += np.asarray(r, "<i4").tobytes()             # r(l-1:m)
    for c in cores:
        blob += np.asarray(c, "<f8").tobytes(order="F")  # column-major
    p = tmp_path / "ref.tt"
    p.write_bytes(blob)
    t = ptt.load_ttbin_ref(str(p), device="cpu")
    assert t.n == (2, 3) and t.r == (1, 2, 1)
    for b in range(2):
        assert np.array_equal(t.cores[b].numpy(), cores[b])
    ptt.save_ttbin_ref(t, str(tmp_path / "back.tt"))
    assert (tmp_path / "back.tt").read_bytes() == blob


@pytest.mark.parametrize("blob,match", [
    (b"TT      " + np.asarray([9, 0], "<i4").tobytes() + b"\0" * 120, "version"),
    (b"XX      " + np.asarray([1, 0], "<i4").tobytes() + b"\0" * 120, "not a TT header"),
    (b"TT", "truncated"),
])
def test_ttbin_ref_rejects_what_the_reference_reader_rejects(blob, match, tmp_path):
    p = tmp_path / "bad.tt"
    p.write_bytes(blob)
    with pytest.raises(ValueError, match=match):
        ptt.load_ttbin_ref(str(p), device="cpu")
    with pytest.raises(ValueError, match="magic"):
        ptt.load_ttbin(str(p), device="cpu")


def test_state_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX CrossState checkpoint loads as a port state (the PRNG key
    dropped, the sweep count 0), and a port checkpoint loads in the JAX
    package; a checkpoint without `padded` (an old one) starts it at 0."""
    jst = jempty_state(3, 5, 4, jax.random.PRNGKey(1))
    jst = jst._replace(amax=jnp.asarray(2.5), neval=jnp.asarray(77, jnp.int64),
                       cores=jst.cores.at[1, 2, 3, 1].set(-4.0))
    jfile = str(tmp_path / "j.npz")
    jtt.save_state(jst, jfile)
    pst = ptt.load_state(jfile, device="cpu")
    assert isinstance(pst, CrossState) and int(pst.sweeps) == 0 and int(pst.neval) == 77
    for f in CrossState._fields:
        if f != "sweeps":
            assert np.array_equal(getattr(pst, f).numpy(), np.asarray(getattr(jst, f))), f
    pst = pst._replace(sweeps=pst.sweeps + 3)
    pfile = str(tmp_path / "p.npz")
    ptt.save_state(pst, pfile)
    assert int(ptt.load_state(pfile, device="cpu").sweeps) == 3
    data = dict(np.load(pfile))
    data["key"] = np.asarray(jax.random.key_data(jst.key))     # the one field the port lacks
    np.savez(pfile, **data)
    back = jtt.load_state(pfile)
    assert float(back.amax) == 2.5 and float(back.cores[1, 2, 3, 1]) == -4.0
    data.pop("padded")
    np.savez(pfile, **data)
    assert int(ptt.load_state(pfile, device="cpu").padded) == 0
    data.pop("vip")
    np.savez(pfile, **data)
    with pytest.raises(KeyError, match="vip"):
        ptt.load_state(pfile, device="cpu")


def test_pad_state_matches_jax():
    from ttcross_tpu.cross.state import pad_state as jpad_state

    rng = np.random.default_rng(11)
    jst = jempty_state(4, 5, 3, jax.random.PRNGKey(0))
    jst = jst._replace(**{f: jnp.asarray(rng.normal(size=getattr(jst, f).shape))
                          for f in ("cores", "colf", "rowf", "lu_c", "lu_u", "lu_d", "itl", "itt")},
                       vip=jnp.asarray(rng.integers(0, 3, size=(3, 3, 4)), jnp.int32))
    from ttcross_tpu_torch.interop import state_from_numpy

    pst = state_from_numpy({k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    got, want = pad_state(pst, 5), jpad_state(jst, 5)
    for f in CrossState._fields:
        if f != "sweeps":
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert pad_state(pst, 3) is pst
    with pytest.raises(ValueError, match="shrink"):
        pad_state(pst, 2)
    assert empty_state(4, 5, 5, torch.float64, "cpu").cores.shape == got.cores.shape
