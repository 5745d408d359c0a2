"""The port's native surface (ttcross_tpu_torch/native/, its own copy of
csrc/ttcross_native.cpp built with g++) against the JAX package's
ttcross_tpu.native, and ops/dd.py::pow2_balance against the JAX package's.

Both libraries compile the same source, so every name gives the JAX
package's bits; the port's takes its trains as the port's TT (cores on any
device) and reads a native file onto the device it is asked for.  A file
written by either package's tt_write_native is read back by the other.
Without g++ the port falls back to its own twins (ops/quadrature.py's dd
rule, tt/serialize.py) where the JAX package has fallbacks, and raises
elsewhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.tt.types as JTT
from ttcross_tpu import native as jnative
from ttcross_tpu_torch import native
from ttcross_tpu_torch.tt.types import from_cores


@pytest.fixture
def lib():
    """Builds the library at first use (in the test, not at collection);
    skips when it does not build."""
    if not native.available():
        pytest.skip("g++ / libquadmath unavailable")


def _cores(seed, n=(5, 4, 6), r=(1, 3, 2, 1), complex_=False):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(len(n)):
        a = rng.standard_normal((r[c], n[c], r[c + 1]))
        if complex_:
            a = a + 1j * rng.standard_normal(a.shape)
        out.append(a)
    return out


def test_every_jax_name_exists_in_the_port():
    for name in jnative.__all__:
        assert callable(getattr(native, name)), name
    for name in ("stdnorm_dd", "ising_c_dd", "cross_value_dd", "MP_FUN_CB"):
        assert hasattr(native, name) and hasattr(jnative, name)
    assert set(jnative.__all__) <= set(native.__all__)


@pytest.mark.parametrize("n", [1, 2, 17, 33, 65, 101])
def test_gauss_legendre_dd_bit_equal(n, lib):
    (px, pw), (jx, jw) = native.gauss_legendre_dd(n), jnative.gauss_legendre_dd(n)
    for a, b in zip(px + pw, jx + jw):
        assert np.array_equal(a, b)


def test_gaussian_chf_native_bit_equal_and_agrees_with_the_torch_chf(lib):
    from ttcross_tpu_torch.apps.cos import gaussian_chf

    rng = np.random.default_rng(3)
    d = 4
    mu = rng.standard_normal(d)
    A = rng.standard_normal((d, d))
    sigma = A @ A.T / d
    omega = rng.uniform(-1, 1, (50, d))
    p = native.gaussian_chf_native(omega, mu, sigma)
    assert np.array_equal(p, jnative.gaussian_chf_native(omega, mu, sigma))
    # tensors are taken too (copied to the host)
    assert np.array_equal(native.gaussian_chf_native(torch.from_numpy(omega), mu, sigma), p)
    ours = gaussian_chf(omega, mu, sigma, device="cpu").numpy()
    assert np.abs(ours - p).max() < 1e-13


def test_contract_q_equal(lib):
    cores = _cores(1)
    rng = np.random.default_rng(2)
    wh = [rng.standard_normal(c.shape[1]) for c in cores]
    wl = [w * 1e-17 for w in wh]
    p = native.contract_q(from_cores(cores, device="cpu"), wh, wl)
    j = jnative.contract_q(JTT.from_cores([jnp.asarray(c) for c in cores]), wh, wl)
    assert p == j
    p0 = native.contract_q(from_cores(cores, device="cpu"), [torch.from_numpy(w) for w in wh])
    assert p0 == jnative.contract_q(JTT.from_cores([jnp.asarray(c) for c in cores]), wh)


def test_dd_integrands_and_cross_value_equal(lib):
    rng = np.random.default_rng(4)
    (xh, xl), (wh, wl) = native.gauss_legendre_dd(17)
    ind = rng.integers(0, 17, (30, 3))
    for a, b in zip(native.stdnorm_dd(ind, xh, xl), jnative.stdnorm_dd(ind, xh, xl)):
        assert np.array_equal(a, b)
    x01h, x01l = (xh + 1) / 2, xl / 2
    p = native.ising_c_dd(torch.from_numpy(ind), x01h, x01l, wh, wl)
    for a, b in zip(p, jnative.ising_c_dd(ind, x01h, x01l, wh, wl)):
        assert np.array_equal(a, b)
    # a rank-1 cross interpolant: cores and a 1x1 pivot block per bond
    d, n = 3, [4, 4, 4]
    cores = [rng.standard_normal((1, 4, 1)) for _ in range(d)]
    ahat = [np.array([[cores[b][0, 1, 0]]]) for b in range(d - 1)]
    zeros = [np.zeros_like(c) for c in cores]
    w = [np.full(4, 0.25)] * d
    args = ([1, 1, 1, 1], n, cores, zeros, ahat, [np.zeros_like(a) for a in ahat], w,
            [np.zeros(4)] * d)
    assert native.cross_value_dd(*args) == jnative.cross_value_dd(*args)


@pytest.mark.parametrize("complex_", [False, True])
def test_native_files_cross_read(tmp_path, complex_, lib):
    cores = _cores(5, complex_=complex_)
    t = from_cores(cores, device="cpu")
    native.tt_write_native(t, str(tmp_path / "port.ttn"))
    j = jnative.tt_read_native(str(tmp_path / "port.ttn"))
    for a, b in zip(j.cores, cores):
        assert np.array_equal(np.asarray(a), b)
    jnative.tt_write_native(JTT.from_cores([jnp.asarray(c) for c in cores]),
                            str(tmp_path / "jax.ttn"))
    p = native.tt_read_native(str(tmp_path / "jax.ttn"), device="cpu")
    assert p.r == t.r and p.n == t.n and all(c.device.type == "cpu" for c in p.cores)
    for a, b in zip(p.cores, cores):
        assert np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="native TT"):
        (tmp_path / "bad.ttn").write_bytes(b"XXXX" + bytes(40))
        native.tt_read_native(str(tmp_path / "bad.ttn"), device="cpu")


def test_fallbacks_without_the_library(monkeypatch, tmp_path):
    """Without the library: the dd rule is the port's own decimal rule
    (within 1e-31 of the __float128 one), the TT IO is tt/serialize.py's
    format (which the JAX package's loader reads), the rest raise."""
    from ttcross_tpu.tt.serialize import load_ttbin as jload_ttbin
    from ttcross_tpu_torch.ops.quadrature import gauss_legendre_dd

    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    (px, pw) = native.gauss_legendre_dd(33)
    (qx, qw) = gauss_legendre_dd(33)
    for a, b in zip(px + pw, qx + qw):
        assert np.array_equal(a, b)
    (jx, jw) = jnative.gauss_legendre_dd(33)
    for (ah, al), (bh, bl) in ((px, jx), (pw, jw)):
        assert np.abs((ah - bh) + (al - bl)).max() < 1e-31
    cores = _cores(6)
    native.tt_write_native(from_cores(cores, device="cpu"), str(tmp_path / "f.tt"))
    back = native.tt_read_native(str(tmp_path / "f.tt"), device="cpu")
    for a, b in zip(back.cores, cores):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip(jload_ttbin(str(tmp_path / "f.tt")).cores, cores):
        assert np.array_equal(np.asarray(a), b)
    for fn, args in ((native.contract_q, (from_cores(cores, device="cpu"), [np.ones(5)] * 3)),
                     (native.stdnorm_dd, (np.zeros((1, 2), np.int64), np.zeros(3), np.zeros(3))),
                     (native.gaussian_chf_native, (np.zeros((1, 2)), np.zeros(2), np.eye(2)))):
        with pytest.raises(RuntimeError, match="native library unavailable"):
            fn(*args)


@pytest.mark.parametrize("scale", [1e-300, 1e-20, 1e-3, 1.0, 3.7, 1e5, 1e200, 0.0])
def test_pow2_balance_matches_jax(scale):
    """ops/dd.py::pow2_balance against the JAX package's (ttcross_tpu/ops/
    dd.py:231): the same exponent and the same balanced array, bit for bit,
    here read from the bits where the JAX package takes a log2."""
    from ttcross_tpu.ops.dd import pow2_balance as jpow2_balance
    from ttcross_tpu_torch.ops.dd import pow2_balance

    x = np.random.default_rng(8).standard_normal((4, 5)) * scale
    y, e = pow2_balance(torch.from_numpy(x))
    jy, je = jpow2_balance(jnp.asarray(x))
    assert float(e) == float(je) and e.dtype == torch.float64 and e.dim() == 0
    assert np.array_equal(y.numpy(), np.asarray(jy))
    if scale:
        assert 1.0 <= float(y.abs().max()) < 2.0
