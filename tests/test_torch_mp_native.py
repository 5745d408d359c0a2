"""The port's compiled MPFR engine (csrc/mpfr_cross.cpp built by
native/_mpfr.py; cross/engine_mp_native.py) against the JAX package's.

The two libraries are built from copies of one source against the same
MPFR, so ising_cross_mp_native and cross_mp_native give the JAX package's
value strings, evaluation counts, ranks and histories exactly.  The port's
library is built into the checkout's build/ directory and never taken
from the JAX package's native directory.  The tests skip only when the
library does not build (no g++ or no libmpfr), as the JAX package's do
(tests/test_mp_native.py:15)."""

from pathlib import Path

import pytest

import ttcross_tpu  # noqa: F401  (x64)
from ttcross_tpu import native as jnative
from ttcross_tpu_torch import native
from ttcross_tpu_torch.native import _mpfr


@pytest.fixture
def mpfr():
    """Builds the library at first use (in the test, not at collection);
    skips when it does not build."""
    if not native.mpfr_available():
        pytest.skip("libmpfr/g++ unavailable")


def _same(p, j):
    assert (p.value_str, p.neval, p.sweeps, p.ranks) == (j.value_str, j.neval, j.sweeps, j.ranks)
    assert p.history == j.history and p.digits == j.digits


def test_abi_selftest_and_build_place(mpfr):
    lib = native.load_mpfr()
    assert lib.mp_selftest() == _mpfr.SELFTEST == 27182818
    built = Path(lib._name).resolve()
    root = Path(native.__file__).resolve().parents[2]
    assert built.is_relative_to(root / "build" / "ttcross_tpu_torch"), built
    assert "ttcross_tpu/native" not in str(built)
    assert native.build_mpfr() and native.mpfr_available()


@pytest.mark.parametrize("kind, m, n, rank, dps", [("C", 4, 17, 8, 60), ("D", 4, 17, 8, 60),
                                                   ("E", 4, 17, 8, 60), ("C", 5, 9, 6, 120)])
def test_ising_cross_mp_native_matches_jax(kind, m, n, rank, dps, mpfr):
    from ttcross_tpu.cross.engine_mp_native import ising_cross_mp_native as jrun
    from ttcross_tpu_torch.cross import ising_cross_mp_native

    p = ising_cross_mp_native(kind, m=m, n=n, max_rank=rank, dps=dps)
    j = jrun(kind, m=m, n=n, max_rank=rank, dps=dps)
    _same(p, j)
    assert p.sweeps >= 3 and p.digits is not None and p.digits > 5   # C_5 at n = 9: 5.72


def test_ising_c4_native_digits(mpfr):
    """The JAX package's accuracy test: C_4 at n = 33, rank 16, dps 120
    beyond 18 digits, bit for bit the JAX run."""
    from ttcross_tpu.cross.engine_mp_native import ising_cross_mp_native as jrun
    from ttcross_tpu_torch.cross import ising_cross_mp_native

    p = ising_cross_mp_native("C", m=4, n=33, max_rank=16, dps=120)
    _same(p, jrun("C", m=4, n=33, max_rank=16, dps=120))
    assert p.digits > 18 and p.neval > 5000 and p.ranks[1] == 16


def test_cross_mp_native_callback_matches_jax(mpfr):
    """The native engine with the port's mp integrand (IsingMP) through the
    decimal-string callback equals the JAX package's with its own."""
    import ttcross_tpu.apps.ising as JI
    from mpmath import mp, workdps
    from ttcross_tpu.cross.engine_mp_native import cross_mp_native as jrun
    from ttcross_tpu_torch.apps import make_ising_mp
    from ttcross_tpu_torch.cross import cross_mp_native

    dps = 60
    d, n, f, q, t = make_ising_mp("C", m=4, n=17, dps=dps)
    _, _, jf, jq, jt = JI.make_ising_mp("C", m=4, n=17, dps=dps)
    p = cross_mp_native(f, [n] * d, max_rank=8, quad=q, truth=t, dps=dps)
    j = jrun(jf, [n] * d, max_rank=8, quad=jq, truth=jt, dps=dps)
    _same(p, j)
    with workdps(dps):
        assert float(-mp.log10(abs(1 - p.value / t))) > 9
    with pytest.raises(ValueError, match="quad length"):
        cross_mp_native(f, [n] * d, max_rank=4, quad=[q[0][:3]] * d, dps=dps)


def test_without_the_library_the_mp_native_engine_raises(monkeypatch, mpfr):
    from ttcross_tpu_torch.cross import engine_mp_native as E

    monkeypatch.setattr(E.native, "load_mpfr", lambda: None)
    with pytest.raises(RuntimeError, match="MPFR"):
        E.ising_cross_mp_native("C", m=4, n=9, max_rank=4, dps=30)


def test_unknown_kind_rejected(mpfr):
    from ttcross_tpu_torch.cross import ising_cross_mp_native

    with pytest.raises(ValueError):
        ising_cross_mp_native("X", m=4, n=9)
    assert jnative.mpfr_available() == native.mpfr_available()
