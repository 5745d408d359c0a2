"""The port's chain tables and growing LU against the JAX ones."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.cross import chains as jch
from ttcross_tpu.ops import lu as jlu
from ttcross_tpu_torch.cross import chains as pch
from ttcross_tpu_torch.ops import lu as plu

# triangular solves and products sum in another order: a few ulps of the
# largest entry (an entry that cancels to near 0 keeps that absolute error)
RTOL = 1e-13


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(want)))


def _vip(rng, d=6, R=5):
    return rng.integers(0, R, size=(d - 1, R, 4)).astype(np.int32)


def test_tables_exact(rng):
    d, R = 6, 5
    vip = _vip(rng, d, R)
    jv, pv = jnp.asarray(vip), torch.from_numpy(vip)
    for p in range(d - 1):
        assert np.array_equal(pch.left_table(pv, p, d).numpy(),
                              np.asarray(jch.left_table(jv, p, d)))
        assert np.array_equal(pch.right_table(pv, p, d).numpy(),
                              np.asarray(jch.right_table(jv, p, d)))
    assert np.array_equal(pch.all_left_tables(pv, d).numpy(),
                          np.asarray(jch.all_left_tables(jv, d)))
    assert np.array_equal(pch.all_right_tables(pv, d).numpy(),
                          np.asarray(jch.all_right_tables(jv, d)))
    tab = np.asarray(jch.left_table(jv, 2, d))
    assert np.array_equal(pch.advance_left(torch.from_numpy(tab), pv[2], 2).numpy(),
                          np.asarray(jch.advance_left(jnp.asarray(tab), jv[2], 2)))
    tab = np.asarray(jch.right_table(jv, 3, d))
    assert np.array_equal(pch.advance_right(torch.from_numpy(tab), pv[3], 2).numpy(),
                          np.asarray(jch.advance_right(jnp.asarray(tab), jv[3], 2)))


@pytest.mark.parametrize("p", [0, 2, 4])
def test_assemble_indices_exact(p, rng):
    d, R, N, B = 6, 5, 9, 40
    vip = _vip(rng, d, R)
    lt = np.asarray(jch.left_table(jnp.asarray(vip), p, d))
    rt = np.asarray(jch.right_table(jnp.asarray(vip), p, d))
    i, q = rng.integers(0, R, B), rng.integers(0, R, B)
    j, k = rng.integers(0, N, B), rng.integers(0, N, B)
    want = np.asarray(jch.assemble_indices(jnp.asarray(lt), jnp.asarray(rt), p,
                                           *map(jnp.asarray, (i, j, k, q)), d))
    got = pch.assemble_indices(torch.from_numpy(lt), torch.from_numpy(rt), p,
                               *map(torch.from_numpy, (i, j, k, q)), d)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _lu(rng, R=6):
    c = rng.standard_normal((R, R))
    u = rng.standard_normal((R, R))
    dd = 1.0 + rng.random(R)
    return (jlu.GrowingLU(jnp.asarray(c), jnp.asarray(u), jnp.asarray(dd)),
            plu.GrowingLU(*map(torch.from_numpy, (c, u, dd))))


@pytest.mark.parametrize("r", [0, 3, 6])
def test_lu_matches_jax(r, rng):
    R = 6
    jl, pl = _lu(rng, R)
    for f in ("make_T", "make_L"):
        assert np.array_equal(getattr(plu, f)(pl, r).numpy(),
                              np.asarray(getattr(jlu, f)(jl, r))), f
    C = rng.standard_normal((4, 3, R))
    _close(plu.solve_cols(pl, r, torch.from_numpy(C)).numpy(),
           np.asarray(jlu.solve_cols(jl, r, jnp.asarray(C))))
    Rm = rng.standard_normal((R, 3, 4))
    _close(plu.solve_rows(pl, r, torch.from_numpy(Rm)).numpy(),
           np.asarray(jlu.solve_rows(jl, r, jnp.asarray(Rm))))
    prev = rng.standard_normal((5, 7, R))
    vec, acol, delta = rng.standard_normal(R), rng.standard_normal((5, 7)), 0.37
    _close(
        plu.apply_new_col(torch.from_numpy(prev), torch.from_numpy(vec), delta,
                          torch.from_numpy(acol), r).numpy(),
        np.asarray(jlu.apply_new_col(jnp.asarray(prev), jnp.asarray(vec), delta,
                                     jnp.asarray(acol), r)))
    prev_r = rng.standard_normal((R, 7, 5))
    arow = rng.standard_normal((7, 5))
    _close(
        plu.apply_new_row(torch.from_numpy(prev_r), torch.from_numpy(vec),
                          torch.from_numpy(arow), r).numpy(),
        np.asarray(jlu.apply_new_row(jnp.asarray(prev_r), jnp.asarray(vec),
                                     jnp.asarray(arow), r)))
    if r < R:
        cn, un = rng.standard_normal(R), rng.standard_normal(R)
        ja = jlu.lu_append(jl, r, jnp.asarray(cn), jnp.asarray(un), 2.5)
        pa = plu.lu_append(pl, r, torch.from_numpy(cn), torch.from_numpy(un), 2.5)
        for a, b in zip(pa, ja):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(pl.c.numpy(), np.asarray(jl.c))   # not modified
