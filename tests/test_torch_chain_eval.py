"""The port's chain evaluator (cross/chain_eval.py), the Ising chain spec,
the batched dense helpers and the vectorised chain tables, against the JAX
package's on the CPU.

Inputs come from a numpy seed and go through both packages; the port runs
on device="cpu", where kernel B (the lift's lookup) is its plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps.ising import make_ising as jmake_ising
from ttcross_tpu.cross import chains as jch
from ttcross_tpu.cross.chain_eval import ChainEvaluator as JChainEvaluator
from ttcross_tpu.cross.chain_eval import chain_fun as jchain_fun
from ttcross_tpu.ops import dense as jdense
from ttcross_tpu_torch.apps import ising as pising
from ttcross_tpu_torch.apps import make_ising
from ttcross_tpu_torch.cross import chains as pch
from ttcross_tpu_torch.cross.chain_eval import (ChainEvaluator, chain_fun, interface_states,
                                                interface_states_scan, reduce_merge)
from ttcross_tpu_torch.interop import chain_states_from_numpy, ising_from_numpy
from ttcross_tpu_torch.ops import dense as pdense

M, NQ, R = 32, 17, 6          # C_32 on a 17-point rule: d = 31
# the evaluators merge the same products and sums in another order than the
# integrand (and the two packages' reductions in yet another): rounding only
RTOL = 1e-13


@pytest.fixture(scope="module")
def problems():
    jp = jmake_ising("C", M, NQ)
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", M, jp.truth, "cpu")
    return jp, tp


def _vip(rng, d, n, rank=R):
    vip = rng.integers(0, n, size=(d - 1, rank, 4)).astype(np.int32)
    vip[:, :, 0] %= rank
    vip[:, :, 3] %= rank
    return vip


def test_chain_fun_matches_integrand_and_jax(problems):
    jp, tp = problems
    rng = np.random.default_rng(0)
    ind = rng.integers(0, jp.n, size=(300, jp.d)).astype(np.int32)
    got = chain_fun(tp.chain, tp.d)(torch.from_numpy(ind)).numpy()
    np.testing.assert_allclose(got, tp.fun(torch.from_numpy(ind)).numpy(), rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(jchain_fun(jp.chain, jp.d)(ind)), rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(jp.fun(ind)), rtol=RTOL)


@pytest.mark.parametrize("kind", ["D", "E"])
def test_only_kind_c_has_a_chain(kind, problems):
    assert make_ising(kind, 6, 17, device="cpu").chain is None
    assert jmake_ising(kind, 6, 17).chain is None
    _, tp = problems
    assert tp.chain is tp.chain            # one spec per problem


def test_lift_is_one_lookup_on_a_contiguous_2d_int32_index(problems, monkeypatch):
    """Every lift makes ONE small-table lookup on the stacked (2, n) tables,
    with an index that the kernel takes: 2-D, int32, contiguous (the kernel's
    wrapper raises on anything else, which the plain version would hide)."""
    _, tp = problems
    calls = []
    real = pising.small_table_lookup

    def checked(tables, ind):
        assert ind.dim() == 2 and ind.dtype == torch.int32 and ind.is_contiguous()
        assert tables.shape == (2, tp.n)
        calls.append(tuple(ind.shape))
        return real(tables, ind)

    monkeypatch.setattr(pising, "small_table_lookup", checked)
    spec = pising.ising_c_chain(tp.tables)
    vip = torch.from_numpy(_vip(np.random.default_rng(5), tp.d, tp.n))
    ev = ChainEvaluator(spec, tp.d)
    ev.states_from_vip(vip)
    assert calls == [(tp.d - 1, R)] * 2
    for idx in (vip[:, :, 1], vip[3, :, 2], torch.tensor(4), torch.arange(NQ)[None, :],
                torch.arange(12).reshape(2, 3, 2)):
        n0 = len(calls)
        out = spec.lift(None, idx)
        assert len(calls) == n0 + 1
        assert out["P"].shape == idx.shape and out["W"].shape == idx.shape
        assert torch.equal(out["P"], tp.tables[0][idx.long()])
        assert torch.equal(out["W"], tp.tables[1][idx.long()])


def test_states_from_vip_matches_jax_packed_states(problems):
    """Packed (Ls, Rs) against the JAX evaluator's, leaf order included (the
    sorted keys A, P, Q, W on the trailing axis), and against the table
    route and the plain fold of the port."""
    jp, tp = problems
    d = jp.d
    vip = _vip(np.random.default_rng(7), d, jp.n)
    jL, jR = JChainEvaluator(jp.chain, d).states_from_vip(jnp.asarray(vip))
    ev = ChainEvaluator(tp.chain, d)
    tv = torch.from_numpy(vip)
    Ls, Rs = ev.states_from_vip(tv)
    assert ev._keys == ["A", "P", "Q", "W"] and Ls.shape == (d - 1, R, 4)
    np.testing.assert_allclose(Ls.numpy(), np.asarray(jL), rtol=RTOL)
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jR), rtol=RTOL)
    Lt, Rt = ev.states(pch.all_left_tables(tv, d), pch.all_right_tables(tv, d))
    np.testing.assert_allclose(Lt.numpy(), Ls.numpy(), rtol=RTOL)
    np.testing.assert_allclose(Rt.numpy(), Rs.numpy(), rtol=RTOL)
    Lf, Rf = interface_states_scan(tp.chain, tv, d)
    np.testing.assert_allclose(ev._pack(Lf).numpy(), Ls.numpy(), rtol=RTOL)
    np.testing.assert_allclose(ev._pack(Rf).numpy(), Rs.numpy(), rtol=RTOL)
    pL, pR = chain_states_from_numpy(np.asarray(jL), np.asarray(jR), "cpu")
    assert pL.dtype == torch.float64 and np.array_equal(pR.numpy(), np.asarray(jR))


def test_update_states_equals_a_rebuild_and_jax(problems):
    """After accepts at some bonds, update_states gives the rows that a
    rebuild from the extended vip gives (1e-13; the fold's order against
    the doubling scan's), equals the JAX update (1e-13), and leaves every
    other row's bits alone."""
    jp, tp = problems
    d, nb = jp.d, jp.d - 1
    rng = np.random.default_rng(11)
    rank = R - 1                                # slot R - 1 is free on every bond
    vip = _vip(rng, d, jp.n)
    vip[:, :, [0, 3]] %= rank                   # no existing pivot links to the free slot
    vip[:, rank:, :] = 0
    ii, qq = rng.integers(0, rank, nb), rng.integers(0, rank, nb)
    jj, kk = rng.integers(0, jp.n, nb), rng.integers(0, jp.n, nb)
    upd = rng.random(nb) < 0.6
    upd[[0, nb - 1]] = True
    slots = np.full(nb, rank)
    ev, jev = ChainEvaluator(tp.chain, d), JChainEvaluator(jp.chain, d)
    Ls0, Rs0 = ev.states_from_vip(torch.from_numpy(vip))
    jL0, jR0 = jev.states_from_vip(jnp.asarray(vip))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    Ls, Rs = ev.update_states(Ls0.clone(), Rs0.clone(), t(ii), t(jj), t(kk), t(qq), t(upd),
                              t(slots))
    jL, jR = jev.update_states(jL0, jR0, *(jnp.asarray(a) for a in (ii, jj, kk, qq, upd, slots)))
    np.testing.assert_allclose(Ls.numpy(), np.asarray(jL), rtol=RTOL)
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jR), rtol=RTOL)
    vip2 = vip.copy()
    vip2[upd, rank] = np.stack([ii, jj, kk, qq], 1)[upd]
    Lr, Rr = ev.states_from_vip(torch.from_numpy(vip2))
    wroteL = np.zeros((nb, R), bool)
    wroteL[1:, rank] = upd[:-1]
    wroteR = np.zeros((nb, R), bool)
    wroteR[:-1, rank] = upd[1:]
    np.testing.assert_allclose(Ls.numpy()[wroteL], Lr.numpy()[wroteL], rtol=RTOL)
    np.testing.assert_allclose(Rs.numpy()[wroteR], Rr.numpy()[wroteR], rtol=RTOL)
    assert np.array_equal(Ls.numpy()[~wroteL], Ls0.numpy()[~wroteL])
    assert np.array_equal(Rs.numpy()[~wroteR], Rs0.numpy()[~wroteR])


def test_evaluators_match_the_integrand_on_assembled_indices(problems):
    """eval_cand, eval_col, eval_row and the two corner evaluators against
    the full integrand on the indices that the batched assemble_indices
    builds (itself checked against the per-bond form and the JAX one)."""
    jp, tp = problems
    d, n, nb = jp.d, jp.n, jp.d - 1
    rng = np.random.default_rng(1)
    vip = _vip(rng, d, n)
    tv = torch.from_numpy(vip)
    LT, RT = pch.all_left_tables(tv, d), pch.all_right_tables(tv, d)
    ev = ChainEvaluator(tp.chain, d)
    Ls, Rs = ev.states_from_vip(tv)
    ps, iN, iR = torch.arange(nb), torch.arange(n), torch.arange(R)
    B = 5
    i, q = (torch.from_numpy(rng.integers(0, R, (nb, B))) for _ in range(2))
    j, k = (torch.from_numpy(rng.integers(0, n, (nb, B))) for _ in range(2))

    def full(i, j, k, q):
        ind = pch.assemble_indices(LT, RT, ps, i, j, k, q, d)
        return tp.fun(ind.reshape(-1, d)).reshape(i.shape), ind

    want, ind = full(i, j, k, q)
    np.testing.assert_allclose(ev.eval_cand(Ls, Rs, ps, i, j, k, q).numpy(), want.numpy(),
                               rtol=RTOL)
    for b in (0, nb // 2, nb - 1):
        one = pch.assemble_indices(LT[b], RT[b], b, i[b], j[b], k[b], q[b], d)
        assert ind.dtype == torch.int32 and torch.equal(ind[b], one)
        jone = jch.assemble_indices(jnp.asarray(LT[b].numpy()), jnp.asarray(RT[b].numpy()), b,
                                    *(jnp.asarray(x[b].numpy()) for x in (i, j, k, q)), d)
        assert np.array_equal(one.numpy(), np.asarray(jone))
    # window-sliced states give the window's rows
    w = slice(3, 9)
    assert torch.equal(ev.eval_cand(Ls[w], Rs[w], ps[w], i[w], j[w], k[w], q[w]),
                       ev.eval_cand(Ls, Rs, ps, i, j, k, q)[w])

    ii, qq = (torch.from_numpy(rng.integers(0, R, nb)) for _ in range(2))
    jj, kk = (torch.from_numpy(rng.integers(0, n, nb)) for _ in range(2))
    RN = R * n
    col = lambda x: x[:, None].expand(nb, RN)  # noqa: E731
    want, _ = full(iR.repeat_interleave(n).expand(nb, RN), iN.repeat(R).expand(nb, RN),
                   col(kk), col(qq))
    np.testing.assert_allclose(ev.eval_col(Ls, Rs, ps, kk, qq, iN).reshape(nb, RN).numpy(),
                               want.numpy(), rtol=RTOL)
    want, _ = full(col(ii), col(jj), iN.repeat_interleave(R).expand(nb, RN),
                   iR.repeat(n).expand(nb, RN))
    np.testing.assert_allclose(ev.eval_row(Ls, Rs, ps, ii, jj, iN).reshape(nb, RN).numpy(),
                               want.numpy(), rtol=RTOL)
    cn = lambda x: x[:, None].expand(nb, n)  # noqa: E731
    want, _ = full(cn(ii), iN.expand(nb, n), cn(kk), cn(qq))
    np.testing.assert_allclose(ev.eval_corner_col(Ls, Rs, ps, ii, kk, qq, iN).numpy(),
                               want.numpy(), rtol=RTOL)
    want, _ = full(cn(ii), cn(jj), iN.expand(nb, n), cn(qq))
    np.testing.assert_allclose(ev.eval_corner_row(Ls, Rs, ps, ii, jj, qq, iN).numpy(),
                               want.numpy(), rtol=RTOL)


def test_reduce_merge_keeps_the_order_and_pads_with_the_identity(problems):
    _, tp = problems
    spec = tp.chain
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, tp.n, (4, 11)))
    states = spec.lift(None, idx)
    got = reduce_merge(spec, states, 11)
    acc = {k: v[:, 0] for k, v in states.items()}
    for s in range(1, 11):
        acc = spec.merge(acc, {k: v[:, s] for k, v in states.items()})
    for k in acc:
        np.testing.assert_allclose(got[k].numpy(), acc[k].numpy(), rtol=RTOL)
    Ls, _ = interface_states(spec, torch.zeros((2, 3, 3), dtype=torch.int32),
                             torch.zeros((2, 3, 3), dtype=torch.int32), 3)
    ident = spec.identity()
    assert all(float(Ls[k][0, 0]) == ident[k] for k in ident)      # bond 0: no mode to its left


@pytest.mark.parametrize("d", [40, 255])
def test_vectorised_chain_tables_match_the_recurrence_and_jax(d):
    """all_left_tables / all_right_tables (pointer doubling, log2(d) levels)
    against the per-bond advance_left / advance_right recurrence and, at
    d = 40, against the JAX package's associative scan: integers, exact."""
    rng = np.random.default_rng(d)
    rank = 5
    vip = _vip(rng, d, 17, rank)
    tv = torch.from_numpy(vip)
    tabs = [torch.zeros((rank, d), dtype=torch.int32)]
    for p in range(d - 2):
        tabs.append(pch.advance_left(tabs[-1], tv[p], p))
    LT = pch.all_left_tables(tv, d)
    assert LT.dtype == torch.int32 and torch.equal(LT, torch.stack(tabs))
    tabs = [torch.zeros((rank, d), dtype=torch.int32)]
    for p in range(d - 3, -1, -1):
        tabs.append(pch.advance_right(tabs[-1], tv[p + 1], p))
    RT = pch.all_right_tables(tv, d)
    assert torch.equal(RT, torch.stack(tabs[::-1]))
    for p in (0, 1, d // 2, d - 2):
        assert torch.equal(LT[p], pch.left_table(tv, p, d))
        assert torch.equal(RT[p], pch.right_table(tv, p, d))
    if d == 40:
        assert np.array_equal(LT.numpy(), np.asarray(jch.all_left_tables(jnp.asarray(vip), d)))
        assert np.array_equal(RT.numpy(), np.asarray(jch.all_right_tables(jnp.asarray(vip), d)))


def test_batched_row_lookup_and_masked_slot_write():
    rng = np.random.default_rng(3)
    tabs = rng.standard_normal((7, 11, 4))
    lin = rng.integers(0, 11, (7, 5))
    got = pdense.batched_row_lookup(torch.from_numpy(tabs), torch.from_numpy(lin))
    assert np.array_equal(got.numpy(), np.asarray(jdense.batched_row_lookup(jnp.asarray(tabs),
                                                                            jnp.asarray(lin))))
    one = pdense.batched_row_lookup(torch.from_numpy(tabs), torch.from_numpy(lin[:, 0]))
    assert one.shape == (7, 4) and torch.equal(one, got[:, 0])
    buf = torch.from_numpy(rng.standard_normal((7, 3, 5, 6)))
    slot = torch.from_numpy(rng.integers(0, 6, 7))
    upd = torch.from_numpy(rng.random(7) < 0.5)
    new = torch.from_numpy(rng.standard_normal((7, 3, 5)))
    want = buf.clone()
    for p in range(7):
        if upd[p]:
            want[p, :, :, slot[p]] = new[p]
    pdense.masked_slot_write(buf[:], 3, slot, new, upd)        # through a view, in place
    assert torch.equal(buf, want)
    rows = torch.from_numpy(rng.standard_normal((7, 5)))
    slot1 = slot.clamp(max=2)
    for p in range(7):
        if upd[p]:
            want[p, slot1[p], :, 0] = rows[p]
    pdense.masked_slot_write(buf[..., 0], 1, slot1, rows, upd)
    assert torch.equal(buf, want)


@pytest.mark.parametrize("d", [255, 1023])
def test_balanced_matmul_chain_over_the_whole_f64_range(d):
    """Stacks whose matrices have maxima near 1e-300 and 1e+300, in an
    order that keeps the running product finite, and a stack of subnormal
    maxima: the port's (P, e) against the JAX function's (P to 1e-12 of
    its unit scale, e exactly) and against an exact rescaled product."""
    rng = np.random.default_rng(d)
    Rm = 4
    base = rng.standard_normal((d, Rm, Rm)) + 2.0 * np.eye(Rm)
    expo = np.where(np.arange(d) % 2 == 0, -300.0, 300.0)
    expo[-1] = -300.0 if d % 2 else 0.0
    mats = base * 10.0 ** expo[:, None, None]
    P, e = pdense.balanced_matmul_chain(torch.from_numpy(mats))
    jP, je = jdense.balanced_matmul_chain(jnp.asarray(mats))
    assert float(e) == float(je)
    assert np.all(np.isfinite(P.numpy())) and 0.25 <= np.abs(P.numpy()).max() <= 4.0
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=0, atol=1e-12)
    m10 = np.floor(np.log10(np.abs(mats).max(axis=(1, 2))))
    ref = np.eye(Rm)
    e10 = 0.0
    for c in range(d):                       # the same product with decimal rescales
        ref = ref @ (mats[c] / 10.0 ** m10[c])
        s = np.floor(np.log10(np.abs(ref).max()))
        ref, e10 = ref / 10.0 ** s, e10 + m10[c] + s
    lg = np.log2(np.abs(P.numpy()[0, 0])) + float(e)
    np.testing.assert_allclose(lg, np.log2(np.abs(ref[0, 0])) + e10 * np.log2(10.0), rtol=1e-10)
    # subnormal maxima: 2^-e passes 2^1023, which no single f64 factor holds
    tiny = torch.from_numpy(base[:8] * 0 + 2.0 ** -1070 * np.sign(base[:8]))
    bal, et = pdense.pow2_balance_mats(tiny)
    assert torch.equal(et, torch.full((8,), -1070, dtype=torch.int64))
    assert torch.equal(bal, torch.from_numpy(np.sign(base[:8])))
    x = torch.tensor([2.0 ** -1074, 3 * 2.0 ** -1074, 2.0 ** 1000, 1.5, 1.0, 1.0],
                     dtype=torch.float64)
    e2 = torch.tensor([1074.0, 2000.0, -2000.0, -1074.0, 5000.0, -5000.0], dtype=torch.float64)
    want = [1.0, 3 * 2.0 ** 926, 2.0 ** -1000, 2.0 ** -1073, np.inf, 0.0]
    assert pdense.scale_pow2(x, e2).tolist() == want
