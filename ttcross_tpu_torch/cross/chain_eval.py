"""Chain-structured integrand evaluation (interface states).

Counterpart of ttcross_tpu/cross/chain_eval.py.  An integrand is
chain-structured when its value factors through a small per-prefix state
that composes associatively along the dimension axis: the Ising C_m
integrand 2/(v w) prod W is a 4-component product / prefix-sum monoid.  The
hunt candidates of a bond share their left chain (one of R pivot prefixes)
and their right chain (one of R suffixes), so with the merged state of every
prefix and suffix at hand a candidate costs 3 merges and a finalize, O(1),
instead of an O(d) integrand call on its full multi-index.

A ChainSpec supplies four callables on tensors, batched and broadcasting
over leading axes:

  identity()       -> state: a dict of Python floats (the monoid unit)
  lift(dims, idx)  -> state: a dict of tensors shaped like idx (integer
                      tensors; dims are the mode ids, for mode-dependent
                      tables)
  merge(a, b)      -> state (associative; a is the left block)
  finalize(state)  -> values

with fun(ind) == finalize(reduce(merge, [lift(s, ind[:, s]) for s])) up to
the order of association.  A state is a dict of tensors; the evaluator
packs its leaves, in the order of the sorted keys (the order in which the
JAX package flattens the same dict), on a trailing axis: (..., K).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.dense import masked_slot_write

__all__ = ["ChainSpec", "chain_fun", "reduce_merge", "interface_states",
           "interface_states_scan", "ChainEvaluator"]


class ChainSpec(NamedTuple):
    identity: Callable
    lift: Callable
    merge: Callable
    finalize: Callable


def _map(f, state):
    return {k: f(v) for k, v in state.items()}


def reduce_merge(spec: ChainSpec, states, length: int):
    """Order-preserving log2-depth reduction of `states` (leaves
    (..., length)) along the last axis with spec.merge, padded to the next
    power of two with the identity."""
    size = 1
    while size < max(length, 1):
        size *= 2
    if size != length:
        ident = spec.identity()
        states = {k: torch.cat([x, x.new_full(x.shape[:-1] + (size - length,), ident[k])],
                               dim=-1) for k, x in states.items()}
    while size > 1:
        states = spec.merge(_map(lambda x: x[..., 0:size:2], states),
                            _map(lambda x: x[..., 1:size:2], states))
        size //= 2
    return _map(lambda x: x[..., 0], states)


def chain_fun(spec: ChainSpec, d: int):
    """The full-index integrand of the spec: fun(ind (B, d) int) -> (B,)."""
    def fun(ind):
        dims = torch.arange(d, device=ind.device).expand(ind.shape)
        return spec.finalize(reduce_merge(spec, spec.lift(dims, ind), d))

    return fun


def interface_states(spec: ChainSpec, LT, RT, d: int):
    """Interface states from the bonds' chain tables LT, RT (d-1, R, d):
    state dicts with leaves (d-1, R),
      Ls[b, i] = merged state of modes 0..b-1 on left chain i,
      Rs[b, q] = merged state of modes b+2..d-1 on right chain q,
    by lifting every table entry and reducing along the modes."""
    ps = torch.arange(d - 1, device=LT.device)[:, None, None]
    dims = torch.arange(d, device=LT.device)
    ident = spec.identity()

    def side(tab, mask):
        lifted = spec.lift(dims.expand(tab.shape), tab)
        return reduce_merge(spec, {k: torch.where(mask, x, ident[k])
                                   for k, x in lifted.items()}, d)

    return side(LT, dims < ps), side(RT, dims > ps + 1)


def interface_states_scan(spec: ChainSpec, vip, d: int):
    """Interface states straight from the vip chains, as the plain fold
    along the chain walk:
      Ls[b+1][t] = merge(Ls[b][vip[b, t, 0]], lift(b, vip[b, t, 1])),
      Rs[b-1][t] = merge(lift(b+1, vip[b, t, 2]), Rs[b][vip[b, t, 3]]),
    from the identity at b = 0 and b = d-2.  It takes d-2 dependent steps
    per side, so the engine uses ChainEvaluator.states_from_vip (log2(d)
    levels) and update_states; this is the order of association that
    update_states keeps, and the reference the two are tested against
    (JAX: the same states by lax.associative_scan)."""
    nb, R = d - 1, vip.shape[1]
    ident = spec.identity()
    first = spec.lift(torch.zeros((R,), dtype=torch.long, device=vip.device), vip[0, :, 1])
    unit = {k: torch.full_like(first[k], ident[k]) for k in ident}
    Ls, Rs = [unit], [unit]
    for b in range(nb - 1):
        g = vip[b, :, 0].long()
        Ls.append(spec.merge(_map(lambda x: x[g], Ls[-1]),
                             spec.lift(torch.full_like(g, b), vip[b, :, 1])))
    for b in range(nb - 1, 0, -1):
        h = vip[b, :, 3].long()
        Rs.append(spec.merge(spec.lift(torch.full_like(h, b + 1), vip[b, :, 2]),
                             _map(lambda x: x[h], Rs[-1])))
    return ({k: torch.stack([s[k] for s in Ls]) for k in ident},
            {k: torch.stack([s[k] for s in Rs[::-1]]) for k in ident})


class ChainEvaluator:
    """Hunt-candidate evaluators bound to one ChainSpec.

    States are packed, the K leaves on a trailing axis, (d-1, R, K), so a
    link gather is one gather; they carry a leading bond axis that callers
    slice to their window.  What states() and states_from_vip() return is
    valid only as input to this evaluator's methods.  dtype: the dtype of
    the packed states, the engine's."""

    def __init__(self, spec: ChainSpec, d: int, dtype: torch.dtype = torch.float64):
        self.spec = spec
        self.d = d
        self.dtype = dtype
        self.fun = chain_fun(spec, d)
        ident = spec.identity()
        self._keys = sorted(ident)
        self._K = len(self._keys)
        self._ident = [float(ident[k]) for k in self._keys]

    def _pack(self, states):
        leaves = torch.broadcast_tensors(*[states[k] for k in self._keys])
        return torch.stack(leaves, dim=-1)

    def _unpack(self, arr):
        return {k: arr[..., i] for i, k in enumerate(self._keys)}

    def states(self, LT, RT):
        Ls, Rs = interface_states(self.spec, LT, RT, self.d)
        return self._pack(Ls), self._pack(Rs)

    def states_from_vip(self, vip):
        """Packed interface states (Ls, Rs), each (d-1, R, K), straight from
        the vip chains: a Hillis-Steele doubling scan of (link gather,
        payload) operators, log2(d) levels of one gather and one merge.

        Bond p's left operator acts on a state vector S as
        (O_p S)[t] = merge(S[g_p[t]], e_p[t]) with g_p = vip[p, :, 0] and
        e_p[t] = lift(p, vip[p, t, 1]); "earlier, then later" composes to
        (g_e[g_l], merge(e_e[g_l], e_l)).  The right operators mirror it
        with (vip[p, :, 3], lift(p+1, vip[p, :, 2])) and "later, then
        earlier" (h_l[h_e], merge(f_e, f_l[h_e])).  Rows shifted in are the
        identity operator.  The merges associate in another order than the
        chain walk's fold: equal to rounding."""
        sp, K = self.spec, self._K
        nb, R = self.d - 1, vip.shape[1]
        dev = vip.device
        ps = torch.arange(nb, device=dev)
        # the identity's leaves, filled on the device: a tensor made from the
        # Python floats would be a host-to-device copy, which waits
        identE = torch.stack([torch.full((), v, dtype=self.dtype, device=dev)
                              for v in self._ident])
        iR = torch.arange(R, device=dev)

        def hs_scan(g, e, reverse: bool):
            shift = 1
            while shift < nb:
                gI = iR.expand(shift, R)
                eI = identE.expand(shift, R, K)
                if not reverse:
                    ga = torch.cat([gI, g[:-shift]])          # the earlier operator
                    ea = torch.cat([eI, e[:-shift]])
                else:
                    ga = torch.cat([g[shift:], gI])           # the later operator
                    ea = torch.cat([e[shift:], eI])
                eg = self._unpack(ea.gather(1, g[:, :, None].expand(nb, R, K)))
                eb = self._unpack(e)
                e = self._pack(sp.merge(eb, eg) if reverse else sp.merge(eg, eb))
                g = ga.gather(1, g)
                shift *= 2
            return e

        def payload(dims, idx):
            return self._pack(sp.lift(dims, idx)).to(self.dtype).expand(nb, R, K)

        identRow = identE.expand(1, R, K)
        eP = hs_scan(vip[:, :, 0].long(), payload(ps[:, None], vip[:, :, 1]), False)
        fS = hs_scan(vip[:, :, 3].long(), payload(ps[:, None] + 1, vip[:, :, 2]), True)
        return torch.cat([identRow, eP[:-1]]), torch.cat([fS[1:], identRow])

    def update_states(self, Ls, Rs, ii, jj, kk, qq, upd, slots):
        """Append the accepted pivots' interface-state rows, IN PLACE.

        vip is append-only (accepted pivots extend the chains, existing
        entries never change), so every row of Ls / Rs stays valid and only
        the new slot row of each accepting bond's neighbours is missing:

          Ls[p+1][s_p] = merge(Ls[p][i_p], lift(p, j_p))      (prefix)
          Rs[p-1][s_p] = merge(lift(p+1, k_p), Rs[p][q_p])    (suffix)

        Ls, Rs packed (d-1, R, K); ii, jj, kk, qq, upd, slots (d-1,): the
        accept rows, slots the slot written (rk[p+1] before the accept).
        One gather, one merge and one masked slot write per side, batched
        over bonds, with no wait for the device.  The merges associate as
        the chain walk's fold does."""
        sp = self.spec
        nb, R = self.d - 1, Ls.shape[1]
        ps = torch.arange(nb, device=Ls.device)
        slot = slots.long().clamp(max=R - 1)      # a saturated bond never accepts

        def row(S, idx):
            return self._unpack(S.gather(1, idx.long().view(nb, 1, 1).expand(nb, 1, self._K))[:, 0])

        newL = self._pack(sp.merge(row(Ls, ii), sp.lift(ps, jj))).to(Ls.dtype)
        newR = self._pack(sp.merge(sp.lift(ps + 1, kk), row(Rs, qq))).to(Rs.dtype)
        masked_slot_write(Ls[1:], 1, slot[:-1], newL[:-1], upd[:-1])
        masked_slot_write(Rs[:-1], 1, slot[1:], newR[1:], upd[1:])
        return Ls, Rs

    def _take(self, Sp, idx):
        """One gather on the packed states: Sp (mc, R, K), idx (mc, B) ->
        a state with leaves (mc, B)."""
        mc, B = idx.shape
        return self._unpack(Sp.gather(1, idx.long()[:, :, None].expand(mc, B, self._K)))

    def eval_cand(self, Lw, Rw, psw, i, j, k, q):
        """Candidates (i, j, k, q) (mc, B) at the window's bonds psw (mc,)
        -> values (mc, B).  Lw, Rw: the window's packed states (mc, R, K)."""
        sp = self.spec
        lj = sp.lift(psw[:, None], j)
        lk = sp.lift(psw[:, None] + 1, k)
        return sp.finalize(sp.merge(sp.merge(self._take(Lw, i), lj),
                                    sp.merge(lk, self._take(Rw, q))))

    def eval_col(self, Lw, Rw, psw, kk, qq, iN):
        """Column fibers: all (i, j) over (R, N) at each bond's fixed
        (kk, qq) -> (mc, R, N)."""
        sp = self.spec
        L2 = sp.merge(_map(lambda a: a[:, :, None], self._unpack(Lw)),
                      _map(lambda a: a[:, None, :], sp.lift(psw[:, None], iN[None, :])))
        Rfix = sp.merge(sp.lift(psw[:, None] + 1, kk[:, None]),
                        self._take(Rw, qq[:, None]))                     # (mc, 1)
        return sp.finalize(sp.merge(L2, _map(lambda a: a[:, :, None], Rfix)))

    def eval_row(self, Lw, Rw, psw, ii, jj, iN):
        """Row fibers: all (k, q) over (N, R) at each bond's fixed (ii, jj)
        -> (mc, N, R)."""
        sp = self.spec
        Lfix = sp.merge(self._take(Lw, ii[:, None]),
                        sp.lift(psw[:, None], jj[:, None]))              # (mc, 1)
        R2 = sp.merge(_map(lambda a: a[:, :, None], sp.lift(psw[:, None] + 1, iN[None, :])),
                      _map(lambda a: a[:, None, :], self._unpack(Rw)))
        return sp.finalize(sp.merge(_map(lambda a: a[:, None, :], Lfix), R2))

    def eval_corner_col(self, Ls, Rs, ps, i0, kk, qq, iN):
        """Corner column fibers (nb, N): mode j varies at each bond's fixed
        (i0, kk, qq) (the jacobi corner repair)."""
        sp = self.spec
        lj = sp.lift(ps[:, None], iN[None, :])                           # (1, N)
        Rfix = sp.merge(sp.lift(ps[:, None] + 1, kk[:, None]),
                        self._take(Rs, qq[:, None]))                     # (nb, 1)
        return sp.finalize(sp.merge(sp.merge(self._take(Ls, i0[:, None]), lj), Rfix))

    def eval_corner_row(self, Ls, Rs, ps, ii, jj, q0, iN):
        """Corner row fibers (nb, N): mode k varies at each bond's fixed
        (ii, jj, q0)."""
        sp = self.spec
        Lfix = sp.merge(self._take(Ls, ii[:, None]),
                        sp.lift(ps[:, None], jj[:, None]))               # (nb, 1)
        lk = sp.lift(ps[:, None] + 1, iN[None, :])
        return sp.finalize(sp.merge(Lfix, sp.merge(lk, self._take(Rs, q0[:, None]))))
