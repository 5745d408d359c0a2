"""All-bonds-batched (Jacobi) sweep machinery.

Counterpart of ttcross_tpu/cross/engine_jacobi.py: the reference's
dimension-parallel decomposition taken to its limit (a slab is one bond;
the staleness license of dmrgg.f90:822-850, the corner repair of
dmrgg.f90:928-932).  Every bond hunts at once against the start-of-sweep
factors, so a sweep costs a fixed number of batched integrand calls and
tensor ops whatever the chain length: the throughput mode for long chains
(C_256 and up).  build_jacobi binds the closures to one engine context.

A family of runs (cross/batch.py::cross_batch(sweep_mode="jacobi")) goes
through the same closures with a lane axis: the engine works on lane
states (cross/state.py; one run is its one-lane view) and flattens every
(bond, lane) pair into one row, bond-major, so kernel A batched scores P =
(bonds) x (lanes) fibers in one launch, every slot write is one masked
write over the rows, and a lane that is not live is frozen as the
sequential lane engine freezes it.  Every product is summed over a short
contiguous axis (ops/dense.py::matmul_by_sums), so a lane repeats its
single run bit for bit.

What differs from the JAX module, on purpose:
* the fiber residuals are scored in f64 by kernel A batched over bonds
  (ops/kernels.py::score_residual_argmax_batched), whose residual is the
  pivot; JAX scores in f32, which its TPU emulates f64 by, and recomputes
  the chosen pivot in f64.  At an f32 near-tie the two may pick differently;
* the lottery draws from an exact integer cumsum held in f32 (JAX: a
  triangular-ones f32 matmul, the same counts) and marks used pivots with a
  scatter (JAX: any-compares);
* every accept-slot write is an in-place masked write at the bond's slot
  (ops/dense.py::masked_slot_write; JAX: a one-hot select of the whole
  array), so the state is updated in place.
No step waits for the device: every decision is a tensor mask.
"""

from __future__ import annotations

import torch

from ..ops.dense import batched_row_lookup, masked_slot_write, matmul_by_sums
from ..ops.kernels import score_residual_argmax_batched
from ..utils.metrics import span
from .chains import all_left_tables, all_right_tables, assemble_indices
from .state import CrossState, as_lanes, lane

__all__ = ["build_jacobi"]

_SCALARS = ("amax", "pivotmax", "pivotmin", "pivotmax_prev", "neval", "padded")


def build_jacobi(cfg, fun, d, N, R, NLOT, iR, iN, n_t, chain_ev=None,
                 dtype: torch.dtype = torch.float64, lanes: int = 0):
    """Build (sweep, jacobi_hunt, jacobi_apply) bound to the engine
    context: cfg and fun, the static geometry (d, N, R, NLOT) and the index
    vectors iR, iN and per-mode sizes n_t on the engine's device, and the
    state's dtype.

    lanes = 0: fun(ind (B, d)) -> (B,), and sweep(st, fwd, U (d-1, 2,
    NLOT), cs=None, lw=None) takes one run's state.  lanes = L >= 1:
    fun(ind (L, B, d)) -> (L, B), and sweep(st, fwd, U (L, d-1, 2, NLOT),
    lw=None, live=None) takes a lane state, live (L,) the lanes that sweep.
    jacobi_hunt and jacobi_apply take one run (the distributed engine's
    window-wise calls, parallel/engine.py).

    chain_ev (one run only): optional cross/chain_eval.py::ChainEvaluator
    of a chain-structured integrand; hunt candidates are then evaluated in
    O(1) from per-bond interface states (3 merges and a finalize) instead
    of an O(d) integrand call on assembled (B, d) indices.  n_evals counts
    the same tensor entries either way."""
    ce = chain_ev
    dev = iR.device
    RN = R * N
    L = max(lanes, 1)
    nb = d - 1
    lot = torch.arange(NLOT, device=dev)
    # candidate enumerations: column fibers vary (i, j) over (R, N), row
    # fibers (k, q) over (N, R)
    ci_g, cj_g = iR.repeat_interleave(N), iN.repeat(R)
    rg_k, rg_q = iN.repeat_interleave(R), iR.repeat(N)

    def evalf(ind):
        """The integrand on rows of candidates: ind (P, B, d), P = bonds x
        lanes bond-major -> (P, B)."""
        P, B = ind.shape[:2]
        if not lanes:
            return fun(ind.reshape(-1, d)).reshape(P, B)
        mc = P // L
        out = fun(ind.view(mc, L, B, d).transpose(0, 1).reshape(L, mc * B, d))
        return out.view(L, mc, B).transpose(0, 1).reshape(P, B)

    def lane_max(x, mc):
        """(mc * L, ...) rows -> (L,): each lane's maximum."""
        return x.reshape(mc, L, -1).amax(dim=(0, 2))

    def lane_sum(x, mc):
        """(mc * L,) rows -> (L,): each lane's sum."""
        return x.view(mc, L).sum(dim=0)

    def _hunt(st: CrossState, U, dir_fwd: bool, base: int, mc: int, live, lw=None, cs=None):
        """The batched hunt on a lane state: bonds base .. base+mc-1 of
        every lane, as P = mc * L rows; U (P, 2, NLOT), live (P,).  Returns
        (hunt dict of (P, ...) rows, amax', neval', padded'), the counters
        per lane (L,)."""
        P = mc * L

        def win(a, off=0):
            """Rows of a lane array's window: a[base+off : ...+mc] as (P, ...)."""
            w = a[base + off:base + off + mc]
            return w.reshape((P,) + tuple(w.shape[2:]))

        def wmode(a, off=0):
            """Rows of a per-mode (d, ...) array's window, repeated per lane."""
            w = a[base + off:base + off + mc]
            return w if L == 1 else w.repeat_interleave(L, dim=0)

        psw = base + torch.arange(mc, device=dev)
        psw = psw if L == 1 else psw.repeat_interleave(L)
        if ce is None:
            LT = win(all_left_tables(st.vip, d))       # (P, R, d)
            RT = win(all_right_tables(st.vip, d))
        else:
            Lsf, Rsf = cs if cs is not None else ce.states_from_vip(st.vip[:, 0])
            Lw, Rw = Lsf[base:base + mc], Rsf[base:base + mc]
        rk = st.rk.long()
        rk_l, rk_b, rk_r = win(rk), win(rk, 1), win(rk, 2)   # rk[p], rk[p+1], rk[p+2]
        n_l, n_r = wmode(n_t), wmode(n_t, 1)
        colf_flat = win(st.colf).reshape(P, RN, R)    # slot p; row i*N + j
        rowf_mat = win(st.rowf, 1).reshape(P, R, RN)  # slot p+1; column k*R + q
        rmask_b = (iR[None, :] < rk_b[:, None]).to(dtype)              # (P, R)
        lv = live[:, None, None]
        cmask = (lv & (iR[None, :, None] < rk_l[:, None, None])
                 & (iN[None, None, :] < n_l[:, None, None]))             # (P, R, N)
        rmask2 = (lv & (iN[None, :, None] < n_r[:, None, None])
                  & (iR[None, None, :] < rk_r[:, None, None]))           # (P, N, R)

        def rowf_cols(kq):
            """rowf[p+1][:, k, q] as rows: kq (P, B) -> (P, B, R); (P,) -> (P, R)."""
            single = kq.dim() == 1
            if single:
                kq = kq[:, None]
            out = rowf_mat.gather(2, kq[:, None, :].expand(P, R, kq.shape[1])).transpose(1, 2)
            return out[:, 0] if single else out

        def col_fiber(kk, qq):
            """Raw column fibers (P, R, N) at each row's (kk, qq), masked."""
            if ce is None:
                ind = assemble_indices(LT, RT, psw, ci_g.expand(P, RN), cj_g.expand(P, RN),
                                       kk[:, None].expand(P, RN), qq[:, None].expand(P, RN), d)
                vals = evalf(ind).reshape(P, R, N)
            else:
                vals = ce.eval_col(Lw, Rw, psw, kk, qq, iN)
            return torch.where(cmask, vals, 0.0)

        def row_fiber(ii, jj):
            """Raw row fibers (P, N, R) at each row's (ii, jj), masked."""
            if ce is None:
                ind = assemble_indices(LT, RT, psw, ii[:, None].expand(P, RN),
                                       jj[:, None].expand(P, RN), rg_k.expand(P, RN),
                                       rg_q.expand(P, RN), d)
                vals = evalf(ind).reshape(P, N, R)
            else:
                vals = ce.eval_row(Lw, Rw, psw, ii, jj, iN)
            return torch.where(rmask2, vals, 0.0)

        # ---------------- batched lottery (one integrand call for all rows)
        # layouts: columns (i, j) flattened i*N + j; rows (q, k) q*N + k.
        # Zero weight on the pivots already used (dmrgg.f90:432-439);
        # padding rows of vip repeat index 0, so the scatter takes the max
        smask = (iR[None, :] < rk_b[:, None]).to(torch.int32)
        vb = win(st.vip).long()                                          # (P, R, 4)
        used_col = torch.zeros((P, RN), dtype=torch.int32, device=dev).scatter_reduce_(
            1, vb[:, :, 0] * N + vb[:, :, 1], smask, "amax")
        used_row = torch.zeros((P, RN), dtype=torch.int32, device=dev).scatter_reduce_(
            1, vb[:, :, 3] * N + vb[:, :, 2], smask, "amax")
        wcol = cmask.reshape(P, RN) & (used_col == 0)
        wrow = rmask2.transpose(1, 2).reshape(P, RN) & (used_row == 0)
        # the draw rounds exactly as the JAX engine's: the CDF of the 0/1
        # weights is an integer cumsum held in f32 (exact below 2^24), the
        # target f32(u) * total clamped to total * f32(1 - 2^-20), the pick
        # searchsorted(right)
        if lw is None:
            cdf_c = torch.cumsum(wcol.to(torch.int32), 1).to(torch.float32)
            cdf_r = torch.cumsum(wrow.to(torch.int32), 1).to(torch.float32)
        else:
            # weighted: the f64 cumsum of the scaled weights, then f32 (the
            # JAX engine sums the unscaled |w| in f32, which underflows for
            # small weights; the picks agree but at f32 ties of the CDF)
            cdf_c = torch.cumsum(wcol * wmode(lw).repeat(1, R), 1).to(torch.float32)
            cdf_r = torch.cumsum(wrow * wmode(lw, 1).repeat(1, R), 1).to(torch.float32)
        below = 1.0 - 2.0 ** -20          # exact in f32
        tot_c, tot_r = cdf_c[:, -1:], cdf_r[:, -1:]
        t_c = torch.minimum(U[:, 0, :].to(torch.float32) * torch.where(tot_c > 0, tot_c, 1.0),
                            tot_c * below)
        t_r = torch.minimum(U[:, 1, :].to(torch.float32) * torch.where(tot_r > 0, tot_r, 1.0),
                            tot_r * below)
        lin_c = torch.searchsorted(cdf_c, t_c.contiguous(), right=True).clamp(max=RN - 1)
        lin_r = torch.searchsorted(cdf_r, t_r.contiguous(), right=True).clamp(max=RN - 1)
        i_c, j_c = lin_c // N, lin_c % N
        q_c, k_c = lin_r // N, lin_r % N
        nlot_act = rk_l + n_l + n_r + rk_r
        candmask = live[:, None] & (lot[None, :] < nlot_act[:, None])
        if ce is None:
            b = evalf(assemble_indices(LT, RT, psw, i_c, j_c, k_c, q_c, d))  # (P, NLOT)
        else:
            b = ce.eval_cand(Lw, Rw, psw, i_c, j_c, k_c, q_c)
        amax = torch.maximum(st.amax, lane_max(torch.where(candmask, b.abs(), 0.0), mc))
        neval = st.neval + lane_sum(torch.where(live, nlot_act, 0), mc)
        padded = st.padded + mc * NLOT
        # residual b - colf[p][i,j,:] . rowf[p+1][:,k,q]  (dmrgg.f90:469-476)
        cf = batched_row_lookup(colf_flat, lin_c)                        # (P, NLOT, R)
        rf = rowf_cols(k_c * R + q_c)
        resid = b - (cf * rf * rmask_b[:, None, :]).sum(dim=2)
        best = torch.argmax(torch.where(candmask, resid.abs(), -1.0), dim=1)[:, None]
        ii, jj, kk, qq = (x.gather(1, best)[:, 0] for x in (i_c, j_c, k_c, q_c))
        pivot = resid.gather(1, best)[:, 0]

        if cfg.piv == 0:
            # the seed's fibers once: one column call and one row call
            acol, arow = col_fiber(kk, qq), row_fiber(ii, jj)
            amax = torch.maximum(amax, torch.maximum(lane_max(acol.abs(), mc),
                                                     lane_max(arow.abs(), mc)))
            neval = neval + lane_sum(torch.where(live, rk_l * n_l + n_r * rk_r, 0), mc)
            padded = padded + 2 * mc * RN
        else:
            # ---------------- batched rook passes (dmrgg.f90:515-582): 2*piv
            # masked passes, one integrand call and one kernel-A launch each
            # ('>>' sweeps start with a column pass, '<<' with a row pass).
            # `done` is a tensor flag per row; whether the budget ends a
            # pass depends on the pass number only, so the host knows it
            acol = torch.zeros((P, R, N), dtype=dtype, device=dev)
            arow = torch.zeros((P, N, R), dtype=dtype, device=dev)
            done = ~live
            havecol = haverow = False
            for t in range(2 * cfg.piv):
                act = ~done
                if dir_fwd == (t % 2 == 0):      # column pass
                    new = col_fiber(kk, qq)
                    dnev = rk_l * n_l
                    u = rowf_cols(kk * R + qq) * rmask_b                 # (P, R)
                    flat, _, pv = score_residual_argmax_batched(
                        new.reshape(P, RN, 1), colf_flat, u[:, :, None],
                        cmask.reshape(P, RN, 1))
                    a2, b2 = flat // N, flat % N
                    budget = haverow and t + 1 >= 2 * cfg.piv
                    stat = ((a2 == ii) & (b2 == jj)) if haverow else torch.zeros_like(done)
                    havecol = True
                    acol = torch.where(act[:, None, None], new, acol)
                    if not budget:
                        ii, jj = torch.where(act, a2, ii), torch.where(act, b2, jj)
                else:                            # row pass
                    new = row_fiber(ii, jj)
                    dnev = n_r * rk_r
                    cw = batched_row_lookup(colf_flat, ii * N + jj) * rmask_b
                    flat, _, pv = score_residual_argmax_batched(
                        new.reshape(P, 1, RN), cw[:, None, :], rowf_mat,
                        rmask2.reshape(P, 1, RN))
                    a2, b2 = flat // R, flat % R
                    budget = havecol and t + 1 >= 2 * cfg.piv
                    stat = ((a2 == kk) & (b2 == qq)) if havecol else torch.zeros_like(done)
                    haverow = True
                    arow = torch.where(act[:, None, None], new, arow)
                    if not budget:
                        kk, qq = torch.where(act, a2, kk), torch.where(act, b2, qq)
                if not budget:
                    pivot = torch.where(act, pv, pivot)
                amax = torch.where(act.view(mc, L).any(dim=0),
                                   torch.maximum(amax, lane_max(new.abs(), mc)), amax)
                neval = neval + lane_sum(torch.where(act, dnev, 0), mc)
                done = torch.ones_like(done) if budget else done | stat
            padded = padded + 2 * cfg.piv * mc * RN
        hunt = dict(ii=ii, jj=jj, kk=kk, qq=qq, pivot=pivot, acol=acol, arow=arow)
        return hunt, amax, neval, padded

    def jacobi_hunt(st: CrossState, U, dir_fwd: bool, base: int, mc: int,
                    live, lw=None, cs=None):
        """Batched lottery + rook hunt of one run over the window of mc
        bonds that starts at bond `base` (base + mc <= d-1).  U (mc, 2,
        NLOT): the window's lottery uniforms.  live (mc,) masks window rows
        outside the caller's slab: a dead row adds nothing to amax or
        n_evals, and its outputs are garbage that the caller masks.  The
        one-device sweep takes the full window (base = 0, mc = d-1).  cs:
        the carried packed interface states (chain path), else they are
        rebuilt from vip.  lw (d, N): the per-mode lottery weights, each
        mode's scaled to a maximum of 1 (cross(weighted_lottery=True)).
        Returns (hunt dict, amax', neval', padded')."""
        hunt, amax, neval, padded = _hunt(as_lanes(st), U, dir_fwd, base, mc, live, lw, cs)
        return hunt, amax[0], neval[0], padded[0]

    def _apply(st: CrossState, hunt, corner_count=None, live=None,
               skip_corners: bool = False):
        """jacobi_apply on a lane state: the hunt's rows are (d-1) x L,
        bond-major, and so are live and corner_count.  Returns (st, upd,
        the slot written per row)."""
        P = nb * L
        ps = torch.arange(nb, device=dev)
        ps = ps if L == 1 else ps.repeat_interleave(L)

        def rows(a):
            """A lane array's bond rows (nb, L, ...) as (P, ...), a view."""
            return a.view((P,) + tuple(a.shape[2:]))

        ii, jj, kk, qq = (hunt[k].long() for k in ("ii", "jj", "kk", "qq"))
        pivot, acol, arow = hunt["pivot"], hunt["acol"], hunt["arow"]
        rk_b = st.rk[1:-1].long().reshape(P)
        n_l, n_r = n_t[:-1], n_t[1:]
        if L > 1:
            n_l, n_r = n_l.repeat_interleave(L), n_r.repeat_interleave(L)
        rmask_b = (iR[None, :] < rk_b[:, None]).to(dtype)               # (P, R)

        # ---------------- batched acceptance
        apiv = pivot.abs()
        upd = ((apiv > cfg.small_element * st.amax.repeat(nb))
               & (apiv > cfg.small_pivot * st.pivotmax_prev.repeat(nb)) & (rk_b < R))
        if live is not None:
            upd = upd & live
        piv_safe = torch.where(apiv > 0, pivot, 1.0)
        c_new = batched_row_lookup(rows(st.colf[:-1]).reshape(P, RN, R), ii * N + jj) * rmask_b
        u_new = rows(st.rowf[1:]).reshape(P, R, RN).gather(
            2, (kk * R + qq).view(P, 1, 1).expand(P, R, 1))[:, :, 0] * rmask_b
        slot = rk_b.clamp(max=R - 1)      # a saturated bond never accepts
        at_slot = iR[None, :] == rk_b[:, None]                           # (P, R)
        # maintained triangular inverses (bordered-inverse recurrences), from
        # the inverses as they were
        itl, itt = rows(st.itl), rows(st.itt)
        new_row = torch.where(at_slot, 1.0, -matmul_by_sums(c_new[:, None, :], itl)[:, 0])
        new_col = torch.where(at_slot, 1.0 / piv_safe[:, None],
                              -matmul_by_sums(itt, u_new[:, :, None])[:, :, 0]
                              / piv_safe[:, None])
        masked_slot_write(rows(st.vip), 1, slot, torch.stack([ii, jj, kk, qq], 1).to(torch.int32),
                          upd)
        masked_slot_write(rows(st.lu_c), 1, slot, c_new, upd)
        masked_slot_write(rows(st.lu_u), 1, slot, u_new, upd)
        masked_slot_write(rows(st.lu_d), 1, slot, pivot, upd)
        masked_slot_write(itl, 1, slot, new_row, upd)
        masked_slot_write(itt, 2, slot, new_col, upd)
        upd2 = upd.view(nb, L)
        st.rk[1:d] += upd2.to(st.rk.dtype)
        any_acc = upd2.any(dim=0)
        neg = torch.full((L,), -1.0, dtype=dtype, device=dev)
        pivotmax = torch.where(any_acc, torch.where(upd, apiv, -torch.inf).view(nb, L).amax(0),
                               neg)
        pivotmin = torch.where(any_acc, torch.where(upd, apiv, torch.inf).view(nb, L).amin(0),
                               neg)
        st = st._replace(pivotmax=pivotmax, pivotmin=pivotmin)

        # ---------------- corner fibers (one batched call, dmrgg.f90:928-932)
        # A corner is missing only when ADJACENT bonds of a lane accept in
        # the same apply; red-black phases separate neighbours by parity, so
        # their callers skip the block and the other phase's hunt fibers
        # evaluate the fresh rows instead.
        if not skip_corners:
            false1 = torch.zeros((1, L), dtype=torch.bool, device=dev)
            lmiss = (upd2 & torch.cat([false1, upd2[:-1]])).view(P)
            rmiss = (upd2 & torch.cat([upd2[1:], false1])).view(P)
            i_newL = st.rk[:-2].long().reshape(P) - 1                    # the new left link
            q_newR = st.rk[2:].long().reshape(P) - 1
            cols = lambda x: x[:, None].expand(P, N)  # noqa: E731
            if ce is None:
                LT2 = all_left_tables(st.vip, d).reshape(P, R, d)
                RT2 = all_right_tables(st.vip, d).reshape(P, R, d)
                ind_cc = assemble_indices(LT2, RT2, ps, cols(i_newL), iN.expand(P, N),
                                          cols(kk), cols(qq), d)          # (P, N, d)
                ind_rc = assemble_indices(LT2, RT2, ps, cols(ii), cols(jj), iN.expand(P, N),
                                          cols(q_newR), d)
                vals_c = evalf(torch.cat([ind_cc, ind_rc])).reshape(2, P, N)
            else:
                Ls2, Rs2 = ce.states_from_vip(st.vip[:, 0])
                vals_c = (ce.eval_corner_col(Ls2, Rs2, ps, i_newL, kk, qq, iN),
                          ce.eval_corner_row(Ls2, Rs2, ps, ii, jj, q_newR, iN))
            corner_col = torch.where(lmiss[:, None] & (iN[None, :] < n_l[:, None]),
                                     vals_c[0], 0.0)                      # (P, N)
            corner_row = torch.where(rmiss[:, None] & (iN[None, :] < n_r[:, None]),
                                     vals_c[1], 0.0)
            cc = torch.ones_like(upd) if corner_count is None else corner_count
            neval = st.neval + lane_sum(torch.where(cc & lmiss, n_l, 0)
                                        + torch.where(cc & rmiss, n_r, 0), nb)
            st = st._replace(neval=neval, padded=st.padded + 2 * nb * N)
            acol, arow = acol.clone(), arow.clone()
            masked_slot_write(acol, 1, i_newL, corner_col, lmiss)
            masked_slot_write(arow, 2, q_newR, corner_row, rmiss)

        st = _jacobi_reconstruct(st, upd, acol, arow, c_new, u_new, slot, piv_safe, ps, rows)
        return st, upd, rk_b

    def jacobi_apply(st: CrossState, hunt, corner_count=None, live=None,
                     skip_corners: bool = False, ret_accept: bool = False):
        """Batched acceptance + corner repair + reconstruction of one run
        for a full-width (d-1 bonds) hunt result, updating the state IN
        PLACE.  Deterministic in (st, hunt).

        st must carry the post-hunt amax / neval / padded.  live (d-1,)
        bool: only these bonds may accept (a red-black phase's parity).
        corner_count (d-1,) bool: which corner fibers this caller counts
        into neval.  skip_corners: no corner batch (red-black: neighbours
        never accept in one apply).  ret_accept: also return the accept
        mask and the slot written per bond."""
        stl, upd, rk_b = _apply(as_lanes(st), hunt, corner_count, live, skip_corners)
        st = lane(stl, 0)
        return (st, upd, rk_b) if ret_accept else st

    def _jacobi_reconstruct(st: CrossState, upd, acol, arow, c_new, u_new, slot,
                            piv_safe, ps, rows) -> CrossState:
        """Reconstruction phases A and B, in place: the raw fibers and the
        LU slices, then the factor borders from the post-A factors.  st.itl
        and st.itt are the post-accept inverses."""
        P = nb * L

        def set_col(arr, body, mask):
            """arr[p, :, :, slot[p]] = body[p] where mask[p], p < nb."""
            masked_slot_write(rows(arr[:nb]), 3, slot, body, mask)

        def set_row(arr, body, mask):
            """arr[p+1, slot[p], :, :] = body[p] where mask[p]."""
            masked_slot_write(rows(arr[1:]), 1, slot, body, mask)

        # phase A: raw fibers into cores (dmrgg.f90:662-685); the row factor
        # of bond p-1 on core p gains the new column with that bond's L-solve
        # applied, the col factor of bond p+1 on core p+1 the new row with
        # that bond's T-solve (dmrgg.f90:715-749)
        set_col(st.cores, acol, upd)
        set_row(st.cores, arow, upd)
        itl_prev = rows(torch.cat([st.itl[:1], st.itl[:-1]]))           # (P, R, R)
        set_col(st.rowf, matmul_by_sums(itl_prev, acol), upd & (ps > 0))
        itt_next = rows(torch.cat([st.itt[1:], st.itt[-1:]]))
        set_row(st.colf, matmul_by_sums(arow, itt_next), upd & (ps < d - 2))
        # phase B: the factor borders (dmrgg.f90:687-713) from the post-A factors
        approx = matmul_by_sums(rows(st.colf[:-1]).reshape(P, RN, R), u_new[:, :, None])
        set_col(st.colf, (acol - approx.view(P, R, N)) / piv_safe[:, None, None], upd)
        approx2 = matmul_by_sums(c_new[:, None, :], rows(st.rowf[1:]).reshape(P, R, RN))
        set_row(st.rowf, arow - approx2.view(P, N, R), upd)
        return st._replace(pivotmax_prev=st.pivotmax)

    def _sweep(st: CrossState, dir_fwd: bool, U, live=None, lw=None, cs=None):
        """One jacobi sweep of a lane state with the lottery uniforms U
        (L, d-1, 2, NLOT); live (L,) the lanes that sweep (None: all).  cs:
        the carried packed interface states (chain path, one run only);
        when given, the return is (st, cs') with the states kept up to date
        by update_states instead of rebuilt inside every hunt."""
        old = st
        Uw = U.transpose(0, 1).reshape(nb * L, 2, NLOT)
        rows_live = (torch.ones((nb * L,), dtype=torch.bool, device=dev) if live is None
                     else live.repeat(nb))
        if cfg.rb:
            st, cs = _rb_phases(st, Uw, dir_fwd, rows_live, live is not None, cs, lw)
        else:
            with span("engine.hunt", bond="all"):
                hunt, amax, neval, padded = _hunt(st, Uw, dir_fwd, 0, nb, rows_live, lw=lw, cs=cs)
                st = st._replace(amax=amax, neval=neval, padded=padded)
            with span("engine.accept"):
                st, upd, slots = _apply(st, hunt, live=None if live is None else rows_live)
            if cs is not None:
                cs = ce.update_states(cs[0], cs[1], hunt["ii"], hunt["jj"], hunt["kk"],
                                      hunt["qq"], upd, slots)
        if live is not None:
            st = st._replace(**{f: torch.where(live, getattr(st, f), getattr(old, f))
                                for f in _SCALARS})
        return st, cs

    def _rb_phases(st: CrossState, Uw, dir_fwd: bool, rows_live, gate: bool, cs=None, lw=None):
        """Red-black (two-phase Gauss-Seidel) sweep: the even bonds hunt and
        accept batched, then the odd bonds against the post-even factors.

        A bond's neighbours are always in the other phase: their accepts
        land before its hunt, whose fibers evaluate the new rows fresh (no
        corner is ever missing within a phase), and the chain tables or
        states are those after the first phase.  Both phases draw with the
        same U and threshold against the previous sweep's pivotmax
        (dmrgg.f90:598-600)."""
        ps = torch.arange(nb, device=dev)
        ps = ps if L == 1 else ps.repeat_interleave(L)
        pm_prev = st.pivotmax_prev
        pms, pns = [], []
        for par in (0, 1):
            live = rows_live & ((ps % 2) == par) if gate else (ps % 2) == par
            st = st._replace(pivotmax_prev=pm_prev)
            with span("engine.hunt", bond="all", phase=par):
                hunt, amax, neval, padded = _hunt(st, Uw, dir_fwd, 0, nb, live, lw=lw, cs=cs)
                st = st._replace(amax=amax, neval=neval, padded=padded)
            with span("engine.accept"):
                st, upd, slots = _apply(st, hunt, live=live, skip_corners=True)
            if cs is not None:
                cs = ce.update_states(cs[0], cs[1], hunt["ii"], hunt["jj"], hunt["kk"],
                                      hunt["qq"], upd, slots)
            pms.append(st.pivotmax)
            pns.append(st.pivotmin)
        pm = torch.maximum(pms[0], pms[1])          # -1 = no accept
        pn = torch.where(pns[0] < 0, pns[1],
                         torch.where(pns[1] < 0, pns[0], torch.minimum(pns[0], pns[1])))
        return st._replace(pivotmax=pm, pivotmin=pn, pivotmax_prev=pm), cs

    if lanes:
        def sweep(st: CrossState, dir_fwd: bool, U, lw=None, live=None) -> CrossState:
            return _sweep(st, dir_fwd, U, live=live, lw=lw)[0]
    else:
        def sweep(st: CrossState, dir_fwd: bool, U, cs=None, lw=None):
            stl, cs = _sweep(as_lanes(st), dir_fwd, U[None], lw=lw, cs=cs)
            st = lane(stl, 0)
            return st if cs is None else (st, cs)

    return sweep, jacobi_hunt, jacobi_apply
