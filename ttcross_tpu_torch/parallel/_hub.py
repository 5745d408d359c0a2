"""Bond-slab worker hub of the host-indexed precision tiers.

Counterpart of ttcross_tpu/parallel/_hub.py (:1-336).  The qd engine
(cross/engine_qd.py) keeps its pivot bookkeeping on the host and the mp
engine (cross/engine_mp.py) is host code, so their distribution unit is a
process: a pool of workers, each running its tier's
engine over an owned bond slab, exchanging per-sweep tapes through this
parent hub.  The consistency model is the reference's MPI mp mode
(mptt_dmrgg, dmrggmp.f90:518-629), unchanged from the JAX package:

  * vip / ranks / bordered triangular inverses are REPLICATED: every worker
    replays every remote accept from the tape in bond order;
  * cores and col/row factors are OWNER-authoritative; cross-slab updates
    arrive as the accepted raw fibers in the tape, padded with freshly
    evaluated corner rows / columns when the adjacent bond also accepted
    this sweep (dmrgg.f90:928-932), only on the side this worker consumes;
  * non-owned accepts land after the sweep, one iteration late (the
    staleness license of dmrgg.f90:822-850);
  * worker w's lottery is seeded seed + 7919 w; the parent folds the
    workers' value partials in slab order and stops on three quiet sweeps.

The JAX package forks its workers (they inherit closures).  A process
forked after CUDA was used cannot use the card, so here the workers are
SPAWNED (torch.multiprocessing's spawn context) and whatever crosses to
them pickles: the integrand (a module-level callable, e.g.
apps.ising.IsingQD), the adapter, and the quadrature, which the parent
sends after the start as the JAX parent does.  Tapes, partials and solved
cores cross the pipes as host copies of the limbs (TierAdapter.to_host /
from_host).  The caller's CUDA kernels are built in the parent before the
spawn (the workers would race to build them).  Every receive has a time
limit; a worker that raises, dies or overruns it fails the run, and every
worker is stopped before run_hub returns or raises.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch
import torch.multiprocessing as mp

from .mesh import share

__all__ = ["TierAdapter", "run_hub"]


class TierAdapter:
    """Type-specific operations a tier plugs into the hub protocol.

    Subclasses (one per tier, parallel/engine_qd.py and engine_mp.py)
    override what they need; the base class documents the contract."""

    tag = ""             # verbose-line prefix inside [..w], e.g. "qd"

    def prepare_parent(self):
        """Run in the parent before the workers are spawned (build the
        kernels the workers will load)."""

    def worker_ctx(self):
        """Context manager around a worker's whole life (the mp tier sets
        its working precision: a spawned process starts at mpmath's
        default)."""
        return nullcontext()

    def parent_ctx(self):
        """Context manager around the parent's driver loop."""
        return nullcontext()

    def prep_truth(self, truth):
        """The caller's truth in the tier's representation (in the parent)."""
        return truth

    def make_engine(self, fun, n, max_rank, pivoting, snum, seed):
        raise NotImplementedError

    def prep_quad(self, quad, n):
        """Convert the caller's quadrature to the tier's representation on
        the parent's device (runs in the PARENT, after the start)."""
        raise NotImplementedError

    def to_host(self, obj):
        """A picklable host copy of a tape record, partial, quadrature or
        core dict (the tier's values as numpy)."""
        raise NotImplementedError

    def from_host(self, obj):
        """The inverse of to_host, on the receiver's device."""
        raise NotImplementedError

    def fixup_row(self, eng, rec):
        """Return rec's acol padded with any missing corner rows."""
        raise NotImplementedError

    def fixup_col(self, eng, rec):
        """Return rec's arow padded with any missing corner columns."""
        raise NotImplementedError

    def append_core_right(self, eng, b, arow):
        raise NotImplementedError

    def value_partial(self, eng, w, own_cores):
        """Ordered product of the LU-solved (r, r) quadrature mats of the
        locally-owned cores (the local half of mptt_quad's tree reduce,
        dmrggmp.f90:778-888)."""
        raise NotImplementedError

    def combine_parts(self, v, part):
        """Ordered product fold of two slab partials (None = identity)."""
        raise NotImplementedError

    def value_scalar(self, v):
        """Extract the (0, 0) scalar of the folded product."""
        raise NotImplementedError

    def err(self, value, truth):
        """|1 - value/truth| in the tier's precision (truth prepped)."""
        raise NotImplementedError

    def fmt_err_val(self, rec):
        """' err ... val ...' suffix for the verbose per-sweep line."""
        raise NotImplementedError

    def tt_value(self, cores, w):
        """Full-train quadrature value from the solved cores."""
        raise NotImplementedError

    def make_result(self, cores, value, neval, sweeps, ranks, history):
        raise NotImplementedError

    def worker_report(self, eng):
        """A picklable summary of a worker's run, made in the worker once,
        after its last sweep (run_hub's ``reports``); None by default."""
        return None


def _owned_bonds(own, w):
    return range(int(own[w]), int(own[w + 1]))


def _owned_cores(own, w, d, nw):
    cores = set(range(int(own[w]), int(own[w + 1])))
    if w == nw - 1:
        cores.add(d - 1)
    return cores


def _worker_main(ad: TierAdapter, conn, wid, nw, own, fun, n, max_rank, pivoting, snum, seed):
    try:
        torch.set_num_threads(1)
        with ad.worker_ctx():
            d = len(n)
            my_bonds = list(_owned_bonds(own, wid))
            my_cores = _owned_cores(own, wid, d, nw)
            eng = ad.make_engine(fun, n, max_rank, pivoting, snum, seed + 7919 * wid)
            eng.init_state()
            if nw > 1:
                eng.own_cores = my_cores
            init_neval = eng.neval
            conn.send(("ready", init_neval))
            # the quadrature arrives over the pipe, converted by the parent
            msg = conn.recv()
            assert msg[0] == "quad"
            w = ad.from_host(msg[1])

            while True:
                msg = conn.recv()
                if msg[0] == "stop":
                    break
                assert msg[0] == "sweep"
                it = msg[1]
                dir_fwd = it % 2 == 1
                bonds = my_bonds if dir_fwd else list(reversed(my_bonds))
                recs = []
                for b in bonds:
                    rec = eng.visit_bond(b, dir_fwd)
                    if rec is None:
                        continue
                    # owner-local neighbour slices (the serial path does the
                    # same right after the visit)
                    if b - 1 in my_bonds:
                        eng.apply_left_slice(b, rec["acol"])
                    if b + 1 in my_bonds:
                        eng.apply_right_slice(b, rec["arow"])
                    recs.append(rec)
                conn.send(("tape", ad.to_host(recs), eng.log_amax, eng.neval - init_neval))

                all_recs, g_amax = conn.recv()
                all_recs = ad.from_host(all_recs)
                eng.log_amax = max(eng.log_amax, g_amax)
                # replay every REMOTE accept (vip / rank / inverses), sorted
                # by bond so the replicated state is identical
                remote = sorted((r for r in all_recs if r["b"] not in my_bonds),
                                key=lambda r: r["b"])
                for rec in remote:
                    eng.replay_remote(rec)
                # boundary fixups with post-replay chains: raw fibers into
                # owned cores, factor slices for slab-adjacent bonds; each
                # side padded only if THIS worker consumes it
                for rec in remote:
                    b = rec["b"]
                    if b - 1 in my_bonds:
                        eng.apply_left_slice(b, ad.fixup_row(eng, rec))
                    if (b + 1 in my_cores) or (b + 1 in my_bonds and b + 1 <= d - 2):
                        arow = ad.fixup_col(eng, rec)
                        if b + 1 in my_cores:
                            ad.append_core_right(eng, b, arow)
                        if b + 1 in my_bonds and b + 1 <= d - 2:
                            eng.apply_right_slice(b, arow)
                lps = [r["lp"] for r in all_recs]
                if lps:
                    eng.log_pivotmax_prev = max(lps)
                part = ad.value_partial(eng, w, my_cores) if w is not None else None
                conn.send(("done", eng.neval - init_neval, ad.to_host(part)))

            solved = {c: eng.solve_core(c) for c in sorted(my_cores)}
            conn.send(("cores", ad.to_host(solved), eng.neval - init_neval, tuple(eng.r),
                       ad.worker_report(eng)))
    except Exception as e:  # noqa: BLE001 - surfaced by the parent
        import traceback

        conn.send(("error", f"{e!r}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def run_hub(ad: TierAdapter, fun, n, max_rank, pivoting, quad, truth, lacc, snum, seed, verbose,
            n_workers, mybonds, name: str, timeout: float = 600.0, reports: list | None = None):
    """The parent driver: spawn the workers, run the sweep / tape / replay
    loop to the strike-3 stop, gather the solved cores, return the tier's
    result.  timeout: seconds any one message from a worker may take.
    reports: a list that receives each worker's ad.worker_report, in worker
    order."""
    with ad.parent_ctx():
        return _run_hub(ad, fun, n, max_rank, pivoting, quad, truth, lacc, snum, seed, verbose,
                        n_workers, mybonds, name, timeout, reports)


def _run_hub(ad, fun, n, max_rank, pivoting, quad, truth, lacc, snum, seed, verbose, n_workers,
             mybonds, name, timeout, reports):
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError(f"{name} requires d >= 2")
    nw = int(n_workers)
    if nw < 1 or nw > d - 1:
        raise ValueError(f"n_workers must be in [1, d-1]; got {nw} for d={d}")
    if mybonds is None:
        own = share(d - 1, nw)
    else:
        own = np.asarray(mybonds, dtype=np.int64)
        if (own.shape != (nw + 1,) or own[0] != 0 or own[-1] != d - 1
                or np.any(np.diff(own) < 1)):
            raise ValueError(f"bad mybonds {own.tolist()}")

    ad.prepare_parent()
    ctx = mp.get_context("spawn")
    conns, procs = [], []

    def _recv(wid):
        c, p = conns[wid], procs[wid]
        deadline = time.monotonic() + timeout
        while not c.poll(1.0):
            if not p.is_alive() and not c.poll(0):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{name} worker {wid} sent nothing within {timeout} s")
        try:
            msg = c.recv()
        except EOFError:
            p.join(5)
            raise RuntimeError(f"{name} worker {wid} exited with code {p.exitcode} and no "
                               "message") from None
        if msg[0] == "error":
            raise RuntimeError(f"{name} worker {wid} failed:\n{msg[1]}")
        return msg

    try:
        for wid in range(nw):
            pc, cc = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(ad, cc, wid, nw, own, fun, n, max_rank, pivoting, snum, seed),
                            daemon=True)
            p.start()
            cc.close()
            conns.append(pc)
            procs.append(p)
        init_neval = None
        for wid in range(nw):
            msg = _recv(wid)
            assert msg[0] == "ready"
            init_neval = msg[1]

        w = ad.prep_quad(quad, n) if quad is not None else None
        w_host = ad.to_host(w)
        for c in conns:
            c.send(("quad", w_host))
        if truth is not None:
            truth = ad.prep_truth(truth)

        history = []
        strike = 0
        it = 0
        neval = init_neval
        while it + 1 < max_rank:
            it += 1
            for c in conns:
                c.send(("sweep", it))
            all_recs, log_amax = [], -float("inf")
            for wid in range(nw):
                msg = _recv(wid)
                assert msg[0] == "tape"
                all_recs.extend(msg[1])
                log_amax = max(log_amax, msg[2])
            all_recs.sort(key=lambda r: r["b"])
            for c in conns:
                c.send((all_recs, log_amax))
            parts = []
            neval = init_neval
            for wid in range(nw):
                msg = _recv(wid)
                assert msg[0] == "done"
                neval += msg[1]
                parts.append(ad.from_host(msg[2]))

            lps = [r["lp"] for r in all_recs]
            log_pivotmax = max(lps) if lps else None
            rec = {"it": it, "dir": ">>" if it % 2 == 1 else "<<",
                   "pivotmax_log10": log_pivotmax, "n_evals": neval,
                   "value": None, "err": None}
            if w is not None:
                v = None
                for part in parts:       # ordered product over slabs
                    v = ad.combine_parts(v, part)
                rec["value"] = ad.value_scalar(v)
                if truth is not None:
                    rec["err"] = ad.err(rec["value"], truth)
            history.append(rec)
            if verbose:
                line = (f"{it:3d}{rec['dir']} {ad.tag}[{nw}w] n_evals {neval:9d} "
                        f"log10|pivot| "
                        f"{log_pivotmax if log_pivotmax is not None else float('-inf'):8.2f}")
                if rec["err"] is not None:
                    line += ad.fmt_err_val(rec)
                print(line)

            quiet = log_pivotmax is None or log_pivotmax <= lacc + log_amax
            strike = strike + 1 if quiet else 0
            if strike >= 3:
                break

        for c in conns:
            c.send(("stop",))
        cores = [None] * d
        ranks = None
        neval = init_neval
        for wid in range(nw):
            msg = _recv(wid)
            assert msg[0] == "cores"
            for ci, g in ad.from_host(msg[1]).items():
                cores[ci] = g
            neval += msg[2]
            ranks = msg[3]
            if reports is not None:
                reports.append(msg[4])
        assert all(g is not None for g in cores)
        value = ad.tt_value(cores, w) if w is not None else None
        return ad.make_result(cores=cores, value=value, neval=neval, sweeps=it, ranks=ranks,
                              history=history)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()
