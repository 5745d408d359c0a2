"""Run a function on every rank of a local torch.distributed group.

The distributed engines (parallel/) run one process per rank, as the
reference's ``mpirun -np N`` does.  ``torchrun --nproc-per-node N`` starts
such processes from a script; spawn_ranks starts them from Python, for the
tests and chip_smoke.py: N processes by the spawn start method, each joined
to one group through a file store in a temporary directory, each running
``fn(*args)``, whose result (plain Python or numpy: nothing on a card)
comes back to the caller in rank order.  Every rank has the same time
limit; a rank that raises, dies or overruns it fails the whole call, and
every process is stopped before spawn_ranks returns or raises, so a hang
cannot outlive the call.  CUDA kernels are built by the caller before it
spawns (ops/_build.py: the ranks would race to build them).
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_ranks"]


def _rank_main(fn, rank, world, backend, init, timeout, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":   # a rank's card, as bond_mesh's default picks it
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, True, fn(*args)))
    except BaseException:   # noqa: BLE001 - sent back to the caller, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), backend: str = "gloo", timeout: float = 600.0,
                threads: int = 1) -> list:
    """fn(*args) on `world` spawned ranks of one `backend` group; returns
    their results in rank order.  fn must be picklable (a module-level
    function) and builds its mesh itself (parallel/mesh.py::bond_mesh).
    threads: torch's intra-op threads per rank (0 leaves torch's default).
    Raises RuntimeError with the failing ranks' tracebacks if any rank
    raises or exits early, and TimeoutError if the ranks are not all done
    within `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="ttcross_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, init, timeout, threads, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < world and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} did "
                                       f"not finish within {timeout} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode is not None:
                            errors[r] = f"rank {r} exited with code {p.exitcode} and no result"
                    continue
                (results if ok else errors)[rank] = payload
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    if errors:
        raise RuntimeError("distributed run failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
    return [results[r] for r in range(world)]
