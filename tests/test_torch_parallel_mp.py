"""The port's distributed mp cross (parallel/engine_mp.py::cross_mp_parallel,
spawned workers through parallel/_hub.py) against the JAX package's hub
(forked workers) with the same seed.

Worker w draws its lottery from np.random.default_rng(seed + 7919 w) in
both packages, and every worker runs the same mpmath operations at the
working precision, which a spawned worker sets itself (it starts at
mpmath's default): so the value (its string at dps), the per-sweep history,
neval, ranks and sweeps are equal.  One worker equals cross_mp; ragged slabs
(mybonds) cross the corner fibers both ways; too many workers raise
ValueError, as in the JAX package, before anything is spawned."""

import numpy as np
import pytest
from mpmath import mp

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.apps.ising as JI
from ttcross_tpu.parallel.engine_mp import cross_mp_parallel as jcross_mp_parallel
from ttcross_tpu_torch.apps import make_ising_mp
from ttcross_tpu_torch.cross import cross_mp
from ttcross_tpu_torch.ops.mp import workdps
from ttcross_tpu_torch.parallel import cross_mp_parallel
from test_torch_engine_mp import _hist, _s
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)


def _same(p, j, dps):
    assert (p.neval, p.ranks, p.sweeps) == (j.neval, j.ranks, j.sweeps)
    assert _s(p.value, dps) == _s(j.value, dps)
    assert _hist(p, dps) == _hist(j, dps)


def test_one_worker_equals_serial():
    """n_workers = 1 is cross_mp: the same lottery, visit order and accepts."""
    dps = 30
    d, n, f, q, t = make_ising_mp("C", m=4, n=9, dps=dps)
    ser = cross_mp(f, [n] * d, max_rank=5, quad=q, truth=t, dps=dps, seed=5)
    par = cross_mp_parallel(f, [n] * d, max_rank=5, quad=q, truth=t, dps=dps, seed=5,
                            n_workers=1)
    _same(par, ser, dps)
    for a, b in zip(par.cores, ser.cores):
        assert [_s(v, dps) for v in a.reshape(-1)] == [_s(v, dps) for v in b.reshape(-1)]


@pytest.mark.parametrize("m, n, rank, dps, workers, mybonds", [
    (4, 17, 8, 40, 2, None),              # C_4: one bond per worker
    (5, 9, 5, 30, 2, [0, 2, 3]),          # ragged: bonds {0, 1} and {2}
    (6, 7, 4, 30, 3, [0, 1, 3, 4]),       # three workers, a two-bond middle slab
])
def test_workers_match_jax(m, n, rank, dps, workers, mybonds):
    d, n, f, q, t = make_ising_mp("C", m=m, n=n, dps=dps)
    _, _, jf, jq, jt = JI.make_ising_mp("C", m=m, n=n, dps=dps)
    dps0 = mp.dps
    p = cross_mp_parallel(f, [n] * d, max_rank=rank, quad=q, truth=t, dps=dps,
                          n_workers=workers, mybonds=mybonds)
    j = jcross_mp_parallel(jf, [n] * d, max_rank=rank, quad=jq, truth=jt, dps=dps,
                           n_workers=workers, mybonds=mybonds)
    _same(p, j, dps)
    assert mp.dps == dps0        # the parent's working precision is restored
    with workdps(dps):
        assert float(-mp.log10(abs(1 - p.value / t))) > 3.0


def test_too_many_workers_and_bad_slabs_are_rejected():
    d, n, f, q, t = make_ising_mp("C", m=4, n=5, dps=20)
    for kw in (dict(n_workers=3), dict(n_workers=0), dict(n_workers=2, mybonds=[0, 2, 2])):
        with pytest.raises(ValueError):
            cross_mp_parallel(f, [n] * d, max_rank=3, quad=q, dps=20, **kw)
