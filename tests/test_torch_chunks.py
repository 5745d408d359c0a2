"""The port's chunked and adaptive cross against the JAX engine
(split from test_torch_caps.py, whose helpers these tests use).

cross(rank_chunks=...) grows the padded rank chunk by chunk, and
cross(adaptive=...) gates a bond's fiber hunt by its lottery residual
(ttcross_tpu/cross/engine.py:748-771, 835-1022, 1736-1840).  The port is fed
the JAX engine's lottery uniforms, recomputed from the same key chain: one
split of the state key per sweep, drawn at the sweep's chunk's padded rank
(a chunk's state carries the key on).  With the same uniforms the pivots,
ranks and evaluation counts agree exactly, and the values to rtol 1e-12."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_caps import R, assert_same_run, problems, run_both, run_port  # noqa: F401

from ttcross_tpu.apps import make_stdnorm as jmake_stdnorm
from ttcross_tpu.cross.engine import auto_chunks as jauto_chunks
from ttcross_tpu_torch.apps import make_stdnorm
from ttcross_tpu_torch.cross import cross
from ttcross_tpu_torch.cross.engine import auto_chunks, chunk_plan


@pytest.mark.parametrize("chunks,extra", [
    ([4, 6, 8], {}),
    ("auto", dict(accuracy=1e-12)),
    ([3, 8], dict(oversample=2)),
    ([4, 8], dict(refine_sweeps=1, max_sweeps=5)),
])
def test_chunked_runs_match_jax(problems, chunks, extra):
    """Rank-padding growth: each chunk's lottery at its own padded rank,
    the sweep counter and the strike carried over, the state re-embedded by
    pad_state; with oversample the schedule extends to the inflated rank,
    with refine_sweeps the maxvol pass seeds from the last chunk's pivots."""
    jp, tp = problems
    d, N = jp.d, jp.n
    kw = dict(pivoting=1, quad=[jp.quad_weights] * d, truth=jp.truth, rank_chunks=chunks,
              **extra)
    jres, pres = run_both(jp.fun, tp.fun, [N] * d, R, **kw)
    assert_same_run(jres, pres, vip=not (extra.get("oversample") or extra.get("refine_sweeps")))


@pytest.mark.parametrize("adaptive,piv", [(True, 1), (100.0, 0)])
def test_adaptive_matches_jax(adaptive, piv):
    """The adaptive gate on stdnorm (rank-1 modes, so bonds saturate and
    gate): a gated bond costs its lottery, in n_evals and padded_evals, as
    the JAX package counts it, and the pivots are the JAX package's."""
    jp = jmake_stdnorm(d=6, n=17)
    pp = make_stdnorm(d=6, n=17, device="cpu")
    kw = dict(pivoting=piv, quad=[jp.quad_weights] * jp.d, truth=jp.truth,
              accuracy=5 * 2.2e-16)
    jres, pres = run_both(jp.fun, pp.fun, [pp.n] * pp.d, 6, adaptive=adaptive, **kw)
    assert_same_run(jres, pres)
    plain = run_port(pp.fun, [pp.n] * pp.d, 6, **kw)
    assert pres.neval < plain.neval        # the gate did skip fibers


def test_chunk_schedules_match_jax():
    for r in range(2, 64):
        assert auto_chunks(r) == jauto_chunks(r)
    assert chunk_plan([4, 6, 8], 7) == [(4, 3), (6, 2), (8, 2)]
    assert chunk_plan([4, 6, 8], 4) == [(4, 3), (6, 1)]
    assert chunk_plan([4, 6, 8], 12) == [(4, 3), (6, 2), (8, 7)]


def test_chunked_state_is_padded_at_the_last_chunk(problems):
    _, tp = problems
    res = cross(tp.fun, [tp.n] * tp.d, max_rank=R, rank_chunks=[4, 6, 8], return_state=True,
                quad=[tp.quad_weights] * tp.d, truth=tp.truth, device="cpu")
    assert res.state.cores.shape == (tp.d, R, tp.n, R) and int(res.state.sweeps) == R - 1
    stop = cross(tp.fun, [tp.n] * tp.d, max_rank=R, rank_chunks=[4, 6, 8], max_sweeps=2,
                 return_state=True, device="cpu")
    assert stop.state.cores.shape == (tp.d, 4, tp.n, 4) and stop.sweeps == 2
