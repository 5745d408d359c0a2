"""The port's capped cross and cross()'s argument checks against the JAX
engine; the chunked and adaptive runs are in test_torch_chunks.py, which
shares this file's helpers.

cross(rank_caps=...) evaluates every bond's fibers at the capped sizes,
cross(rank_chunks=...) grows the padded rank chunk by chunk, and
cross(adaptive=...) gates a bond's fiber hunt by its lottery residual
(ttcross_tpu/cross/engine.py:748-771, 835-1022, 1736-1840).  The port is fed
the JAX engine's lottery uniforms, recomputed from the same key chain: one
split of the state key per sweep, drawn at the sweep's chunk's padded rank
(a chunk's state carries the key on).  With the same uniforms the pivots,
ranks and evaluation counts agree exactly, and the values to rtol 1e-12
(f64 rounding through the LU chain).  The argument checks raise the JAX
package's ValueErrors with its messages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ttcross_tpu.apps import make_ising as jmake_ising
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu_torch.cross import cross
from ttcross_tpu_torch.cross.engine import _cross, auto_chunks, chunk_plan
from ttcross_tpu_torch.interop import ising_from_numpy

M, NQ, R = 5, 17, 8     # C_5 on a 17-point rule: d = 4, rank 8
VAL_RTOL = 1e-12


@pytest.fixture(scope="module")
def problems():
    jp = jmake_ising("C", M, NQ)
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", M, jp.truth, "cpu")
    return jp, tp


def jax_uniforms(key, plan, d, N):
    """The JAX sweeps' uniforms for a run planned as [(padded rank, sweeps)]:
    sweep s splits the key carried by the state and draws (d-1, 2,
    2 (R_c + N)) at its chunk's rank R_c; one block per chunk."""
    k = jax.random.PRNGKey(key)
    out = []
    for Rc, sweeps in plan:
        us = []
        for _ in range(sweeps):
            k, sub = jax.random.split(k)
            us.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, 2 * (Rc + N)), jnp.float64)))
        out.append(np.stack(us))
    return out


def run_port(pfun, n, max_rank, key=0, oversample=0, **kw):
    """The port's cross fed the JAX uniforms of the same arguments."""
    R_run = max_rank + oversample
    chunks = kw.get("rank_chunks")
    if chunks is not None and chunks != "auto" and oversample:
        chunks = [c for c in chunks if c < R_run] + [R_run]
    if chunks == "auto":
        chunks = auto_chunks(R_run)
    sweeps = kw.get("max_sweeps") or R_run - 1
    plan = chunk_plan(chunks, sweeps) if chunks and len(chunks) > 1 else [(R_run, sweeps)]
    U = jax_uniforms(key, plan, len(n), max(n))
    pkw = dict(accuracy=None, dtype=torch.float64, verbose=False, max_sweeps=None,
               small_element=None, small_pivot=None, sweep_mode="sequential", quad=None,
               truth=None)
    pkw.update(kw)
    return _cross(pfun, n, max_rank=max_rank, key=key, oversample=oversample,
                  return_state=not oversample, device="cpu",
                  uniforms=U if len(plan) > 1 else U[0], **pkw)


def run_both(jfun, pfun, n, max_rank, key=0, oversample=0, **kw):
    """The same cross in both packages, the port fed the JAX uniforms;
    return_state (the vip) where the run allows it."""
    jres = jcross(jfun, n, max_rank=max_rank, key=key, oversample=oversample,
                  return_state=not oversample, **kw)
    return jres, run_port(pfun, n, max_rank, key=key, oversample=oversample, **kw)


def assert_same_run(jres, pres, vip=True):
    assert pres.ranks == tuple(int(x) for x in jres.ranks)
    assert pres.sweeps == jres.sweeps
    assert pres.neval == jres.neval
    assert pres.padded_evals == jres.padded_evals
    assert pres.converged == jres.converged
    if vip:
        assert np.array_equal(pres.state.vip.numpy(), np.asarray(jres.state.vip))
    assert len(pres.values) == len(jres.values)
    np.testing.assert_allclose(pres.values, np.asarray(jres.values, np.float64),
                               rtol=VAL_RTOL)
    assert [h.direction for h in pres.history] == [h.direction for h in jres.history]
    assert [h.n_evals for h in pres.history] == [h.n_evals for h in jres.history]


@pytest.mark.parametrize("caps,piv,extra", [
    ([4, 8, 4], 1, {}),
    ([3, 8, 3], 0, {}),
    ([5, 8, 6], 1, dict(rank_chunks=[4, 8])),
    ([2, 5, 3], 2, dict(accuracy=1e-10)),
])
def test_capped_runs_match_jax(problems, caps, piv, extra):
    """Capped fiber batches at (Rl, N) / (N, Rr), the lottery over the
    first Rl + 2N + Rr uniforms, col-first rook passes, the bond's cap on
    its rank: pivot for pivot, also composed with rank chunks."""
    jp, tp = problems
    d, N = jp.d, jp.n
    kw = dict(pivoting=piv, quad=[jp.quad_weights] * d, truth=jp.truth, rank_caps=caps,
              **extra)
    jres, pres = run_both(jp.fun, tp.fun, [N] * d, R, **kw)
    assert_same_run(jres, pres)
    assert all(r <= min(R, c) for r, c in zip(pres.ranks[1:-1], caps))
    uncapped = run_port(tp.fun, [N] * d, R, pivoting=piv, **extra)
    assert pres.padded_evals < uncapped.padded_evals


def test_saturated_bond_parity():
    """n = (3, 3, 3, 3), f = 1/(1 + sum (k+1) x_k), rank 6, rook: a reference
    defect kept for parity (the JAX package cannot change): bond 0 takes 4
    pivots although its unfolding is 3 x 27, and vip holds the left-chain
    index 5 at bond 0, where the left rank is 1.  The port gives the same
    ranks, evaluations and vip."""
    def jf(ind):
        return 1.0 / (1.0 + (jnp.arange(1, 5)[None, :] * ind).sum(1))

    def pf(ind):
        return 1.0 / (1.0 + (torch.arange(1, 5, dtype=torch.float64)[None, :] * ind).sum(1))

    jres, pres = run_both(jf, pf, [3] * 4, 6, pivoting=1)
    assert_same_run(jres, pres)
    assert pres.ranks == (1, 4, 5, 5, 1) and pres.neval == 418
    assert pres.state.vip[0, 3].tolist() == [5, 2, 0, 0]


def _host(ind):
    return np.zeros(len(ind))


# (kwargs, message fragment) of every ValueError of the JAX cross()'s
# argument checks (ttcross_tpu/cross/engine.py:1389-1550)
CHECKS = [
    (dict(n=[4]), "d >= 2"),
    (dict(max_rank=1), "max_rank must be >= 2"),
    (dict(host_reeval=_host, rank_chunks=[2, 4]), "host_reeval supports"),
    (dict(host_reeval=_host, refine_sweeps=1), "host_reeval supports"),
    (dict(return_pivots=True, rank_chunks=[2, 4]), "return_pivots supports"),
    (dict(return_pivots=True, oversample=2), "return_pivots supports"),
    (dict(oversample=2, return_state=True), "oversample is incompatible"),
    (dict(weighted_lottery=True), "weighted_lottery requires quad"),
    (dict(sweep_mode="gauss-seidel"), "unknown sweep_mode"),
    (dict(sweep_mode="jacobi", pivoting=-1), "requires pivoting >= 0"),
    (dict(adaptive=True, pivoting=-1), "adaptive gating requires pivoting >= 0"),
    (dict(adaptive=2.0, sweep_mode="jacobi-rb"), "adaptive gating applies to sequential"),
    (dict(rank_caps=[4, 4]), "rank_caps must be d-1"),
    (dict(rank_caps=[4, 0, 4]), "rank_caps must be d-1"),
    (dict(rank_caps=[4, 4, 4], sweep_mode="jacobi"), "not supported with jacobi"),
    (dict(rank_caps=[4, 4, 4], pivoting=-1), "rank_caps requires pivoting >= 0"),
    (dict(rank_caps=[4, 4, 4], adaptive=True), "not supported with rank_caps"),
    (dict(rank_chunks=[2, 4], init_state=object()), "cannot resume from init_state"),
    (dict(rank_chunks=[4, 2]), "rank_chunks must be increasing"),
    (dict(rank_chunks=[2, 3]), "rank_chunks must be increasing"),
    (dict(rank_chunks=[1, 4]), "rank_chunks must be increasing"),
    (dict(rank_chunks=[2, 4], oversample=2, return_state=True), "oversample is incompatible"),
]


@pytest.mark.parametrize("kw,match", CHECKS, ids=[m for _, m in CHECKS])
def test_argument_checks_match_jax(problems, kw, match):
    """Each of the JAX package's ValueErrors, its message fragment
    included, raised by the port for the same arguments."""
    jp, tp = problems
    kw = {"n": [jp.n] * jp.d, "max_rank": 4, **kw}
    n = kw.pop("n")
    with pytest.raises(ValueError, match=match):
        jcross(jp.fun, n, **kw)
    with pytest.raises(ValueError, match=match):
        cross(tp.fun, n, device="cpu", **kw)
