"""Resuming a saved cross state (cross(init_state=...)) in the port against
the JAX package: the documented difference, stated by tests.

The JAX package's cross restarts a loaded state at iteration 1: a '>>'
sweep, with uniforms split from the key saved in the state
(ttcross_tpu/cross/engine.py:1623-1625).  The port's state counts its
sweeps (CrossState.sweeps), so a state the port saved resumes at sweep
k + 1, in the direction and in the key's stream of uniforms where the
uninterrupted run would be.  A state saved by the JAX package has no such
count: load_state gives it sweeps = 0, so it resumes as the JAX package
does.  The port is fed the JAX package's uniforms, recomputed from the
saved key as tests/test_torch_engine.py does; with them the pivots, the
ranks and the evaluations agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttcross_tpu.apps import make_ising as jmake_ising
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu.tt.serialize import load_state as jload_state
from ttcross_tpu.tt.serialize import save_state as jsave_state
from ttcross_tpu_torch.apps import make_ising
from ttcross_tpu_torch.cross import cross
from ttcross_tpu_torch.cross.engine import _cross, draw_uniforms
from ttcross_tpu_torch.interop import ising_from_numpy
from ttcross_tpu_torch.tt.serialize import load_state, save_state
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

M, NQ, R = 5, 17, 8         # C_5 on a 17-point rule: d = 4, rank 8
FIRST, REST = 3, 3          # sweeps before the checkpoint (odd: the next would be '<<'), after
KEY = 3


def _uniforms_from_key(key, sweeps, d, nlot):
    """The JAX sweep's U (d-1, 2, NLOT) for the next `sweeps` sweeps of a
    state whose PRNG key is `key` (one split per sweep)."""
    out = []
    for _ in range(sweeps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """A JAX run of FIRST sweeps saved with the JAX package's save_state,
    and the JAX package's resume of REST sweeps from the file."""
    jp = jmake_ising("C", M, NQ)
    kw = dict(max_rank=R, pivoting=1, quad=[jp.quad_weights] * jp.d, truth=jp.truth,
              return_state=True)
    first = jcross(jp.fun, [jp.n] * jp.d, key=KEY, max_sweeps=FIRST, **kw)
    path = str(tmp_path_factory.mktemp("resume") / "jax_state.npz")
    jsave_state(first.state, path)
    rest = jcross(jp.fun, [jp.n] * jp.d, key=KEY, max_sweeps=REST, init_state=jload_state(path),
                  **kw)
    return jp, path, first, rest


def test_jax_saved_state_resumes_as_in_the_jax_package(jax_resume):
    jp, path, first, rest = jax_resume
    tp = ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", M, jp.truth, "cpu")
    st = load_state(path, device="cpu")
    assert int(st.sweeps) == 0                      # the JAX state counts no sweeps
    assert int(st.neval) == first.neval
    U = _uniforms_from_key(jload_state(path).key, REST, jp.d, 2 * (R + jp.n))
    res = _cross(tp.fun, [jp.n] * jp.d, max_rank=R, accuracy=None, pivoting=1,
                 quad=[jp.quad_weights] * jp.d, truth=jp.truth, key=KEY, dtype=torch.float64,
                 verbose=False, return_state=True, max_sweeps=REST, small_element=None,
                 small_pivot=None, oversample=0, sweep_mode="sequential", device="cpu",
                 init_state=st, uniforms=U)
    assert np.array_equal(res.state.vip.numpy(), np.asarray(rest.state.vip))
    assert res.ranks == rest.ranks and res.neval == rest.neval and res.sweeps == rest.sweeps
    assert [h.direction for h in res.history] == [h.direction for h in rest.history]
    assert res.history[0].direction == ">>"         # restarted at iteration 1
    np.testing.assert_allclose(res.values, rest.values, rtol=1e-11)


def test_port_saved_state_continues_its_stream(tmp_path):
    """A port checkpoint after FIRST sweeps resumes at sweep FIRST + 1: its
    count is FIRST, its first sweep is the '<<' of the uninterrupted run,
    and it draws blocks FIRST + 1.. of the key's stream, so it ends where
    the uninterrupted run ends; with the count reset to 0 (a JAX package
    checkpoint) the same state restarts the stream and the direction."""
    p = make_ising("C", M, NQ, device="cpu")
    kw = dict(max_rank=R, pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth, key=KEY,
              return_state=True, device="cpu")
    whole = cross(p.fun, [p.n] * p.d, max_sweeps=FIRST + REST, **kw)
    first = cross(p.fun, [p.n] * p.d, max_sweeps=FIRST, **kw)
    save_state(first.state, str(tmp_path / "port_state.npz"))
    st = load_state(str(tmp_path / "port_state.npz"), device="cpu")
    assert int(st.sweeps) == FIRST
    rest = cross(p.fun, [p.n] * p.d, max_sweeps=REST, init_state=st, **kw)
    assert rest.history[0].direction == "<<" and int(rest.state.sweeps) == FIRST + REST
    for f, a, b in zip(whole.state._fields, whole.state, rest.state):
        assert torch.equal(a, b), f
    # the stream's blocks FIRST + 1 .. FIRST + REST, injected, give the same run
    U = draw_uniforms(KEY, FIRST + REST, p.d, 2 * (R + p.n))[FIRST:]
    fed = _cross(p.fun, [p.n] * p.d, max_rank=R, accuracy=None, pivoting=1,
                 quad=[p.quad_weights] * p.d, truth=p.truth, key=KEY, dtype=torch.float64,
                 verbose=False, return_state=True, max_sweeps=REST, small_element=None,
                 small_pivot=None, oversample=0, sweep_mode="sequential", device="cpu",
                 init_state=load_state(str(tmp_path / "port_state.npz"), device="cpu"),
                 uniforms=U)
    assert torch.equal(fed.state.vip, rest.state.vip) and fed.neval == rest.neval
    # the JAX package's behaviour on the same checkpoint: the count at 0
    # restarts the direction and the stream
    restarted = cross(p.fun, [p.n] * p.d, max_sweeps=REST,
                      init_state=st._replace(sweeps=torch.zeros_like(st.sweeps)), **kw)
    assert restarted.history[0].direction == ">>"
    assert int(restarted.state.sweeps) == REST
    assert not torch.equal(restarted.state.vip, rest.state.vip)
