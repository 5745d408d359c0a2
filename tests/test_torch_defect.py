"""The port's defect-corrected cross (cross/defect.py) against the JAX
package's, at C_4 on a 17-point rule, rank 8, two levels.

Each level is an f64 cross; the port is fed the JAX engine's lottery
uniforms of each level's key (key, key + 1), recomputed from the same key
chain, so the levels take the same pivots, ranks and evaluations.  Level
2's integrand is the dd defect A_dd - TT1, evaluated by the JAX package
under jit (XLA contracts multiply-adds into FMAs, ~1e-31 per dd operation)
and by the port eagerly.  The two f64 engines agree to f64 rounding, not
bit for bit, so the level-1 trains' contractions q1 differ by ~1e-16 and
the levels' total by less; the JAX package contracts each train in
__float128 on the host, the port in dd: each port q within 1e-28 of its own
train's __float128 contraction."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
from ttcross_tpu import native
from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
from ttcross_tpu.cross.defect import cross_defect_corrected as jdefect
from ttcross_tpu_torch.apps.ising import ising_dd_problem
from ttcross_tpu_torch.cross import cross_defect_corrected
from ttcross_tpu_torch.interop import dd_pair_from_numpy
from ttcross_tpu_torch.parallel import BondMesh
from test_torch_engine import _jax_uniforms
from test_torch_engine_dd import _jax_tables

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")

M, NQ, R = 4, 17, 8


def test_defect_corrected_matches_jax():
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=M, n=NQ)
    n = [NQ] * (M - 1)
    hi_j, lo_j, info_j = jdefect(jprob.fun, jfun, n, jwh, jwl, max_rank=R, levels=2)
    (xh, xl), (wh, wl) = _jax_tables(NQ)
    prob, fun_dd, pwh, pwl = ising_dd_problem(dd_pair_from_numpy(xh, xl, "cpu"),
                                              dd_pair_from_numpy(wh, wl, "cpu"), M, "cpu")
    assert np.array_equal(prob.nodes, jprob.nodes) and np.array_equal(pwh[0], jwh[0])
    U = [_jax_uniforms(lvl, R - 1, M - 1, 2 * (R + NQ)) for lvl in range(2)]
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, n, pwh, pwl, max_rank=R, levels=2,
                                          device="cpu", uniforms=U)
    assert set(info) == set(info_j)
    assert info["nevals"] == info_j["nevals"] and info["ranks"] == [tuple(r) for r in info_j["ranks"]]
    # the f64 level-1 trains agree to f64 rounding, not bit for bit (the JAX
    # engine's jitted sums run in other orders): q1 by 7.6e-17 measured,
    # q2 by as much absolutely; level 2 absorbs most of it, the total by
    # 5.2e-18 measured
    q1, q2, jq1, jq2 = info["q1"], info["q2"], info_j["q1"], info_j["q2"]
    assert abs((q1[0] - jq1[0]) + (q1[1] - jq1[1])) <= 1e-15 * abs(jq1[0])
    assert abs((q2[0] - jq2[0]) + (q2[1] - jq2[1])) <= 1e-15 * abs(jq1[0])
    assert abs((hi - hi_j) + (lo - lo_j)) <= 1e-16 * abs(hi_j)
    # level 2 corrects level 1 by the f64 train's error, ~1e-10 of C_4 at rank 8
    assert 1e-13 < abs(q2[0]) < 1e-8
    # each q is the port's own train contracted in dd: within 1e-28 of the
    # same train contracted in __float128 (native.contract_q)
    from ttcross_tpu.tt.types import TT as JTT
    from ttcross_tpu_torch.cross.defect import _Defect
    from ttcross_tpu_torch.cross.engine import _cross

    kw = dict(accuracy=1e-13, pivoting=1, quad=None, truth=None, dtype=torch.float64,
              verbose=False, return_state=False, max_sweeps=None, small_element=None,
              small_pivot=None, oversample=0, sweep_mode="sequential", device="cpu")
    t1 = _cross(prob.fun, n, max_rank=R, key=0, uniforms=U[0], **kw).tt
    t2 = _cross(_Defect(fun_dd, [t1]), n, max_rank=R, key=1, uniforms=U[1], **kw).tt
    for t, (qh, ql) in zip((t1, t2), (q1, q2)):
        fh, fl = native.contract_q(JTT(cores=[c.numpy() for c in t.cores]), pwh, pwl)
        assert abs((qh - fh) + (ql - fl)) <= 1e-28 * abs(fh)


def test_defect_mesh_raises():
    """With a mesh every level runs on the distributed engine
    (tests/test_torch_parallel_misc.py), whose ranks may not outnumber the
    bonds."""
    mesh = BondMesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="more devices"):
        cross_defect_corrected(None, None, [3, 3], [], [], mesh=mesh, device="cpu")
