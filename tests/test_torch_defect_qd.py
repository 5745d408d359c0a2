"""The port's quad-double defect pipeline (cross/defect.py::
cross_defect_corrected_qd) and qd Ising integrand against the JAX
package's, at C_4 on a 17-point rule.

The qd integrand and the defect integrand (the qd integrand minus given
trains gathered in qd, rounded to f64) are IEEE f64 operations in the same
order in both packages: bit-equal (tolerance: none).  The pipeline's levels
are f64 crosses; the port is fed the JAX engine's lottery uniforms of each
level's key, so level 1 takes the same pivots, ranks and evaluations.
Later levels cross a noise-like defect, so their pivots may part: there
each package's qd total is held to the exact quadrature of the discrete
tensor (all 17^3 entries summed in qd) below 1e-24 (measured: JAX 1.0e-25,
port 1.8e-26 on the CPU; the n = 17 rule itself caps both at 1.5e-18
against C_4), and the two totals to each other within the worse of the
two errors."""

from decimal import localcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
from ttcross_tpu.apps.ising import make_ising_qd as jmake_ising_qd
from ttcross_tpu.cross.defect import _DefectQD as JDefectQD
from ttcross_tpu.cross.defect import cross_defect_corrected_qd as jdefect_qd
from ttcross_tpu_torch.apps import ising_c_integrand_qd, make_ising_qd
from ttcross_tpu_torch.cross import cross_defect_corrected_qd
from ttcross_tpu_torch.cross.defect import _DefectQD
from ttcross_tpu_torch.ops import qd as PQ
from ttcross_tpu_torch.tt.types import TT
from test_torch_engine import _jax_uniforms
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

M, NQ, R, R2 = 4, 17, 8, 17


def _same(a, b):
    return all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def problems():
    return jmake_ising_qd(m=M, n=NQ), make_ising_qd(m=M, n=NQ, device="cpu")


def test_qd_integrands_bit_equal(problems):
    """ising_c_integrand_qd (the maker's fun_qd and the functional form) and
    the defect integrand of two random trains equal the JAX package's."""
    (jp, jf, _), (pp, pf, _) = problems
    rng = np.random.default_rng(21)
    ind = rng.integers(0, NQ, (400, M - 1))
    ti = torch.from_numpy(ind.astype(np.int32))
    assert _same(jf(ind), pf(ti))
    limbs = pf.limbs
    assert _same(jf(ind), ising_c_integrand_qd(ti, PQ.QD(*limbs[:4]), PQ.QD(*limbs[4:])))
    trains = []
    for ranks in ((1, 4, 3, 1), (1, 2, 5, 1)):
        trains.append([rng.standard_normal((ranks[c], NQ, ranks[c + 1])) * 1e-3
                       for c in range(M - 1)])

    class NpTT:    # the JAX defect reads .d and .cores
        def __init__(self, cores):
            self.d, self.cores = len(cores), cores

    jd = JDefectQD(jf, [])
    jd.trains = tuple(NpTT(c) for c in trains)
    pd = _DefectQD(pf, [TT(tuple(torch.from_numpy(c) for c in cs)) for cs in trains])
    assert np.array_equal(jd._host(ind), pd(ti).numpy())


def _discrete_truth(pf, pw):
    """The qd quadrature of the whole discrete tensor (17^3 entries)."""
    ind = np.stack(np.meshgrid(*[np.arange(NQ)] * (M - 1), indexing="ij"), -1).reshape(-1, M - 1)
    f = pf(torch.from_numpy(ind.astype(np.int32)))
    w = pw[0]
    wt = PQ.QD(*(e[ind[:, 0]] for e in w))
    for c in range(1, M - 1):
        wt = PQ.qd_mul(wt, PQ.QD(*(e[ind[:, c]] for e in w)))
    return PQ.qd_to_mp(*(float(e) for e in PQ.qd_sum(PQ.qd_mul(f, wt))))


def test_defect_corrected_qd_matches_jax(problems):
    """Two levels (ranks 8 and 17, the full rank of the correction): level
    1 equal to the JAX package's (ranks, vip, evaluations); both totals
    within 1e-24 of the discrete tensor's exact quadrature and within the
    worse of the two errors of each other."""
    from ttcross_tpu.cross.engine import cross as jcross
    from ttcross_tpu_torch.cross.engine import _cross

    (jp, jf, jw), (pp, pf, pw) = problems
    n = [NQ] * (M - 1)
    jl, ji = jdefect_qd(jp.fun, jf, n, jw, max_rank=R, max_rank2=R2, levels=2)
    U = [_jax_uniforms(lvl, r - 1, M - 1, 2 * (r + NQ)) for lvl, r in enumerate((R, R2))]
    pl, pi = cross_defect_corrected_qd(pp.fun, pf, n, pw, max_rank=R, max_rank2=R2, levels=2,
                                       device="cpu", uniforms=U)
    assert set(pi) == set(ji) and pi["levels"] == 2
    assert pi["ranks"][0] == tuple(ji["ranks"][0]) and pi["nevals"][0] == ji["nevals"][0]
    # level 1's pivots, from the same f64 crosses run alone
    jst = jcross(jp.fun, n, max_rank=R, accuracy=1e-13, pivoting=1, key=0, return_state=True)
    pst = _cross(pp.fun, n, max_rank=R, accuracy=1e-13, pivoting=1, quad=None, truth=None, key=0,
                 dtype=torch.float64, verbose=False, return_state=True, max_sweeps=None,
                 small_element=None, small_pivot=None, oversample=0, sweep_mode="sequential",
                 device="cpu", uniforms=U[0])
    assert np.array_equal(np.asarray(jst.state.vip), pst.state.vip.numpy())
    truth = _discrete_truth(pf, pw)
    with localcontext() as ctx:
        ctx.prec = 80
        ej = abs(1 - PQ.qd_to_mp(*jl) / truth)
        ep = abs(1 - PQ.qd_to_mp(*pl) / truth)
        both = abs(PQ.qd_to_mp(*jl) - PQ.qd_to_mp(*pl)) / truth
    assert ej < 1e-24 and ep < 1e-24, (float(ej), float(ep))
    assert both <= max(ej, ep), (float(both), float(ej), float(ep))
    assert len(pi["qs"]) == 2 and all(len(q) == 4 for q in pi["qs"])
