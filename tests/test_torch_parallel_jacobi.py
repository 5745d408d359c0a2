"""The port's distributed all-bonds sweeps (sweep_mode "jacobi" and
"jacobi-rb", ttcross_tpu_torch/parallel/engine.py) against the JAX
package's, on the CPU: 2 and 4 gloo ranks against as many virtual devices,
every rank fed its JAX device's uniforms (tests/test_torch_parallel.py's
harness, one spawn per world size).  The JAX hunt ranks its fiber
residuals in f32 (ttcross_tpu/cross/engine_jacobi.py:214-251), so runs are
compared as tests/test_torch_jacobi.py compares them: the counts exactly,
and a run that parted at an f32 near-tie by its digits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import ACC, run_cases

# name: (problem, run kwargs, ranks), as tests/test_torch_parallel.py's
CASES = {
    "jacobi": (("tt", 6, (7,) * 6, (1, 2, 3, 3, 3, 2, 1)),
               dict(max_rank=5, pivoting=1, accuracy=1e-12, sweep_mode="jacobi", quad=True), 2),
    "jacobi_4": (("tt", 6, (7,) * 6, (1, 2, 3, 3, 3, 2, 1)),
                 dict(max_rank=5, pivoting=1, accuracy=1e-12, sweep_mode="jacobi", quad=True), 4),
    "rb_chain": (("ising", 7, 17), dict(max_rank=6, pivoting=1, accuracy=ACC, quad=True,
                                        sweep_mode="jacobi-rb", chain=True), 2),
    "rb_plain_4": (("ising", 7, 17), dict(max_rank=6, pivoting=1, accuracy=ACC, quad=True,
                                          sweep_mode="jacobi-rb"), 4),
}


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_jacobi_matches_jax(name, runs):
    """Each rank hunts its window, one all_reduce merges the hunts, the
    apply runs replicated: the counts exactly (ranks, n_evals, padded
    evals, sweeps).  Where the pivots are the JAX run's, the per-sweep
    values within 1e-13 relative and the trains within 1e-12; a run that
    parted at an f32 near-tie of the JAX hunt within 0.5 of its digits."""
    jres, pres = runs
    j, p = jres[name], pres[name]
    assert (p["ranks"], p["neval"], p["padded"], p["sweeps"]) == \
        (j["ranks"], j["neval"], j["padded"], j["sweeps"]), name
    if np.array_equal(p["vip"], j["vip"]):
        np.testing.assert_allclose(p["values"], j["values"], rtol=1e-13, atol=0)
        np.testing.assert_allclose(p["full"], j["full"], rtol=0,
                                   atol=1e-12 * np.abs(j["full"]).max())
    else:
        truth = j["tables"][3]
        jd, pd = (-np.log10(abs(1 - v[-1] / truth)) for v in (j["values"], p["values"]))
        assert abs(pd - jd) <= 0.5, (name, pd, jd)
    if CASES[name][0][0] == "tt":   # the exact-rank target recovered
        assert np.abs(p["full"] - j["full"]).max() < 1e-10 * np.abs(j["full"]).max()
