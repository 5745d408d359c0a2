"""The batched kernel A's launch plan (ops/kernels.py::_plan with bonds > 0)
and its plain version, on the CPU.

The plan's rule puts a cluster of blocks on each fiber where the fibers
are few and long (a family's 2, 4 or 20 lanes of 1300) and keeps a block
per fiber for the long chain's all-bonds sweeps (254 and 1022 fibers of
170); every plan covers each element of a fiber once, within shared
memory and the cluster's 16 blocks.  The plain version is held against P
calls of the single-fiber plain version and, fiber by fiber, against the
JAX package's reference (ttcross_tpu/ops/pallas_kernels.py::
score_residual_argmax_ref).  The kernels are held against the plain
version, and bit for bit against single-fiber launches, on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.ops.pallas_kernels import score_residual_argmax_ref
from ttcross_tpu_torch.ops import kernels as K

SMS = 132    # an H100 SXM; the plan takes the count of the card it runs on
FAMILY = [(P, 1300, 1, 20) for P in (2, 4, 20)] + [(P, 1, 1300, 20) for P in (2, 4, 20)]
CHAINS = [(254, 170, 1, 10), (254, 1, 170, 10), (1022, 170, 1, 10), (1022, 1, 170, 10)]


def _walk(plan, length):
    """How often the plan's blocks visit each element of one fiber: block b
    of the fiber's cluster takes tiles b, b + C, ... of `threads`
    elements."""
    seen = np.zeros(length, int)
    tiles = -(-length // plan.threads)
    for b in range(plan.cluster):
        assert b < tiles, "a block of the cluster has no tile"
        for tile in range(b, tiles, plan.cluster):
            seen[tile * plan.threads:(tile + 1) * plan.threads] += 1
    return seen


@pytest.mark.parametrize("esz", [8, 4])
@pytest.mark.parametrize("P,M,Kc,R", FAMILY + CHAINS)
def test_rule_takes_a_cluster_for_few_long_fibers_only(P, M, Kc, R, esz):
    """The family (phase 9), the mesh's two lanes a rank and the lane
    jacobi's 4 x 5 fibers of 1300 take a cluster per fiber; the long
    chain's 254 and 1022 fibers of 170 keep the block body."""
    plan = K._plan(M, Kc, R, SMS, bonds=P, esz=esz)
    length = max(M, Kc)
    assert plan.path == (K.BATCH_COL if Kc == 1 else K.BATCH_ROW)
    if length == 1300:
        assert plan.cluster == 11 and plan.threads == 128
    else:
        assert plan.cluster == 1 and plan.threads == 192 and plan.nparts == 0
    assert plan.blocks == P * plan.cluster
    assert np.all(_walk(plan, length) == 1)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64, 128, 254, 1022])
@pytest.mark.parametrize("length,R", [(170, 10), (170, 20), (1300, 10), (1300, 20)])
def test_rule_stays_within_the_card_and_covers_each_element_once(P, length, R):
    for M, Kc in ((length, 1), (1, length)):
        plan = K._plan(M, Kc, R, SMS, bonds=P)
        C = plan.cluster
        assert 1 <= C <= 16 and plan.blocks == P * C
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
        assert plan.smem == 8 * R + 16 + 8 * plan.threads * R <= K.SMEM_OPTIN - 1024
        assert plan.nparts == (0 if C == 1 else P * C * plan.threads // 32)
        if C > 1:      # a few blocks an SM, a cluster only past one block's tile
            assert P * C <= K._BATCHED_FULL * SMS and length > 512
        assert np.all(_walk(plan, length) == 1)
    # fewer fibers never take smaller clusters
    if P > 1:
        assert K._plan(length, 1, R, SMS, bonds=P).cluster <= K._plan(length, 1, R, SMS,
                                                                       bonds=P // 2).cluster


@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 11, 16])
@pytest.mark.parametrize("length,R", [(170, 10), (1300, 20), (5000, 30), (1300, 200)])
def test_forced_clusters_cover_each_element_once(cluster, length, R):
    """A forced cluster size (the tuning's and the card tests' plans) is cut
    to the fiber's tiles, so no block of a cluster is idle."""
    plan = K._plan(length, 1, R, SMS, bonds=3, cluster=cluster)
    assert plan.cluster <= cluster and plan.blocks == 3 * plan.cluster
    assert plan.smem <= K.SMEM_OPTIN - 1024
    assert np.all(_walk(plan, length) == 1)
    if cluster == 1:
        assert plan == K._plan(length, 1, R, SMS, bonds=3) or plan.cluster == 1


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        K._plan(1300, 1, 5000, SMS, bonds=4)       # 32 rows of colf exceed shared memory
    with pytest.raises(ValueError, match="shared memory"):
        K._plan(1, 1300, 5000, SMS, bonds=4, esz=4)
    with pytest.raises(ValueError):
        K._plan(1300, 1, 20, SMS, bonds=4, cluster=17)    # clusters hold at most 16 blocks
    with pytest.raises(ValueError, match="65535"):
        K._plan(1300, 1, 20, SMS, bonds=70000, cluster=2)
    with pytest.raises(ValueError, match="fibers"):
        K._plan(6, 5, 3, SMS, bonds=4)


def _stack(rng, P, M, Kc, R):
    vals, colf, rowf = (rng.standard_normal(s) for s in ((P, M, Kc), (P, M, R), (P, R, Kc)))
    mask = rng.random((P, M, Kc)) > 0.2
    mask[1] = False                        # a fully masked fiber: (0, -1)
    vals[2].reshape(-1)[[5, M * Kc - 3]] = np.nan        # NaN ranks above every number
    vals[3].reshape(-1)[[7, 11]] = 50.0                   # a tie: the first maximum
    colf[3], rowf[3] = 0.0, 0.0
    for p, at in ((2, [5, M * Kc - 3]), (3, [7, 11])):
        mask[p].reshape(-1)[at] = True
    return vals, colf, rowf, mask


@pytest.mark.parametrize("P,M,Kc,R", [(4, 130, 1, 5), (4, 1, 130, 5), (6, 1300, 1, 20),
                                      (5, 1, 170, 10)])
def test_plain_is_p_single_fibers_and_the_jax_reference(P, M, Kc, R, rng):
    vals, colf, rowf, mask = _stack(rng, P, M, Kc, R)
    args = [torch.from_numpy(a) for a in (vals, colf, rowf, mask)]
    flat, score, resid = K.score_residual_argmax_batched(*args)   # the CPU: the plain version
    assert K.score_residual_argmax_batched.launches == 0
    for p in range(P):
        f1, s1, r1 = K.score_residual_argmax_plain(*(a[p] for a in args))
        assert int(flat[p]) == int(f1)
        # a batched matmul and P single ones may round the sums otherwise
        np.testing.assert_allclose([float(score[p]), float(resid[p])], [float(s1), float(r1)],
                                   rtol=1e-13)
        jf, js = score_residual_argmax_ref(*(jnp.asarray(a[p]) for a in (vals, colf, rowf, mask)))
        assert int(flat[p]) == int(jf)
        np.testing.assert_allclose(float(score[p]), float(js), rtol=1e-13)
    assert (int(flat[1]), float(score[1])) == (0, -1.0)
    assert int(flat[2]) == 5 and torch.isnan(score[2])
    assert int(flat[3]) == 7 and float(score[3]) == 50.0
