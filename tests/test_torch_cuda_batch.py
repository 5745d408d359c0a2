"""The lane-batched engine and the skeleton on the card: what only the card
can show.  Without a GPU these skip; they import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_batch.py

(chip_smoke.py holds the family's lanes against their single runs and the
Greeks against their central difference on the card.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

LANE_SWEEP_SEED = 0   # the lottery uniforms of test_a_lane_sweep_makes_no_host_sync


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("piv", [1, 0, -1])
def test_a_lane_sweep_makes_no_host_sync(piv, cuda_device):
    """Two sweeps of a 3-lane MVN family, one lane frozen in the second,
    under torch's sync debug mode set to raise: the lane axis adds no host
    round trip to a sweep."""
    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.batch import _lane_fun
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine
    from ttcross_tpu_torch.cross.state import lane

    fam = make_mvn_family(d=4, n=17, corrs=(0.2, 0.4, 0.6), device=cuda_device)
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=4, n=(fam.n,) * 4, N=fam.n, R=6, piv=piv, small_element=se,
                      small_pivot=sp)
    kit = make_engine(_lane_fun(fam.fun, fam.params), cfg, cuda_device, lanes=3)
    st = kit.init_fn()
    ranks0 = st.rk[1:-1].sum(dim=0)
    gen = torch.Generator(device=cuda_device).manual_seed(LANE_SWEEP_SEED)
    U = torch.rand((2, 3, 3, 2, 2 * (6 + fam.n)), dtype=torch.float64, device=cuda_device,
                   generator=gen)
    live = torch.tensor([True, False, True], device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = kit.sweep_fn(st, 1, U[0])
        frozen = [t.clone() for t in st]
        st = kit.sweep_fn(st, 2, U[1], live=live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the live lanes accepted pivots (a bond may stay at rank 1 on these
    # near-separable lanes: the lottery decides which)
    grew = (st.rk[1:-1].sum(dim=0) > ranks0).tolist()
    assert grew[0] and grew[2], (ranks0.tolist(), st.rk.tolist())
    for name, a, b in zip(lane(st, 1)._fields, lane(st, 1), lane(st._make(frozen), 1)):
        assert torch.equal(a, b), name


def test_a_kernel_refuses_a_vmapped_tensor_on_the_card(cuda_device):
    """On the card a hand kernel under torch.func.vmap raises a TypeError
    that names the lane-batched form, and cross_batch passes it on for an
    unmarked integrand that looks its nodes up with kernel B."""
    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.cross import cross_batch
    from ttcross_tpu_torch.ops.dense import table_lookup

    fam = make_mvn_family(d=3, n=9, corrs=(0.3, 0.5), device=cuda_device)

    def unmarked(ind, par):
        x = table_lookup(fam.table, ind)
        return torch.exp(-((x - par["mu"]) ** 2).sum(dim=1))

    with pytest.raises(TypeError, match="lane_batched"):
        cross_batch(unmarked, [fam.n] * 3, fam.params, max_rank=3)
    res = cross_batch(fam.fun, [fam.n] * 3, fam.params, max_rank=3, quad=[fam.quad_weights] * 3,
                      truth=1.0)
    assert all(r.tt.device.type == "cuda" and np.isfinite(r.values[-1]) for r in res)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_cuda_batch.py: the lane sweep over
    # the seeds 0-19 of its lottery uniforms (LANE_SWEEP_SEED), every
    # pivoting; needs a CUDA device.
    import sys

    failed = []
    for seed in range(20):
        LANE_SWEEP_SEED = seed
        for piv in (1, 0, -1):
            try:
                test_a_lane_sweep_makes_no_host_sync(piv, torch.device("cuda"))
            except AssertionError as e:
                failed.append((seed, piv, str(e)[:200]))
    print("lane sweep, seeds 0-19 x pivoting (1, 0, -1): failed", failed)
    sys.exit(1 if failed else 0)
