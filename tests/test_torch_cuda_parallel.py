"""The distributed engines and the lane-batched all-bonds sweep on the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel.py

A one-rank NCCL group (parallel/launch.py::spawn_ranks, the kernels built
by this process first) makes two distributed sweeps and values, sequential
and red-black with the chain, with torch's sync debug mode set to raise:
nothing inside a sweep waits for the card (the stop rule's read between
sweeps does, and is not called here).  Two gloo ranks on one card (NCCL
refuses two ranks on one GPU) check every collective helper on CUDA
tensors.  The lane-batched all-bonds sweep of cross_batch(sweep_mode=
"jacobi") runs under the same mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.parallel import bond_mesh, spawn_ranks

pytestmark = pytest.mark.cuda
TIMEOUT = 300


@pytest.fixture(scope="module")
def built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    from ttcross_tpu_torch.ops import _build

    _build.build()        # once, before any rank spawns


def _rank_sync_free(mode):
    """Sweeps 2 and 3 (and their values) of the distributed C_32 cross
    (n = 17, rank 8) under sync debug "error", after a first sweep that
    starts NCCL's communicator and loads the kernels."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, quad_matrix
    from ttcross_tpu_torch.parallel.engine import make_parallel_engine, rank_uniforms

    mesh = bond_mesh()
    p = make_ising("C", 32, 17, device=mesh.device)
    R, jacobi = 8, mode != "sequential"
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=p.d, n=(p.n,) * p.d, N=p.n, R=R, piv=1, small_element=se,
                      small_pivot=sp, jacobi=jacobi, rb=mode == "jacobi-rb")
    pk = make_parallel_engine(p.fun, cfg, mesh, chain=p.chain if jacobi else None)
    U = rank_uniforms(0, mesh.rank, 3, pk.max_cnt if jacobi else p.d - 1,
                      2 * (R + p.n)).to(mesh.device)
    w = quad_matrix([p.quad_weights] * p.d, cfg.n, cfg.N, mesh.device, torch.float64)
    st = pk.kit.init_fn()
    cs = pk.kit.chain_ev.states_from_vip(st.vip) if jacobi else None
    st, _, _, cs = pk.sweep_fn(st, 1, U[0], cs)
    pk.value_fn(st, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (2, 3):
            st, _, _, cs = pk.sweep_fn(st, it, U[it - 1], cs)
            pk.value_fn(st, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return mesh.backend, str(st.cores.device), st.rk.tolist()


@pytest.mark.parametrize("mode", ["sequential", "jacobi-rb"])
def test_one_rank_nccl_sweeps_make_no_sync(built, mode):
    backend, where, rk = spawn_ranks(_rank_sync_free, 1, args=(mode,), backend="nccl",
                                     timeout=TIMEOUT)[0]
    assert backend == "nccl" and where.startswith("cuda") and max(rk) > 1


def _rank_collectives():
    """Every collective helper on CUDA tensors over gloo (two ranks on one
    card: the host-staged all_gather and shift, all_reduce on the card)."""
    from ttcross_tpu_torch.parallel.mesh import all_gather, gmax, psum, shift

    mesh = bond_mesh(device="cuda:0")
    me = mesh.rank
    x = torch.full((3,), float(me + 1), dtype=torch.float64, device=mesh.device)
    i32 = torch.full((2,), me + 1, dtype=torch.int32, device=mesh.device)
    i64 = torch.full((2,), me + 1, dtype=torch.int64, device=mesh.device)
    out = {"psum": psum(mesh, x), "gmax": gmax(mesh, x), "all_gather": all_gather(mesh, x),
           "shift": shift(mesh, x, 1), "psum_i32": psum(mesh, i32), "psum_i64": psum(mesh, i64),
           "c128": psum(mesh, torch.view_as_real(x.to(torch.complex128)))}
    assert all(t.device.type == "cuda" for t in out.values())
    return {k: v.cpu().numpy() for k, v in out.items()}


def test_gloo_collectives_on_the_card(built):
    r0, r1 = spawn_ranks(_rank_collectives, 2, backend="gloo", timeout=TIMEOUT)
    for r, got in enumerate((r0, r1)):
        np.testing.assert_array_equal(got["psum"], [3.0] * 3)
        np.testing.assert_array_equal(got["gmax"], [2.0] * 3)
        np.testing.assert_array_equal(got["all_gather"], [[1.0] * 3, [2.0] * 3])
        np.testing.assert_array_equal(got["shift"], [2.0 - r] * 3)
        np.testing.assert_array_equal(got["psum_i32"], [3, 3])
        np.testing.assert_array_equal(got["psum_i64"], [3, 3])
        np.testing.assert_array_equal(got["c128"], [[3.0, 0.0]] * 3)


def test_lane_jacobi_sweep_makes_no_sync(built):
    """One sweep of the 4-lane mvn_d6 family's all-bonds engine (kernel A
    batched over lanes x bonds, kernel B once per integrand step) after a
    first one, one lane frozen, with sync debug "error"."""
    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.batch import _lane_fun
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine

    dev = torch.device("cuda")
    fam = make_mvn_family(d=6, n=65, corrs=np.linspace(0.2, 0.6, 4), device=dev)
    R, L, d = 20, 4, 6
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=d, n=(fam.n,) * d, N=fam.n, R=R, piv=1, small_element=se,
                      small_pivot=sp, jacobi=True)
    kit = make_engine(_lane_fun(fam.fun, fam.params), cfg, dev, lanes=L)
    gen = torch.Generator().manual_seed(0)
    U = torch.rand((2, L, d - 1, 2, 2 * (R + fam.n)), generator=gen,
                   dtype=torch.float64).to(dev)
    live = torch.tensor([True, True, False, True], device=dev)
    st = kit.sweep_fn(kit.init_fn(), 1, U[0], live=live)
    frozen = st.rk[:, 2].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = kit.sweep_fn(st, 2, U[1], live=live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(st.rk[:, 2], frozen) and int(st.rk[:, 0].max()) > 1


def _rank_c32(device, mode):
    """bench.py's parallel line (C_32, n = 16, rank 8) through cross_parallel
    on this rank (device None: the rank's card)."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.parallel import cross_parallel

    mesh = bond_mesh(device=device)
    p = make_ising("C", 32, 16, device=mesh.device)
    res = cross_parallel(p.fun, [p.n] * p.d, max_rank=8, accuracy=500 * 2.2e-16, pivoting=1,
                         quad=[p.quad_weights] * p.d, truth=p.truth, sweep_mode=mode, mesh=mesh)
    return {"values": list(res.values), "ranks": res.ranks, "n_evals": res.neval,
            "sweeps": res.sweeps, "backend": mesh.backend, "device": str(mesh.device)}


@pytest.mark.parametrize("mode", ["sequential", "jacobi-rb"])
def test_nccl_ranks_across_cards_match_gloo_on_the_cpu(built, mode):
    """One NCCL rank per card (up to four): every rank the same result, and
    that of as many gloo ranks on the CPU with the same draws (ranks,
    n_evals, sweeps; values to 1e-13: the card's sums run in other orders)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: NCCL refuses two ranks on one card")
    world = min(cards, 4)
    on_cards = spawn_ranks(_rank_c32, world, args=(None, mode), backend="nccl", timeout=TIMEOUT)
    on_cpu = spawn_ranks(_rank_c32, world, args=("cpu", mode), timeout=TIMEOUT, threads=2)
    assert all(r == dict(on_cards[0], device=r["device"]) for r in on_cards)
    assert {r["device"] for r in on_cards} == {f"cuda:{i}" for i in range(world)}
    got, want = on_cards[0], on_cpu[0]
    assert got["backend"] == "nccl"
    assert (got["ranks"], got["n_evals"], got["sweeps"]) == (want["ranks"], want["n_evals"],
                                                             want["sweeps"])
    np.testing.assert_allclose(got["values"], want["values"], rtol=1e-13)
