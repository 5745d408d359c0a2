"""The dd tier's CUDA kernels (csrc/dd_kernels.cu) and the dd engine on
the card.

These need an NVIDIA GPU and skip without one.  They import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dd.py

Tolerance: none.  Each dd kernel computes in the operation order of
ops/dd.py with intrinsics nvcc does not contract, and eager torch rounds
every operation once, so a kernel equals its plain version on the card bit
for bit, hi and lo."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.dd import DD

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(4321)


def _pair(gen, shape, dev, scale=1.0):
    hi = gen.standard_normal(shape) * scale
    lo = hi * gen.standard_normal(shape) * 2.0 ** -54
    return DD(torch.as_tensor(hi).to(dev), torch.as_tensor(lo).to(dev))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _views(kind, x, y, B, T, R, N):
    """x, y (B, T) views of the dd engine's passes: a lottery (both
    gathered), a column pass (y a broadcast vector), a row pass (x a
    broadcast vector, y the transposed row factor (T, N, R) of B = N R)."""
    if kind == "col":
        y = DD(*(p[0].expand(B, T) for p in y))
    elif kind == "row":
        x = DD(*(p[0].expand(B, T) for p in x))
        y = DD(*(p.reshape(T, N * R)[:, :B].T for p in y))
    return x, y


@pytest.mark.parametrize("kind,B,T,N", [("lottery", 226, 48, 65), ("col", 3120, 48, 65),
                                        ("row", 3120, 48, 65), ("lottery", 98, 16, 33),
                                        ("col", 528, 16, 33), ("row", 528, 16, 33),
                                        ("col", 9000, 8, 17)])
@pytest.mark.parametrize("rank_frac", [0.0, 0.5, 1.0])
def test_dd_score_kernel_matches_plain(kind, B, T, N, rank_frac, gen, cuda_device):
    R = T
    x = _pair(gen, (B, T), cuda_device)
    y = _pair(gen, (T, N, R) if kind == "row" else (B, T), cuda_device)
    x, y = _views(kind, x, y, B, T, R, N)
    vals = _pair(gen, (B,), cuda_device)
    mask = torch.as_tensor(gen.random(B) > 0.3).to(cuda_device)
    rank = torch.tensor([int(rank_frac * T)], dtype=torch.int32, device=cuda_device)
    side = K.MASK_Y if kind == "col" else K.MASK_X
    n0 = K.dd_score_residual_argmax.launches
    got = K.dd_score_residual_argmax(vals, x, y, rank, mask, side)
    want = K.dd_score_residual_argmax_plain(vals, x, y, rank, mask, side)
    torch.cuda.synchronize()
    assert K.dd_score_residual_argmax.launches == n0 + 1
    assert _same(got[0], want[0])
    assert int(got[1]) == int(want[1])
    assert _same(got[2], want[2])


def test_dd_score_kernel_ties_and_empty_mask(gen, cuda_device):
    """Equal scores in different blocks of the cluster: the smaller index
    wins; no mask (the accept's products): flat 0, r the sum itself."""
    B, T = 5000, 8
    x = _pair(gen, (B, T), cuda_device)
    y = DD(torch.zeros(B, T, dtype=torch.float64, device=cuda_device),
           torch.zeros(B, T, dtype=torch.float64, device=cuda_device))
    vals = DD(torch.ones(B, dtype=torch.float64, device=cuda_device),
              torch.zeros(B, dtype=torch.float64, device=cuda_device))
    vals.hi[[300, 2600, 4999]] = 7.0
    mask = torch.ones(B, dtype=torch.bool, device=cuda_device)
    r, flat, best = K.dd_score_residual_argmax(vals, x, y, None, mask, K.MASK_NONE)
    assert int(flat) == 300 and float(best.hi) == 7.0
    mask[:] = False
    r, flat, _ = K.dd_score_residual_argmax(vals, x, y, None, mask, K.MASK_NONE)
    want = K.dd_score_residual_argmax_plain(vals, x, y, None, mask, K.MASK_NONE)
    assert int(flat) == int(want[1]) == 0 and _same(r, want[0])
    r, flat, _ = K.dd_score_residual_argmax(None, x, _pair(gen, (B, T), cuda_device), None, None)
    assert int(flat) == 0


@pytest.mark.parametrize("M,N,T,layout", [(48, 65, 48, "mm"), (65, 48, 48, "mm"),
                                          (48, 3120, 48, "mm"), (3120, 48, 48, "mm"),
                                          (48, 48, 65, "value"), (1, 48, 48, "mm"),
                                          (16, 33, 16, "mm")])
def test_dd_dot_kernel_matches_plain(M, N, T, layout, gen, cuda_device):
    if layout == "mm":       # A (M, T) @ B (T, N)
        a, b = _pair(gen, (M, T), cuda_device), _pair(gen, (T, N), cuda_device)
        x = DD(*(p[:, None, :].expand(M, N, T) for p in a))
        y = DD(*(p.T[None].expand(M, N, T) for p in b))
    else:                    # m[i, j] = sum_n g[i, n, j] w[n]
        g, w = _pair(gen, (M, T, N), cuda_device), _pair(gen, (T,), cuda_device)
        x = DD(*(p.permute(0, 2, 1) for p in g))
        y = DD(*(p[None, None].expand(M, N, T) for p in w))
    got, want = K.dd_dot(x, y), K.dd_dot_plain(x, y)
    assert _same(got, want)


@pytest.mark.parametrize("B,ranks,n", [(1560, (1, 24, 32, 32, 24, 1), 65),
                                       (3120, (1, 32, 32, 32, 32, 1), 65),
                                       (226, (1, 8, 8, 1), 17), (500, (1, 48, 64, 48, 1), 33)])
def test_dd_gather_tt_kernel_matches_plain(B, ranks, n, gen, cuda_device):
    from ttcross_tpu_torch.tt.types import TT

    d = len(ranks) - 1
    t = TT(tuple(torch.as_tensor(gen.standard_normal((ranks[c], n, ranks[c + 1]))).to(cuda_device)
                 for c in range(d)))
    packed = K.pack_tt(t)
    ind = torch.as_tensor(gen.integers(0, n, (B, d)), dtype=torch.int32).to(cuda_device)
    got = K.dd_gather_tt_fused(packed, ind)
    want = K.dd_gather_tt_plain(packed, ind)
    assert _same(got, want)


@pytest.mark.parametrize("B,d,n", [(3120, 5, 65), (226, 5, 65), (2080, 3, 65), (98, 3, 33),
                                   (136, 3, 17), (1, 8, 17), (500, 15, 17), (70, 31, 33)])
def test_dd_ising_kernel_matches_plain(B, d, n, gen, cuda_device):
    from ttcross_tpu_torch.apps.ising import make_ising_dd

    _, fun_dd, _, _ = make_ising_dd(m=d + 1, n=n, device=cuda_device)
    tables = fun_dd.tables
    ind = torch.as_tensor(gen.integers(0, tables.shape[1], (B, d)), dtype=torch.int32)
    ind = ind.to(cuda_device)
    got = K.ising_c_integrand_dd_fused(tables, ind)
    want = K.ising_c_integrand_dd_plain(tables, ind)
    assert _same(got, want)


def test_dd_contract_card_equals_cpu(gen, cuda_device):
    """dd_contract (two launches of D4 per core on the card) against its
    CPU run, the plain dd operations: bit for bit."""
    from ttcross_tpu_torch.ops.dd import dd_contract
    from ttcross_tpu_torch.tt.types import TT

    ranks, n = (1, 24, 48, 32, 1), 65
    cores = [gen.standard_normal((ranks[c], n, ranks[c + 1])) for c in range(len(ranks) - 1)]
    wh = [gen.random(n) for _ in cores]
    wl = [w * gen.standard_normal(n) * 2.0 ** -54 for w in wh]
    got = dd_contract(TT(tuple(torch.as_tensor(g).to(cuda_device) for g in cores)), wh, wl)
    want = dd_contract(TT(tuple(torch.as_tensor(g) for g in cores)), wh, wl)
    assert (float(got.hi), float(got.lo)) == (float(want.hi), float(want.lo))


def test_dd_kernels_refuse_wrong_input(gen, cuda_device):
    x = _pair(gen, (10, 4), cuda_device)
    with pytest.raises(ValueError):
        K.dd_score_residual_argmax(None, x, _pair(gen, (11, 4), cuda_device))
    with pytest.raises(TypeError):
        K.dd_dot(DD(*(p.float()[None] for p in x)), DD(*(p.float()[None] for p in x)))
    with pytest.raises(ValueError):
        K.ising_c_integrand_dd_fused(torch.zeros((2, 5), dtype=torch.float64, device=cuda_device),
                                     torch.zeros((3, 2), dtype=torch.int32, device=cuda_device))


def test_cross_dd_card_equals_cpu(cuda_device):
    """cross_dd at C_4, n = 17, rank 8 on the card and on the CPU with the
    same key: the same draws, eager dd operations rounded once on both and
    kernels equal to their plain versions, so the value, the pivots, the
    ranks and the dd cores agree bit for bit."""
    from ttcross_tpu_torch.apps.ising import make_ising_dd
    from ttcross_tpu_torch.cross import cross_dd

    runs = []
    for where in (cuda_device, "cpu"):
        prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device=where)
        runs.append(cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8, pivoting=1,
                             device=where))
    card, cpu = runs
    assert card.value == cpu.value and card.ranks == cpu.ranks and card.neval == cpu.neval
    assert np.array_equal(card.vip, cpu.vip)
    for a, b in zip(card.cores_hi + card.cores_lo, cpu.cores_hi + cpu.cores_lo):
        assert np.array_equal(a, b)


def test_dd_sweeps_make_no_host_sync(cuda_device):
    """Two dd sweeps and a call of the defect's integrand under torch's sync
    debug mode set to raise: the lottery's integers, the pivot indices and
    the accept stay on the card (chip_smoke.py phase 15 runs the same)."""
    import chip_smoke

    row = chip_smoke.dd_sweeps_without_sync(cuda_device)
    assert row["sync_free_sweeps"] == 2 and row["ranks"][1] > 1
