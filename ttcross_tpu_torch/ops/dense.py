"""Dense helpers: the lookups and balanced chains of the main path, and the
small matrix toolbox.

Counterpart of ttcross_tpu/ops/dense.py (:110-380; mat.f90, ort.f90,
lr.f90, trans.f90).  The one-hot split-f32 lookups and power-of-2 range
rescales that the TPU needed are not ported: the lookups here are plain
f64 gathers, and the small-table one runs on kernel B (the Ising integrand
does its own lookup inside its fused kernel).  The matrix helpers take
tensors (or numpy arrays, which go to ``device``) and work on the tensor's
device with torch.linalg.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import small_table_lookup

__all__ = ["as_tensor", "table_lookup", "row_lookup", "batched_row_lookup",
           "masked_slot_write", "matmul_by_sums", "pow2_balance_mats", "balanced_matmul_chain",
           "scale_pow2", "svd_chopped", "matinv", "eye", "laplace", "norm2p",
           "qr_ort", "gram_schmidt", "orto_block", "aca", "greedy_cur",
           "transpose2d", "transpose3d"]


def table_lookup(table, ind):
    """out[...] = table[ind] for a small f64 table, 0 out of range.

    table (n,) or (L, n); ind (B, d) int32.  Returns (B, d), or (L, B, d)
    for L stacked tables: all L come from one kernel-B launch on CUDA."""
    if table.dim() == 1:
        return small_table_lookup(table[None], ind)[0]
    return small_table_lookup(table, ind)


def row_lookup(mat, lin, axis: int = 0):
    """Rows (axis=0) or columns (axis=1) of a 2-D matrix as rows:
    out[b, :] = mat[lin[b], :] or mat[:, lin[b]]."""
    if axis == 0:
        return mat[lin]
    return mat[:, lin].T


def batched_row_lookup(tabs, lin):
    """Rows of a stack of matrices: out[b, l, :] = tabs[b, lin[b, l], :]
    for tabs (B, M, K) and lin (B, L); lin (B,) gives (B, K)."""
    single = lin.dim() == 1
    if single:
        lin = lin[:, None]
    B, L = lin.shape
    out = tabs.gather(1, lin.long()[:, :, None].expand(B, L, tabs.shape[2]))
    return out[:, 0] if single else out


def masked_slot_write(buf, dim: int, slot, new, upd) -> None:
    """In place, for every p: buf[p]'s slot slot[p] along dim becomes new[p]
    where upd[p] and stays as it was elsewhere.

    buf (P, ...) with dim >= 1; slot (P,) int64 in range; new has buf's
    shape without dim; upd (P,) bool.  One slot per p, so no index repeats,
    and nothing here waits for the device (JAX: a one-hot where)."""
    shape = list(buf.shape)
    shape[dim] = 1
    lead = (-1,) + (1,) * (buf.dim() - 1)
    idx = slot.view(lead).expand(shape)
    old = buf.gather(dim, idx)
    buf.scatter_(dim, idx, torch.where(upd.view(lead), new.unsqueeze(dim), old))


def _scale_by_halves(x, biased):
    """x * 2**(biased - 2046) for an int64 tensor biased in [2, 4090]: two
    normal f64 factors made from exponent bits (exact on every device), of
    exponents floor and ceiling of half the shift, one after the other.  Both
    scale the same way, so no intermediate leaves the range between x and the
    result.  An f32 x takes the factors rounded to f32: exact while half the
    shift is within f32's exponent range."""
    lo = biased >> 1
    x = x * (lo << 52).view(torch.float64).to(x.dtype)
    return x * ((biased - lo) << 52).view(torch.float64).to(x.dtype)


def scale_pow2(x, e):
    """x * 2**e for an integer-valued tensor e (int64, or a float holding
    integers; broadcast against x), exact wherever the result is
    representable.

    2**e itself leaves the f64 range beyond |e| = 1023, while the value
    chain of a long train balances matrices whose largest entry may be
    subnormal (e down to -1074) and ends on an exponent of either sign.  So
    the shift is applied as two in-range factors (_scale_by_halves).  Beyond
    |e| = 2044 the result of any normal x overflows or vanishes, as it does
    here."""
    return _scale_by_halves(x, e.to(torch.int64).clamp(-2044, 2044) + 2046)


def pow2_balance_mats(x):
    """Per-matrix exact power-of-2 rescale of a (K, R, R) stack: returns
    (x * 2^-e, e) with max|x * 2^-e| in [1, 2) and e int64 (zero or
    non-finite matrices pass through with e = 0).  The exponent is read
    from the bits (frexp), so it is the true floor(log2 max|x|), subnormal
    maxima included."""
    m = x.abs().amax(dim=(-2, -1))
    ok = (m > 0) & (m < float("inf"))                  # false for NaN too
    ex = torch.where(ok, torch.frexp(m).exponent.long(), 1)    # m = mantissa in [0.5, 1) * 2^ex
    return _scale_by_halves(x, (2047 - ex)[..., None, None]), ex - 1


def matmul_by_sums(a, b):
    """a (..., M, K) @ b (..., K, Q) as elementwise products summed over a
    contiguous last axis.  Each matrix of a batch is then computed the same
    way whatever the batch's size: torch takes cuBLAS's single gemm for a
    batch of one matrix and its batched gemm for more (on the CPU a gemv
    against a batched path), which round otherwise, while a short sum over
    the last axis does not depend on the number of sums.  So a lane of a
    family (cross/batch.py) repeats its single run bit for bit.  For the
    engine's small products (K, Q <= a few dozen)."""
    return (a[..., :, None, :] * b.mT.contiguous()[..., None, :, :]).sum(dim=-1)


def balanced_matmul_chain(mats):
    """Ordered product of a (K, R, R) stack as a log2(K)-depth pairwise
    tree with an exact power-of-2 rebalance per level.  Returns (P, e) with
    mats[0] @ ... @ mats[K-1] = P * 2^e and max|P| ~ 1, so long chains
    whose partial products leave the f64 range stay representable.  A
    (K, L, R, R) stack chains each of its L lanes: P (L, R, R), e (L,), each
    lane's product the same as alone (matmul_by_sums)."""
    K, R = mats.shape[0], mats.shape[-1]
    mats, ex = pow2_balance_mats(mats)
    P = 1 << max(K - 1, 1).bit_length()        # next power of two >= K
    if P > K:
        eye = torch.eye(R, dtype=mats.dtype, device=mats.device)
        mats = torch.cat([mats, eye.expand(P - K, *mats.shape[1:])], dim=0)
        ex = torch.cat([ex, ex.new_zeros((P - K,) + ex.shape[1:])])
    while mats.shape[0] > 1:
        prod, e = pow2_balance_mats(matmul_by_sums(mats[0::2], mats[1::2]))
        mats, ex = prod, ex[0::2] + ex[1::2] + e
    return mats[0], ex[0]


def as_tensor(a, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The package's one conversion of a caller's array.  A tensor stays
    where it lies unless ``device`` is given; anything else (a numpy array,
    a list) is copied and goes to the card unless ``device`` says
    otherwise.  ``dtype=None`` keeps the dtype."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
        device = "cuda" if device is None else device
    return a.to(device=device, dtype=dtype)


def svd_chopped(a, tol: float | None = None, rmax: int | None = None, device=None):
    """SVD with rank truncation: (u, s, vh, err) with the chopped rank of
    the reference's tail-energy rule (svd + chop, mat.f90:340-458).  The
    factorization is tt/ortho.py's: gesvd on the card, LAPACK on the CPU."""
    from ..tt.ortho import _svd, chop_rank

    u, s, vh = _svd(as_tensor(a, device))
    r = chop_rank(s.cpu().numpy(), tol=tol, rmax=rmax)
    err = float(torch.linalg.norm(s[r:]))
    return u[:, :r], s[:r], vh[:r], err


def matinv(a, method: str = "svd", tol: float = 0.0, device=None):
    """Matrix (pseudo-)inverse via SVD with a small-singular-value cutoff,
    or a plain LU inverse (matinv, mat.f90:23-236)."""
    from ..tt.ortho import _svd

    a = as_tensor(a, device)
    if method == "lu":
        return torch.linalg.inv(a)
    u, s, vh = _svd(a)
    cutoff = (tol * s.max()).clamp(min=0.0)
    sinv = torch.where(s > cutoff, 1.0 / torch.where(s > cutoff, s, 1.0), 0.0)
    return (vh.mH * sinv) @ u.mH


def eye(m: int, n: int | None = None, dtype: torch.dtype = torch.float64, device="cuda"):
    """Rectangular identity (eye, mat.f90:239-258)."""
    return torch.eye(m, n or m, dtype=dtype, device=device)


def laplace(n: int, dtype: torch.dtype = torch.float64, device="cuda"):
    """1-D Laplacian stencil matrix tridiag(-1, 2, -1) (laplace, mat.f90)."""
    one = torch.ones(n - 1, dtype=dtype, device=device)
    return (2.0 * torch.eye(n, dtype=dtype, device=device)
            - torch.diag(one, 1) - torch.diag(one, -1))


def norm2p(a, iters: int = 32, key: int = 0, device=None):
    """Spectral norm by power iteration on A^H A (norm2p_d,
    mat.f90:474-507), from a start vector drawn by a CPU generator seeded
    with key; a 0-d tensor."""
    a = as_tensor(a, device)
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    real = a.real.dtype if a.is_complex() else a.dtype
    v = torch.randn(a.shape[1], generator=gen, dtype=real).to(a.device, a.dtype)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = a.mH @ (a @ v)
        v = w / torch.linalg.norm(w).clamp(min=1e-300)
    return torch.linalg.norm(a @ v)


def qr_ort(a, device=None):
    """Orthonormalize columns: (Q, R) with economy shapes (ort0,
    ort.f90:17-149)."""
    return torch.linalg.qr(as_tensor(a, device), mode="reduced")


def gram_schmidt(basis, v, passes: int = 3, tol: float = 0.5, device=None):
    """Orthogonalize v against the orthonormal columns of `basis` with up
    to `passes` passes, going on while the norm collapses by more than tol
    (ort1, ort.f90:152-228).  Returns (v_ortho, coeffs).

    The JAX package loops while a condition on the data holds; here all
    `passes` passes are laid out and a pass after the condition failed is
    masked out, so nothing waits for the device."""
    basis, v = as_tensor(basis, device), as_tensor(v, device)
    prev = torch.linalg.norm(v)
    coeffs = basis.mH @ v
    v = v - basis @ coeffs
    live = torch.ones((), dtype=torch.bool, device=v.device)
    for _ in range(1, passes):
        live = live & (torch.linalg.norm(v) < tol * prev)
        c = basis.mH @ v
        v2 = v - basis @ c
        prev = torch.where(live, torch.linalg.norm(v2), prev)
        v = torch.where(live, v2, v)
        coeffs = torch.where(live, coeffs + c, coeffs)
    return v, coeffs


def orto_block(basis, block, device=None):
    """Orthogonalize the columns of `block` against `basis`, then among
    themselves (orto, ort.f90:231-361)."""
    basis, block = as_tensor(basis, device), as_tensor(block, device)
    block = block - basis @ (basis.mH @ block)
    block = block - basis @ (basis.mH @ block)    # one re-orthogonalization
    return torch.linalg.qr(block, mode="reduced")[0]


def aca(a, tol: float = 1e-12, rmax: int | None = None, device=None):
    """Adaptive cross approximation of a dense matrix to tolerance:
    (u, v, err) with a ~= u @ v (lr_d2, lr.f90:11-70; greedy column-max
    pivoting with rank-1 deflation).  The stop depends on the residual's
    norm, so every step reads it on the host."""
    a = as_tensor(a, device)
    m, n = a.shape
    rmax = min(rmax or min(m, n), min(m, n))
    z = a.clone()
    nrm = float(torch.linalg.norm(a))
    us, vs = [], []
    err = nrm
    while len(us) < rmax and err > tol * max(nrm, 1e-300):
        j = torch.argmax(z.abs().amax(dim=0))
        i = torch.argmax(z[:, j].abs())
        piv = z[i, j]
        if float(piv) == 0:
            break
        u = z[:, j].clone()
        v = z[i, :] / piv
        z -= torch.outer(u, v)
        us.append(u)
        vs.append(v)
        err = float(torch.linalg.norm(z))
    u = torch.stack(us, dim=1) if us else a.new_zeros((m, 0))
    v = torch.stack(vs, dim=0) if vs else a.new_zeros((0, n))
    return u, v, err / max(nrm, 1e-300)


def greedy_cur(a, r: int, device=None):
    """Greedy rank-r CUR by the global residual maximum: (u, v, rows, cols)
    with a ~= u @ v (d2_lrg, lr.f90:73-96); rows and cols are lists of
    ints, read from the device once at the end."""
    a = as_tensor(a, device)
    m, n = a.shape
    e = a.clone()
    u, v = a.new_zeros((m, r)), a.new_zeros((r, n))
    picks = []
    for p in range(r):
        flat = torch.argmax(e.abs()).view(1)
        picks.append(flat)
        col = e.index_select(1, flat % n)[:, 0]
        row = e.index_select(0, flat // n)[0]
        u[:, p] = col
        v[p, :] = row / row.index_select(0, flat % n)
        e -= torch.outer(u[:, p], v[p, :])
    flat = torch.cat(picks).tolist()
    return u, v, [f // n for f in flat], [f % n for f in flat]


def transpose2d(a):
    """2-D transpose (trans.f90:19-70)."""
    return as_tensor(a).T


_PRM3 = {1: (0, 1, 2), 2: (0, 2, 1), 3: (1, 0, 2), 4: (2, 1, 0), 5: (1, 2, 0), 6: (2, 0, 1)}


def transpose3d(p: int, a):
    """The six 3-D permutations keyed like the reference's prm3 table
    (d3_trans + prm3, trans.f90:72-240)."""
    return as_tensor(a).permute(_PRM3[p])
