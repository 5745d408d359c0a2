"""The port's TT algebra, container helpers, dense toolbox, sampling and
small utilities against the JAX package, on the same numpy inputs.

Tolerances: the TT algebra 1e-12 of the result's scale (the same f64 or
complex128 operations, sums in another order); selections (aca,
greedy_cur, chop ranks, lexicographic helpers) exactly."""

import io
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import ttcross_tpu.tt as jtt
import ttcross_tpu.utils as jutils
from ttcross_tpu.ops import dense as jdense
from ttcross_tpu.ops import quadrature as jquad
from ttcross_tpu.tt import TT as JTT
import ttcross_tpu_torch as port
import ttcross_tpu_torch.tt as ptt
import ttcross_tpu_torch.utils as putils
from ttcross_tpu_torch.apps import cos as pcos
from ttcross_tpu_torch.ops import dense as pdense
from ttcross_tpu_torch.ops import quadrature as pquad
from ttcross_tpu_torch.ops.sampling import weighted_lottery
from ttcross_tpu_torch.tt import TT

RTOL = 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(20260906)


def _train(rng, n, r, cplx=False):
    r = [1, *r, 1]
    cores = []
    for c in range(len(n)):
        g = rng.normal(size=(r[c], n[c], r[c + 1]))
        if cplx:
            g = g + 1j * rng.normal(size=g.shape)
        cores.append(g)
    return JTT(tuple(jnp.asarray(g) for g in cores)), TT(tuple(torch.from_numpy(g) for g in cores))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _same_train(p, j, rtol=RTOL):
    assert p.r == j.r and p.n == j.n
    for a, b in zip(p.cores, j.cores):
        _close(a, b, rtol)


SHAPES = [((5, 4, 6, 3), (2, 3, 2)), ((3, 4, 3, 5, 4, 3), (3, 5, 4, 2, 3)),
          ((4, 4, 4, 4, 4), (5, 5, 5, 5))]


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n,r", SHAPES)
def test_scalar_valued_algebra_matches_jax(n, r, cplx, rng):
    """sumall, contract (real and complex weights), dot, norm: 0-d tensors."""
    ja, pa = _train(rng, n, r, cplx)
    jb, pb = _train(rng, n, r[::-1] if len(set(n)) == 1 else r, cplx)
    _close(ptt.sumall(pa), jtt.sumall(ja))
    wr = [rng.normal(size=k) for k in n]
    wc = [rng.normal(size=k) + 1j * rng.normal(size=k) for k in n]
    for w in (wr, wc):
        got = ptt.contract(pa, w)
        assert got.dim() == 0
        assert got.dtype == (torch.complex128 if cplx or w is wc else torch.float64)
        _close(got, complex(jtt.contract(ja, w)) if got.is_complex() else jtt.contract(ja, w))
    _close(ptt.dot(pa, pb), jtt.dot(ja, jb))
    _close(ptt.norm(pa), jtt.norm(ja))
    with pytest.raises(ValueError, match="mismatch"):
        ptt.dot(pa, TT(tuple(torch.ones(1, k + 1, 1, dtype=torch.float64) for k in n)))


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n,r", SHAPES)
def test_train_valued_algebra_matches_jax(n, r, cplx, rng):
    """add, scale, hadamard, group (both sides) and astype."""
    ja, pa = _train(rng, n, r, cplx)
    jb, pb = _train(rng, n, [max(1, x - 1) for x in r], cplx)
    _same_train(ptt.add(pa, pb), jtt.add(ja, jb))
    _same_train(ptt.scale(pa, -2.5), jtt.scale(ja, -2.5))
    _same_train(ptt.hadamard(pa, pb), jtt.hadamard(ja, jb))
    for side in (0, 1, None):
        _same_train(ptt.group(pa, pb, side), jtt.group(ja, jb, side))
    if not cplx:
        _same_train(ptt.scale(pa, 1.5 - 0.5j), jtt.scale(ja, 1.5 - 0.5j))
        _same_train(pa.astype(torch.complex128), ja.astype(jnp.complex128))
    _close(ptt.full(ptt.add(pa, pb)), np.asarray(jtt.full(ja)) + np.asarray(jtt.full(jb)),
           rtol=1e-11)


def test_norm_of_a_long_train_stays_in_range(rng):
    """30 cores of entries ~1e-8, then 30 of ~1e8: <a, a> without the
    per-core power-of-2 rescale underflows to 0 half way; with it the norm
    agrees with the JAX package's (host log bookkeeping)."""
    cores = [rng.normal(size=(1 if c == 0 else 2, 3, 1 if c == 59 else 2))
             * (1e-8 if c < 30 else 1e8) for c in range(60)]
    p = TT(tuple(torch.from_numpy(g) for g in cores))
    assert float(ptt.dot(p, p)) == 0.0
    got = float(ptt.norm(p))
    want = float(jtt.norm(JTT(tuple(jnp.asarray(g) for g in cores))))
    assert want > 0 and np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert float(ptt.norm(TT(tuple(torch.zeros_like(c) for c in p.cores[:3])))) == 0.0


def test_container_helpers_match_jax(rng):
    ja, pa = _train(rng, (5, 4, 6, 3), (2, 3, 2))
    assert pa.erank() == ja.erank() and pa.mem() == ja.mem()
    _, p2 = _train(rng, (5, 7), (3,))
    j2 = JTT(tuple(jnp.asarray(c.numpy()) for c in p2.cores))
    assert p2.erank() == j2.erank()
    n = (3, 4, 2)
    _same_train(port.ones(n, device="cpu"), jtt.ones(n))
    _same_train(port.zeros(n, device="cpu"), jtt.zeros(n))
    vs = [rng.normal(size=k) for k in n]
    _same_train(port.rank1(vs, device="cpu"), jtt.rank1(vs))
    _same_train(port.from_cores([c.numpy() for c in pa.cores], device="cpu"), ja)
    with pytest.raises(ValueError, match="inconsistent"):
        port.from_cores([np.ones((1, 3, 2)), np.ones((3, 3, 1))], device="cpu")
    assert "device=cpu" in repr(pa)


NUMPY_ENTRIES = {
    "tt.from_cores": lambda a, **kw: port.from_cores([a.reshape(1, -1, 1)], **kw).cores[0],
    "tt.rank1": lambda a, **kw: port.rank1([a], **kw).cores[0],
    "ops.dense.as_tensor": lambda a, **kw: pdense.as_tensor(a, **kw),
    "ops.dense.qr_ort": lambda a, **kw: pdense.qr_ort(a.reshape(-1, 1), **kw)[0],
    "ops.dense.transpose2d": lambda a, **kw: pdense.transpose2d(a.reshape(-1, 1)),
    "apps.cos.gaussian_chf": lambda a, **kw: pcos.gaussian_chf(a[None, :2], a[:2], np.eye(2), **kw),
    "utils.lin_to_multi": lambda a, **kw: putils.lin_to_multi(a.astype(np.int64), (2, 2), **kw),
    "utils.multi_to_lin": lambda a, **kw: putils.multi_to_lin(a.astype(np.int64)[None, :2], (2, 2), **kw),
    "utils.assert_finite": lambda a, **kw: putils.assert_finite(a, **kw),
    "tt.from_dense": lambda a, **kw: ptt.from_dense(a.reshape(2, 2), **kw).cores[0],
}


@pytest.mark.parametrize("entry", sorted(NUMPY_ENTRIES))
def test_numpy_input_goes_to_the_card_by_default(entry):
    """One rule for every function that takes a caller's array: a numpy
    array goes to the card unless device= says otherwise (without a card
    that raises, it does not carry on on the CPU), and a tensor stays where
    it lies."""
    call = NUMPY_ENTRIES[entry]
    a = np.array([0.0, 1.0, 1.0, 0.0])
    if torch.cuda.is_available():
        assert call(a).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(a)
    if entry != "ops.dense.transpose2d":                   # takes no device=
        assert call(a, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["tt.from_cores", "tt.rank1", "ops.dense.as_tensor",
                                   "ops.dense.qr_ort", "ops.dense.transpose2d", "utils.assert_finite",
                                   "tt.from_dense"])
def test_tensor_input_stays_where_it_lies(entry):
    out = NUMPY_ENTRIES[entry](torch.tensor([0.0, 1.0, 1.0, 0.0], dtype=torch.float64))
    assert out.device.type == "cpu"


# ------------------------------------------------------------------ dense helpers
@pytest.mark.parametrize("tol,rmax", [(None, None), (1e-6, None), (None, 3), (1e-3, 5)])
def test_svd_chopped_matches_jax(tol, rmax, rng):
    a = rng.normal(size=(12, 9)) * (0.1 ** np.arange(9))[None, :]
    u, s, vh, err = pdense.svd_chopped(torch.from_numpy(a), tol=tol, rmax=rmax)
    ju, js, jvh, jerr = jdense.svd_chopped(a, tol=tol, rmax=rmax)
    assert s.shape[0] == js.shape[0]                      # the chopped rank
    _close(s, js)
    np.testing.assert_allclose(err, jerr, rtol=0, atol=RTOL * js[0])
    _close((u * s) @ vh, (ju * js) @ jvh)


def test_matrix_toolbox_matches_jax(rng):
    a = rng.normal(size=(7, 7)) + 3 * np.eye(7)
    ta = torch.from_numpy(a)
    for method in ("svd", "lu"):
        _close(pdense.matinv(ta, method), jdense.matinv(a, method), rtol=1e-11)
    low = a.copy()
    low[:, -1] = low[:, 0]                                 # singular: pseudo-inverse with a cutoff
    _close(pdense.matinv(torch.from_numpy(low), tol=1e-10), jdense.matinv(low, tol=1e-10),
           rtol=1e-10)
    _close(pdense.eye(3, 5, device="cpu"), jdense.eye(3, 5))
    _close(pdense.laplace(6, device="cpu"), jdense.laplace(6))
    m = rng.normal(size=(9, 4))
    # the start vectors differ (two generators): both converge to the top singular value
    top = np.linalg.svd(m, compute_uv=False)[0]
    np.testing.assert_allclose(float(pdense.norm2p(torch.from_numpy(m), iters=200)), top, rtol=1e-9)
    np.testing.assert_allclose(float(jdense.norm2p(m, iters=200)), top, rtol=1e-9)
    q, r = pdense.qr_ort(torch.from_numpy(m))
    jq, jr = jdense.qr_ort(m)
    _close(q @ r, np.asarray(jq) @ np.asarray(jr))
    _close((q.T @ q), np.eye(4))
    _close(pdense.transpose2d(torch.from_numpy(m)), jdense.transpose2d(m))
    t3 = rng.normal(size=(2, 3, 4))
    for p in range(1, 7):
        _close(pdense.transpose3d(p, torch.from_numpy(t3)), jdense.transpose3d(p, t3))


@pytest.mark.parametrize("collapse", [False, True])
def test_gram_schmidt_and_orto_block_match_jax(collapse, rng):
    """gram_schmidt's data-dependent loop as masked fixed passes: the same
    vector and coefficients whether or not the norm collapses (v almost
    inside the basis takes the second pass)."""
    basis = np.linalg.qr(rng.normal(size=(10, 4)))[0]
    v = rng.normal(size=10)
    if collapse:
        v = basis @ rng.normal(size=4) + 1e-9 * v
    got_v, got_c = pdense.gram_schmidt(torch.from_numpy(basis), torch.from_numpy(v))
    want_v, want_c = jdense.gram_schmidt(basis, v)
    _close(got_c, want_c)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=RTOL * np.linalg.norm(v))
    block = rng.normal(size=(10, 3))
    q = pdense.orto_block(torch.from_numpy(basis), torch.from_numpy(block))
    jq = np.asarray(jdense.orto_block(basis, block))
    _close(q @ q.T, jq @ jq.T, rtol=1e-11)                   # the same subspace
    assert float((torch.from_numpy(basis).T @ q).abs().max()) < 1e-14


def test_aca_and_greedy_cur_select_like_jax(rng):
    a = (rng.normal(size=(14, 5)) @ rng.normal(size=(5, 11))) + 1e-9 * rng.normal(size=(14, 11))
    ta = torch.from_numpy(a)
    u, v, err = pdense.aca(ta, tol=1e-6)
    ju, jv, jerr = jdense.aca(a, tol=1e-6)
    assert u.shape == ju.shape == (14, 5)                  # the same number of crosses
    _close(u, ju, rtol=1e-10)
    _close(v, jv, rtol=1e-10)
    np.testing.assert_allclose(err, jerr, rtol=1e-3)
    u, v, rows, cols = pdense.greedy_cur(ta, 5)
    ju, jv, jrows, jcols = jdense.greedy_cur(a, 5)
    assert (rows, cols) == (jrows, jcols)
    _close(u @ v, ju @ jv, rtol=1e-10)
    assert pdense.aca(torch.zeros((3, 4), dtype=torch.float64))[0].shape == (3, 0)


# ------------------------------------------------------------------ quadrature, sampling, utils
def test_quadrature_helpers_bitwise():
    x, w = pquad.lgwt(17)
    jx, jw = jquad.lgwt(17)
    assert np.array_equal(x, jx) and np.array_equal(w, jw)
    for got, want in zip(pquad.map_to_interval(x, w, -3.0, 5.5), jquad.map_to_interval(jx, jw, -3.0, 5.5)):
        assert np.array_equal(got, want)
    assert pquad.gauss_legendre is pquad.lgwt


def test_weighted_lottery_draws_in_proportion(rng):
    """The two packages draw with different generators, so the port's draw
    is held to the distribution: zero weights never drawn, frequencies
    within 5 sigma of |w| / sum |w|, and the same pairs for the same key."""
    wcol = np.array([0.0, 3.0, -1.0, 0.0, 2.0, 0.0])
    wrow = np.array([1e-300, 0.0, 1e-300])
    n = 20000
    got = weighted_lottery(11, wcol, wrow, n, device="cpu")
    assert got.shape == (n, 2) and torch.equal(got, weighted_lottery(11, wcol, wrow, n, device="cpu"))
    assert not torch.equal(got, weighted_lottery(12, wcol, wrow, n, device="cpu"))
    freq = np.bincount(got[:, 0].numpy(), minlength=6) / n
    p = np.abs(wcol) / np.abs(wcol).sum()
    assert np.all(freq[p == 0] == 0)
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / n) + 1e-12)
    rows = np.bincount(got[:, 1].numpy(), minlength=3) / n      # tiny weights do not underflow
    assert rows[1] == 0 and abs(rows[0] - 0.5) < 0.02


def test_indexing_and_guards_match_jax(rng):
    n = (3, 5, 4)
    lin = rng.integers(0, 60, size=50)
    multi = putils.lin_to_multi(torch.from_numpy(lin), n)
    assert np.array_equal(multi.numpy(), np.asarray(jutils.lin_to_multi(lin, n)))
    assert np.array_equal(putils.multi_to_lin(multi, n).numpy(), lin)
    assert np.array_equal(putils.multi_to_lin(multi.numpy(), n, device="cpu").numpy(),
                          np.asarray(jutils.multi_to_lin(multi.numpy(), n)))
    inds = rng.integers(0, 3, size=(12, 3))
    srt = putils.lex_sort(inds)
    assert np.array_equal(srt, jutils.lex_sort(inds))
    for probe in (srt[4], np.array([9, 9, 9])):
        assert putils.lex_find(srt, probe) == jutils.lex_find(srt, probe)
        assert np.array_equal(putils.lex_push(srt, probe), jutils.lex_push(srt, probe))
    assert putils.lex_compare([1, 2, 3], [2, 1, 3]) == jutils.lex_compare([1, 2, 3], [2, 1, 3]) == 1
    _, pa = _train(rng, (3, 4, 2), (2, 2))
    putils.tt_check(pa)
    bad = TT((pa.cores[0], pa.cores[1] * float("nan"), pa.cores[2]))
    assert putils.has_nan(*bad.cores) and not putils.has_nan(*pa.cores)
    with pytest.raises(FloatingPointError, match="core 1"):
        putils.tt_check(bad)
    with pytest.raises(FloatingPointError):
        putils.assert_finite(torch.tensor([1.0, float("inf")]))
    with pytest.raises(ValueError, match="inconsistent"):
        putils.tt_check(TT((pa.cores[0], pa.cores[0])))


def test_printers_print_what_the_jax_package_prints(rng):
    ja, pa = _train(rng, (3, 4, 2), (2, 2))

    def out(fn, *a):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(*a)
        return buf.getvalue()

    m = rng.normal(size=(3, 4))
    assert out(putils.say, torch.from_numpy(m)) == out(jutils.say, m)
    assert out(putils.say, torch.from_numpy(m + 1j * m)) == out(jutils.say, m + 1j * m)
    assert out(putils.saynnz, torch.from_numpy(m), 0.5) == out(jutils.saynnz, m, 0.5)
    got, want = out(putils.say_tt, pa).splitlines(), out(jutils.say_tt, ja).splitlines()
    assert got[1:] == want[1:] and got[0].startswith("TT d=3") and "device=cpu" in got[0]


# ------------------------------------------------------------------ the API surface
def test_every_ported_name_resolves():
    """Every public name of the JAX package's modules that the port has
    taken over resolves in the port under the same name (docs/api.md)."""
    import ttcross_tpu_torch.apps as papps
    import ttcross_tpu_torch.cross as pcross
    import ttcross_tpu_torch.interop as interop

    ported = {
        port: ["TT", "from_cores", "ones", "rank1", "zeros"],
        papps: ["IsingProblem", "ising_integrand", "make_ising", "MvnDensity", "MvnProblem",
                "make_mvn", "make_mvn_density", "make_mvn_family", "StdnormProblem",
                "make_stdnorm", "CosCoefficients", "cos_approximate", "gaussian_chf",
                "make_cos_coefficients", "s_vectors", "basket_chf", "basket_pdf",
                "CHF_REFERENCE", "CHF_RHO05", "ising_truth", "QuanticsProblem",
                "make_quantics", "quantics_cross"],
        pcross: ["CrossResult", "cross", "make_engine", "CrossState", "empty_state",
                 "cross_maxvol", "maxvol_refine", "accchk", "cross_batch", "BatchCrossResult",
                 "Skeleton", "extract_skeleton", "skeleton_value_fn", "skeleton_tt_fn",
                 "reevaluate_host"],
        ptt: ["TT", "from_cores", "ones", "rank1", "zeros", "add", "contract", "dot", "full",
              "gather", "group", "hadamard", "norm", "scale", "sumall", "value", "chop_rank",
              "orthogonalize", "svd_round", "save_ttbin", "load_ttbin", "save_ttbin_ref",
              "load_ttbin_ref", "save_npz", "load_npz", "save_hdf5", "load_hdf5", "save_state",
              "load_state", "from_dense"],
        putils: ["assert_finite", "has_nan", "tt_check", "lex_compare", "lex_find", "lex_push",
                 "lex_sort", "lin_to_multi", "multi_to_lin", "SweepRecord", "say", "say_tt",
                 "saynnz", "Timer", "write_jsonl", "profile_trace"],
        pdense: ["table_lookup", "row_lookup", "batched_row_lookup", "svd_chopped", "matinv",
                 "eye", "laplace", "norm2p", "qr_ort", "gram_schmidt", "orto_block", "aca",
                 "greedy_cur", "transpose2d", "transpose3d", "pow2_balance_mats",
                 "balanced_matmul_chain"],
        interop: ["state_from_numpy", "tt_from_numpy", "ising_from_numpy", "mvn_from_numpy",
                  "stdnorm_from_numpy", "cos_from_numpy", "sets_from_numpy"],
    }
    for mod, names in ported.items():
        for name in names:
            assert name in mod.__all__ and getattr(mod, name) is not None, (mod.__name__, name)
    import ttcross_tpu.apps as japps
    import ttcross_tpu.cross as jcross

    # the same names are the JAX package's
    for jmod, pmod in ((japps, papps), (jcross, pcross), (jtt, ptt), (jutils, putils)):
        missing = [name for name in ported[pmod] if not hasattr(jmod, name)]
        assert not missing, (jmod.__name__, missing)
    from ttcross_tpu_torch.cross.chains import pivot_index_sets
    from ttcross_tpu_torch.cross.state import pad_state

    assert callable(pivot_index_sets) and callable(pad_state)
    # names the JAX package keeps in a module's __all__ only
    import ttcross_tpu.apps.ising as jising
    import ttcross_tpu.cross.skeleton as jskeleton
    import ttcross_tpu.tt.ortho as jortho
    import ttcross_tpu_torch.apps.ising as pising
    import ttcross_tpu_torch.cross.skeleton as pskeleton
    import ttcross_tpu_torch.tt.ortho as portho

    import ttcross_tpu.config as jconfig
    import ttcross_tpu.cross.engine as jengine
    import ttcross_tpu.ops.quadrature as jquad
    import ttcross_tpu.utils.cli as jcli
    import ttcross_tpu_torch.config as pconfig
    import ttcross_tpu_torch.cross.engine as pengine
    import ttcross_tpu_torch.ops.quadrature as pquad
    import ttcross_tpu_torch.utils.cli as pcli

    for jmod, pmod, name in [(jskeleton, pskeleton, "derive_host_fun"),
                             (jortho, portho, "svd_round_host"),
                             (jising, pising, "ising_integrand_np"),
                             (jconfig, pconfig, "default_dtype"),
                             (jconfig, pconfig, "default_complex_dtype"),
                             (jquad, pquad, "quad_rinv"), (jquad, pquad, "quad_rinv_error"),
                             (jcli, pcli, "readarg"), (jcli, pcli, "print_config"),
                             (jcli, pcli, "maybe_accchk")]:
        assert name in pmod.__all__ and callable(getattr(pmod, name)) and hasattr(jmod, name)
    assert callable(pengine.auto_chunks) and callable(jengine.auto_chunks)
    assert callable(pising.IsingProblem.fun_np)
    # the device dd tier: ops/dd.py's names, the dd engine, the defect
    # pipeline and the dd makers and integrands
    import ttcross_tpu.apps.stdnorm as jstdnorm
    import ttcross_tpu.cross.defect as jdefect
    import ttcross_tpu.cross.engine_dd as jengine_dd
    import ttcross_tpu.ops.dd as jdd
    import ttcross_tpu_torch.apps.stdnorm as pstdnorm
    import ttcross_tpu_torch.cross.defect as pdefect
    import ttcross_tpu_torch.cross.engine_dd as pengine_dd
    import ttcross_tpu_torch.ops.dd as pdd

    dd_names = ["DD", "dd", "two_sum", "_quick_two_sum", "_split", "two_prod", "dd_add", "dd_neg",
                "dd_sub", "dd_abs", "dd_mul", "dd_div", "dd_sum", "dd_dot", "dd_matvec",
                "dd_matmul", "_dd_const", "dd_exp", "dd_log", "dd_to_float", "dd_from_string",
                "dd_to_string", "dd_gather_tt", "dd_contract"]
    for jmod, pmod, names in [
            (jdd, pdd, dd_names),
            (jengine_dd, pengine_dd, ["DDConfig", "DDState", "DDCrossResult", "DDKit",
                                      "get_dd_engine", "dd_quad_cores", "cross_dd"]),
            (jdefect, pdefect, ["cross_defect_corrected"]),
            (jising, pising, ["ising_c_integrand_dd", "make_ising_dd"]),
            (jstdnorm, pstdnorm, ["stdnorm_integrand_dd", "make_stdnorm_dd"])]:
        for name in names:
            assert getattr(pmod, name) is not None and hasattr(jmod, name), (pmod.__name__, name)
            assert name.startswith("_") or name in pmod.__all__, (pmod.__name__, name)
    for name in ("cross_dd", "cross_defect_corrected"):
        assert getattr(pcross, name) is getattr(pengine_dd if name == "cross_dd" else pdefect, name)
    for name in ("make_ising_dd", "make_stdnorm_dd", "ising_c_integrand_dd",
                 "stdnorm_integrand_dd"):
        assert name in papps.__all__
    for name in ("dd_pair_from_numpy", "dd_state_from_numpy"):
        assert name in interop.__all__
