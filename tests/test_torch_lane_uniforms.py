"""The lottery uniforms of a lane family (ops/kernels.py::lane_uniforms).

On a CUDA device one MT19937 kernel draws every lane's stream
(csrc/kernels.cu::lane_mt19937_kernel); on the CPU each lane draws from its
own torch.Generator.  Here the kernel's arithmetic, lane_uniforms_emulated,
is held bit for bit to the stacked host draws, and cross_batch on the CPU
to the host path (tests/test_torch_cuda.py holds the kernel itself)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from ttcross_tpu_torch.apps import make_mvn_family
from ttcross_tpu_torch.cross import cross_batch, lane_key
from ttcross_tpu_torch.cross.batch import _cross_batch
from ttcross_tpu_torch.cross.engine import draw_uniforms
from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.utils import reset_spans, spans

# keys at the edges of the 32 bits a generator keeps, and real lane keys
KEY_SETS = {"L1": [2**62 + 987654321],
            "L3": [0, 1, 2**32 - 1],
            "L17": [2**32 + 5] + [lane_key(11, lane) for lane in range(16)]}
# (d, nlot): odd row lengths put pairs of words across the layout's rows
SHAPES = [(2, 6), (6, 170), (4, 7)]
D, N, L, R = 4, 17, 3, 6          # the small MVN family of the cross_batch tests


def _stacked(keys, sweeps, d, nlot):
    return torch.stack([draw_uniforms(k, sweeps, d, nlot) for k in keys], dim=1)


@pytest.mark.parametrize("d,nlot", SHAPES)
@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("keys", list(KEY_SETS), ids=list(KEY_SETS))
def test_emulation_is_the_host_draws_bit_for_bit(keys, sweeps, d, nlot):
    keys = KEY_SETS[keys]
    got = K.lane_uniforms_emulated(keys, sweeps, d, nlot)
    want = _stacked(keys, sweeps, d, nlot)
    assert got.shape == want.shape == (sweeps, len(keys), d - 1, 2, nlot)
    assert got.dtype == torch.float64 and torch.equal(got, want)


def test_emulation_crosses_twists_and_keeps_the_low_32_bits():
    # 19 sweeps of mvn_d6 are 32,300 doubles a lane: 104 twists, the last one
    # used in part; a key and the key plus 2^32 seed the same stream
    keys = [7, 7 + 2**32, lane_key(0, 1023)]
    got = K.lane_uniforms_emulated(keys, 19, 6, 170)
    assert torch.equal(got, _stacked(keys, 19, 6, 170))
    assert torch.equal(got[:, 0], got[:, 1]) and not torch.equal(got[:, 0], got[:, 2])


def test_on_the_cpu_the_wrapper_is_the_plain_path_and_launches_nothing():
    K.reset_launch_counts()
    keys = KEY_SETS["L3"]
    got = K.lane_uniforms(keys, 2, 4, 7, "cpu")
    assert torch.equal(got, K.lane_uniforms_plain(keys, 2, 4, 7))
    assert torch.equal(got, _stacked(keys, 2, 4, 7))
    assert K.lane_uniforms(keys, 0, 4, 7, torch.device("cpu")).shape == (1, 3, 3, 2, 7)
    assert K.lane_uniforms.launches == 0 and K.launch_shapes()["lane_uniforms"] == {}


@pytest.mark.parametrize("keys,d,nlot", [([], 4, 7), ([1], 1, 7), ([1], 4, 0)])
def test_the_wrapper_refuses_what_has_no_uniforms(keys, d, nlot):
    for fn in (K.lane_uniforms_plain, K.lane_uniforms_emulated):
        with pytest.raises(ValueError):
            fn(keys, 2, d, nlot)


def _family():
    fam = make_mvn_family(d=D, n=N, corrs=np.linspace(0.2, 0.6, L), device="cpu")
    kw = dict(max_rank=R, key=3, pivoting=1, accuracy=500 * 2.2e-16,
              quad=[fam.quad_weights] * D, truth=1.0, device="cpu")
    return fam, kw


def _uniforms_span(fn):
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    recs = spans()
    up = [r for r in recs if r.name == "entry.uniforms"]
    assert len(up) == 1
    below = [r for r in recs if r.parent is not None and recs[r.parent] is up[0]]
    assert [r.name for r in below] == ["entry.upload"]
    return out, up[0].attrs, below[0].attrs


@pytest.mark.parametrize("mode", ["sequential", "jacobi"])
def test_cross_batch_on_the_cpu_draws_on_the_host(mode):
    """cross_batch on the CPU draws each lane's uniforms on the host
    (drawn="host", no launch, the whole block under entry.upload), and
    the same family fed lane_uniforms_emulated's draws is the same run."""
    fam, kw = _family()
    K.reset_launch_counts()
    res, attrs, upload = _uniforms_span(
        lambda: cross_batch(fam.fun, [fam.n] * D, fam.params, sweep_mode=mode, **kw))
    assert attrs == {"drawn": "host"} and K.lane_uniforms.launches == 0
    assert upload == {"bytes": (R - 1) * L * (D - 1) * 2 * 2 * (R + N) * 8}
    U = K.lane_uniforms_emulated([lane_key(3, lane) for lane in range(L)], R - 1, D, 2 * (R + N))
    base = dict(dtype=torch.float64, verbose=False, max_sweeps=None, small_element=None,
                small_pivot=None, sweep_mode=mode, mesh=None)
    fed, attrs, _ = _uniforms_span(
        lambda: _cross_batch(fam.fun, [fam.n] * D, fam.params, uniforms=U, **base, **kw))
    assert attrs == {"drawn": "host"} and fed.neval == res.neval > 0
    for a, b in zip(fed.lanes, res.lanes):
        assert a.values == b.values and a.ranks == b.ranks and a.neval == b.neval
        assert np.array_equal(a.state.vip, b.state.vip)
