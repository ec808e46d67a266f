"""The port's post-filter against the reference's.

`_postfilter_ref` (plain torch) is held to the JAX `_postfilter` and, on
two cases, to the Pallas kernel in interpret mode, on the cases of
tests/test_pallas_pf.py: every (lm, chunk) class, zero-gain streams,
same-filter streams and zero-gain streams with garbage lags.  The
chunked comb recurrence has one solution for any chunk <= min active
lag - 2, so the versions agree to float reassociation noise: the gate is
the reference's own, max abs error below 1e-6 of the output's scale.

The CUDA kernel has no CPU mode and chooses each row's chunk itself.
Here, `_postfilter_ref` at chunks 60-240 is held to the JAX version at
chunk 12 where every active lag allows it (the sum per sample does not
depend on the chunk), and a numpy model of the kernel's algorithm
(per-row chunk, zero-gain filters skipped, equal pairs) is held to the
JAX version on mixed rows.  The kernel's cases are marked `cuda` and
skip here.
"""

import functools

import numpy as np
import pytest
import torch

from opus_tpu_torch.dsp.postfilter import _postfilter_ref, postfilter

W = 2048  # DECODE_BUFFER_SIZE: the row is history then frame
CASES = [(3, 12), (3, 120), (3, 240), (2, 60), (1, 12), (0, 12), (0, 240)]


def _inputs(lm, chunk, seed, garbage_lags=False, B=8, C=2):
    """y, periods, gains, tapsets as in tests/test_pallas_pf.py, at B=8:
    rows 0-1 zero-gain (with garbage lags if asked), rows 2-3 same-filter."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, W)).astype(np.float32) * 1000.0
    periods = rng.integers(max(15, chunk + 2), 1025, (B, 3)).astype(np.int32)
    gains = (rng.integers(0, 5, (B, 3)) * 0.09375).astype(np.float32)
    gains[:2] = 0.0
    if garbage_lags:
        periods[:2] = rng.integers(-5, 5000, (2, 3))
    periods[2:4, 1] = periods[2:4, 0]
    gains[2:4, 1] = gains[2:4, 0]
    tapsets = rng.integers(0, 3, (B, 3)).astype(np.int32)
    return y, periods, gains, tapsets


def _torch_ref(lm, chunk, y, periods, gains, tapsets):
    n = 120 << lm
    out = _postfilter_ref(torch.tensor(y), W - n, n, lm, torch.tensor(periods),
                          torch.tensor(gains), torch.tensor(tapsets), chunk)
    return out.numpy()


def _rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("lm,chunk", CASES)
def test_postfilter_ref_matches_jax(lm, chunk, garbage):
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import _postfilter

    args = _inputs(lm, chunk, 3 + lm * 10 + chunk, garbage_lags=garbage)
    y, periods, gains, tapsets = args
    n = 120 << lm
    ref = np.asarray(_postfilter(jnp.asarray(y), W - n, n, lm, jnp.asarray(periods),
                                 jnp.asarray(gains), jnp.asarray(tapsets), chunk))
    assert _rel_err(_torch_ref(lm, chunk, *args), ref) < 1e-6


@pytest.mark.parametrize("lm,chunk", [(3, 12), (0, 240)])
def test_postfilter_ref_matches_pallas_interpret(lm, chunk):
    import jax.numpy as jnp

    from opus_tpu.dsp.pallas_pf import pallas_postfilter

    args = _inputs(lm, chunk, 77 + lm, garbage_lags=True)
    y, periods, gains, tapsets = args
    n = 120 << lm
    ref = np.asarray(pallas_postfilter(jnp.asarray(y), W - n, n, lm, jnp.asarray(periods),
                                       jnp.asarray(gains), jnp.asarray(tapsets), chunk,
                                       interpret=True))
    assert _rel_err(_torch_ref(lm, chunk, *args), ref) < 1e-6


def test_wrapper_on_cpu_runs_plain_version_in_place():
    y, periods, gains, tapsets = (torch.tensor(a) for a in _inputs(3, 60, 9))
    want = _postfilter_ref(y.clone(), 1088, 960, 3, periods, gains, tapsets, 60)
    before = postfilter.launches
    got = postfilter(y, 1088, 960, 3, periods, gains, tapsets, 60)
    assert got is y and torch.equal(y, want)
    assert postfilter.launches == before  # only a kernel launch counts


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y, periods, gains, tapsets = (torch.tensor(a) for a in _inputs(3, 12, 4))
    bad = [
        dict(y=y.double()),
        dict(y=y.transpose(0, 1)),
        dict(chunk=24),
        dict(n=480),
        dict(periods=periods[:4]),
        dict(periods=periods.float()),
        dict(gains=gains.double()),
        dict(tapsets=tapsets[:, :2]),
    ]
    for kw in bad:
        args = dict(y=y, hist=1088, n=960, lm=3, periods=periods, gains=gains,
                    tapsets=tapsets, chunk=12)
        args.update(kw)
        with pytest.raises(ValueError):
            postfilter(**args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the post-filter kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lm,chunk", CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, lm, chunk):
    """Kernel vs `_postfilter_ref` on the card, B=1024 stereo, rel < 1e-6."""
    n = 120 << lm
    y, periods, gains, tapsets = (torch.tensor(a, device=cuda_device) for a in
                                  _inputs(lm, chunk, 11 + lm, garbage_lags=True, B=1024))
    ref = _postfilter_ref(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
    before = postfilter.launches
    got = postfilter(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
    torch.cuda.synchronize()
    assert postfilter.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@functools.lru_cache(maxsize=None)
def _jax_postfilter(lm, chunk, seed, garbage):
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import _postfilter

    y, periods, gains, tapsets = _inputs(lm, 240, seed, garbage_lags=garbage)
    n = 120 << lm
    return np.asarray(_postfilter(jnp.asarray(y), W - n, n, lm, jnp.asarray(periods),
                                  jnp.asarray(gains), jnp.asarray(tapsets), chunk))


@pytest.mark.parametrize("chunk", [60, 120, 240])
@pytest.mark.parametrize("lm", [3, 2])
def test_postfilter_ref_is_chunk_independent(lm, chunk):
    """Active lags all >= 242: the port's plain version at `chunk` equals
    the JAX version at chunk 12, the premise of the kernel's per-row
    chunk."""
    args = _inputs(lm, 240, 50 + lm, garbage_lags=True)
    assert int(args[1][args[2] != 0].min()) >= 242
    want = _jax_postfilter(lm, 12, 50 + lm, True)
    assert _rel_err(_torch_ref(lm, chunk, *args), want) < 1e-6


def _mixed_inputs(B, seed, C=2):
    """y, periods, gains, tapsets over eight stream kinds, cycled: all
    lags 15; all lags 1024; lags 15, 1024, 300; zero gains with garbage
    lags -5, 5000, 3; a zero-gain filter with a garbage lag beside active
    lag-20 filters; equal pairs; every tapset; random."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, W)).astype(np.float32) * 1000.0
    periods = rng.integers(15, 1025, (B, 3)).astype(np.int32)
    gains = (rng.integers(1, 5, (B, 3)) * 0.09375).astype(np.float32)
    tapsets = rng.integers(0, 3, (B, 3)).astype(np.int32)
    kind = np.arange(B) % 8
    periods[kind == 0] = 15
    periods[kind == 1] = 1024
    periods[kind == 2] = (15, 1024, 300)
    periods[kind == 3] = (-5, 5000, 3)
    gains[kind == 3] = 0.0
    periods[kind == 4] = (5000, 20, 20)
    gains[kind == 4, 0] = 0.0
    periods[kind == 5] = 400
    gains[kind == 5] = 0.1875
    tapsets[kind == 5] = 1
    tapsets[kind == 6] = (0, 1, 2)
    return y, periods, gains, tapsets


def _kernel_model(y, hist, n, lm, periods, gains, tapsets):
    """numpy model of csrc/postfilter.cu, float32: per row, the chunk is
    its shortest active lag - 2 (up to 256); zero-gain filters add
    nothing and are not read; a row with no active filter is left as is;
    an equal pair of filters cross-fades to the second alone."""
    from opus_tpu_torch.dsp.tables import _tap_gains, _window_sq

    w2, tbl = _window_sq(), _tap_gains()
    y = y.copy()
    nf = 2 if lm == 0 else 3
    for b in range(y.shape[0]):
        lag = np.clip(periods[b], 15, 1024)
        act = [f < nf and gains[b, f] != 0 for f in range(3)]
        if not any(act):
            continue
        taps = tbl[np.clip(tapsets[b], 0, 2)] * gains[b][:, None]
        same = [gains[b, f] == gains[b, f + 1] and periods[b, f] == periods[b, f + 1]
                and tapsets[b, f] == tapsets[b, f + 1] for f in (0, 1)]
        chunk = min(min(int(lag[f]) for f in range(3) if act[f]) - 2, 256)
        for row in y[b]:
            for i0 in range(hist, hist + n, chunk):
                i = np.arange(i0, min(i0 + chunk, hist + n))
                j = i - hist

                def comb(f):
                    if not act[f]:
                        return np.float32(0.0)
                    q = i - lag[f]
                    return (taps[f, 0] * row[q] + taps[f, 1] * (row[q - 1] + row[q + 1])
                            + taps[f, 2] * (row[q - 2] + row[q + 2]))

                wh = [np.float32(1.0) if same[f] else w2[np.clip(j - 120 * f, 0, 119)]
                      for f in (0, 1)]
                a = np.where(j < 120, (1 - wh[0]) * comb(0) + wh[0] * comb(1),
                             np.where(j < 240, (1 - wh[1]) * comb(1) + wh[1] * comb(2),
                                      comb(2)))
                row[i] += a
    return y


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_kernel_model_matches_jax(lm):
    """The kernel's algorithm on mixed rows against the JAX version at
    chunk 12, and against the port's plain version."""
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import _postfilter

    y, periods, gains, tapsets = _mixed_inputs(16, 60 + lm)
    n = 120 << lm
    want = np.asarray(_postfilter(jnp.asarray(y), W - n, n, lm, jnp.asarray(periods),
                                  jnp.asarray(gains), jnp.asarray(tapsets), 12))
    got = _kernel_model(y, W - n, n, lm, periods, gains, tapsets)
    assert _rel_err(got, want) < 1e-6
    assert _rel_err(_torch_ref(lm, 12, y, periods, gains, tapsets), want) < 1e-6
    np.testing.assert_array_equal(got[3::8], y[3::8])  # no active filter: untouched


def _meta_views(periods, gains, tapsets, device):
    """periods and tapsets as the serving core passes them: int32 views
    meta[:, 6:9] and meta[:, 9:12] of a [B, 16] plane; gains a view of
    the slot's words too."""
    B = periods.shape[0]
    meta = torch.zeros(B, 16, dtype=torch.int32, device=device)
    meta[:, 6:9] = torch.from_numpy(periods)
    meta[:, 9:12] = torch.from_numpy(tapsets)
    words = torch.zeros(B, 4, dtype=torch.float32, device=device)
    words[:, 1:] = torch.from_numpy(gains)
    return meta[:, 6:9], words[:, 1:], meta[:, 9:12]


@pytest.mark.cuda
@pytest.mark.parametrize("lm", [3, 2, 1, 0])
def test_kernel_on_mixed_rows_and_meta_views_on_card(cuda_device, lm):
    """Kernel vs `_postfilter_ref` on the card, B=1024 stereo of the
    mixed stream kinds, parameters as strided views: rel < 1e-6, and the
    rows with no active filter unchanged."""
    n = 120 << lm
    y, periods, gains, tapsets = _mixed_inputs(1024, 70 + lm)
    y = torch.from_numpy(y).to(cuda_device)
    views = _meta_views(periods, gains, tapsets, cuda_device)
    ref = _postfilter_ref(y.clone(), W - n, n, lm, *views, 12)
    got = postfilter(y.clone(), W - n, n, lm, *views, 12)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6
    assert torch.equal(got[3::8], y[3::8])


@pytest.mark.cuda
def test_kernel_scalar_path_on_card(cuda_device):
    """A row of 2046 with the frame at 1086: the 16-byte path does not
    apply, the scalar one must give the same."""
    w, lm, n = 2046, 3, 960
    y, periods, gains, tapsets = _mixed_inputs(64, 80)
    y = torch.from_numpy(np.ascontiguousarray(y[..., :w])).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (periods, gains, tapsets)]
    ref = _postfilter_ref(y.clone(), w - n, n, lm, *args, 12)
    got = postfilter(y.clone(), w - n, n, lm, *args, 12)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.cuda
def test_wrapper_issues_one_launch_on_card(cuda_device):
    """After the first call (build, load, WINDOW^2 upload), a call is one
    device kernel: no prep op, no copy; int64 parameters are refused."""
    y, periods, gains, tapsets = _mixed_inputs(256, 90)
    y = torch.from_numpy(y).to(cuda_device)
    views = _meta_views(periods, gains, tapsets, cuda_device)
    postfilter(y, 1088, 960, 3, *views, 12)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        postfilter(y, 1088, 960, 3, *views, 12)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in device) == 1 and "postfilter_kernel" in device[0].key
    with pytest.raises(ValueError):
        postfilter(y, 1088, 960, 3, views[0].long(), views[1], views[2], 12)
