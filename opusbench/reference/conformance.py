"""The RFC 8251 quality metric, a copy of opus_tpu.conformance.

compare(reference, test) scores decoded PCM against a reference decode
on the opus_compare scale; PASS_QUALITY is the passing score.
chip_smoke.py and the port's tests grade decoders with it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

#: Comparison bands over the 240 x 100 Hz bins of a 480-point transform
#: at 48 kHz (opus_compare.c band layout; CELT band edges x2).
BANDS = np.array(
    [0, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 68, 80, 96, 120, 156, 200],
    np.int32,
)
NBANDS = len(BANDS) - 1
WIN = 480
STEP = 120

#: Conformance threshold: RFC 8251 accepts a decoder whose output scores
#: at least 90 on every test vector.
PASS_QUALITY = 90.0


def _band_energies(x: np.ndarray) -> np.ndarray:
    """[nframes, NBANDS] short-time band energies of a mono 48 kHz signal."""
    n = x.shape[0]
    nframes = max(0, (n - WIN) // STEP + 1)
    if nframes == 0:
        return np.zeros((0, NBANDS), np.float64)
    idx = np.arange(WIN)[None, :] + STEP * np.arange(nframes)[:, None]
    w = np.sin(np.pi / WIN * (np.arange(WIN) + 0.5))
    frames = x[idx] * w
    spec = np.fft.rfft(frames, axis=1)[:, :240]
    p = (spec.real**2 + spec.imag**2).astype(np.float64)
    out = np.empty((nframes, NBANDS), np.float64)
    for b in range(NBANDS):
        out[:, b] = p[:, BANDS[b] : BANDS[b + 1]].sum(axis=1)
    return out


def compare(ref: np.ndarray, test: np.ndarray, rate: int = 48000) -> float:
    """opus_compare-style quality score in [0, 100].

    ref/test: float PCM in [-1, 1], shape [n] or [n, channels], 48 kHz,
    time-aligned (Opus decoders are delay-free relative to each other).
    Stereo is scored per channel plus the mid signal; the worst governs.
    """
    assert rate == 48000, "comparison runs at 48 kHz like the reference tool"
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    if ref.ndim == 1:
        ref = ref[:, None]
    if test.ndim == 1:
        test = test[:, None]
    n = min(ref.shape[0], test.shape[0])
    ref, test = ref[:n], test[:n]
    channels = []
    for c in range(ref.shape[1]):
        channels.append((ref[:, c], test[:, c]))
    if ref.shape[1] == 2:
        channels.append((ref.mean(axis=1), test.mean(axis=1)))
    return min(_compare_mono(r, t) for r, t in channels)


def _compare_mono(ref: np.ndarray, test: np.ndarray) -> float:
    eb_r = _band_energies(ref)
    eb_t = _band_energies(test)
    if eb_r.shape[0] == 0:
        return 100.0
    # Pseudo-NMR: symmetric log energy ratio with an absolute floor so
    # silence compares as silence (the bias term in opus_compare).
    bias = 1e-8 * WIN  # ~ -75 dBFS band energy floor
    r = np.log((eb_r + bias) / (eb_t + bias))
    e = r * r
    # Per-band temporal smoothing over ~5 frames (the method tolerates
    # phase/reordering differences inside a window, not energy drift).
    k = 5
    if e.shape[0] >= k:
        csum = np.cumsum(e, axis=0)
        e = (csum[k - 1 :] - np.concatenate([np.zeros((1, NBANDS)), csum[:-k]], axis=0)) / k
    # 4th-power emphasis over frequency then time: rare large errors
    # dominate, matching the tool's intolerance of localised artifacts.
    ef = (np.mean(e**2, axis=1)) ** 0.5
    err = float(np.mean(ef**2) ** 0.5)
    return 100.0 * max(0.0, 1.0 - err / 0.5)
