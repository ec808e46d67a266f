"""CELT inverse MDCT on the host (a copy of opus_tpu.celt.mdct), built
from the transform's definition with the low-overlap window.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import numpy as np

from .modes import OVERLAP, WINDOW

_TWIST_CACHE: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def _twists(n2: int):
    """Phase twist vectors for the FFT-based evaluation."""
    if n2 not in _TWIST_CACHE:
        n = 2 * n2
        t0 = 0.5 + n / 4.0
        k = np.arange(n2, dtype=np.float64)
        spec_twist = np.exp(2j * np.pi * k * t0 / n)
        t = np.arange(n, dtype=np.float64)
        time_twist = np.exp(1j * np.pi * (t + t0) / n)
        fwd_twist = np.exp(-2j * np.pi * t0 * (k + 0.5) / n)
        _TWIST_CACHE[n2] = (spec_twist, time_twist, fwd_twist)
    return _TWIST_CACHE[n2]


def imdct_full(spec: np.ndarray) -> np.ndarray:
    """Plain (unwindowed) synthesis: N2 lines -> N=2*N2 time samples."""
    n2 = spec.shape[0]
    n = 2 * n2
    spec_twist, time_twist, _ = _twists(n2)
    y = np.zeros(n, dtype=np.complex128)
    y[:n2] = spec.astype(np.float64) * spec_twist
    g = np.fft.ifft(y) * n
    return (time_twist * g).real


def mdct_backward(spec: np.ndarray, out: np.ndarray, window: np.ndarray = WINDOW, overlap: int = OVERLAP) -> None:
    """Inverse MDCT of one block with TDAC into ``out`` (in place).

    out[0:overlap] must hold the previous block's unwound tail; on return
    out[0:N2+overlap] holds the block's contribution at libopus layout.
    """
    n2 = spec.shape[0]
    half_ov = overlap >> 1
    u = imdct_full(spec)
    # Middle of the low-overlap support: u[N2/2 + j].
    out[half_ov : half_ov + n2] = u[n2 // 2 : n2 // 2 + n2]
    # TDAC fold of the leading overlap against the previous tail, using
    # u's antisymmetry (u at support pos i == -u at pos ov-1-i).
    w_lo = window[:half_ov].astype(np.float64)
    w_hi = window[overlap - 1 : half_ov - 1 : -1].astype(np.float64)  # w[ov-1-i]
    prev = out[:half_ov].copy()
    new_mirror = out[overlap - 1 : half_ov - 1 : -1].copy()
    out[:half_ov] = w_hi * prev - w_lo * new_mirror
    out[overlap - 1 : half_ov - 1 : -1] = w_hi * new_mirror + w_lo * prev
