"""PVQ band-shape decoding (a copy of opus_tpu.celt.vq): pulses to unit
vectors, the spreading rotation and renormalisation, in float64 numpy
with float32 outputs.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import math

import numpy as np

from .cwrs import decode_pulses

SPREAD_NONE = 0
SPREAD_LIGHT = 1
SPREAD_NORMAL = 2
SPREAD_AGGRESSIVE = 3

_SPREAD_FACTOR = (15, 10, 5)
EPSILON = 1e-15


def _exp_rotation1(x: np.ndarray, length: int, stride: int, c: float, s: float) -> None:
    """One pass of the Givens-rotation network used for spreading."""
    ms = -s
    for i in range(length - stride):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2


def exp_rotation(x: np.ndarray, length: int, direction: int, stride: int, k: int, spread: int) -> None:
    """Spreading rotation (direction=-1 decodes/undoes, +1 encodes)."""
    if 2 * k >= length or spread == SPREAD_NONE:
        return
    factor = _SPREAD_FACTOR[spread - 1]
    gain = length / (length + factor * k)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))  # == sin(pi/2 * theta)

    stride2 = 0
    if length >= 8 * stride:
        # sqrt(len/stride) with rounding, computed incrementally.
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1

    length //= stride
    for i in range(stride):
        seg = x[i * length : (i + 1) * length]
        if direction < 0:
            if stride2:
                _exp_rotation1(seg, length, stride2, s, c)
            _exp_rotation1(seg, length, 1, c, s)
        else:
            _exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                _exp_rotation1(seg, length, stride2, s, -c)


def extract_collapse_mask(iy: np.ndarray, n: int, b: int) -> int:
    """Which of the B interleaved short blocks received any pulse."""
    if b <= 1:
        return 1
    n0 = n // b
    mask = 0
    for i in range(b):
        if np.any(iy[i * n0 : (i + 1) * n0]):
            mask |= 1 << i
    return mask


def normalise_residual(iy: np.ndarray, x: np.ndarray, n: int, ryy: int, gain: float) -> None:
    g = gain / math.sqrt(ryy)
    x[:n] = (g * iy[:n]).astype(x.dtype)


def renormalise_vector(x: np.ndarray, n: int, gain: float) -> None:
    e = EPSILON + float(np.sum(x[:n].astype(np.float64) ** 2))
    g = gain / math.sqrt(e)
    x[:n] = (g * x[:n]).astype(x.dtype)


def alg_unquant(x: np.ndarray, n: int, k: int, spread: int, b: int, dec, gain: float) -> int:
    """Decode one PVQ shape into x[:n]; returns the collapse mask."""
    assert k > 0 and n > 1
    iy, ryy = decode_pulses(dec, n, k)
    normalise_residual(iy, x, n, ryy, gain)
    exp_rotation(x, n, -1, b, k, spread)
    return extract_collapse_mask(iy, n, b)
