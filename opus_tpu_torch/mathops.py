"""Scalar math helpers and bit-exact fixed-point approximations (a copy
of opus_tpu.mathops).

The ``bitexact_*`` functions feed the CELT bit allocator (theta
splitting) and must be integer-exact on every platform; the ``fast_*``
float helpers only shape audio.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

import math

import numpy as np


def ilog(x: int) -> int:
    """Minimum bits to store a positive integer; 0 for x <= 0
    (reference: math.rs:5-7)."""
    return x.bit_length() if x > 0 else 0


def _wrap_i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def frac_mul16(a: int, b: int) -> int:
    """Q15 multiply with round-to-nearest: (16384 + a*b) >> 15, as i16
    (reference: math.rs:71-75)."""
    return _wrap_i16((16384 + a * b) >> 15)


def bitexact_cos(x: int) -> int:
    """Bit-exact cos approximation on Q14 inputs (reference: math.rs:48-55).

    Drives the stereo theta -> (mid, side) gain split; must match libopus
    exactly because the result feeds integer bit allocation.
    """
    x2 = x * x
    y = _wrap_i16((x2 + 4096) >> 13)
    return _wrap_i16(
        1 + (32767 - y) + frac_mul16(y, -7651 + frac_mul16(y, 8277 + frac_mul16(-626, y)))
    )


def bitexact_log2tan(isin: int, icos: int) -> int:
    """Bit-exact log2(tan) in Q11 (reference: math.rs:57-69)."""
    ls = ilog(isin)
    lc = ilog(icos)
    icos = _wrap_i16(icos << (15 - lc))
    isin = _wrap_i16(isin << (15 - ls))
    a = frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
    b = frac_mul16(icos, frac_mul16(icos, -2597) + 7932)
    return (ls - lc) * (1 << 11) + a - b


# ---------------------------------------------------------------------------
# float32 helpers.  numpy scalars keep the arithmetic in true f32.
# ---------------------------------------------------------------------------

_LOG2_E = np.float32(math.log2(math.e))
_LN_2 = np.float32(math.log(2.0))
_HALF_PI = np.float32(math.pi / 2.0)


def fast_log2(x) -> np.float32:
    """log2 via ln (reference: math.rs:9-13)."""
    return np.float32(np.log(np.float32(x)) * _LOG2_E)


def fast_exp2(x) -> np.float32:
    """exp2 via exp (reference: math.rs:15-19)."""
    return np.float32(np.exp(np.float32(x) * _LN_2))


def fast_atan2(y, x) -> np.float32:
    """Polynomial atan2 approximation (reference: math.rs:21-46)."""
    a = np.float32(0.43157974)
    b = np.float32(0.67848403)
    c = np.float32(0.08595542)
    x = np.float32(x)
    y = np.float32(y)
    x2 = x * x
    y2 = y * y
    # For very small values the answer doesn't matter; avoid 0/0.
    if float(x2 + y2) < 1e-18:
        return np.float32(0.0)
    if x2 < y2:
        den = (y2 + b * x2) * (y2 + c * x2)
        return np.float32(-x * y * (y2 + a * x2) / den + (-_HALF_PI if y < 0.0 else _HALF_PI))
    den = (x2 + b * y2) * (x2 + c * y2)
    return np.float32(
        x * y * (x2 + a * y2) / den
        + (-_HALF_PI if y < 0.0 else _HALF_PI)
        - (-_HALF_PI if x * y < 0.0 else _HALF_PI)
    )


def celt_udiv(n: int, d: int) -> int:
    """Unsigned integer division (libopus celt_udiv semantics)."""
    assert d > 0
    return n // d


def celt_sudiv(n: int, d: int) -> int:
    """Signed integer division truncating toward zero (C semantics)."""
    assert d > 0
    q = abs(n) // d
    return -q if n < 0 else q
