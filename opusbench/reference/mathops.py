"""Scalar math helpers and bit-exact fixed-point approximations (a copy
of opus_tpu.mathops).

The ``bitexact_*`` functions feed the CELT bit allocator (theta
splitting) and must be integer-exact on every platform.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import math


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


def celt_sudiv(n: int, d: int) -> int:
    """Signed integer division truncating toward zero (C semantics)."""
    assert d > 0
    q = abs(n) // d
    return -q if n < 0 else q
