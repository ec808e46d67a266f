"""Laplace-distributed symbols over the range coder (a copy of
opus_tpu.rc.laplace): the CELT coarse-energy residuals.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

from .decoder import RangeDecoder
from .encoder import RangeEncoder

#: log2 of the minimum probability of an energy delta (in 1/32768 units).
LOG_MINP = 0
MINP = 1 << LOG_MINP
#: Terms coded above which the distribution goes flat at MINP.
NMIN = 16
_FTOTAL = 32768


def laplace_freq1(fs0: int, decay: int) -> int:
    """Frequency of the first tail value (reference: mod.rs:114-117)."""
    ft = _FTOTAL - MINP * (2 * NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def encode_laplace(enc: RangeEncoder, value: int, fs: int, decay: int) -> int:
    """Encode ``value``; returns the (possibly magnitude-clamped) value
    actually coded, which the caller must feed back into its predictor."""
    fl = 0
    val = value
    if val != 0:
        s = -1 if val < 0 else 0
        val = (val + s) ^ s  # |val|
        fl = fs
        fs = laplace_freq1(fs, decay)
        # Walk the geometrically decaying part of the PDF.
        i = 1
        while fs > 0 and i < val:
            fs *= 2
            fl += fs + 2 * MINP
            fs = (fs * decay) >> 15
            i += 1
        if fs == 0:
            # Flat MINP tail; clamp the magnitude to what remains codable.
            ndi_max = (_FTOTAL - fl + MINP - 1) >> LOG_MINP
            ndi_max = (ndi_max - s) >> 1
            di = min(val - i, ndi_max - 1)
            fl += (2 * di + 1 + s) * MINP
            fs = min(MINP, _FTOTAL - fl)
            value = (i + di + s) ^ s
        else:
            fs += MINP
            if s == 0:
                fl += fs
        assert fl + fs <= _FTOTAL
        assert fs > 0
    enc.encode_bin(fl, fl + fs, 15)
    return value


def decode_laplace(dec: RangeDecoder, fs: int, decay: int) -> int:
    """Decode one Laplace-coded value (reference: decoder.rs:314-355)."""
    val = 0
    fl = 0
    fm = dec.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = laplace_freq1(fs, decay) + MINP
        # Walk the decaying part of the PDF.
        while fs > MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2 * MINP) * decay) >> 15
            fs += MINP
            val += 1
        # Flat MINP tail.
        if fs <= MINP:
            di = (fm - fl) >> (LOG_MINP + 1)
            val += di
            fl += 2 * di * MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, _FTOTAL), _FTOTAL)
    return val
