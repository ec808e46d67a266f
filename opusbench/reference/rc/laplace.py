"""Laplace-distributed symbols over the range coder (a copy of
opus_tpu.rc.laplace): the CELT coarse-energy residuals.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

from .decoder import RangeDecoder

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
