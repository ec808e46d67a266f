"""Constant builders of the plan executor.

Each function or table named after one in `opus_tpu.dsp.plan_exec` is a
copy of it and must stay bit-identical to it (tests/test_torch_tables.py
and tests/test_torch_plan_exec.py); they are copied rather than imported
because the port imports nothing of `opus_tpu`.  `_lcg_jump_table` is the
port's own: the LCG jump coefficients as one table instead of the
reference's double-and-add.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..celt import modes

NB = modes.NB_E_BANDS
EPSILON = 1e-15
_SPREAD_FACTOR = (15, 10, 5)


def f16_bits_to_f32(h: np.ndarray) -> np.ndarray:
    """uint16 IEEE half bits -> float32 (vectorised)."""
    h = h.astype(np.uint32)
    sign = (h >> 15) & 1
    exp = (h >> 10) & 0x1F
    man = h & 0x3FF
    # normal
    f = np.where(
        exp == 0,
        (man / 1024.0) * 2.0 ** (-14),
        (1.0 + man / 1024.0) * (2.0 ** (exp.astype(np.int32) - 15)),
    )
    f = np.where(exp == 31, np.inf, f)
    return np.where(sign == 1, -f, f).astype(np.float32)


def lcg(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def rotation_params(n: int, k: int, spread: int, bq: int):
    """(c, s, stride2, L) of the decode-side spreading rotation, or None
    when the rotation is a no-op (celt/vq.py exp_rotation)."""
    if 2 * k >= n or spread == 0:
        return None
    factor = _SPREAD_FACTOR[spread - 1]
    gain = float(n) / (n + factor * k)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if n >= 8 * bq:
        stride2 = 1
        while (stride2 * stride2 + stride2) * bq + (bq >> 2) < n:
            stride2 += 1
    return c, s, stride2, n // bq


# --- band transform matrices ------------------------------------------------

def _haar1_cols(x: np.ndarray, n0: int, stride: int) -> None:
    """haar1 on the leading axis of a [n, cols] array (bands.py haar1)."""
    n0 >>= 1
    c = 0.70710678
    for i in range(stride):
        idx = i + stride * 2 * np.arange(n0)
        a = c * x[idx]
        b = c * x[idx + stride]
        x[idx] = a + b
        x[idx + stride] = a - b


_ORDERY = {2: (1, 0), 4: (3, 0, 2, 1), 8: (7, 0, 4, 3, 6, 1, 5, 2),
           16: (15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5)}


def _deinterleave_cols(x, n0, stride, hadamard):
    n = n0 * stride
    tmp = np.empty_like(x[:n])
    if hadamard:
        o = _ORDERY[stride]
        for i in range(stride):
            tmp[o[i] * n0 : o[i] * n0 + n0] = x[i:n:stride]
    else:
        for i in range(stride):
            tmp[i * n0 : (i + 1) * n0] = x[i:n:stride]
    x[:n] = tmp


def _interleave_cols(x, n0, stride, hadamard):
    n = n0 * stride
    tmp = np.empty_like(x[:n])
    if hadamard:
        o = _ORDERY[stride]
        for i in range(stride):
            tmp[i:n:stride] = x[o[i] * n0 : o[i] * n0 + n0]
    else:
        for i in range(stride):
            tmp[i:n:stride] = x[i * n0 : (i + 1) * n0]
    x[:n] = tmp


@functools.lru_cache(maxsize=None)
def band_transforms(n: int, b_frame: int, recombine: int, time_divide: int,
                    longblocks: bool):
    """(T_fwd, T_undo) [n, n] f32 for one band config.

    T_undo maps the coded (deinterleaved) domain back to natural order
    (quant_band's resynth reshaping); T_fwd is the forward transform the
    fold source (lowband) receives before leaf filling.  Built by op
    replay on identity columns so float semantics match the reference.
    """
    eye = np.eye(n, dtype=np.float64)

    fwd = eye.copy()
    B = b_frame
    n_b = n // B
    for kk in range(recombine):
        _haar1_cols(fwd, n >> kk, 1 << kk)
    B >>= recombine
    n_b <<= recombine
    for _ in range(time_divide):
        _haar1_cols(fwd, n_b, B)
        B <<= 1
        n_b >>= 1
    b_final = B
    if b_final > 1:
        _deinterleave_cols(fwd, n_b >> recombine, b_final << recombine, longblocks)

    undo = eye.copy()
    if b_final > 1:
        _interleave_cols(undo, n_b >> recombine, b_final << recombine, longblocks)
    B2 = b_final
    n_b2 = n_b
    for _ in range(time_divide):
        B2 >>= 1
        n_b2 <<= 1
        _haar1_cols(undo, n_b2, B2)
    for kk in range(recombine):
        _haar1_cols(undo, n >> kk, 1 << kk)
    return fwd.astype(np.float32), undo.astype(np.float32)


#: Bound on LCG jump distances appearing in any leaf/anti-collapse replay.
_LCG_MAX = 1600


@functools.lru_cache(maxsize=None)
def _lcg_pow2() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(a_k, c_k) of the 2^k-step LCG jump, k = 0..10 (covers _LCG_MAX)."""
    a, c = 1664525, 1013904223
    aa, cc = [], []
    for _ in range(11):
        aa.append(a)
        cc.append(c)
        c = ((a + 1) * c) & 0xFFFFFFFF
        a = (a * a) & 0xFFFFFFFF
    return tuple(aa), tuple(cc)


@functools.lru_cache(maxsize=None)
def _lcg_jump_table() -> np.ndarray:
    """[2, _LCG_MAX] int64: (A_t, C_t) with seed_t = A_t * seed_0 + C_t
    (mod 2^32), composed from _lcg_pow2 by the reference's double-and-add
    (its `_lcg_jump_j`), so every entry is the same integer."""
    aa, cc = _lcg_pow2()
    t = np.arange(_LCG_MAX, dtype=np.int64)
    A = np.ones(_LCG_MAX, np.uint64)
    C = np.zeros(_LCG_MAX, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    for k in range(11):
        bit = ((t >> k) & 1) == 1
        A = np.where(bit, (np.uint64(aa[k]) * A) & m, A)
        C = np.where(bit, (np.uint64(aa[k]) * C + np.uint64(cc[k])) & m, C)
    return np.stack([A, C]).astype(np.int64)


#: Reachable (recombine, time_divide) pairs by longblocks, per lm, from
#: TF_SELECT_TABLE (celt_tables.h): long frames only shrink (td>0), short
#: frames recombine (rec>0) or shrink once.
_TF_CFGS = {
    0: {True: [(0, 0), (0, 1)], False: []},
    1: {True: [(0, 0), (0, 1), (0, 2)], False: [(0, 0), (1, 0), (0, 1)]},
    2: {True: [(0, 0), (0, 2), (0, 3)], False: [(0, 0), (1, 0), (2, 0), (0, 1)]},
    3: {True: [(0, 0), (0, 2), (0, 3)], False: [(0, 0), (1, 0), (3, 0), (0, 1)]},
}


def _valid_cfg(n: int, b_frame: int, rec: int, td: int) -> bool:
    if b_frame >> rec < 1:
        return False
    n_b = (n // b_frame) << rec
    for _ in range(td):
        if n_b & 1:
            return False
        n_b >>= 1
    return True


@functools.lru_cache(maxsize=None)
def _plan_band_of_bin(lm: int) -> np.ndarray:
    m = 1 << lm
    n = m * modes.SHORT_MDCT_SIZE
    widths = (modes.E_BANDS[1:] - modes.E_BANDS[:-1]).astype(np.int64) * m
    idx = np.repeat(np.arange(NB, dtype=np.int32), widths)
    # Bins above the top band never carry anti-collapse content; map them
    # to band 20 (they are masked by `has` anyway).
    return np.concatenate([idx, np.full(n - idx.size, NB - 1, np.int32)])
