"""CELT band decoding (a copy of opus_tpu.celt.bands): theta splitting,
folding, stereo, anti-collapse and denormalisation.  Its integer
decisions are part of the bitstream and must stay bit-exact.

Below this docstring the code is the reference's decode side: the
encoder's branches and helpers (theta analysis, intensity and mid/side
analysis, the PVQ search, band energies) are taken out, and every path
resynthesises, as a decoder does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..mathops import bitexact_cos, bitexact_log2tan, celt_sudiv, frac_mul16
from . import modes
from .rate import BITRES, bits2pulses, pulses2bits
from .cwrs import get_pulses
from .vq import (
    SPREAD_AGGRESSIVE,
    alg_unquant,
    renormalise_vector,
)

QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
NORM_SCALING = 1.0

#: Natural -> "ordery" Hadamard permutations for strides 2/4/8/16.
_ORDERY = {
    2: (1, 0),
    4: (3, 0, 2, 1),
    8: (7, 0, 4, 3, 6, 1, 5, 2),
    16: (15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5),
}

_BIT_INTERLEAVE = (0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3)
_BIT_DEINTERLEAVE = (
    0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
    0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF,
)

_EXP2_TABLE8 = (16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048)


def celt_lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def celt_exp2(x: float) -> float:
    return math.exp(0.6931471805599453094 * float(x))


def haar1(x: np.ndarray, n0: int, stride: int) -> None:
    """Orthonormal 2-point Haar butterflies across interleaved blocks."""
    n0 >>= 1
    c = 0.70710678
    for i in range(stride):
        idx = i + stride * 2 * np.arange(n0)
        a = c * x[idx]
        b = c * x[idx + stride]
        x[idx] = a + b
        x[idx + stride] = a - b


def deinterleave_hadamard(x: np.ndarray, n0: int, stride: int, hadamard: bool) -> None:
    n = n0 * stride
    tmp = np.empty(n, dtype=x.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[ordery[i] * n0 : ordery[i] * n0 + n0] = x[i:n:stride]
    else:
        for i in range(stride):
            tmp[i * n0 : (i + 1) * n0] = x[i:n:stride]
    x[:n] = tmp


def interleave_hadamard(x: np.ndarray, n0: int, stride: int, hadamard: bool) -> None:
    n = n0 * stride
    tmp = np.empty(n, dtype=x.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[i:n:stride] = x[ordery[i] * n0 : ordery[i] * n0 + n0]
    else:
        for i in range(stride):
            tmp[i:n:stride] = x[i * n0 : (i + 1) * n0]
    x[:n] = tmp


def compute_qn(n: int, b: int, offset: int, pulse_cap: int, stereo: bool) -> int:
    """Resolution of the theta split parameter."""
    n2 = 2 * n - 1
    if stereo and n == 2:
        n2 -= 1
    qb = celt_sudiv(b + n2 * offset, n2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = _EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> BITRES))
    qn = ((qn + 1) >> 1) << 1
    assert qn <= 256
    return qn


def stereo_merge(x: np.ndarray, y: np.ndarray, mid: float, n: int) -> None:
    """Decoder: mid/side -> left/right with unit-norm gains."""
    xp = float(np.dot(y[:n].astype(np.float64), x[:n].astype(np.float64)))
    side = float(np.dot(y[:n].astype(np.float64), y[:n].astype(np.float64)))
    xp *= mid
    el = mid * mid + side - 2 * xp
    er = mid * mid + side + 2 * xp
    if er < 6e-4 or el < 6e-4:
        y[:n] = x[:n]
        return
    lgain = 1.0 / math.sqrt(el)
    rgain = 1.0 / math.sqrt(er)
    for j in range(n):
        l = mid * x[j]
        r = y[j]
        x[j] = lgain * (l - r)
        y[j] = rgain * (l + r)


@dataclasses.dataclass
class BandCtx:
    band: int
    intensity: int
    spread: int
    tf_change: int
    ec: object
    remaining_bits: int
    seed: int
    disable_inv: bool = False


@dataclasses.dataclass
class SplitCtx:
    inv: bool = False
    imid: int = 0
    iside: int = 0
    delta: int = 0
    itheta: int = 0
    qalloc: int = 0


def compute_theta(
    ctx: BandCtx, sctx: SplitCtx, x, y, n: int, b: int, B: int, B0: int,
    lm: int, stereo: bool, fill: int,
) -> tuple[int, int]:
    """Code/decode the mid/side (or lower/upper) angle; returns
    (b_remaining, fill)."""
    ec = ctx.ec
    band = ctx.band
    pulse_cap = int(modes.LOG_N[band]) + lm * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE if (stereo and n == 2) else QTHETA_OFFSET)
    qn = compute_qn(n, b, offset, pulse_cap, stereo)
    if stereo and band >= ctx.intensity:
        qn = 1
    itheta = 0
    inv = False
    tell = ec.tell_frac()
    if qn != 1:
        # Decode the angle: step pdf for stereo, uniform for time splits,
        # triangular otherwise.
        if stereo and n > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fs = ec.decode(ft)
            if fs < (x0 + 1) * p0:
                t = fs // p0
            else:
                t = x0 + 1 + (fs - (x0 + 1) * p0)
            fl = p0 * t if t <= x0 else (t - 1 - x0) + (x0 + 1) * p0
            fh = p0 * (t + 1) if t <= x0 else (t - x0) + (x0 + 1) * p0
            ec.update(fl, fh, ft)
            itheta = t
        elif B0 > 1 or stereo:
            itheta = ec.decode_uint(qn + 1)
        else:
            # Triangular pdf.
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            fm = ec.decode(ft)
            if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                itheta = (math.isqrt(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                itheta = (2 * (qn + 1) - math.isqrt(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            ec.update(fl, fl + fs, ft)
        assert itheta >= 0
        itheta = (itheta * 16384) // qn
    elif stereo:
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = ec.decode_bit_logp(2)
        else:
            inv = False
        if ctx.disable_inv:
            inv = False
        itheta = 0
    qalloc = ec.tell_frac() - tell
    b -= qalloc

    if itheta == 0:
        imid, iside = 32767, 0
        fill &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid, iside = 0, 32767
        fill &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        # Mid/side allocation minimising squared error for this band.
        delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid))

    sctx.inv = inv
    sctx.imid = imid
    sctx.iside = iside
    sctx.delta = delta
    sctx.itheta = itheta
    sctx.qalloc = qalloc
    return b, fill


def quant_band_n1(ctx: BandCtx, x, y, b: int, lowband_out) -> int:
    """1-sample bands: just a sign bit per channel."""
    stereo = y is not None
    vec = x
    for _ in range(1 + (1 if stereo else 0)):
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = ctx.ec.decode_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        vec[0] = -NORM_SCALING if sign else NORM_SCALING
        vec = y
    if lowband_out is not None:
        lowband_out[0] = x[0]
    return 1


def quant_partition(
    ctx: BandCtx, x: np.ndarray, n: int, b: int, B: int, lowband, lm: int,
    gain: float, fill: int,
) -> int:
    """Recursively split-and-code one partition of a band."""
    band = ctx.band
    B0 = B
    cache_off = int(modes.CACHE_INDEX[lm + 1][band])
    cache = modes.CACHE_BITS
    # Needing ~1.5 bits more than the codebook can produce? Split in two.
    if lm != -1 and b > int(cache[cache_off + int(cache[cache_off])]) + 12 and n > 2:
        n >>= 1
        y = x[n:]
        lm -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1

        sctx = SplitCtx()
        b, fill = compute_theta(ctx, sctx, x, y, n, b, B, B0, lm, False, fill)
        imid, iside = sctx.imid, sctx.iside
        delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
        mid = imid / 32768.0
        side = iside / 32768.0

        # Give more bits to low-energy MDCTs than they'd otherwise get.
        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                # Rough pre-echo masking approximation.
                delta -= delta >> (4 - lm)
            else:
                # Forward-masking slope of 1.5 dB per 10 ms.
                delta = min(0, delta + (n << BITRES >> (5 - lm)))
        mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc

        next_lowband2 = lowband[n:] if lowband is not None else None
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(ctx, x, n, mbits, B, lowband, lm, gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, y, n, sbits, B, next_lowband2, lm, gain * side, fill >> B) << (B0 >> 1)
        else:
            cm = quant_partition(ctx, y, n, sbits, B, next_lowband2, lm, gain * side, fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, x, n, mbits, B, lowband, lm, gain * mid, fill)
        return cm

    # Leaf: code this partition with PVQ (or fold/noise if no pulses).
    q = bits2pulses(band, lm, b)
    curr_bits = pulses2bits(band, lm, q)
    ctx.remaining_bits -= curr_bits
    while ctx.remaining_bits < 0 and q > 0:
        ctx.remaining_bits += curr_bits
        q -= 1
        curr_bits = pulses2bits(band, lm, q)
        ctx.remaining_bits -= curr_bits

    if q != 0:
        k = get_pulses(q)
        return alg_unquant(x, n, k, ctx.spread, B, ctx.ec, gain)

    cm = 0
    cm_mask = (1 << B) - 1
    fill &= cm_mask
    if not fill:
        x[:n] = 0.0
    else:
        if lowband is None:
            # Noise-fill from the LCG.
            for j in range(n):
                ctx.seed = celt_lcg_rand(ctx.seed)
                # Top bits as a signed value, like (int32)seed >> 20.
                s32 = ctx.seed - (1 << 32) if ctx.seed & 0x80000000 else ctx.seed
                x[j] = float(s32 >> 20)
            cm = cm_mask
        else:
            # Fold the lower spectrum, plus low-level dither.
            for j in range(n):
                ctx.seed = celt_lcg_rand(ctx.seed)
                tmp = 1.0 / 256.0
                if not (ctx.seed & 0x8000):
                    tmp = -tmp
                x[j] = lowband[j] + tmp
            cm = fill
        renormalise_vector(x, n, gain)
    return cm


def quant_band(
    ctx: BandCtx, x: np.ndarray, n: int, b: int, B: int, lowband, lm: int,
    lowband_out, gain: float, lowband_scratch, fill: int,
) -> int:
    """Code one mono band: time/frequency reshaping around quant_partition."""
    n0 = n
    n_b = n // B
    B0 = B
    time_divide = 0
    recombine = 0
    long_blocks = B0 == 1
    tf_change = ctx.tf_change

    if n == 1:
        return quant_band_n1(ctx, x, None, b, lowband_out)

    if tf_change > 0:
        recombine = tf_change

    if (
        lowband_scratch is not None
        and lowband is not None
        and (recombine or (n_b & 1) == 0 and tf_change < 0 or B0 > 1)
    ):
        lowband_scratch[:n] = lowband[:n]
        lowband = lowband_scratch

    for k in range(recombine):
        if lowband is not None:
            haar1(lowband, n >> k, 1 << k)
        fill = _BIT_INTERLEAVE[fill & 0xF] | _BIT_INTERLEAVE[fill >> 4] << 2
    B >>= recombine
    n_b <<= recombine

    while (n_b & 1) == 0 and tf_change < 0:
        if lowband is not None:
            haar1(lowband, n_b, B)
        fill |= fill << B
        B <<= 1
        n_b >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    n_b0 = n_b

    if B0 > 1:
        if lowband is not None:
            deinterleave_hadamard(lowband, n_b >> recombine, B0 << recombine, long_blocks)

    cm = quant_partition(ctx, x, n, b, B, lowband, lm, gain, fill)

    # Undo the reshaping.
    if B0 > 1:
        interleave_hadamard(x, n_b >> recombine, B0 << recombine, long_blocks)
    n_b = n_b0
    B = B0
    for _ in range(time_divide):
        B >>= 1
        n_b <<= 1
        cm |= cm >> B
        haar1(x, n_b, B)
    for k in range(recombine):
        cm = _BIT_DEINTERLEAVE[cm]
        haar1(x, n0 >> k, 1 << k)
    B <<= recombine

    # Scale for later folding.
    if lowband_out is not None:
        scale = math.sqrt(n0)
        lowband_out[:n0] = scale * x[:n0]
    cm &= (1 << B) - 1
    return cm


def quant_band_stereo(
    ctx: BandCtx, x: np.ndarray, y: np.ndarray, n: int, b: int, B: int,
    lowband, lm: int, lowband_out, lowband_scratch, fill: int,
) -> int:
    """Code one stereo band (mid/side with coded theta)."""
    if n == 1:
        return quant_band_n1(ctx, x, y, b, lowband_out)

    orig_fill = fill
    sctx = SplitCtx()
    b, fill = compute_theta(ctx, sctx, x, y, n, b, B, B, lm, True, fill)
    inv, imid, iside = sctx.inv, sctx.imid, sctx.iside
    delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
    mid = imid / 32768.0
    side = iside / 32768.0

    if n == 2:
        # Special 2-sample stereo: side costs one sign bit.
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = 1 if itheta > 8192 else 0
        ctx.remaining_bits -= qalloc + sbits
        x2, y2 = (y, x) if c else (x, y)
        sign = 0
        if sbits:
            sign = ctx.ec.decode_bits(1)
        sign = 1 - 2 * sign
        # Use orig_fill: fold the side even if itheta cleared fill bits.
        cm = quant_band(ctx, x2, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, orig_fill)
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        x[0] = mid * x[0]
        x[1] = mid * x[1]
        y[0] = side * y[0]
        y[1] = side * y[1]
        tmp = x[0]
        x[0] = tmp - y[0]
        y[0] = tmp + y[0]
        tmp = x[1]
        x[1] = tmp - y[1]
        y[1] = tmp + y[1]
    else:
        mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            # Mid gets no gain: we need the normalised mid for folding.
            cm = quant_band(ctx, x, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            # Side never gets folded (high fill bits are zero).
            cm |= quant_band(ctx, y, n, sbits, B, None, lm, None, side, None, fill >> B)
        else:
            cm = quant_band(ctx, y, n, sbits, B, None, lm, None, side, None, fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, x, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, fill)

    if n != 2:
        stereo_merge(x, y, mid, n)
    if inv:
        y[:n] = -y[:n]
    return cm


def special_hybrid_folding(norm, norm2, start: int, m: int, dual_stereo: bool) -> None:
    """Duplicate first-band folding data so band start+1 can fold (hybrid)."""
    e_bands = modes.E_BANDS
    n1 = m * int(e_bands[start + 1] - e_bands[start])
    n2 = m * int(e_bands[start + 2] - e_bands[start + 1])
    norm[n1 : n2] = norm[2 * n1 - n2 : n1]
    if dual_stereo:
        norm2[n1 : n2] = norm2[2 * n1 - n2 : n1]


def quant_all_bands(
    start: int, end: int, x_, y_, collapse_masks, pulses,
    short_blocks: bool, spread: int, dual_stereo: bool, intensity: int, tf_res,
    total_bits: int, balance: int, ec, lm: int, coded_bands: int, seed: int,
    disable_inv: bool = False,
) -> int:
    """Decode all band shapes (libopus quant_all_bands).  Returns the updated
    noise seed; collapse_masks[band][ch] is filled in place."""
    e_bands = modes.E_BANDS
    eff_e_bands = modes.EFF_E_BANDS
    nb_e_bands = modes.NB_E_BANDS
    M = 1 << lm
    B = M if short_blocks else 1
    C = 2 if y_ is not None else 1
    norm_offset = M * int(e_bands[start])
    norm_len = M * int(e_bands[nb_e_bands - 1]) - norm_offset
    norm = np.zeros(norm_len, dtype=np.float64)
    norm2 = np.zeros(norm_len, dtype=np.float64) if C == 2 else norm
    lowband_scratch = np.zeros(
        M * int(e_bands[nb_e_bands] - e_bands[nb_e_bands - 1]), dtype=np.float64
    )

    ctx = BandCtx(
        band=0, intensity=intensity, spread=spread, tf_change=0, ec=ec,
        remaining_bits=0, seed=seed, disable_inv=disable_inv,
    )
    lowband_offset = 0
    update_lowband = True
    for i in range(start, end):
        ctx.band = i
        last = i == end - 1
        X = x_[M * int(e_bands[i]) :]
        Y = y_[M * int(e_bands[i]) :] if y_ is not None else None
        n = M * int(e_bands[i + 1]) - M * int(e_bands[i])
        tell = ec.tell_frac()

        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= coded_bands - 1:
            curr_balance = celt_sudiv(balance, min(3, coded_bands - i))
            b = max(0, min(16383, min(remaining_bits + 1, pulses[i] + curr_balance)))
        else:
            b = 0

        if (M * int(e_bands[i]) - n >= M * int(e_bands[start]) or i == start + 1) and (update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            special_hybrid_folding(norm, norm2, start, M, dual_stereo)

        ctx.tf_change = tf_res[i]
        scratch = lowband_scratch
        if i >= eff_e_bands:
            X = norm
            Y = norm if y_ is not None else None
            scratch = None
        if last:
            scratch = None

        # Estimate collapse masks of the folding source bands.
        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE or B > 1 or ctx.tf_change < 0):
            effective_lowband = max(0, M * int(e_bands[lowband_offset]) - norm_offset - n)
            # Pre-decrement like the C do-while: the range always starts at
            # least one band below lowband_offset.
            fold_start = lowband_offset - 1
            while M * int(e_bands[fold_start]) > effective_lowband + norm_offset:
                fold_start -= 1
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and M * int(e_bands[fold_end]) < effective_lowband + norm_offset + n):
                    break
            x_cm = y_cm = 0
            for fold_i in range(fold_start, max(fold_end, fold_start + 1)):
                x_cm |= int(collapse_masks[fold_i][0])
                y_cm |= int(collapse_masks[fold_i][C - 1])
        else:
            effective_lowband = -1
            x_cm = y_cm = (1 << B) - 1

        if dual_stereo and i == intensity:
            # Switch off dual stereo to do intensity from here up.
            dual_stereo = False
            upto = M * int(e_bands[i]) - norm_offset
            norm[:upto] = 0.5 * (norm[:upto] + norm2[:upto])

        lowband = norm[effective_lowband:] if effective_lowband != -1 else None
        lowband2 = norm2[effective_lowband:] if effective_lowband != -1 else None
        lowband_out = None if last else norm[M * int(e_bands[i]) - norm_offset :]
        lowband_out2 = None if last else norm2[M * int(e_bands[i]) - norm_offset :]

        if dual_stereo:
            x_cm = quant_band(ctx, X, n, b // 2, B, lowband, lm, lowband_out, 1.0, scratch, x_cm)
            y_cm = quant_band(ctx, Y, n, b // 2, B, lowband2, lm, lowband_out2, 1.0, scratch, y_cm)
        else:
            if Y is not None:
                x_cm = quant_band_stereo(ctx, X, Y, n, b, B, lowband, lm, lowband_out, scratch, x_cm | y_cm)
            else:
                x_cm = quant_band(ctx, X, n, b, B, lowband, lm, lowband_out, 1.0, scratch, x_cm)
            y_cm = x_cm
        collapse_masks[i][0] = x_cm & 0xFF
        collapse_masks[i][C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        # Keep updating the folding position while depth is > 1 bit/sample.
        update_lowband = b > (n << BITRES)
    return ctx.seed


def anti_collapse(
    x_: np.ndarray, collapse_masks, lm: int, C: int, size: int, start: int,
    end: int, log_e, prev1_log_e, prev2_log_e, pulses, seed: int,
) -> None:
    """Inject controlled noise into short-MDCT lines that collapsed to zero
    in a transient frame (libopus anti_collapse)."""
    e_bands = modes.E_BANDS
    nb = modes.NB_E_BANDS
    for i in range(start, end):
        n0 = int(e_bands[i + 1] - e_bands[i])
        depth = ((1 + pulses[i]) // n0) >> lm
        thresh = 0.5 * celt_exp2(-0.125 * depth)
        sqrt_1 = 1.0 / math.sqrt(n0 << lm)
        for c in range(C):
            prev1 = prev1_log_e[c][i]
            prev2 = prev2_log_e[c][i]
            if C == 1:
                prev1 = max(prev1, prev1_log_e[1][i])
                prev2 = max(prev2, prev2_log_e[1][i])
            ediff = max(0.0, float(log_e[c][i]) - float(min(prev1, prev2)))
            # r scales with how far energy dropped vs the last two frames.
            r = 2.0 * celt_exp2(-ediff)
            if lm == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            base = c * size + (int(e_bands[i]) << lm)
            renorm = False
            for k in range(1 << lm):
                if not (int(collapse_masks[i][c]) & (1 << k)):
                    # Fill with noise.
                    for j in range(n0):
                        seed = celt_lcg_rand(seed)
                        x_[base + (j << lm) + k] = r if (seed & 0x8000) else -r
                    renorm = True
            if renorm:
                renormalise_vector(x_[base : base + (n0 << lm)], n0 << lm, 1.0)


def denormalise_bands(
    x: np.ndarray, freq: np.ndarray, band_log_e, start: int, end: int,
    m: int, downsample: int, silence: bool,
) -> None:
    """Scale unit-norm band shapes back to full energy (celt_sig scale,
    i.e. float values around +/-32768 like the libopus float build)."""
    from .energy import E_MEANS

    e_bands = modes.E_BANDS
    n = m * modes.SHORT_MDCT_SIZE
    bound = m * int(e_bands[end])
    if downsample != 1:
        bound = min(bound, n // downsample)
    if silence:
        bound = 0
        start = end = 0
    freq[: m * int(e_bands[start])] = 0.0
    for i in range(start, end):
        j0 = m * int(e_bands[i])
        j1 = m * int(e_bands[i + 1])
        lg = float(band_log_e[i]) + float(E_MEANS[i])
        g = celt_exp2(min(32.0, lg))
        freq[j0:j1] = x[j0:j1] * g
    freq[bound:n] = 0.0
