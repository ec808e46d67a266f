"""CELT bit allocation (a copy of opus_tpu.celt.rate): the PVQ pulse
cache, compute_allocation and interp_bits2pulses.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from .cwrs import MAX_PSEUDO, fits_in32, get_pulses, log2_frac, pvq_v
from . import modes

BITRES = 3


def get_required_bits(n: int, maxk: int, frac: int = BITRES) -> list[int]:
    """Bits (in 1/2**frac units) needed to code k pulses in n dims, for
    k = 0..maxk."""
    assert maxk > 0
    if n == 1:
        return [0] + [1 << frac] * maxk
    return [0] + [log2_frac(pvq_v(n, k), frac) for k in range(1, maxk + 1)]


def compute_pulse_cache(lm: int = modes.MAX_LM, nb_bands: int = modes.NB_E_BANDS):
    """Build (index[lm+2][nb_bands], bits[]) for every distinct half-band
    size N = width<<i>>1, deduplicating identical sizes."""
    e_bands = modes.E_BANDS
    index = np.full((lm + 2, nb_bands), -1, dtype=np.int32)
    bits: list[int] = []
    for i in range(lm + 2):
        for j in range(nb_bands):
            n = (int(e_bands[j + 1] - e_bands[j]) << i) >> 1
            # Reuse the entry of any earlier band with the same size.
            found = False
            for k in range(i + 1):
                limit = j if k == i else nb_bands
                for m in range(limit):
                    if n == (int(e_bands[m + 1] - e_bands[m]) << k) >> 1:
                        index[i][j] = index[k][m]
                        found = True
                        break
                if found:
                    break
            if not found and n != 0:
                # New size: store max pseudo-pulse count, then bit costs.
                max_pseudo = 0
                while max_pseudo < MAX_PSEUDO and fits_in32(n, get_pulses(max_pseudo + 1)):
                    max_pseudo += 1
                costs = get_required_bits(n, get_pulses(max_pseudo))
                index[i][j] = len(bits)
                bits.append(max_pseudo)
                bits.extend(costs[get_pulses(q)] - 1 for q in range(1, max_pseudo + 1))
    return index, np.array(bits, dtype=np.int32)


ALLOC_STEPS = 6
LOG_MAX_PSEUDO = 6
FINE_OFFSET = 21
MAX_FINE_BITS = modes.MAX_FINE_BITS

#: log2_frac(j, 3) lookup used for the intensity-stereo position cost
#: (confirmed against libopus .rodata).
LOG2_FRAC_TABLE = (
    0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29, 30, 31, 32,
    32, 33, 34, 34, 35, 36, 36, 37, 37,
)


def init_caps(lm: int, channels: int) -> list[int]:
    """Per-band ceiling on allocatable bits (libopus init_caps).

    Returns plain Python ints: cap values flow into range-coder state and
    must keep arbitrary-precision arithmetic.
    """
    caps_row = modes.CACHE_CAPS.reshape(4, 2, modes.NB_E_BANDS)[lm][channels - 1]
    n = (modes.E_BANDS[1:] - modes.E_BANDS[:-1]).astype(np.int64) << lm
    return [int(v) for v in ((caps_row.astype(np.int64) + 64) * channels * n) >> 2]


def bits2pulses(band: int, lm: int, bits: int) -> int:
    """Largest pseudo-pulse count whose cost is nearest to ``bits``
    (1/8-bit units); binary search over the band's cache row."""
    cache_off = int(modes.CACHE_INDEX[lm + 1][band])
    cache = modes.CACHE_BITS[cache_off:]
    lo = 0
    hi = int(cache[0])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(cache[mid]) >= bits:
            hi = mid
        else:
            lo = mid
    lo_cost = -1 if lo == 0 else int(cache[lo])
    if bits - lo_cost <= int(cache[hi]) - bits:
        return lo
    return hi


def pulses2bits(band: int, lm: int, pulses: int) -> int:
    """Cost in 1/8 bits of a pseudo-pulse count."""
    if pulses == 0:
        return 0
    cache_off = int(modes.CACHE_INDEX[lm + 1][band])
    return int(modes.CACHE_BITS[cache_off + pulses]) + 1


def _interp_bits2pulses(
    start, end, skip_start, bits1, bits2, thresh, cap, total, skip_rsv,
    intensity, intensity_rsv, dual_stereo, dual_stereo_rsv,
    bits, ebits, fine_priority, C, lm, ec, encode, prev, signal_bandwidth,
):
    """Second-stage allocation: interpolate between the two bracketing
    quality rows, run the skip loop, split fine-energy vs PVQ bits.
    Returns (coded_bands, intensity, dual_stereo, balance)."""
    e_bands = modes.E_BANDS
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    log_m = lm << BITRES

    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum = 0
    done = False
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    # Skip loop: working back from the top band, decide which get coded.
    coded_bands = end
    while True:
        j = coded_bands - 1
        if j <= skip_start:
            # Give the reserved skip bit back.
            total += skip_rsv
            break
        left = total - psum
        percoeff = left // int(e_bands[coded_bands] - e_bands[start])
        left -= int(e_bands[coded_bands] - e_bands[start]) * percoeff
        rem = max(left - int(e_bands[j] - e_bands[start]), 0)
        band_width = int(e_bands[coded_bands] - e_bands[j])
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if encode:
                if coded_bands > 17:
                    depth_threshold = 7 if j < prev else 9
                else:
                    depth_threshold = 0
                if coded_bands <= start + 2 or (
                    band_bits > ((depth_threshold * band_width << lm << BITRES) >> 4)
                    and j <= signal_bandwidth
                ):
                    ec.encode_bit_logp(1, 1)
                    break
                ec.encode_bit_logp(0, 1)
            elif ec.decode_bit_logp(1):
                break
            # We used a bit to skip this band.
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        # Reclaim this band's bits (and re-reserve a cheaper intensity field).
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = LOG2_FRAC_TABLE[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        coded_bands -= 1

    assert coded_bands > start
    # Intensity & dual-stereo parameters.
    if intensity_rsv > 0:
        if encode:
            intensity = min(intensity, coded_bands)
            ec.encode_uint(intensity - start, coded_bands + 1 - start)
        else:
            intensity = start + ec.decode_uint(coded_bands + 1 - start)
    else:
        intensity = 0
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        if encode:
            ec.encode_bit_logp(1 if dual_stereo else 0, 1)
        else:
            dual_stereo = bool(ec.decode_bit_logp(1))
    else:
        dual_stereo = False

    # Spread the remaining bits per-coefficient over the coded bands.
    left = total - psum
    percoeff = left // int(e_bands[coded_bands] - e_bands[start])
    left -= int(e_bands[coded_bands] - e_bands[start]) * percoeff
    for i in range(start, coded_bands):
        bits[i] += percoeff * int(e_bands[i + 1] - e_bands[i])
    for i in range(start, coded_bands):
        tmp = min(left, int(e_bands[i + 1] - e_bands[i]))
        bits[i] += tmp
        left -= tmp

    # Split each band's budget into fine-energy bits and PVQ bits.
    balance = 0
    for i in range(start, coded_bands):
        n0 = int(e_bands[i + 1] - e_bands[i])
        n = n0 << lm
        bit = bits[i] + balance
        if n > 1:
            excess = max(bit - cap[i], 0)
            bits[i] = bit - excess
            # Stereo mid/side adds one degree of freedom.
            den = C * n + (1 if (C == 2 and n > 2 and not dual_stereo and i < intensity) else 0)
            nclogn = den * (int(modes.LOG_N[i]) + log_m)
            # Fine bits get log2(N)/2 + FINE_OFFSET over their fair share.
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset += (den << BITRES) >> 2
            # Make the 2nd/3rd fine bit cheaper to allocate.
            if bits[i] + offset < (den * 2) << BITRES:
                offset += nclogn >> 2
            elif bits[i] + offset < (den * 3) << BITRES:
                offset += nclogn >> 3
            eb = max(0, bits[i] + offset + (den << (BITRES - 1)))
            eb = (eb // den) >> BITRES
            if C * eb > (bits[i] >> BITRES):
                eb = bits[i] >> stereo >> BITRES
            eb = min(eb, MAX_FINE_BITS)
            fine_priority[i] = 1 if eb * (den << BITRES) >= bits[i] + offset else 0
            bits[i] -= (C * eb) << BITRES
            ebits[i] = eb
        else:
            # N=1: everything but a sign bit goes to fine energy.
            excess = max(0, bit - (C << BITRES))
            bits[i] = bit - excess
            ebits[i] = 0
            fine_priority[i] = 1
        # Fine energy can't ride quant_all_bands' rebalancing; do it here.
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES), MAX_FINE_BITS - ebits[i])
            ebits[i] += extra_fine
            extra_bits = (extra_fine * C) << BITRES
            fine_priority[i] = 1 if extra_bits >= excess - balance else 0
            excess -= extra_bits
        balance = excess
        assert bits[i] >= 0 and ebits[i] >= 0

    # Skipped bands spend everything on fine energy.
    for i in range(coded_bands, end):
        ebits[i] = bits[i] >> stereo >> BITRES
        assert (C * ebits[i]) << BITRES == bits[i]
        bits[i] = 0
        fine_priority[i] = 1 if ebits[i] < 1 else 0

    return coded_bands, intensity, dual_stereo, balance


def compute_allocation(
    start: int,
    end: int,
    offsets,
    cap,
    alloc_trim: int,
    intensity: int,
    dual_stereo: bool,
    total: int,
    C: int,
    lm: int,
    ec,
    encode: bool,
    prev: int = 0,
    signal_bandwidth: int = 0,
):
    """Full band bit allocation (libopus clt_compute_allocation).

    Returns (pulses[], ebits[], fine_priority[], coded_bands, intensity,
    dual_stereo, balance).  Runs identically on encoder and decoder — it
    *is* the shared implicit allocation protocol of RFC 6716 sec. 4.3.3.
    """
    e_bands = modes.E_BANDS
    len_bands = modes.NB_E_BANDS
    total = max(total, 0)
    skip_start = start
    # One bit to end manual band skipping, if we can afford it.
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = LOG2_FRAC_TABLE[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv

    thresh = [0] * len_bands
    trim_offset = [0] * len_bands
    for j in range(start, end):
        width = int(e_bands[j + 1] - e_bands[j])
        # Below this, no PVQ bits for sure.
        thresh[j] = max(C << BITRES, (3 * width << lm << BITRES) >> 4)
        # Allocation-curve tilt.
        trim_offset[j] = (
            C * width * (alloc_trim - 5 - lm) * (end - j - 1) * (1 << (lm + BITRES))
        ) >> 6
        if (width << lm) == 1:
            trim_offset[j] -= C << BITRES

    lo, hi = 1, modes.NB_ALLOC_VECTORS - 1
    while lo <= hi:
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            width = int(e_bands[j + 1] - e_bands[j])
            bitsj = (C * width * int(modes.ALLOC_VECTORS[mid][j]) << lm) >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1

    bits1 = [0] * len_bands
    bits2 = [0] * len_bands
    for j in range(start, end):
        width = int(e_bands[j + 1] - e_bands[j])
        bits1j = (C * width * int(modes.ALLOC_VECTORS[lo][j]) << lm) >> 2
        bits2j = (
            cap[j]
            if hi >= modes.NB_ALLOC_VECTORS
            else (C * width * int(modes.ALLOC_VECTORS[hi][j]) << lm) >> 2
        )
        if bits1j > 0:
            bits1j = max(0, bits1j + trim_offset[j])
        if bits2j > 0:
            bits2j = max(0, bits2j + trim_offset[j])
        if lo > 0:
            bits1j += offsets[j]
        bits2j += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits2j = max(0, bits2j - bits1j)
        bits1[j] = bits1j
        bits2[j] = bits2j

    pulses = [0] * len_bands
    ebits = [0] * len_bands
    fine_priority = [0] * len_bands
    coded_bands, intensity, dual_stereo, balance = _interp_bits2pulses(
        start, end, skip_start, bits1, bits2, thresh, cap, total, skip_rsv,
        intensity, intensity_rsv, dual_stereo, dual_stereo_rsv,
        pulses, ebits, fine_priority, C, lm, ec, encode, prev, signal_bandwidth,
    )
    return pulses, ebits, fine_priority, coded_bands, intensity, dual_stereo, balance
