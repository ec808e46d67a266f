"""CELT packet-loss concealment on the host (a copy of
opus_tpu.celt.plc): the pitch regime for a stream's first losses and
comfort noise for long runs.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import math

import numpy as np

from . import modes
from .bands import celt_lcg_rand, denormalise_bands
from .comb_filter import GAINS
from .mdct import mdct_backward
from .vq import renormalise_vector

MAX_PERIOD = 1024
LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100


def celt_autocorr(x: np.ndarray, lag: int, window: np.ndarray | None, overlap: int) -> np.ndarray:
    n = x.shape[0]
    if overlap and window is not None:
        xx = x.astype(np.float64).copy()
        xx[:overlap] *= window[:overlap]
        xx[n - overlap :] *= window[:overlap][::-1]
    else:
        xx = x.astype(np.float64)
    ac = np.empty(lag + 1)
    for k in range(lag + 1):
        ac[k] = float(np.dot(xx[: n - k], xx[k:]))
    return ac


def celt_lpc(ac: np.ndarray, order: int) -> np.ndarray:
    """Levinson-Durbin recursion (libopus _celt_lpc, float)."""
    lpc = np.zeros(order)
    error = ac[0]
    if ac[0] == 0.0:
        return lpc
    for i in range(order):
        rr = float(np.dot(lpc[:i], ac[i:0:-1])) + ac[i + 1]
        r = -rr / error
        lpc[i] = r
        half = (i + 1) >> 1
        for j in range(half):
            t1, t2 = lpc[j], lpc[i - 1 - j]
            lpc[j] = t1 + r * t2
            lpc[i - 1 - j] = t2 + r * t1
        error -= r * r * error
        if error < 0.001 * ac[0]:
            break
    return lpc


def celt_fir(x: np.ndarray, coeffs: np.ndarray, history: np.ndarray) -> np.ndarray:
    """y[i] = x[i] + sum_j coeffs[j] * x[i-1-j], with pre-history samples."""
    order = coeffs.shape[0]
    ext = np.concatenate([history[-order:], x])
    y = x.astype(np.float64).copy()
    for j in range(order):
        y += coeffs[j] * ext[order - 1 - j : order - 1 - j + x.shape[0]]
    return y


def celt_iir_inplace(buf: np.ndarray, start: int, n: int, coeffs: np.ndarray, mem: np.ndarray) -> None:
    """y[i] = x[i] - sum_j coeffs[j]*y[i-1-j], in place over buf[start:start+n].

    mem[j] = y[start-1-j] seed values."""
    order = coeffs.shape[0]
    hist = list(mem[:order])
    for i in range(n):
        acc = buf[start + i]
        for j in range(order):
            acc -= coeffs[j] * hist[j]
        hist.pop()
        hist.insert(0, acc)
        buf[start + i] = acc


def _pitch_xcorr(x: np.ndarray, y: np.ndarray, max_pitch: int) -> np.ndarray:
    n = x.shape[0]
    return np.array([float(np.dot(x, y[i : i + n])) for i in range(max_pitch)])


def _find_best_pitch(xcorr: np.ndarray, y: np.ndarray, length: int) -> list[int]:
    best_num = [-1.0, -1.0]
    best_den = [0.0, 0.0]
    best_pitch = [0, 1]
    syy = 1.0 + float(np.dot(y[:length], y[:length]))
    for i in range(xcorr.shape[0]):
        if xcorr[i] > 0:
            xcorr16 = xcorr[i] * 1e-12  # avoid inf on square (float build)
            num = xcorr16 * xcorr16
            if num * best_den[1] > best_num[1] * syy:
                if num * best_den[0] > best_num[0] * syy:
                    best_num[1] = best_num[0]
                    best_den[1] = best_den[0]
                    best_pitch[1] = best_pitch[0]
                    best_num[0] = num
                    best_den[0] = syy
                    best_pitch[0] = i
                else:
                    best_num[1] = num
                    best_den[1] = syy
                    best_pitch[1] = i
        syy += y[i + length] * y[i + length] - y[i] * y[i]
        syy = max(1.0, syy)
    return best_pitch


def pitch_downsample(decode_mem: np.ndarray, length: int) -> np.ndarray:
    """2x downsample + 4th-order whitening with an added zero
    (libopus pitch_downsample, float)."""
    c_count = decode_mem.shape[0]
    half = length >> 1
    x_lp = np.zeros(half)
    for c in range(c_count):
        x = decode_mem[c]
        x_lp[1:half] += 0.25 * (x[1 : 2 * half - 1 : 2] + x[3 : 2 * half + 1 : 2]) + 0.5 * x[2 : 2 * half : 2]
        x_lp[0] += 0.25 * x[1] + 0.5 * x[0]
    ac = celt_autocorr(x_lp, 4, None, 0)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
    lpc = celt_lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp *= 0.9
        lpc[i] *= tmp
    c1 = 0.8
    lpc2 = np.array(
        [lpc[0] + 0.8, lpc[1] + c1 * lpc[0], lpc[2] + c1 * lpc[1], lpc[3] + c1 * lpc[2], c1 * lpc[3]]
    )
    # celt_fir5: y[i] = x[i] + sum lpc2[j]*x[i-1-j]  (5 taps, zero history)
    y = x_lp.copy()
    for j in range(5):
        y[j + 1 :] += lpc2[j] * x_lp[: half - 1 - j]
    return y


def pitch_search(x_lp: np.ndarray, y: np.ndarray, length: int, max_pitch: int) -> int:
    """Coarse 4x + fine 2x cross-correlation search with interpolation."""
    x_lp4 = x_lp[: length >> 1 : 2]
    y_lp4 = y[: (length + max_pitch) >> 1 : 2]
    xcorr4 = _pitch_xcorr(x_lp4, y_lp4, max_pitch >> 2)
    best = _find_best_pitch(xcorr4, y_lp4, length >> 2)

    xcorr = np.zeros(max_pitch >> 1)
    for i in range(max_pitch >> 1):
        if abs(i - 2 * best[0]) > 2 and abs(i - 2 * best[1]) > 2:
            continue
        xcorr[i] = max(-1.0, float(np.dot(x_lp[: length >> 1], y[i : i + (length >> 1)])))
    best2 = _find_best_pitch(xcorr, y, length >> 1)

    bp = best2[0]
    if 0 < bp < (max_pitch >> 1) - 1:
        a, b, c = xcorr[bp - 1], xcorr[bp], xcorr[bp + 1]
        if (c - a) > 0.7 * (b - a):
            offset = 1
        elif (a - c) > 0.7 * (b - c):
            offset = -1
        else:
            offset = 0
    else:
        offset = 0
    return 2 * bp - offset


def plc_pitch_search(decode_mem: np.ndarray) -> int:
    lp = pitch_downsample(decode_mem, 2048)
    pitch = pitch_search(
        lp[PLC_PITCH_LAG_MAX >> 1 :], lp, 2048 - PLC_PITCH_LAG_MAX, PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN
    )
    return PLC_PITCH_LAG_MAX - pitch


def decode_lost(dec, n: int, lm: int) -> None:
    """Conceal one lost frame in place on a CeltDecoder instance."""
    from .decoder import DECODE_BUFFER_SIZE

    cc = dec.channels
    ov = modes.OVERLAP
    start, end = dec.start_band, dec.end_band
    # libopus 1.3 tracks losses in 2.5 ms units (loss_duration += 1<<LM
    # per concealed frame, celt_decoder.c celt_decode_lost); the noise
    # regime starts at 100 ms regardless of frame size.
    loss_duration = dec.loss_duration
    noise_based = loss_duration >= 40 or start != 0 or dec.skip_plc

    if noise_based:
        eff_end = max(start, min(end, modes.EFF_E_BANDS))
        decay = 1.5 if loss_duration == 0 else 0.5
        for c in range(cc):
            dec.old_band_e[c, start:end] = np.maximum(
                dec.background_log_e[c, start:end], dec.old_band_e[c, start:end] - decay
            )
        seed = dec.rng
        x_ = np.zeros(cc * n)
        m = 1 << lm
        for c in range(cc):
            for i in range(start, eff_end):
                boffs = n * c + (int(modes.E_BANDS[i]) << lm)
                blen = int(modes.E_BANDS[i + 1] - modes.E_BANDS[i]) << lm
                for j in range(blen):
                    seed = celt_lcg_rand(seed)
                    s32 = seed - (1 << 32) if seed & 0x80000000 else seed
                    x_[boffs + j] = float(s32 >> 20)
                renormalise_vector(x_[boffs : boffs + blen], blen, 1.0)
        dec.rng = seed
        for c in range(cc):
            dm = dec.decode_mem[c]
            dm[: DECODE_BUFFER_SIZE - n + ov // 2] = dm[n : DECODE_BUFFER_SIZE + ov // 2]
        # Synthesis (long blocks, no transient) into decode memory.
        freq = np.empty(n)
        for c in range(cc):
            denormalise_bands(x_[c * n :], freq, dec.old_band_e[c], start, eff_end, m, dec.downsample, False)
            out = dec.decode_mem[c][DECODE_BUFFER_SIZE - n :]
            mdct_backward(freq.copy(), out)
    else:
        window = modes.WINDOW.astype(np.float64)
        fade = 1.0
        if loss_duration == 0:
            dec.last_pitch_index = plc_pitch_search(dec.decode_mem[:, :DECODE_BUFFER_SIZE])
            pitch_index = dec.last_pitch_index
        else:
            pitch_index = dec.last_pitch_index
            fade = 0.8
        exc_length = min(2 * pitch_index, MAX_PERIOD)

        for c in range(cc):
            buf = dec.decode_mem[c]
            full_exc = buf[
                DECODE_BUFFER_SIZE - MAX_PERIOD - LPC_ORDER : DECODE_BUFFER_SIZE
            ].copy()
            exc = full_exc[LPC_ORDER:]  # MAX_PERIOD samples

            if loss_duration == 0:
                ac = celt_autocorr(exc, LPC_ORDER, window, modes.OVERLAP)
                ac[0] *= 1.0001  # -40 dB noise floor
                for i in range(1, LPC_ORDER + 1):
                    ac[i] -= ac[i] * (0.008 * 0.008) * i * i  # lag windowing
                dec.lpc[c] = celt_lpc(ac, LPC_ORDER)
            lpc = dec.lpc[c]

            # Excitation for the last exc_length samples.
            fir_in = exc[MAX_PERIOD - exc_length :].copy()
            fir_hist = full_exc[MAX_PERIOD - exc_length : MAX_PERIOD - exc_length + LPC_ORDER]
            exc[MAX_PERIOD - exc_length :] = celt_fir(fir_in, lpc, fir_hist)

            # Decay estimate: compare energy of the last two half-periods.
            half_len = exc_length >> 1
            e1 = 1.0 + float(np.dot(exc[MAX_PERIOD - half_len :], exc[MAX_PERIOD - half_len :]))
            e2 = 1.0 + float(np.dot(exc[MAX_PERIOD - 2 * half_len : MAX_PERIOD - half_len],
                                    exc[MAX_PERIOD - 2 * half_len : MAX_PERIOD - half_len]))
            e1 = min(e1, e2)
            decay = math.sqrt(e1 / e2)

            buf[: DECODE_BUFFER_SIZE - n] = buf[n:DECODE_BUFFER_SIZE]

            # Periodic extrapolation of the excitation.
            extrapolation_offset = MAX_PERIOD - pitch_index
            extrapolation_len = n + ov
            attenuation = fade * decay
            s1 = 0.0
            j = 0
            for i in range(extrapolation_len):
                if j >= pitch_index:
                    j -= pitch_index
                    attenuation *= decay
                buf[DECODE_BUFFER_SIZE - n + i] = attenuation * exc[extrapolation_offset + j]
                tmp = buf[DECODE_BUFFER_SIZE - MAX_PERIOD - n + extrapolation_offset + j]
                s1 += tmp * tmp / 1024.0
                j += 1

            # LPC synthesis back to the signal domain.
            lpc_mem = np.array([buf[DECODE_BUFFER_SIZE - n - 1 - i] for i in range(LPC_ORDER)])
            celt_iir_inplace(buf, DECODE_BUFFER_SIZE - n, extrapolation_len, lpc, lpc_mem)

            # "Explosion" check (float-build branch: the 0.2 factor is
            # written explicitly and doubles as a NaN catch).
            seg = buf[DECODE_BUFFER_SIZE - n : DECODE_BUFFER_SIZE - n + extrapolation_len]
            s2 = float(np.dot(seg, seg)) / 1024.0
            if not (s1 > 0.2 * s2):
                seg[:] = 0.0
            elif s1 < s2:
                ratio = math.sqrt((s1 + 1.0) / (s2 + 1.0))
                g = 1.0 - window * (1.0 - ratio)
                seg[:ov] *= g
                seg[ov:] *= ratio

            # Undo the post-filter on the TDAC tail so the next frame's
            # comb filter re-application lines up.
            pf_t = max(dec.postfilter_period, 15)
            g = dec.postfilter_gain
            taps = GAINS[dec.postfilter_tapset]
            etmp = np.empty(ov)
            for i in range(ov):
                p = DECODE_BUFFER_SIZE + i
                etmp[i] = buf[p] - g * (
                    taps[0] * buf[p - pf_t]
                    + taps[1] * (buf[p - pf_t + 1] + buf[p - pf_t - 1])
                    + taps[2] * (buf[p - pf_t + 2] + buf[p - pf_t - 2])
                )
            # Simulate TDAC so the concealed tail blends with the next MDCT.
            for i in range(ov // 2):
                buf[DECODE_BUFFER_SIZE + i] = (
                    window[i] * etmp[ov - 1 - i] + window[ov - 1 - i] * etmp[i]
                )

    dec.loss_duration = min(10000, loss_duration + (1 << lm))
