"""Encoder side of CELT band-energy coding, a copy of
opus_tpu.celt.energy_encode: coarse 6 dB Laplace residuals against the
2-D predictor, fine raw bits and the final leftover-bit pass, each
writing back the values the decoder will reconstruct.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_encode.py holds the two equal).
"""

from __future__ import annotations

import math

import numpy as np

from ..rc.laplace import encode_laplace
from . import modes
from .energy import BETA_COEF, BETA_INTRA, E_MEANS, E_PROB_MODEL, PRED_COEF, SMALL_ENERGY_ICDF


def amp2_log2(band_e: np.ndarray, end: int, channels: int) -> np.ndarray:
    """Linear band energies -> log2 relative to eMeans."""
    out = np.full((2, modes.NB_E_BANDS), -7.0, dtype=np.float32)
    for c in range(channels):
        for i in range(end):
            out[c][i] = np.float32(math.log2(max(float(band_e[c][i]), 1e-27)) - float(E_MEANS[i]))
    return out


def quant_coarse_energy(
    enc,
    band_log_e: np.ndarray,
    old_band_e: np.ndarray,
    start: int,
    end: int,
    intra: bool,
    lm: int,
    channels: int,
    budget: int,
    nb_available_bytes: int,
) -> np.ndarray:
    """Encode coarse energies; returns the per-band quantisation error
    (input to fine energy).  Mutates old_band_e to the decoder's values."""
    prob = E_PROB_MODEL[lm][1 if intra else 0]
    coef = np.float32(0.0) if intra else PRED_COEF[lm]
    beta = BETA_INTRA if intra else BETA_COEF[lm]
    error = np.zeros((2, modes.NB_E_BANDS), dtype=np.float32)

    tell = enc.tell()
    if tell + 3 <= budget:
        enc.encode_bit_logp(1 if intra else 0, 3)

    max_decay = 16.0
    if end - start > 10:
        max_decay = min(max_decay, 0.125 * nb_available_bytes)

    prev = [np.float32(0.0)] * channels
    for i in range(start, end):
        for c in range(channels):
            x = float(band_log_e[c][i])
            old = max(-9.0, float(old_band_e[c][i]))
            f = x - float(coef) * old - float(prev[c])
            qi = int(math.floor(0.5 + f))
            decay_bound = max(-28.0, float(old_band_e[c][i])) - max_decay
            # Don't let energy drop faster than the decoder can follow.
            if qi < 0 and x < decay_bound:
                qi += int(decay_bound - x)
                if qi > 0:
                    qi = 0
            tell = enc.tell()
            bits_left = budget - tell - 3 * channels * (end - i)
            if i != start and bits_left < 30:
                if bits_left < 24:
                    qi = min(1, qi)
                if bits_left < 16:
                    qi = max(-1, qi)
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = encode_laplace(enc, qi, int(prob[pi]) << 7, int(prob[pi + 1]) << 6)
            elif budget - tell >= 2:
                qi = max(-1, min(qi, 1))
                enc.encode_icdf((2 * qi) ^ -(1 if qi < 0 else 0), SMALL_ENERGY_ICDF, 2)
            elif budget - tell >= 1:
                qi = min(0, qi)
                enc.encode_bit_logp(-qi, 1)
            else:
                qi = -1
            error[c][i] = np.float32(f - qi)
            q = np.float32(qi)
            old_band_e[c][i] = np.float32(coef * np.float32(old) + prev[c] + q)
            prev[c] = np.float32(prev[c] + q - beta * q)
    return error


def quant_fine_energy(enc, old_band_e, error, fine_quant, start, end, channels) -> None:
    for i in range(start, end):
        bits = int(fine_quant[i])
        if bits <= 0:
            continue
        frac = 1 << bits
        for c in range(channels):
            q2 = int(math.floor((float(error[c][i]) + 0.5) * frac))
            q2 = max(0, min(q2, frac - 1))
            enc.encode_bits(q2, bits)
            offset = np.float32((q2 + 0.5) * (1 << (14 - bits)) * (1.0 / 16384.0) - 0.5)
            old_band_e[c][i] = np.float32(old_band_e[c][i] + offset)
            error[c][i] = np.float32(error[c][i] - offset)


def quant_energy_finalise(enc, old_band_e, error, fine_quant, fine_priority, bits_left, start, end, channels) -> None:
    for prio in range(2):
        i = start
        while i < end and bits_left >= channels:
            if int(fine_quant[i]) >= modes.MAX_FINE_BITS or int(fine_priority[i]) != prio:
                i += 1
                continue
            for c in range(channels):
                q2 = 0 if float(error[c][i]) < 0 else 1
                enc.encode_bits(q2, 1)
                offset = np.float32((q2 - 0.5) * (1 << (14 - int(fine_quant[i]) - 1)) * (1.0 / 16384.0))
                old_band_e[c][i] = np.float32(old_band_e[c][i] + offset)
                error[c][i] = np.float32(error[c][i] - offset)
                bits_left -= 1
            i += 1
