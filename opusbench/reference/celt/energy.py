"""CELT band-energy decoding (RFC 6716 sec. 4.3.2), a copy of
opus_tpu.celt.energy: Laplace-coded coarse energy against a time x
frequency predictor, fine energy from raw bits, and the final pass.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import numpy as np

from ..rc.laplace import decode_laplace
from . import modes

#: Laplace (fs<<7, decay<<6) parameters per (LM, intra, band)
#: — libopus e_prob_model[4][2][42].
E_PROB_MODEL = np.array(
    [
        [  # 120-sample frames
            [72, 127, 65, 129, 66, 128, 65, 128, 64, 128, 62, 128, 64, 128, 64, 128,
             92, 78, 92, 79, 92, 78, 90, 79, 116, 41, 115, 40, 114, 40, 132, 26,
             132, 26, 145, 17, 161, 12, 176, 10, 177, 11],
            [24, 179, 48, 138, 54, 135, 54, 132, 53, 134, 56, 133, 55, 132, 55, 132,
             61, 114, 70, 96, 74, 88, 75, 88, 87, 74, 89, 66, 91, 67, 100, 59,
             108, 50, 120, 40, 122, 37, 97, 43, 78, 50],
        ],
        [  # 240-sample frames
            [83, 78, 84, 81, 88, 75, 86, 74, 87, 71, 90, 73, 93, 74, 93, 74,
             109, 40, 114, 36, 117, 34, 117, 34, 143, 17, 145, 18, 146, 19, 162, 12,
             165, 10, 178, 7, 189, 6, 190, 8, 177, 9],
            [23, 178, 54, 115, 63, 102, 66, 98, 69, 99, 74, 89, 71, 91, 73, 91,
             78, 89, 86, 80, 92, 66, 93, 64, 102, 59, 103, 60, 104, 60, 117, 52,
             123, 44, 138, 35, 133, 31, 97, 38, 77, 45],
        ],
        [  # 480-sample frames
            [61, 90, 93, 60, 105, 42, 107, 41, 110, 45, 116, 38, 113, 38, 112, 38,
             124, 26, 132, 27, 136, 19, 140, 20, 155, 14, 159, 16, 158, 18, 170, 13,
             177, 10, 187, 8, 192, 6, 175, 9, 159, 10],
            [21, 178, 59, 110, 71, 86, 75, 85, 84, 83, 91, 66, 88, 73, 87, 72,
             92, 75, 98, 72, 105, 58, 107, 54, 115, 52, 114, 55, 112, 56, 129, 51,
             132, 40, 150, 33, 140, 29, 98, 35, 77, 42],
        ],
        [  # 960-sample frames
            [42, 121, 96, 66, 108, 43, 111, 40, 117, 44, 123, 32, 120, 36, 119, 33,
             127, 33, 134, 34, 139, 21, 147, 23, 152, 20, 158, 25, 154, 26, 166, 21,
             173, 16, 184, 13, 184, 10, 150, 13, 139, 15],
            [22, 178, 63, 114, 74, 82, 84, 83, 92, 82, 103, 62, 96, 72, 96, 67,
             101, 73, 107, 72, 113, 55, 118, 52, 125, 52, 118, 52, 117, 55, 135, 49,
             137, 39, 157, 32, 145, 29, 97, 33, 77, 40],
        ],
    ],
    dtype=np.int32,
)

#: iCDF for the 2-bit "small energy" fallback symbol when budget is tight.
SMALL_ENERGY_ICDF = (2, 1, 0)

#: Mean log-energy per band (Q: dB6 units), libopus eMeans (float build).
E_MEANS = np.array(
    [6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
     4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
     3.75, 3.75, 3.75, 3.75, 3.75],
    dtype=np.float32,
)

#: Frequency-axis prediction coefficient per LM (29440.. >>15 in fixed).
PRED_COEF = np.array([0.8984375, 0.796875, 0.6484375, 0.5], dtype=np.float32)
#: Time-axis leak per LM for inter frames.
BETA_COEF = np.array(
    [30147 / 32768.0, 22282 / 32768.0, 12124 / 32768.0, 6554 / 32768.0],
    dtype=np.float32,
)
BETA_INTRA = np.float32(4915 / 32768.0)


def unquant_coarse_energy(
    dec,
    old_ebands: np.ndarray,
    start: int,
    end: int,
    intra: bool,
    lm: int,
    channels: int,
) -> None:
    """Decode coarse (6 dB) band energies in place into old_ebands[c][band].

    Mirrors libopus unquant_coarse_energy: Laplace while the budget allows,
    then a 2-bit iCDF, then a single bit, then pure prediction.
    """
    prob = E_PROB_MODEL[lm][1 if intra else 0]
    coef = np.float32(0.0) if intra else PRED_COEF[lm]
    beta = BETA_INTRA if intra else BETA_COEF[lm]
    budget = dec.storage * 8

    prev = [np.float32(0.0)] * channels
    for band in range(start, end):
        for c in range(channels):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(band, 20)
                qi = decode_laplace(dec, int(prob[pi]) << 7, int(prob[pi + 1]) << 6)
            elif budget - tell >= 2:
                qi = dec.decode_icdf(SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -int(dec.decode_bit_logp(1))
            else:
                qi = -1
            q = np.float32(qi)
            # Energy floor: never predict from below -9 (54 dB down).
            old = max(np.float32(-9.0), old_ebands[c][band])
            old_ebands[c][band] = np.float32(coef * old + prev[c] + q)
            prev[c] = np.float32(prev[c] + q - beta * q)


def unquant_fine_energy(
    dec, old_ebands: np.ndarray, fine_quant, start: int, end: int, channels: int
) -> None:
    """Refine band energies with fine_quant[band] raw bits each."""
    for band in range(start, end):
        bits = int(fine_quant[band])
        if bits <= 0:
            continue
        for c in range(channels):
            q2 = dec.decode_bits(bits)
            offset = np.float32((q2 + 0.5) * (1 << (14 - bits)) * (1.0 / 16384.0) - 0.5)
            old_ebands[c][band] = np.float32(old_ebands[c][band] + offset)


def unquant_energy_finalise(
    dec,
    old_ebands: np.ndarray,
    fine_quant,
    fine_priority,
    bits_left: int,
    start: int,
    end: int,
    channels: int,
) -> None:
    """Spend leftover whole bits on one extra fine-energy bit per band,
    priority-0 bands first."""
    for prio in range(2):
        band = start
        while band < end and bits_left >= channels:
            if int(fine_quant[band]) >= modes.MAX_FINE_BITS or int(fine_priority[band]) != prio:
                band += 1
                continue
            for c in range(channels):
                q2 = int(dec.decode_bits(1))
                offset = np.float32((q2 - 0.5) * (1 << (14 - int(fine_quant[band]) - 1)) * (1.0 / 16384.0))
                old_ebands[c][band] = np.float32(old_ebands[c][band] + offset)
                bits_left -= 1
            band += 1
