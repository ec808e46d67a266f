"""The single CELT mode: 48 kHz, 960-sample frames, 21 energy bands.

Every name of the reference's opus_tpu.celt.modes with its value: the
integer tables (band edges, allocation matrix, logN, PVQ bit cache) are
normative data that drive bit-exact allocation decisions, and the MDCT
window comes from its defining formula.  Below them, three constants the
port's device modules read, copied from the reference's scalar decoder,
comb filter and energy modules (the port's own copies of those modules
define them too).  tests/test_torch_tables.py and
tests/test_torch_celt_decoder.py hold every value to the reference's.
"""

from __future__ import annotations

import numpy as np

SAMPLING_RATE = 48000
#: MDCT low-overlap region length.
OVERLAP = 120
MAX_LM = 3
NB_SHORT_MDCTS = 8
SHORT_MDCT_SIZE = 120
NB_E_BANDS = 21
EFF_E_BANDS = 21
#: Maximum fine-energy bits per band.
MAX_FINE_BITS = 8

#: De-emphasis filter coefficient (reference: mode.rs:10).
PREEMPH = np.float32(0.8500061)

#: Band boundaries in units of 4 bins at LM=0 (reference: mode.rs:33-35).
E_BANDS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100],
    dtype=np.int32,
)

#: log2(band size) in Q3... actually 8*log2(N_band at LM=0) lookup used by
#: the allocator and spreading decisions (reference: mode.rs:37-39).
LOG_N = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 8, 8, 8, 8, 16, 16, 16, 21, 21, 24, 29, 34, 36],
    dtype=np.int32,
)

#: Bit allocation matrix, 11 quality rows x 21 bands, units of 1/32
#: bit/sample (reference: mode.rs:16-28).
NB_ALLOC_VECTORS = 11
ALLOC_VECTORS = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [90, 80, 75, 69, 63, 56, 49, 40, 34, 29, 20, 18, 10, 0, 0, 0, 0, 0, 0, 0, 0],
        [110, 100, 90, 84, 78, 71, 65, 58, 51, 45, 39, 32, 26, 20, 12, 0, 0, 0, 0, 0, 0],
        [118, 110, 103, 93, 86, 80, 75, 70, 65, 59, 53, 47, 40, 31, 23, 15, 4, 0, 0, 0, 0],
        [126, 119, 112, 104, 95, 89, 83, 78, 72, 66, 60, 54, 47, 39, 32, 25, 17, 12, 1, 0, 0],
        [134, 127, 120, 114, 103, 97, 91, 85, 78, 72, 66, 60, 54, 47, 41, 35, 29, 23, 16, 10, 1],
        [144, 137, 130, 124, 113, 107, 101, 95, 88, 82, 76, 70, 64, 57, 51, 45, 39, 33, 26, 15, 1],
        [152, 145, 138, 132, 123, 117, 111, 105, 98, 92, 86, 80, 74, 67, 61, 55, 49, 43, 36, 20, 1],
        [162, 155, 148, 142, 133, 127, 121, 115, 108, 102, 96, 90, 84, 77, 71, 65, 59, 53, 46, 30, 1],
        [172, 165, 158, 152, 143, 137, 131, 125, 118, 112, 106, 100, 94, 87, 81, 75, 69, 63, 56, 45, 20],
        [200, 200, 200, 200, 200, 200, 200, 200, 198, 193, 188, 183, 178, 173, 168, 163, 158, 153, 148, 129, 104],
    ],
    dtype=np.int32,
)

#: PVQ bit cache: per (LM, band) an offset into CACHE_BITS
#: (reference: mode.rs:70-111; layout identical to libopus PulseCache).
CACHE_INDEX = np.array(
    [
        [-1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 41, 41, 41, 82, 82, 123, 164, 200, 222],
        [0, 0, 0, 0, 0, 0, 0, 0, 41, 41, 41, 41, 123, 123, 123, 164, 164, 240, 266, 283, 295],
        [41, 41, 41, 41, 41, 41, 41, 41, 123, 123, 123, 123, 240, 240, 240, 266, 266, 305, 318, 328, 336],
        [123, 123, 123, 123, 123, 123, 123, 123, 240, 240, 240, 240, 305, 305, 305, 318, 318, 343, 351, 358, 364],
        [240, 240, 240, 240, 240, 240, 240, 240, 305, 305, 305, 305, 343, 343, 343, 351, 351, 370, 376, 382, 387],
    ],
    dtype=np.int32,
)

CACHE_BITS = np.array(
    # fmt: off
    [
        40, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
        7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 40, 15, 23, 28,
        31, 34, 36, 38, 39, 41, 42, 43, 44, 45, 46, 47, 47, 49, 50, 51, 52, 53,
        54, 55, 55, 57, 58, 59, 60, 61, 62, 63, 63, 65, 66, 67, 68, 69, 70, 71,
        71, 40, 20, 33, 41, 48, 53, 57, 61, 64, 66, 69, 71, 73, 75, 76, 78, 80,
        82, 85, 87, 89, 91, 92, 94, 96, 98, 101, 103, 105, 107, 108, 110, 112,
        114, 117, 119, 121, 123, 124, 126, 128, 40, 23, 39, 51, 60, 67, 73, 79,
        83, 87, 91, 94, 97, 100, 102, 105, 107, 111, 115, 118, 121, 124, 126,
        129, 131, 135, 139, 142, 145, 148, 150, 153, 155, 159, 163, 166, 169,
        172, 174, 177, 179, 35, 28, 49, 65, 78, 89, 99, 107, 114, 120, 126,
        132, 136, 141, 145, 149, 153, 159, 165, 171, 176, 180, 185, 189, 192,
        199, 205, 211, 216, 220, 225, 229, 232, 239, 245, 251, 21, 33, 58, 79,
        97, 112, 125, 137, 148, 157, 166, 174, 182, 189, 195, 201, 207, 217,
        227, 235, 243, 251, 17, 35, 63, 86, 106, 123, 139, 152, 165, 177, 187,
        197, 206, 214, 222, 230, 237, 250, 25, 31, 55, 75, 91, 105, 117, 128,
        138, 146, 154, 161, 168, 174, 180, 185, 190, 200, 208, 215, 222, 229,
        235, 240, 245, 255, 16, 36, 65, 89, 110, 128, 144, 159, 173, 185, 196,
        207, 217, 226, 234, 242, 250, 11, 41, 74, 103, 128, 151, 172, 191, 209,
        225, 241, 255, 9, 43, 79, 110, 138, 163, 186, 207, 227, 246, 12, 39,
        71, 99, 123, 144, 164, 182, 198, 214, 228, 241, 253, 9, 44, 81, 113,
        142, 168, 192, 214, 235, 255, 7, 49, 90, 127, 160, 191, 220, 247, 6,
        51, 95, 134, 170, 203, 234, 7, 47, 87, 123, 155, 184, 212, 237, 6, 52,
        97, 137, 174, 208, 240, 5, 57, 106, 151, 192, 231, 5, 59, 111, 158,
        202, 243, 5, 55, 103, 147, 187, 224, 5, 60, 113, 161, 206, 248, 4, 65,
        122, 175, 224, 4, 67, 127, 182, 234,
    ],
    # fmt: on
    dtype=np.int32,
)

#: Per (LM, stereo, band) cap on PVQ bits, in 1/8 bit units scaled by N
#: (reference: mode.rs:101-111; consumed via the caps formula in rate.py).
CACHE_CAPS = np.array(
    # fmt: off
    [
        224, 224, 224, 224, 224, 224, 224, 224, 160, 160, 160, 160, 185, 185,
        185, 178, 178, 168, 134, 61, 37, 224, 224, 224, 224, 224, 224, 224,
        224, 240, 240, 240, 240, 207, 207, 207, 198, 198, 183, 144, 66, 40,
        160, 160, 160, 160, 160, 160, 160, 160, 185, 185, 185, 185, 193, 193,
        193, 183, 183, 172, 138, 64, 38, 240, 240, 240, 240, 240, 240, 240,
        240, 207, 207, 207, 207, 204, 204, 204, 193, 193, 180, 143, 66, 40,
        185, 185, 185, 185, 185, 185, 185, 185, 193, 193, 193, 193, 193, 193,
        193, 183, 183, 172, 138, 65, 39, 207, 207, 207, 207, 207, 207, 207,
        207, 204, 204, 204, 204, 201, 201, 201, 188, 188, 176, 141, 66, 40,
        193, 193, 193, 193, 193, 193, 193, 193, 193, 193, 193, 193, 194, 194,
        194, 184, 184, 173, 139, 65, 39, 204, 204, 204, 204, 204, 204, 204,
        204, 201, 201, 201, 201, 198, 198, 198, 187, 187, 175, 140, 66, 40,
    ],
    # fmt: on
    dtype=np.int32,
)


def _make_window(overlap: int = OVERLAP) -> np.ndarray:
    """The CELT low-overlap MDCT window: W(n) = sin(pi/2 * sin^2(pi/2 *
    (n+.5)/L)) (Vorbis window; reference literal at mode.rs:43-68)."""
    n = (np.arange(overlap, dtype=np.float64) + 0.5) / overlap
    inner = np.sin(0.5 * np.pi * n)
    return np.sin(0.5 * np.pi * inner * inner).astype(np.float32)


WINDOW = _make_window()


def band_bins(lm: int) -> np.ndarray:
    """Band boundaries in MDCT bins for frame size 120<<lm."""
    return (E_BANDS.astype(np.int64) << lm).astype(np.int32)


# From opus_tpu/celt/decoder.py: decode-memory history per channel.
DECODE_BUFFER_SIZE = 2048

# From opus_tpu/celt/comb_filter.py: comb filter tap gains per tapset.
GAINS = (
    (0.3066406250, 0.2170410156, 0.1296386719),
    (0.4638671875, 0.2680664062, 0.0),
    (0.7998046875, 0.1000976562, 0.0),
)

# From opus_tpu/celt/energy.py: mean log-energy per band (float build).
E_MEANS = np.array(
    [6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
     4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
     3.75, 3.75, 3.75, 3.75, 3.75],
    dtype=np.float32,
)
