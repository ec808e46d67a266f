"""Constant tables of the CELT serving synthesis.

These are the port's fixed "weights": the IMDCT basis, the band one-hot
expansion, the de-emphasis Toeplitz block, the post-filter crossfade
envelopes and the packed-slot layout, built as numpy arrays.  Each builder
named after one in `opus_tpu.dsp.synthesis` is
a copy of it and must stay bit-identical to it (tests/test_torch_tables.py).
They are copied rather than imported because the port imports nothing of
`opus_tpu`.  `on_device` uploads a table to a device once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..celt import modes
from ..celt.modes import E_MEANS, GAINS

OVERLAP = modes.OVERLAP


@functools.lru_cache(maxsize=None)
def on_device(builder, device: torch.device, *args) -> torch.Tensor:
    """builder(*args) as a contiguous tensor on `device`, uploaded once."""
    return torch.as_tensor(np.ascontiguousarray(builder(*args)), device=device)


@functools.lru_cache(maxsize=None)
def _synthesis_basis(n2: int) -> np.ndarray:
    """[N2, N2] matrix mapping spectra to the IMDCT mid-region
    u[N2/2 + j] (see opus_tpu.celt.mdct for the derivation)."""
    n = 2 * n2
    j = np.arange(n2)[:, None] + n2 / 2.0
    k = np.arange(n2)[None, :]
    return np.cos(2.0 * np.pi / n * (j + 0.5 + n / 4.0) * (k + 0.5)).astype(np.float32).T


@functools.lru_cache(maxsize=None)
def _band_of_bin(lm: int) -> np.ndarray:
    """[N] band index of every MDCT bin."""
    m = 1 << lm
    n = m * modes.SHORT_MDCT_SIZE
    widths = (modes.E_BANDS[1:] - modes.E_BANDS[:-1]).astype(np.int64) * m
    idx = np.repeat(np.arange(modes.NB_E_BANDS, dtype=np.int32), widths)
    # Bins above the top band (always masked by `bound`) map to band 20.
    return np.concatenate([idx, np.full(n - idx.size, modes.NB_E_BANDS - 1, np.int32)])


@functools.lru_cache(maxsize=None)
def _band_onehot(lm: int) -> np.ndarray:
    """[21, N] one-hot band->bin expansion matrix."""
    bob = _band_of_bin(lm)
    oh = np.zeros((modes.NB_E_BANDS, bob.size), np.float32)
    oh[bob, np.arange(bob.size)] = 1.0
    return oh


_DEEMPH_BLK = modes.SHORT_MDCT_SIZE


@functools.lru_cache(maxsize=None)
def _deemph_toeplitz() -> np.ndarray:
    """[120, 120] lower-triangular Toeplitz block of PREEMPH^(j-k)."""
    k = np.arange(_DEEMPH_BLK)
    d = k[None, :] - k[:, None]  # output j, input k -> j - k
    T = np.where(d >= 0, np.float64(modes.PREEMPH) ** np.maximum(d, 0), 0.0)
    return T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _deemph_powers() -> np.ndarray:
    return (np.float64(modes.PREEMPH) ** np.arange(_DEEMPH_BLK)).astype(np.float32)


#: Post-filter chunk sizes; `chunk` is safe iff every active (nonzero-gain)
#: filter lag in the batch is >= chunk+2 (see pf_chunk_for).
PF_CHUNKS = (12, 60, 120, 240)


def pf_chunk_for(periods: np.ndarray, gains: np.ndarray):
    """Largest safe postfilter chunk for a step (host-side, numpy).

    periods [B, 3] int, gains [B, 3] float.  Zero-gain filters never
    contribute, so only lags of active filters constrain the chunk.
    Returns (chunk, any_active).  Silent frames still carry the previous
    frames' nonzero gains, so they constrain the chunk like any other.
    """
    active = gains != 0.0
    if not active.any():
        return PF_CHUNKS[0], False
    min_lag = int(np.maximum(periods, 15)[active].min())
    chunk = PF_CHUNKS[0]
    for c in PF_CHUNKS:
        if c + 2 <= min_lag:
            chunk = c
    return chunk, True


#: int32 words of band-shape data per stream for each transfer mode:
#: "q14" = 1920 Q14 int16 (two per word); "pW" (W = 12/10/8) = W-bit
#: offset-binary mantissas in a little-endian bit stream, with the
#: per-band exponent folded into the band log-energies by the native packer.
PACK_BITS = {"p12": 12, "p10": 10, "p8": 8}
XQ_WORDS = {"q14": 960, "p12": 720, "p10": 600, "p8": 480}


def packed_words(batch: int, mode: str = "q14", silk_words: int = 0) -> int:
    """int32 words in one packed plane-A slot (layout below)."""
    return batch * (XQ_WORDS[mode] + silk_words + 42 + 16 + 3)


def packed_offsets(batch: int, mode: str = "q14", silk_words: int = 0) -> dict:
    """Word offsets of each region in a packed slot.

    Layout (all regions contiguous, per-region stream-major):
      xq    [B, XQ_WORDS] i32 — band shapes (mode-dependent packing)
      silk  [B, silk_words] i32 — SILK PCM (mixed-mode slots only)
      ble   [B, 2, 21] f32   — band log-energies
      meta  [B, 16]   int32  — silence/short/lm/ch/start/end/pf periods+tapsets
      gains [B, 3]    f32    — prefilter gains
    """
    o0 = 0
    os_ = o0 + batch * XQ_WORDS[mode]
    o1 = os_ + batch * silk_words
    o2 = o1 + batch * 42
    o3 = o2 + batch * 16
    return {"xq": o0, "silk": os_, "ble": o1, "meta": o2, "gains": o3,
            "end": o3 + batch * 3}


@functools.lru_cache(maxsize=None)
def _window_sq() -> np.ndarray:
    """[OVERLAP] WINDOW^2, the post-filter crossfade weight (the kernel
    reads it; opus_tpu.dsp.pallas_pf._envelopes lays it out per filter)."""
    return (modes.WINDOW.astype(np.float64) ** 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tap_gains() -> np.ndarray:
    """[3 tapsets, 3 taps] comb filter tap gains."""
    return np.array(GAINS, np.float32)


@functools.lru_cache(maxsize=None)
def _e_means() -> np.ndarray:
    """[21] mean band log-energies, added back by denormalisation."""
    return np.asarray(E_MEANS[: modes.NB_E_BANDS], np.float32)


@functools.lru_cache(maxsize=None)
def _e_bands() -> np.ndarray:
    """[22] band edges in short-MDCT bins."""
    return np.asarray(modes.E_BANDS, np.int64)


@functools.lru_cache(maxsize=None)
def _tdac_windows() -> np.ndarray:
    """[4, OVERLAP/2] TDAC fades: WINDOW's first half, its second half
    reversed, and those two reversed again (w_lo, w_hi, w_hi[::-1],
    w_lo[::-1] of the reference's _overlap_add)."""
    half = OVERLAP // 2
    w_lo = modes.WINDOW[:half].astype(np.float32)
    w_hi = modes.WINDOW[OVERLAP - 1 : half - 1 : -1].astype(np.float32)
    return np.stack([w_lo, w_hi, w_hi[::-1], w_lo[::-1]])


@functools.lru_cache(maxsize=None)
def _unpack_index(w_bits: int) -> np.ndarray:
    """[3, 960] per-coefficient (word, next word, shift) of a W-bit packed
    band-shape row (see _unpack_pw)."""
    nw = 30 * w_bits
    bit = w_bits * np.arange(960)
    widx = bit >> 5
    return np.stack([widx, np.minimum(widx + 1, nw - 1), bit & 31]).astype(np.int64)
