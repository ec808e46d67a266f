"""The batched CELT music encoder's device plane (the port of
opus_tpu/dsp/encode_exec.py): analyze and PVQ search steps.

The host plane (celt/plan_encoder.py) takes the frame's decisions and
range-codes it from what this module computes for the whole batch:

* `make_encode_analyze`: pre-emphasis, the forward MDCT as one
  [B*C, N+OV] x [N+OV, N2] product with a constant basis, band energies
  and unit-normalised bands (each a product with the band one-hot), the
  dyadic cell stats (Ex, Ey, Exy over the finest spans the band walk's
  halving can visit), from which the host derives every itheta without
  the spectra, and the time-domain dots of the dual-stereo decision.
  Plain torch: `torch.matmul` in full float32 (TF32 off, set at package
  import), as the reference leaves these products to XLA at HIGHEST.
* `make_encode_search`: the host's leaf table searched on the device
  (dsp/pvq_search.py: one CUDA kernel launch on the card over the used
  leaves), the pulses packed in plan order as int16.

`forward_mdct_basis` and `cell_table` are the reference's numpy table
functions, unchanged, and the host plane reads `cell_table` from here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..celt import modes
from .pvq_search import pvq_search

OV = modes.OVERLAP
NB = modes.NB_E_BANDS
PREEMPH = float(modes.PREEMPH)


@functools.lru_cache(maxsize=None)
def forward_mdct_basis(n2: int) -> np.ndarray:
    """[N2+OV, N2] matrix equal to celt/mdct.py mdct_forward (f64 math,
    stored f32): out = in @ M."""
    n = 2 * n2
    pad = (n2 - OV) // 2
    w = np.zeros(n)
    win = modes.WINDOW.astype(np.float64)
    w[pad : pad + OV] = win
    w[pad + OV : pad + n2] = 1.0
    w[pad + n2 : pad + n2 + OV] = win[::-1]
    t = np.arange(n)
    k = np.arange(n2)
    # mdct_forward: z = FFT(xw * e^{-i pi t / n}); out = (2/n2) Re(tw_k z_k),
    # with the twist tw taken from the mdct module's table for exactness.
    from ..celt.mdct import _twists

    _, _, fwd_twist = _twists(n2)
    ph = np.exp(-2j * np.pi * np.outer(k, t) / n) * np.exp(-1j * np.pi * t / n)[None, :]
    M = (2.0 / n2) * np.real(fwd_twist[:, None] * ph) * w[None, :]
    # columns outside [pad, pad+n2+OV) multiply zeros — slice them off
    return np.ascontiguousarray(M[:, pad : pad + n2 + OV].T.astype(np.float32))


@functools.lru_cache(maxsize=None)
def cell_table(lm: int):
    """Static dyadic cell spans per band, mirroring quant_partition's
    halving recursion (n >>= 1, depth bounded by lm -> -1).  Returns
    (starts, lens, band_of_cell, cells_per_band_offsets)."""
    m = 1 << lm
    e = (modes.E_BANDS.astype(np.int64) * m).astype(np.int64)
    starts, lens, bands, offs = [], [], [], [0]

    def rec(off, n, l):
        if l < 0 or n <= 2:
            starts.append(off)
            lens.append(n)
            return
        h = n >> 1
        rec(off, h, l - 1)
        rec(off + h, h, l - 1)
        if off + 2 * h < off + n:  # odd n: the dropped tail sample(s)
            starts.append(off + 2 * h)
            lens.append(n - 2 * h)

    for i in range(NB):
        rec(int(e[i]), int(e[i + 1] - e[i]), lm)
        while len(starts) > len(bands):
            bands.append(i)
        offs.append(len(starts))
    return (np.asarray(starts, np.int32), np.asarray(lens, np.int32),
            np.asarray(bands, np.int32), np.asarray(offs, np.int32))


def _band_mask(lm: int, n: int) -> np.ndarray:
    """[NB, n] one-hot of the bands at frame size lm."""
    e = modes.E_BANDS.astype(np.int64) << lm
    mask = np.zeros((NB, n), np.float32)
    for i in range(NB):
        mask[i, e[i] : e[i + 1]] = 1.0
    return mask


def make_encode_analyze(lm: int, batch: int, channels: int, *, device):
    """analyze(pcm [B, N, C] float32 in +-1, in_mem [B, C, OV], preemph_mem
    [B, C]) -> (x [B, C, N2] unit-normalised bands, which stay on the
    device for the search, band_e [B, C, NB], cells [B, NC, 3], dots
    [B, 3], new in_mem, new preemph_mem), all float32 on `device`."""
    n = (1 << lm) * modes.SHORT_MDCT_SIZE
    M = torch.tensor(forward_mdct_basis(n), device=device)  # [N + OV, N2]
    starts, lens, _bands, _offs = cell_table(lm)
    pos = np.arange(n)[None, :]
    cell_mask = ((pos >= starts[:, None]) & (pos < (starts + lens)[:, None])
                 ).astype(np.float32)  # [NC, N2]
    cm_t = torch.tensor(cell_mask.T.copy(), device=device)  # [N2, NC]
    bm = torch.tensor(_band_mask(lm, n), device=device)  # [NB, N2]
    bm_t = bm.T.contiguous()
    B, C = batch, channels

    def analyze(pcm, in_mem, preemph_mem):
        x48 = pcm.to(torch.float32).transpose(1, 2) * 32768.0  # [B, C, N]
        prev = torch.cat([preemph_mem[..., None], x48[..., :-1]], dim=-1)
        pre = x48 - PREEMPH * prev
        new_pre = PREEMPH * x48[..., -1]
        bi = torch.cat([in_mem, pre], dim=-1)  # [B, C, OV + N]
        new_in = bi[..., n : n + OV].contiguous()
        freq = torch.matmul(bi.reshape(B * C, n + OV), M).reshape(B, C, n)
        be2 = torch.matmul(freq * freq, bm_t)  # [B, C, NB]
        band_e = torch.sqrt(1e-27 + be2)
        gain = 1.0 / (1e-27 + band_e)
        x = freq * torch.matmul(gain, bm)  # unit-normalised bands
        x0, x1 = x[:, 0], x[:, C - 1]
        stats = torch.stack([x0 * x0, x1 * x1, x0 * x1], dim=1)  # [B, 3, N2]
        cells = torch.matmul(stats, cm_t).transpose(1, 2)  # [B, NC, 3]
        a, b_ = pre[:, 0], pre[:, C - 1]
        dots = torch.stack([(a * a).sum(-1), (b_ * b_).sum(-1), (a * b_).sum(-1)], dim=-1)
        return x, band_e, cells, dots, new_in, new_pre

    return analyze


def make_encode_search(lm: int, batch: int, channels: int, p_max: int = 160,
                       n_max: int = 176, t_max: int = 128, *, device):
    """search(x [B, C, N2] from analyze, band_ops [B, NB, 4] float32,
    leaves [B, p_max, 4] int32, order) -> (iy [order.total] int16, left
    [B, p_max] int32): the greedy PVQ search of every used leaf, its pulses
    packed in plan order; order is the table's `leaf_order`
    (dsp/pvq_search.py, where the layouts are described)."""
    device = torch.device(device)

    def search(x, band_ops, leaves, order):
        if x.device.type != device.type:
            raise ValueError(f"x is on {x.device}, the search on {device}")
        if leaves.shape != (batch, p_max, 4) or x.shape[:2] != (batch, channels):
            raise ValueError(f"search of {batch} streams, {channels} channels, {p_max} "
                             f"leaves: got x {tuple(x.shape)}, leaves {tuple(leaves.shape)}")
        return pvq_search(x, band_ops, leaves, order, lm, n_max, t_max)

    return search
