"""Transition crossfades on the mixed serving ring (the port of
opus_tpu.dsp.transitions; the scalar decoder's _smooth_fade semantics,
decoder.rs:833-865).

Plane A reports per-stream transition events, and the host supplies the
5 ms correction PCM (plane A's SILK PLC row of a SILK/hybrid -> CELT
switch); the windowed fades are written into the device PCM ring after the
serving step, so the host never downloads the ring:

kind 0 (head): ring[:120] = corr[:120];
               ring[120:240] = w2*ring + (1-w2)*corr[120:240]
kind 1 (tail): ring[-120:] = w2*corr[120:240] + (1-w2)*ring[-120:]

with w2 = WINDOW^2 at 48 kHz (2.5 ms = 120 samples).  The reference pads
the correction list to a few static sizes for XLA; here the rows are
indexed writes of exactly the corrected streams.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..celt import modes
from .tables import on_device

F2_5 = 120  # 2.5 ms at 48 kHz


@functools.lru_cache(maxsize=None)
def _fade() -> np.ndarray:
    """[120, 1] WINDOW^2 over the first 2.5 ms."""
    return (modes.WINDOW[:F2_5].astype(np.float64) ** 2).astype(np.float32)[:, None]


@torch.no_grad()
def apply_corrections(ring, corrs, frame48: int):
    """ring [B, frame48, C] on the device, updated in place and returned;
    corrs = [(stream, kind, pcm [240, C] f32)] from the host."""
    if not corrs:
        return ring
    C = ring.shape[2]
    dev = ring.device
    w2 = on_device(_fade, dev)
    rows = torch.as_tensor(np.stack([pcm[:240, :C] for _, _, pcm in corrs]), device=dev)
    idx = torch.as_tensor(np.array([i for i, _, _ in corrs], np.int64), device=dev)
    kinds = np.array([k for _, k, _ in corrs])
    cur = ring.index_select(0, idx)  # every fade reads the ring before any write
    head = torch.cat([rows[:, :F2_5], w2 * cur[:, F2_5 : 2 * F2_5] + (1.0 - w2) * rows[:, F2_5:]],
                     dim=1)
    tail = w2 * rows[:, F2_5:] + (1.0 - w2) * cur[:, frame48 - F2_5 :]
    for kind, new, lo in ((0, head, 0), (1, tail, frame48 - F2_5)):
        sel = np.flatnonzero(kinds == kind)
        if sel.size:
            pick = torch.as_tensor(sel, device=dev)
            ring[idx[pick], lo : lo + new.shape[1]] = new.index_select(0, pick)
    return ring
