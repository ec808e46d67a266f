"""Carry a synthesis state between numpy and the port.

The tests start the reference and the port from one state: the reference's
SynthState is fetched with np.asarray, handed to `synth_state_from_numpy`,
and the port's state comes back through `synth_state_to_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp.synthesis import SynthState


def synth_state_from_numpy(mem, preemph, device, silk_hist=None) -> SynthState:
    """mem [B, C, DECODE_BUFFER_SIZE + OVERLAP], preemph [B, C] and, for
    mixed serving with the internal SILK transfer, the resampler tail
    silk_hist [B, C, TAIL] -> a new SynthState on `device` (copies: the
    port updates its state in place)."""

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return SynthState(mem=tensor(mem), preemph=tensor(preemph),
                      silk_hist=None if silk_hist is None else tensor(silk_hist))


def synth_state_to_numpy(state: SynthState) -> tuple[np.ndarray, ...]:
    """The state's arrays as float32 numpy arrays on the host, in the order
    of the reference's SynthState leaves: (mem, preemph), then silk_hist
    when the state carries one."""
    leaves = (state.mem, state.preemph, state.silk_hist)
    return tuple(t.cpu().numpy() for t in leaves if t is not None)
