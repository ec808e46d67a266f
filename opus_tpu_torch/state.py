"""Carry a decoder state between numpy and the port.

The tests start the reference and the port from one state: the reference's
SynthState is fetched with np.asarray, handed to `synth_state_from_numpy`,
and the port's state comes back through `synth_state_to_numpy`; the SILK
batch decoder's state (its LPC history on the device and each front end's
output history on the host) goes in through `load_silk_state` and comes
back through `silk_state_to_numpy`.  The batched music encoder's state
(its device memories and each stream's host encoder state) goes in
through `load_encode_state` and comes back through
`encode_state_to_numpy`.
"""

from __future__ import annotations

import copy

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


def load_silk_state(dec, lpc_hist, out_bufs) -> None:
    """Set a BatchedSilkDecoder's carried state: lpc_hist [B, order] (a
    copy lands on the decoder's device) and each front end's out_buf, the
    int16-scale output history its next frame reads."""
    dec.lpc_hist = torch.tensor(np.asarray(lpc_hist, np.float32), device=dec.device)
    for front, buf in zip(dec.fronts, out_bufs, strict=True):
        front.st.out_buf[:] = [int(v) for v in buf]


def silk_state_to_numpy(dec) -> tuple[np.ndarray, np.ndarray]:
    """A BatchedSilkDecoder's carried state on the host: (lpc_hist [B,
    order] float32, out_buf [B, ltp_mem_length] int64)."""
    return (dec.lpc_hist.cpu().numpy(),
            np.array([front.st.out_buf for front in dec.fronts], np.int64))


#: The host CeltEncoder's fields that carry across frames: the plan and
#: emit passes read old_band_e and frame_count; the overflow fallback,
#: which encodes a frame on the host, reads all of them.
ENCODE_HOST_FIELDS = ("old_band_e", "frame_count", "rng", "in_mem", "preemph_mem",
                      "prefilter_mem", "prefilter_period", "prefilter_gain",
                      "prefilter_tapset", "tapset_decision", "_prev_sub_energy")


def load_encode_state(enc, in_mem, pm, hosts) -> None:
    """Set a BatchedPlanEncoder's carried state: the device plane's memories
    in_mem [B, C, OVERLAP] and pm [B, C] (copies land on the encoder's
    device) and, a dict a stream, {"rng": the stream's final range,
    "host": {field: value for each of ENCODE_HOST_FIELDS of its host
    CeltEncoder}} (values copied)."""
    enc._in_mem = torch.tensor(np.asarray(in_mem, np.float32), device=enc.device)
    enc._pm = torch.tensor(np.asarray(pm, np.float32), device=enc.device)
    for plan, state in zip(enc.hosts, hosts, strict=True):
        plan.rng = int(state["rng"])
        for field in ENCODE_HOST_FIELDS:
            setattr(plan.host, field, copy.deepcopy(state["host"][field]))


def encode_state_to_numpy(enc) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """A BatchedPlanEncoder's carried state on the host, as
    `load_encode_state` takes it: (in_mem, pm, hosts)."""
    hosts = [{"rng": plan.rng,
              "host": {f: copy.deepcopy(getattr(plan.host, f)) for f in ENCODE_HOST_FIELDS}}
             for plan in enc.hosts]
    return enc._in_mem.cpu().numpy(), enc._pm.cpu().numpy(), hosts
