"""Batched multistream decode on a torch device (the port of
opus_tpu.batch.multistream_pipeline).

A multistream packet (RFC 7845 channel mapping family 1) carries S
elementary Opus streams, all but the last self-delimited; decoding B
sessions is one batch of B*S elementary decodes through one of the port's
serving decoders, and the output channels are gathered from the
elementary streams on the device by the session's mapping.

Two cores:

* mode="celt": CELT-only elementary streams through BatchedCeltDecoder
  (stereo-shaped; a mono stream is decoded with stream_channels 1), on
  its packed or plan serving loop;
* mode="opus": SILK, hybrid or mixed elementary streams through the
  mixed-mode BatchedOpusDecoder.

A multi-frame elementary packet (codes 1-3) is decoded as successive
steps of one frame: the framing code never enters the decoder state, so
per-frame code-0 packets decode as the original does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..packet import parse_packet
from .opus_pipeline import BatchedOpusDecoder
from .pipeline import BatchedCeltDecoder

MODES = ("celt", "opus")


def split_multistream_packet(packet: bytes, streams: int) -> list[tuple[int, list[bytes]]]:
    """Split one multistream packet -> per stream (toc_byte, [frames...]).

    Self-delimited framing for all but the last stream; every framing
    code (0-3, CBR/VBR, padding) is accepted — multi-frame packets come
    back as per-frame lists."""
    out = []
    offset = 0
    for s in range(streams):
        self_delimited = s < streams - 1
        parsed = parse_packet(packet[offset:], self_delimited)
        frames = parsed.frames(packet[offset:])
        out.append((packet[offset], list(frames)))
        offset += parsed.packet_offset
    return out


class BatchedMultistreamDecoder:
    """Decode a batch of multistream sessions of one layout.

    Each session has `streams` elementary streams, the first `coupled` of
    them stereo, mapped to `channels` output channels by `mapping` (255 =
    a silent channel).  The core's transfer is set on `core.transfer`
    before the first step, as on BatchedCeltDecoder or BatchedOpusDecoder.
    """

    def __init__(self, batch: int, channels: int, streams: int, coupled: int,
                 mapping: list[int], mode: str = "celt", *, device):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if len(mapping) != channels:
            raise ValueError(f"{len(mapping)} mapping entries for {channels} channels")
        if not 0 <= coupled <= streams or any(m != 255 and m >= streams + coupled
                                              for m in mapping):
            raise ValueError(f"mapping {mapping} does not fit {streams} streams, "
                             f"{coupled} coupled")
        self.batch = batch
        self.channels = channels
        self.streams = streams
        self.coupled = coupled
        self.mapping = list(mapping)
        self.mode = mode
        self.device = torch.device(device)
        core = BatchedCeltDecoder if mode == "celt" else BatchedOpusDecoder
        self.core = core(batch * streams, 2, device=self.device)
        # Output channel -> column of the [B, n, S * 2] elementary plane
        # (stream s, left/right): a coupled pair's m-th channel is stream
        # m >> 1, side m & 1; a mono stream's only channel is its left.
        cols = np.zeros(channels, np.int64)
        for ch, m in enumerate(self.mapping):
            if m == 255:
                continue
            stream, lr = (m >> 1, m & 1) if m < 2 * coupled else (coupled + m - 2 * coupled, 0)
            cols[ch] = 2 * stream + lr
        self._cols = torch.as_tensor(cols, device=self.device)
        self._silent = torch.as_tensor([m == 255 for m in self.mapping], device=self.device)

    def _split_batch(self, packets: list[bytes]):
        """-> (n_frames, per_session split) with a uniform frame count."""
        if len(packets) != self.batch:
            raise ValueError(f"{len(packets)} packets for a batch of {self.batch}")
        per_session = [split_multistream_packet(p, self.streams) for p in packets]
        nf = len(per_session[0][0][1])
        for sess in per_session:
            for _, frames in sess:
                if len(frames) != nf:
                    raise ValueError("elementary streams disagree on frame count")
        return nf, per_session

    def unmap_on_device(self, pcm: torch.Tensor) -> torch.Tensor:
        """[B*S, n, 2] -> [B, n, channels] on the device: one gather of the
        mapped columns, silent channels 0."""
        B, S = self.batch, self.streams
        n = pcm.shape[1]
        plane = pcm.reshape(B, S, n, 2).permute(0, 2, 1, 3).reshape(B, n, 2 * S)
        return plane.index_select(2, self._cols).masked_fill(self._silent, 0.0)

    def _step_payloads(self, per_session, f: int):
        """Elementary inputs for frame f of every (session, stream)."""
        payloads, schs, fulls = [], [], []
        for sess in per_session:
            for s, (toc, frames) in enumerate(sess):
                if self.mode == "opus":
                    # Rebuild a standard code-0 packet: the framing code is
                    # transport-only, so per-frame code-0 packets decode
                    # identically to the original multi-frame packet.
                    fulls.append(bytes([toc & 0xFC]) + frames[f])
                else:
                    payloads.append(frames[f])
                    schs.append(2 if s < self.coupled else 1)
        return payloads, schs, fulls

    def decode_frames(self, packets: list[bytes], frame_size: int) -> np.ndarray:
        """packets: one multistream packet per session; frame_size = samples
        per FRAME (multi-frame packets return nf*frame_size samples).
        Returns pcm [batch, nf*frame_size, channels]."""
        nf, per_session = self._split_batch(packets)
        outs = []
        for f in range(nf):
            payloads, schs, fulls = self._step_payloads(per_session, f)
            if self.mode == "opus":
                pcm = self.core.decode_frames_on_device(fulls)
            else:
                pcm = self.core.decode_frames_on_device(
                    payloads, frame_size, stream_channels=np.array(schs, np.int32))
            outs.append(self.unmap_on_device(pcm).cpu().numpy())
        return np.concatenate(outs, axis=1) if nf > 1 else outs[0]

    def serve(self, batches: list[list[bytes]], frame_size: int) -> np.ndarray:
        """Serving loop over multistream sessions: each step splits every
        session's packet into its elementary payloads and serves the
        (B*S)-stream batch through the core's serve() (one upload and one
        serving step per frame).  Multi-frame packets become successive
        serving steps.  Returns the final step's un-mapped pcm [batch,
        frame_size, channels].  The tracer's spans: `split` (the packets
        into elementary payloads), the core's serve() tree, `unmap` (the
        gather and its fetch)."""
        schs = None
        elem_steps = []
        full_steps = []
        with trace.span("split", step=self.core.steps_served):
            for packets in batches:
                nf, per_session = self._split_batch(packets)
                for f in range(nf):
                    payloads, sch, fulls = self._step_payloads(per_session, f)
                    if self.mode == "opus":
                        full_steps.append(fulls)
                    else:
                        elem_steps.append(payloads)
                        if schs is None:
                            schs = np.array(sch, np.int32)
        if self.mode == "opus":
            self.core.serve(full_steps)
        else:
            self.core.serve(elem_steps, frame_size, stream_channels=schs)
        with trace.span("unmap", step=self.core.steps_served - 1):
            return self.unmap_on_device(self.core._serve_ring).cpu().numpy()

    def final_ranges(self) -> list[int]:
        """Per-session XOR of elementary final ranges (opus multistream)."""
        elem = self.core.final_ranges()
        S = self.streams
        return [int(np.bitwise_xor.reduce(elem[i * S : (i + 1) * S])) for i in range(self.batch)]
