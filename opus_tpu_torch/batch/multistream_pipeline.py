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
  its packed or plan serving loop.  Each elementary packet's ToC gives
  its stream's CELT end band for that frame, as libopus's
  opus_decode_frame sets CELT_SET_END_BAND from the bandwidth (NB 13, WB
  17, SWB 19, FB 21): an RFC 7845 surround session codes its LFE as CELT
  NB.  A packet that is not CELT-only is refused, naming its session and
  stream;
* mode="opus": SILK, hybrid or mixed elementary streams through the
  mixed-mode BatchedOpusDecoder.

serve() leaves the sessions' PCM on the device, in `_serve_ring` [B,
frame, channels]; decode_frames() returns it to the host.

A multi-frame elementary packet (codes 1-3) is decoded as successive
steps of one frame: the framing code never enters the decoder state, so
per-frame code-0 packets decode as the original does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..packet import MAX_FRAME_BYTES, parse_packet
from .opus_pipeline import BatchedOpusDecoder
from .pipeline import BatchedCeltDecoder

MODES = ("celt", "opus")

#: CELT end band by the bandwidth of a CELT-only ToC, (config - 16) >> 2:
#: NB, WB, SWB, FB (libopus opus_decode_frame; CELT has no MB)
CELT_END_BANDS = np.array([13, 17, 19, 21], np.int32)


def split_multistream_packet(packet: bytes, streams: int) -> list[tuple[int, list[bytes]]]:
    """Split one multistream packet -> per stream (toc_byte, [frames...]).

    Self-delimited framing for all but the last stream; every framing
    code (0-3, CBR/VBR, padding) is accepted — multi-frame packets come
    back as per-frame lists.  A code-0 elementary packet (one frame, as
    libopus's multistream encoder writes 20 ms) is read in place; any
    other, or one whose length does not fit, goes to parse_packet, which
    reads or refuses it."""
    out = []
    offset = 0
    for s in range(streams):
        self_delimited = s < streams - 1
        one = _single_frame(packet, offset, self_delimited)
        if one is not None:
            out.append((packet[offset], [one[0]]))
            offset = one[1]
            continue
        parsed = parse_packet(packet[offset:], self_delimited)
        frames = parsed.frames(packet[offset:])
        out.append((packet[offset], list(frames)))
        offset += parsed.packet_offset
    return out


def _single_frame(packet: bytes, at: int, self_delimited: bool):
    """(frame, offset after it) of the elementary packet at `at` where it
    is code 0: its ToC, then, self-delimited, a one- or two-byte length
    (RFC 6716 sec. 3.2.1, appendix B), else the rest of the packet; None
    where it is not code 0 or its length does not fit."""
    end = len(packet)
    if at >= end or packet[at] & 3:
        return None
    if not self_delimited:
        return (packet[at + 1:], end) if end - at - 1 <= MAX_FRAME_BYTES else None
    if at + 2 > end:
        return None
    n, head = packet[at + 1], at + 2
    if n >= 252:
        if head >= end:
            return None
        n, head = n + 4 * packet[head], head + 1
    return (packet[head:head + n], head + n) if head + n <= end else None


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
        # Output channel -> (stream, left/right) of the [B*S, n, 2]
        # elementary plane: a coupled pair's m-th channel is stream m >> 1,
        # side m & 1; a mono stream's only channel is its left.
        self._cols = np.zeros(channels, np.int64)
        for ch, m in enumerate(self.mapping):
            if m == 255:
                continue
            stream, lr = (m >> 1, m & 1) if m < 2 * coupled else (coupled + m - 2 * coupled, 0)
            self._cols[ch] = 2 * stream + lr
        self._silent = torch.as_tensor([m == 255 for m in self.mapping], device=self.device)
        self._any_silent = 255 in self.mapping
        self._unmap_at: dict = {}
        #: each elementary row's coded channels: stereo for a coupled stream
        self._schs = np.tile(np.where(np.arange(streams) < coupled, 2, 1), batch).astype(np.int32)
        self._serve_ring = None

    def _split_batch(self, packets: list[bytes]):
        """-> (ToCs [B*S], frames: for each frame f, the B*S elementary
        frames f, in session then stream order) with a uniform frame
        count."""
        if len(packets) != self.batch:
            raise ValueError(f"{len(packets)} packets for a batch of {self.batch}")
        per_session = [split_multistream_packet(p, self.streams) for p in packets]
        nf = len(per_session[0][0][1])
        for sess in per_session:
            for _, frames in sess:
                if len(frames) != nf:
                    raise ValueError("elementary streams disagree on frame count")
        return ([toc for sess in per_session for toc, _ in sess],
                [[frames[f] for sess in per_session for _, frames in sess] for f in range(nf)])

    def _unmap_index(self, n: int) -> torch.Tensor:
        """The flat position in the [B*S, n, 2] elementary plane of every
        output sample [B, n, channels], made once a frame length."""
        if n not in self._unmap_at:
            S = self.streams
            at = (np.arange(self.batch)[:, None, None] * (S * n * 2)
                  + np.arange(n)[None, :, None] * 2
                  + ((self._cols >> 1) * (n * 2) + (self._cols & 1))[None, None, :])
            self._unmap_at[n] = torch.as_tensor(at.reshape(-1), device=self.device)
        return self._unmap_at[n]

    def unmap_on_device(self, pcm: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """[B*S, n, 2] -> [B, n, channels] on the device (into `out` where
        given): one gather of the mapped samples, silent channels 0."""
        n = pcm.shape[1]
        if out is None:
            out = pcm.new_empty(self.batch, n, self.channels)
        torch.index_select(pcm.reshape(-1), 0, self._unmap_index(n), out=out.view(-1))
        return out.masked_fill_(self._silent, 0.0) if self._any_silent else out

    @staticmethod
    def _full_packets(tocs: list, frames: list) -> list:
        """One frame of every (session, stream) as a standard code-0
        packet: the framing code is transport-only, so per-frame code-0
        packets decode identically to the original multi-frame packet."""
        return [bytes([toc & 0xFC]) + frame for toc, frame in zip(tocs, frames)]

    def _end_bands(self, tocs: list) -> np.ndarray:
        """Each (session, stream)'s CELT end band, int32 [B*S], from its
        ToC; a ToC that is not CELT-only raises ValueError."""
        config = np.array(tocs, np.int32) >> 3
        bad = np.flatnonzero(config < 16)
        if bad.size:
            i = int(bad[0])
            raise ValueError(f"session {i // self.streams} stream {i % self.streams}: ToC "
                             f"config {config[i]} is not CELT-only; mode='celt' decodes CELT-only "
                             f"elementary streams, mode='opus' SILK and hybrid ones")
        return CELT_END_BANDS[(config - 16) >> 2]

    def decode_frames(self, packets: list[bytes], frame_size: int) -> np.ndarray:
        """packets: one multistream packet per session; frame_size = samples
        per FRAME (multi-frame packets return nf*frame_size samples).
        Returns pcm [batch, nf*frame_size, channels]."""
        tocs, per_frame = self._split_batch(packets)
        end_bands = self._end_bands(tocs) if self.mode == "celt" else None
        outs = []
        for frames in per_frame:
            if self.mode == "opus":
                pcm = self.core.decode_frames_on_device(self._full_packets(tocs, frames))
            else:
                pcm = self.core.decode_frames_on_device(
                    frames, frame_size, stream_channels=self._schs, end_bands=end_bands)
            outs.append(self.unmap_on_device(pcm).cpu().numpy())
        return np.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]

    def serve(self, batches: list[list[bytes]], frame_size: int) -> np.ndarray:
        """Serving loop over multistream sessions: each step splits every
        session's packet into its elementary payloads (and, on the CELT
        core, each stream's end band from its ToC) and serves the
        (B*S)-stream batch through the core's serve() (one upload and one
        serving step per frame).  Multi-frame packets become successive
        serving steps.  The final step's PCM is then un-mapped on the
        device into `_serve_ring` [batch, frame_size, channels], in place,
        and complete when serve() returns; nothing is fetched to the host.
        Returns the core's digest of the final step.  The tracer's spans:
        `split` (the packets into elementary payloads), the core's serve()
        tree, `unmap` (the gather and its wait)."""
        steps, end_bands = [], []
        with trace.span("split", step=self.core.steps_served):
            for packets in batches:
                tocs, per_frame = self._split_batch(packets)
                if self.mode == "opus":
                    steps += [self._full_packets(tocs, frames) for frames in per_frame]
                else:
                    steps += per_frame
                    end_bands += [self._end_bands(tocs)] * len(per_frame)
        if self.mode == "opus":
            digest = self.core.serve(steps)
        else:
            digest = self.core.serve(steps, frame_size, stream_channels=self._schs,
                                     end_bands=end_bands)
        with trace.span("unmap", step=self.core.steps_served - 1):
            pcm = self.core._serve_ring
            ring = self._serve_ring
            if ring is None or ring.shape[1] != pcm.shape[1]:
                ring = self._serve_ring = pcm.new_empty(self.batch, pcm.shape[1], self.channels)
            self.unmap_on_device(pcm, out=ring)
            if ring.is_cuda:
                torch.cuda.current_stream(ring.device).synchronize()
        return digest

    def final_ranges(self) -> list[int]:
        """Per-session XOR of elementary final ranges (opus multistream)."""
        elem = self.core.final_ranges()
        S = self.streams
        return [int(np.bitwise_xor.reduce(elem[i * S : (i + 1) * S])) for i in range(self.batch)]
