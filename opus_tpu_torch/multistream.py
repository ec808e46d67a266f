"""The Opus multistream codec (RFC 7845 sec. 5.1.1), a copy of
opus_tpu.multistream.

MultistreamDecoder and MultistreamEncoder: coupled and uncoupled
elementary streams behind one channel mapping, one scalar Decoder or
Encoder each.  chip_smoke.py holds the batched multistream decoder to it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from .decoder import Decoder, DecoderConfiguration
from .encoder import Encoder, EncoderConfiguration
from .errors import BadArguments, InvalidPacket
from .packet import parse_packet
from .repacketizer import Repacketizer, _encode_size
from .types import Channels, SamplingRate


class MultistreamDecoder:
    """Decode multistream packets to interleaved multichannel PCM."""

    def __init__(
        self,
        sampling_rate: SamplingRate,
        channels: int,
        streams: int,
        coupled_streams: int,
        mapping: list[int],
    ):
        if not (0 < streams <= 255 and 0 <= coupled_streams <= streams and channels <= 255):
            raise BadArguments("invalid stream layout")
        if len(mapping) != channels:
            raise BadArguments("mapping length must equal channels")
        for m in mapping:
            if m != 255 and m >= coupled_streams * 2 + (streams - coupled_streams):
                raise BadArguments("mapping entry out of range")
        self.channels = channels
        self.streams = streams
        self.coupled = coupled_streams
        self.mapping = list(mapping)
        self.decoders = [
            Decoder(
                DecoderConfiguration(
                    sampling_rate,
                    Channels.STEREO if s < coupled_streams else Channels.MONO,
                )
            )
            for s in range(streams)
        ]

    def _split(self, packet: bytes) -> list[bytes]:
        """Split a multistream packet into per-stream packets."""
        out = []
        offset = 0
        for s in range(self.streams):
            final = s == self.streams - 1
            sub = packet[offset:]
            if not sub:
                raise InvalidPacket("truncated multistream packet")
            parsed = parse_packet(sub, self_delimited=not final)
            if final:
                out.append(sub)
            else:
                # Reconstruct a regular packet from the self-delimited one.
                frames = parsed.frames(sub)
                rp = Repacketizer()
                rp.toc = sub[0]
                from .packet import query_packet_samples_per_frame
                from .types import SamplingRate as SR

                rp.framesize = query_packet_samples_per_frame(sub, SR.HZ_48000)
                rp.frames = frames
                out.append(rp.out())
                offset += parsed.packet_offset
        return out

    def decode(self, packet: bytes | None, frame_size: int) -> np.ndarray:
        """Returns pcm [frame_size, channels] float32."""
        if packet is None:
            subs = [None] * self.streams
        else:
            subs = self._split(packet)
        decoded = []
        for s in range(self.streams):
            decoded.append(self.decoders[s].decode_float(subs[s], frame_size))
        n = decoded[0].shape[0]
        out = np.zeros((n, self.channels), dtype=np.float32)
        for ch, m in enumerate(self.mapping):
            if m == 255:
                continue
            if m < 2 * self.coupled:
                out[:, ch] = decoded[m >> 1][:, m & 1]
            else:
                out[:, ch] = decoded[self.coupled + (m - 2 * self.coupled)][:, 0]
        return out

    @property
    def final_range(self) -> int:
        r = 0
        for d in self.decoders:
            r ^= d.final_range
        return r & 0xFFFFFFFF


class MultistreamEncoder:
    """Encode multichannel PCM as one multistream packet (CELT mode)."""

    def __init__(
        self,
        sampling_rate: SamplingRate,
        channels: int,
        streams: int,
        coupled_streams: int,
        mapping: list[int],
        bitrate_per_stream: int = 96000,
    ):
        if len(mapping) != channels:
            raise BadArguments("mapping length must equal channels")
        self.channels = channels
        self.streams = streams
        self.coupled = coupled_streams
        self.mapping = list(mapping)
        self.encoders = [
            Encoder(
                EncoderConfiguration(
                    sampling_rate,
                    Channels.STEREO if s < coupled_streams else Channels.MONO,
                    bitrate_per_stream,
                )
            )
            for s in range(streams)
        ]

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm [N, channels] -> multistream packet."""
        n = pcm.shape[0]
        parts = []
        for s in range(self.streams):
            if s < self.coupled:
                chans = [None, None]
                for ch, m in enumerate(self.mapping):
                    if m == 2 * s:
                        chans[0] = pcm[:, ch]
                    elif m == 2 * s + 1:
                        chans[1] = pcm[:, ch]
                data = np.stack(
                    [c if c is not None else np.zeros(n, np.float32) for c in chans], -1
                )
            else:
                idx = 2 * self.coupled + (s - self.coupled)
                col = None
                for ch, m in enumerate(self.mapping):
                    if m == idx:
                        col = pcm[:, ch]
                data = (col if col is not None else np.zeros(n, np.float32))[:, None]
            parts.append(self.encoders[s].encode(data))
        # First S-1 packets become self-delimited.
        out = b""
        for s, pkt in enumerate(parts):
            if s == self.streams - 1:
                out += pkt
            else:
                parsed = parse_packet(pkt)
                assert parsed.frame_count == 1
                body = parsed.frames(pkt)[0]
                out += bytes([pkt[0]]) + _encode_size(len(body)) + body
        return out

    @property
    def final_range(self) -> int:
        r = 0
        for e in self.encoders:
            r ^= e.final_range
        return r & 0xFFFFFFFF
