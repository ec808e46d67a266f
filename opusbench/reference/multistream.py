"""The Opus multistream decoder (RFC 7845 sec. 5.1.1), the decoder half
of `opus_tpu_torch/multistream.py` at commit cd2dea1, frozen.

A multistream packet carries one Opus packet for each elementary stream,
the first N - 1 self-delimited (RFC 6716 appendix B).  Each elementary
stream is decoded by a scalar `Decoder` of its own, stereo for the first
M (coupled) streams and mono for the rest, and the channel mapping places
the decoded channels on the output channels.  The final range is the XOR
of the elementary streams' ranges, as libopus's `OPUS_GET_FINAL_RANGE`
gives it for a multistream decoder.

Changes from the copied code: no encoder; the repacketizer is replaced by
`_regular_packet`, its framing of whole frames as one undelimited packet;
`decode_float` returns float64 where the port's `decode` rounds the
placed channels to float32; and `family_decoder` checks a channel
mapping family 1 layout (RFC 7845 sec. 5.1.1.2) before building one.
"""

from __future__ import annotations

import numpy as np

from .decoder import Decoder, DecoderConfiguration
from .errors import BadArguments, InvalidPacket
from .packet import MAX_FRAME_BYTES, parse_packet
from .types import Channels, SamplingRate

#: RFC 7845 sec. 5.1.1.2: channel mapping family 1 allows 1 to 8 channels,
#: in Vorbis order; the speaker of each channel index by channel count.
FAMILY1_SPEAKERS = {
    1: ("mono",),
    2: ("left", "right"),
    3: ("left", "center", "right"),
    4: ("front left", "front right", "rear left", "rear right"),
    5: ("front left", "front center", "front right", "rear left", "rear right"),
    6: ("front left", "front center", "front right", "rear left", "rear right", "LFE"),
    7: ("front left", "front center", "front right", "side left", "side right",
        "rear center", "LFE"),
    8: ("front left", "front center", "front right", "side left", "side right",
        "rear left", "rear right", "LFE"),
}


def family_decoder(layout: dict) -> "MultistreamDecoder":
    """A decoder to 48 kHz for `layout` ({"family", "channels", "streams",
    "coupled", "mapping"}), which has to be one that channel mapping
    family 1 defines: 1 to 8 channels, a mapping entry for each, every
    entry a decoded channel or 255 (silence)."""
    if layout.get("family") != 1:
        raise BadArguments(f"channel mapping family {layout.get('family')!r}: only family 1")
    channels = layout.get("channels")
    if channels not in FAMILY1_SPEAKERS:
        raise BadArguments(f"family 1 defines 1 to 8 channels, not {channels!r}")
    return MultistreamDecoder(SamplingRate.HZ_48000, channels, int(layout["streams"]),
                              int(layout["coupled"]), [int(m) for m in layout["mapping"]])


def _encode_size(size: int) -> bytes:
    if size < 252:
        return bytes([size])
    return bytes([252 + (size & 0x3), (size - 252) >> 2])


def _regular_packet(toc: int, frames: list) -> bytes:
    """Whole frames as one packet that is not self-delimited (the
    repacketizer's `out` over all its frames)."""
    count = len(frames)
    sizes = [len(f) for f in frames]
    if any(s > MAX_FRAME_BYTES for s in sizes):
        raise InvalidPacket("frame exceeds 1275 bytes")
    cbr = count > 1 and len(set(sizes)) == 1
    if count == 1:
        header = bytes([(toc & 0xFC) | 0])
    elif count == 2 and cbr:
        header = bytes([(toc & 0xFC) | 1])
    elif count == 2:
        header = bytes([(toc & 0xFC) | 2]) + _encode_size(sizes[0])
    else:
        header = bytes([(toc & 0xFC) | 3, (0 if cbr else 0x80) | count])
        header += b"" if cbr else b"".join(_encode_size(s) for s in sizes[:-1])
    return header + b"".join(frames)


class MultistreamDecoder:
    """Decode multistream packets to multichannel PCM."""

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
                out.append(_regular_packet(sub[0], parsed.frames(sub)))
                offset += parsed.packet_offset
        return out

    def decode_float(self, packet: bytes | None, frame_size: int) -> np.ndarray:
        """pcm [frame_size, channels] float64; a lost packet (None) is
        concealed in every elementary stream."""
        if packet is None:
            subs = [None] * self.streams
        else:
            subs = self._split(packet)
        decoded = []
        for s in range(self.streams):
            decoded.append(self.decoders[s].decode_float(subs[s], frame_size))
        n = decoded[0].shape[0]
        out = np.zeros((n, self.channels), dtype=np.float64)
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
