"""The ToC layer the serving loops need (RFC 6716 sec. 3).

A copy of what `BatchedOpusDecoder._toc_arrays` and the multistream
splitter read from opus_tpu/packet.py and opus_tpu/types.py: the
bandwidth and codec-mode codes, the ToC queries and the framing parse,
with the self-delimited form that every elementary stream of a
multistream packet but the last uses (RFC 6716 appendix B).  It is copied
because the port imports nothing of opus_tpu; tests/test_torch_opus.py
and tests/test_torch_multistream.py hold it to the reference on real and
fuzzed packets.
"""

from __future__ import annotations

import dataclasses
import enum

#: Maximum duration of one packet in 48 kHz samples (120 ms).
MAX_PACKET_SAMPLES_48K = 5760
#: Maximum size of a single compressed frame in bytes (RFC 6716 sec. 3.4).
MAX_FRAME_BYTES = 1275


class InvalidPacket(ValueError):
    """A packet that RFC 6716 sec. 3 framing rejects."""


class Bandwidth(enum.IntEnum):
    """Audio bandwidth; the values are libopus' OPUS_BANDWIDTH_* codes."""

    NARROWBAND = 1101
    MEDIUMBAND = 1102
    WIDEBAND = 1103
    SUPERWIDEBAND = 1104
    FULLBAND = 1105


class CodecMode(enum.Enum):
    """Coding layer of a packet."""

    SILK_ONLY = enum.auto()
    HYBRID = enum.auto()
    CELT_ONLY = enum.auto()


#: ToC config (0..31) -> bandwidth: SILK NB/MB/WB (4 each), hybrid SWB/FB
#: (2 each), CELT NB/WB/SWB/FB (4 each).
BANDWIDTH_TABLE: tuple[Bandwidth, ...] = tuple(
    bw for count, bw in ((4, Bandwidth.NARROWBAND), (4, Bandwidth.MEDIUMBAND),
                         (4, Bandwidth.WIDEBAND), (2, Bandwidth.SUPERWIDEBAND),
                         (2, Bandwidth.FULLBAND), (4, Bandwidth.NARROWBAND),
                         (4, Bandwidth.WIDEBAND), (4, Bandwidth.SUPERWIDEBAND),
                         (4, Bandwidth.FULLBAND))
    for _ in range(count)
)


def query_packet_bandwidth(packet: bytes) -> Bandwidth:
    if not packet:
        raise InvalidPacket("empty packet")
    return BANDWIDTH_TABLE[(packet[0] & 0xF8) >> 3]


def query_packet_samples_per_frame(packet: bytes, sampling_rate: int) -> int:
    rate = int(sampling_rate)
    toc = packet[0]
    if toc & 0x80:  # CELT-only: 2.5/5/10/20 ms
        return (rate << ((toc >> 3) & 0x3)) // 400
    if (toc & 0x60) == 0x60:  # hybrid: 10 or 20 ms
        return rate // 50 if toc & 0x08 else rate // 100
    size_code = (toc >> 3) & 0x3  # SILK-only: 10/20/40/60 ms
    if size_code == 3:
        return rate * 60 // 1000
    return (rate << size_code) // 100


def query_packet_codec_mode(packet: bytes) -> CodecMode:
    toc = packet[0]
    if toc & 0x80:
        return CodecMode.CELT_ONLY
    if (toc & 0x60) == 0x60:
        return CodecMode.HYBRID
    return CodecMode.SILK_ONLY


def _parse_size(data: bytes) -> tuple[int, int]:
    """A 1-2 byte frame length field -> (size, bytes consumed)."""
    if not data:
        raise InvalidPacket("missing frame size byte")
    if data[0] < 252:
        return data[0], 1
    if len(data) < 2:
        raise InvalidPacket("truncated two-byte frame size")
    return 4 * data[1] + data[0], 2


@dataclasses.dataclass(frozen=True)
class ParsedPacket:
    toc: int
    frame_offsets: tuple[int, ...]
    frame_sizes: tuple[int, ...]
    payload_offset: int
    packet_offset: int

    @property
    def frame_count(self) -> int:
        return len(self.frame_sizes)

    def frames(self, packet: bytes) -> list[bytes]:
        """The frame payloads, sliced from the packet buffer."""
        return [packet[off : off + size]
                for off, size in zip(self.frame_offsets, self.frame_sizes)]


def parse_packet(packet: bytes, self_delimited: bool = False) -> ParsedPacket:
    """Split an Opus packet into frames: codes 0-3, CBR/VBR, padding and,
    with `self_delimited`, the explicit last-frame length of the
    self-delimited form (RFC 6716 sec. 3.2, appendix B); `packet_offset`
    is where the next packet starts.  Raises InvalidPacket on malformed
    input."""
    if not packet:
        raise InvalidPacket("empty packet")

    framesize = query_packet_samples_per_frame(packet, 48000)
    toc = packet[0]
    code = toc & 0x3
    offset = 1
    length = len(packet) - 1
    pad = 0
    cbr = False
    sizes: list[int] = []

    if code == 0:
        count = 1
        last_size = length
    elif code == 1:
        count = 2
        cbr = True
        last_size = length
        if not self_delimited:
            if length & 0x1:
                raise InvalidPacket("odd length for two CBR frames")
            last_size = length // 2
            sizes.append(last_size)
    elif code == 2:
        count = 2
        size0, consumed = _parse_size(packet[offset:])
        length -= consumed
        if size0 > length:
            raise InvalidPacket("VBR frame size exceeds packet")
        offset += consumed
        sizes.append(size0)
        last_size = length - size0
    else:
        # Code 3: arbitrary frame count with optional padding and VBR sizes.
        if length < 1:
            raise InvalidPacket("code-3 packet without count byte")
        ch = packet[offset]
        offset += 1
        length -= 1
        count = ch & 0x3F
        if count < 1 or framesize * count > MAX_PACKET_SAMPLES_48K:
            raise InvalidPacket("invalid code-3 frame count")

        if ch & 0x40:
            # Padding: run-length encoded with 255-chaining.
            p = 255
            while p == 255:
                if length <= 0:
                    raise InvalidPacket("truncated padding run")
                p = packet[offset]
                offset += 1
                length -= 1
                this_pad = 254 if p == 255 else p
                length -= this_pad
                pad += this_pad
            if length < 0:
                raise InvalidPacket("padding exceeds packet")

        cbr = not (ch & 0x80)
        if not cbr:
            last_size = length
            for _ in range(count - 1):
                size_i, consumed = _parse_size(packet[offset:])
                length -= consumed
                if size_i > length:
                    raise InvalidPacket("VBR frame size exceeds packet")
                offset += consumed
                sizes.append(size_i)
                last_size -= consumed + size_i
        else:
            last_size = length
            if not self_delimited:
                last_size, rem = divmod(length, count)
                if rem:
                    raise InvalidPacket("CBR payload not divisible by frame count")
                sizes.extend([last_size] * (count - 1))

    if self_delimited:
        final_size, consumed = _parse_size(packet[offset:])
        length -= consumed
        if final_size > length:
            raise InvalidPacket("self-delimited size exceeds packet")
        offset += consumed
        if cbr:
            if final_size * count > length:
                raise InvalidPacket("self-delimited CBR frames exceed packet")
            sizes = [final_size] * count
        else:
            if consumed + final_size > last_size:
                raise InvalidPacket("self-delimited final frame exceeds packet")
            sizes.append(final_size)
    else:
        # The implicit last-frame size may exceed the 1275-byte cap.
        if last_size > MAX_FRAME_BYTES:
            raise InvalidPacket("frame larger than 1275 bytes")
        sizes.append(last_size)

    assert len(sizes) == count
    payload_offset = offset
    frame_offsets = []
    for size in sizes:
        frame_offsets.append(offset)
        offset += size

    return ParsedPacket(
        toc=toc,
        frame_offsets=tuple(frame_offsets),
        frame_sizes=tuple(sizes),
        payload_offset=payload_offset,
        packet_offset=pad + offset,
    )
