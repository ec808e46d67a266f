"""The Opus packet layer (RFC 6716 sec. 3), a copy of opus_tpu.packet.

ToC queries and the framing parse, with the self-delimited form that
every elementary stream of a multistream packet but the last uses (RFC
6716 appendix B).  The scalar Decoder, the repacketizer, the multistream
codec and the CLI use it, and so do the serving loops' ToC parse
(batch/opus_pipeline.py) and the multistream splitter
(batch/multistream_pipeline.py).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import dataclasses

from .errors import InvalidPacket
from .types import BANDWIDTH_TABLE, Bandwidth, Channels, CodecMode, SamplingRate

#: Maximum number of frames in one packet (RFC 6716 sec. 3.2.5).
MAX_FRAMES_PER_PACKET = 48

#: Maximum size of a single compressed frame in bytes (RFC 6716 sec. 3.4).
MAX_FRAME_BYTES = 1275

#: Maximum duration of one packet in 48 kHz samples (120 ms).
MAX_PACKET_SAMPLES_48K = 5760


def query_packet_bandwidth(packet: bytes) -> Bandwidth:
    """Audio bandwidth from the ToC byte (reference: lib.rs:219-224)."""
    if not packet:
        raise InvalidPacket("empty packet")
    return BANDWIDTH_TABLE[(packet[0] & 0xF8) >> 3]


def query_packet_channel_count(packet: bytes) -> Channels:
    """Channel count from ToC bit 2 (reference: lib.rs:233-241)."""
    if not packet:
        raise InvalidPacket("empty packet")
    return Channels.STEREO if packet[0] & 0x4 else Channels.MONO


def query_packet_frame_count(packet: bytes) -> int:
    """Number of frames from the framing code (reference: lib.rs:250-263)."""
    if not packet:
        raise InvalidPacket("empty packet")
    code = packet[0] & 0x3
    if code == 0:
        return 1
    if code != 3:
        return 2
    if len(packet) < 2:
        raise InvalidPacket("code-3 packet without count byte")
    return packet[1] & 0x3F


def query_packet_samples_per_frame(packet: bytes, sampling_rate: SamplingRate | int) -> int:
    """Samples per frame from the ToC config bits (reference: lib.rs:271-289)."""
    rate = int(sampling_rate)
    toc = packet[0]
    if toc & 0x80:
        # CELT-only: 2.5/5/10/20 ms.
        return (rate << ((toc >> 3) & 0x3)) // 400
    if (toc & 0x60) == 0x60:
        # Hybrid: 10 or 20 ms.
        return rate // 50 if toc & 0x08 else rate // 100
    # SILK-only: 10/20/40/60 ms.
    size_code = (toc >> 3) & 0x3
    if size_code == 3:
        return rate * 60 // 1000
    return (rate << size_code) // 100


def query_packet_sample_count(packet: bytes, sampling_rate: SamplingRate | int) -> int:
    """Total samples in a packet, capped at 120 ms (reference: lib.rs:299-310)."""
    count = query_packet_frame_count(packet)
    samples = count * query_packet_samples_per_frame(packet, sampling_rate)
    if samples * 25 > int(sampling_rate) * 3:
        raise InvalidPacket("packet longer than 120 ms")
    return samples


def query_packet_codec_mode(packet: bytes) -> CodecMode:
    """Coding layer from the ToC top bits (reference: lib.rs:317-325)."""
    toc = packet[0]
    if toc & 0x80:
        return CodecMode.CELT_ONLY
    if (toc & 0x60) == 0x60:
        return CodecMode.HYBRID
    return CodecMode.SILK_ONLY


def parse_size(data: bytes) -> tuple[int, int]:
    """Decode a 1-2 byte frame length field (reference: lib.rs:500-512).

    Returns ``(size, bytes_consumed)``.
    """
    if not data:
        raise InvalidPacket("missing frame size byte")
    if data[0] < 252:
        return data[0], 1
    if len(data) < 2:
        raise InvalidPacket("truncated two-byte frame size")
    return 4 * data[1] + data[0], 2


@dataclasses.dataclass(frozen=True)
class ParsedPacket:
    """Result of :func:`parse_packet`.

    ``frame_offsets[i]``/``frame_sizes[i]`` delimit frame ``i`` inside the
    original packet buffer (the frames are not copied, mirroring the
    reference's offset-returning API, lib.rs:334).
    """

    toc: int
    frame_offsets: tuple[int, ...]
    frame_sizes: tuple[int, ...]
    payload_offset: int
    packet_offset: int

    @property
    def frame_count(self) -> int:
        return len(self.frame_sizes)

    def frames(self, packet: bytes) -> list[bytes]:
        """Materialise the frame payloads from the packet buffer."""
        return [
            packet[off : off + size]
            for off, size in zip(self.frame_offsets, self.frame_sizes)
        ]


def parse_packet(packet: bytes, self_delimited: bool = False) -> ParsedPacket:
    """Split an Opus packet into frames (reference: lib.rs:345-498).

    Implements RFC 6716 sec. 3.2 framing: codes 0-3, CBR/VBR, padding
    run-length chains and the optional self-delimited final length used by
    multistream packets.  Raises :class:`InvalidPacket` on malformed input.
    """
    if not packet:
        raise InvalidPacket("empty packet")

    framesize = query_packet_samples_per_frame(packet, SamplingRate.HZ_48000)
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
        size0, consumed = parse_size(packet[offset:])
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
                size_i, consumed = parse_size(packet[offset:])
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
        final_size, consumed = parse_size(packet[offset:])
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
