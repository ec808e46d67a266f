"""The Opus repacketizer, a copy of opus_tpu.repacketizer.

Merges the frames of packets into one packet, splits them out again and
pads packets.  The Encoder builds multi-frame packets with it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

from .errors import BadArguments, BufferTooSmall, InvalidPacket
from .packet import MAX_FRAME_BYTES, parse_packet, query_packet_samples_per_frame
from .types import SamplingRate

_MAX_FRAMES = 48


def _encode_size(size: int) -> bytes:
    if size < 252:
        return bytes([size])
    return bytes([252 + (size & 0x3), (size - 252) >> 2])


class Repacketizer:
    """Frame collector/re-framer (opus_repacketizer analog)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.toc = 0
        self.frames: list[bytes] = []
        self.framesize = 0

    @property
    def nb_frames(self) -> int:
        return len(self.frames)

    def cat(self, packet: bytes, self_delimited: bool = False) -> None:
        """Append all frames of ``packet`` (must match prior config)."""
        if not packet:
            raise InvalidPacket("empty packet")
        if not self.frames:
            self.toc = packet[0]
            self.framesize = query_packet_samples_per_frame(packet, SamplingRate.HZ_48000)
        elif (self.toc & 0xFC) != (packet[0] & 0xFC):
            raise InvalidPacket("incompatible ToC for repacketizing")
        parsed = parse_packet(packet, self_delimited)
        if len(self.frames) + parsed.frame_count > _MAX_FRAMES:
            raise BufferTooSmall("more than 48 frames")
        dur = (len(self.frames) + parsed.frame_count) * self.framesize
        if dur > 5760:
            raise InvalidPacket("repacketized duration exceeds 120 ms")
        self.frames.extend(parsed.frames(packet))

    def out_range(
        self,
        begin: int,
        end: int,
        maxlen: int = 65535,
        self_delimited: bool = False,
        pad_to: int | None = None,
    ) -> bytes:
        """Emit frames [begin, end) as one packet (opus_repacketizer_out_range)."""
        if not (0 <= begin < end <= len(self.frames)):
            raise BadArguments("invalid frame range")
        frames = self.frames[begin:end]
        count = len(frames)
        sizes = [len(f) for f in frames]
        if any(s > MAX_FRAME_BYTES for s in sizes):
            raise InvalidPacket("frame exceeds 1275 bytes")

        cbr = count > 1 and len(set(sizes)) == 1
        if count == 1:
            header = bytes([(self.toc & 0xFC) | 0])
            body = b""
        elif count == 2 and cbr:
            header = bytes([(self.toc & 0xFC) | 1])
            body = b""
        elif count == 2:
            header = bytes([(self.toc & 0xFC) | 2]) + _encode_size(sizes[0])
            body = b""
        else:
            vbr_bit = 0 if cbr else 0x80
            header = bytes([(self.toc & 0xFC) | 3, vbr_bit | count])
            body = b"" if cbr else b"".join(_encode_size(s) for s in sizes[:-1])

        tail = _encode_size(sizes[-1]) if self_delimited else b""
        out = header + body + tail + b"".join(frames)

        if pad_to is not None and pad_to > len(out):
            out = self._pad(out, pad_to)
        if len(out) > maxlen:
            raise BufferTooSmall("repacketized output exceeds maxlen")
        return out

    def out(self, maxlen: int = 65535, self_delimited: bool = False) -> bytes:
        return self.out_range(0, len(self.frames), maxlen, self_delimited)

    @staticmethod
    def _pad(packet: bytes, target: int) -> bytes:
        """Grow a packet with code-3 padding (opus_packet_pad semantics)."""
        if target <= len(packet):
            return packet
        parsed = parse_packet(packet)
        rp = Repacketizer()
        rp.cat(packet)
        # Re-emit as code 3 with explicit padding bytes.
        frames = rp.frames
        count = len(frames)
        sizes = [len(f) for f in frames]
        cbr = len(set(sizes)) == 1
        header = bytearray([(packet[0] & 0xFC) | 3, (0 if cbr else 0x80) | 0x40 | count])
        body = b"" if cbr else b"".join(_encode_size(s) for s in sizes[:-1])
        payload = b"".join(frames)
        base_len = len(header) + len(body) + len(payload)
        # Padding length field: chain of 255s plus remainder; each 255 adds
        # 254 pad bytes plus its own byte.
        pad_data = target - base_len - 1
        if pad_data < 0:
            raise BadArguments("cannot pad below current size")
        pad_field = b""
        remaining = pad_data
        while remaining >= 255:
            pad_field += b"\xff"
            remaining -= 254
        pad_field += bytes([remaining])
        pad_zeros = target - base_len - len(pad_field)
        return bytes(header) + pad_field + body + payload + b"\x00" * pad_zeros
