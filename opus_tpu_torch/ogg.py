"""The Ogg Opus container (RFC 7845), a copy of opus_tpu.ogg.

OpusHead, OggOpusWriter, OggOpusReader and the Ogg page CRC.  The CLI
reads and writes files with it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import dataclasses
import struct

from .errors import InvalidPacket

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if r & 0x80000000 else (r << 1) & 0xFFFFFFFF
            table.append(r)
        _CRC_TABLE = table
    return _CRC_TABLE


def ogg_crc(data: bytes) -> int:
    """Ogg page checksum: CRC-32/BZIP-style, poly 0x04c11db7, init 0."""
    table = _crc_table()
    r = 0
    for b in data:
        r = ((r << 8) & 0xFFFFFFFF) ^ table[((r >> 24) & 0xFF) ^ b]
    return r


@dataclasses.dataclass(frozen=True)
class OpusHead:
    """RFC 7845 §5.1 identification header."""

    channels: int
    pre_skip: int = 312
    input_sample_rate: int = 48000
    output_gain_q8: int = 0
    mapping_family: int = 0
    streams: int = 1
    coupled: int = 1
    mapping: tuple[int, ...] = ()

    def to_bytes(self) -> bytes:
        head = b"OpusHead" + struct.pack(
            "<BBHIhB", 1, self.channels, self.pre_skip, self.input_sample_rate,
            self.output_gain_q8, self.mapping_family,
        )
        if self.mapping_family != 0:
            head += struct.pack("<BB", self.streams, self.coupled) + bytes(self.mapping)
        return head

    @classmethod
    def from_bytes(cls, data: bytes) -> "OpusHead":
        if data[:8] != b"OpusHead":
            raise InvalidPacket("missing OpusHead")
        version, ch, pre_skip, rate, gain, family = struct.unpack("<BBHIhB", data[8:19])
        if version >> 4 != 0:
            raise InvalidPacket("unsupported OpusHead version")
        if family == 0:
            return cls(ch, pre_skip, rate, gain, 0, 1, 1 if ch == 2 else 0, tuple(range(ch)))
        streams, coupled = data[19], data[20]
        mapping = tuple(data[21 : 21 + ch])
        return cls(ch, pre_skip, rate, gain, family, streams, coupled, mapping)


def _page(serial: int, pageno: int, granule: int, header_type: int, segments: list[bytes], lacing: list[int]) -> bytes:
    header = struct.pack(
        "<4sBBqIIIB", b"OggS", 0, header_type, granule, serial, pageno, 0, len(lacing)
    ) + bytes(lacing)
    body = b"".join(segments)
    page = bytearray(header + body)
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def _lace(packet: bytes) -> list[int]:
    lacing = [255] * (len(packet) // 255)
    lacing.append(len(packet) % 255)
    return lacing


class OggOpusWriter:
    """Write an .opus (Ogg Opus) stream: header pages then audio pages."""

    def __init__(self, fileobj, head: OpusHead, vendor: str = "opus_tpu", serial: int = 0x6F707573):
        self.f = fileobj
        self.head = head
        self.serial = serial
        self.pageno = 0
        self.granule = 0
        self._pending: list[bytes] = []
        self._write_page([head.to_bytes()], 0, header_type=0x02)
        tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor.encode() + struct.pack("<I", 0)
        self._write_page([tags], 0)

    def _write_page(self, packets: list[bytes], granule: int, header_type: int = 0) -> None:
        lacing: list[int] = []
        for p in packets:
            lacing.extend(_lace(p))
        if len(lacing) > 255:
            raise InvalidPacket("page lacing overflow")
        self.f.write(_page(self.serial, self.pageno, granule, header_type, packets, lacing))
        self.pageno += 1

    def write_packet(self, packet: bytes, samples_48k: int, end_of_stream: bool = False) -> None:
        """Append one Opus packet advancing the granule position."""
        self.granule += samples_48k
        lacing = _lace(packet)
        if len(lacing) > 255:
            raise InvalidPacket("packet too large for single page writer")
        self.f.write(
            _page(self.serial, self.pageno, self.granule, 0x04 if end_of_stream else 0, [packet], lacing)
        )
        self.pageno += 1
        if end_of_stream:
            self._eos = True

    def close(self) -> None:
        # Emit an empty EOS page only if the caller didn't flag the last
        # packet (a zero lacing value would otherwise read back as a
        # spurious empty packet).
        if not getattr(self, "_eos", False):
            self.f.write(_page(self.serial, self.pageno, self.granule, 0x04, [], [0]))
            self.pageno += 1
            self._eos = True


class OggOpusReader:
    """Parse an .opus stream into (OpusHead, packets[])."""

    def __init__(self, data: bytes):
        self.packets: list[bytes] = []
        self.granules: list[int] = []
        pos = 0
        partial = b""
        n_pages = 0
        while pos < len(data):
            idx = data.find(b"OggS", pos)
            if idx < 0:
                break
            if idx + 27 > len(data):
                break
            (magic, version, htype, granule, serial, pageno, crc, nsegs) = struct.unpack(
                "<4sBBqIIIB", data[idx : idx + 27]
            )
            lacing = data[idx + 27 : idx + 27 + nsegs]
            body_len = sum(lacing)
            total = 27 + nsegs + body_len
            page = bytearray(data[idx : idx + total])
            page[22:26] = b"\x00\x00\x00\x00"
            if ogg_crc(bytes(page)) != crc:
                raise InvalidPacket(f"ogg page {pageno} CRC mismatch")
            body = data[idx + 27 + nsegs : idx + total]
            if not (htype & 0x01):
                partial = b""
            off = 0
            for i, seg in enumerate(lacing):
                partial += body[off : off + seg]
                off += seg
                if seg < 255:
                    self.packets.append(partial)
                    self.granules.append(granule)
                    partial = b""
            pos = idx + total
            n_pages += 1
        if len(self.packets) < 2:
            raise InvalidPacket("not an Ogg Opus stream")
        self.head = OpusHead.from_bytes(self.packets[0])
        # packets[1] is OpusTags.
        self.audio_packets = [p for p in self.packets[2:] if p]
