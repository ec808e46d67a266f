"""Replay tracing of the range coder, a copy of opus_tpu.rc.trace.

Records the symbols a RangeDecoder reads and replays them through a
RangeEncoder, to check that a decoded stream re-encodes to the same bytes.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

from .decoder import RangeDecoder
from .encoder import RangeEncoder


class TracingRangeDecoder(RangeDecoder):
    """RangeDecoder recording (op, args, result) tuples + tell_frac."""

    def __init__(self, buf: bytes):
        self.ops: list[tuple] = []
        self._nested = False
        super().__init__(buf)

    def decode(self, ft):
        fs = super().decode(ft)
        self._pending = ("decode", ft)
        return fs

    def decode_bin(self, bits):
        fs = super().decode_bin(bits)
        self._pending = ("decode_bin", bits)
        return fs

    def update(self, fl, fh, ft):
        r = super().update(fl, fh, ft)
        if not self._nested:
            self.ops.append(("update", (fl, fh, ft), None, self.tell_frac_safe()))
        return r

    def decode_bit_logp(self, logp):
        r = super().decode_bit_logp(logp)
        self.ops.append(("bit_logp", (logp,), int(r), self.tell_frac_safe()))
        return r

    def decode_icdf(self, icdf, ftb):
        r = super().decode_icdf(icdf, ftb)
        self.ops.append(("icdf", (tuple(icdf), ftb), r, self.tell_frac_safe()))
        return r

    def decode_uint(self, ft):
        self._nested = True
        try:
            r = super().decode_uint(ft)
        finally:
            self._nested = False
        self.ops.append(("uint", (ft,), r, self.tell_frac_safe()))
        return r

    def decode_bits(self, bits):
        r = super().decode_bits(bits)
        if not self._nested:
            self.ops.append(("bits", (bits,), r, self.tell_frac_safe()))
        return r

    def tell_frac_safe(self):
        return self.tell_frac()


def replay(ops, size: int) -> bytes:
    """Re-encode a recorded op list; returns the produced byte stream."""
    buf = bytearray(size)
    enc = RangeEncoder(buf)
    for op, args, result, _tell in ops:
        if op == "update":
            fl, fh, ft = args
            enc.encode(fl, fh, ft)
        elif op == "bit_logp":
            enc.encode_bit_logp(result, args[0])
        elif op == "icdf":
            enc.encode_icdf(result, args[0], args[1])
        elif op == "uint":
            enc.encode_uint(result, args[0])
        elif op == "bits":
            enc.encode_bits(result, args[0])
    enc.done()
    return bytes(buf)


def first_divergence(ops, data: bytes):
    """Compare a replay against the original frame; returns (byte_index,
    op_index_estimate) of the first mismatch, or None if identical."""
    out = replay(ops, len(data))
    for i, (a, b) in enumerate(zip(out, data)):
        if a != b:
            # Find the op whose tell covers this byte position.
            for j, (_, _, _, tf) in enumerate(ops):
                if tf >= 8 * (i + 1) * 8:  # tell_frac in 1/8 bits
                    return i, j
            return i, len(ops)
    return None
