"""Range encoder (RFC 6716 sec. 4.1), a copy of opus_tpu.rc.encoder.

Range-coded symbols are written front to back with carry buffering, raw
bits back to front.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

from .common import (
    CODE_BITS,
    CODE_BOT,
    CODE_SHIFT,
    CODE_TOP,
    SYM_BITS,
    SYM_MAX,
    UINT_BITS,
    WINDOW_SIZE,
    Tell,
    ilog,
)

_U32 = 0xFFFFFFFF


class RangeEncoder(Tell):
    """Sequential range encoder over one output frame buffer."""

    __slots__ = (
        "buf",
        "storage",
        "offs",
        "end_offs",
        "end_window",
        "nend_bits",
        "bits_total",
        "rng",
        "val",
        "ext",
        "rem",
        "error",
    )

    def __init__(self, buf: bytearray):
        self.buf = buf
        self.storage = len(buf)
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        # +1 for the spare carry bit.
        self.bits_total = CODE_BITS + 1
        self.rng = CODE_TOP
        self.val = 0
        self.ext = 0
        self.rem = -1
        self.error = False

    # -- byte IO -----------------------------------------------------------

    def _write_byte(self, value: int) -> None:
        if self.offs + self.end_offs >= self.storage:
            self.error = True
            return
        self.buf[self.offs] = value & 0xFF
        self.offs += 1

    def _write_byte_at_end(self, value: int) -> None:
        if self.offs + self.end_offs >= self.storage:
            self.error = True
            return
        self.end_offs += 1
        self.buf[self.storage - self.end_offs] = value & 0xFF

    def _carry_out(self, c: int) -> None:
        """Emit a finished symbol, propagating carries through 0xFF runs."""
        if c != SYM_MAX:
            carry = c >> SYM_BITS
            if self.rem >= 0:
                self._write_byte(self.rem + carry)
            if self.ext > 0:
                sym = (SYM_MAX + carry) & SYM_MAX
                while self.ext > 0:
                    self._write_byte(sym)
                    self.ext -= 1
            self.rem = c & SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self._carry_out(self.val >> CODE_SHIFT)
            self.val = (self.val << SYM_BITS) & (CODE_TOP - 1)
            self.rng = (self.rng << SYM_BITS) & _U32
            self.bits_total += SYM_BITS

    # -- primitive encoders --------------------------------------------------

    def encode(self, fl: int, fh: int, ft: int) -> None:
        """Encode a symbol with cumulative range [fl, fh) of total ft."""
        r = self.rng // ft
        if fl > 0:
            self.val = (self.val + (self.rng - r * (ft - fl))) & _U32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        """Like :meth:`encode` with ft = 1<<bits (division-free)."""
        r = self.rng >> bits
        if fl > 0:
            self.val = (self.val + (self.rng - r * ((1 << bits) - fl))) & _U32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << bits) - fh)
        self._normalize()

    def encode_bit_logp(self, bit: int, logp: int) -> None:
        """Encode one bit with P(1) = 2**-logp."""
        r = self.rng
        s = r >> logp
        r -= s
        if bit:
            self.val = (self.val + r) & _U32
        self.rng = s if bit else r
        self._normalize()

    def encode_icdf(self, symbol: int, icdf, ftb: int) -> None:
        """Encode a symbol from an inverse-CDF table scaled by 2**ftb."""
        r = self.rng >> ftb
        if symbol > 0:
            self.val = (self.val + (self.rng - r * icdf[symbol - 1])) & _U32
            self.rng = r * (icdf[symbol - 1] - icdf[symbol])
        else:
            self.rng -= r * icdf[symbol]
        self._normalize()

    def encode_uint(self, fl: int, ft: int) -> None:
        """Encode a uniform integer fl in [0, ft)."""
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft1 = (ft >> ftb) + 1
            fl1 = fl >> ftb
            self.encode(fl1, fl1 + 1, ft1)
            self.encode_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def encode_bits(self, fl: int, bits: int) -> None:
        """Write raw bits to the end of the buffer, backwards."""
        assert bits > 0
        window = self.end_window
        used = self.nend_bits
        if used + bits > WINDOW_SIZE:
            while used >= SYM_BITS:
                self._write_byte_at_end(window & SYM_MAX)
                window >>= SYM_BITS
                used -= SYM_BITS
        window |= fl << used
        used += bits
        self.end_window = window
        self.nend_bits = used
        self.bits_total += bits

    # -- finalisation ---------------------------------------------------------

    def patch_initial_bits(self, value: int, nbits: int) -> None:
        """Rewrite the first nbits of the stream after the fact
        (reference: encoder.rs:327-347); used for VAD/flag bits that are
        only known once the frame is fully coded."""
        assert nbits <= SYM_BITS
        shift = SYM_BITS - nbits
        mask = ((1 << nbits) - 1) << shift
        if self.offs > 0:
            # The first byte has been finalised: patch it in place.
            self.buf[0] = (self.buf[0] & ~mask & 0xFF) | (value << shift)
        elif self.rem >= 0:
            # Still buffered in the carry chain.
            self.rem = (self.rem & ~mask & 0xFF) | (value << shift)
        elif self.rng <= (CODE_TOP >> nbits):
            # Not even one symbol normalised out yet: patch the code value.
            self.val = (self.val & ~((mask << CODE_SHIFT) & _U32)) | (
                value << (CODE_SHIFT + shift)
            )
        else:
            self.error = True

    def shrink(self, new_size: int) -> None:
        """Compact the raw-bit tail so the stream fits new_size bytes
        (reference: encoder.rs:361-369); caller guarantees it fits."""
        assert self.offs + self.end_offs <= new_size
        if self.end_offs > 0:
            tail = self.buf[self.storage - self.end_offs : self.storage]
            self.buf[new_size - self.end_offs : new_size] = tail
        self.storage = new_size

    def done(self) -> None:
        """Flush: emit just enough bits to disambiguate the final interval,
        zero the gap and merge the last raw-bit byte (reference:
        encoder.rs:376-425)."""
        # Find the smallest end value with as many trailing zeros as possible.
        l = CODE_BITS - ilog(self.rng)
        msk = ((CODE_TOP - 1) >> l) & _U32
        end = (self.val + msk) & ~msk & _U32
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk & _U32
        while l > 0:
            self._carry_out(end >> CODE_SHIFT)
            end = (end << SYM_BITS) & (CODE_TOP - 1)
            l -= SYM_BITS
        # Flush any buffered carry chain.
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        # Flush whole bytes of the raw-bit window.
        window = self.end_window
        used = self.nend_bits
        while used >= SYM_BITS:
            self._write_byte_at_end(window & SYM_MAX)
            window >>= SYM_BITS
            used -= SYM_BITS
        if not self.error:
            # Clear the unused gap between the two streams.
            for i in range(self.offs, self.storage - self.end_offs):
                self.buf[i] = 0
            if used > 0:
                # The remaining raw bits collide with the range coder tail
                # byte; merge them (the range coder wrote only -l bits of it).
                if self.end_offs >= self.storage:
                    self.error = True
                else:
                    l = -l
                    if self.offs + self.end_offs >= self.storage and l < used:
                        window &= (1 << l) - 1
                        self.error = True
                    self.buf[self.storage - self.end_offs - 1] |= window & 0xFF

    # -- accessors ------------------------------------------------------------

    def range_bytes(self) -> int:
        """Bytes used by the range-coded (front) stream."""
        return self.offs

    def total_bytes(self) -> int:
        return self.offs + self.end_offs

    def range(self) -> int:
        return self.rng

    def data(self) -> bytes:
        """The finished stream (after :meth:`done`): front bytes, gap, tail."""
        return bytes(self.buf[: self.storage])
