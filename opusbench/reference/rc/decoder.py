"""Range decoder (RFC 6716 sec. 4.1), a copy of opus_tpu.rc.decoder.

Range-coded symbols are read from the front of the buffer, raw bits from
the end, backwards; a corrupt stream saturates (error flag) instead of
aborting.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

from .common import (
    CODE_BITS,
    CODE_BOT,
    CODE_EXTRA,
    CODE_TOP,
    SYM_BITS,
    SYM_MAX,
    UINT_BITS,
    WINDOW_SIZE,
    Tell,
    ilog,
)

_U32 = 0xFFFFFFFF


class RangeDecoder(Tell):
    """Sequential range decoder over one compressed frame."""

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
        "error",
        "_rem",
    )

    def __init__(self, buf: bytes):
        self.buf = buf
        self.storage = len(buf)
        self.offs = 0
        # Raw-bit side: read from the buffer end, backwards.
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        # The remainder of CODE_BITS that doesn't fit in whole symbols is
        # read up-front; account for it plus the spare carry bit.
        self.bits_total = CODE_BITS + 1 - ((CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS
        self.ext = 0
        self.error = False
        self.rng = 1 << CODE_EXTRA
        rem = self._read_byte()
        self.val = self.rng - 1 - (rem >> (SYM_BITS - CODE_EXTRA))
        self._rem = rem
        self._normalize()

    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        """Refill ``val`` 8 bits at a time while the range is too small."""
        while self.rng <= CODE_BOT:
            self.bits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & _U32
            sym = self._rem
            rem = self._read_byte()
            self._rem = rem
            sym = ((sym << SYM_BITS) | rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = ((self.val << SYM_BITS) + (SYM_MAX & ~sym)) & (CODE_TOP - 1)

    # -- primitive decode/update pair ------------------------------------

    def decode(self, ft: int) -> int:
        """Map the current code point into a cumulative frequency < ft."""
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        """Like :meth:`decode` with ft = 1<<bits (division-free scale)."""
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        """Commit a symbol whose cumulative range is [fl, fh) of ft."""
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    # -- derived decoders --------------------------------------------------

    def decode_bit_logp(self, logp: int) -> bool:
        """Decode one bit with P(1) = 2**-logp."""
        r = self.rng
        d = self.val
        s = r >> logp
        ret = d < s
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def decode_icdf(self, icdf, ftb: int) -> int:
        """Decode a symbol from an inverse-CDF table scaled by 2**ftb."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def decode_uint(self, ft: int) -> int:
        """Decode a uniform integer in [0, ft); large ft splits into
        range-coded MSBs plus raw LSBs (reference: decoder.rs:245-266)."""
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft1 = (ft >> ftb) + 1
            s = self.decode(ft1)
            self.update(s, s + 1, ft1)
            t = (s << ftb) | self.decode_bits(ftb)
            if t <= ft:
                return t
            # Corrupt frame: saturate instead of aborting.
            self.error = True
            return ft
        s = self.decode(ft + 1)
        self.update(s, s + 1, ft + 1)
        return s

    def decode_bits(self, bits: int) -> int:
        """Read raw bits from the end of the buffer, backwards."""
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while True:
                window |= self._read_byte_from_end() << available
                available += SYM_BITS
                if available > WINDOW_SIZE - SYM_BITS:
                    break
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.bits_total += bits
        return ret

    # -- frame surgery -----------------------------------------------------

    def shrink_storage(self, new_storage: int) -> None:
        """Hide the trailing bytes of the frame from the raw-bit reader;
        used to split off CELT->SILK redundancy (reference: decoder.rs:81-83)."""
        self.storage = new_storage

    def range(self) -> int:
        return self.rng
