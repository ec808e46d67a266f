"""Shared range-coder constants and bit-usage accounting (a copy of
opus_tpu.rc.common).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations

#: Resolution of fractional bit accounting: 3 -> 1/8th bits.
BITRES = 3
#: Number of bits to use for the range-coded part of unsigned integers.
UINT_BITS = 8
#: Size of the raw-bits window.
WINDOW_SIZE = 32
#: Number of bits output at a time.
SYM_BITS = 8
#: Total bits in each state register.
CODE_BITS = 32
#: Maximum byte symbol value.
SYM_MAX = (1 << SYM_BITS) - 1
#: Shift moving a symbol into the high-order position.
CODE_SHIFT = CODE_BITS - SYM_BITS - 1
#: Carry bit of the high-order range symbol.
CODE_TOP = 1 << (CODE_BITS - 1)
#: Low-order bit of the high-order range symbol.
CODE_BOT = CODE_TOP >> SYM_BITS
#: Bits available for the last, partial symbol in the code field.
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1

_U32 = 0xFFFFFFFF

#: tell_frac transition thresholds (see mod.rs:96-111): a linear function
#: plus this lookup replaces the RFC's iterative squaring.
_TELL_FRAC_CORRECTION = (35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535)


def ilog(value: int) -> int:
    """Position of the highest set bit, with ilog(0) == 0."""
    return value.bit_length()


class Tell:
    """Bit-usage accounting shared by encoder and decoder.

    Subclasses provide ``bits_total`` and ``rng`` attributes.  Both sides
    compute identical values, which is what lets SILK and CELT split one
    bit budget across a shared bitstream.
    """

    bits_total: int
    rng: int

    def tell(self) -> int:
        """Whole bits used so far (conservative, rounds up)."""
        return (self.bits_total - ilog(self.rng)) & _U32

    def tell_frac(self) -> int:
        """Bits used so far in 1/8-bit units."""
        bits = (self.bits_total << BITRES) & _U32
        l = ilog(self.rng)
        r = self.rng >> (l - 16)
        b = (r >> 12) - 8
        if r > _TELL_FRAC_CORRECTION[b]:
            b += 1
        return (bits - ((l << 3) + b)) & _U32
