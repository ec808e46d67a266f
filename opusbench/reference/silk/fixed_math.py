"""SILK fixed-point primitives, a copy of opus_tpu.silk.fixed_math: Python
ints as two's-complement 32-bit values, wrapped exactly like the C macros
(silk_SMULWB and the rest).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""

from __future__ import annotations


def i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def sat16(x: int) -> int:
    return max(-32768, min(32767, x))


def sat32(x: int) -> int:
    return max(-0x80000000, min(0x7FFFFFFF, x))


def smulbb(a: int, b: int) -> int:
    """i16(a) * i16(b)."""
    return i32(i16(a) * i16(b))


def smulwb(a: int, b: int) -> int:
    """(a32 * bottom16(b)) >> 16."""
    return i32((i32(a) * i16(b)) >> 16)


def smlawb(a: int, b: int, c: int) -> int:
    return i32(a + ((i32(b) * i16(c)) >> 16))


def smulww(a: int, b: int) -> int:
    return i32((i32(a) * i32(b)) >> 16)


def smlaww(a: int, b: int, c: int) -> int:
    return i32(a + ((i32(b) * i32(c)) >> 16))


def smull(a: int, b: int) -> int:
    """Full 64-bit product."""
    return i32(a) * i32(b)


def rshift_round(a: int, shift: int) -> int:
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def rshift_round64(a: int, shift: int) -> int:
    return ((a >> (shift - 1)) + 1) >> 1


def lshift_sat32(a: int, shift: int) -> int:
    return sat32(i32(a) << shift)


def add_sat32(a: int, b: int) -> int:
    return sat32(i32(a) + i32(b))


def add_sat16(a: int, b: int) -> int:
    return sat16(i16(a) + i16(b))


def clz32(x: int) -> int:
    x &= 0xFFFFFFFF
    if x == 0:
        return 32
    return 32 - x.bit_length()


def silk_rand(seed: int) -> int:
    return i32(907633515 + i32(seed) * 196314165)


def div32_16(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def inverse32_varq(b32: int, qres: int) -> int:
    """silk_INVERSE32_varQ: Newton-refined integer inverse."""
    b_headrm = clz32(abs(b32)) - 1
    b32_nrm = i32(b32 << b_headrm)
    b32_inv = div32_16(0x7FFFFFFF >> 2, i16(b32_nrm >> 16))
    result = i32(b32_inv << 16)
    err_q32 = i32(((1 << 29) - smulwb(b32_nrm, b32_inv)) << 3)
    result = smlaww(result, err_q32, b32_inv)
    lshift = 61 - b_headrm - qres
    if lshift <= 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return i32(result >> lshift)
    return 0


def silk_log2lin(in_log_q7: int) -> int:
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return 0x7FFFFFFF
    out = 1 << (in_log_q7 >> 7)
    frac_q7 = in_log_q7 & 0x7F
    if in_log_q7 < 2048:
        out = i32(out + ((out * smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)) >> 7))
    else:
        out = i32(out + out // 128 * smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174))
    return out


def silk_lin2log(in_lin: int) -> int:
    lz = clz32(in_lin)
    frac_q7 = (in_lin << lz >> 24) & 0x7F if False else 0
    # exact libopus: silk_CLZ_FRAC
    lz_out, frac = _clz_frac(in_lin)
    frac_q7 = frac
    return i32(((31 - lz_out) << 7) + smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), 179))


def _clz_frac(x: int):
    lzeros = clz32(x)
    frac_q7 = ((x * (1 << lzeros)) & 0xFFFFFFFF) >> 24 & 0x7F
    return lzeros, frac_q7
