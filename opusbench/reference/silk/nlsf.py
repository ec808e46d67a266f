"""NLSF dequantisation and NLSF -> LPC conversion (RFC 6716 sec. 4.2.7.5), a
copy of opus_tpu.silk.nlsf, in the normative fixed-point sequence.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""

from __future__ import annotations

from .bitstream import NlsfCodebook, nlsf_unpack
from .fixed_math import (
    add_sat16,
    clz32,
    div32_16,
    i16,
    i32,
    inverse32_varq,
    rshift_round,
    rshift_round64,
    sat16,
    smlawb,
    smulbb,
    smulww,
)

NLSF_QUANT_LEVEL_ADJ_Q10 = 102  # SILK_FIX_CONST(0.1, 10)
MAX_LOOPS = 20
MAX_LPC_STABILIZE_ITERATIONS = 16
QA16 = 16  # NLSF2A polynomial Q domain
QA24 = 24  # inverse prediction gain Q domain
A_LIMIT_Q24 = 16773022  # SILK_FIX_CONST(0.99975, 24)
INV_MAX_PRED_GAIN_Q30 = 107374  # SILK_FIX_CONST(1/1e4, 30)

_ORDERING16 = (0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1)
_ORDERING10 = (0, 9, 6, 3, 4, 5, 8, 1, 2, 7)


def _residual_dequant(indices, pred_q8, quant_step_size_q16, order):
    """Backwards one-tap-predicted residual, Q10."""
    x_q10 = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = smulbb(out_q10, pred_q8[i]) >> 8
        out_q10 = i16(indices[i] << 10)
        if out_q10 > 0:
            out_q10 = i16(out_q10 - NLSF_QUANT_LEVEL_ADJ_Q10)
        elif out_q10 < 0:
            out_q10 = i16(out_q10 + NLSF_QUANT_LEVEL_ADJ_Q10)
        out_q10 = smlawb(pred_q10, out_q10, quant_step_size_q16)
        x_q10[i] = out_q10
    return x_q10


def nlsf_stabilize(nlsf_q15, delta_min_q15, order):
    """silk_NLSF_stabilize: enforce minimum spacing, keeping ordering."""
    for _ in range(MAX_LOOPS):
        min_diff = nlsf_q15[0] - int(delta_min_q15[0])
        idx = 0
        for i in range(1, order):
            diff = nlsf_q15[i] - (nlsf_q15[i - 1] + int(delta_min_q15[i]))
            if diff < min_diff:
                min_diff = diff
                idx = i
        diff = (1 << 15) - (nlsf_q15[order - 1] + int(delta_min_q15[order]))
        if diff < min_diff:
            min_diff = diff
            idx = order

        if min_diff >= 0:
            return
        if idx == 0:
            nlsf_q15[0] = int(delta_min_q15[0])
        elif idx == order:
            nlsf_q15[order - 1] = (1 << 15) - int(delta_min_q15[order])
        else:
            min_center = sum(int(delta_min_q15[k]) for k in range(idx)) + (int(delta_min_q15[idx]) >> 1)
            max_center = (1 << 15) - sum(int(delta_min_q15[k]) for k in range(order, idx, -1)) - (
                int(delta_min_q15[idx]) >> 1
            )
            center = rshift_round(nlsf_q15[idx - 1] + nlsf_q15[idx], 1)
            center = max(min_center, min(max_center, center))
            nlsf_q15[idx - 1] = center - (int(delta_min_q15[idx]) >> 1)
            nlsf_q15[idx] = nlsf_q15[idx - 1] + int(delta_min_q15[idx])
    # Fallback: sort then clamp both directions.
    nlsf_q15.sort()
    nlsf_q15[0] = max(nlsf_q15[0], int(delta_min_q15[0]))
    for i in range(1, order):
        nlsf_q15[i] = max(nlsf_q15[i], add_sat16(nlsf_q15[i - 1], int(delta_min_q15[i])))
    nlsf_q15[order - 1] = min(nlsf_q15[order - 1], (1 << 15) - int(delta_min_q15[order]))
    for i in range(order - 2, -1, -1):
        nlsf_q15[i] = min(nlsf_q15[i], nlsf_q15[i + 1] - int(delta_min_q15[i + 1]))


def nlsf_decode(nlsf_indices, cb: NlsfCodebook):
    """silk_NLSF_decode -> stabilised NLSF vector, Q15."""
    _, pred_q8 = nlsf_unpack(cb, nlsf_indices[0])
    res_q10 = _residual_dequant(nlsf_indices[1:], pred_q8, cb.quant_step_size_q16, cb.order)
    nlsf_q15 = [0] * cb.order
    for i in range(cb.order):
        w = int(cb.cb1_wght_q9[nlsf_indices[0]][i])
        base = int(cb.cb1_q8[nlsf_indices[0]][i]) << 7
        val = div32_16(res_q10[i] << 14, w) + base
        nlsf_q15[i] = max(0, min(32767, val))
    nlsf_stabilize(nlsf_q15, cb.delta_min_q15, cb.order)
    return nlsf_q15


def _find_poly(c_lsf, off, dd):
    out = [0] * (dd + 1)
    out[0] = 1 << QA16
    out[1] = -c_lsf[off]
    for k in range(1, dd):
        ftmp = c_lsf[off + 2 * k]
        out[k + 1] = i32((out[k - 1] << 1) - i32(rshift_round64(ftmp * out[k], QA16)))
        for n in range(k, 1, -1):
            out[n] = i32(out[n] + out[n - 2] - i32(rshift_round64(ftmp * out[n - 1], QA16)))
        out[1] = i32(out[1] - ftmp)
    return out


def bwexpander_32(ar, d, chirp_q16):
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = smulww(chirp_q16, ar[i])
        chirp_q16 = i32(chirp_q16 + rshift_round(i32(chirp_q16 * chirp_minus_one), 16))
    ar[d - 1] = smulww(chirp_q16, ar[d - 1])


def bwexpander_16(ar, d, chirp_q16):
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = i16(rshift_round(i32(chirp_q16 * ar[i]), 16))
        chirp_q16 = i32(chirp_q16 + rshift_round(i32(chirp_q16 * chirp_minus_one), 16))
    ar[d - 1] = i16(rshift_round(i32(chirp_q16 * ar[d - 1]), 16))


def _smmul(a, b):
    return i32((i32(a) * i32(b)) >> 32)


def lpc_inverse_pred_gain(a_q12, order):
    """silk_LPC_inverse_pred_gain: Q30 inverse gain, 0 if unstable."""
    dc_resp = sum(a_q12[:order])
    if dc_resp >= 4096:
        return 0
    a_qa = [i32(a_q12[k] << (QA24 - 12)) for k in range(order)]
    inv_gain_q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if a_qa[k] > A_LIMIT_Q24 or a_qa[k] < -A_LIMIT_Q24:
            return 0
        rc_q31 = i32(-(a_qa[k] << (31 - QA24)))
        rc_mult1_q30 = i32((1 << 30) - _smmul(rc_q31, rc_q31))
        inv_gain_q30 = i32(_smmul(inv_gain_q30, rc_mult1_q30) << 2)
        if inv_gain_q30 < INV_MAX_PRED_GAIN_Q30:
            return 0
        mult2q = 32 - clz32(abs(rc_mult1_q30))
        rc_mult2 = inverse32_varq(rc_mult1_q30, mult2q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = a_qa[n]
            tmp2 = a_qa[k - n - 1]
            t64 = rshift_round64(
                (tmp1 - i32(rshift_round64(tmp2 * rc_q31, 31))) * rc_mult2, mult2q
            )
            if not (-0x80000000 <= t64 <= 0x7FFFFFFF):
                return 0
            a_qa[n] = t64
            t64 = rshift_round64(
                (tmp2 - i32(rshift_round64(tmp1 * rc_q31, 31))) * rc_mult2, mult2q
            )
            if not (-0x80000000 <= t64 <= 0x7FFFFFFF):
                return 0
            a_qa[k - n - 1] = t64
    if a_qa[0] > A_LIMIT_Q24 or a_qa[0] < -A_LIMIT_Q24:
        return 0
    rc_q31 = i32(-(a_qa[0] << (31 - QA24)))
    rc_mult1_q30 = i32((1 << 30) - _smmul(rc_q31, rc_q31))
    inv_gain_q30 = i32(_smmul(inv_gain_q30, rc_mult1_q30) << 2)
    if inv_gain_q30 < INV_MAX_PRED_GAIN_Q30:
        return 0
    return inv_gain_q30


def lpc_fit(a_qin, qout, qin, d):
    """silk_LPC_fit: scale 32-bit coefs into int16 at qout, chirping as
    needed; mutates a_qin to the quantised values it settled on."""
    a_qout = [0] * d
    for i in range(10):
        maxabs = 0
        idx = 0
        for k in range(d):
            absval = abs(a_qin[k])
            if absval > maxabs:
                maxabs = absval
                idx = k
        maxabs = rshift_round(maxabs, qin - qout)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_q16 = 65470 - div32_16((maxabs - 32767) << 14, i32(maxabs * (idx + 1)) >> 2)
            bwexpander_32(a_qin, d, chirp_q16)
        else:
            break
    else:
        i = 10
    if i == 10:
        for k in range(d):
            a_qout[k] = sat16(rshift_round(a_qin[k], qin - qout))
            a_qin[k] = i32(a_qout[k] << (qin - qout))
    else:
        for k in range(d):
            a_qout[k] = i16(rshift_round(a_qin[k], qin - qout))
    return a_qout


def nlsf2a(nlsf_q15, d):
    """silk_NLSF2A: NLSF (Q15) -> stable LPC prediction coefs (Q12)."""
    from .tables import LSF_COS_TAB_Q12

    ordering = _ORDERING16 if d == 16 else _ORDERING10
    c_lsf = [0] * d
    for k in range(d):
        f_int = nlsf_q15[k] >> 8
        f_frac = nlsf_q15[k] - (f_int << 8)
        cos_val = int(LSF_COS_TAB_Q12[f_int])
        delta = int(LSF_COS_TAB_Q12[f_int + 1]) - cos_val
        c_lsf[ordering[k]] = rshift_round((cos_val << 8) + delta * f_frac, 20 - QA16)

    dd = d >> 1
    p = _find_poly(c_lsf, 0, dd)
    q = _find_poly(c_lsf, 1, dd)
    a32_qa1 = [0] * d
    for k in range(dd):
        ptmp = i32(p[k + 1] + p[k])
        qtmp = i32(q[k + 1] - q[k])
        a32_qa1[k] = i32(-qtmp - ptmp)
        a32_qa1[d - k - 1] = i32(qtmp - ptmp)

    a_q12 = lpc_fit(a32_qa1, 12, QA16 + 1, d)

    i = 0
    while lpc_inverse_pred_gain(a_q12, d) == 0 and i < MAX_LPC_STABILIZE_ITERATIONS:
        bwexpander_32(a32_qa1, d, 65536 - (2 << i))
        for k in range(d):
            a_q12[k] = i16(rshift_round(a32_qa1[k], QA16 + 1 - 12))
        i += 1
    return a_q12
