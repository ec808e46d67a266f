"""SILK packet-loss concealment and comfort noise, a copy of
opus_tpu.silk.plc.

The scalar SILK layer (silk/api.py) conceals lost frames and glues the
first good frame after a loss with it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

from .bitstream import LTP_ORDER, TYPE_NO_VOICE_ACTIVITY, TYPE_VOICED
from .fixed_math import (
    _clz_frac,
    add_sat16,
    add_sat32,
    clz32,
    i16,
    i32,
    inverse32_varq,
    lshift_sat32,
    rshift_round,
    sat16,
    silk_rand,
    smlawb,
    smulbb,
    smulwb,
    smulww,
)
from .nlsf import bwexpander_16, lpc_inverse_pred_gain, nlsf2a

NB_ATT = 2
HARM_ATT_Q15 = (32440, 31130)            # 0.99, 0.95
PLC_RAND_ATTENUATE_V_Q15 = (31130, 26214)   # 0.95, 0.8
PLC_RAND_ATTENUATE_UV_Q15 = (32440, 29491)  # 0.99, 0.9
V_PITCH_GAIN_START_MIN_Q14 = 11469
V_PITCH_GAIN_START_MAX_Q14 = 15565
BWE_COEF_Q16 = 64881  # 0.99
PITCH_DRIFT_FAC_Q16 = 655
RAND_BUF_SIZE = 128
RAND_BUF_MASK = RAND_BUF_SIZE - 1
LOG2_INV_LPC_GAIN_HIGH_THRES = 3
LOG2_INV_LPC_GAIN_LOW_THRES = 8
MAX_LPC_ORDER = 16
MAX_NB_SUBFR = 4
MAX_PITCH_LAG_MS = 18
CNG_BUF_MASK_MAX = 255
CNG_GAIN_SMTH_Q16 = 4634
CNG_NLSF_SMTH_Q16 = 16348


class PlcState:
    def __init__(self, frame_length):
        self.pitch_l_q8 = frame_length << 7
        self.ltp_coef_q14 = [0] * LTP_ORDER
        self.prev_lpc_q12 = [0] * MAX_LPC_ORDER
        self.last_frame_lost = 0
        self.rand_seed = 0  # silk_init_decoder memsets the PLC struct
        self.rand_scale_q14 = 1 << 14
        self.conc_energy = 0
        self.conc_energy_shift = 0
        self.prev_ltp_scale_q14 = 0
        self.prev_gain_q16 = [1 << 16, 1 << 16]
        self.fs_khz = 0
        self.nb_subfr = 2
        self.subfr_length = 20


def _ensure_plc(st):
    if st.plc is None or st.plc.fs_khz != st.fs_khz:
        st.plc = PlcState(st.frame_length)
        st.plc.fs_khz = st.fs_khz
    return st.plc


def sum_sqr_shift(x):
    """silk_sum_sqr_shift -> (energy, shift)."""
    length = len(x)
    shft = 31 - clz32(length)
    nrg = length
    i = 0
    while i < length - 1:
        t = (x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF
        nrg = (nrg + (t >> shft)) & 0xFFFFFFFF
        i += 2
    if i < length:
        t = (x[i] * x[i]) & 0xFFFFFFFF
        nrg = (nrg + (t >> shft)) & 0xFFFFFFFF
    nrg = i32(nrg)
    shft = max(0, shft + 3 - clz32(nrg))
    nrg = 0
    i = 0
    while i < length - 1:
        t = (x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF
        nrg = (nrg + (t >> shft)) & 0xFFFFFFFF
        i += 2
    if i < length:
        t = (x[i] * x[i]) & 0xFFFFFFFF
        nrg = (nrg + (t >> shft)) & 0xFFFFFFFF
    return i32(nrg), shft


def sqrt_approx(x):
    if x <= 0:
        return 0
    lz, frac_q7 = _clz_frac(x)
    y = 32768 if (lz & 1) else 46214
    y >>= lz >> 1
    return smlawb(y, y, smulbb(213, frac_q7))


def plc_save(st, ctrl, ind):
    """silk_PLC_update: remember the last good frame's parameters."""
    plc = _ensure_plc(st)
    st.prev_signal_type = ind.signal_type
    ltp_gain_q14 = 0
    if ind.signal_type == TYPE_VOICED:
        j = 0
        while j * st.subfr_length < ctrl.pitch_l[st.nb_subfr - 1]:
            if j == st.nb_subfr:
                break
            temp = sum(ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER + i] for i in range(LTP_ORDER))
            if temp > ltp_gain_q14:
                ltp_gain_q14 = temp
                plc.ltp_coef_q14 = list(
                    ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER : (st.nb_subfr - j) * LTP_ORDER]
                )
                plc.pitch_l_q8 = ctrl.pitch_l[st.nb_subfr - 1 - j] << 8
            j += 1
        plc.ltp_coef_q14 = [0] * LTP_ORDER
        plc.ltp_coef_q14[LTP_ORDER // 2] = ltp_gain_q14
        if ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14:
            scale_q10 = (V_PITCH_GAIN_START_MIN_Q14 << 10) // max(ltp_gain_q14, 1)
            plc.ltp_coef_q14 = [smulbb(c, scale_q10) >> 10 for c in plc.ltp_coef_q14]
        elif ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14:
            scale_q14 = (V_PITCH_GAIN_START_MAX_Q14 << 14) // ltp_gain_q14
            plc.ltp_coef_q14 = [smulbb(c, scale_q14) >> 14 for c in plc.ltp_coef_q14]
    else:
        plc.pitch_l_q8 = (st.fs_khz * 18) << 8
        plc.ltp_coef_q14 = [0] * LTP_ORDER
    plc.prev_lpc_q12 = list(ctrl.pred_coef_q12[1][: st.lpc_order]) + [0] * (MAX_LPC_ORDER - st.lpc_order)
    plc.prev_ltp_scale_q14 = ctrl.ltp_scale_q14
    plc.prev_gain_q16 = [ctrl.gains_q16[st.nb_subfr - 2], ctrl.gains_q16[st.nb_subfr - 1]]
    plc.subfr_length = st.subfr_length
    plc.nb_subfr = st.nb_subfr


def plc_conceal(st) -> list:
    """silk_PLC_conceal: extrapolate one frame from saved parameters."""
    plc = _ensure_plc(st)
    frame_length = st.frame_length
    lpc_order = st.lpc_order

    prev_gain_q10 = [plc.prev_gain_q16[0] >> 6, plc.prev_gain_q16[1] >> 6]
    if st.first_frame_after_reset:
        plc.prev_lpc_q12 = [0] * MAX_LPC_ORDER

    # Energy of the last two excitation subframes -> noise source choice.
    exc = st.exc_q14 if st.exc_q14 is not None else [0] * frame_length
    def _exc_buf(k):
        base = (k + st.nb_subfr - 2) * st.subfr_length
        return [
            sat16(smulww(exc[base + i] if base + i < len(exc) else 0, prev_gain_q10[k]) >> 8)
            for i in range(st.subfr_length)
        ]

    e1, s1 = sum_sqr_shift(_exc_buf(0))
    e2, s2 = sum_sqr_shift(_exc_buf(1))
    if (e1 >> s2) < (e2 >> s1):
        rand_base = max(0, (plc.nb_subfr - 1) * plc.subfr_length - RAND_BUF_SIZE)
    else:
        rand_base = max(0, plc.nb_subfr * plc.subfr_length - RAND_BUF_SIZE)
    rand_ptr = exc[rand_base : rand_base + RAND_BUF_SIZE]
    rand_ptr += [0] * (RAND_BUF_SIZE - len(rand_ptr))

    b_q14 = plc.ltp_coef_q14  # aliased: decay persists in PLC state (C: pointer)
    rand_scale_q14 = plc.rand_scale_q14

    harm_gain_q15 = HARM_ATT_Q15[min(NB_ATT - 1, st.loss_cnt)]
    if st.prev_signal_type == TYPE_VOICED:
        rand_gain_q15 = PLC_RAND_ATTENUATE_V_Q15[min(NB_ATT - 1, st.loss_cnt)]
    else:
        rand_gain_q15 = PLC_RAND_ATTENUATE_UV_Q15[min(NB_ATT - 1, st.loss_cnt)]

    lpc = plc.prev_lpc_q12[:lpc_order]
    bwexpander_16(lpc, lpc_order, BWE_COEF_Q16)
    plc.prev_lpc_q12[:lpc_order] = lpc
    a_q12 = list(lpc)

    if st.loss_cnt == 0:
        rand_scale_q14 = 1 << 14
        if st.prev_signal_type == TYPE_VOICED:
            for i in range(LTP_ORDER):
                rand_scale_q14 -= b_q14[i]
            rand_scale_q14 = max(3277, rand_scale_q14)
            rand_scale_q14 = i16(smulbb(rand_scale_q14, plc.prev_ltp_scale_q14) >> 14)
        else:
            inv_gain_q30 = lpc_inverse_pred_gain(a_q12, lpc_order)
            down_scale_q30 = min((1 << 30) >> LOG2_INV_LPC_GAIN_HIGH_THRES, inv_gain_q30)
            down_scale_q30 = max((1 << 30) >> LOG2_INV_LPC_GAIN_LOW_THRES, down_scale_q30)
            down_scale_q30 = i32(down_scale_q30 << LOG2_INV_LPC_GAIN_HIGH_THRES)
            rand_gain_q15 = smulwb(down_scale_q30, rand_gain_q15) >> 14

    rand_seed = plc.rand_seed
    lag = rshift_round(plc.pitch_l_q8, 8)
    s_ltp_buf_idx = st.ltp_mem_length

    s_ltp = [0] * st.ltp_mem_length
    s_ltp_q14 = [0] * (st.ltp_mem_length + frame_length)

    idx = st.ltp_mem_length - lag - lpc_order - LTP_ORDER // 2
    if idx <= 0:
        idx = 1
    _lpc_analysis_filter_plc(s_ltp, idx, st.out_buf, idx, a_q12, st.ltp_mem_length - idx, lpc_order)
    inv_gain_q30 = inverse32_varq(plc.prev_gain_q16[1], 46)
    inv_gain_q30 = min(inv_gain_q30, 0x7FFFFFFF >> 1)
    for i in range(idx + lpc_order, st.ltp_mem_length):
        s_ltp_q14[i] = smulwb(inv_gain_q30, s_ltp[i])

    for k in range(st.nb_subfr):
        pred_lag = s_ltp_buf_idx - lag + LTP_ORDER // 2
        for i in range(st.subfr_length):
            ltp_pred_q12 = 2
            ltp_pred_q12 = smlawb(ltp_pred_q12, s_ltp_q14[pred_lag + 0], b_q14[0])
            ltp_pred_q12 = smlawb(ltp_pred_q12, s_ltp_q14[pred_lag - 1], b_q14[1])
            ltp_pred_q12 = smlawb(ltp_pred_q12, s_ltp_q14[pred_lag - 2], b_q14[2])
            ltp_pred_q12 = smlawb(ltp_pred_q12, s_ltp_q14[pred_lag - 3], b_q14[3])
            ltp_pred_q12 = smlawb(ltp_pred_q12, s_ltp_q14[pred_lag - 4], b_q14[4])
            pred_lag += 1
            rand_seed = silk_rand(rand_seed)
            ridx = (rand_seed >> 25) & RAND_BUF_MASK
            s_ltp_q14[s_ltp_buf_idx] = i32(smlawb(ltp_pred_q12, rand_ptr[ridx], rand_scale_q14) << 2)
            s_ltp_buf_idx += 1
        for j in range(LTP_ORDER):
            b_q14[j] = smulbb(harm_gain_q15, b_q14[j]) >> 15
        if st.prev_signal_type != TYPE_NO_VOICE_ACTIVITY:
            rand_scale_q14 = i16(smulbb(rand_scale_q14, rand_gain_q15) >> 15)
        plc.pitch_l_q8 = smlawb(plc.pitch_l_q8, plc.pitch_l_q8, PITCH_DRIFT_FAC_Q16)
        plc.pitch_l_q8 = min(plc.pitch_l_q8, (MAX_PITCH_LAG_MS * st.fs_khz) << 8)
        lag = rshift_round(plc.pitch_l_q8, 8)

    # LPC synthesis over the whole frame.
    base = st.ltp_mem_length - MAX_LPC_ORDER
    s_ltp_q14[base : base + MAX_LPC_ORDER] = st.s_lpc_q14
    frame = [0] * frame_length
    for i in range(frame_length):
        lpc_pred_q10 = lpc_order >> 1
        for j in range(lpc_order):
            lpc_pred_q10 = smlawb(lpc_pred_q10, s_ltp_q14[base + MAX_LPC_ORDER + i - 1 - j], a_q12[j])
        s_ltp_q14[base + MAX_LPC_ORDER + i] = add_sat32(
            s_ltp_q14[base + MAX_LPC_ORDER + i], lshift_sat32(lpc_pred_q10, 4)
        )
        frame[i] = sat16(rshift_round(smulww(s_ltp_q14[base + MAX_LPC_ORDER + i], prev_gain_q10[1]), 8))
    st.s_lpc_q14 = s_ltp_q14[base + frame_length : base + frame_length + MAX_LPC_ORDER]

    plc.rand_seed = rand_seed
    plc.rand_scale_q14 = rand_scale_q14
    st.loss_cnt += 1
    # silk_PLC sets all control pitch lags to `lag` for lag_prev.
    st.lag_prev = lag
    return frame


def plc_glue_frames(st, frame, length):
    """silk_PLC_glue_frames: fade-in after concealment."""
    plc = _ensure_plc(st)
    if st.loss_cnt:
        plc.conc_energy, plc.conc_energy_shift = sum_sqr_shift(frame)
        plc.last_frame_lost = 1
    else:
        if plc.last_frame_lost:
            energy, energy_shift = sum_sqr_shift(frame)
            if energy_shift > plc.conc_energy_shift:
                plc.conc_energy >>= energy_shift - plc.conc_energy_shift
            elif energy_shift < plc.conc_energy_shift:
                energy >>= plc.conc_energy_shift - energy_shift
            if energy > plc.conc_energy:
                lz = clz32(plc.conc_energy) - 1
                plc.conc_energy = i32(plc.conc_energy << lz)
                energy >>= max(24 - lz, 0)
                frac_q24 = plc.conc_energy // max(energy, 1)
                gain_q16 = i32(sqrt_approx(frac_q24) << 4)
                slope_q16 = i32(((1 << 16) - gain_q16) // length) << 2
                for i in range(length):
                    frame[i] = smulwb(gain_q16, frame[i])
                    gain_q16 += slope_q16
                    if gain_q16 > 1 << 16:
                        break
        plc.last_frame_lost = 0


def cng(st, ctrl, frame, length):
    """silk_CNG: update noise estimate; add noise on concealed frames."""
    if getattr(st, "cng_fs_khz", 0) != st.fs_khz:
        st.cng_reset()
        st.cng_synth_state = [0] * MAX_LPC_ORDER
    if not hasattr(st, "cng_synth_state"):
        st.cng_synth_state = [0] * MAX_LPC_ORDER

    if st.loss_cnt == 0 and st.prev_signal_type == TYPE_NO_VOICE_ACTIVITY and ctrl is not None:
        for i in range(st.lpc_order):
            st.cng_smth_nlsf_q15[i] += smulwb(
                st.prev_nlsf_q15[i] - st.cng_smth_nlsf_q15[i], CNG_NLSF_SMTH_Q16
            )
        max_gain = 0
        subfr = 0
        for i in range(st.nb_subfr):
            if ctrl.gains_q16[i] > max_gain:
                max_gain = ctrl.gains_q16[i]
                subfr = i
        sl = st.subfr_length
        st.cng_exc_buf_q14[sl : st.nb_subfr * sl] = st.cng_exc_buf_q14[: (st.nb_subfr - 1) * sl]
        st.cng_exc_buf_q14[:sl] = st.exc_q14[subfr * sl : (subfr + 1) * sl]
        for i in range(st.nb_subfr):
            st.cng_smth_gain_q16 += smulwb(ctrl.gains_q16[i] - st.cng_smth_gain_q16, CNG_GAIN_SMTH_Q16)

    if st.loss_cnt:
        plc = _ensure_plc(st)
        gain_q16 = smulww(plc.rand_scale_q14, plc.prev_gain_q16[1])
        if gain_q16 >= (1 << 21) or st.cng_smth_gain_q16 > (1 << 23):
            gain_q16 = i32((gain_q16 >> 16) * (gain_q16 >> 16))
            gain_q16 = i32(
                ((st.cng_smth_gain_q16 >> 16) * (st.cng_smth_gain_q16 >> 16)) - (gain_q16 << 5)
            )
            gain_q16 = i32(sqrt_approx(gain_q16) << 16)
        else:
            gain_q16 = smulww(gain_q16, gain_q16)
            gain_q16 = i32(smulww(st.cng_smth_gain_q16, st.cng_smth_gain_q16) - (gain_q16 << 5))
            gain_q16 = i32(sqrt_approx(gain_q16) << 8)
        gain_q10 = gain_q16 >> 6

        exc_mask = CNG_BUF_MASK_MAX
        while exc_mask > length:
            exc_mask >>= 1
        seed = st.cng_rand_seed
        sig_q14 = [0] * (MAX_LPC_ORDER + length)
        for i in range(length):
            seed = silk_rand(seed)
            sig_q14[MAX_LPC_ORDER + i] = st.cng_exc_buf_q14[(seed >> 24) & exc_mask]
        st.cng_rand_seed = seed

        a_q12 = nlsf2a(st.cng_smth_nlsf_q15[: st.lpc_order], st.lpc_order)
        sig_q14[:MAX_LPC_ORDER] = st.cng_synth_state
        for i in range(length):
            lpc_pred_q10 = st.lpc_order >> 1
            for j in range(st.lpc_order):
                lpc_pred_q10 = smlawb(lpc_pred_q10, sig_q14[MAX_LPC_ORDER + i - 1 - j], a_q12[j])
            sig_q14[MAX_LPC_ORDER + i] = add_sat32(sig_q14[MAX_LPC_ORDER + i], lshift_sat32(lpc_pred_q10, 4))
            frame[i] = add_sat16(frame[i], sat16(rshift_round(smulww(sig_q14[MAX_LPC_ORDER + i], gain_q10), 8)))
        st.cng_synth_state = sig_q14[length : length + MAX_LPC_ORDER]
    else:
        st.cng_synth_state = [0] * MAX_LPC_ORDER


def _lpc_analysis_filter_plc(out, out_off, inp, in_off, b_q12, length, order):
    from .decoder import _lpc_analysis_filter

    _lpc_analysis_filter(out, out_off, inp, in_off, b_q12, length, order)
