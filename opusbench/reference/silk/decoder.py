"""The SILK frame decoder (RFC 6716 sec. 4.2), a copy of
opus_tpu.silk.decoder: the channel state, parameter decoding and the
normative fixed-point synthesis.  The SILK-only batch decoder
(batch/silk_pipeline.py) uses its state and parameter decode, and runs
the synthesis itself on the device.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""

from __future__ import annotations

from ..errors import InvalidPacket
from . import tables as T
from .bitstream import (
    CODE_CONDITIONALLY,
    LTP_ORDER,
    MAX_NB_SUBFR,
    NLSF_CB_NB_MB,
    NLSF_CB_WB,
    TYPE_VOICED,
    SideInfo,
)
from .fixed_math import (
    add_sat32,
    i16,
    i32,
    inverse32_varq,
    lshift_sat32,
    rshift_round,
    sat16,
    silk_log2lin,
    silk_rand,
    smlawb,
    smulbb,
    smulwb,
    smulww,
)
from .nlsf import bwexpander_16, nlsf2a, nlsf_decode

MAX_LPC_ORDER = 16
MIN_LPC_ORDER = 10
MAX_FRAME_LENGTH_MS = 20
LTP_MEM_LENGTH_MS = 20
QUANT_LEVEL_ADJUST_Q10 = 80
MAX_PITCH_LAG_MS = 18
MIN_PITCH_LAG_MS = 2
BWE_AFTER_LOSS_Q16 = 63570
N_LEVELS_QGAIN = 64
MIN_DELTA_GAIN_QUANT = -4
MAX_DELTA_GAIN_QUANT = 36
LOG2_INV_LPC_GAIN_HIGH_THRES = 3
LOG2_INV_LPC_GAIN_LOW_THRES = 8

_LTP_VQ = (T.LTP_GAIN_VQ_0, T.LTP_GAIN_VQ_1, T.LTP_GAIN_VQ_2)

FLAG_DECODE_NORMAL = 0
FLAG_PACKET_LOST = 1
FLAG_DECODE_LBRR = 2


def gains_dequant(gains_indices, prev_ind, conditional, nb_subfr):
    """silk_gains_dequant -> (Gains_Q16 list, new prev_ind)."""
    gains_q16 = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(gains_indices[k], prev_ind - 16)
        else:
            ind_tmp = gains_indices[k] + MIN_DELTA_GAIN_QUANT
            double_step_thresh = 2 * MAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN + prev_ind
            if ind_tmp > double_step_thresh:
                prev_ind += (ind_tmp << 1) - double_step_thresh
            else:
                prev_ind += ind_tmp
        prev_ind = max(0, min(N_LEVELS_QGAIN - 1, prev_ind))
        # INV_SCALE_Q16 = (65536*((88-2)*128/6))/63 = 1907825 (C int division)
        gains_q16[k] = silk_log2lin(min(smulwb(1907825, prev_ind) + 2090, 3967))
    return gains_q16, prev_ind


def decode_pitch(lag_index, contour_index, fs_khz, nb_subfr):
    """silk_decode_pitch: absolute lag + contour codebook offsets."""
    if fs_khz == 8:
        if nb_subfr == MAX_NB_SUBFR:
            cb = T.CB_LAGS_STAGE2
        else:
            cb = T.CB_LAGS_STAGE2_10MS
    else:
        if nb_subfr == MAX_NB_SUBFR:
            cb = T.CB_LAGS_STAGE3
        else:
            cb = T.CB_LAGS_STAGE3_10MS
    min_lag = MIN_PITCH_LAG_MS * fs_khz
    max_lag = MAX_PITCH_LAG_MS * fs_khz
    lag = min_lag + lag_index
    return [max(min_lag, min(max_lag, lag + int(cb[k][contour_index]))) for k in range(nb_subfr)]


OUT_BUF_LEN = 20 * 16 + 2 * 5 * 16  # MAX_FRAME_LENGTH + 2*MAX_SUB_FRAME_LENGTH


class SilkChannelState:
    """Per-channel decoder state (silk_decoder_state)."""

    def __init__(self):
        self.fs_khz = 0
        self.fs_api_hz = 0
        self.nb_subfr = 0
        self.frame_length = 0
        self.subfr_length = 0
        self.ltp_mem_length = 0
        self.lpc_order = 0
        self.nlsf_cb = NLSF_CB_WB
        self.pitch_lag_low_bits_icdf = T.UNIFORM8_ICDF
        self.pitch_contour_icdf = T.PITCH_CONTOUR_ICDF
        self.prev_nlsf_q15 = [0] * MAX_LPC_ORDER
        self.ec_prev_signal_type = 0
        self.ec_prev_lag_index = 0
        self.last_gain_index = 10
        self.prev_gain_q16 = 1 << 16
        self.first_frame_after_reset = 1
        self.prev_signal_type = 0
        self.lag_prev = 100
        self.loss_cnt = 0
        self.out_buf = [0] * OUT_BUF_LEN
        self.s_lpc_q14 = [0] * MAX_LPC_ORDER
        self.exc_q14 = None
        self.vad_flags = [0] * 3
        self.lbrr_flag = 0
        self.lbrr_flags = [0] * 3
        self.n_frames_per_packet = 0
        self.n_frames_decoded = 0
        self.resampler = None
        # CNG / PLC state
        self.cng_smth_nlsf_q15 = [0] * MAX_LPC_ORDER
        self.cng_smth_gain_q16 = 0
        self.cng_rand_seed = 3176576
        self.cng_exc_buf_q14 = [0] * 320
        self.plc = None

    def cng_reset(self):
        step = 32767 // (self.lpc_order + 1)
        acc = 0
        for i in range(self.lpc_order):
            acc += step
            self.cng_smth_nlsf_q15[i] = acc
        self.cng_smth_gain_q16 = 0
        self.cng_rand_seed = 3176576
        self.cng_fs_khz = self.fs_khz

    def set_fs(self, fs_khz: int, fs_api_hz: int):
        """silk_decoder_set_fs: nb_subfr must be set by the caller first."""
        self.subfr_length = 5 * fs_khz
        frame_length = self.nb_subfr * self.subfr_length
        if self.fs_khz != fs_khz or self.fs_api_hz != fs_api_hz:
            from .resampler import Resampler

            self.resampler = Resampler(fs_khz * 1000, fs_api_hz)
            self.fs_api_hz = fs_api_hz
        if self.fs_khz != fs_khz or frame_length != self.frame_length:
            if fs_khz == 8:
                self.pitch_contour_icdf = (
                    T.PITCH_CONTOUR_NB_ICDF if self.nb_subfr == MAX_NB_SUBFR else T.PITCH_CONTOUR_10MS_NB_ICDF
                )
            else:
                self.pitch_contour_icdf = (
                    T.PITCH_CONTOUR_ICDF if self.nb_subfr == MAX_NB_SUBFR else T.PITCH_CONTOUR_10MS_ICDF
                )
            if self.fs_khz != fs_khz:
                self.ltp_mem_length = LTP_MEM_LENGTH_MS * fs_khz
                if fs_khz in (8, 12):
                    self.lpc_order = MIN_LPC_ORDER
                    self.nlsf_cb = NLSF_CB_NB_MB
                else:
                    self.lpc_order = MAX_LPC_ORDER
                    self.nlsf_cb = NLSF_CB_WB
                if fs_khz == 16:
                    self.pitch_lag_low_bits_icdf = T.UNIFORM8_ICDF
                elif fs_khz == 12:
                    self.pitch_lag_low_bits_icdf = T.UNIFORM6_ICDF
                else:
                    self.pitch_lag_low_bits_icdf = T.UNIFORM4_ICDF
                self.first_frame_after_reset = 1
                self.lag_prev = 100
                self.last_gain_index = 10
                self.prev_signal_type = 0
                self.out_buf = [0] * OUT_BUF_LEN
                self.s_lpc_q14 = [0] * MAX_LPC_ORDER
                self.prev_nlsf_q15 = [0] * MAX_LPC_ORDER
            self.fs_khz = fs_khz
            self.frame_length = frame_length


class DecoderControl:
    """Per-frame dequantised parameters (silk_decoder_control)."""

    def __init__(self):
        self.pitch_l = [0] * MAX_NB_SUBFR
        self.gains_q16 = [0] * MAX_NB_SUBFR
        self.pred_coef_q12 = [[0] * MAX_LPC_ORDER, [0] * MAX_LPC_ORDER]
        self.ltp_coef_q14 = [0] * (LTP_ORDER * MAX_NB_SUBFR)
        self.ltp_scale_q14 = 0


def decode_parameters(st: SilkChannelState, ind: SideInfo, cond_coding: int) -> DecoderControl:
    """silk_decode_parameters: indices -> gains, LPC, pitch, LTP."""
    ctrl = DecoderControl()
    gains, st.last_gain_index = gains_dequant(
        ind.gains_indices, st.last_gain_index, cond_coding == CODE_CONDITIONALLY, st.nb_subfr
    )
    ctrl.gains_q16[: st.nb_subfr] = gains

    nlsf_q15 = nlsf_decode(ind.nlsf_indices, st.nlsf_cb)
    ctrl.pred_coef_q12[1][: st.lpc_order] = nlsf2a(nlsf_q15, st.lpc_order)

    if st.first_frame_after_reset:
        ind.nlsf_interp_coef_q2 = 4
    if ind.nlsf_interp_coef_q2 < 4:
        nlsf0 = [
            st.prev_nlsf_q15[i] + ((ind.nlsf_interp_coef_q2 * (nlsf_q15[i] - st.prev_nlsf_q15[i])) >> 2)
            for i in range(st.lpc_order)
        ]
        ctrl.pred_coef_q12[0][: st.lpc_order] = nlsf2a(nlsf0, st.lpc_order)
    else:
        ctrl.pred_coef_q12[0][: st.lpc_order] = list(ctrl.pred_coef_q12[1][: st.lpc_order])

    st.prev_nlsf_q15[: st.lpc_order] = nlsf_q15

    if st.loss_cnt:
        for half in range(2):
            coefs = ctrl.pred_coef_q12[half][: st.lpc_order]
            bwexpander_16(coefs, st.lpc_order, BWE_AFTER_LOSS_Q16)
            ctrl.pred_coef_q12[half][: st.lpc_order] = coefs

    if ind.signal_type == TYPE_VOICED:
        ctrl.pitch_l[: st.nb_subfr] = decode_pitch(ind.lag_index, ind.contour_index, st.fs_khz, st.nb_subfr)
        vq = _LTP_VQ[ind.per_index]
        for k in range(st.nb_subfr):
            for i in range(LTP_ORDER):
                ctrl.ltp_coef_q14[k * LTP_ORDER + i] = int(vq[ind.ltp_index[k]][i]) << 7
        ctrl.ltp_scale_q14 = int(T.LTP_SCALES_TABLE_Q14[ind.ltp_scale_index])
    else:
        ctrl.pitch_l = [0] * MAX_NB_SUBFR
        ctrl.ltp_coef_q14 = [0] * (LTP_ORDER * MAX_NB_SUBFR)
        ind.per_index = 0
        ctrl.ltp_scale_q14 = 0
    return ctrl


def decode_core(st: SilkChannelState, ctrl: DecoderControl, ind: SideInfo, pulses) -> list:
    """silk_decode_core: excitation reconstruction + LTP/LPC synthesis.

    Returns frame_length int16 samples; updates s_lpc/exc/prev_gain state.
    (out_buf history is rolled by the caller, decode_frame.)
    """
    lpc_order = st.lpc_order
    frame_length = st.frame_length
    subfr_length = st.subfr_length

    offset_q10 = int(T.QUANTIZATION_OFFSETS_Q10[ind.signal_type >> 1][ind.quant_offset_type])
    nlsf_interpolation_flag = 1 if ind.nlsf_interp_coef_q2 < 4 else 0

    # Excitation: lift pulses to Q14 with offset/adjust, pseudorandom sign inversion.
    rand_seed = ind.seed
    exc_q14 = [0] * frame_length
    for i in range(frame_length):
        rand_seed = silk_rand(rand_seed)
        v = pulses[i] << 14
        if v > 0:
            v -= QUANT_LEVEL_ADJUST_Q10 << 4
        elif v < 0:
            v += QUANT_LEVEL_ADJUST_Q10 << 4
        v += offset_q10 << 4
        if rand_seed < 0:
            v = -v
        exc_q14[i] = i32(v)
        rand_seed = i32(rand_seed + pulses[i])
    st.exc_q14 = exc_q14

    s_ltp = [0] * st.ltp_mem_length
    s_ltp_q15 = [0] * (st.ltp_mem_length + frame_length)
    s_lpc = st.s_lpc_q14 + [0] * subfr_length  # MAX_LPC_ORDER history + workspace
    xq = [0] * frame_length
    s_ltp_buf_idx = st.ltp_mem_length
    lag = 0

    for k in range(st.nb_subfr):
        pexc = k * subfr_length
        a_q12 = ctrl.pred_coef_q12[k >> 1]
        b_q14 = ctrl.ltp_coef_q14[k * LTP_ORDER : (k + 1) * LTP_ORDER]
        signal_type = ind.signal_type

        gain_q10 = ctrl.gains_q16[k] >> 6
        inv_gain_q31 = inverse32_varq(ctrl.gains_q16[k], 47)

        if ctrl.gains_q16[k] != st.prev_gain_q16:
            gain_adj_q16 = div32_varq(st.prev_gain_q16, ctrl.gains_q16[k], 16)
            for i in range(MAX_LPC_ORDER):
                s_lpc[i] = smulww(gain_adj_q16, s_lpc[i])
        else:
            gain_adj_q16 = 1 << 16
        st.prev_gain_q16 = ctrl.gains_q16[k]

        # Avoid abrupt transition from voiced PLC to unvoiced normal decoding.
        if (
            st.loss_cnt
            and st.prev_signal_type == TYPE_VOICED
            and ind.signal_type != TYPE_VOICED
            and k < MAX_NB_SUBFR // 2
        ):
            b_q14 = [0] * LTP_ORDER
            b_q14[LTP_ORDER // 2] = 4096  # SILK_FIX_CONST(0.25, 14)
            signal_type = TYPE_VOICED
            ctrl.pitch_l[k] = st.lag_prev

        if signal_type == TYPE_VOICED:
            lag = ctrl.pitch_l[k]
            if k == 0 or (k == 2 and nlsf_interpolation_flag):
                # Rewhiten LTP state with current LPC.
                start_idx = st.ltp_mem_length - lag - lpc_order - LTP_ORDER // 2
                if start_idx <= 0:
                    raise InvalidPacket("silk: invalid pitch lag")
                if k == 2:
                    st.out_buf[st.ltp_mem_length : st.ltp_mem_length + 2 * subfr_length] = xq[: 2 * subfr_length]
                _lpc_analysis_filter(
                    s_ltp,
                    start_idx,
                    st.out_buf,
                    start_idx + k * subfr_length,
                    a_q12,
                    st.ltp_mem_length - start_idx,
                    lpc_order,
                )
                if k == 0:
                    # LTP downscaling to reduce inter-packet dependency.
                    inv_gain_q31 = i32(smulwb(inv_gain_q31, ctrl.ltp_scale_q14) << 2)
                for i in range(lag + LTP_ORDER // 2):
                    s_ltp_q15[s_ltp_buf_idx - i - 1] = smulwb(inv_gain_q31, s_ltp[st.ltp_mem_length - i - 1])
            else:
                if gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        s_ltp_q15[s_ltp_buf_idx - i - 1] = smulww(gain_adj_q16, s_ltp_q15[s_ltp_buf_idx - i - 1])

        if signal_type == TYPE_VOICED:
            pred_lag = s_ltp_buf_idx - lag + LTP_ORDER // 2
            pres_q14 = [0] * subfr_length
            for i in range(subfr_length):
                ltp_pred_q13 = 2
                ltp_pred_q13 = smlawb(ltp_pred_q13, s_ltp_q15[pred_lag + 0], b_q14[0])
                ltp_pred_q13 = smlawb(ltp_pred_q13, s_ltp_q15[pred_lag - 1], b_q14[1])
                ltp_pred_q13 = smlawb(ltp_pred_q13, s_ltp_q15[pred_lag - 2], b_q14[2])
                ltp_pred_q13 = smlawb(ltp_pred_q13, s_ltp_q15[pred_lag - 3], b_q14[3])
                ltp_pred_q13 = smlawb(ltp_pred_q13, s_ltp_q15[pred_lag - 4], b_q14[4])
                pred_lag += 1
                pres_q14[i] = i32(exc_q14[pexc + i] + (ltp_pred_q13 << 1))
                s_ltp_q15[s_ltp_buf_idx] = i32(pres_q14[i] << 1)
                s_ltp_buf_idx += 1
        else:
            pres_q14 = exc_q14[pexc : pexc + subfr_length]

        for i in range(subfr_length):
            lpc_pred_q10 = lpc_order >> 1
            for j in range(lpc_order):
                lpc_pred_q10 = smlawb(lpc_pred_q10, s_lpc[MAX_LPC_ORDER + i - 1 - j], a_q12[j])
            s_lpc[MAX_LPC_ORDER + i] = add_sat32(pres_q14[i], lshift_sat32(lpc_pred_q10, 4))
            xq[k * subfr_length + i] = sat16(rshift_round(smulww(s_lpc[MAX_LPC_ORDER + i], gain_q10), 8))

        s_lpc[:MAX_LPC_ORDER] = s_lpc[subfr_length : subfr_length + MAX_LPC_ORDER]

    st.s_lpc_q14 = s_lpc[:MAX_LPC_ORDER]
    return xq


def div32_varq(a32, b32, qres):
    """silk_DIV32_varQ: a/b with qres fractional bits."""
    from .fixed_math import clz32

    a_headrm = clz32(abs(a32)) - 1
    a32_nrm = i32(a32 << a_headrm)
    b_headrm = clz32(abs(b32)) - 1
    b32_nrm = i32(b32 << b_headrm)
    b32_inv = _c_div(0x7FFFFFFF >> 2, i16(b32_nrm >> 16))
    result = smulwb(a32_nrm, b32_inv)
    a32_nrm = i32(a32_nrm - (i32((i32(b32_nrm) * i32(result)) >> 32) << 3))
    result = smlawb(result, a32_nrm, b32_inv)
    lshift = 29 + a_headrm - b_headrm - qres
    if lshift < 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return i32(result >> lshift)
    return 0


def _c_div(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _lpc_analysis_filter(out, out_off, inp, in_off, b_q12, length, order):
    """silk_LPC_analysis_filter: FIR whitening, first `order` outputs 0."""
    for ix in range(order, length):
        in_ptr = in_off + ix - 1
        out32_q12 = smulbb(inp[in_ptr], b_q12[0])
        out32_q12 = i32(out32_q12 + smulbb(inp[in_ptr - 1], b_q12[1]))
        out32_q12 = i32(out32_q12 + smulbb(inp[in_ptr - 2], b_q12[2]))
        for j in range(3, order):
            out32_q12 = i32(out32_q12 + smulbb(inp[in_ptr - j], b_q12[j]))
        out32_q12 = i32((inp[in_ptr + 1] << 12) - out32_q12)
        out[out_off + ix] = sat16(rshift_round(out32_q12, 12))
    for ix in range(order):
        out[out_off + ix] = 0
