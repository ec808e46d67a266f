"""The SILK symbol layer (RFC 6716 sec. 4.2.3-4.2.7), a copy of
opus_tpu.silk.bitstream: header flags, indices and excitation pulses read
from the port's range decoder.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import tables as T

TYPE_NO_VOICE_ACTIVITY = 0
TYPE_UNVOICED = 1
TYPE_VOICED = 2

MAX_NB_SUBFR = 4
LTP_ORDER = 5
SHELL_FRAME = 16
SILK_MAX_PULSES = 16
N_RATE_LEVELS = 10
NLSF_QUANT_MAX_AMPLITUDE = 4

CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2

# Per-bandwidth NLSF codebook descriptors (RFC 6716 tab. 23/24).
@dataclasses.dataclass(frozen=True)
class NlsfCodebook:
    order: int
    n_vectors: int
    quant_step_size_q16: int
    inv_quant_step_size_q6: int
    cb1_q8: np.ndarray
    cb1_wght_q9: np.ndarray
    cb1_icdf: np.ndarray
    pred_q8: np.ndarray
    ec_sel: np.ndarray
    ec_icdf: np.ndarray
    delta_min_q15: np.ndarray


NLSF_CB_NB_MB = NlsfCodebook(
    order=10,
    n_vectors=32,
    quant_step_size_q16=11796,   # SILK_FIX_CONST(0.18, 16)
    inv_quant_step_size_q6=356,  # SILK_FIX_CONST(1/0.18, 6)
    cb1_q8=T.NLSF_CB1_NB_MB_Q8,
    cb1_wght_q9=T.NLSF_CB1_WGHT_NB_MB_Q9,
    cb1_icdf=T.NLSF_CB1_ICDF_NB_MB,
    pred_q8=T.NLSF_PRED_NB_MB_Q8,
    ec_sel=T.NLSF_CB2_SELECT_NB_MB,
    ec_icdf=T.NLSF_CB2_ICDF_NB_MB,
    delta_min_q15=T.NLSF_DELTA_MIN_NB_MB_Q15,
)

NLSF_CB_WB = NlsfCodebook(
    order=16,
    n_vectors=32,
    quant_step_size_q16=9830,    # SILK_FIX_CONST(0.15, 16)
    inv_quant_step_size_q6=427,  # SILK_FIX_CONST(1/0.15, 6)
    cb1_q8=T.NLSF_CB1_WB_Q8,
    cb1_wght_q9=T.NLSF_CB1_WGHT_WB_Q9,
    cb1_icdf=T.NLSF_CB1_ICDF_WB,
    pred_q8=T.NLSF_PRED_WB_Q8,
    ec_sel=T.NLSF_CB2_SELECT_WB,
    ec_icdf=T.NLSF_CB2_ICDF_WB,
    delta_min_q15=T.NLSF_DELTA_MIN_WB_Q15,
)

_LTP_GAIN_ICDF = (T.LTP_GAIN_ICDF_0, T.LTP_GAIN_ICDF_1, T.LTP_GAIN_ICDF_2)


@dataclasses.dataclass
class SideInfo:
    """Decoded per-frame side information (silk SideInfoIndices)."""

    signal_type: int = TYPE_NO_VOICE_ACTIVITY
    quant_offset_type: int = 0
    gains_indices: list = dataclasses.field(default_factory=lambda: [0] * MAX_NB_SUBFR)
    nlsf_indices: list = dataclasses.field(default_factory=lambda: [0] * 17)
    nlsf_interp_coef_q2: int = 4
    lag_index: int = 0
    contour_index: int = 0
    per_index: int = 0
    ltp_index: list = dataclasses.field(default_factory=lambda: [0] * MAX_NB_SUBFR)
    ltp_scale_index: int = 0
    seed: int = 0


def nlsf_unpack(cb: NlsfCodebook, cb1_index: int):
    """silk_NLSF_unpack: per-coefficient entropy table index + predictor."""
    ec_ix = [0] * cb.order
    pred_q8 = [0] * cb.order
    sel = cb.ec_sel[cb1_index * cb.order // 2 : (cb1_index + 1) * cb.order // 2]
    for i in range(0, cb.order, 2):
        entry = int(sel[i // 2])
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i] = int(cb.pred_q8[i + (entry & 1) * (cb.order - 1)])
        ec_ix[i + 1] = ((entry >> 5) & 7) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i + 1] = int(cb.pred_q8[i + 1 + ((entry >> 4) & 1) * (cb.order - 1)])
    return ec_ix, pred_q8


def decode_indices(dec, state, frame_index: int, decode_lbrr: bool, cond_coding: int) -> SideInfo:
    """silk_decode_indices: side-info symbols for one 20/10 ms SILK frame.

    `state` carries fs_khz, nb_subfr, nlsf codebook, VAD flags and the
    inter-frame entropy context (ec_prev_signal_type / ec_prev_lag_index).
    """
    ind = SideInfo()
    if decode_lbrr or state.vad_flags[frame_index]:
        ix = dec.decode_icdf(T.TYPE_OFFSET_VAD_ICDF, 8) + 2
    else:
        ix = dec.decode_icdf(T.TYPE_OFFSET_NO_VAD_ICDF, 8)
    ind.signal_type = ix >> 1
    ind.quant_offset_type = ix & 1

    if cond_coding == CODE_CONDITIONALLY:
        ind.gains_indices[0] = dec.decode_icdf(T.DELTA_GAIN_ICDF, 8)
    else:
        ind.gains_indices[0] = dec.decode_icdf(T.GAIN_ICDF[ind.signal_type], 8) << 3
        ind.gains_indices[0] += dec.decode_icdf(T.UNIFORM8_ICDF, 8)
    for i in range(1, state.nb_subfr):
        ind.gains_indices[i] = dec.decode_icdf(T.DELTA_GAIN_ICDF, 8)

    cb = state.nlsf_cb
    ind.nlsf_indices[0] = dec.decode_icdf(
        cb.cb1_icdf[(ind.signal_type >> 1) * cb.n_vectors : (ind.signal_type >> 1) * cb.n_vectors + cb.n_vectors], 8
    )
    ec_ix, _pred = nlsf_unpack(cb, ind.nlsf_indices[0])
    for i in range(cb.order):
        ix = dec.decode_icdf(cb.ec_icdf[ec_ix[i] : ec_ix[i] + 2 * NLSF_QUANT_MAX_AMPLITUDE + 1], 8)
        if ix == 0:
            ix -= dec.decode_icdf(T.NLSF_EXT_ICDF, 8)
        elif ix == 2 * NLSF_QUANT_MAX_AMPLITUDE:
            ix += dec.decode_icdf(T.NLSF_EXT_ICDF, 8)
        ind.nlsf_indices[i + 1] = ix - NLSF_QUANT_MAX_AMPLITUDE

    if state.nb_subfr == MAX_NB_SUBFR:
        ind.nlsf_interp_coef_q2 = dec.decode_icdf(T.NLSF_INTERP_FACTOR_ICDF, 8)
    else:
        ind.nlsf_interp_coef_q2 = 4

    if ind.signal_type == TYPE_VOICED:
        decode_absolute = True
        if cond_coding == CODE_CONDITIONALLY and state.ec_prev_signal_type == TYPE_VOICED:
            delta = dec.decode_icdf(T.PITCH_DELTA_ICDF, 8)
            if delta > 0:
                ind.lag_index = state.ec_prev_lag_index + (delta - 9)
                decode_absolute = False
        if decode_absolute:
            ind.lag_index = dec.decode_icdf(T.PITCH_LAG_ICDF, 8) * (state.fs_khz >> 1)
            ind.lag_index += dec.decode_icdf(state.pitch_lag_low_bits_icdf, 8)
        state.ec_prev_lag_index = ind.lag_index

        ind.contour_index = dec.decode_icdf(state.pitch_contour_icdf, 8)

        ind.per_index = dec.decode_icdf(T.LTP_PER_INDEX_ICDF, 8)
        for k in range(state.nb_subfr):
            ind.ltp_index[k] = dec.decode_icdf(_LTP_GAIN_ICDF[ind.per_index], 8)

        if cond_coding == CODE_INDEPENDENTLY:
            ind.ltp_scale_index = dec.decode_icdf(T.LTPSCALE_ICDF, 8)
        else:
            ind.ltp_scale_index = 0
    state.ec_prev_signal_type = ind.signal_type

    ind.seed = dec.decode_icdf(T.UNIFORM4_ICDF, 8)
    return ind


def _decode_split(dec, p: int, shell_table: np.ndarray):
    if p > 0:
        off = int(T.SHELL_CODE_TABLE_OFFSETS[p])
        a = dec.decode_icdf(shell_table[off : off + p + 1], 8)
        return a, p - a
    return 0, 0


def shell_decoder(dec, pulses4: int) -> list:
    """silk_shell_decoder: one 16-sample shell frame of pulse magnitudes."""
    out = [0] * 16
    p3 = _decode_split(dec, pulses4, T.SHELL_CODE_TABLE3)
    for half in range(2):
        p2 = _decode_split(dec, p3[half], T.SHELL_CODE_TABLE2)
        for quarter in range(2):
            p1 = _decode_split(dec, p2[quarter], T.SHELL_CODE_TABLE1)
            for eighth in range(2):
                a, b = _decode_split(dec, p1[eighth], T.SHELL_CODE_TABLE0)
                base = half * 8 + quarter * 4 + eighth * 2
                out[base] = a
                out[base + 1] = b
    return out


def decode_pulses(dec, signal_type: int, quant_offset_type: int, frame_length: int) -> list:
    """silk_decode_pulses: full excitation pulse vector for one frame."""
    rate_level = dec.decode_icdf(T.RATE_LEVELS_ICDF[signal_type >> 1], 8)

    n_blocks = frame_length >> 4
    if n_blocks * SHELL_FRAME < frame_length:
        n_blocks += 1  # 10 ms @ 12 kHz: 120 samples = 7.5 blocks -> 8

    sum_pulses = [0] * n_blocks
    n_lshifts = [0] * n_blocks
    for i in range(n_blocks):
        sum_pulses[i] = dec.decode_icdf(T.PULSES_PER_BLOCK_ICDF[rate_level], 8)
        while sum_pulses[i] == SILK_MAX_PULSES + 1:
            n_lshifts[i] += 1
            row = T.PULSES_PER_BLOCK_ICDF[N_RATE_LEVELS - 1]
            if n_lshifts[i] == 10:
                row = row[1:]
            sum_pulses[i] = dec.decode_icdf(row, 8)

    pulses = [0] * (n_blocks * SHELL_FRAME)
    for i in range(n_blocks):
        if sum_pulses[i] > 0:
            pulses[i * SHELL_FRAME : (i + 1) * SHELL_FRAME] = shell_decoder(dec, sum_pulses[i])

    for i in range(n_blocks):
        if n_lshifts[i] > 0:
            nls = n_lshifts[i]
            for k in range(SHELL_FRAME):
                q = pulses[i * SHELL_FRAME + k]
                for _ in range(nls):
                    q = (q << 1) + dec.decode_icdf(T.LSB_ICDF, 8)
                pulses[i * SHELL_FRAME + k] = q
            sum_pulses[i] |= nls << 5

    decode_signs(dec, pulses, frame_length, signal_type, quant_offset_type, sum_pulses)
    return pulses[:frame_length] if n_blocks * SHELL_FRAME > frame_length else pulses


def decode_signs(dec, pulses, frame_length, signal_type, quant_offset_type, sum_pulses):
    """silk_decode_signs: sign bit per nonzero sample, context by pulse count."""
    base = 7 * (quant_offset_type + (signal_type << 1))
    icdf_ptr = T.SIGN_ICDF[base : base + 7]
    n_blocks = (frame_length + SHELL_FRAME // 2) >> 4
    for i in range(n_blocks):
        p = sum_pulses[i]
        if p > 0:
            icdf = (int(icdf_ptr[min(p & 0x1F, 6)]), 0)
            for j in range(SHELL_FRAME):
                k = i * SHELL_FRAME + j
                if pulses[k] > 0:
                    pulses[k] *= 2 * dec.decode_icdf(icdf, 8) - 1
