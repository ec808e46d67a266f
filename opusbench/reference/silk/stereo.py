"""SILK stereo prediction and mid/side unmixing (RFC 6716 sec. 4.2.7.1
and 4.2.8), a copy of opus_tpu.silk.stereo.

The scalar SILK layer (silk/api.py) uses it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

from . import tables as T
from .fixed_math import i32, rshift_round, sat16, smlawb, smulbb

STEREO_QUANT_SUB_STEPS = 5
STEREO_INTERP_LEN_MS = 8


class StereoDecState:
    def __init__(self):
        self.pred_prev_q13 = [0, 0]
        self.s_mid = [0, 0]
        self.s_side = [0, 0]


def stereo_decode_pred(dec):
    """silk_stereo_decode_pred -> [pred0_Q13, pred1_Q13]."""
    n = dec.decode_icdf(T.STEREO_PRED_JOINT_ICDF, 8)
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[0][2] = n // 5
    ix[1][2] = n - 5 * ix[0][2]
    for ch in range(2):
        ix[ch][0] = dec.decode_icdf(T.UNIFORM3_ICDF, 8)
        ix[ch][1] = dec.decode_icdf(T.UNIFORM5_ICDF, 8)
    pred_q13 = [0, 0]
    for ch in range(2):
        ix[ch][0] += 3 * ix[ch][2]
        low = int(T.STEREO_PRED_QUANT_Q13[ix[ch][0]])
        step = ((int(T.STEREO_PRED_QUANT_Q13[ix[ch][0] + 1]) - low) * 6554) >> 16  # 0.5/5 in Q16
        pred_q13[ch] = i32(low + smulbb(step, 2 * ix[ch][1] + 1))
    pred_q13[0] = i32(pred_q13[0] - pred_q13[1])
    return pred_q13


def stereo_decode_mid_only(dec) -> int:
    return dec.decode_icdf(T.STEREO_ONLY_CODE_MID_ICDF, 8)


def stereo_ms_to_lr(state: StereoDecState, x1, x2, pred_q13, fs_khz, frame_length):
    """silk_stereo_MS_to_LR: in-place; x1/x2 have a 2-sample prefix."""
    x1[0:2] = state.s_mid
    x2[0:2] = state.s_side
    state.s_mid = list(x1[frame_length : frame_length + 2])
    state.s_side = list(x2[frame_length : frame_length + 2])

    pred0 = state.pred_prev_q13[0]
    pred1 = state.pred_prev_q13[1]
    interp_len = STEREO_INTERP_LEN_MS * fs_khz
    denom_q16 = (1 << 16) // interp_len
    delta0 = rshift_round(smulbb(pred_q13[0] - state.pred_prev_q13[0], denom_q16), 16)
    delta1 = rshift_round(smulbb(pred_q13[1] - state.pred_prev_q13[1], denom_q16), 16)
    for n in range(interp_len):
        pred0 += delta0
        pred1 += delta1
        _apply_pred(x1, x2, n, pred0, pred1)
    pred0 = pred_q13[0]
    pred1 = pred_q13[1]
    for n in range(interp_len, frame_length):
        _apply_pred(x1, x2, n, pred0, pred1)
    state.pred_prev_q13 = list(pred_q13)

    for n in range(frame_length):
        s = x1[n + 1] + x2[n + 1]
        d = x1[n + 1] - x2[n + 1]
        x1[n + 1] = sat16(s)
        x2[n + 1] = sat16(d)


def _apply_pred(x1, x2, n, pred0_q13, pred1_q13):
    s = i32((x1[n] + x1[n + 2] + (x1[n + 1] << 1)) << 9)
    s = smlawb(i32(x2[n + 1] << 8), s, pred0_q13)
    s = smlawb(s, i32(x1[n + 1] << 11), pred1_q13)
    x2[n + 1] = sat16(rshift_round(s, 8))
