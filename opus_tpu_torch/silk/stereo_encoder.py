"""The Python SILK stereo (mid/side) encoder, a copy of
opus_tpu.silk.stereo_encoder.

The Encoder builds it for stereo voice and hybrid sessions beside the
native encoders of native/frontend.py.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .encoder import SilkEncoder
from .fixed_math import i32, rshift_round, sat16, smlawb, smulbb
from .stereo import STEREO_INTERP_LEN_MS


def _dequant_pred(i0: int, ix1: int) -> int:
    low = int(T.STEREO_PRED_QUANT_Q13[i0])
    step = ((int(T.STEREO_PRED_QUANT_Q13[i0 + 1]) - low) * 6554) >> 16
    return i32(low + smulbb(step, 2 * ix1 + 1))


def quantize_stereo_pred(w_q13: float):
    """Scan the stereo-prediction codebook for the closest dequantised
    value; returns (i0, ix1, dequant_q13)."""
    best = None
    for i0 in range(15):
        for ix1 in range(5):
            q = _dequant_pred(i0, ix1)
            err = abs(q - w_q13)
            if best is None or err < best[0]:
                best = (err, i0, ix1, q)
    return best[1], best[2], best[3]


class SilkStereoEncoder:
    """Two-channel SILK encoder (mid/side with quantised prediction)."""

    def __init__(self, fs_khz: int):
        self.fs_khz = fs_khz
        self.mid = SilkEncoder(fs_khz)
        self.side = SilkEncoder(fs_khz)
        self.pred_prev_q13 = [0, 0]
        self.s_mid = [0, 0]  # decoded-mid 2-sample tail (decoder replay)
        self.mid_hist = 0.0  # original mid[-1] for the LP/HP fit
        self.last_range = 0

    def _fit_weights(self, mid: np.ndarray, side: np.ndarray):
        """Least-squares fit of side on {LP(mid), HP(mid)} -> Q13 weights."""
        m = np.concatenate([[self.mid_hist], mid.astype(np.float64)])
        lp = np.empty(len(mid))
        lp[:-1] = (m[:-2] + 2.0 * m[1:-1] + m[2:]) * 0.25
        lp[-1] = (m[-2] + 3.0 * m[-1]) * 0.25  # edge: repeat last sample
        hp = mid - lp
        s = side.astype(np.float64)
        a = np.array([[np.dot(lp, lp) + 1e3, np.dot(lp, hp)],
                      [np.dot(lp, hp), np.dot(hp, hp) + 1e3]])
        b = np.array([np.dot(lp, s), np.dot(hp, s)])
        w = np.linalg.solve(a, b)
        w = np.clip(w, -1.0, 1.0)
        self.mid_hist = float(mid[-1])
        return float(w[0] * 8192.0), float(w[1] * 8192.0)

    def _pred_contribution(self, xq_mid: np.ndarray, pred_q13) -> np.ndarray:
        """Exact integer replica of the decoder's _apply_pred loop over the
        decoded mid (stereo.py::stereo_ms_to_lr): returns c[n] added to the
        side at output index n+1, for n in 0..L-1."""
        L = len(xq_mid)
        x1 = np.concatenate([np.array(self.s_mid, dtype=np.int64),
                             xq_mid.astype(np.int64)])
        c = np.zeros(L, dtype=np.int64)
        interp_len = STEREO_INTERP_LEN_MS * self.fs_khz
        denom_q16 = (1 << 16) // interp_len
        p0, p1 = self.pred_prev_q13
        d0 = rshift_round(smulbb(pred_q13[0] - self.pred_prev_q13[0], denom_q16), 16)
        d1 = rshift_round(smulbb(pred_q13[1] - self.pred_prev_q13[1], denom_q16), 16)
        for n in range(L):
            if n < interp_len:
                p0 += d0
                p1 += d1
            elif n == interp_len:
                p0, p1 = pred_q13
            s = i32((int(x1[n]) + int(x1[n + 2]) + (int(x1[n + 1]) << 1)) << 9)
            s = smlawb(0, s, p0)
            s = smlawb(s, i32(int(x1[n + 1]) << 11), p1)
            c[n] = rshift_round(s, 8)
        self.s_mid = [int(x1[L]), int(x1[L + 1])]
        return c

    def encode_packet_cbr(self, left: np.ndarray, right: np.ndarray,
                          budget_bytes: int,
                          lbrr_x: tuple | None = None,
                          lbrr_enc: "SilkStereoEncoder | None" = None) -> bytes:
        """Encode one 10-60 ms stereo block -> SILK payload bytes.

        In-band FEC: ``lbrr_x = (prev_left, prev_right)`` is re-encoded
        coarsely by ``lbrr_enc`` (a separate SilkStereoEncoder) into LBRR
        frames before the regular frames, per the decoder's stereo skip
        path (silk/api.py: stereo pred + mid + side per LBRR frame, all
        per-frame LBRR flags set).
        """
        from ..rc.encoder import RangeEncoder

        L = self.mid.frame_length
        if len(left) == L // 2:
            nf, L = 1, L // 2  # one 10 ms frame
        else:
            nf = len(left) // L
            assert nf * L == len(left) and 1 <= nf <= 3
        lf = left.astype(np.int64)
        rf = right.astype(np.int64)
        mid = np.array([rshift_round(int(a + b), 1) for a, b in zip(lf, rf)], np.int64)
        side = np.array([sat16(rshift_round(int(a - b), 1)) for a, b in zip(lf, rf)], np.int64)
        has_lbrr = lbrr_x is not None and lbrr_enc is not None
        if has_lbrr:
            ll = lbrr_x[0].astype(np.int64)
            lr = lbrr_x[1].astype(np.int64)
            lmid = np.array([rshift_round(int(a + b), 1) for a, b in zip(ll, lr)], np.int64)
            lside = np.array([sat16(rshift_round(int(a - b), 1)) for a, b in zip(ll, lr)], np.int64)

        headroom = 1.8
        saved = self.snapshot()
        saved_lbrr = lbrr_enc.snapshot() if has_lbrr else None
        payload = b""
        for _ in range(6):
            self.restore(saved)
            if has_lbrr:
                lbrr_enc.restore(saved_lbrr)
            buf = bytearray(2800)
            enc = RangeEncoder(buf)
            for ch in range(2):
                for f in range(nf):
                    enc.encode_bit_logp(1, 1)  # VAD
                enc.encode_bit_logp(1 if has_lbrr else 0, 1)  # LBRR (per channel)
            if has_lbrr:
                for ch in range(2):  # per-channel LBRR frame flags, all set
                    if nf > 1:
                        tbl = T.LBRR_FLAGS_2_ICDF if nf == 2 else T.LBRR_FLAGS_3_ICDF
                        enc.encode_icdf((1 << nf) - 2, tbl, 8)
                for e_dst, e_src in ((lbrr_enc.mid, self.mid), (lbrr_enc.side, self.side)):
                    e_dst.ec_prev_signal_type = e_src.ec_prev_signal_type
                    e_dst.ec_prev_lag_index = e_src.ec_prev_lag_index
                for f in range(nf):
                    lbrr_enc._encode_stereo_frame(
                        enc, lmid[f * L : (f + 1) * L], lside[f * L : (f + 1) * L],
                        headroom * 2.0, cond=f > 0)
                for e_dst, e_src in ((self.mid, lbrr_enc.mid), (self.side, lbrr_enc.side)):
                    e_dst.ec_prev_signal_type = e_src.ec_prev_signal_type
                    e_dst.ec_prev_lag_index = e_src.ec_prev_lag_index
            for f in range(nf):
                m = mid[f * L : (f + 1) * L]
                s = side[f * L : (f + 1) * L]
                self._encode_stereo_frame(enc, m, s, headroom, cond=f > 0)
            nbytes = min((enc.tell() + 7) >> 3, 1275)
            enc.shrink(nbytes)
            enc.done()
            payload = bytes(enc.data())
            self.last_range = enc.rng & 0xFFFFFFFF
            if len(payload) <= budget_bytes or headroom <= 0.36:
                break
            headroom = max(0.35, headroom / (1.15 * max(1.0, len(payload) / max(budget_bytes, 1)) ** 0.5))
        return payload

    def encode_frame_into(self, enc, left: np.ndarray, right: np.ndarray,
                          headroom: float,
                          lbrr_x: tuple | None = None,
                          lbrr_enc: "SilkStereoEncoder | None" = None) -> None:
        """Write one 10/20 ms stereo SILK frame (with header flags) into a
        shared RangeEncoder — the hybrid-mode low band.  With ``lbrr_x``
        (previous frame's left/right) and ``lbrr_enc``, an LBRR stereo
        frame precedes the regular frame (hybrid in-band FEC)."""
        lf = left.astype(np.int64)
        rf = right.astype(np.int64)
        mid = np.array([rshift_round(int(a + b), 1) for a, b in zip(lf, rf)], np.int64)
        side = np.array([sat16(rshift_round(int(a - b), 1)) for a, b in zip(lf, rf)], np.int64)
        has_lbrr = lbrr_x is not None and lbrr_enc is not None
        for _ch in range(2):
            enc.encode_bit_logp(1, 1)  # VAD
            enc.encode_bit_logp(1 if has_lbrr else 0, 1)  # LBRR
        if has_lbrr:
            ll = lbrr_x[0].astype(np.int64)
            lr = lbrr_x[1].astype(np.int64)
            lmid = np.array([rshift_round(int(a + b), 1) for a, b in zip(ll, lr)], np.int64)
            lside = np.array([sat16(rshift_round(int(a - b), 1)) for a, b in zip(ll, lr)], np.int64)
            for e_dst, e_src in ((lbrr_enc.mid, self.mid), (lbrr_enc.side, self.side)):
                e_dst.ec_prev_signal_type = e_src.ec_prev_signal_type
                e_dst.ec_prev_lag_index = e_src.ec_prev_lag_index
            lbrr_enc._encode_stereo_frame(enc, lmid, lside, headroom * 2.0, cond=False)
            for e_dst, e_src in ((self.mid, lbrr_enc.mid), (self.side, lbrr_enc.side)):
                e_dst.ec_prev_signal_type = e_src.ec_prev_signal_type
                e_dst.ec_prev_lag_index = e_src.ec_prev_lag_index
        self._encode_stereo_frame(enc, mid, side, headroom, cond=False)

    def snapshot(self):
        return (self._snapshot(self.mid), self._snapshot(self.side),
                list(self.pred_prev_q13), list(self.s_mid), self.mid_hist)

    def restore(self, s) -> None:
        self._restore(self.mid, s[0])
        self._restore(self.side, s[1])
        self.pred_prev_q13 = list(s[2])
        self.s_mid = list(s[3])
        self.mid_hist = s[4]

    def _encode_stereo_frame(self, enc, mid, side, headroom, cond):
        # Stereo prediction: fit on the originals, quantise, encode the
        # joint index then the per-channel residual indices
        # (stereo.py::stereo_decode_pred read order).
        w0_q13, w1_q13 = self._fit_weights(mid.astype(np.float64), side.astype(np.float64))
        i0_0, ix1_0, q0 = quantize_stereo_pred(w0_q13)
        i0_1, ix1_1, q1 = quantize_stereo_pred(w1_q13)
        n_joint = 5 * (i0_0 // 3) + (i0_1 // 3)
        enc.encode_icdf(n_joint, T.STEREO_PRED_JOINT_ICDF, 8)
        for i0, ix1 in ((i0_0, ix1_0), (i0_1, ix1_1)):
            enc.encode_icdf(i0 % 3, T.UNIFORM3_ICDF, 8)
            enc.encode_icdf(ix1, T.UNIFORM5_ICDF, 8)
        # stereo_decode_pred returns [q0 - q1, q1]; replay that exactly so
        # the contribution equals LP*q0 + HP*q1 in Q13.
        pred_q13 = [i32(q0 - q1), i32(q1)]

        # Mid channel (closed loop gives the decoded mid for the side pred).
        self.mid.encode_frame(enc, mid, headroom=headroom, write_header=False, cond=cond)
        xq_mid = np.clip(np.rint(self.mid.xq_buf[-len(mid):]), -32768, 32767).astype(np.int64)

        c = self._pred_contribution(xq_mid, pred_q13)
        self.pred_prev_q13 = list(pred_q13)
        # c[n] lands on side output index n+1 == coded side sample n-1; the
        # frame's last sample takes the edge value (next frame's c[0] is
        # unknown at encode time).
        resid = np.empty(len(side), np.int64)
        resid[: len(side) - 1] = side[: len(side) - 1] - c[1:]
        resid[-1] = side[-1] - c[-1]
        resid = np.array([sat16(int(v)) for v in resid], np.int64)
        self.side.encode_frame(enc, resid, headroom=headroom, write_header=False, cond=cond)

    @staticmethod
    def _snapshot(e: SilkEncoder):
        return e.snapshot()

    @staticmethod
    def _restore(e: SilkEncoder, s):
        e.restore(s)
