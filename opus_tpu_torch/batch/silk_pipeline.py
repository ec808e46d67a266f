"""Batch-of-streams SILK decode on a torch device (the port of
opus_tpu.batch.silk_pipeline).

* Host: one front end per mono stream walks the range-coded symbols and
  dequantises the parameters exactly (the port's copy of the reference's
  SILK layer, silk/), then folds every gain and Q-format into float
  planes in the output domain.
* Device: one `silk_synthesis_step` per step (dsp/silk_synthesis.py, one
  CUDA kernel launch on the card) runs the LTP and LPC recurrences of the
  whole batch; the LPC history stays on the device between steps.  The
  output comes back to the host, where each front end keeps it, rounded,
  as the history of its next frame.

Output is at the internal rate (8, 12 or 16 kHz), as in the reference:
20 ms mono frames, one internal rate for the batch, no LBRR data read.
Its parity with the normative fixed-point decoder is float-level (about
1e-3 of an int16 LSB a sample, growing with the LPC feedback).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.silk_synthesis import silk_synthesis_step
from ..rc.decoder import RangeDecoder
from ..silk import tables as T
from ..silk.bitstream import TYPE_VOICED, decode_indices, decode_pulses
from ..silk.decoder import (
    QUANT_LEVEL_ADJUST_Q10,
    SilkChannelState,
    _lpc_analysis_filter,
    decode_parameters,
)
from ..silk.fixed_math import i32, silk_rand

_CHUNK = {8: 10, 12: 20, 16: 20}  # divides subfr_len, <= 2ms*fs - 2


class SilkPlaneFrontEnd:
    """Bitstream front end for one mono SILK stream: exact symbol decode +
    parameter dequant; synthesis state (out_buf) tracks the device output."""

    def __init__(self, fs_khz: int):
        self.st = SilkChannelState()
        self.st.nb_subfr = 4
        self.st.set_fs(fs_khz, fs_khz * 1000)
        self.st.n_frames_per_packet = 1
        self.fs_khz = fs_khz

    def decode_planes(self, payload: bytes) -> dict:
        st = self.st
        dec = RangeDecoder(payload)
        st.n_frames_decoded = 0
        st.vad_flags[0] = 1 if dec.decode_bit_logp(1) else 0
        st.lbrr_flag = 1 if dec.decode_bit_logp(1) else 0
        # (LBRR data absent for the bench/test streams used here.)
        ind = decode_indices(dec, st, 0, False, 0)
        pulses = decode_pulses(dec, ind.signal_type, ind.quant_offset_type, st.frame_length)
        ctrl = decode_parameters(st, ind, 0)
        st.first_frame_after_reset = 0
        st.prev_signal_type = ind.signal_type

        # Excitation with pseudorandom sign flips (output-domain scale folded
        # in per subframe).
        offset_q10 = int(T.QUANTIZATION_OFFSETS_Q10[ind.signal_type >> 1][ind.quant_offset_type])
        rand_seed = ind.seed
        L = st.frame_length
        sub = st.subfr_length
        gexc = np.empty(L, np.float32)
        gains = [g / 65536.0 for g in ctrl.gains_q16]
        for i in range(L):
            rand_seed = silk_rand(rand_seed)
            v = pulses[i] << 14
            if v > 0:
                v -= QUANT_LEVEL_ADJUST_Q10 << 4
            elif v < 0:
                v += QUANT_LEVEL_ADJUST_Q10 << 4
            v += offset_q10 << 4
            if rand_seed < 0:
                v = -v
            gexc[i] = (v / 16384.0) * gains[i // sub]
            rand_seed = i32(rand_seed + pulses[i])

        voiced = ind.signal_type == TYPE_VOICED
        head_len = 18 * self.fs_khz + 2  # max lag + LTP_ORDER/2
        head = np.zeros(head_len, np.float32)
        if voiced:
            # Rewhiten the LTP history (output domain): run the LPC analysis
            # filter over out_buf and keep the last head_len samples.
            order = st.lpc_order
            lag = ctrl.pitch_l[0]
            start_idx = max(1, st.ltp_mem_length - lag - order - 2)
            s_ltp = [0] * st.ltp_mem_length
            _lpc_analysis_filter(
                s_ltp, start_idx, st.out_buf, start_idx,
                ctrl.pred_coef_q12[0], st.ltp_mem_length - start_idx, order,
            )
            # LTP scaling for the first subframe (output domain): the
            # reference scales by LTP_scale_Q14; fold it into the head.
            scale = ctrl.ltp_scale_q14 / 16384.0
            tail = np.array(s_ltp[-head_len:], np.float32) * scale
            head[-len(tail):] = tail

        order = st.lpc_order
        return {
            "gexc": gexc,
            "a1": np.array(ctrl.pred_coef_q12[0][:order], np.float32) / 4096.0,
            "a2": np.array(ctrl.pred_coef_q12[1][:order], np.float32) / 4096.0,
            "voiced": voiced,
            "lags": np.array([max(l, _CHUNK[self.fs_khz] + 2) for l in ctrl.pitch_l[:4]], np.int32),
            "b": np.array(ctrl.ltp_coef_q14, np.float32).reshape(4, 5) / 16384.0,
            "head": head,
            "rng": dec.rng & 0xFFFFFFFF,
        }

    def commit_output(self, xq: np.ndarray) -> None:
        """Feed the device output back as the decoder's history."""
        st = self.st
        x = np.clip(np.rint(xq), -32768, 32767).astype(int)
        mv = st.ltp_mem_length - st.frame_length
        if mv > 0:
            st.out_buf[:mv] = st.out_buf[st.frame_length : st.ltp_mem_length]
            st.out_buf[mv : st.ltp_mem_length] = x.tolist()
        else:
            st.out_buf[: st.ltp_mem_length] = x[-st.ltp_mem_length :].tolist()


class BatchedSilkDecoder:
    """Decode a fixed batch of mono SILK streams (same internal rate), one
    20 ms frame per stream per step, the synthesis on `device`."""

    def __init__(self, batch: int, fs_khz: int = 16, *, device):
        if fs_khz not in _CHUNK:
            raise ValueError(f"fs_khz must be one of {sorted(_CHUNK)}, got {fs_khz}")
        self.batch = batch
        self.fs_khz = fs_khz
        self.device = torch.device(device)
        self.fronts = [SilkPlaneFrontEnd(fs_khz) for _ in range(batch)]
        order = self.fronts[0].st.lpc_order
        self.lpc_hist = torch.zeros(batch, order, device=self.device)
        self.order = order

    def planes(self, payloads: list) -> dict:
        """Host step: every stream's planes, stacked [B, ...] in numpy."""
        if len(payloads) != self.batch:
            raise ValueError(f"{len(payloads)} payloads for a batch of {self.batch}")
        planes = [f.decode_planes(p) for f, p in zip(self.fronts, payloads)]
        return {k: np.stack([p[k] for p in planes]) for k in
                ("gexc", "a1", "a2", "voiced", "lags", "b", "head")}

    def synthesize(self, planes: dict) -> torch.Tensor:
        """Device step: upload the planes, one synthesis launch; the LPC
        history is carried on the device.  Returns xq [B, L] there."""
        dev = self.device
        up = {k: torch.from_numpy(v).to(dev) for k, v in planes.items()}
        xq, self.lpc_hist = silk_synthesis_step(
            up["gexc"], up["a1"], up["a2"], up["voiced"], up["lags"], up["b"], up["head"],
            self.lpc_hist, subfr_len=self.fronts[0].st.subfr_length, nb_subfr=4,
            chunk=_CHUNK[self.fs_khz])
        return xq

    def decode_frames(self, payloads: list) -> np.ndarray:
        """One step: planes on the host, the synthesis on the device, the
        output fed back to every front end.  Returns xq [B, L] float32 at
        int16 scale."""
        out = self.synthesize(self.planes(payloads)).cpu().numpy()
        for f, row in zip(self.fronts, out):
            f.commit_output(row)
        return out

    def final_ranges(self) -> list:
        return [None] * self.batch  # set per decode in planes["rng"]
