"""SILK internal-rate -> 48 kHz resampling as a dense matmul (a copy of
opus_tpu.dsp.resample, the numpy builder of the per-rate banks).

The serving pipelines can ship SILK PCM at the internal rate (8/12/16
kHz, int16: 3-6x fewer upload bytes than 48 kHz PCM) and resample on the
device.  The normative decoder-direction resampler
(silk_resampler_private_IIR_FIR: a 2x allpass-IIR upsampler feeding a
12-phase/8-tap windowed-sinc interpolator, with a 1 ms delay-buffer
framing) is linear and 10 ms-block-time-invariant, so its action on one
10/20 ms frame is exactly a matrix applied to [previous-frame tail |
current frame]: the IIR state is a linear function of past inputs whose
influence decays below f32 noise within about 40 samples.

`resample_matrix(fs_khz, n_in)` builds that matrix [T+n_in, n_out] from a
float twin of the fixed-point structure (same framing, same Q16 index
walk, float filters).  Parity with the bit-exact fixed-point path is about
1e-4 of full scale (its rounding noise).  The builders are copies of the
reference's and must stay bit-identical to them (tests/test_torch_opus.py);
so are the constants below, copied from opus_tpu/silk/resampler.py and
opus_tpu/silk/tables.py because the port imports nothing of opus_tpu.
"""

from __future__ import annotations

import functools

import numpy as np

#: silk/resampler.c delay_matrix_dec: input delay by (fs_in kHz, fs_out kHz).
_DELAY_DEC = {
    8: {8: 4, 12: 0, 16: 2, 24: 0, 48: 0},
    12: {8: 0, 12: 9, 16: 4, 24: 7, 48: 4},
    16: {8: 0, 12: 3, 16: 12, 24: 7, 48: 7},
    24: {8: 0, 12: 0, 16: 0, 24: 0, 48: 0},
    48: {8: 0, 12: 0, 16: 0, 24: 0, 48: 0},
}
#: The 2x allpass upsampler's coefficients (Q16), two branches.
UP2_HQ_0 = (1746, 14986, -26453)
UP2_HQ_1 = (6854, 25769, -9994)
#: The 12-phase fractional interpolator's half-taps (Q15).
RESAMPLER_FRAC_FIR_12 = [
    [189, -600, 617, 30567], [117, -159, -1070, 29704], [52, 221, -2392, 28276],
    [-4, 529, -3350, 26341], [-48, 758, -3956, 23973], [-80, 905, -4235, 21254],
    [-99, 972, -4222, 18278], [-107, 967, -3957, 15143], [-103, 896, -3487, 11950],
    [-91, 773, -2865, 8798], [-71, 611, -2143, 5784], [-46, 425, -1375, 2996],
]

#: Previous-frame tail samples (at the input rate) that stand in for the
#: IIR/FIR/delay-buffer state.  The slowest allpass pole is ~0.64, so 48
#: samples bound the truncated tail below 1e-9 relative — f32-invisible.
TAIL = 48

_ORDER_FIR_12 = 8


def _up2_hq_f(s, x):
    """Float twin of silk_resampler_private_up2_HQ, vectorised over a
    trailing column axis: x [n, C] -> [2n, C]; s [6, C] carried state."""
    n, C = x.shape
    out = np.zeros((2 * n, C), np.float64)
    c00, c01, c02 = (v / 65536.0 for v in UP2_HQ_0)
    c10, c11, c12 = (v / 65536.0 for v in UP2_HQ_1)
    for k in range(n):
        in32 = x[k] * 1024.0
        y = in32 - s[0]
        t = y * c00
        out1 = s[0] + t
        s[0] = in32 + t
        y = out1 - s[1]
        t = y * c01
        out2 = s[1] + t
        s[1] = out1 + t
        y = out2 - s[2]
        t = y + y * c02
        out[2 * k] = (s[2] + t) / 1024.0
        s[2] = out2 + t
        y = in32 - s[3]
        t = y * c10
        out1 = s[3] + t
        s[3] = in32 + t
        y = out1 - s[4]
        t = y * c11
        out2 = s[4] + t
        s[4] = out1 + t
        y = out2 - s[5]
        t = y + y * c12
        out[2 * k + 1] = (s[5] + t) / 1024.0
        s[5] = out2 + t
    return out


class _FloatResampler:
    """Float twin of silk.resampler.Resampler (decoder direction, up-
    sampling modes only) with the exact framing and Q16 index walk."""

    def __init__(self, fs_in_khz: int, C: int):
        if fs_in_khz not in (8, 12, 16):
            raise ValueError("decoder-direction internal rates are 8/12/16 kHz")
        self.frac = np.asarray(RESAMPLER_FRAC_FIR_12, np.float64)
        self.fs_in_khz = fs_in_khz
        self.batch_size = fs_in_khz * 10
        self.input_delay = _DELAY_DEC[fs_in_khz][48]
        self.delay_buf = np.zeros((48, C), np.float64)
        self.s_iir = np.zeros((6, C), np.float64)
        self.s_fir = np.zeros((_ORDER_FIR_12, C), np.float64)
        fs_in_hz, fs_out_hz = fs_in_khz * 1000, 48000
        inv = ((fs_in_hz << 15) // fs_out_hz) << 2
        while ((inv * fs_out_hz) >> 16) < (fs_in_hz << 1):
            inv += 1
        self.inv_ratio_q16 = inv

    def process(self, x):
        """x [L, C] -> [L*48//fs, C] (the two-phase 1 ms framing)."""
        in_len = len(x)
        n = self.fs_in_khz - self.input_delay
        self.delay_buf[self.input_delay : self.input_delay + n] = x[:n]
        outs = [
            self._iir_fir(self.delay_buf[: self.fs_in_khz]),
            self._iir_fir(x[n : n + in_len - self.fs_in_khz]),
        ]
        if self.input_delay:
            self.delay_buf[: self.input_delay] = x[in_len - self.input_delay :]
        return np.concatenate(outs, axis=0)

    def _iir_fir(self, x):
        C = x.shape[1]
        length = len(x)
        outs = []
        off = 0
        while True:
            n = min(length, self.batch_size)
            buf = np.concatenate(
                [self.s_fir, _up2_hq_f(self.s_iir, x[off : off + n])], axis=0
            )
            max_index_q16 = n << 17
            index_q16 = 0
            while index_q16 < max_index_q16:
                ti = ((index_q16 & 0xFFFF) * 12) >> 16
                b = index_q16 >> 16
                w = np.concatenate([self.frac[ti], self.frac[11 - ti][::-1]])
                outs.append(w @ buf[b : b + 8] / 32768.0)
                index_q16 += self.inv_ratio_q16
            off += n
            length -= n
            self.s_fir = buf[2 * n : 2 * n + _ORDER_FIR_12]
            if length <= 0:
                break
        return np.stack(outs, axis=0)


@functools.lru_cache(maxsize=None)
def resample_matrix(fs_khz: int, n_in: int, tail: int = TAIL) -> np.ndarray:
    """[tail + n_in, n_out] float32: out-frame = [prev-tail | frame] @ M.

    Column j of the input is the previous frame's sample L-tail+j for
    j < tail, else current-frame sample j-tail; built by superposition
    (the float twin is exactly linear).  A fresh stream (or a rate
    switch, where libopus re-inits the resampler) uses a ZERO tail —
    identical to the re-initialised state."""
    n_out = n_in * 48 // fs_khz
    C = tail + n_in
    rs = _FloatResampler(fs_khz, C)
    prev = np.zeros((n_in, C), np.float64)
    for j in range(tail):
        prev[n_in - tail + j, j] = 1.0
    cur = np.zeros((n_in, C), np.float64)
    for j in range(n_in):
        cur[j, tail + j] = 1.0
    rs.process(prev)
    out = rs.process(cur)
    assert out.shape == (n_out, C)
    return np.ascontiguousarray(out.T, np.float32)


def resample_matrices(frame48: int, tail: int = TAIL):
    """The per-rate banks for one serving frame duration, padded to a
    common input width [tail + frame48//3] (the WB length; NB/MB use a
    zero-padded prefix): returns (stacked [3, tail+Lmax, frame48] f32,
    per-rate history slice offsets [3])."""
    lmax = frame48 // 3
    mats, offs = [], []
    for fs in (8, 12, 16):
        n_in = frame48 * fs // 48
        m = resample_matrix(fs, n_in, tail)
        pad = np.zeros((tail + lmax, frame48), np.float32)
        pad[: tail + n_in] = m
        mats.append(pad)
        # history for the next step = last `tail` samples of THIS frame's
        # input, which lives at [tail + n_in - tail : tail + n_in).
        offs.append(n_in)
    return np.stack(mats, axis=0), np.asarray(offs, np.int32)
