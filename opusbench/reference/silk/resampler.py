"""The SILK resampler (libopus silk_resampler), a copy of
opus_tpu.silk.resampler: the channel state's set_fs builds one, so the
SILK-only batch decoder's front ends reach it, though the batch output
stays at the internal rate.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""

from __future__ import annotations

from .fixed_math import i32, rshift_round, sat16, smlawb, smulbb, smulwb, smulww

# Allpass coefficients for the 2x high-quality upsampler (code immediates
# in libopus; verified by disassembly of silk_resampler_private_up2_HQ).
UP2_HQ_0 = (1746, 14986, -26453)
UP2_HQ_1 = (6854, 25769, -9994)

# Fractional/FIR downsampler coefficient tables (rodata 0x52180-0x522d8).
_COEFS_3_4 = [-20694, -13867,
              -49, 64, 17, -157, 353, -496, 163, 11047, 22205,
              -39, 6, 91, -170, 186, 23, -896, 6336, 19928,
              -19, -36, 102, -89, -24, 328, -951, 2568, 15909]
_COEFS_2_3 = [-14457, -14019,
              64, 128, -122, 36, 310, -768, 584, 9267, 17733,
              12, 128, 18, -142, 288, -117, -865, 4123, 14459]
_COEFS_1_2 = [616, -14323,
              -10, 39, 58, -46, -84, 120, 184, -315, -541, 1284, 5380, 9024]
_COEFS_1_3 = [16102, -15162,
              -13, 0, 20, 26, 5, -31, -43, -4, 65, 90, 7, -157, -248, -44, 593, 1583, 2612, 3271]
_COEFS_1_4 = [22500, -15099,
              3, -14, -20, -15, 2, 25, 37, 25, -16, -71, -107, -79, 50, 292, 623, 982, 1288, 1464]
_COEFS_1_6 = [27540, -15257,
              17, 12, 8, 1, -10, -22, -30, -32, -22, 3, 44, 100, 168, 243, 317, 381, 429, 455]

_ORDER_FIR0 = 18
_ORDER_FIR1 = 24
_ORDER_FIR2 = 36
_ORDER_FIR_12 = 8  # interpolator history for IIR_FIR

# Decoder-side delay compensation, samples at the input rate
# (resampler.c delay_matrix_dec, rodata 0x52094).  Rows for 24/48 kHz
# inputs are ours (encoder-direction use; any delay is valid there).
_DELAY_DEC = {
    8: {8: 4, 12: 0, 16: 2, 24: 0, 48: 0},
    12: {8: 0, 12: 9, 16: 4, 24: 7, 48: 4},
    16: {8: 0, 12: 3, 16: 12, 24: 7, 48: 7},
    24: {8: 0, 12: 0, 16: 0, 24: 0, 48: 0},
    48: {8: 0, 12: 0, 16: 0, 24: 0, 48: 0},
}


def _up2_hq(s_iir, out, out_off, inp, in_off, length):
    """silk_resampler_private_up2_HQ: 3-stage allpass pairs, Q10 state."""
    for k in range(length):
        in32 = i32(inp[in_off + k] << 10)

        y = i32(in32 - s_iir[0])
        x = smulwb(y, UP2_HQ_0[0])
        out1 = i32(s_iir[0] + x)
        s_iir[0] = i32(in32 + x)

        y = i32(out1 - s_iir[1])
        x = smulwb(y, UP2_HQ_0[1])
        out2 = i32(s_iir[1] + x)
        s_iir[1] = i32(out1 + x)

        y = i32(out2 - s_iir[2])
        x = smlawb(y, y, UP2_HQ_0[2])
        out1 = i32(s_iir[2] + x)
        s_iir[2] = i32(out2 + x)

        out[out_off + 2 * k] = sat16(rshift_round(out1, 10))

        y = i32(in32 - s_iir[3])
        x = smulwb(y, UP2_HQ_1[0])
        out1 = i32(s_iir[3] + x)
        s_iir[3] = i32(in32 + x)

        y = i32(out1 - s_iir[4])
        x = smulwb(y, UP2_HQ_1[1])
        out2 = i32(s_iir[4] + x)
        s_iir[4] = i32(out1 + x)

        y = i32(out2 - s_iir[5])
        x = smlawb(y, y, UP2_HQ_1[2])
        out1 = i32(s_iir[5] + x)
        s_iir[5] = i32(out2 + x)

        out[out_off + 2 * k + 1] = sat16(rshift_round(out1, 10))


def _ar2(s_iir, out_q8, out_off, inp, in_off, a_q14, length):
    """silk_resampler_private_AR2: second-order AR prefilter, Q8 out."""
    for k in range(length):
        out32 = i32(s_iir[0] + (inp[in_off + k] << 8))
        out_q8[out_off + k] = out32
        out32 = i32(out32 << 2)
        s_iir[0] = smlawb(s_iir[1], out32, a_q14[0])
        s_iir[1] = smulwb(out32, a_q14[1])


class Resampler:
    """silk_resampler_state_struct + dispatch (decoder direction)."""

    def __init__(self, fs_in_hz: int, fs_out_hz: int):
        self.fs_in_khz = fs_in_hz // 1000
        self.fs_out_khz = fs_out_hz // 1000
        self.batch_size = self.fs_in_khz * 10
        self.input_delay = _DELAY_DEC[self.fs_in_khz][self.fs_out_khz]
        self.delay_buf = [0] * 48
        self.s_iir = [0] * 6
        self.s_fir = [0] * _ORDER_FIR2  # generous: holds i16 or i32 history
        self.fir_order = 0
        self.fir_fracs = 0
        self.coefs = None
        up2x = 0
        if fs_out_hz > fs_in_hz:
            if fs_out_hz == 2 * fs_in_hz:
                self.mode = "up2hq"
            else:
                self.mode = "iirfir"
                up2x = 1
        elif fs_out_hz < fs_in_hz:
            self.mode = "downfir"
            if fs_out_hz * 4 == fs_in_hz * 3:
                self.fir_fracs, self.fir_order, self.coefs = 3, _ORDER_FIR0, _COEFS_3_4
            elif fs_out_hz * 3 == fs_in_hz * 2:
                self.fir_fracs, self.fir_order, self.coefs = 2, _ORDER_FIR0, _COEFS_2_3
            elif fs_out_hz * 2 == fs_in_hz:
                self.fir_fracs, self.fir_order, self.coefs = 1, _ORDER_FIR1, _COEFS_1_2
            elif fs_out_hz * 3 == fs_in_hz:
                self.fir_fracs, self.fir_order, self.coefs = 1, _ORDER_FIR2, _COEFS_1_3
            elif fs_out_hz * 4 == fs_in_hz:
                self.fir_fracs, self.fir_order, self.coefs = 1, _ORDER_FIR2, _COEFS_1_4
            elif fs_out_hz * 6 == fs_in_hz:
                self.fir_fracs, self.fir_order, self.coefs = 1, _ORDER_FIR2, _COEFS_1_6
            else:
                raise ValueError("unsupported resampling ratio")
        else:
            self.mode = "copy"
        inv = ((fs_in_hz << (14 + up2x)) // fs_out_hz) << 2
        while smulww(inv, fs_out_hz) < i32(fs_in_hz << up2x):
            inv += 1
        self.inv_ratio_q16 = inv

    def process(self, inp) -> list:
        """silk_resampler: two-phase (1 ms delay buffer, then the rest)."""
        in_len = len(inp)
        n = self.fs_in_khz - self.input_delay
        self.delay_buf[self.input_delay : self.input_delay + n] = inp[:n]
        out = []
        self._run(out, self.delay_buf, 0, self.fs_in_khz)
        self._run(out, inp, n, in_len - self.fs_in_khz)
        self.delay_buf[: self.input_delay] = inp[in_len - self.input_delay : in_len] if self.input_delay else []
        return out

    def _run(self, out, inp, in_off, length):
        if self.mode == "copy":
            out.extend(inp[in_off : in_off + length])
        elif self.mode == "up2hq":
            buf = [0] * (2 * length)
            _up2_hq(self.s_iir, buf, 0, inp, in_off, length)
            out.extend(buf)
        elif self.mode == "iirfir":
            self._iir_fir(out, inp, in_off, length)
        else:
            self._down_fir(out, inp, in_off, length)

    def _iir_fir(self, out, inp, in_off, length):
        from .tables import RESAMPLER_FRAC_FIR_12 as FRAC

        buf = [0] * (2 * self.batch_size + _ORDER_FIR_12)
        buf[:_ORDER_FIR_12] = self.s_fir[:_ORDER_FIR_12]
        increment = self.inv_ratio_q16
        while True:
            n = min(length, self.batch_size)
            _up2_hq(self.s_iir, buf, _ORDER_FIR_12, inp, in_off, n)
            max_index_q16 = n << 17
            index_q16 = 0
            while index_q16 < max_index_q16:
                table_index = smulwb(index_q16 & 0xFFFF, 12)
                b = index_q16 >> 16
                res = smulbb(buf[b + 0], int(FRAC[table_index][0]))
                res = i32(res + smulbb(buf[b + 1], int(FRAC[table_index][1])))
                res = i32(res + smulbb(buf[b + 2], int(FRAC[table_index][2])))
                res = i32(res + smulbb(buf[b + 3], int(FRAC[table_index][3])))
                res = i32(res + smulbb(buf[b + 4], int(FRAC[11 - table_index][3])))
                res = i32(res + smulbb(buf[b + 5], int(FRAC[11 - table_index][2])))
                res = i32(res + smulbb(buf[b + 6], int(FRAC[11 - table_index][1])))
                res = i32(res + smulbb(buf[b + 7], int(FRAC[11 - table_index][0])))
                out.append(sat16(rshift_round(res, 15)))
                index_q16 += increment
            in_off += n
            length -= n
            if length > 0:
                buf[:_ORDER_FIR_12] = buf[2 * n : 2 * n + _ORDER_FIR_12]
            else:
                break
        self.s_fir[:_ORDER_FIR_12] = buf[2 * n : 2 * n + _ORDER_FIR_12]

    def _down_fir(self, out, inp, in_off, length):
        buf = [0] * (self.batch_size + self.fir_order)
        buf[: self.fir_order] = self.s_fir[: self.fir_order]
        fir = self.coefs[2:]
        increment = self.inv_ratio_q16
        while True:
            n = min(length, self.batch_size)
            _ar2(self.s_iir, buf, self.fir_order, inp, in_off, self.coefs[:2], n)
            max_index_q16 = n << 16
            index_q16 = 0
            while index_q16 < max_index_q16:
                b = index_q16 >> 16
                if self.fir_order == _ORDER_FIR0:
                    interpol_ind = smulwb(index_q16 & 0xFFFF, self.fir_fracs)
                    p1 = 9 * interpol_ind
                    p2 = 9 * (self.fir_fracs - 1 - interpol_ind)
                    res = smulwb(buf[b + 0], fir[p1 + 0])
                    for j in range(1, 9):
                        res = smlawb(res, buf[b + j], fir[p1 + j])
                    for j in range(9):
                        res = smlawb(res, buf[b + 17 - j], fir[p2 + j])
                elif self.fir_order == _ORDER_FIR1:
                    res = smulwb(i32(buf[b + 0] + buf[b + 23]), fir[0])
                    for j in range(1, 12):
                        res = smlawb(res, i32(buf[b + j] + buf[b + 23 - j]), fir[j])
                else:
                    res = smulwb(i32(buf[b + 0] + buf[b + 35]), fir[0])
                    for j in range(1, 18):
                        res = smlawb(res, i32(buf[b + j] + buf[b + 35 - j]), fir[j])
                out.append(sat16(rshift_round(res, 6)))
                index_q16 += increment
            in_off += n
            length -= n
            if length > 1:
                buf[: self.fir_order] = buf[n : n + self.fir_order]
            else:
                break
        self.s_fir[: self.fir_order] = buf[n : n + self.fir_order]
