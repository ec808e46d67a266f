"""The scalar SILK layer of the Opus decoder, a copy of opus_tpu.silk.api.

SilkDecoder and SilkLayer: LBRR frames and in-band FEC, stereo, and the
concealment and comfort-noise glue around silk/decoder.py.  The scalar
Decoder (decoder.py) builds it for SILK-only and hybrid packets.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidPacket
from . import tables as T
from .bitstream import (
    CODE_CONDITIONALLY,
    CODE_INDEPENDENTLY,
    CODE_INDEPENDENTLY_NO_LTP_SCALING,
    TYPE_NO_VOICE_ACTIVITY,
    decode_indices,
    decode_pulses,
)
from .decoder import (
    FLAG_DECODE_LBRR,
    FLAG_DECODE_NORMAL,
    FLAG_PACKET_LOST,
    MAX_LPC_ORDER,
    SilkChannelState,
    decode_core,
    decode_parameters,
)
from .stereo import StereoDecState, stereo_decode_mid_only, stereo_decode_pred, stereo_ms_to_lr

_LBRR_FLAGS_ICDF = (T.LBRR_FLAGS_2_ICDF, T.LBRR_FLAGS_3_ICDF)


def decode_frame(st: SilkChannelState, dec, lost_flag: int, cond_coding: int) -> list:
    """silk_decode_frame: one 10/20 ms frame for one channel."""
    frame_length = st.frame_length
    if lost_flag == FLAG_DECODE_NORMAL or (
        lost_flag == FLAG_DECODE_LBRR and st.lbrr_flags[st.n_frames_decoded] == 1
    ):
        ind = decode_indices(dec, st, st.n_frames_decoded, lost_flag == FLAG_DECODE_LBRR, cond_coding)
        pulses = decode_pulses(dec, ind.signal_type, ind.quant_offset_type, frame_length)
        ctrl = decode_parameters(st, ind, cond_coding)
        out = decode_core(st, ctrl, ind, pulses)
        _plc_update(st, ctrl, ind)
        st.loss_cnt = 0
        st.prev_signal_type = ind.signal_type
        st.first_frame_after_reset = 0
    else:
        from .plc import plc_conceal

        ind = None
        ctrl = None
        out = plc_conceal(st)

    # Roll the LTP history buffer.
    mv_len = st.ltp_mem_length - frame_length
    st.out_buf[:mv_len] = st.out_buf[frame_length : st.ltp_mem_length]
    st.out_buf[mv_len : st.ltp_mem_length] = out

    _cng_update(st, ctrl, out, frame_length)
    _plc_glue(st, out, frame_length)
    if ctrl is not None:
        st.lag_prev = ctrl.pitch_l[st.nb_subfr - 1]
    return out


def _plc_update(st, ctrl, ind):
    """silk_PLC(lost=0): remember parameters for future concealment."""
    from .plc import plc_save

    plc_save(st, ctrl, ind)


def _cng_update(st, ctrl, out, length):
    """silk_CNG: estimate comfort-noise parameters in no-activity frames.

    On clean frames this only updates state; noise is only mixed into
    concealed frames (handled in plc.py).
    """
    from .plc import cng

    cng(st, ctrl, out, length)


def _plc_glue(st, out, length):
    from .plc import plc_glue_frames

    plc_glue_frames(st, out, length)


class SilkDecoder:
    """silk_Decode-level state: up to 2 channel states + stereo unmix."""

    def __init__(self):
        self.channel_state = [SilkChannelState(), SilkChannelState()]
        self.stereo = StereoDecState()
        self.n_channels_api = 0
        self.n_channels_internal = 0
        self.prev_decode_only_middle = 0

    def reset(self):
        self.__init__()

    def decode(
        self,
        dec,
        n_channels_internal: int,
        n_channels_api: int,
        internal_rate_hz: int,
        api_rate_hz: int,
        payload_size_ms: int,
        new_packet: bool,
        lost_flag: int = FLAG_DECODE_NORMAL,
    ) -> np.ndarray:
        """One SILK frame (10/20 ms) -> int16 array [n_samples_out, api_ch].

        For 40/60 ms packets the caller invokes this repeatedly with
        new_packet=False (dec_API.c:silk_Decode semantics).
        """
        cs = self.channel_state
        if new_packet:
            for n in range(n_channels_internal):
                cs[n].n_frames_decoded = 0
        if n_channels_internal > self.n_channels_internal:
            cs[1] = SilkChannelState()
        if cs[0].n_frames_decoded == 0:
            for n in range(n_channels_internal):
                if payload_size_ms in (0, 10):
                    cs[n].n_frames_per_packet = 1
                    cs[n].nb_subfr = 2
                elif payload_size_ms == 20:
                    cs[n].n_frames_per_packet = 1
                    cs[n].nb_subfr = 4
                elif payload_size_ms == 40:
                    cs[n].n_frames_per_packet = 2
                    cs[n].nb_subfr = 4
                elif payload_size_ms == 60:
                    cs[n].n_frames_per_packet = 3
                    cs[n].nb_subfr = 4
                else:
                    raise InvalidPacket("silk: invalid payload size")
                fs_khz_dec = (internal_rate_hz >> 10) + 1
                if fs_khz_dec not in (8, 12, 16):
                    raise InvalidPacket("silk: invalid internal rate")
                cs[n].set_fs(fs_khz_dec, api_rate_hz)
        if n_channels_api == 2 and n_channels_internal == 2 and (
            self.n_channels_api == 1 or self.n_channels_internal == 1
        ):
            self.stereo.pred_prev_q13 = [0, 0]
            self.stereo.s_side = [0, 0]
            import copy

            cs[1].resampler = copy.deepcopy(cs[0].resampler)
        self.n_channels_api = n_channels_api
        self.n_channels_internal = n_channels_internal

        ms_pred_q13 = [0, 0]
        decode_only_middle = 0
        if lost_flag != FLAG_PACKET_LOST and cs[0].n_frames_decoded == 0:
            # Header flags: VAD per frame, then LBRR.
            for n in range(n_channels_internal):
                for i in range(cs[n].n_frames_per_packet):
                    cs[n].vad_flags[i] = 1 if dec.decode_bit_logp(1) else 0
                cs[n].lbrr_flag = 1 if dec.decode_bit_logp(1) else 0
            for n in range(n_channels_internal):
                cs[n].lbrr_flags = [0] * 3
                if cs[n].lbrr_flag:
                    if cs[n].n_frames_per_packet == 1:
                        cs[n].lbrr_flags[0] = 1
                    else:
                        sym = dec.decode_icdf(_LBRR_FLAGS_ICDF[cs[n].n_frames_per_packet - 2], 8) + 1
                        for i in range(cs[n].n_frames_per_packet):
                            cs[n].lbrr_flags[i] = (sym >> i) & 1
            if lost_flag == FLAG_DECODE_NORMAL:
                # Skip LBRR data (symbols advance the range decoder).
                for i in range(cs[0].n_frames_per_packet):
                    for n in range(n_channels_internal):
                        if cs[n].lbrr_flags[i]:
                            if n_channels_internal == 2 and n == 0:
                                stereo_decode_pred(dec)
                                if cs[1].lbrr_flags[i] == 0:
                                    stereo_decode_mid_only(dec)
                            cond = CODE_CONDITIONALLY if (i > 0 and cs[n].lbrr_flags[i - 1]) else CODE_INDEPENDENTLY
                            ind = decode_indices(dec, cs[n], i, True, cond)
                            decode_pulses(dec, ind.signal_type, ind.quant_offset_type, cs[n].frame_length)

        if n_channels_internal == 2:
            if lost_flag == FLAG_DECODE_NORMAL or (
                lost_flag == FLAG_DECODE_LBRR and cs[0].lbrr_flags[cs[0].n_frames_decoded] == 1
            ):
                ms_pred_q13 = stereo_decode_pred(dec)
                if (lost_flag == FLAG_DECODE_NORMAL and cs[1].vad_flags[cs[0].n_frames_decoded] == 0) or (
                    lost_flag == FLAG_DECODE_LBRR and cs[1].lbrr_flags[cs[0].n_frames_decoded] == 0
                ):
                    decode_only_middle = stereo_decode_mid_only(dec)
                else:
                    decode_only_middle = 0
            else:
                ms_pred_q13 = list(self.stereo.pred_prev_q13)

        if n_channels_internal == 2 and decode_only_middle == 0 and self.prev_decode_only_middle == 1:
            s = cs[1]
            s.out_buf = [0] * len(s.out_buf)
            s.s_lpc_q14 = [0] * MAX_LPC_ORDER
            s.lag_prev = 100
            s.last_gain_index = 10
            s.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
            s.first_frame_after_reset = 1

        if lost_flag == FLAG_DECODE_NORMAL:
            has_side = not decode_only_middle
        else:
            has_side = (not self.prev_decode_only_middle) or (
                n_channels_internal == 2
                and lost_flag == FLAG_DECODE_LBRR
                and cs[1].lbrr_flags[cs[1].n_frames_decoded] == 1
            )

        n_samples_dec = cs[0].frame_length
        # 2-sample prefix holds the stereo/mono delay state.
        samples1 = [[0] * (n_samples_dec + 2) for _ in range(2)]
        for n in range(n_channels_internal):
            if n == 0 or has_side:
                frame_index = cs[0].n_frames_decoded - n
                if frame_index <= 0:
                    cond = CODE_INDEPENDENTLY
                elif lost_flag == FLAG_DECODE_LBRR:
                    cond = CODE_CONDITIONALLY if cs[n].lbrr_flags[frame_index - 1] else CODE_INDEPENDENTLY
                elif n > 0 and self.prev_decode_only_middle:
                    cond = CODE_INDEPENDENTLY_NO_LTP_SCALING
                else:
                    cond = CODE_CONDITIONALLY
                samples1[n][2:] = decode_frame(cs[n], dec, lost_flag, cond)
            cs[n].n_frames_decoded += 1

        if n_channels_api == 2 and n_channels_internal == 2:
            stereo_ms_to_lr(self.stereo, samples1[0], samples1[1], ms_pred_q13, cs[0].fs_khz, n_samples_dec)
        else:
            samples1[0][0:2] = self.stereo.s_mid
            self.stereo.s_mid = list(samples1[0][n_samples_dec : n_samples_dec + 2])

        n_samples_out = n_samples_dec * api_rate_hz // (cs[0].fs_khz * 1000)
        out = np.zeros((n_samples_out, n_channels_api), dtype=np.int16)
        for n in range(min(n_channels_api, n_channels_internal)):
            resampled = cs[n].resampler.process(samples1[n][1 : 1 + n_samples_dec])
            out[:, n] = resampled
        if n_channels_api == 2 and n_channels_internal == 1:
            out[:, 1] = out[:, 0]

        if lost_flag != FLAG_PACKET_LOST:
            self.prev_decode_only_middle = decode_only_middle
        return out


class SilkLayer:
    """Adapter matching opus_decode_frame's SILK invocation (dec_API).

    Chunks 40/60 ms Opus frames into silk_Decode calls, caches the
    DecControl fields across PLC frames, and converts int16 -> float32.
    """

    def __init__(self, api_rate_hz: int, channels: int):
        self.core = SilkDecoder()
        self.api_rate = api_rate_hz
        self.channels = channels
        self._internal_rate = 16000
        self._stream_channels = channels

    def reset(self):
        self.core.reset()

    def decode(self, dec, mode, bandwidth, frame_size, stream_channels, decode_fec):
        """Decode frame_size samples at the API rate; dec=None means loss."""
        from ..types import Bandwidth, CodecMode

        payload_ms = max(10, 1000 * frame_size // self.api_rate)
        if dec is not None:
            self._stream_channels = stream_channels
            if mode == CodecMode.SILK_ONLY:
                if bandwidth == Bandwidth.NARROWBAND:
                    self._internal_rate = 8000
                elif bandwidth == Bandwidth.MEDIUMBAND:
                    self._internal_rate = 12000
                else:
                    self._internal_rate = 16000
            else:
                self._internal_rate = 16000
        if dec is None:
            lost_flag = FLAG_PACKET_LOST
        elif decode_fec:
            lost_flag = FLAG_DECODE_LBRR
        else:
            lost_flag = FLAG_DECODE_NORMAL
        decoded = 0
        outs = []
        first = True
        while decoded < frame_size:
            out = self.core.decode(
                dec,
                self._stream_channels,
                self.channels,
                self._internal_rate,
                self.api_rate,
                payload_ms,
                new_packet=first,
                lost_flag=lost_flag,
            )
            first = False
            outs.append(out)
            decoded += out.shape[0]
        pcm = np.concatenate(outs).astype(np.float32) / np.float32(32768.0)
        return pcm[:frame_size]
