"""The scalar CELT decoder (RFC 6716 sec. 4.3), a copy of
opus_tpu.celt.decoder: flags, energies, allocation, PVQ band shapes,
anti-collapse, inverse MDCT, post-filter and de-emphasis, one frame at
a time in numpy.

The mixed serving loop (batch/opus_pipeline.py) decodes the redundant
5 ms CELT blocks of mode and bandwidth switches with it, on the host.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations


import numpy as np

from ..errors import BadArguments, InternalError
from ..rc import RangeDecoder
from . import modes
from .bands import anti_collapse, denormalise_bands, quant_all_bands
from .comb_filter import MIN_PERIOD, comb_filter
from .energy import (
    unquant_coarse_energy,
    unquant_energy_finalise,
    unquant_fine_energy,
)
from .mdct import mdct_backward
from .rate import BITRES, compute_allocation, init_caps
from .vq import SPREAD_NORMAL

DECODE_BUFFER_SIZE = 2048
LPC_ORDER = 24

#: iCDFs confirmed byte-exact against libopus .rodata (celt.c statics).
TAPSET_ICDF = (2, 1, 0)
SPREAD_ICDF = (25, 23, 2, 0)
TRIM_ICDF = (126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0)

TF_SELECT_TABLE = (
    # (isTransient=0: sel0 curr0, sel0 curr1, sel1 curr0, sel1 curr1 | isTransient=1: same)
    (0, -1, 0, -1, 0, -1, 0, -1),  # 2.5 ms
    (0, -1, 0, -2, 1, 0, 1, -1),  # 5 ms
    (0, -2, 0, -3, 2, 0, 1, -1),  # 10 ms
    (0, -2, 0, -3, 3, 0, 1, -1),  # 20 ms
)


def tf_decode(start: int, end: int, is_transient: bool, tf_res, lm: int, dec) -> None:
    """Per-band time/frequency resolution switches."""
    budget = dec.storage * 8
    tell = dec.tell()
    logp = 2 if is_transient else 4
    tf_select_rsv = 1 if (lm > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    tf_changed = 0
    curr = 0
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= 1 if dec.decode_bit_logp(logp) else 0
            tell = dec.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if is_transient else 5
    tf_select = 0
    base = 4 if is_transient else 0
    if tf_select_rsv and TF_SELECT_TABLE[lm][base + 0 + tf_changed] != TF_SELECT_TABLE[lm][base + 2 + tf_changed]:
        tf_select = 1 if dec.decode_bit_logp(1) else 0
    for i in range(start, end):
        tf_res[i] = TF_SELECT_TABLE[lm][base + 2 * tf_select + tf_res[i]]


class CeltDecoder:
    """Stateful CELT decoder for one stream (mono or stereo)."""

    def __init__(self, channels: int, downsample: int = 1):
        if channels not in (1, 2):
            raise BadArguments("channels must be 1 or 2")
        self.channels = channels
        self.stream_channels = channels
        self.downsample = downsample
        self.start_band = 0
        self.end_band = modes.NB_E_BANDS
        self.disable_inv = channels == 1  # libopus default: mono disables inv
        self.error = False
        self.rng = 0
        #: When False, decode() extracts symbol planes (self.last_planes)
        #: and skips host DSP — the batched device plane synthesises.
        self.synthesize_host = True
        self.last_planes: dict | None = None
        self.reset()

    def reset(self) -> None:
        ov = modes.OVERLAP
        self.decode_mem = np.zeros((self.channels, DECODE_BUFFER_SIZE + ov), dtype=np.float64)
        self.preemph_mem = np.zeros(2, dtype=np.float64)
        self.lpc = np.zeros((self.channels, LPC_ORDER), dtype=np.float64)
        self.old_band_e = np.zeros((2, modes.NB_E_BANDS), dtype=np.float32)
        self.old_log_e = np.full((2, modes.NB_E_BANDS), -28.0, dtype=np.float32)
        self.old_log_e2 = np.full((2, modes.NB_E_BANDS), -28.0, dtype=np.float32)
        # libopus inits backgroundLogE to 0 (cleared memory), NOT -28: the
        # tracker falls instantly (MIN with oldBandE) but rises at only
        # 2.4 dB/s, so this init is the concealment noise floor for bands
        # that stayed loud since reset.  With -28 the deep-loss regime
        # decayed ~0.5 log2/frame below libopus's floored trajectory.
        self.background_log_e = np.zeros((2, modes.NB_E_BANDS), dtype=np.float32)
        self.postfilter_period = 0
        self.postfilter_period_old = 0
        self.postfilter_gain = 0.0
        self.postfilter_gain_old = 0.0
        self.postfilter_tapset = 0
        self.postfilter_tapset_old = 0
        self.loss_duration = 0  # lost time in 2.5 ms units (libopus 1.3)
        self.skip_plc = False
        self.last_pitch_index = 0
        # The noise/fold LCG seed is part of the reset region in libopus
        # (celt_decoder.c DECODER_RESET_START begins at `rng`): after a
        # mode-switch reset the first frame's folded bands must draw from
        # seed 0, not the carried range state.
        self.rng = 0

    # -- helpers -----------------------------------------------------------

    def _deemphasis(self, out_syn, pcm: np.ndarray, n: int) -> None:
        """De-emphasis IIR + integer downsample; pcm shape [nd, cc] in ±1."""
        coef0 = float(modes.PREEMPH)
        cc = self.channels
        nd = n // self.downsample
        for c in range(cc):
            m = self.preemph_mem[c]
            x = out_syn[c]
            scratch = np.empty(n, dtype=np.float64)
            for j in range(n):
                tmp = x[j] + 1e-30 + m
                m = coef0 * tmp
                scratch[j] = tmp
            self.preemph_mem[c] = m
            pcm[:, c] = scratch[:: self.downsample][:nd] * (1.0 / 32768.0)

    def pitch(self) -> int:
        return self.postfilter_period

    @property
    def final_range(self) -> int:
        return self.rng

    # -- main decode -------------------------------------------------------

    def decode(self, data: bytes | None, frame_size: int, dec: RangeDecoder | None = None) -> np.ndarray:
        """Decode one CELT frame to pcm [frame_size, channels] in ±1.

        frame_size is at the decoder's output rate (48000/downsample).
        """
        frame_size = frame_size * self.downsample
        lm = -1
        for l in range(modes.MAX_LM + 1):
            if modes.SHORT_MDCT_SIZE << l == frame_size:
                lm = l
                break
        if lm < 0:
            raise BadArguments("unsupported CELT frame size")
        m = 1 << lm
        n = m * modes.SHORT_MDCT_SIZE
        cc = self.channels
        c_ = self.stream_channels
        nb = modes.NB_E_BANDS
        ov = modes.OVERLAP
        start, end = self.start_band, self.end_band
        eff_end = min(end, modes.EFF_E_BANDS)
        pcm = np.zeros((frame_size // self.downsample, cc), dtype=np.float32)

        if data is None or len(data) <= 1:
            self._decode_lost(n, lm)
            out_syn = [self.decode_mem[c][DECODE_BUFFER_SIZE - n :] for c in range(cc)]
            self._deemphasis(out_syn, pcm, n)
            return pcm

        if len(data) > 1275:
            raise BadArguments("frame too large")

        self.skip_plc = self.loss_duration != 0
        if dec is None:
            dec = RangeDecoder(data)
        frame_bytes = dec.storage

        old_band_e = self.old_band_e
        if c_ == 1:
            np.maximum(old_band_e[0], old_band_e[1], out=old_band_e[0])

        total_bits = frame_bytes * 8
        tell = dec.tell()
        if tell >= total_bits:
            silence = True
        elif tell == 1:
            silence = bool(dec.decode_bit_logp(15))
        else:
            silence = False
        if silence:
            # Pretend we've read all remaining bits.
            tell = total_bits
            dec.bits_total += tell - dec.tell()

        postfilter_gain = 0.0
        postfilter_pitch = 0
        postfilter_tapset = 0
        if start == 0 and tell + 16 <= total_bits:
            if dec.decode_bit_logp(1):
                octave = dec.decode_uint(6)
                postfilter_pitch = (16 << octave) + dec.decode_bits(4 + octave) - 1
                qg = dec.decode_bits(3)
                if dec.tell() + 2 <= total_bits:
                    postfilter_tapset = dec.decode_icdf(TAPSET_ICDF, 2)
                postfilter_gain = 0.09375 * (qg + 1)
            tell = dec.tell()

        if lm > 0 and tell + 3 <= total_bits:
            is_transient = bool(dec.decode_bit_logp(3))
            tell = dec.tell()
        else:
            is_transient = False
        short_blocks = is_transient

        intra_ener = bool(dec.decode_bit_logp(3)) if tell + 3 <= total_bits else False
        unquant_coarse_energy(dec, old_band_e, start, end, intra_ener, lm, c_)

        tf_res = [0] * nb
        tf_decode(start, end, is_transient, tf_res, lm, dec)

        tell = dec.tell()
        spread_decision = SPREAD_NORMAL
        if tell + 4 <= total_bits:
            spread_decision = dec.decode_icdf(SPREAD_ICDF, 5)

        cap = init_caps(lm, c_)

        # Dynalloc: per-band boosts with adaptive flag probability.
        offsets = [0] * nb
        dynalloc_logp = 6
        total_bits_frac = total_bits << BITRES
        tell_frac = dec.tell_frac()
        for i in range(start, end):
            width = c_ * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i]) << lm
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while tell_frac + (dynalloc_loop_logp << BITRES) < total_bits_frac and boost < int(cap[i]):
                flag = dec.decode_bit_logp(dynalloc_loop_logp)
                tell_frac = dec.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits_frac -= quanta
                dynalloc_loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = 5
        if tell_frac + (6 << BITRES) <= total_bits_frac:
            alloc_trim = dec.decode_icdf(TRIM_ICDF, 7)

        bits = (frame_bytes * 8 << BITRES) - dec.tell_frac() - 1
        anti_collapse_rsv = (
            (1 << BITRES) if (is_transient and lm >= 2 and bits >= ((lm + 2) << BITRES)) else 0
        )
        bits -= anti_collapse_rsv

        pulses, fine_quant, fine_priority, coded_bands, intensity, dual_stereo, balance = compute_allocation(
            start, end, offsets, cap, alloc_trim, 0, False, bits, c_, lm, dec, False
        )

        unquant_fine_energy(dec, old_band_e, fine_quant, start, end, c_)

        for c in range(cc):
            dm = self.decode_mem[c]
            dm[: DECODE_BUFFER_SIZE - n + ov // 2] = dm[n : DECODE_BUFFER_SIZE + ov // 2]

        collapse_masks = np.zeros((nb, c_), dtype=np.int32)
        x_ = np.zeros(c_ * n, dtype=np.float64)
        self.rng = quant_all_bands(
            start, end, x_, x_[n:] if c_ == 2 else None, collapse_masks,
            pulses, short_blocks, spread_decision, dual_stereo, intensity,
            tf_res, frame_bytes * (8 << BITRES) - anti_collapse_rsv, balance,
            dec, lm, coded_bands, self.rng, disable_inv=self.disable_inv,
        )

        anti_collapse_on = False
        if anti_collapse_rsv > 0:
            anti_collapse_on = bool(dec.decode_bits(1))

        unquant_energy_finalise(
            dec, old_band_e, fine_quant, fine_priority,
            frame_bytes * 8 - dec.tell(), start, end, c_,
        )

        if anti_collapse_on:
            anti_collapse(
                x_, collapse_masks, lm, c_, n, start, end, old_band_e,
                self.old_log_e, self.old_log_e2, pulses, self.rng,
            )

        if silence:
            old_band_e[:, :] = -28.0

        if not self.synthesize_host:
            # Batch/TPU mode: hand the dense symbol planes to the device
            # synthesis kernel instead of running host DSP.  All host state
            # that the front end owns (postfilter params, energy history,
            # rng) still advances.
            self.last_planes = {
                "x": x_.copy(),
                "band_log_e": old_band_e[:cc].copy(),
                "silence": silence,
                "short_blocks": bool(short_blocks),
                "lm": lm,
                "stream_channels": c_,
                "start": start,
                "eff_end": eff_end,
                "pf_period0": max(self.postfilter_period_old, MIN_PERIOD),
                "pf_period1": max(self.postfilter_period, MIN_PERIOD),
                "pf_gain0": self.postfilter_gain_old,
                "pf_gain1": self.postfilter_gain,
                "pf_tapset0": self.postfilter_tapset_old,
                "pf_tapset1": self.postfilter_tapset,
                "pf_period2": postfilter_pitch,
                "pf_gain2": postfilter_gain,
                "pf_tapset2": postfilter_tapset,
            }
            self._rotate_postfilter(lm, postfilter_pitch, postfilter_gain, postfilter_tapset)
            self._update_energy_history(is_transient, old_band_e, m, start, end, c_)
            self.rng = dec.rng
            self.loss_duration = 0
            if dec.tell() > 8 * frame_bytes:
                raise InternalError("bit budget overrun")
            if dec.error:
                self.error = True
            return pcm

        # Synthesis: denormalise + IMDCT with TDAC into the decode memory.
        out_syn = [self.decode_mem[c][DECODE_BUFFER_SIZE - n :] for c in range(cc)]
        b_count = m if short_blocks else 1
        nb_size = modes.SHORT_MDCT_SIZE if short_blocks else n
        freq = np.empty(n, dtype=np.float64)
        if cc == 2 and c_ == 1:
            denormalise_bands(x_, freq, old_band_e[0], start, eff_end, m, self.downsample, silence)
            for c in range(2):
                for b in range(b_count):
                    mdct_backward(freq[b::b_count].copy(), out_syn[c][nb_size * b :])
        elif cc == 1 and c_ == 2:
            freq2 = np.empty(n, dtype=np.float64)
            denormalise_bands(x_, freq, old_band_e[0], start, eff_end, m, self.downsample, silence)
            denormalise_bands(x_[n:], freq2, old_band_e[1], start, eff_end, m, self.downsample, silence)
            freq = 0.5 * (freq + freq2)
            for b in range(b_count):
                mdct_backward(freq[b::b_count].copy(), out_syn[0][nb_size * b :])
        else:
            for c in range(cc):
                denormalise_bands(
                    x_[c * n :], freq, old_band_e[c], start, eff_end, m, self.downsample, silence
                )
                for b in range(b_count):
                    mdct_backward(freq[b::b_count].copy(), out_syn[c][nb_size * b :])

        # Post-filter (cross-faded between old and new parameters).
        self.postfilter_period = max(self.postfilter_period, MIN_PERIOD)
        self.postfilter_period_old = max(self.postfilter_period_old, MIN_PERIOD)
        for c in range(cc):
            base = DECODE_BUFFER_SIZE - n
            comb_filter(
                self.decode_mem[c], base, self.postfilter_period_old, self.postfilter_period,
                modes.SHORT_MDCT_SIZE, self.postfilter_gain_old, self.postfilter_gain,
                self.postfilter_tapset_old, self.postfilter_tapset, modes.WINDOW, ov,
            )
            if lm != 0:
                comb_filter(
                    self.decode_mem[c], base + modes.SHORT_MDCT_SIZE,
                    self.postfilter_period, postfilter_pitch, n - modes.SHORT_MDCT_SIZE,
                    self.postfilter_gain, postfilter_gain,
                    self.postfilter_tapset, postfilter_tapset, modes.WINDOW, ov,
                )
        self._rotate_postfilter(lm, postfilter_pitch, postfilter_gain, postfilter_tapset)
        self._update_energy_history(is_transient, old_band_e, m, start, end, c_)
        self.rng = dec.rng

        self._deemphasis(out_syn, pcm, n)
        self.loss_duration = 0
        if dec.tell() > 8 * frame_bytes:
            raise InternalError("bit budget overrun")
        if dec.error:
            self.error = True
        return pcm

    def _rotate_postfilter(self, lm: int, pitch: int, gain: float, tapset: int) -> None:
        self.postfilter_period_old = self.postfilter_period
        self.postfilter_gain_old = self.postfilter_gain
        self.postfilter_tapset_old = self.postfilter_tapset
        self.postfilter_period = pitch
        self.postfilter_gain = gain
        self.postfilter_tapset = tapset
        if lm != 0:
            self.postfilter_period_old = self.postfilter_period
            self.postfilter_gain_old = self.postfilter_gain
            self.postfilter_tapset_old = self.postfilter_tapset

    def _update_energy_history(self, is_transient, old_band_e, m, start, end, c_) -> None:
        if c_ == 1:
            old_band_e[1, :] = old_band_e[0, :]
        # Energy history for anti-collapse and PLC.
        if not is_transient:
            self.old_log_e2[:, :] = self.old_log_e
            self.old_log_e[:, :] = old_band_e
            # Noise floor rises <= 2.4 dB/s normally; after a loss burst the
            # first update may jump by the whole missed span (libopus 1.3:
            # IMIN(160, loss_duration + M) * 0.001 in log2 units).
            max_inc = min(160, self.loss_duration + m) * 0.001
            np.minimum(self.background_log_e + max_inc, self.old_log_e, out=self.background_log_e)
        else:
            np.minimum(self.old_log_e, old_band_e, out=self.old_log_e)
        for c in range(2):
            old_band_e[c, :start] = 0.0
            self.old_log_e[c, :start] = -28.0
            self.old_log_e2[c, :start] = -28.0
            old_band_e[c, end:] = 0.0
            self.old_log_e[c, end:] = -28.0
            self.old_log_e2[c, end:] = -28.0

    def _decode_lost(self, n: int, lm: int) -> None:
        """Packet-loss concealment: pitch-LPC extrapolation or comfort
        noise (opus_tpu.celt.plc)."""
        from .plc import decode_lost

        decode_lost(self, n, lm)
