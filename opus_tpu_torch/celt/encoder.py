"""The scalar CELT encoder (RFC 6716 sec. 4.3, encode direction), a copy
of opus_tpu.celt.encoder: pre-emphasis, pitch prefilter, forward MDCT,
band energies, coarse and fine energy, allocation, PVQ band shapes and
finalisation, one frame at a time in numpy.

The batched plan encoder (celt/plan_encoder.py) keeps one per stream as
the container of its cross-frame state and encodes with it a stream whose
leaves overflow the device's leaf table (batch/encode_pipeline.py).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_encode.py holds the two equal).
"""

from __future__ import annotations


import numpy as np

from ..rc import RangeEncoder
from . import modes
from .bands import compute_band_energies, normalise_bands, quant_all_bands
from .decoder import SPREAD_ICDF, TAPSET_ICDF, TF_SELECT_TABLE, TRIM_ICDF
from .energy_encode import E_MEANS, amp2_log2, quant_coarse_energy, quant_energy_finalise, quant_fine_energy
from .comb_filter import comb_filter_into
from .mdct import mdct_forward
from .rate import BITRES, compute_allocation, init_caps
from .vq import SPREAD_NORMAL

E_MEANS_F = np.asarray(E_MEANS, dtype=np.float64)


class CeltEncoder:
    """Stateful CELT encoder for one stream (mono or stereo, 48 kHz)."""

    def __init__(self, channels: int):
        assert channels in (1, 2)
        self.channels = channels
        self.stream_channels = channels
        self.start_band = 0
        self.end_band = modes.NB_E_BANDS
        #: libopus-scale complexity knob; >= 8 enables the theta RDO
        #: search in quant_all_bands (set per frame by the Opus encoder).
        self.complexity = 10
        self.reset()

    def reset(self) -> None:
        ov = modes.OVERLAP
        self.in_mem = np.zeros((self.channels, ov), dtype=np.float64)
        self.preemph_mem = np.zeros(self.channels, dtype=np.float64)
        self.old_band_e = np.zeros((2, modes.NB_E_BANDS), dtype=np.float32)
        self.rng = 0
        self.frame_count = 0
        # Pitch prefilter state (libopus celt_encoder.c run_prefilter):
        # UNFILTERED pre-emphasised history for the pitch analysis, plus
        # the (period, gain, tapset) actually applied last frame for the
        # comb cross-fade.
        self.prefilter_mem = np.zeros((self.channels, 1024), dtype=np.float64)
        self.prefilter_period = 15
        self.prefilter_gain = 0.0
        self.prefilter_tapset = 0
        #: Tapset for the NEXT frame's prefilter, from the spread analysis
        #: (libopus derives tapset_decision in spreading_decision): very
        #: tonal content gets the sharp 1-tap comb (tapset 2), mildly tonal
        #: the middle one — matching the 3 tapsets the decoder implements
        #: (celt/comb_filter.py).
        self.tapset_decision = 0
        #: Last 2.5 ms sub-block energy of the previous frame (None =
        #: none yet): transient-floor seed across the frame boundary.
        self._prev_sub_energy = None

    def _run_prefilter(self, prebuf: np.ndarray, n: int, nb_available_bytes: int,
                       enabled: bool):
        """Pitch prefilter decision (libopus celt_encoder.c run_prefilter).

        prebuf: [cc, 1024 + n] pre-emphasised UNFILTERED signal (1024 of
        history).  Returns (pf_on, pitch_index, gain, qg, tapset): the comb
        is applied by the caller with negative gains; the decoder's
        post-filter (+gain) undoes it, shaping coding noise harmonically.
        """
        MAXP, MINP = 1024, 15
        if self.complexity < 5:
            enabled = False
        # Digital-silence guard: the silence flag would stop the decoder
        # from reading the post-filter params.
        if float(np.max(np.abs(prebuf[:, MAXP:]))) < 0.5:
            enabled = False
        gain1 = 0.0
        pitch_index = MINP
        qg = 0
        if enabled:
            from .plc import pitch_downsample, pitch_search, remove_doubling

            pitch_buf = pitch_downsample(prebuf, MAXP + n)
            raw = pitch_search(pitch_buf[MAXP >> 1 :], pitch_buf, n, MAXP - 3 * MINP)
            pitch_index = MAXP - raw
            pitch_index, gain1 = remove_doubling(
                pitch_buf, MAXP, MINP, n, pitch_index,
                self.prefilter_period, self.prefilter_gain,
            )
            if pitch_index > MAXP - 2:
                pitch_index = MAXP - 2
            gain1 = 0.7 * gain1

        # Threshold with rate + continuity hysteresis.
        pf_threshold = 0.2
        if abs(pitch_index - self.prefilter_period) * 10 > pitch_index:
            pf_threshold += 0.2
        if nb_available_bytes < 25:
            pf_threshold += 0.1
        if nb_available_bytes < 35:
            pf_threshold += 0.1
        if self.prefilter_gain > 0.4:
            pf_threshold -= 0.1
        if self.prefilter_gain > 0.55:
            pf_threshold -= 0.1
        pf_threshold = max(pf_threshold, 0.2)

        if gain1 < pf_threshold:
            return False, MINP, 0.0, 0, self.tapset_decision
        if abs(gain1 - self.prefilter_gain) < 0.1:
            gain1 = self.prefilter_gain
        qg = max(0, min(7, int(np.floor(0.5 + gain1 * 32.0 / 3.0)) - 1))
        gain1 = 0.09375 * (qg + 1)
        return True, pitch_index, gain1, qg, self.tapset_decision

    def encode(self, pcm: np.ndarray, nb_bytes: int, enc: RangeEncoder | None = None) -> bytes:
        """Encode one frame of pcm [N, channels] (N in 2.5-20 ms at 48 kHz)
        into exactly nb_bytes of CELT payload (constant bitrate).

        When ``enc`` is given (hybrid mode), CELT symbols append to that
        shared range coder up to its nb_bytes budget and the caller
        finalises; otherwise a fresh coder is created and flushed here."""
        shared = enc is not None
        n = pcm.shape[0]
        lm = -1
        for l in range(modes.MAX_LM + 1):
            if modes.SHORT_MDCT_SIZE << l == n:
                lm = l
                break
        assert lm >= 0, "frame must be 120/240/480/960 samples"
        m = 1 << lm
        cc = self.channels
        c_ = self.stream_channels
        ov = modes.OVERLAP
        start, end = self.start_band, self.end_band
        eff_end = min(end, modes.EFF_E_BANDS)
        nb_bytes = min(nb_bytes, 1275)

        if not shared:
            buf = bytearray(nb_bytes)
            enc = RangeEncoder(buf)
        total_bits = nb_bytes * 8

        # --- pre-emphasis + pitch prefilter + MDCT analysis ---------------
        MAXP = 1024
        prebuf = np.zeros((cc, MAXP + n))
        for c in range(cc):
            x = pcm[:, c].astype(np.float64) * 32768.0
            pre = x - np.concatenate([[self.preemph_mem[c]], float(modes.PREEMPH) * x[:-1]])
            self.preemph_mem[c] = float(modes.PREEMPH) * x[-1]
            prebuf[c, :MAXP] = self.prefilter_mem[c]
            prebuf[c, MAXP:] = pre

        pf_on, pitch_index, gain1, qg, pf_tapset = self._run_prefilter(
            prebuf, n, nb_bytes, enabled=(start == 0 and total_bits >= 19)
        )

        band_input = np.zeros((cc, ov + n))
        for c in range(cc):
            band_input[c, :ov] = self.in_mem[c]
            comb_filter_into(
                band_input[c], ov, prebuf[c], MAXP,
                self.prefilter_period, pitch_index, n,
                -self.prefilter_gain, -gain1,
                self.prefilter_tapset, pf_tapset,
                modes.WINDOW.astype(np.float64), ov,
            )
            self.in_mem[c] = band_input[c, n : n + ov]
            self.prefilter_mem[c] = prebuf[c, n : n + MAXP]
        self.prefilter_period = pitch_index
        self.prefilter_gain = gain1
        self.prefilter_tapset = pf_tapset

        is_transient = lm > 0 and self._transient_decision(band_input[:, ov:], m)
        B = m if is_transient else 1
        nb = n // B
        freq = np.zeros(cc * n)
        for c in range(cc):
            for b in range(B):
                freq[c * n :][b : n : B] = mdct_forward(band_input[c, b * nb : b * nb + nb + ov])
        if c_ == 1 and cc == 2:
            freq = 0.5 * (freq[:n] + freq[n:])
            freq = np.concatenate([freq, freq])

        band_e = compute_band_energies(freq, c_, m, eff_end)
        x_ = np.zeros(c_ * n)
        normalise_bands(freq, x_, band_e, c_, m, eff_end)
        band_log_e = amp2_log2(band_e, eff_end, c_)

        # --- header flags --------------------------------------------------
        tell = enc.tell()
        if tell == 1:
            # Silence flag: a digitally-silent frame codes as one symbol and
            # the decoder skips the rest (decoder.py silence path, which
            # also resets its energy memory to -28).
            silence = bool(np.max(band_log_e[:c_, :eff_end]) < -25.0)
            enc.encode_bit_logp(1 if silence else 0, 15)
            if silence:
                self.old_band_e[:, :] = -28.0
                self.rng = enc.rng
                self.frame_count += 1
                if shared:
                    return b""
                enc.done()
                self.rng = enc.rng
                return bytes(buf)
        tell = enc.tell()
        if start == 0 and tell + 16 <= total_bits:
            if pf_on:
                from ..mathops import ilog

                enc.encode_bit_logp(1, 1)
                pi = pitch_index + 1
                octave = ilog(pi) - 5
                enc.encode_uint(octave, 6)
                enc.encode_bits(pi - (16 << octave), 4 + octave)
                enc.encode_bits(qg, 3)
                if enc.tell() + 2 <= total_bits:
                    enc.encode_icdf(pf_tapset, TAPSET_ICDF, 2)
            else:
                enc.encode_bit_logp(0, 1)  # no post-filter this frame
            tell = enc.tell()
        if lm > 0 and tell + 3 <= total_bits:
            enc.encode_bit_logp(1 if is_transient else 0, 3)
            tell = enc.tell()
        else:
            is_transient = False

        # --- energy + per-band params --------------------------------------
        intra = self.frame_count == 0
        error = quant_coarse_energy(
            enc, band_log_e, self.old_band_e, start, end, intra, lm, c_,
            total_bits, nb_bytes,
        )

        tf_res, tf_sel = self._tf_analysis(x_, start, eff_end, lm, m, c_, is_transient,
                                           nb_bytes)
        tf_res = self._tf_encode(enc, start, end, is_transient, lm, nb_bytes, tf_res, tf_sel)

        spread = self._spread_decision(x_, band_e, start, eff_end, m, c_)
        if enc.tell() + 4 <= total_bits:
            enc.encode_icdf(spread, SPREAD_ICDF, 5)
        else:
            spread = SPREAD_NORMAL
        # Tapset for the NEXT frame from the same tonality analysis the
        # spread uses: SPREAD_NONE (very tonal) -> sharp comb (2),
        # SPREAD_LIGHT -> 1, else the wide default (0).
        self.tapset_decision = {0: 2, 1: 1}.get(spread, 0)

        cap = init_caps(lm, c_)
        # Dynalloc: boost bands whose energy pops far above their smoothed
        # neighbourhood (tonal peaks leak into neighbours unless they get
        # extra shape bits).  Emission mirrors the decoder's budget loop
        # exactly (decoder.py dynalloc: adaptive logp, quanta, caps).
        want = self._dynalloc_analysis(band_log_e, start, eff_end, lm, c_, cap,
                                       is_transient=is_transient,
                                       effective_bytes=nb_bytes)
        dynalloc_logp = 6
        total_bits_frac = total_bits << BITRES
        tell_frac = enc.tell_frac()
        offsets = [0] * modes.NB_E_BANDS
        for i in range(start, end):
            width = c_ * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i]) << lm
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while tell_frac + (dynalloc_loop_logp << BITRES) < total_bits_frac and boost < int(cap[i]):
                flag = 1 if boost + quanta <= want[i] else 0
                enc.encode_bit_logp(flag, dynalloc_loop_logp)
                tell_frac = enc.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits_frac -= quanta
                dynalloc_loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = self._trim_decision(band_log_e, start, eff_end, c_)
        if tell_frac + (6 << BITRES) <= total_bits_frac:
            enc.encode_icdf(alloc_trim, TRIM_ICDF, 7)
        else:
            alloc_trim = 5

        bits = (nb_bytes * 8 << BITRES) - enc.tell_frac() - 1
        anti_collapse_rsv = (
            (1 << BITRES)
            if (is_transient and lm >= 2 and bits >= ((lm + 2) << BITRES))
            else 0
        )
        bits -= anti_collapse_rsv
        # Intensity stereo: when stereo bits are scarce, code bands above
        # the intensity threshold as mono+panning (decoder reconstructs
        # from the transmitted intensity index; any value is conformant).
        intensity = end
        if c_ == 2:
            bps = nb_bytes * 8 * 48000 // n
            if bps < 44000:
                intensity = min(8, end)
            elif bps < 52000:
                intensity = min(12, end)
            elif bps < 56000:
                intensity = min(16, end)
        # Dual stereo: decorrelated channels waste theta bits on a
        # meaningless mid/side angle; code them separately instead.
        dual_stereo = False
        if c_ == 2:
            a_ch = band_input[0, ov:]
            b_ch = band_input[1, ov:]
            den = (float(np.dot(a_ch, a_ch)) * float(np.dot(b_ch, b_ch))) ** 0.5
            if den > 1e-9 and abs(float(np.dot(a_ch, b_ch))) / den < 0.3:
                dual_stereo = True
        pulses, fine_quant, fine_priority, coded_bands, intensity, dual_stereo, balance = compute_allocation(
            start, end, offsets, cap, alloc_trim, intensity, dual_stereo,
            bits, c_, lm, enc, True, 0, end,
        )

        quant_fine_energy(enc, self.old_band_e, error, fine_quant, start, end, c_)

        # --- band shapes -----------------------------------------------------
        collapse_masks = np.zeros((modes.NB_E_BANDS, c_), dtype=np.int32)
        self.rng = quant_all_bands(
            True, start, end, x_, x_[n:] if c_ == 2 else None, collapse_masks,
            band_e, pulses, is_transient, spread, dual_stereo, intensity, tf_res,
            nb_bytes * (8 << BITRES) - anti_collapse_rsv, balance, enc, lm,
            coded_bands, self.rng, complexity=self.complexity,
        )
        if anti_collapse_rsv > 0:
            # Enable collapse fill on transient frames: the decoder then
            # renormalises any short-MDCT band that received no pulses with
            # noise at the previous frame's energy (celt/bands anti_collapse)
            # instead of leaving a spectral hole.  Encoder state is open-loop
            # so the injected noise never feeds back here.
            enc.encode_bits(1, 1)

        quant_energy_finalise(
            enc, self.old_band_e, error, fine_quant, fine_priority,
            nb_bytes * 8 - enc.tell(), start, end, c_,
        )
        if c_ == 1:
            self.old_band_e[1, :] = self.old_band_e[0, :]
        for c in range(2):
            self.old_band_e[c, :start] = 0.0
            self.old_band_e[c, end:] = 0.0

        if shared:
            self.rng = enc.rng
            self.frame_count += 1
            return b""
        enc.done()
        self.rng = enc.rng
        self.frame_count += 1
        return bytes(buf)

    def _spread_decision(self, x_, band_e, start, end, m, c_):
        """Spreading from spectral concentration: the energy-weighted mean
        inverse participation ratio of the normalised bands (bands are
        unit-normalised, so the weighting must come from the pre-norm
        energies or silent bands drown the tonality signal).  Concentrated
        (tonal) spectra rotate less (NONE/LIGHT) so pulses stay on peaks;
        noise-like spectra keep NORMAL.  Any coded value is conformant —
        the decoder inverts whatever is signalled."""
        from .vq import SPREAD_LIGHT, SPREAD_NONE

        ipr_sum, w_sum = 0.0, 0.0
        for i in range(start, end):
            a = m * int(modes.E_BANDS[i])
            b = m * int(modes.E_BANDS[i + 1])
            if b - a < 4:
                continue
            v = x_[a:b]
            e2 = float(np.dot(v, v))
            if e2 < 1e-12:
                continue
            w = float(band_e[0][i]) ** 2
            ipr_sum += w * (b - a) * float(np.sum(v**4)) / (e2 * e2)
            w_sum += w
        if w_sum <= 0:
            return SPREAD_NORMAL
        ipr = ipr_sum / w_sum  # ~1-3 for noise, >> 1 for tonal peaks
        if ipr > 12.0:
            return SPREAD_NONE
        if ipr > 6.0:
            return SPREAD_LIGHT
        return SPREAD_NORMAL

    def _dynalloc_analysis(self, band_log_e, start, end, lm, c_, cap,
                           is_transient=False, effective_bytes=0):
        """Per-band boost targets (1/8-bit units) from a masking-floor
        follower (the celt_encoder.c dynalloc_analysis semantics, authored
        fresh; cf. reference scope celt/decoder.rs:25 build note).

        A leaky min-envelope tracks the spectral floor per channel (rise
        limited to 1.5 log2/band going up, 2.0 coming back down, stopping
        at the last ascending band so band-limited signals don't boost
        their empty tail), is floored by a +/-2-band median - 1 and by the
        per-band noise floor of the input depth.  A band's boost is the
        bits needed to push coding noise down to that floor: one bit per
        sample per log2 of excess (excess capped at 4), doubled below
        band 8, halved from band 12 up, halved again on CBR non-transient
        frames, with the total capped at 2/3 of the frame bytes."""
        want = [0] * modes.NB_E_BANDS
        n = end - start
        if n < 3 or effective_bytes <= 50 or lm < 1:
            return want
        e = band_log_e[:c_, :end].astype(np.float64)
        follow = np.empty((c_, n))
        for c in range(c_):
            ec = e[c, start:end]
            f = np.empty(n)
            f[0] = ec[0]
            last = 0
            for i in range(1, n):
                if ec[i] > ec[i - 1] + 0.5:
                    last = i
                f[i] = min(f[i - 1] + 1.5, ec[i])
            for i in range(last - 1, -1, -1):
                f[i] = min(f[i], min(f[i + 1] + 2.0, ec[i]))
            # median guard: never below the local median - 1 (stops the
            # follower from calling an ordinary spectral slope "excess")
            med = np.empty(n)
            for i in range(n):
                lo = max(0, i - 2)
                hi = min(n, i + 3)
                med[i] = np.median(ec[lo:hi])
            f = np.maximum(f, med - 1.0)
            # noise floor of a 24-bit input at this band's width/centre
            idx = np.arange(start, end)
            nf = (0.0625 * modes.LOG_N[idx] + 0.5 + 9.0 - 24.0
                  - E_MEANS_F[idx] + 0.0062 * (idx + 5.0) ** 2)
            follow[c] = np.maximum(f, nf)
        if c_ == 2:
            # 24 dB cross-talk: a band audible in one channel masks its
            # twin; excess is the mean of the per-channel excesses
            f0 = np.maximum(follow[0], follow[1] - 4.0)
            f1 = np.maximum(follow[1], follow[0] - 4.0)
            exc = 0.5 * (np.maximum(0.0, e[0, start:end] - f0)
                         + np.maximum(0.0, e[1, start:end] - f1))
        else:
            exc = np.maximum(0.0, e[0, start:end] - follow[0])
        if not getattr(self, "vbr", False) and not is_transient:
            exc *= 0.5
        total_cap = (2 * effective_bytes // 3) << (BITRES + 3)
        tot = 0
        for i in range(start, end):
            x = float(exc[i - start])
            if i < 8:
                x *= 2.0
            if i >= 12:
                x *= 0.5
            x = min(x, 4.0)
            if x <= 0.0:
                continue
            width = c_ * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i]) << lm
            # one bit per sample per log2 of excess, quantised per width
            # class so narrow bands move in >=1-bit steps
            if width < 6:
                bb = int(x) * width << BITRES
            elif width > 48:
                bb = (int(8 * x) * width << BITRES) >> 3
            else:
                bb = (int(x * width / 6.0) * 6) << BITRES
            bb = min(bb, int(cap[i]))
            if tot + bb > total_cap:
                bb = max(0, total_cap - tot)
            want[i] = bb
            tot += bb
        return want

    def _trim_decision(self, band_log_e, start, end, c_) -> int:
        """Allocation trim from the spectral tilt: HF-tilted frames get a
        lower trim (more bits to high bands), LF-tilted a higher one."""
        if end - start < 2:
            return 5
        diff = 0.0
        for c in range(c_):
            e = band_log_e[c, start:end]
            n = end - start
            diff += float(np.dot(e - e.mean(), 2.0 * np.arange(n) - n + 1))
        tilt = diff / (c_ * (end - start) * (end - start))
        return max(0, min(10, int(round(5 - 0.7 * tilt))))

    def _transient_decision(self, pre: np.ndarray, m: int) -> bool:
        """Energy-ratio transient heuristic: short blocks when one 2.5 ms
        sub-block jumps far above the running energy floor.  The floor is
        seeded with the PREVIOUS frame's last sub-block so an attack in
        the first 2.5 ms of a frame can fire too (castanet clicks landing
        at a frame boundary were invisible to the old in-frame-only
        floor)."""
        n = pre.shape[1]
        sub = n // m if m > 1 else n
        e = (pre.reshape(pre.shape[0], -1, sub) ** 2).sum(axis=2).max(axis=0) + 1e-9
        prev_tail = getattr(self, "_prev_sub_energy", None)
        self._prev_sub_energy = float(e[-1])
        if len(e) < 2:
            return False
        seed = float(e[0]) if prev_tail is None else prev_tail
        floor = np.minimum.accumulate(np.concatenate([[seed], e[:-1]]))
        ratio = float(np.max(e / np.maximum(floor, 1e-9)))
        return ratio > 6.0

    def _tf_analysis(self, x_, start, end, lm, m, c_, is_transient,
                     nb_bytes=1 << 30):
        """Per-band time/frequency resolution choice on EVERY frame.

        The decoder's quant_band runs one of two Haar ladders per band
        (bands.py:470-487): tf_change>0 recombines interleaved short
        blocks (frequency resolution), tf_change<0 splits a band into
        halves (time resolution inside a long MDCT — the lever that
        tracks decaying attacks; libopus uses it heavily on click tails
        where we previously always signalled 0).  The bitstream carries
        one flag per band plus a global tf_select; the executed
        tf_change is TF_SELECT_TABLE[lm][4*T + 2*sel + flag].

        Analysis (authored fresh): for each band, apply the EXACT
        ladder the decoder would run for each achievable tf_change and
        score it by biased L1 (sparser post-transform coefficients are
        cheaper to shape-code; 4% penalty per Haar step, slight extra
        preference for flag=0).  Per sel option, each band picks its
        best flag; the sel with the lower corpus-of-bands total wins.
        Returns (tf_res flags, tf_select)."""
        from .bands import haar1

        tf_res = [0] * modes.NB_E_BANDS
        if lm == 0 or end - start < 1:
            return tf_res, 0
        # At very low rates (<100-byte frames ~= 32 kbps stereo) the PVQ
        # has too few pulses for the time-split resolution to pay for
        # itself: corpus-measured, every 32k signal lost 0.4-1.6 dB with
        # non-transient tf active while 64k+ gained 2-5 dB.  Transient
        # frames keep the analysis at every rate.
        if not is_transient and nb_bytes < 100:
            return tf_res, 0
        base = 4 if is_transient else 0
        table = TF_SELECT_TABLE[lm]

        def ladder_l1(band: np.ndarray, n: int, v: int) -> float:
            x = band.copy()
            steps = 0
            if v > 0:
                for k in range(v):
                    if (n >> k) < 2:
                        break
                    haar1(x, n >> k, 1 << k)
                    steps += 1
            elif v < 0:
                n_b, bb = (n // m, m) if is_transient else (n, 1)
                while (n_b & 1) == 0 and v < 0:
                    haar1(x, n_b, bb)
                    bb <<= 1
                    n_b >>= 1
                    v += 1
                    steps += 1
            return float(np.abs(x).sum()) * (1.0 + 0.04 * steps)

        # Score both flag values under both sel options in one pass.
        cost = np.zeros((2, 2, end - start))  # [sel][flag][band]
        for i in range(start, end):
            n = m * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i])
            b0 = x_[m * int(modes.E_BANDS[i]) : m * int(modes.E_BANDS[i]) + n]
            if n < 2:
                continue
            seen: dict[int, float] = {}
            for sel in (0, 1):
                for flag in (0, 1):
                    v = table[base + 2 * sel + flag]
                    if v not in seen:
                        seen[v] = ladder_l1(b0, n, v)
                    cost[sel, flag, i - start] = seen[v] * (1.005 if flag else 1.0)
        best = np.minimum(cost[:, 0, :], cost[:, 1, :]).sum(axis=1)
        sel = int(best[1] < best[0])
        for i in range(start, end):
            tf_res[i] = int(cost[sel, 1, i - start] < cost[sel, 0, i - start])
        return tf_res, sel

    def _tf_encode(self, enc, start, end, is_transient, lm, nb_bytes, tf_res,
                   tf_select=0):
        """Write the per-band tf flags exactly as tf_decode reads them
        (delta-coded with budget gating) and return the decoder-visible
        tf_res after TF_SELECT mapping — quant_all_bands must see the same
        values the decoder derives."""
        budget = nb_bytes * 8
        tell = enc.tell()
        logp = 2 if is_transient else 4
        tf_select_rsv = 1 if (lm > 0 and tell + logp + 1 <= budget) else 0
        budget -= tf_select_rsv
        curr = 0
        tf_changed = 0
        out = [0] * modes.NB_E_BANDS
        for i in range(start, end):
            if tell + logp <= budget:
                enc.encode_bit_logp(tf_res[i] ^ curr, logp)
                tell = enc.tell()
                curr = tf_res[i]
                tf_changed |= curr
            out[i] = curr
            logp = 4 if is_transient else 5
        base = 4 if is_transient else 0
        # The select bit is only coded when it changes an executed value
        # (tf_decode's gate); otherwise the decoder derives sel=0.
        if tf_select_rsv and TF_SELECT_TABLE[lm][base + tf_changed] != TF_SELECT_TABLE[lm][base + 2 + tf_changed]:
            enc.encode_bit_logp(tf_select, 1)
        else:
            tf_select = 0
        for i in range(start, end):
            out[i] = TF_SELECT_TABLE[lm][base + 2 * tf_select + out[i]]
        return out
