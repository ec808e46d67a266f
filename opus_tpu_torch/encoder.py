"""The Opus encoder, a copy of opus_tpu.encoder.

Encoder and EncoderConfiguration: music (CELT), voice (SILK) and hybrid
sessions, CBR and VBR, in-band FEC, DTX, multi-frame packets, and the
set_* control surface.  The packets come from the native encoders of
native/frontend.py (NativeCeltEncoder, NativeVoiceEncoder,
NativeStereoVoiceEncoder, NativeHybridEncoder); the Python encoders are
built beside them.  The multistream encoder and the CLI use it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .celt.encoder import CeltEncoder
from .errors import BadArguments
from .types import Channels, SamplingRate

#: frame samples (48 kHz) -> CELT fullband ToC config number.
_CELT_FB_CONFIG = {120: 28, 240: 29, 480: 30, 960: 31}
#: CELT-only config block base + coded band limit per bandwidth.
_CELT_BW = {"NB": (16, 13), "WB": (20, 17), "SWB": (24, 19), "FB": (28, 21)}

#: SILK internal kHz -> 20 ms SILK-only ToC config number.
_SILK_20MS_CONFIG = {8: 1, 12: 5, 16: 9}
#: Hybrid 20 ms ToC configs: SWB=13, FB=15.
_HYBRID_20MS_SWB = 13


@dataclasses.dataclass(frozen=True)
class EncoderConfiguration:
    sampling_rate: SamplingRate = SamplingRate.HZ_48000
    channels: Channels = Channels.STEREO
    bitrate: int = 96000  # bits/sec, CBR
    #: "music" -> CELT full-band; "voice" -> SILK WB (mono, 20 ms frames);
    #: "hybrid" -> SILK WB low band + CELT bands 17+ (mono SWB, 20 ms, 48 kHz).
    application: str = "music"
    #: Discontinuous transmission: emit 1-byte packets during silence
    #: (after one hangover frame); decoders run PLC/CNG over the gap.
    dtx: bool = False
    #: Variable bitrate (music mode): per-frame byte budget follows the
    #: content (transient boost, quiet-frame cut) around `bitrate`, with a
    #: bit reservoir holding the long-term average at the target.
    vbr: bool = False
    #: Audio bandwidth.  Music: "NB"/"WB"/"SWB"/"FB" forces a coded band
    #: limit (13/17/19/21; ToC config block per RFC 6716 table 2);
    #: "auto" (default) picks by bitrate like libopus's
    #: audio_bandwidth_thresholds — coding fewer bands at low rates
    #: spends the bits where the energy is (WB under ~45 kb/s equivalent,
    #: SWB under ~59 kb/s, FB above; stereo rates count 3/4).  Voice:
    #: "NB"/"MB"/"WB" forces the SILK internal rate (8/12/16 kHz);
    #: "auto"/"FB" = auto from the input rate.
    bandwidth: str = "auto"
    #: In-band FEC (voice + hybrid, mono + stereo): each packet also
    #: carries a coarse LBRR re-encode of the previous frame's SILK band;
    #: receivers recover one lost packet with
    #: decode(next_packet, decode_fec=True).
    fec: bool = False


def _try_native_voice(fs_khz: int, in_rate: int, fec: bool = False):
    """Native mono voice plane (None when the engine is unavailable)."""
    try:
        from .native.frontend import NativeVoiceEncoder

        return NativeVoiceEncoder(fs_khz, in_rate, fec)
    except Exception:
        return None


def _try_native_stereo_voice(fs_khz: int, in_rate: int, fec: bool = False):
    try:
        from .native.frontend import NativeStereoVoiceEncoder

        return NativeStereoVoiceEncoder(fs_khz, in_rate, fec)
    except Exception:
        return None


def _try_native_hybrid(channels: int = 1, fec: bool = False):
    try:
        from .native.frontend import NativeHybridEncoder

        return NativeHybridEncoder(channels, fec)
    except Exception:
        return None


def _try_native_music(channels: int, end_band: int):
    try:
        from .native.frontend import NativeCeltEncoder

        enc = NativeCeltEncoder(channels)
        enc.end_band = end_band
        return enc
    except Exception:
        return None


class Encoder:
    """Stateful Opus encoder for one elementary stream."""

    def __init__(self, configuration: EncoderConfiguration | None = None):
        self.config = configuration or EncoderConfiguration()
        self.rate = int(self.config.sampling_rate)
        self.channels = int(self.config.channels)
        self.application = self.config.application
        self.bitrate = int(self.config.bitrate)
        # Runtime-tunable knobs (see ctl()/set_* below); initialised from
        # the construction-time configuration.
        self.vbr = bool(self.config.vbr)
        self.dtx = bool(self.config.dtx)
        self.bandwidth = self.config.bandwidth
        self.complexity = 10
        self.packet_loss_perc = 10 if self.config.fec else 0
        self._rng = 0
        self._dtx_run = 0
        self._last_toc = None
        self._vbr_reservoir = 0.0
        self._native_enc = None
        if self.application == "voice":
            from .silk.encoder import SilkEncoder
            from .silk.resampler import Resampler

            _vbw = {"NB": 8, "MB": 12, "WB": 16}
            if self.config.bandwidth in _vbw:
                self.silk_fs_khz = min(_vbw[self.config.bandwidth], self.rate // 1000)
            else:
                self.silk_fs_khz = 16 if self.rate >= 16000 else self.rate // 1000
            self._lbrr_prev = None
            # Native plane (silk_encoder.inc VoiceEnc/StereoVoiceEnc:
            # resampler + SILK encoder + optional LBRR companion in C++,
            # ~100-500x the Python path).
            self._native_enc = (
                _try_native_voice(self.silk_fs_khz, self.rate, self.config.fec)
                if self.channels == 1
                else _try_native_stereo_voice(self.silk_fs_khz, self.rate,
                                              self.config.fec)
            )
            if self.channels == 2:
                from .silk.stereo_encoder import SilkStereoEncoder

                self._lbrr_enc = SilkStereoEncoder(self.silk_fs_khz) if self.config.fec else None
                self.silk = SilkStereoEncoder(self.silk_fs_khz)
                self._resampler = None if self.rate == self.silk_fs_khz * 1000 else [
                    Resampler(self.rate, self.silk_fs_khz * 1000) for _ in range(2)]
            else:
                self._lbrr_enc = SilkEncoder(self.silk_fs_khz) if self.config.fec else None
                self.silk = SilkEncoder(self.silk_fs_khz)
                self._resampler = (
                    None
                    if self.rate == self.silk_fs_khz * 1000
                    else Resampler(self.rate, self.silk_fs_khz * 1000)
                )
            self.celt = None
        elif self.application == "hybrid":
            if self.rate != 48000:
                raise BadArguments("hybrid mode takes 48 kHz input")
            from .silk.encoder import SilkEncoder
            from .silk.resampler import Resampler

            self.silk_fs_khz = 16
            self._lbrr_prev = None
            if self.channels == 2:
                from .silk.stereo_encoder import SilkStereoEncoder

                self._lbrr_enc = SilkStereoEncoder(16) if self.config.fec else None
                self.silk = SilkStereoEncoder(16)
                self._resampler = [Resampler(48000, 16000) for _ in range(2)]
            else:
                self._lbrr_enc = SilkEncoder(16) if self.config.fec else None
                self.silk = SilkEncoder(16)
                self._resampler = Resampler(48000, 16000)
            self._native_enc = _try_native_hybrid(self.channels, self.config.fec)
            self.celt = CeltEncoder(self.channels)
            self.celt.start_band = 17
            self.celt.end_band = 19  # SWB
            # Align the band paths: CELT's MDCT overlap costs ~120 samples
            # @48 kHz, the SILK path ~54 (13 @16 kHz decoder delay + the
            # 48->16 resampler); delay the SILK input by the difference.
            self._silk_delay = np.zeros((66, self.channels), dtype=np.float32)
        else:
            if self.rate != 48000:
                raise BadArguments("music mode supports 48 kHz input for now")
            if self.bandwidth == "auto":
                # Rate-driven coded bandwidth (libopus opus_encoder.c
                # audio_bandwidth_thresholds, measured on our corpus:
                # the three round-4 negative quality rows — castanet 32k,
                # tones 64k, noise_white 32k — all flip positive once low
                # rates stop paying for bands they can't afford).
                equiv = self.bitrate * 3 // 4 if self.channels == 2 else self.bitrate
                self.bandwidth = ("NB" if equiv < 12000 else
                                  "WB" if equiv < 45000 else
                                  "SWB" if equiv < 59000 else "FB")
            if self.bandwidth not in _CELT_BW:
                raise BadArguments("bandwidth must be auto/NB/WB/SWB/FB")
            self.celt = CeltEncoder(self.channels)
            self.celt.end_band = _CELT_BW[self.bandwidth][1]
            self.silk = None
            # Native plane (celt_encoder.inc): conformant CELT bitstreams
            # at C++ speed; Python keeps the fallback.
            self._native_enc = _try_native_music(self.channels,
                                                 self.celt.end_band)

    def reset(self) -> None:
        if self.celt is not None:
            self.celt.reset()
        if self._native_enc is not None and hasattr(self._native_enc, "reset"):
            self._native_enc.reset()

    @property
    def final_range(self) -> int:
        if self._native_enc is not None:
            return self._rng
        return self.celt.rng if self.celt is not None else self._rng

    def max_encoded_size(self, frame_size: int) -> int:
        return 1 + min(1275, self.frame_bytes(frame_size))

    # ------------------------------------------------------------------
    # Runtime control surface (the libopus opus_encoder_ctl equivalent;
    # the reference encoder sketch implies it).
    # Every knob takes effect from the next encode() call.
    # ------------------------------------------------------------------

    def set_bitrate(self, bits_per_second: int) -> None:
        """Change the target bitrate mid-stream (500 .. 512000 b/s)."""
        if not 500 <= int(bits_per_second) <= 512000:
            raise BadArguments("bitrate out of range")
        self.bitrate = int(bits_per_second)

    def set_vbr(self, enabled: bool) -> None:
        """Toggle variable bitrate (music mode's per-frame budget loop)."""
        self.vbr = bool(enabled)

    def set_dtx(self, enabled: bool) -> None:
        """Toggle discontinuous transmission (1-byte packets in silence)."""
        self.dtx = bool(enabled)
        if not self.dtx:
            self._dtx_run = 0

    def set_complexity(self, complexity: int) -> None:
        """0..10; >= 8 enables the CELT theta RDO search (libopus scale)."""
        if not 0 <= int(complexity) <= 10:
            raise BadArguments("complexity must be 0..10")
        self.complexity = int(complexity)

    def set_packet_loss_perc(self, perc: int) -> None:
        """Expected loss rate; > 0 activates LBRR when in-band FEC is on."""
        if not 0 <= int(perc) <= 100:
            raise BadArguments("packet loss percentage must be 0..100")
        self.packet_loss_perc = int(perc)
        self._update_fec_state()

    def set_inband_fec(self, enabled: bool) -> None:
        """Toggle in-band FEC (LBRR) for voice/hybrid streams."""
        self._fec_requested = bool(enabled)
        if enabled and self.packet_loss_perc == 0:
            self.packet_loss_perc = 10
        self._update_fec_state()

    def set_bandwidth(self, bandwidth: str) -> None:
        """Change the coded audio bandwidth. Music: NB/WB/SWB/FB mid-stream
        (the decoder reconfigures from each packet's ToC).  Voice/hybrid
        keep their internal rate; pick it at construction time."""
        if self.application != "music":
            if bandwidth != self.bandwidth:
                raise BadArguments("voice/hybrid bandwidth is fixed per stream")
            return
        if bandwidth not in _CELT_BW:
            raise BadArguments("bandwidth must be NB/WB/SWB/FB")
        self.bandwidth = bandwidth
        self.celt.end_band = _CELT_BW[bandwidth][1]
        if self._native_enc is not None:
            self._native_enc.end_band = self.celt.end_band

    def ctl(self, name: str, value) -> None:
        """Generic control entry: ctl('bitrate', 64000) etc."""
        setter = getattr(self, f"set_{name}", None)
        if setter is None:
            raise BadArguments(f"unknown encoder control {name!r}")
        setter(value)

    def _update_fec_state(self) -> None:
        want = getattr(self, "_fec_requested", self.config.fec) and self.packet_loss_perc > 0
        if self.application not in ("voice", "hybrid"):
            return
        if want and self._lbrr_enc is None:
            if self.channels == 2:
                from .silk.stereo_encoder import SilkStereoEncoder

                self._lbrr_enc = SilkStereoEncoder(self.silk_fs_khz)
            else:
                from .silk.encoder import SilkEncoder

                self._lbrr_enc = SilkEncoder(self.silk_fs_khz)
            self._lbrr_prev = None
        elif not want and self._lbrr_enc is not None:
            self._lbrr_enc = None
            self._lbrr_prev = None

    def frame_bytes(self, frame_size: int) -> int:
        return max(2, min(1275, (self.bitrate * frame_size) // (48000 * 8)))

    def encode(self, pcm: np.ndarray) -> bytes:
        """Encode one frame of float PCM [N, channels] in ±1.

        Music mode: N in {120, 240, 480, 960, 1920, 2880} at 48 kHz.
        Voice mode: N = 20 ms at the configured rate.
        Returns a complete Opus packet."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        n = pcm.shape[0]
        if pcm.shape[1] != self.channels:
            raise BadArguments("channel count mismatch")
        if self.dtx:
            rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
            if rms < 1e-4:
                self._dtx_run += 1
                # Refresh the receiver's comfort-noise parameters with a
                # real frame every ~400 ms of silence (libopus DTX cadence);
                # otherwise emit a 1-byte ToC-only packet.
                refresh = (self._dtx_run - 2) % max(1, 400 // max(1, n * 1000 // self.rate)) == 0
                if self._dtx_run >= 2 and not (self._dtx_run > 2 and refresh):
                    toc = (self._last_toc if self._last_toc is not None
                           else self._toc_for(n))
                    if self.application == "music" and n in (1920, 2880):
                        # 40/60 ms cadence: a code-3 packet of M zero-
                        # length CBR frames keeps the DTX duration right.
                        return bytes([toc | 0x3, n // 960])
                    return bytes([toc])
            else:
                self._dtx_run = 0
        if self.application == "voice":
            return self._encode_voice(pcm, n)
        if self.application == "hybrid":
            return self._encode_hybrid(pcm, n)
        if n in (1920, 2880):
            # 40/60 ms music: CELT frames cap at 20 ms (RFC 6716 table 2;
            # ref lib.rs:20-28 envelope), so pack 2-3 independent 20 ms
            # frames as ONE code-3 packet (lib.rs:250-263 frame-count
            # framing) via the repacketizer.  Cross-frame encoder state
            # (energy prediction, overlap) carries normally; final_range
            # is the LAST frame's, matching the decoder's multi-frame
            # loop semantics.
            from .repacketizer import Repacketizer

            rp = Repacketizer()
            for i in range(n // 960):
                rp.cat(self._encode_music(pcm[960 * i : 960 * (i + 1)], 960))
            return rp.out()
        return self._encode_music(pcm, n)

    def _encode_music(self, pcm: np.ndarray, n: int) -> bytes:
        if n not in _CELT_FB_CONFIG:
            raise BadArguments("frame must be 2.5/5/10/20/40/60 ms at 48 kHz")
        cfg = _CELT_BW[self.bandwidth][0] + (_CELT_FB_CONFIG[n] - 28)
        toc = (cfg << 3) | (0x4 if self.channels == 2 else 0)
        nb = self._vbr_bytes(pcm, n) if self.vbr else self.frame_bytes(n)
        if self._native_enc is not None:
            self._native_enc.complexity = self.complexity
            payload = self._native_enc.encode(pcm, nb)
            self._rng = self._native_enc.final_range
        else:
            self.celt.complexity = self.complexity
            payload = self.celt.encode(pcm, nb)
        self._last_toc = toc
        return bytes([toc]) + payload

    def _vbr_bytes(self, pcm: np.ndarray, n: int) -> int:
        """Per-frame byte budget: transient frames borrow from the
        reservoir, quiet frames repay it; long-term average stays at
        `bitrate` (cf. the reference's VBR loop, celt/celt_encoder.c
        vbr_rate handling — redesigned as a packet-level controller)."""
        base = self.frame_bytes(n)
        x = pcm.astype(np.float64)
        sub = max(n // 8, 1)
        e = (x[: (n // sub) * sub].reshape(-1, sub, x.shape[1]) ** 2).sum(axis=(1, 2)) + 1e-12
        rms = float(np.sqrt(np.mean(x**2)))
        if rms < 1e-6:
            # Digital silence: the CELT silence flag codes the frame in one
            # symbol, so two payload bytes suffice (reservoir refills).
            self._vbr_reservoir = min(4.0 * base, self._vbr_reservoir + base - 2)
            return 2
        boost = 1.0
        if len(e) >= 2:
            floor = np.minimum.accumulate(np.concatenate([[e[0]], e[:-1]]))
            if float(np.max(e[1:] / np.maximum(floor[1:], 1e-12))) > 6.0:
                boost = 1.35  # transient: spend extra bits on short blocks
        if rms < 1e-3:
            boost *= 0.55  # near-silence
        elif rms < 1e-2:
            boost *= 0.8
        correction = max(-0.3 * base, min(0.3 * base, 0.25 * self._vbr_reservoir))
        nb = int(round(base * boost + correction))
        nb = max(max(2, base // 2), min(nb, min(1275, (base * 8) // 5)))
        self._vbr_reservoir = max(-4.0 * base, min(4.0 * base, self._vbr_reservoir + base - nb))
        return nb

    def _toc_for(self, n: int) -> int:
        stereo = 0x4 if self.channels == 2 else 0
        if self.application == "voice":
            ms = max(20, min(60, n * 1000 // self.rate))
            return ((_SILK_20MS_CONFIG[self.silk_fs_khz] + (ms // 20 - 1)) << 3) | stereo
        if self.application == "hybrid":
            return (_HYBRID_20MS_SWB << 3) | stereo
        return ((_CELT_BW[self.bandwidth][0] + (_CELT_FB_CONFIG.get(n, 31) - 28)) << 3) | stereo

    def _encode_voice(self, pcm: np.ndarray, n: int) -> bytes:
        ms = n * 1000 // self.rate
        if ms not in (10, 20, 40, 60) or n * 1000 != ms * self.rate:
            raise BadArguments("voice mode takes 10/20/40/60 ms frames")
        budget = max(10, (self.bitrate * ms) // (1000 * 8))
        if self._native_enc is not None:
            xi = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
            if self.channels == 2:
                payload = self._native_enc.encode(xi[:, 0], xi[:, 1], budget)
            else:
                payload = self._native_enc.encode(xi[:, 0], budget)
            self._rng = self._native_enc.final_range
            off = {10: -1, 20: 0, 40: 1, 60: 2}[ms]
            toc = ((_SILK_20MS_CONFIG[self.silk_fs_khz] + off) << 3) | (
                0x4 if self.channels == 2 else 0)
            self._last_toc = toc
            return bytes([toc]) + payload
        if self.channels == 2:
            chans = []
            for c in range(2):
                xc = np.clip(pcm[:, c] * 32768.0, -32768, 32767).astype(np.int16)
                if self._resampler is not None:
                    xc = np.array(self._resampler[c].process([int(v) for v in xc]), dtype=np.int16)
                chans.append(xc)
            if self._lbrr_enc is not None:
                payload = self.silk.encode_packet_cbr(
                    chans[0], chans[1], budget,
                    lbrr_x=self._lbrr_prev if self._lbrr_prev is not None
                    and len(self._lbrr_prev[0]) == len(chans[0]) else None,
                    lbrr_enc=self._lbrr_enc)
                self._lbrr_prev = (chans[0].copy(), chans[1].copy())
            else:
                payload = self.silk.encode_packet_cbr(chans[0], chans[1], budget)
        else:
            x48 = np.clip(pcm[:, 0] * 32768.0, -32768, 32767).astype(np.int16)
            if self._resampler is not None:
                x = np.array(self._resampler.process([int(v) for v in x48]), dtype=np.int16)
            else:
                x = x48
            if self._lbrr_enc is not None:
                payload = self.silk.encode_packet_cbr(
                    x, budget,
                    lbrr_x=self._lbrr_prev if self._lbrr_prev is not None
                    and len(self._lbrr_prev) == len(x) else None,
                    lbrr_enc=self._lbrr_enc)
                self._lbrr_prev = x.copy()
            else:
                payload = self.silk.encode_packet_cbr(x, budget)
        self._rng = self.silk.last_range
        # 10/20/40/60 ms share a config block per bandwidth; 20 ms is +1.
        off = {10: -1, 20: 0, 40: 1, 60: 2}[ms]
        toc = ((_SILK_20MS_CONFIG[self.silk_fs_khz] + off) << 3) | (
            0x4 if self.channels == 2 else 0)
        self._last_toc = toc
        return bytes([toc]) + payload

    def _encode_hybrid(self, pcm: np.ndarray, n: int) -> bytes:
        """SILK WB low band + CELT bands 17.. in one shared range coder
        (RFC 6716 hybrid framing, SWB 20 ms mono, CBR)."""
        from .rc.encoder import RangeEncoder

        if n not in (480, 960):
            raise BadArguments("hybrid mode takes 10/20 ms frames")
        ms = n // 48
        nb_bytes = max(25 * self.channels, min(1275, (self.bitrate * ms) // (1000 * 8)))
        if self._native_enc is not None:
            payload = self._native_enc.encode(
                pcm[:, 0] if self.channels == 1 else pcm, nb_bytes)
            self._rng = self._native_enc.final_range
            toc = ((_HYBRID_20MS_SWB - (1 if ms == 10 else 0)) << 3) | (
                0x4 if self.channels == 2 else 0)
            self._last_toc = toc
            return bytes([toc]) + payload
        silk_in = np.concatenate([self._silk_delay, pcm])
        self._silk_delay = silk_in[n:].astype(np.float32)
        x48 = np.clip(silk_in[:n] * 32768.0, -32768, 32767).astype(np.int16)
        if self.channels == 2:
            x16 = [np.array(self._resampler[c].process([int(v) for v in x48[:, c]]),
                            dtype=np.int16) for c in range(2)]
        else:
            x16 = np.array(self._resampler.process([int(v) for v in x48[:, 0]]), dtype=np.int16)

        # SILK should take roughly 60% of the budget; retry coarser if over.
        headroom = 1.2
        saved = self.silk.snapshot()
        saved_lbrr = (self._lbrr_enc.snapshot()
                      if getattr(self, "_lbrr_enc", None) is not None else None)
        celt_state = (self.celt.in_mem.copy(), self.celt.preemph_mem.copy(),
                      self.celt.old_band_e.copy(), self.celt.rng, self.celt.frame_count)
        for _ in range(5):
            self.silk.restore(saved)
            (self.celt.in_mem, self.celt.preemph_mem, self.celt.old_band_e,
             self.celt.rng, self.celt.frame_count) = (
                celt_state[0].copy(), celt_state[1].copy(), celt_state[2].copy(),
                celt_state[3], celt_state[4])
            buf = bytearray(nb_bytes)
            enc = RangeEncoder(buf)
            if self.channels == 2 and self._lbrr_enc is not None:
                has_lbrr = (self._lbrr_prev is not None
                            and len(self._lbrr_prev[0]) == len(x16[0]))
                if saved_lbrr is not None:
                    self._lbrr_enc.restore(saved_lbrr)
                self.silk.encode_frame_into(
                    enc, x16[0], x16[1], headroom,
                    lbrr_x=self._lbrr_prev if has_lbrr else None,
                    lbrr_enc=self._lbrr_enc if has_lbrr else None)
            elif self.channels == 2:
                self.silk.encode_frame_into(enc, x16[0], x16[1], headroom)
            elif self._lbrr_enc is not None:
                # Hybrid in-band FEC: VAD + LBRR flags, then the LBRR
                # re-encode of the previous frame's low band, then the
                # regular frame (silk/api.py parse order).
                enc.encode_bit_logp(1, 1)  # VAD
                has_lbrr = self._lbrr_prev is not None and len(self._lbrr_prev) == len(x16)
                enc.encode_bit_logp(1 if has_lbrr else 0, 1)  # LBRR
                if has_lbrr:
                    self._lbrr_enc.restore(saved_lbrr)
                    self._lbrr_enc.ec_prev_signal_type = self.silk.ec_prev_signal_type
                    self._lbrr_enc.ec_prev_lag_index = self.silk.ec_prev_lag_index
                    self._lbrr_enc.encode_frame(enc, self._lbrr_prev,
                                                headroom=headroom * 2.0,
                                                write_header=False)
                    self.silk.ec_prev_signal_type = self._lbrr_enc.ec_prev_signal_type
                    self.silk.ec_prev_lag_index = self._lbrr_enc.ec_prev_lag_index
                self.silk.encode_frame(enc, x16, headroom=headroom, write_header=False)
            else:
                self.silk.encode_frame(enc, x16, headroom=headroom)
            silk_bits = enc.tell()
            if silk_bits > int(nb_bytes * 8 * 0.72) and headroom > 0.4:
                headroom = max(0.38, headroom * 0.6)
                continue
            break
        # Redundancy flag (decoder reads it when budget allows).
        if enc.tell() + 37 <= 8 * nb_bytes:
            enc.encode_bit_logp(0, 12)
        # CELT high bands share the remaining budget.
        self.celt.encode(pcm, nb_bytes, enc=enc)
        enc.done()
        if getattr(self, "_lbrr_enc", None) is not None:
            self._lbrr_prev = ((x16[0].copy(), x16[1].copy())
                               if self.channels == 2 else x16.copy())
        self._rng = enc.rng & 0xFFFFFFFF
        toc = ((_HYBRID_20MS_SWB - (1 if ms == 10 else 0)) << 3) | (
            0x4 if self.channels == 2 else 0)
        self._last_toc = toc
        return bytes([toc]) + bytes(buf)
