"""The scalar Opus decoder (RFC 6716), a copy of opus_tpu.decoder.

Decoder and DecoderConfiguration: the normative state machine over the
CELT, SILK and hybrid layers, one packet at a time in numpy on the host,
with loss concealment, in-band FEC, gain and the int16 soft-clip path.
The multistream codec and the CLI decode with it, and chip_smoke.py holds
the batched device decoders to it.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .celt import modes as celt_modes
from .celt.bands import celt_exp2
from .celt.decoder import CeltDecoder
from .errors import BadArguments, BufferTooSmall
from .packet import parse_packet, query_packet_samples_per_frame
from .rc import RangeDecoder
from .softclip import pcm_soft_clip
from .types import Bandwidth, Channels, CodecMode, SamplingRate, convert_samples

#: ToC bandwidth -> CELT end band (libopus opus_decoder.c mapping).
CELT_END_BAND = {
    Bandwidth.NARROWBAND: 13,
    Bandwidth.MEDIUMBAND: 17,
    Bandwidth.WIDEBAND: 17,
    Bandwidth.SUPERWIDEBAND: 19,
    Bandwidth.FULLBAND: 21,
}


@dataclasses.dataclass(frozen=True)
class DecoderConfiguration:
    """Decoder setup (reference: decoder.rs:27-44)."""

    sampling_rate: SamplingRate = SamplingRate.HZ_48000
    channels: Channels = Channels.STEREO
    #: Playback gain in Q8 dB (gain = 10**(x/(20*256))).
    gain: int = 0


def _smooth_fade(in1, in2, out, overlap, channels, inc):
    """Windowed crossfade with the squared MDCT window at 48k/Fs stride
    (reference: decoder.rs:833-865)."""
    w = celt_modes.WINDOW[::1].astype(np.float64)
    for i in range(overlap):
        wi = w[i * inc] * w[i * inc]
        out[i, :channels] = wi * in2[i, :channels] + (1.0 - wi) * in1[i, :channels]


class Decoder:
    """Stateful Opus decoder for one elementary stream."""

    def __init__(self, configuration: DecoderConfiguration | None = None):
        self.config = configuration or DecoderConfiguration()
        rate = int(self.config.sampling_rate)
        self.sampling_rate = self.config.sampling_rate
        self.channels = int(self.config.channels)
        self.decode_gain = int(self.config.gain)
        self.downsample = 48000 // rate
        self.celt = CeltDecoder(self.channels, self.downsample)
        from .silk.api import SilkLayer

        self.silk = SilkLayer(rate, self.channels)
        self.reset()

    # -- public accessors (reference: decoder.rs:80-123) --------------------

    def reset(self) -> None:
        self.celt.reset()
        self.silk.reset()
        self.stream_channels = self.channels
        self.bandwidth: Bandwidth | None = None
        self.mode: CodecMode | None = None
        self.prev_mode: CodecMode | None = None
        self.frame_size = int(self.sampling_rate) // 400
        self.prev_redundancy = False
        self.last_packet_duration = 0
        self.softclip_mem = np.zeros(2, dtype=np.float32)
        self.range_final = 0

    @property
    def final_range(self) -> int:
        """Entropy-coder state checksum of the last decode; equal on a
        matching encoder (reference: decoder.rs:116-123)."""
        return self.range_final

    @property
    def gain(self) -> int:
        return self.decode_gain

    def pitch(self) -> int:
        if self.prev_mode == CodecMode.CELT_ONLY:
            return self.celt.pitch()
        return 0

    # -- decoding ------------------------------------------------------------

    def decode(self, packet: bytes | None, frame_size: int, decode_fec: bool = False, dtype=np.float32) -> np.ndarray:
        """Decode one packet (or conceal a loss when packet is None).

        Returns PCM shaped [samples, channels] in the requested sample
        format.  frame_size is the max duration to decode, in samples at
        the decoder rate (reference: decoder.rs:148-232).
        """
        if packet is not None and len(packet) == 0:
            packet = None
        pcm = self._decode_native(packet, frame_size, decode_fec, soft_clip=dtype not in (np.float32, np.float64))
        return convert_samples(pcm, dtype)

    def decode_float(self, packet: bytes | None, frame_size: int, decode_fec: bool = False) -> np.ndarray:
        if packet is not None and len(packet) == 0:
            packet = None
        return self._decode_native(packet, frame_size, decode_fec, soft_clip=False)

    def _decode_native(self, packet, frame_size, decode_fec, soft_clip, self_delimited=False):
        rate = int(self.sampling_rate)
        if frame_size <= 0:
            raise BadArguments("frame_size must be positive")
        # Duration must be a 2.5 ms multiple (reference: decoder.rs:316-319).
        if frame_size % (rate // 400) != 0:
            raise BadArguments("frame_size must be a multiple of 2.5 ms")

        if packet is None:
            out = np.zeros((frame_size, self.channels), dtype=np.float32)
            done = 0
            while done < frame_size:
                got = self._decode_frame(None, 0, out[done:], frame_size - done, False)
                done += got
            self.last_packet_duration = done
            if soft_clip:
                flat = out.reshape(-1).copy()
                pcm_soft_clip(flat, self.channels, self.softclip_mem)
                out = flat.reshape(out.shape)
            else:
                self.softclip_mem[:] = 0.0
            return out

        packet_mode = _packet_mode(packet)
        packet_bandwidth = _packet_bandwidth(packet)
        packet_frame_size = query_packet_samples_per_frame(packet, rate)
        packet_stream_channels = Channels.STEREO if packet[0] & 0x4 else Channels.MONO

        parsed = parse_packet(packet, self_delimited)
        frames = parsed.frames(packet)
        count = parsed.frame_count

        if decode_fec:
            # FEC: conceal the gap, then decode the LBRR data of frame 0
            # (reference: decoder.rs:343-386).
            if (
                frame_size < packet_frame_size
                or packet_mode == CodecMode.CELT_ONLY
                or self.mode == CodecMode.CELT_ONLY
            ):
                return self._decode_native(None, frame_size, False, soft_clip)
            duration_copy = self.last_packet_duration
            out = np.zeros((frame_size, self.channels), dtype=np.float32)
            if frame_size - packet_frame_size != 0:
                try:
                    self._decode_native_into(out[: frame_size - packet_frame_size])
                except Exception:
                    self.last_packet_duration = duration_copy
                    raise
            self.mode = packet_mode
            self.bandwidth = packet_bandwidth
            self.frame_size = packet_frame_size
            self.stream_channels = int(packet_stream_channels)
            self._decode_frame(frames[0], len(frames[0]), out[frame_size - packet_frame_size :], packet_frame_size, True)
            self.last_packet_duration = frame_size
            return self._finish(out, soft_clip)

        if count * packet_frame_size > frame_size:
            raise BufferTooSmall("packet contains more audio than frame_size")

        self.mode = packet_mode
        self.bandwidth = packet_bandwidth
        self.frame_size = packet_frame_size
        self.stream_channels = int(packet_stream_channels)

        out = np.zeros((count * packet_frame_size, self.channels), dtype=np.float32)
        done = 0
        for data in frames:
            got = self._decode_frame(data, len(data), out[done:], frame_size - done, False)
            assert got == packet_frame_size
            done += got
        self.last_packet_duration = done
        return self._finish(out, soft_clip)

    def _decode_native_into(self, out) -> None:
        got = 0
        n = out.shape[0]
        while got < n:
            got += self._decode_frame(None, 0, out[got:], n - got, False)

    def _finish(self, out, soft_clip):
        if soft_clip:
            flat = out.reshape(-1).copy()
            pcm_soft_clip(flat, self.channels, self.softclip_mem)
            out = flat.reshape(out.shape)
        else:
            self.softclip_mem[:] = 0.0
        return out

    # -- one frame (reference: decoder.rs:445-809) ---------------------------

    def _decode_frame(self, data, length, pcm_out, frame_size, decode_fec) -> int:
        rate = int(self.sampling_rate)
        f20 = rate // 50
        f10 = f20 >> 1
        f5 = f10 >> 1
        f2_5 = f5 >> 1
        if frame_size < f2_5:
            raise BufferTooSmall("frame_size smaller than 2.5 ms")
        # Payloads of 0 or 1 byte trigger PLC/DTX.
        if length <= 1:
            data = None
            frame_size = min(frame_size, self.frame_size)

        redundancy = False
        celt_to_silk = False
        redundant_rng = 0
        transition = False
        pcm_transition = None

        if data is not None:
            audiosize = self.frame_size
            mode = self.mode
            bandwidth = self.bandwidth
            dec = RangeDecoder(data)
        else:
            audiosize = frame_size
            mode = self.prev_mode
            bandwidth = None
            if mode is None:
                # No packet yet: silence.
                pcm_out[:audiosize] = 0.0
                return audiosize
            if audiosize > f20:
                done = 0
                while done < audiosize:
                    got = self._decode_frame(None, 0, pcm_out[done:], min(audiosize - done, f20), False)
                    done += got
                return frame_size
            if audiosize < f20:
                if audiosize > f10:
                    audiosize = f10
                elif mode != CodecMode.SILK_ONLY and f5 < audiosize < f10:
                    audiosize = f5
            dec = None

        if (
            data is not None
            and self.prev_mode is not None
            and (
                (mode == CodecMode.CELT_ONLY and self.prev_mode != CodecMode.CELT_ONLY and not self.prev_redundancy)
                or (mode != CodecMode.CELT_ONLY and self.prev_mode == CodecMode.CELT_ONLY)
            )
        ):
            transition = True
            if mode == CodecMode.CELT_ONLY:
                pcm_transition = np.zeros((f5, self.channels), dtype=np.float32)
                self._decode_frame(None, 0, pcm_transition, min(f5, audiosize), False)

        if audiosize > frame_size:
            raise BadArguments("audiosize exceeds buffer")
        frame_size = audiosize

        # --- SILK layer -----------------------------------------------------
        silk_pcm = None
        if mode != CodecMode.CELT_ONLY:
            if data is not None and self.prev_mode == CodecMode.CELT_ONLY:
                # CELT-only -> SILK/hybrid: SILK state is stale; reset.
                self.silk.reset()
            silk_pcm = self.silk.decode(
                dec if data is not None else None,
                mode, bandwidth, frame_size, self.stream_channels, decode_fec,
            )

        # --- redundancy flags (reference: decoder.rs:626-656) ---------------
        length_eff = length
        redundancy_bytes = 0
        if (
            not decode_fec
            and mode != CodecMode.CELT_ONLY
            and data is not None
            and dec.tell() + 17 + 20 * (1 if self.mode == CodecMode.HYBRID else 0) <= 8 * length
        ):
            if mode == CodecMode.HYBRID:
                redundancy = bool(dec.decode_bit_logp(12))
            else:
                redundancy = True
            if redundancy:
                celt_to_silk = bool(dec.decode_bit_logp(1))
                redundancy_bytes = (
                    dec.decode_uint(256) + 2
                    if mode == CodecMode.HYBRID
                    else length - ((dec.tell() + 7) >> 3)
                )
                length_eff = length - redundancy_bytes
                if length_eff * 8 < dec.tell():
                    # Corrupt packet; not normative (decoder.rs:648-655).
                    length_eff = 0
                    redundancy_bytes = 0
                    redundancy = celt_to_silk = False
                dec.shrink_storage(dec.storage - redundancy_bytes)

        start_band = 0 if mode == CodecMode.CELT_ONLY else 17

        if redundancy:
            transition = False

        if transition and mode != CodecMode.CELT_ONLY:
            pcm_transition = np.zeros((f5, self.channels), dtype=np.float32)
            self._decode_frame(None, 0, pcm_transition, min(f5, audiosize), False)

        if bandwidth is not None:
            self.celt.end_band = CELT_END_BAND[bandwidth]
        self.celt.stream_channels = self.stream_channels

        redundant_audio = None
        # 5 ms redundant CELT frame, CELT->SILK direction.
        if redundancy and celt_to_silk:
            self.celt.start_band = 0
            redundant_audio = self.celt.decode(data[length_eff : length_eff + redundancy_bytes], f5)
            redundant_rng = self.celt.final_range

        self.celt.start_band = start_band

        celt_ret = frame_size
        if mode != CodecMode.SILK_ONLY:
            celt_frame_size = min(f20, frame_size)
            if mode != self.prev_mode and self.prev_mode is not None and not self.prev_redundancy:
                self.celt.reset()
            decoded = self.celt.decode(
                None if decode_fec else data,
                celt_frame_size,
                dec=dec if data is not None and not decode_fec else None,
            )
            pcm_out[: decoded.shape[0]] = decoded
            if decoded.shape[0] < frame_size:
                pcm_out[decoded.shape[0] : frame_size] = 0.0
        else:
            pcm_out[:frame_size] = 0.0
            # Hybrid -> SILK: fade out the CELT MDCT with a silence frame.
            if self.prev_mode == CodecMode.HYBRID and not (redundancy and celt_to_silk and self.prev_redundancy):
                self.celt.start_band = 0
                sil = self.celt.decode(b"\xff\xff", f2_5)
                pcm_out[: sil.shape[0]] = sil

        if mode != CodecMode.CELT_ONLY and silk_pcm is not None:
            pcm_out[:frame_size] += silk_pcm[:frame_size]

        window = celt_modes.WINDOW
        inc = 48000 // rate

        # 5 ms redundant CELT frame, SILK->CELT direction.
        if redundancy and not celt_to_silk:
            self.celt.reset()
            self.celt.start_band = 0
            redundant_audio = self.celt.decode(data[length_eff : length_eff + redundancy_bytes], f5)
            redundant_rng = self.celt.final_range
            _smooth_fade(
                pcm_out[frame_size - f2_5 :], redundant_audio[f2_5:],
                pcm_out[frame_size - f2_5 :], f2_5, self.channels, inc,
            )
        if redundancy and celt_to_silk:
            pcm_out[:f2_5] = redundant_audio[:f2_5]
            _smooth_fade(
                redundant_audio[f2_5:], pcm_out[f2_5:].copy(),
                pcm_out[f2_5:], f2_5, self.channels, inc,
            )
        if transition and pcm_transition is not None:
            if audiosize >= f5:
                pcm_out[:f2_5] = pcm_transition[:f2_5]
                _smooth_fade(
                    pcm_transition[f2_5:], pcm_out[f2_5 : f5].copy(),
                    pcm_out[f2_5:], f2_5, self.channels, inc,
                )
            else:
                _smooth_fade(pcm_transition, pcm_out[:f2_5].copy(), pcm_out, f2_5, self.channels, inc)

        if self.decode_gain:
            g = celt_exp2(np.float32(6.48814081e-4) * self.decode_gain)
            pcm_out[:frame_size] *= np.float32(g)

        if length <= 1:
            self.range_final = 0
        else:
            self.range_final = (dec.rng ^ redundant_rng) & 0xFFFFFFFF

        self.prev_mode = mode
        self.prev_redundancy = redundancy and not celt_to_silk
        return audiosize


def _packet_mode(packet: bytes) -> CodecMode:
    toc = packet[0]
    if toc & 0x80:
        return CodecMode.CELT_ONLY
    if (toc & 0x60) == 0x60:
        return CodecMode.HYBRID
    return CodecMode.SILK_ONLY


def _packet_bandwidth(packet: bytes) -> Bandwidth:
    from .packet import query_packet_bandwidth

    return query_packet_bandwidth(packet)
