"""Record the benchmark's packet pools from the system libopus.

    python3 opusbench/traffic/record.py [pool ...]   # every pool without names

Runs where libopus is installed (it is looked up with ctypes), never in a
benchmark run: the pools it writes are committed, and a run only reads
them.  Each pool is `opusbench/traffic/<pool>.npz` with

* `data` (uint8): every packet's bytes, back to back, whole Opus packets
  with their ToC byte;
* `lens` (int32 [sequences, frames]): each packet's length;
* `ranges` (uint32 [sequences, frames]): libopus's final range after
  decoding each packet (equal to its encoder's, which is checked);
* `pcm_sequences` (int32 [k]) and `pcm` (float32 [k, frames * 960, C]):
  libopus's decoded PCM, 48 kHz, of the first k sequences, decoded to the
  pool's own channel count C (a mono stream to mono, as a WebRTC receiver
  with the default `stereo=0` decodes it);
* `kind` (str): the codec settings the pool was encoded with;
* `layout` (str, multistream pools only): the channel layout as JSON,
  `{"family", "channels", "streams", "coupled", "mapping"}`, as a
  configuration's `layout` names it.

Every sequence is `FRAMES` 20 ms frames of its own seeded signal, encoded
by a fresh libopus encoder.  A single-stream pool (`POOLS`) has its mode,
bandwidth, bit rate and application forced.  A multistream pool
(`SURROUND_POOLS`) is encoded by libopus's surround encoder
(`opus_multistream_surround_encoder_create`) with its bit rate and
application set and nothing else: libopus chooses the streams, the
coupling, the mapping, each stream's mode and bandwidth (it codes the LFE
stream as CELT narrowband), its VBR (on) and complexity (10).  While
recording, the encoder's layout must equal the pool's, every elementary
packet must be code 0 with one 20 ms frame, and the encoder's final range
(the XOR over its streams) must equal libopus's multistream decoder's.

The signals are synthetic: music (harmonic notes with attacks, vibrato,
noise and percussive clicks, so that transient frames and post-filter
lags vary), voice (a glottal pulse train with moving pitch and formants,
fricatives and pauses), or a film mix in channel mapping family 1 order
(`film`: music on the front pair, voice dialogue on the centre,
decorrelated ambience on the four surrounds, content under 120 Hz on the
LFE).  This module imports ctypes, json and numpy only.

`surround71_fb_416k`, a 7.1 session (RFC 7845 sec. 5.1.1.2, 8 channels)
at 416 kbit/s: opus-tools' `opusenc` gives 64 kbit/s a stream and 32 more
a coupled stream at 48 kHz, 3 x 96 + 2 x 64 kbit/s for this layout (that
rule is recalled, not read from opus-tools' source; libopus's own
`OPUS_AUTO` picks 504 kbit/s).  From libopus 1.3.1 it holds streams 0-2
(FL+FR, SL+SR, BL+BR) as CELT fullband stereo (ToC config 31) in every
frame, stream 3 (centre) as CELT fullband mono in every frame, and stream
4 (LFE) as CELT narrowband mono (config 19) in every frame (`kind` counts
them).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
RATE, FRAME, FRAMES, SEQUENCES, PCM_SEQUENCES = 48000, 960, 50, 64, 2

# opus_defines.h / opus_private.h request codes and values
SET_BITRATE, SET_BANDWIDTH, SET_VBR, GET_FINAL_RANGE = 4002, 4008, 4006, 4031
SET_FORCE_MODE = 11002
APPLICATION = {"voip": 2048, "audio": 2049}
MODE = {"silk": 1000, "hybrid": 1001, "celt": 1002}
BANDWIDTH = {"wb": 1103, "swb": 1104, "fb": 1105}
#: ToC config ranges by mode (RFC 6716 sec. 3.1)
TOC_CONFIGS = {"silk": range(0, 12), "hybrid": range(12, 16), "celt": range(16, 32)}

#: pool name -> (signal, channels, mode, bandwidth, bit rate, application)
#: (the voice pools: RFC 7587 sec. 3.1.1's speech rows, wideband 16-20 and
#: fullband 28-40 kbit/s, mono as its sec. 6.1 default `stereo=0` asks)
POOLS = {
    "celt_music_fb_stereo_96k": ("music", 2, "celt", "fb", 96000, "audio"),
    "voice_silk_wb_mono_20k": ("voice", 1, "silk", "wb", 20000, "voip"),
    "voice_hybrid_fb_mono_32k": ("voice", 1, "hybrid", "fb", 32000, "voip"),
    "voice_celt_fb_mono_32k": ("voice", 1, "celt", "fb", 32000, "voip"),
}

#: multistream pool name -> (bit rate, application, the layout the surround
#: encoder has to choose for the family and channel count); signal `film`
SURROUND_POOLS = {
    "surround71_fb_416k": (416000, "audio",
                           {"family": 1, "channels": 8, "streams": 5, "coupled": 3,
                            "mapping": [0, 6, 1, 2, 3, 4, 5, 7]}),
}


class Libopus:
    """The few libopus calls the recorder needs."""

    def __init__(self):
        name = ctypes.util.find_library("opus")
        if name is None:
            raise FileNotFoundError("libopus not found; the pools are recorded where it is")
        lib = self.lib = ctypes.CDLL(name)
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [ctypes.c_int32, ctypes.c_int,
                                            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [ctypes.c_int32, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.opus_encode_float.restype = ctypes.c_int32
        lib.opus_encode_float.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int, ctypes.c_char_p, ctypes.c_int32]
        lib.opus_decode_float.restype = ctypes.c_int
        lib.opus_decode_float.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                          ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                          ctypes.c_int]
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_get_version_string.restype = ctypes.c_char_p
        intp, bytep = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ubyte)
        lib.opus_multistream_surround_encoder_create.restype = ctypes.c_void_p
        lib.opus_multistream_surround_encoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int, ctypes.c_int, intp, intp, bytep, ctypes.c_int, intp]
        lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
        lib.opus_multistream_decoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int, bytep, intp]
        lib.opus_multistream_encode_float.restype = ctypes.c_int
        lib.opus_multistream_encode_float.argtypes = lib.opus_encode_float.argtypes
        lib.opus_multistream_decode_float.restype = ctypes.c_int
        lib.opus_multistream_decode_float.argtypes = lib.opus_decode_float.argtypes
        lib.opus_multistream_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_multistream_decoder_destroy.argtypes = [ctypes.c_void_p]

    def version(self) -> str:
        return self.lib.opus_get_version_string().decode()

    def encoder(self, channels: int, application: str):
        err = ctypes.c_int()
        enc = self.lib.opus_encoder_create(RATE, channels, APPLICATION[application],
                                           ctypes.byref(err))
        if err.value != 0 or not enc:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        return enc

    def ctl(self, enc, request: int, value: int, fn=None) -> None:
        rc = (fn or self.lib.opus_encoder_ctl)(ctypes.c_void_p(enc), ctypes.c_int(request),
                                               ctypes.c_int(value))
        if rc != 0:
            raise RuntimeError(f"opus_encoder_ctl({request}, {value}) failed: {rc}")

    def final_range(self, handle, ctl) -> int:
        out = ctypes.c_uint32()
        rc = ctl(ctypes.c_void_p(handle), ctypes.c_int(GET_FINAL_RANGE), ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"GET_FINAL_RANGE failed: {rc}")
        return out.value

    def encode(self, enc, pcm: np.ndarray, fn=None, room: int = 4000) -> bytes:
        pcm = np.ascontiguousarray(pcm, np.float32)
        buf = ctypes.create_string_buffer(room)
        n = (fn or self.lib.opus_encode_float)(
            ctypes.c_void_p(enc), pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            FRAME, buf, room)
        if n < 0:
            raise RuntimeError(f"opus_encode_float failed: {n}")
        return buf.raw[:n]

    def decoder(self, channels: int):
        err = ctypes.c_int()
        dec = self.lib.opus_decoder_create(RATE, channels, ctypes.byref(err))
        if err.value != 0 or not dec:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        return dec

    def decode(self, dec, packet: bytes, channels: int, fn=None) -> np.ndarray:
        out = np.zeros((FRAME, channels), np.float32)
        n = (fn or self.lib.opus_decode_float)(
            ctypes.c_void_p(dec), packet, len(packet),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), FRAME, 0)
        if n != FRAME:
            raise RuntimeError(f"opus_decode_float returned {n}")
        return out

    def surround_encoder(self, family: int, channels: int, application: str):
        """(encoder, its layout) from libopus's surround encoder."""
        err, streams, coupled = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        mapping = (ctypes.c_ubyte * 255)()
        enc = self.lib.opus_multistream_surround_encoder_create(
            RATE, channels, family, ctypes.byref(streams), ctypes.byref(coupled), mapping,
            APPLICATION[application], ctypes.byref(err))
        if err.value != 0 or not enc:
            raise RuntimeError(f"opus_multistream_surround_encoder_create failed: {err.value}")
        return enc, {"family": family, "channels": channels, "streams": streams.value,
                     "coupled": coupled.value, "mapping": list(mapping[:channels])}

    def multistream_decoder(self, layout: dict):
        err = ctypes.c_int()
        mapping = (ctypes.c_ubyte * layout["channels"])(*layout["mapping"])
        dec = self.lib.opus_multistream_decoder_create(
            RATE, layout["channels"], layout["streams"], layout["coupled"], mapping,
            ctypes.byref(err))
        if err.value != 0 or not dec:
            raise RuntimeError(f"opus_multistream_decoder_create failed: {err.value}")
        return dec


def _envelope(n: int, attack: int, rng) -> np.ndarray:
    a = np.minimum(np.arange(n) / max(attack, 1), 1.0)
    return a * np.exp(-np.arange(n) / (RATE * rng.uniform(0.15, 0.8)))


def music(rng, n: int) -> np.ndarray:
    """Stereo music-like signal: notes of harmonic tones with attacks and
    vibrato over a noise floor, and percussive clicks."""
    out = np.zeros((n, 2))
    t = np.arange(n) / RATE
    for _ in range(rng.integers(2, 5)):  # voices
        at = 0
        while at < n:
            dur = int(RATE * rng.uniform(0.08, 0.35))
            seg = slice(at, min(at + dur, n))
            m = seg.stop - seg.start
            f0 = 55.0 * 2 ** (rng.integers(0, 48) / 12)
            vib = 1 + 0.004 * np.sin(2 * np.pi * rng.uniform(4, 7) * t[:m])
            ph = np.cumsum(2 * np.pi * f0 * vib / RATE)
            tone = sum(rng.uniform(0.2, 1.0) / h * np.sin(h * ph + rng.uniform(0, 6.3))
                       for h in range(1, int(rng.integers(2, 9))))
            env = _envelope(m, int(rng.integers(20, 2000)), rng) * rng.uniform(0.05, 0.25)
            pan = rng.uniform(0.2, 0.8)
            out[seg, 0] += tone * env * pan
            out[seg, 1] += np.roll(tone * env, int(rng.integers(0, 30))) * (1 - pan)
            at += dur
    for at in rng.integers(0, n - 2000, rng.integers(2, 8)):  # clicks
        m = int(rng.integers(200, 2000))
        click = rng.standard_normal(m) * np.exp(-np.arange(m) / (m / 6)) * rng.uniform(0.1, 0.5)
        out[at : at + m] += click[:, None] * np.array([1.0, rng.uniform(0.5, 1.0)])
    noise = np.cumsum(rng.standard_normal((n, 2)), axis=0)
    noise -= np.convolve(noise[:, 0], np.ones(64) / 64, "same")[:, None]
    out += 0.002 * noise / (np.abs(noise).max() + 1e-9) + 0.003 * rng.standard_normal((n, 2))
    return np.clip(out, -0.95, 0.95)


def _resonate(x: np.ndarray, freqs: np.ndarray, bw: float) -> np.ndarray:
    """x through a cascade of two-pole resonators at `freqs` (one a sample
    block of 480)."""
    y = x.copy()
    for k in range(freqs.shape[1]):
        out = np.zeros_like(y)
        s1 = s2 = 0.0
        for b in range(0, len(y), 480):
            r = np.exp(-np.pi * bw / RATE)
            c = 2 * r * np.cos(2 * np.pi * freqs[b // 480, k] / RATE)
            for i in range(b, min(b + 480, len(y))):
                s = y[i] + c * s1 - r * r * s2
                out[i] = s
                s2, s1 = s1, s
        y = out / (np.abs(out).max() + 1e-9)
    return y


def voice(rng, n: int, channels: int) -> np.ndarray:
    """Speech-like signal: voiced segments (a glottal pulse train with a
    moving pitch, through moving formants), fricatives and pauses."""
    x = np.zeros(n)
    at = 0
    while at < n:
        kind = rng.choice(["voiced", "voiced", "fricative", "pause"])
        m = min(int(RATE * rng.uniform(0.06, 0.3)), n - at)
        if kind == "voiced":
            f0 = rng.uniform(85, 255) * (1 + 0.15 * np.sin(np.linspace(0, rng.uniform(1, 4), m)))
            ph = np.cumsum(f0 / RATE)
            pulses = np.diff(np.floor(ph), prepend=0.0)
            x[at : at + m] = pulses * rng.uniform(0.5, 1.0) + 0.01 * rng.standard_normal(m)
        elif kind == "fricative":
            x[at : at + m] = np.diff(rng.standard_normal(m + 1)) * rng.uniform(0.02, 0.08)
        else:
            x[at : at + m] = 0.001 * rng.standard_normal(m)
        at += m
    blocks = -(-n // 480)
    formants = np.stack([np.interp(np.arange(blocks), np.sort(rng.integers(0, blocks, 6)),
                                   rng.uniform(lo, hi, 6)) for lo, hi in
                         ((300, 900), (900, 2400), (2400, 3400))], 1)
    y = _resonate(x, formants, 120.0) * 0.3
    if channels == 1:
        return y[:, None]
    return np.stack([y, 0.7 * np.roll(y, 13) + 0.002 * rng.standard_normal(n)], -1)


def _below(x: np.ndarray, hz: float) -> np.ndarray:
    """x [n, k] with every component at or above `hz` removed (FFT)."""
    spec = np.fft.rfft(x, axis=0)
    spec[np.fft.rfftfreq(len(x), 1 / RATE) >= hz] = 0
    return np.fft.irfft(spec, len(x), axis=0)


def film(rng, n: int) -> np.ndarray:
    """An 8-channel film or music mix in channel mapping family 1 order
    (FL, C, FR, SL, SR, BL, BR, LFE): `music` on the front pair, `voice`
    dialogue on the centre; on each surround its own delayed, darkened
    copy of the front music (10-45 ms, a quarter to a half of its level)
    over a noise bed of its own, so the four are decorrelated; on the LFE
    a few 30-110 Hz rumbles and hits with the front's low end, all under
    120 Hz, at a peak of 0.3-0.6."""
    out = np.zeros((n, 8))
    front = music(rng, n)
    out[:, 0], out[:, 2] = front[:, 0], front[:, 1]
    out[:, 1] = 2.5 * voice(rng, n, 1)[:, 0]
    for ch in range(3, 7):
        src = front[:, ch % 2]
        late = np.roll(src, int(RATE * rng.uniform(0.010, 0.045))) * rng.uniform(0.25, 0.5)
        bed = np.cumsum(rng.standard_normal(n))
        bed -= np.convolve(bed, np.ones(256) / 256, "same")
        out[:, ch] = (_below(late[:, None], rng.uniform(4000, 9000))[:, 0]
                      + 0.01 * bed / (np.abs(bed).max() + 1e-9))
    t = np.arange(n) / RATE
    lfe = 0.3 * (front[:, 0] + front[:, 1])
    for at in rng.integers(0, n - RATE // 10, rng.integers(3, 9)):
        m = min(int(rng.integers(RATE // 20, RATE // 2)), n - at)
        f0, decay = rng.uniform(30, 110), rng.uniform(0.05, 0.4)
        hit = np.sin(2 * np.pi * f0 * t[:m]) * np.exp(-t[:m] / decay)
        lfe[at : at + m] += hit * rng.uniform(0.2, 0.6)
    low = _below(lfe[:, None], 120.0)[:, 0]
    out[:, 7] = low * (rng.uniform(0.3, 0.6) / (np.abs(low).max() + 1e-9))
    return np.clip(out, -0.95, 0.95)


def frame_ms(config: int) -> float:
    """A ToC configuration's frame duration (RFC 6716 sec. 3.1)."""
    if config < 12:
        return (10, 20, 40, 60)[config & 3]
    if config < 16:
        return (10, 20)[config & 1]
    return (2.5, 5, 10, 20)[config & 3]


def elementary_tocs(packet: bytes, streams: int) -> list:
    """The ToC byte of each elementary packet of a multistream packet (the
    first `streams - 1` self-delimited, RFC 6716 appendix B), each checked
    to be code 0, one 20 ms frame, and to end where the next begins."""
    tocs, at = [], 0
    for s in range(streams):
        if at >= len(packet):
            raise ValueError(f"stream {s}: the packet ends at byte {at}")
        toc = packet[at]
        if toc & 3 or frame_ms(toc >> 3) != 20:
            raise ValueError(f"stream {s}: ToC {toc:#x} is not one 20 ms frame (code 0)")
        if s == streams - 1:
            at = len(packet)
        else:
            size, head = packet[at + 1], 2
            if size >= 252:
                size, head = size + 4 * packet[at + 2], 3
            at += head + size
        tocs.append(toc)
    if at != len(packet):
        raise ValueError(f"the elementary packets end at byte {at} of {len(packet)}")
    return tocs


def record_surround(opus: Libopus, name: str, seed: int) -> dict:
    bitrate, application, layout = SURROUND_POOLS[name]
    channels, streams = layout["channels"], layout["streams"]
    rng = np.random.default_rng(seed)
    data, lens, ranges, pcm = [], np.zeros((SEQUENCES, FRAMES), np.int32), \
        np.zeros((SEQUENCES, FRAMES), np.uint32), []
    configs = [dict() for _ in range(streams)]
    lib = opus.lib
    for s in range(SEQUENCES):
        n = FRAME * FRAMES
        sig = film(rng, n)
        enc, got = opus.surround_encoder(layout["family"], channels, application)
        dec = None
        try:
            if got != layout:
                raise RuntimeError(f"{name}: libopus chose the layout {got}, not {layout}")
            dec = opus.multistream_decoder(layout)
            opus.ctl(enc, SET_BITRATE, bitrate, lib.opus_multistream_encoder_ctl)
            out = []
            for f in range(FRAMES):
                pkt = opus.encode(enc, sig[f * FRAME : (f + 1) * FRAME].ravel(),
                                  lib.opus_multistream_encode_float, room=1277 * streams)
                for k, toc in enumerate(elementary_tocs(pkt, streams)):
                    configs[k][toc >> 3] = configs[k].get(toc >> 3, 0) + 1
                enc_range = opus.final_range(enc, lib.opus_multistream_encoder_ctl)
                out.append(opus.decode(dec, pkt, channels, lib.opus_multistream_decode_float))
                dec_range = opus.final_range(dec, lib.opus_multistream_decoder_ctl)
                if enc_range != dec_range:
                    raise RuntimeError(f"{name} sequence {s} frame {f}: ranges differ")
                data.append(pkt)
                lens[s, f], ranges[s, f] = len(pkt), dec_range
            if s < PCM_SEQUENCES:
                pcm.append(np.concatenate(out))
        finally:
            lib.opus_multistream_encoder_destroy(ctypes.c_void_p(enc))
            if dec is not None:
                lib.opus_multistream_decoder_destroy(ctypes.c_void_p(dec))
    seen = "; ".join(f"stream {k}: " + ", ".join(f"{c} x{m}" for c, m in sorted(cs.items()))
                     for k, cs in enumerate(configs))
    return dict(data=np.frombuffer(b"".join(data), np.uint8), lens=lens, ranges=ranges,
                pcm_sequences=np.arange(PCM_SEQUENCES, dtype=np.int32),
                pcm=np.stack(pcm).astype(np.float32), layout=np.array(json.dumps(layout)),
                kind=np.array(f"surround family {layout['family']}, {channels} channels, "
                              f"{streams} streams ({layout['coupled']} coupled), mapping "
                              f"{' '.join(map(str, layout['mapping']))}; {bitrate} b/s "
                              f"{application}, libopus's default VBR and complexity; ToC "
                              f"configs {seen}; {opus.version()}"))


def record(opus: Libopus, name: str, seed: int) -> dict:
    signal, channels, mode, bandwidth, bitrate, application = POOLS[name]
    rng = np.random.default_rng(seed)
    data, lens, ranges, pcm = [], np.zeros((SEQUENCES, FRAMES), np.int32), \
        np.zeros((SEQUENCES, FRAMES), np.uint32), []
    for s in range(SEQUENCES):
        n = FRAME * FRAMES
        sig = music(rng, n) if signal == "music" else voice(rng, n, channels)
        enc = opus.encoder(channels, application)
        dec = opus.decoder(channels)
        try:
            opus.ctl(enc, SET_FORCE_MODE, MODE[mode])
            opus.ctl(enc, SET_BANDWIDTH, BANDWIDTH[bandwidth])
            opus.ctl(enc, SET_BITRATE, bitrate)
            opus.ctl(enc, SET_VBR, 1)
            out = []
            for f in range(FRAMES):
                pkt = opus.encode(enc, sig[f * FRAME : (f + 1) * FRAME].ravel())
                config, stereo = pkt[0] >> 3, (pkt[0] >> 2) & 1
                if config not in TOC_CONFIGS[mode] or (pkt[0] & 3) or stereo != (channels == 2):
                    raise RuntimeError(f"{name} sequence {s} frame {f}: ToC {pkt[0]:#x}")
                enc_range = opus.final_range(enc, opus.lib.opus_encoder_ctl)
                out.append(opus.decode(dec, pkt, channels))
                dec_range = opus.final_range(dec, opus.lib.opus_decoder_ctl)
                if enc_range != dec_range:
                    raise RuntimeError(f"{name} sequence {s} frame {f}: ranges differ")
                data.append(pkt)
                lens[s, f], ranges[s, f] = len(pkt), dec_range
            if s < PCM_SEQUENCES:
                pcm.append(np.concatenate(out))
        finally:
            opus.lib.opus_encoder_destroy(ctypes.c_void_p(enc))
            opus.lib.opus_decoder_destroy(ctypes.c_void_p(dec))
    return dict(data=np.frombuffer(b"".join(data), np.uint8), lens=lens, ranges=ranges,
                pcm_sequences=np.arange(PCM_SEQUENCES, dtype=np.int32),
                pcm=np.stack(pcm).astype(np.float32),
                kind=np.array(f"{mode} {bandwidth} {'stereo' if channels == 2 else 'mono'} "
                              f"{bitrate} b/s {application}, libopus {opus.version()}"))


def main(names: list) -> None:
    opus = Libopus()
    seeds = {name: seed for seed, name in enumerate([*POOLS, *SURROUND_POOLS], start=2026)}
    for name in names or seeds:
        pool = (record_surround if name in SURROUND_POOLS else record)(opus, name, seeds[name])
        np.savez_compressed(HERE / f"{name}.npz", **pool)
        print(f"{name}: {pool['lens'].size} packets, mean {pool['lens'].mean():.1f} B, "
              f"{pool['data'].size} B; {pool['kind']}")


if __name__ == "__main__":
    main(sys.argv[1:])
