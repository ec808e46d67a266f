"""Record the benchmark's packet pools from the system libopus.

    python3 opusbench/traffic/record.py

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
* `kind` (str): the codec settings the pool was encoded with.

Every sequence is `FRAMES` 20 ms frames of its own seeded signal, encoded
by a fresh libopus encoder with the pool's mode, bandwidth, bit rate and
application forced.  The signals are synthetic: music (harmonic notes with
attacks, vibrato, noise and percussive clicks, so that transient frames
and post-filter lags vary) or voice (a glottal pulse train with moving
pitch and formants, fricatives and pauses).  This module imports ctypes
and numpy only.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import pathlib

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

    def version(self) -> str:
        return self.lib.opus_get_version_string().decode()

    def encoder(self, channels: int, application: str):
        err = ctypes.c_int()
        enc = self.lib.opus_encoder_create(RATE, channels, APPLICATION[application],
                                           ctypes.byref(err))
        if err.value != 0 or not enc:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        return enc

    def ctl(self, enc, request: int, value: int) -> None:
        rc = self.lib.opus_encoder_ctl(ctypes.c_void_p(enc), ctypes.c_int(request),
                                       ctypes.c_int(value))
        if rc != 0:
            raise RuntimeError(f"opus_encoder_ctl({request}, {value}) failed: {rc}")

    def final_range(self, handle, ctl) -> int:
        out = ctypes.c_uint32()
        rc = ctl(ctypes.c_void_p(handle), ctypes.c_int(GET_FINAL_RANGE), ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"GET_FINAL_RANGE failed: {rc}")
        return out.value

    def encode(self, enc, pcm: np.ndarray) -> bytes:
        pcm = np.ascontiguousarray(pcm, np.float32)
        buf = ctypes.create_string_buffer(4000)
        n = self.lib.opus_encode_float(ctypes.c_void_p(enc),
                                       pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       FRAME, buf, 4000)
        if n < 0:
            raise RuntimeError(f"opus_encode_float failed: {n}")
        return buf.raw[:n]

    def decoder(self, channels: int):
        err = ctypes.c_int()
        dec = self.lib.opus_decoder_create(RATE, channels, ctypes.byref(err))
        if err.value != 0 or not dec:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        return dec

    def decode(self, dec, packet: bytes, channels: int) -> np.ndarray:
        out = np.zeros((FRAME, channels), np.float32)
        n = self.lib.opus_decode_float(ctypes.c_void_p(dec), packet, len(packet),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       FRAME, 0)
        if n != FRAME:
            raise RuntimeError(f"opus_decode_float returned {n}")
        return out


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


def main() -> None:
    opus = Libopus()
    for seed, name in enumerate(POOLS, start=2026):
        pool = record(opus, name, seed)
        np.savez_compressed(HERE / f"{name}.npz", **pool)
        print(f"{name}: {pool['lens'].size} packets, mean {pool['lens'].mean():.1f} B, "
              f"{pool['data'].size} B; {pool['kind']}")


if __name__ == "__main__":
    main()
