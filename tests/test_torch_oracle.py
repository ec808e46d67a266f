"""The port's libopus oracle (opus_tpu_torch/oracle.py) against the
reference's (opus_tpu/oracle.py) on the same PCM.

The port's copy binds the same system libopus through the same ctypes
code; these tests drive both bindings side by side, each with its own
encoder and decoder, and hold every output equal: packets byte for byte,
final ranges after every packet, decoded PCM (float and int16) sample for
sample, in CELT, SILK and hybrid sessions with a loss and an FEC
recovery, and in one multistream session.  They skip where no libopus is
found.
"""

from __future__ import annotations

import numpy as np
import pytest

from opus_tpu import oracle as ref
from opus_tpu_torch import oracle as port

pytestmark = pytest.mark.skipif(not port.available(), reason="libopus not present")

F = 960


def _signal(channels: int, frames: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(F * frames) / 48000.0
    ph = np.cumsum(2 * np.pi * (140 + 30 * np.sin(2 * np.pi * 3 * t)) / 48000.0)
    sig = 0.3 * np.sign(np.sin(ph)) + 0.2 * np.sin(2 * np.pi * 1870 * t)
    sig = sig + 0.02 * rng.standard_normal(t.size)
    return np.stack([np.roll(sig, 11 * c) * (1 - 0.2 * c) for c in range(channels)],
                    -1).astype(np.float32)


def _session(lib, mode: int, channels: int, kbps: int, pcm: np.ndarray, frames: int):
    """(packets, encoder ranges, float PCM, int16 PCM, decoder ranges) of
    one session through `lib`: frame 3 lost, frame 4 recovered by FEC."""
    enc = lib.Encoder(48000, channels, lib.APPLICATION_VOIP)
    enc.ctl(lib.SET_FORCE_MODE, mode)
    enc.ctl(lib.SET_BITRATE, kbps * 1000)
    enc.ctl(lib.SET_INBAND_FEC, 1)
    enc.ctl(lib.SET_PACKET_LOSS_PERC, 20)
    assert enc.ctl(lib.GET_BANDWIDTH) > 0
    packets, enc_ranges = [], []
    for f in range(frames):
        packets.append(enc.encode_float(pcm[f * F : (f + 1) * F].ravel(), F))
        enc_ranges.append(enc.final_range)
    dec, dec16 = lib.Decoder(48000, channels), lib.Decoder(48000, channels)
    out, out16, dec_ranges = [], [], []
    for f, p in enumerate(packets):
        if f == 3:
            out.append(dec.decode_float(None, F))
            out16.append(dec16.decode_int16(None, F))
        elif f == 4:
            out.append(dec.decode_float(p, F, fec=True))
            out16.append(dec16.decode_int16(p, F, fec=True))
        out.append(dec.decode_float(p, F))
        out16.append(dec16.decode_int16(p, F))
        dec_ranges.append(dec.final_range)
    return packets, enc_ranges, np.concatenate(out), np.concatenate(out16), dec_ranges


@pytest.mark.parametrize("mode, channels, kbps", [
    ("MODE_CELT_ONLY", 2, 96), ("MODE_CELT_ONLY", 1, 48), ("MODE_SILK_ONLY", 1, 24),
    ("MODE_SILK_ONLY", 2, 32), ("MODE_HYBRID", 2, 48)])
def test_session_equals_reference(mode, channels, kbps):
    frames = 8
    pcm = _signal(channels, frames, seed=channels + kbps)
    want = _session(ref, getattr(ref, mode), channels, kbps, pcm, frames)
    got = _session(port, getattr(port, mode), channels, kbps, pcm, frames)
    assert got[0] == want[0]  # packets, byte for byte
    assert got[1] == want[1] and got[4] == want[4]  # encoder and decoder final ranges
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])
    assert any(len(p) > 1 for p in got[0])


def test_multistream_session_equals_reference():
    """5.1 (6 channels, 4 streams, 2 coupled, the Vorbis mapping)."""
    channels, streams, coupled, mapping = 6, 4, 2, [0, 4, 1, 2, 3, 5]
    frames = 6
    pcm = _signal(channels, frames, seed=3)

    def run(lib):
        enc = lib.MultistreamEncoder(48000, channels, streams, coupled, mapping)
        enc.ctl(lib.SET_BITRATE, 256000)
        dec = lib.MultistreamDecoder(48000, channels, streams, coupled, mapping)
        packets, ranges, out = [], [], []
        for f in range(frames):
            packets.append(enc.encode_float(pcm[f * F : (f + 1) * F], F))
            out.append(dec.decode_float(packets[-1], F))
            ranges.append((enc.final_range, dec.final_range))
        return packets, ranges, np.concatenate(out)

    got, want = run(port), run(ref)
    assert got[0] == want[0] and got[1] == want[1]
    assert np.array_equal(got[2], want[2]) and got[2].shape == (frames * F, channels)


def test_constants_and_version_equal_reference():
    names = [n for n in dir(ref) if n.isupper()]
    assert names == [n for n in dir(port) if n.isupper()]
    assert all(getattr(ref, n) == getattr(port, n) for n in names)
    assert port.version() == ref.version()
