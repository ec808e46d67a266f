"""The sanitizer lane of the port's native C++ engines (no jax, no opus_tpu).

The reference's tests/test_native_sanitize.py, on the port's own copy of
the C++ plane A (opus_tpu_torch/native/, about 10,300 lines): every native
entry point (the CELT, SILK and Opus decoders, the batched plane
extraction into every slot kind, the plan builder, the CELT, SILK, voice,
stereo voice and hybrid encoders) driven with random and hostile input.
Everything reaches the engines through ctypes and numpy, with libopus
through the port's own oracle; `test_lane_imports_neither_jax_nor_the_reference`
checks that nothing here loads jax or opus_tpu.  In the instrumented lane
the engines are built with -fsanitize and loaded under libasan:

    lib=$(OPUS_TPU_SANITIZE=address,undefined python opus_tpu_torch/native/build.py)
    LD_PRELOAD=$(g++ -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0 \
      OPUS_TPU_NATIVE_LIB=$lib python -m pytest tests/test_torch_native_sanitize.py

The same tests also run, fast, in the normal lane as robustness coverage
of the native API surface.
"""


import pathlib
import subprocess
import sys

import numpy as np
import pytest

from opus_tpu_torch import oracle
from opus_tpu_torch.native.frontend import available

pytestmark = pytest.mark.skipif(not available(), reason="native engine not built")


def _rand_payloads(rng, n, lo=1, hi=320):
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        out.append(bytes(rng.integers(0, 256, ln, dtype=np.uint8)))
    return out


def _real_celt_payloads(channels=2, frame=960, kbps=96, nframes=6):
    if not oracle.available():
        pytest.skip("libopus not present")
    from opus_tpu_torch import parse_packet

    enc = oracle.Encoder(48000, channels)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    enc.ctl(oracle.SET_BITRATE, kbps * 1000)
    rng = np.random.default_rng(2)
    t = np.arange(frame * nframes) / 48000.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)
    pcm = np.stack([sig] * channels, -1).astype(np.float32)
    out = []
    for f in range(nframes):
        pkt = enc.encode_float(pcm[f * frame : (f + 1) * frame].ravel(), frame)
        out.append(pkt[parse_packet(pkt).payload_offset :])
    return out


def test_celt_frontend_random_bytes():
    """Random-byte payloads through the scalar CELT frontend: the range
    decoder must saturate (like libopus) or fail with rc != 0 — never
    read out of bounds (ASAN judges)."""
    from opus_tpu_torch.native.frontend import NativeCeltFrontEnd

    rng = np.random.default_rng(0)
    for channels in (1, 2):
        fe = NativeCeltFrontEnd(channels)
        for frame in (120, 240, 480, 960):
            for payload in _rand_payloads(rng, 30):
                try:
                    fe.decode_planes(payload, frame)
                except ValueError:
                    pass


def test_celt_frontend_bitflipped_real_packets():
    """Bit-flipped and truncated REAL payloads: the adversarial corpus
    most likely to drive deep band-decode states out of range."""
    from opus_tpu_torch.native.frontend import NativeCeltFrontEnd

    payloads = _real_celt_payloads()
    rng = np.random.default_rng(1)
    fe = NativeCeltFrontEnd(2)
    for p in payloads:
        for cut in range(0, len(p), 5):  # truncations
            try:
                fe.decode_planes(p[:cut], 960)
            except ValueError:
                pass
        for _ in range(40):  # bit flips
            b = bytearray(p)
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            try:
                fe.decode_planes(bytes(b), 960)
            except ValueError:
                pass


def test_batch_planes_random_bytes():
    """Every batched plane-extraction entry point (f64 / f32 / q14 /
    bit-packed) on random payloads with interleaved losses."""
    from opus_tpu_torch.native.frontend import NativeBatchFrontEnd

    rng = np.random.default_rng(3)
    B = 4
    fe = NativeBatchFrontEnd(B, 2)
    pslots = {m: fe.alloc_packed_slots(1, mode=m)[0] for m in ("q14", "p12", "p10", "p8")}
    for frame in (960, 480):
        for _ in range(12):
            pk = [None if rng.random() < 0.25 else p
                  for p in _rand_payloads(rng, B, hi=200)]
            for call in (
                lambda: fe.decode_batch(pk, frame),
                lambda: fe.decode_batch_f32(pk, frame),
                lambda: fe.decode_batch_q15(pk, frame),
                *[lambda s=s: fe.decode_batch_q15_into(pk, frame, s)
                  for s in pslots.values()],
            ):
                try:
                    call()
                except ValueError:
                    pass


def test_plan_builder_random_and_corrupt():
    """The plan builder (header pass + leaf emission + transactional
    overflow restore) against random bytes, tiny arenas, and corrupted
    real packets — the path with the most hand-written pointer math."""
    from opus_tpu_torch.native.frontend import NativeBatchFrontEnd

    rng = np.random.default_rng(4)
    B = 4
    fe = NativeBatchFrontEnd(B, 2)
    # Tiny arena: forces the overflow/restore path constantly.
    for arena_words in (8, 64, 512):
        slot = fe.alloc_plan_slots(1, arena_words_per_stream=arena_words)[0]
        for _ in range(10):
            pk = [None if rng.random() < 0.2 else p
                  for p in _rand_payloads(rng, B, hi=200)]
            try:
                fe.decode_batch_plan_into(pk, 960, slot)
            except (ValueError, OverflowError):
                pass
    reals = _real_celt_payloads(kbps=128)
    slot = fe.alloc_plan_slots(1)[0]
    for p in reals:
        for _ in range(20):
            b = bytearray(p)
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            pk = [bytes(b)] * B
            try:
                fe.decode_batch_plan_into(pk, 960, slot)
            except (ValueError, OverflowError):
                pass


def test_silk_frontend_random_bytes():
    """Scalar + batch SILK frontends on random payloads at every
    internal rate."""
    from opus_tpu_torch.native.frontend import NativeSilkBatch, NativeSilkFrontEnd

    rng = np.random.default_rng(5)
    for fs in (8, 12, 16):
        fe = NativeSilkFrontEnd(fs)
        for payload in _rand_payloads(rng, 40, hi=120):
            try:
                fe.decode(payload)
            except ValueError:
                pass
        nb = NativeSilkBatch(4, fs)
        for _ in range(10):
            try:
                nb.decode_batch(_rand_payloads(rng, 4, hi=120))
            except ValueError:
                pass


def test_encoder_hostile_pcm():
    """The native CELT encoder on hostile PCM: clipping, NaN/Inf, DC,
    impulse trains; every legal frame size and byte budget extremes."""
    from opus_tpu_torch.native.frontend import NativeCeltEncoder, NativeCeltEncoderBatch

    rng = np.random.default_rng(6)
    for channels in (1, 2):
        enc = NativeCeltEncoder(channels)
        for frame in (120, 240, 480, 960):
            cases = [
                np.zeros((frame, channels), np.float32),
                np.full((frame, channels), 4.0, np.float32),  # way past ±1
                rng.standard_normal((frame, channels)).astype(np.float32) * 10,
            ]
            imp = np.zeros((frame, channels), np.float32)
            imp[:: max(1, frame // 7)] = 1.0
            cases.append(imp)
            nan = np.zeros((frame, channels), np.float32)
            nan[0] = np.nan
            nan[-1] = np.inf
            cases.append(nan)
            for pcm in cases:
                for nb in (2, 20, 200, 1275):
                    try:
                        enc.encode(pcm, nb)
                    except ValueError:
                        pass
    be = NativeCeltEncoderBatch(3, 2)
    pcm = rng.standard_normal((3, 960, 2)).astype(np.float32)
    be.encode_batch(pcm, 80)


def test_silk_and_hybrid_encoders_hostile_pcm():
    """Native SILK + hybrid encoders on hostile PCM (clipping, NaN/Inf,
    impulse trains, DC) at every rate and budget extreme — the encoder
    analysis is float-heavy hand-written C++."""
    from opus_tpu_torch.native.frontend import (
        NativeHybridEncoder, NativeHybridEncoderBatch,
        NativeSilkEncoder, NativeSilkEncoderBatch,
    )

    rng = np.random.default_rng(8)
    for fs in (8, 12, 16):
        enc = NativeSilkEncoder(fs)
        frame = 20 * fs
        cases = [
            np.zeros(frame, np.int16),
            np.full(frame, 32767, np.int16),
            (rng.integers(-32768, 32767, frame)).astype(np.int16),
        ]
        imp = np.zeros(frame, np.int16)
        imp[:: max(1, frame // 9)] = 30000
        cases.append(imp)
        for pcm in cases:
            for nb in (10, 25, 60, 400):
                try:
                    enc.encode(pcm, nb)
                except ValueError:
                    pass
        # 10 ms frames too
        enc.encode(cases[2][: frame // 2], 40)
    sb = NativeSilkEncoderBatch(3, 16)
    sb.encode_batch(np.stack([cases[2][:320]] * 3) if len(cases[2]) >= 320
                    else np.zeros((3, 320), np.int16), 60)
    he = NativeHybridEncoder()
    hostile = [
        np.zeros(960, np.float32),
        np.full(960, 5.0, np.float32),
        rng.standard_normal(960).astype(np.float32) * 8,
    ]
    nan = np.zeros(960, np.float32)
    nan[0] = np.nan
    nan[-1] = np.inf
    hostile.append(nan)
    for pcm in hostile:
        for nb in (40, 160, 1275):
            try:
                he.encode(pcm, nb)
            except ValueError:
                pass
    hb = NativeHybridEncoderBatch(2)
    hb.encode_batch(np.stack([hostile[2]] * 2), 120)


def test_voice_stereo_fec_encoders_hostile_pcm():
    """The public-Encoder planes (VoiceEnc/StereoVoiceEnc/HybridEnc with
    resamplers, mid/side closed loop, and LBRR companions) on hostile PCM
    across rates, channel layouts, FEC, and budget extremes."""
    from opus_tpu_torch.native.frontend import (
        NativeCeltEncoder, NativeHybridEncoder, NativeStereoVoiceEncoder,
        NativeVoiceEncoder,
    )

    rng = np.random.default_rng(21)

    def cases(n):
        imp = np.zeros(n, np.int16)
        imp[:: max(1, n // 9)] = 30000
        return [
            np.zeros(n, np.int16),
            np.full(n, -32768, np.int16),
            rng.integers(-32768, 32767, n).astype(np.int16),
            imp,
        ]

    for fs in (8, 12, 16):
        for in_rate in (fs * 1000, 48000):
            for fec in (False, True):
                enc = NativeVoiceEncoder(fs, in_rate, fec)
                n = in_rate // 50  # 20 ms
                for pcm in cases(n):
                    for nb in (10, 60, 400):
                        try:
                            enc.encode(pcm, nb)  # repeated: LBRR engages
                            enc.encode(pcm, nb)
                        except ValueError:
                            pass
                st = NativeStereoVoiceEncoder(fs, in_rate, fec)
                for pcm in cases(n):
                    for nb in (15, 120, 500):
                        try:
                            st.encode(pcm, pcm[::-1].copy(), nb)
                            st.encode(pcm, pcm, nb)
                        except ValueError:
                            pass
    # 40/60 ms multiframe + frame-size switch mid-stream (FEC prev-block
    # length mismatch path).
    enc = NativeVoiceEncoder(16, 48000, True)
    enc.encode(cases(2880)[2], 90)
    enc.encode(cases(960)[2], 60)
    enc.encode(cases(1920)[2], 80)
    st = NativeStereoVoiceEncoder(16, 48000, True)
    st.encode(cases(2880)[2], cases(2880)[3], 180)
    st.encode(cases(960)[2], cases(960)[3], 120)

    # Hybrid stereo + FEC on hostile floats (interleaved).
    nan = rng.standard_normal(960 * 2).astype(np.float32) * 4
    nan[7] = np.nan
    nan[-3] = -np.inf
    for fec in (False, True):
        he = NativeHybridEncoder(2, fec)
        for pcm in (np.zeros(960 * 2, np.float32), nan):
            for nb in (40, 200, 1275):
                try:
                    he.encode(pcm, nb)
                    he.encode(pcm, nb)
                except ValueError:
                    pass
        he.encode(nan[: 480 * 2], 100)  # 10 ms

    # Band-limited public music entry at the end-band extremes.
    ce = NativeCeltEncoder(2)
    for end_band in (13, 17, 19, 21):
        ce.end_band = end_band
        for comp in (0, 10):
            ce.complexity = comp
            ce.encode(nan.reshape(960, 2), 90)


def test_opus_driver_random_bytes():
    """The native opus-level driver (mode mux + SILK/hybrid/LBRR entry
    points in opus_frontend.cpp) through the scalar Decoder on random
    and bit-flipped packets — jax-free (the scalar path is numpy-only)."""
    from opus_tpu_torch.decoder import Decoder, DecoderConfiguration
    from opus_tpu_torch.errors import OpusError
    from opus_tpu_torch.types import Channels, SamplingRate

    rng = np.random.default_rng(7)
    dec = Decoder(DecoderConfiguration(SamplingRate.HZ_48000, Channels.STEREO))
    for _ in range(60):
        n = int(rng.integers(1, 200))
        pkt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        try:
            out = dec.decode_float(pkt, 5760)
            assert np.isfinite(out).all()
        except OpusError:
            pass


def test_lane_imports_neither_jax_nor_the_reference():
    """This module and everything it reaches load neither jax nor
    opus_tpu, so that it runs where libasan is preloaded: it is imported
    in a fresh interpreter, its tests' imports run, and sys.modules is
    read."""
    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_native_sanitize as t\n"
        "from opus_tpu_torch.decoder import Decoder, DecoderConfiguration\n"
        "from opus_tpu_torch.errors import OpusError\n"
        "from opus_tpu_torch.native.frontend import NativeBatchFrontEnd\n"
        "from opus_tpu_torch.types import Channels, SamplingRate\n"
        "NativeBatchFrontEnd(2, 2).decode_batch([None, None], 960)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'opus_tpu'))\n"
        "assert not bad, bad\n"
        "assert t.oracle.__name__ == 'opus_tpu_torch.oracle'\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
