"""The port's own plane A against the reference's, on the CPU.

opus_tpu_torch.native holds byte-identical copies of the CELT, SILK and
Opus engines' sources and a copy of the ctypes wrapper the port drives, so
that the port imports nothing of opus_tpu.  Both engines load into this process
(each library is its own RTLD_LOCAL handle, so their statics are
separate); on the same packets they must fill their slots word for word
and end on the same final ranges.
"""

import pathlib

import numpy as np
import pytest

from opus_tpu.native import frontend as ref_fe
from opus_tpu_torch.native import frontend as port_fe

pytestmark = pytest.mark.skipif(not ref_fe.available(), reason="native engine not built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAME = 960


@pytest.mark.parametrize("name", ["celt_frontend.cpp", "celt_tables.h", "ec.h",
                                  "celt_encoder.inc", "silk_frontend.cpp", "silk_tables.h",
                                  "silk_encoder.inc", "opus_frontend.cpp"])
def test_sources_are_byte_identical(name):
    port = (ROOT / "opus_tpu_torch" / "native" / name).read_bytes()
    assert port == (ROOT / "opus_tpu" / "native" / name).read_bytes()


def _payloads(B, NF, seed=5):
    """Payloads from the reference's encoder at 96 kbps stereo: tones plus
    noise with clicks (short blocks) and one 160 kbps stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(FRAME * NF) / 48000.0
    f0 = 300.0 * (1.0 + 0.3 * np.arange(B))[:, None]
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, t.size))
    for i in range(B):
        sig[i, 700 + 900 * i :: 3001] += 0.9
    pcm = np.stack([sig, 0.7 * np.roll(sig, 5, axis=1)], -1).astype(np.float32)
    enc = ref_fe.NativeCeltEncoderBatch(B, 2)
    return [[bytes(p) for p in enc.encode_batch(pcm[:, f * FRAME : (f + 1) * FRAME], 240)]
            for f in range(NF)]


def _lose(batches, lost):
    return [[None if (f, i) in lost else p for i, p in enumerate(pk)]
            for f, pk in enumerate(batches)]


@pytest.mark.parametrize("mode", ["q14", "p10", "plan"])
def test_plane_a_fills_slots_like_the_reference(mode):
    """Same packets (with a loss run and a noise-regime loss on stream 1)
    through both engines: every slot word and every final range equal."""
    B, NF = 4, 6
    batches = _lose(_payloads(B, NF), {(2, 1), (4, 1)})
    ref = ref_fe.NativeBatchFrontEnd(B, 2)
    port = port_fe.NativeBatchFrontEnd(B, 2)
    if mode == "plan":
        want_slot = ref.alloc_plan_slots(1)[0]
        got_slot = port_fe.alloc_plan_slots(B, 1)[0]
    else:
        want_slot = ref.alloc_packed_slots(1, mode)[0]
        got_slot = ref.alloc_packed_slots(1, mode)[0]
    for packets in batches:
        if mode == "plan":
            want = ref.decode_batch_plan_into(packets, FRAME, want_slot, want_xdbg=True)
            got = port.decode_batch_plan_into(packets, FRAME, got_slot, want_xdbg=True)
            for key in ("header", "ble", "meta", "gains", "bands", "xdbg", "iy_spans"):
                assert np.array_equal(got[key], want[key]), key
            assert got["used_words"] == want["used_words"]
            assert np.array_equal(got["buf"][: got["used_words"]],
                                  want["buf"][: want["used_words"]])
        else:
            ref.decode_batch_q15_into(packets, FRAME, want_slot)
            port.decode_batch_q15_into(packets, FRAME, got_slot)
            assert np.array_equal(got_slot["buf"], want_slot["buf"])
    assert port.final_ranges() == ref.final_ranges()


def test_f32_and_q15_planes_match_the_reference():
    B = 3
    batches = _payloads(B, 2, seed=9)
    ref = ref_fe.NativeBatchFrontEnd(B, 2)
    port = port_fe.NativeBatchFrontEnd(B, 2)
    for packets in batches:
        for name in ("decode_batch_f32", "decode_batch_q15"):
            want = getattr(ref, name)(packets, FRAME)
            got = getattr(port, name)(packets, FRAME)
            for a, b in zip(got, want):
                assert np.array_equal(a, b), name
    assert port.final_ranges() == ref.final_ranges()


def test_encoder_batch_matches_the_reference():
    B = 3
    rng = np.random.default_rng(2)
    pcm = (0.3 * rng.standard_normal((B, FRAME, 2))).astype(np.float32)
    want = ref_fe.NativeCeltEncoderBatch(B, 2).encode_batch(pcm, 200)
    got = port_fe.NativeCeltEncoderBatch(B, 2).encode_batch(pcm, 200)
    assert np.array_equal(got, want)


def test_plan_constants_and_span_guard_match_the_reference():
    from opus_tpu.dsp.plan_exec import PLAN_IYW

    assert port_fe.PLAN_IYW == PLAN_IYW
    assert port_fe.PLAN_FIXED_WORDS == ref_fe.PLAN_FIXED_WORDS
    B = 4
    slot = port_fe.alloc_plan_slots(B, 1)[0]
    port_fe.NativeBatchFrontEnd(B, 2).decode_batch_plan_into(_payloads(B, 1)[0], FRAME, slot)
    spans = port_fe.check_plan_iy_span(slot)
    assert np.array_equal(spans, ref_fe.check_plan_iy_span(slot))
    assert 0 < int(spans.max()) <= PLAN_IYW - 1
    # A span one word past the window trips both guards.
    over = dict(slot, arena=slot["arena"].copy())
    n_pvq = int(over["header"][0, 1] & 0x1FF)
    off = int(over["header"][0, 0])
    over["arena"][off : off + n_pvq] |= 0xF00 | 0xFF  # every leaf 256 wide, 15 bits
    for guard in (port_fe.check_plan_iy_span, ref_fe.check_plan_iy_span):
        with pytest.raises(OverflowError):
            guard(over)


def _mixed_steps(B, NF):
    """Whole Opus packets, stream i of kind i % 3 (CELT 96 kbps stereo,
    SILK WB 60 B mono, hybrid SWB 160 B mono) from the port's own native
    encoders, as chip_smoke.py makes them, with losses on every kind."""
    rng = np.random.default_rng(4)
    t = np.arange(FRAME * NF) / 48000.0
    voice = (0.35 * np.sign(np.sin(2 * np.pi * 140 * t))[None] * (1 + 0.2 * np.arange(B))[:, None]
             / (1 + 0.2 * B) + 0.02 * rng.standard_normal((B, t.size))).astype(np.float32)
    silk = port_fe.NativeSilkEncoderBatch(B, 16)
    hyb = port_fe.NativeHybridEncoderBatch(B)
    celt = _payloads(B, NF)
    steps = []
    for f in range(NF):
        v = voice[:, f * FRAME : (f + 1) * FRAME]
        s_pay, s_len = silk.encode_batch(np.round(v[:, ::3] * 32767).astype(np.int16), 60)
        h_pay, h_len = hyb.encode_batch(v, 160)
        row = []
        for i in range(B):
            kind = i % 3
            if (f, i) in {(2, 0), (3, 1), (3, 2), (4, 4)}:
                row.append(None)
            elif kind == 0:
                row.append(bytes([31 << 3 | 4]) + celt[f][i])  # CELT FB 20 ms stereo
            elif kind == 1:
                row.append(bytes([9 << 3]) + bytes(s_pay[i, : s_len[i]]))  # SILK WB 20 ms
            else:
                row.append(bytes([13 << 3]) + bytes(h_pay[i, : h_len[i]]))  # hybrid SWB 20 ms
        steps.append(row)
    return steps


@pytest.mark.parametrize("transfer", ["plan", "p10"])
@pytest.mark.parametrize("silk", ["internal", "pcm48"])
def test_mixed_plane_a_fills_slots_like_the_reference(transfer, silk):
    """The mixed decode (NativeOpusFrontEnd) against the reference's
    BatchedOpusDecoder plane A on the same packets: every slot word, the
    SILK staging, the row map and the final ranges equal."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as RefDecoder
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    B, NF = 6, 5
    ref = RefDecoder(B, 2, transfer=transfer, silk_transfer=silk)
    port = BatchedOpusDecoder(B, 2, transfer=transfer, silk_transfer=silk, device="cpu")
    if transfer == "plan":
        want = ref_fe.alloc_plan_slots(B, 1, 512, silk_words=port._silk_shape(FRAME)[1])[0]
        got = port._alloc_plan_slots(FRAME, 1)[0][0]
    else:
        want = ref._alloc_mixed_slots(FRAME, 1)[0]
        got = port._alloc_packed_slots(FRAME, 1)[0][0]
    want["frame48"] = FRAME
    for packets in _mixed_steps(B, NF):
        if transfer == "plan":
            ref._plane_a_plan(packets, want)
            port._plane_a_plan(packets, got)
            for key in ("header", "ble", "meta", "gains", "bands", "silk", "silk_rows"):
                assert np.array_equal(got[key], want[key]), key
            assert got["used_words"] == want["used_words"]
            assert np.array_equal(got["buf"][: got["used_words"]],
                                  want["buf"][: want["used_words"]])
        else:
            ref._plane_a_packed(packets, want)
            port._plane_a_packed(packets, got)
            assert np.array_equal(got["buf"], want["buf"])
        assert np.array_equal(port.native.trans, ref._trans)
    assert port.final_ranges() == ref.final_ranges()


def test_silk_and_hybrid_encoders_match_the_reference():
    """The port's bindings of the native SILK, voice and hybrid encoders
    give the reference's bytes."""
    B = 3
    rng = np.random.default_rng(6)
    x16 = (rng.standard_normal((B, 320)) * 3000).astype(np.int16)
    x48 = (0.2 * rng.standard_normal((B, FRAME))).astype(np.float32)
    for got, want in (
        (port_fe.NativeSilkEncoderBatch(B, 16).encode_batch(x16, 60),
         ref_fe.NativeSilkEncoderBatch(B, 16).encode_batch(x16, 60)),
        (port_fe.NativeHybridEncoderBatch(B).encode_batch(x48, 160),
         ref_fe.NativeHybridEncoderBatch(B).encode_batch(x48, 160)),
    ):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    voice, ref_voice = port_fe.NativeVoiceEncoder(16, 48000), ref_fe.NativeVoiceEncoder(16, 48000)
    hyb, ref_hyb = port_fe.NativeHybridEncoder(), ref_fe.NativeHybridEncoder()
    for i in range(3):
        pcm16 = (x48[i] * 32767).astype(np.int16)
        assert voice.encode(pcm16, 60) == ref_voice.encode(pcm16, 60)
        assert hyb.encode(x48[i], 160) == ref_hyb.encode(x48[i], 160)
    assert voice.final_range == ref_voice.final_range
    assert hyb.final_range == ref_hyb.final_range
