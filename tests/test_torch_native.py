"""The port's own plane A against the reference's, on the CPU.

opus_tpu_torch.native holds byte-identical copies of the CELT engine's
sources and a copy of the ctypes wrapper the port drives, so that the
port imports nothing of opus_tpu.  Both engines load into this process
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
                                  "celt_encoder.inc"])
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
