"""Mode and bandwidth switches in the port's mixed serving loop: the
redundant CELT blocks shadow-decoded on the host and crossfaded into the
ring, against the scalar decoder, the JAX BatchedOpusDecoder and the
reference's own corrections, on the CPU.

The reference's three gates, each on the plan and the p10 transfer: mode
switches CELT -> SILK -> hybrid -> CELT (tests/test_mixed_plan.py:216:
the frame after 5 ms within 2e-3 of the scalar decoder; the first 5 ms of
a switch-adjacent frame within 0.5, the reference's inherited head
approximation; every other frame within 2e-3), a SILK bandwidth switch
NB -> WB (:456, within 1e-6) and the internal-rate resampler reset through
it (tests/test_silk_internal.py:154).  The port's ring also equals the JAX
loop's within 1e-5 on every frame, switch frames included.  Then: a plan
overflow in the step of a redundant block (the shadow advances once), the
committed switching traffic (tests/data/switch_traffic.npz, written by
tools/make_switch_traffic.py) served as JAX serves it, and its
corrections equal to the reference's bit for bit.  The `cuda` case serves
that traffic at B=64 on the card against the CPU.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

F = 960
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "switch_traffic.npz"
JAX_TOL = 1e-5


def _libopus():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _voice(nf: int, amp: float):
    rng = np.random.default_rng(4)
    t = np.arange(F * nf) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    return t, amp * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)


def _mode_switch_packets(nf: int = 16) -> list:
    """The traffic of tests/test_mixed_plan.py:216: stereo 64 kbps, forced
    CELT, SILK, hybrid, CELT for four frames each, music and voice
    alternating every four frames."""
    oracle = _libopus()
    t, voice = _voice(nf, 0.3)
    music = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1763 * t)
    mix = np.where((np.arange(t.size) // (F * 4)) % 2 == 0, music, voice)
    pcm2 = np.stack([mix, 0.8 * np.roll(mix, 9)], -1).astype(np.float32)
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_BITRATE, 64000)
    seq = ([oracle.MODE_CELT_ONLY] * 4 + [oracle.MODE_SILK_ONLY] * 4
           + [oracle.MODE_HYBRID] * 4 + [oracle.MODE_CELT_ONLY] * 4)
    out = []
    for f in range(nf):
        enc.ctl(oracle.SET_FORCE_MODE, seq[f])
        out.append(enc.encode_float(np.ascontiguousarray(pcm2[f * F : (f + 1) * F]).ravel(), F))
    return out


def _bandwidth_switch_packets(nf: int = 8) -> list:
    """The traffic of tests/test_mixed_plan.py:456: SILK mono 24 kbps, the
    maximum bandwidth NB for four frames, then WB."""
    oracle = _libopus()
    voice = _voice(nf, 0.35)[1].astype(np.float32)
    enc = oracle.Encoder(48000, 1)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    enc.ctl(oracle.SET_BITRATE, 24000)
    out = []
    for f in range(nf):
        enc.ctl(oracle.SET_MAX_BANDWIDTH, 1101 if f < 4 else 1103)
        out.append(enc.encode_float(voice[f * F : (f + 1) * F], F))
    return out


def _scalar(pkts: list) -> list:
    from opus_tpu import Decoder

    d = Decoder()
    return [np.asarray(d.decode_float(p, F)).reshape(F, 2) for p in pkts]


@pytest.fixture(scope="module")
def traffic() -> dict:
    """name -> (packets of one stream, the scalar decoder's frames)."""
    out = {}
    for name, make in (("modes", _mode_switch_packets), ("bandwidth", _bandwidth_switch_packets)):
        pkts = make()
        out[name] = (pkts, _scalar(pkts))
    return out


def _port(batch: int, transfer: str, silk: str = "pcm48", device="cpu"):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(batch, 2, transfer=transfer, silk_transfer=silk, device=device)


def _serve_rings(dec, steps: list) -> list:
    """Serve one step per call; each step's ring as numpy."""
    rings = []
    for row in steps:
        dec.serve([row])
        ring = dec._serve_ring
        rings.append((ring.cpu().numpy() if isinstance(ring, torch.Tensor)
                      else np.asarray(ring)).copy())
    return rings


def _jax(batch: int, transfer: str, silk: str = "pcm48"):
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(batch, 2, transfer=transfer, silk_transfer=silk)


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_mode_switches_match_scalar_and_jax(transfer, traffic):
    """The port of tests/test_mixed_plan.py:216 (two copies of the stream,
    so the batch is not one row), and the JAX loop within 1e-5."""
    pkts, refs = traffic["modes"]
    steps = [[p, p] for p in pkts]
    got = _serve_rings(_port(2, transfer), steps)
    want = _serve_rings(_jax(2, transfer), steps)
    switch_adjacent = {f for f in range(len(pkts)) for s in (4, 8, 12) if s <= f < s + 2}
    for f, ring in enumerate(got):
        assert np.isfinite(ring).all()
        assert float(np.abs(ring - want[f]).max()) < JAX_TOL, f
        for b in range(2):
            err = float(np.abs(ring[b] - refs[f]).max())
            tail = float(np.abs(ring[b, 240:] - refs[f][240:]).max())
            assert tail < 2e-3, (f, b, tail)
            assert err < (0.5 if f in switch_adjacent else 2e-3), (f, b, err)


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_bandwidth_switch_matches_scalar_and_jax(transfer, traffic):
    """The port of tests/test_mixed_plan.py:456: through the NB -> WB
    switch and its redundant blocks, every frame within 1e-6 of the
    scalar decoder (the fade runs in f32), and within 1e-5 of JAX."""
    pkts, refs = traffic["bandwidth"]
    steps = [[p] for p in pkts]
    got = _serve_rings(_port(1, transfer), steps)
    want = _serve_rings(_jax(1, transfer), steps)
    for f, ring in enumerate(got):
        assert float(np.abs(ring[0] - refs[f]).max()) < 1e-6, f
        assert float(np.abs(ring - want[f]).max()) < JAX_TOL, f


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_internal_bandwidth_switch_resets_history(transfer, traffic):
    """The port of tests/test_silk_internal.py:154: internal-rate SILK
    through the switch tracks its 48 kHz twin within 6e-4 (a stale
    resampler history would not) and the scalar decoder within 1.2e-3."""
    pkts, refs = traffic["bandwidth"]
    steps = [[p] for p in pkts]
    twin = _serve_rings(_port(1, transfer, "pcm48"), steps)
    got = _serve_rings(_port(1, transfer, "internal"), steps)
    for f in range(len(pkts)):
        assert float(np.abs(got[f][0] - twin[f][0]).max()) < 6e-4, f
        assert float(np.abs(got[f][0] - refs[f]).max()) < 1.2e-3, f


def test_switch_and_plan_overflow_in_one_step(traffic):
    """Beside the mode-switch stream, the bandwidth-switch stream; every
    step with a redundant block also overflows the plan (plane A refuses
    the plan before decoding, as a real overflow leaves every stream's
    state restored).  The packed re-decode alone collects such a step's
    corrections: each step collects once, the shadows decode on the same
    steps as without the overflow, the bandwidth-switch stream stays
    within 1e-6 of the scalar decoder, and every frame within the
    reference's 2e-3 of the run without the overflow."""
    from opus_tpu_torch.celt import decoder as celt_decoder

    pkts, refs = traffic["bandwidth"]
    steps = [[p, m] for p, m in zip(pkts, traffic["modes"][0])]
    real_decode = celt_decoder.CeltDecoder.decode

    def run(overflow_steps):
        dec = _port(2, "plan")
        seen = dict(collected=[], red=[], decodes=[])
        real_collect, real_plan = dec._collect_corrections, dec.native.decode_batch_plan_into
        now = {"t": 0}

        def collect(packets, rcs, *rest):
            seen["collected"].append(now["t"])
            if ((rcs > 0) & (rcs & 1 == 1)).any():
                seen["red"].append(now["t"])
            return real_collect(packets, rcs, *rest)

        def plan(toc, slot):
            if now["t"] in overflow_steps:
                raise OverflowError("synthetic plan overflow")
            return real_plan(toc, slot)

        def decode(self, *args, **kw):
            seen["decodes"].append(now["t"])
            return real_decode(self, *args, **kw)

        dec._collect_corrections, dec.native.decode_batch_plan_into = collect, plan
        celt_decoder.CeltDecoder.decode = decode
        try:
            rings = []
            for t, row in enumerate(steps):
                now["t"] = t
                rings += _serve_rings(dec, [row])
        finally:
            celt_decoder.CeltDecoder.decode = real_decode
        return rings, seen, dec.plan_fallbacks

    clean, seen_clean, _ = run(())
    assert seen_clean["red"] and seen_clean["decodes"], "no redundant block was decoded"
    rings, seen, fallbacks = run(tuple(seen_clean["red"]))
    assert seen["collected"] == list(range(len(steps)))
    assert seen["red"] == seen_clean["red"] and seen["decodes"] == seen_clean["decodes"]
    assert fallbacks == len(seen_clean["red"])
    for f in range(len(steps)):
        assert float(np.abs(rings[f][0] - refs[f]).max()) < 1e-6, f
        assert float(np.abs(rings[f] - clean[f]).max()) < 2e-3, f


def _fixture_steps() -> list:
    """The committed traffic: steps[t][sequence], whole Opus packets."""
    data = np.load(FIXTURE, allow_pickle=False)
    blob, lengths = data["packets"].tobytes(), data["lengths"]
    ends = np.cumsum(lengths.ravel())
    pkts = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    seqs, steps = lengths.shape
    return [[pkts[s * steps + t] for s in range(seqs)] for t in range(steps)]


def test_fixture_holds_both_switches_and_kinds():
    """Every sequence decodes to 13 whole packets; the traffic holds a
    mode switch (CELT, SILK and hybrid frames in one stream), a SILK
    bandwidth switch (NB, then wider: libopus picks MB under its WB
    maximum at 24 kbps), and, from plane A's descriptors, redundant blocks
    of both kinds with one on every step from 1 on."""
    from opus_tpu_torch import packet

    steps = _fixture_steps()
    assert FIXTURE.stat().st_size < 100_000
    assert len(steps) == 13 and {len(r) for r in steps} == {24}
    modes = [{packet.query_packet_codec_mode(r[s]).name for r in steps} for s in range(24)]
    bws = [{int(packet.query_packet_bandwidth(r[s])) for r in steps} for s in range(24)]
    assert any({"CELT_ONLY", "SILK_ONLY", "HYBRID"} <= m for m in modes)
    nb = int(packet.Bandwidth.NARROWBAND)
    assert any(m == {"SILK_ONLY"} and nb in b and len(b) > 1 for m, b in zip(modes, bws))
    dec = _port(24, "p10")
    real = dec._collect_corrections
    kinds = []

    def collect(packets, rcs, *rest):
        red = (rcs > 0) & (rcs & 1 == 1)
        kinds.append(set(((rcs[red] >> 1) & 1).tolist()))
        return real(packets, rcs, *rest)

    dec._collect_corrections = collect
    for row in steps:
        dec.serve([row])
    assert all(kinds[1:]), kinds
    assert set().union(*kinds) == {0, 1}


def test_corrections_equal_reference(traffic):
    """The port's and the reference's packed plane A on the committed
    traffic and on the mode-switch stream: each step's corrections equal
    (stream, kind and PCM bit for bit: the same scalar decoder code) and
    the shadows' warmth equal."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder

    n_corrs = 0
    for steps in (_fixture_steps(), [[p] for p in traffic["modes"][0]]):
        B = len(steps[0])
        ref, port = JaxDecoder(B, 2), _port(B, "p10")
        rslot = ref._alloc_mixed_slots(F, 1)[0]
        pslot = port._alloc_packed_slots(F, 1)[0][0]
        for t, row in enumerate(steps):
            want = ref._plane_a_packed(row, rslot)
            got = port._plane_a_packed(row, pslot)
            assert [(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in want], t
            for (_, _, a), (_, _, b) in zip(got, want):
                assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), t
            assert np.array_equal(port._shadow_warm, ref._shadow_warm), t
            n_corrs += len(got)
    assert n_corrs > 10


@pytest.mark.parametrize("transfer,silk", [("plan", "internal"), ("p10", "pcm48")])
def test_fixture_serves_like_jax(transfer, silk):
    """The committed traffic (B=24) through the port's and the JAX loop,
    one step per call: every frame within 1e-5, equal final ranges, no
    plan fallback."""
    steps = _fixture_steps()
    port, ref = _port(24, transfer, silk), _jax(24, transfer, silk)
    got, want = _serve_rings(port, steps), _serve_rings(ref, steps)
    for f, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all() and float(np.abs(a - b).max()) < JAX_TOL, f
    assert port.final_ranges() == ref.final_ranges()
    assert port.plan_fallbacks == 0


def switch_batch(batch: int, steps: int = 13) -> list:
    """B streams of mixed traffic from the port's native encoders (kind i %
    3: CELT 96 kbps stereo, SILK WB mono 60 B, hybrid SWB mono 160 B) with
    every fourth stream (i % 4 == 3) replaced by fixture sequence (i // 4)
    % 24, whole Opus packets; numpy and the port only."""
    from opus_tpu_torch.native.frontend import (
        NativeCeltEncoderBatch, NativeHybridEncoderBatch, NativeSilkEncoderBatch)

    fixture = _fixture_steps()
    rng = np.random.default_rng(11)
    t = np.arange(F * steps) / 48000.0
    f0 = 100.0 + 180.0 * rng.random(batch)
    voice = (0.3 * np.sign(np.sin(2 * np.pi * f0[:, None] * t))
             + 0.02 * rng.standard_normal((batch, t.size))).astype(np.float32)
    music = (0.4 * np.sin(2 * np.pi * 2 * f0[:, None] * t)
             + 0.05 * rng.standard_normal((batch, t.size))).astype(np.float32)
    celt, silk, hyb = (NativeCeltEncoderBatch(batch, 2), NativeSilkEncoderBatch(batch, 16),
                       NativeHybridEncoderBatch(batch))
    out = []
    for f in range(steps):
        fr = slice(f * F, (f + 1) * F)
        c = celt.encode_batch(np.stack([music[:, fr], 0.8 * music[:, fr]], -1), 240)
        sp, sl = silk.encode_batch(np.round(voice[:, fr][:, ::3] * 32767).astype(np.int16), 60)
        hp, hl = hyb.encode_batch(voice[:, fr], 160)
        row = []
        for i in range(batch):
            if i % 4 == 3:
                row.append(fixture[f][(i // 4) % 24])
            else:
                row.append([bytes([31 << 3 | 4]) + bytes(c[i]),
                            bytes([9 << 3]) + bytes(sp[i, : sl[i]]),
                            bytes([13 << 3]) + bytes(hp[i, : hl[i]])][i % 3])
        out.append(row)
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transfer,silk", [("plan", "internal"), ("p10", "pcm48")])
def test_switch_traffic_on_card_matches_cpu(transfer, silk, cuda_device):
    """Mixed traffic with 16 switching streams at B=64 on the card against
    the port's CPU run: every frame within 1e-4, equal final ranges, no
    plan fallback, redundant blocks on the card's steps."""
    steps = switch_batch(64)
    gpu, cpu = _port(64, transfer, silk, cuda_device), _port(64, transfer, silk)
    real = gpu._collect_corrections
    blocks = []

    def collect(packets, rcs, *rest):
        blocks.append(int(((rcs > 0) & (rcs & 1 == 1)).sum()))
        return real(packets, rcs, *rest)

    gpu._collect_corrections = collect
    for f, (a, b) in enumerate(zip(_serve_rings(gpu, steps), _serve_rings(cpu, steps))):
        assert float(np.abs(a - b).max()) < 1e-4, f
    assert gpu.final_ranges() == cpu.final_ranges()
    assert gpu.plan_fallbacks == 0 and all(blocks[1:]), blocks
