"""The serving decoders' tracer (opus_tpu_torch/trace.py) on the CPU: off
by default and silent when off, the serve loops' span trees and step ids,
the counters, outputs unchanged by tracing, and the spans on the clock of
torch.profiler.  The `cuda` cases read the device phases that a traced
capture records inside a step's CUDA graph.

Traffic comes from the port's own native encoders (CELT 96 kbps stereo;
mixed: CELT, SILK WB and hybrid SWB, whole Opus packets) and the committed
switching traffic; nothing here needs jax or libopus.
"""

from __future__ import annotations

import collections
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from opus_tpu_torch import trace

F = 960
ROOT = pathlib.Path(__file__).resolve().parent.parent
SWITCH = ROOT / "tests" / "data" / "switch_traffic.npz"


@pytest.fixture(autouse=True)
def quiet():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def celt_steps(batch: int, steps: int, lost=()) -> list:
    """steps[t][b]: CELT payloads (no ToC), `lost` (t, b) pairs None."""
    from opus_tpu_torch.native.frontend import NativeCeltEncoderBatch

    rng = np.random.default_rng(3)
    t = np.arange(F * steps) / 48000.0
    f0 = 440.0 * (1.0 + 0.1 * np.arange(batch))[:, None]
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((batch, t.size))
    pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
    enc = NativeCeltEncoderBatch(batch, 2)
    out = []
    for f in range(steps):
        pay = enc.encode_batch(pcm[:, f * F : (f + 1) * F], 240)
        out.append([None if (f, b) in lost else bytes(pay[b]) for b in range(batch)])
    return out


def mixed_steps(steps: int, lost=()) -> list:
    """B=6 whole Opus packets, kinds CELT, SILK WB, hybrid SWB twice."""
    from opus_tpu_torch.native.frontend import (
        NativeCeltEncoderBatch, NativeHybridEncoderBatch, NativeSilkEncoderBatch)

    rng = np.random.default_rng(5)
    t = np.arange(F * steps) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    music = np.stack([0.4 * np.sin(2 * np.pi * 440 * t)] * 2, -1).astype(np.float32)
    celt, silk, hyb = (NativeCeltEncoderBatch(2, 2), NativeSilkEncoderBatch(2, 16),
                       NativeHybridEncoderBatch(2))
    out = []
    for f in range(steps):
        fr = slice(f * F, (f + 1) * F)
        c = celt.encode_batch(np.stack([music[fr], np.roll(music[fr], 5, axis=0)]), 240)
        v = np.stack([voice[fr], 0.8 * np.roll(voice[fr], 9)])
        sp, sl = silk.encode_batch(np.round(v[:, ::3] * 32767).astype(np.int16), 60)
        hp, hl = hyb.encode_batch(v, 160)
        kinds = [[bytes([31 << 3 | 4]) + bytes(c[j]) for j in range(2)],
                 [bytes([9 << 3]) + bytes(sp[j, : sl[j]]) for j in range(2)],
                 [bytes([13 << 3]) + bytes(hp[j, : hl[j]]) for j in range(2)]]
        out.append([None if (f, b) in lost else kinds[b % 3][b // 3] for b in range(6)])
    return out


def celt_decoder(batch: int):
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    return BatchedCeltDecoder(batch, 2, transfer="plan", device="cpu")


def mixed_decoder(batch: int = 6):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(batch, 2, transfer="plan", silk_transfer="internal", device="cpu")


def tree(spans: list) -> dict:
    """id -> (span, [children]) of the host spans."""
    nodes = {s.id: (s, []) for s in spans if not s.device}
    for s, _ in nodes.values():
        if s.parent is not None:
            nodes[s.parent][1].append(s)
    return nodes


def test_off_by_default_and_silent():
    """A fresh interpreter has the tracer off; a serve() with it off
    records no span, and a span is one shared object that reads no clock."""
    out = subprocess.run([sys.executable, "-c", "from opus_tpu_torch import trace; "
                          "print(trace.on, trace.spans())"], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "[]"]
    dec = celt_decoder(4)
    dec.serve(celt_steps(4, 2), F)
    assert trace.spans() == [] and dec.steps_served == 2
    assert trace.span("a") is trace.span("b", step=3)


def test_celt_plan_tree_and_step_ids():
    """CELT plan loop, B=4: two calls of 3 and 1 steps; each call one
    serve_call with its steps and a device_wait; each step's children as
    the loop lays them out, all sharing the step's id; the first step
    builds its variant, the later ones launch it."""
    dec = celt_decoder(4)
    steps = celt_steps(4, 4)
    trace.enable()
    dec.serve(steps[:3], F)
    dec.serve(steps[3:], F)
    spans = trace.spans()
    nodes = tree(spans)
    calls = [s for s in spans if s.name == "serve_call"]
    assert [c.parent for c in calls] == [None, None] and [c.step for c in calls] == [0, 3]
    kids = [[k.name for k in sorted(nodes[c.id][1], key=lambda k: k.start_ns)] for c in calls]
    assert kids == [["step"] * 3 + ["device_wait"], ["step", "device_wait"]]
    step_spans = [s for s in spans if s.name == "step"]
    assert [s.step for s in step_spans] == [0, 1, 2, 3]
    for s in step_spans:
        names = [k.name for k in sorted(nodes[s.id][1], key=lambda k: k.start_ns)]
        assert names == ["slot_wait", "plane_a", "issue"]
        issue = next(k for k in nodes[s.id][1] if k.name == "issue")
        inner = [k.name for k in sorted(nodes[issue.id][1], key=lambda k: k.start_ns)]
        assert inner == ["upload", "graph_build" if s.step == 0 else "launch"]
    # every span of a step carries the step's id, and nests in time
    for s in spans:
        if s.parent is not None:
            p = nodes[s.parent][0]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            if p.name != "serve_call":
                assert s.step == p.step
    waits = [s for s in spans if s.name == "device_wait"]
    assert [w.step for w in waits] == [2, 3]
    assert trace.counters()["graph_builds"] == 1


def test_mixed_plan_tree_with_loss_and_overflow(monkeypatch):
    """Mixed plan loop, B=6, with a step losing both CELT streams (a
    concealing variant) and a forced plan overflow (the packed path for
    that step, under overflow_step with its own children)."""
    dec = mixed_decoder()
    orig, calls = dec._plane_a_plan, {"n": 0}

    def overflowing(packets, slot):
        calls["n"] += 1
        if calls["n"] == 4:
            raise OverflowError("synthetic plan overflow")
        return orig(packets, slot)

    monkeypatch.setattr(dec, "_plane_a_plan", overflowing)
    trace.enable()
    for row in mixed_steps(5, lost={(2, 0), (2, 3)}):
        dec.serve([row])
    spans = trace.spans()
    nodes = tree(spans)
    by_step = collections.defaultdict(list)
    for s in spans:
        if s.name == "step":
            by_step[s.step] = [k.name for k in sorted(nodes[s.id][1], key=lambda k: k.start_ns)]
    plan = ["slot_wait", "toc", "plane_a", "silk_pack", "corrections", "silk_pack", "issue",
            "crossfade"]
    assert by_step == {0: plan, 1: plan, 2: plan, 3: ["slot_wait", "overflow_step"], 4: plan}
    over = next(s for s in spans if s.name == "overflow_step")
    assert [k.name for k in sorted(nodes[over.id][1], key=lambda k: k.start_ns)] == [
        "slot_wait", "toc", "plane_a", "corrections", "issue", "crossfade"]
    assert all(s.step == 3 for s in spans if s.step == 3 or s.parent == over.id)
    assert dec.plan_fallbacks == 1 and trace.counters()["plan_fallbacks"] >= 1
    c = trace.counters()
    assert c["plc_steps_whole"] == 1 and c["plc_steps_compact"] == 0
    # step 2 conceals (a variant of its own) and step 3 is the packed one
    assert c["graph_builds"] == 3


def test_plc_variant_counters():
    """CELT plan loop, B=4, compact capacity 2: one first loss conceals
    compactly, three at once the whole batch; counted by step."""
    dec = celt_decoder(4)
    dec.PLC_COMPACT_K = 2
    trace.enable()
    for row in celt_steps(4, 6, lost={(2, 0), (4, 1), (4, 2), (4, 3)}):
        dec.serve([row], F)
    c = trace.counters()
    assert (c["plc_steps_compact"], c["plc_steps_whole"]) == (1, 1)
    assert trace.counters(steps=(0, 3))["plc_steps_compact"] == 1
    assert trace.counters(steps=(3, 6))["plc_steps_compact"] == 0
    assert trace.counters(steps=(4, 5))["plc_steps_whole"] == 1


def test_upload_bytes_are_the_uploaded_words():
    """upload_bytes = the words each step copies (head and slot prefix) x 4,
    counted whether tracing is on or off."""
    dec = celt_decoder(4)
    want = 0
    for t, row in enumerate(celt_steps(4, 4)):
        if t == 2:
            trace.enable()
        before = trace.counters()["upload_bytes"]
        dec.serve([row], F)
        slot = dec._plan_slots[0]
        want = 4 * (dec.PLAN_HEAD + dec._plan_upload_words(slot))
        assert trace.counters()["upload_bytes"] - before == want
    assert trace.counters(steps=(3, 4))["upload_bytes"] == want
    assert trace.counters(steps=(0, 2))["upload_bytes"] == 0  # kept only while on
    dec = mixed_decoder()
    for row in mixed_steps(2):
        before = trace.counters()["upload_bytes"]
        dec.serve([row])
        words = dec._plan_slots[0]["upload_words"]
        assert trace.counters()["upload_bytes"] - before == 4 * (dec.PLAN_HEAD + words)


def test_shadow_decodes_on_switch_traffic(monkeypatch):
    """shadow_decodes counts every redundant CELT block the shadow
    decoders decode on the host, on the committed switching traffic."""
    from opus_tpu_torch.celt import decoder as celt_decoder_mod

    data = np.load(SWITCH, allow_pickle=False)
    blob, lengths = data["packets"].tobytes(), data["lengths"]
    ends = np.cumsum(lengths.ravel())
    pkts = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    seqs, steps = lengths.shape
    real, decoded = celt_decoder_mod.CeltDecoder.decode, []

    def counting(self, *a, **k):
        decoded.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(celt_decoder_mod.CeltDecoder, "decode", counting)
    dec = mixed_decoder(seqs)
    trace.enable()
    for t in range(steps):
        dec.serve([[pkts[s * steps + t] for s in range(seqs)]])
    assert len(decoded) > 0 and trace.counters()["shadow_decodes"] == len(decoded)
    spans = trace.spans()
    assert sum(1 for s in spans if s.name == "corrections") == steps


@pytest.mark.parametrize("kind", ["celt", "mixed"])
def test_outputs_bit_identical_with_tracing(kind):
    """Ring and digest are the same bits with the tracer on and off."""
    runs = []
    for on in (False, True):
        trace.disable()
        if on:
            trace.enable()
        if kind == "celt":
            dec, rows = celt_decoder(4), celt_steps(4, 4, lost={(2, 1)})
            digests = [dec.serve(rows[:2], F), dec.serve(rows[2:], F)]
        else:
            dec, rows = mixed_decoder(), mixed_steps(3, lost={(1, 0)})
            digests = [dec.serve([row]) for row in rows]
        runs.append((dec._serve_ring.clone(), np.stack(digests)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
    assert trace.spans()


def test_spans_on_the_profiler_clock():
    """Under a CPU torch.profiler each span is a range named with the
    prefix, and its converted start and end fall within 0.2 ms of it."""
    dec = celt_decoder(4)
    rows = celt_steps(4, 3)
    dec.serve(rows[:1], F)
    trace.enable(range_prefix="traced.")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("first"):
            pass  # a session's first range sets the profiler up (about 2 ms here)
        dec.serve(rows[1:], F)
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("traced."):
            ranges[e.name()[len("traced."):]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = trace.spans()
    assert {s.name for s in spans} == set(ranges)
    for name, got in ranges.items():
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        assert len(mine) == len(got), name
        for (a, b), (c, d) in zip(mine, sorted(got)):
            assert abs(a - c) < 200_000 and abs(b - d) < 200_000, (name, a - c, b - d)
    # no profiler: no range, the spans are still kept
    trace.clear()
    dec.serve(rows[:1], F)
    assert {s.name for s in trace.spans()} >= {"serve_call", "step", "plane_a"}


def test_ring_drops_the_oldest(monkeypatch):
    """A full ring drops its oldest records and counts them."""
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=8))
    dec = celt_decoder(4)
    trace.enable()
    dec.serve(celt_steps(4, 2), F)
    spans = trace.spans()
    assert len(spans) == 8 and spans[-1].name == "serve_call"
    # two steps of six spans each, a device_wait and the serve_call
    assert trace.counters()["spans_dropped"] == 2 * 6 + 2 - 8


def test_multistream_split_and_unmap():
    """The multistream loop's own spans around the core's serve() tree."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    data = np.load(ROOT / "tests" / "data" / "multistream_traffic.npz", allow_pickle=False)
    blob, lengths = data["ambi_packets"].tobytes(), data["ambi_lengths"]
    ends = np.cumsum(lengths.ravel())
    flat = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    ch, streams, coupled, *mapping = data["ambi_layout"].tolist()
    sessions, n = lengths.shape
    bmd = BatchedMultistreamDecoder(sessions, ch, streams, coupled, mapping, mode="celt",
                                    device="cpu")
    bmd.core.transfer = "plan"
    trace.enable()
    bmd.serve([[flat[s * n + p] for s in range(sessions)] for p in range(2)], F)
    spans = trace.spans()
    top = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent is None]
    assert top == ["split", "serve_call", "unmap"]
    assert [s.step for s in spans if s.name in ("split", "unmap")] == [0, 1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["celt", "mixed"])
def test_device_phases_on_card(kind, cuda_device):
    """A variant captured with the tracer on records its phases as timing
    events in its graph: every replay's phases are read, each > 0, and
    they sum to at most the step's device time (first to last event)."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    trace.enable()
    if kind == "celt":
        dec = BatchedCeltDecoder(64, 2, transfer="plan", device=cuda_device)
        rows = celt_steps(64, 6)
        for row in rows:
            dec.serve([row], F)
        want = {"plan_exec", "synthesis", "step"}
    else:
        dec = BatchedOpusDecoder(6, 2, transfer="plan", silk_transfer="internal",
                                 device=cuda_device)
        for row in mixed_steps(6):
            dec.serve([row])
        want = {"plan_exec", "silk", "synthesis", "step"}
    phases = collections.defaultdict(dict)
    for s in trace.spans():
        if s.device:
            phases[s.step][s.name] = (s.end_ns - s.start_ns) / 1e6
    builds = trace.counters()["graph_builds"]
    assert len(phases) == 6 - builds and trace.counters()["device_phases_missed"] == 0
    for step, ph in phases.items():
        assert set(ph) == want, (step, ph)
        parts = [v for k, v in ph.items() if k != "step"]
        assert min(parts) > 0 and sum(parts) <= ph["step"] + 1e-3, (step, ph)
