"""The port's serving steps as CUDA graphs (opus_tpu_torch/dsp/graphs.py)
and the static inputs they need.

On the CPU, where the steps run eagerly:

* a plan step fed its whole device buffer, with the upload's end (and, on
  the mixed path, the SILK rows' offset) read from device scalars of the
  same upload, equals the step fed the uploaded prefix bit for bit, on
  plane-A slots of the port's own traffic (chip_smoke.py's payloads at a
  small batch) with stale words past the upload: the clean variant, the
  compact and whole-batch concealing variants, and mixed plan steps;
* the fixed-capacity `_silk_resample` (one product per rate over every
  stream) against the JAX one on the descriptor cases of no stream, one
  stream and every stream at one rate, within the tolerance of
  tests/test_torch_opus.py's comparison;
* the serve loops keep the device buffers, rings and state their steps
  are bound to across serve() calls, and a captured step refuses other
  tensors and counts its launches a replay.

The `cuda` cases (B=64, on the card): each variant's replay equals its
eager step bit for bit (chip_smoke.py's graphs phase at a small batch),
the launch counters count replays, and one graph serves steps whose
uploads end at different words and whose SILK rates differ.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

B, F = 16, 960
CELT_CASES = {"clean": (1, ()), "compact": (2, (1, 5)), "whole-batch": (2, tuple(range(8)))}


@pytest.fixture(scope="module")
def traffic():
    """chip_smoke.py's CELT and mixed payloads at B=16, 3 steps."""
    import chip_smoke as cs

    old = cs.B, cs.STEPS
    cs.B, cs.STEPS = B, 3
    try:
        clean = cs.make_payloads()
        return {"celt": clean, "mixed": cs.make_mixed_payloads(clean)}
    finally:
        cs.B, cs.STEPS = old


def _lose(steps, t: int, streams) -> list:
    return [[None if (f == t and i in streams) else p for i, p in enumerate(pk)]
            for f, pk in enumerate(steps)]


def _copies(state, ring, plc):
    from opus_tpu_torch.dsp.synthesis import SynthState

    hist = None if state.silk_hist is None else state.silk_hist.clone()
    return (SynthState(state.mem.clone(), state.preemph.clone(), hist), ring.clone(),
            [t.clone() for t in plc])


def _same(a, b) -> None:
    (sa, ra, pa, da), (sb, rb, pb, db) = a, b
    assert torch.equal(ra, rb) and torch.equal(da, db)
    assert torch.equal(sa.mem, sb.mem) and torch.equal(sa.preemph, sb.preemph)
    assert (sa.silk_hist is None) == (sb.silk_hist is None)
    if sa.silk_hist is not None:
        assert torch.equal(sa.silk_hist, sb.silk_hist)
    assert len(pa) == len(pb) and all(torch.equal(x, y) for x, y in zip(pa, pb))


def _stale(buf) -> None:
    """Fill a device buffer with words a previous upload could have left."""
    gen = torch.Generator().manual_seed(7)
    buf.copy_(torch.randint(-2**31, 2**31 - 1, buf.shape, generator=gen, dtype=torch.int32))


def _run(step, state, ring, buf, plc, **kw):
    state, ring, plc = _copies(state, ring, plc)
    digest = step(state, ring, buf, *plc, **kw)[2]
    return state, ring, plc, digest


@pytest.mark.parametrize("case", list(CELT_CASES))
def test_plan_step_whole_buffer_equals_prefix(traffic, case):
    """The CELT plan step on its whole device buffer with the upload's end
    as a device scalar (the serve loop's form) equals the step on the
    uploaded prefix, bit for bit, in the clean, compact and whole-batch
    concealing variants."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    t, lost = CELT_CASES[case]
    steps = _lose(traffic["celt"], t, lost)
    dec = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    dec.PLC_COMPACT_K = 4
    dec.serve(steps[:t], F)
    state, ring = dec._serve_state_and_ring()
    plc = dec._serve_plc_state(2)
    slot = dec._alloc_plan_slots(1)[0]
    dec.native.decode_batch_plan_into(steps[t], F, slot)
    meta = slot["meta"]
    with_plc = dec._plc_variant(meta)
    assert with_plc == {"clean": False, "compact": 4, "whole-batch": True}[case]
    dev = dec._device_buffer("plan", slot["head"].shape[0])
    _stale(dev)
    words = dec._plan_upload_words(slot)
    buf, end, _ = dec._upload_plan(slot, dev, words)
    assert int(end) == words and buf.data_ptr() == dev[dec.PLAN_HEAD :].data_ptr()
    chunk, active = pf_chunk_for(meta[:, 6:9], slot["gains"])
    step = dec._plan_serving_step(3, chunk, active, dec._plan_size_class(slot), with_plc)
    plc = plc if with_plc else ()
    want = _run(step, state, ring, slot["host"][:words].clone(), plc)
    got = _run(step, state, ring, buf, plc, end=end)
    _same(got, want)
    assert float(want[1].abs().max()) > 0


@pytest.mark.parametrize("lost", [(), (0, 3)], ids=["clean", "loss"])
def test_mixed_plan_step_whole_buffer_equals_prefix(traffic, lost):
    """The mixed plan step (internal SILK) on its whole device buffer, with
    the upload's end and the SILK rows' offset as device scalars, equals
    the step on the uploaded prefix with the offset as an int, bit for
    bit; with CELT losses it runs the compact concealing variant."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.native.frontend import pack_plan_silk

    steps = _lose(traffic["mixed"], 1, lost)
    dec = BatchedOpusDecoder(B, 2, transfer="plan", silk_transfer="internal", device="cpu")
    dec.PLC_COMPACT_K = 4
    dec.serve(steps[:1])
    state, ring = dec._serve_state_and_ring(F)
    plc = dec._serve_plc_state(2)
    slots, dev = dec._alloc_plan_slots(F, 1)
    _stale(dev)
    dec._plane_a_plan(steps[1], slots[0])
    lm, chunk, active, with_plc = dec._step_picks(slots[0])
    assert with_plc == (4 if lost else False)
    silk_at, words = pack_plan_silk(slots[0])
    assert len(slots[0]["silk_rows"]) > 0
    buf, end, at = dec._upload_plan(slots[0], dev, words, silk_at)
    assert (int(end), int(at)) == (words, silk_at)
    step = dec._mixed_plan_serving_step(lm, chunk, active, dec._plan_size_class(slots[0]),
                                        with_plc)
    plc = plc if with_plc else ()
    want = _run(step, state, ring, slots[0]["host"][:words].clone(), plc, silk_at=silk_at)
    got = _run(step, state, ring, buf, plc, end=end, silk_at=at)
    _same(got, want)


RESAMPLE_CASES = {
    "none": [0] * 6,
    "one": [0, 0, 12 | 1 << 5, 0, 0, 0],
    "all-8": [8, 8 | 1 << 5, 8 | 1 << 6, 8, 8 | 1 << 5 | 1 << 6, 8],
    "all-12": [12 | 1 << 5] * 3 + [12 | 1 << 6] * 3,
    "all-16": [16] * 2 + [16 | 1 << 5] * 4,
}


@pytest.mark.parametrize("case", list(RESAMPLE_CASES))
def test_silk_resample_fixed_capacity_matches_jax(case):
    """The fixed-capacity `_silk_resample` against the JAX one when no
    stream, one stream or every stream ships SILK at one rate: PCM within
    1e-5 of full scale (tests/test_torch_opus.py's gate), the new history
    exactly, and zero PCM and history for a stream without SILK."""
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import _silk_resample as jax_resample
    from opus_tpu_torch.dsp.resample import TAIL
    from opus_tpu_torch.dsp.synthesis import _silk_resample

    desc = np.array(RESAMPLE_CASES[case], np.int32)
    n, lm = len(desc), 3
    lmax = (120 << lm) // 3
    rng = np.random.default_rng(len(case))
    y16 = rng.integers(-20000, 20000, (n, 2 * lmax)).astype(np.float32)
    hist = rng.integers(-20000, 20000, (n, 2, TAIL)).astype(np.float32)
    want, want_h = jax_resample(jnp.asarray(y16), jnp.asarray(desc), jnp.asarray(hist), lm, 2)
    got, got_h = _silk_resample(torch.tensor(y16), torch.tensor(desc), torch.tensor(hist), lm,
                                2)
    assert got.shape == want.shape == (n, 120 << lm, 2)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5 * 32768
    assert np.array_equal(got_h.numpy(), np.asarray(want_h))
    off = desc == 0
    assert not got.numpy()[off].any() and not got_h.numpy()[off].any()
    assert np.abs(got.numpy()[~off]).max(initial=1001) > 1000


def test_serve_keeps_bound_tensors(traffic):
    """Across serve() calls, and a change of slot count, the decoders keep
    the device buffers, the ring and the state their steps are bound to
    (a captured step holds their addresses)."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    celt = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    mixed = BatchedOpusDecoder(B, 2, transfer="plan", silk_transfer="internal", device="cpu")

    def bound(dec):
        return ([b.data_ptr() for b in dec._dev_bufs.values()]
                + [dec._serve_ring.data_ptr(), dec._serve_state.mem.data_ptr()])

    celt.serve(traffic["celt"][:1], F)
    mixed.serve(traffic["mixed"][:1])
    first = bound(celt), bound(mixed)
    celt.serve(traffic["celt"][1:2], F, n_slots=2)
    mixed.serve(traffic["mixed"][1:2], n_slots=2)
    assert (bound(celt), bound(mixed)) == first
    assert len(celt._plan_slots) == len(mixed._plan_slots) == 2


def test_captured_step_replays_and_refuses_other_tensors():
    """A CapturedStep replays its graph for the tensors it was captured
    with, adding each wrapper's launches of a replay to its counter, and
    raises for any other tensor (here a graph that records its replays)."""
    from opus_tpu_torch.dsp import graphs
    from opus_tpu_torch.dsp.postfilter import postfilter
    from opus_tpu_torch.dsp.rotation import rot_pass
    from opus_tpu_torch.dsp.synthesis import init_state

    state = init_state(2, 2, device="cpu")
    ring, buf, end = torch.zeros(2, F, 2), torch.zeros(64, dtype=torch.int32), torch.tensor(9)
    replays = []
    cap = graphs.CapturedStep(None, types.SimpleNamespace(digest=torch.zeros(2)))
    cap.graph = types.SimpleNamespace(replay=lambda: replays.append(1))
    cap.layout = graphs._layout((state, ring, buf), {"end": end})
    cap.launches = {postfilter: 1, rot_pass: 2}
    pf0, rot0 = postfilter.launches, rot_pass.launches
    out = cap(state, ring, buf, end=end)
    assert out[0] is state and out[1] is ring and out[2] is cap.pool.digest
    assert replays == [1] and (postfilter.launches, rot_pass.launches) == (pf0 + 1, rot0 + 2)
    for args, kw in (((state, ring.clone(), buf), {"end": end}),
                     ((state, ring, buf[:32]), {"end": end}),
                     ((state, ring, buf), {"end": end.clone()}),
                     ((state, ring, buf), {})):
        with pytest.raises(ValueError, match="other tensors"):
            cap(*args, **kw)
    assert replays == [1] and postfilter.launches == pf0 + 1
    postfilter.launches, rot_pass.launches = pf0, rot0


# --- on the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_traffic(cuda_device):
    """chip_smoke.py's traffic at B=64, 13 steps: clean, lossy (p10's),
    plan-loss (streams 1 and 5 lost at step 1: compact at a capacity of 8;
    every third stream at step 6: the whole batch), mixed, mixed with CELT
    streams 0 and 3 lost at step 1, and mixed with the switching streams."""
    import chip_smoke as cs

    old, cs.B = cs.B, 64
    try:
        clean = cs.make_payloads()
        mixed = cs.make_mixed_payloads(clean)
        yield {"clean": clean, "lossy": cs.with_losses(clean),
               "plan_lossy": _lose(_lose(clean, 1, (1, 5)), 6, range(0, 64, 3)), "mixed": mixed,
               "mixed_lossy": _lose(mixed, 1, (0, 3)), "switch": cs.with_switches(mixed)}
    finally:
        cs.B = old


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,t", [("p10", "lossy", 1), ("plan", "clean", 1),
                                         ("compact", "plan_lossy", 1),
                                         ("whole-batch", "plan_lossy", 6),
                                         ("mixed", "mixed", 1), ("mixed-loss", "mixed_lossy", 1)])
def test_replay_equals_eager(card_traffic, cuda_device, monkeypatch, name, kind, t):
    """chip_smoke.py's graphs gate at B=64: the variant's step replayed from
    its CUDA graph equals the factory's eager step from copies of the same
    state, slot and ring, bit for bit."""
    import chip_smoke as cs
    from opus_tpu_torch.batch.pipeline import ServingSlots

    monkeypatch.setattr(cs, "B", 64)
    monkeypatch.setattr(ServingSlots, "PLC_COMPACT_K", 8)
    dec, step, state, ring, buf, plc, kw, _ = cs.graph_case(cuda_device, name,
                                                            card_traffic[kind], t)
    res = cs.replay_vs_eager(step, state, ring, buf, plc, **kw)
    assert res["eager_repeat_equal"] and res["equal"], res
    assert step.graph is not None


@pytest.mark.cuda
def test_counters_count_replays(card_traffic, cuda_device):
    """Serving the clean plan traffic on the card: the rotation counter
    shows 2 launches every step and the post-filter one a step with an
    active filter, though most steps were replays, and fewer graphs were
    captured than steps were served."""
    import chip_smoke as cs
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.graphs import CapturedStep
    from opus_tpu_torch.dsp.postfilter import postfilter
    from opus_tpu_torch.dsp.rotation import rot_pass

    steps = card_traffic["clean"]
    dec = BatchedCeltDecoder(64, 2, transfer="plan", device=cuda_device)
    postfilter.launches = rot_pass.launches = 0
    got = cs.serve_steps(dec, steps)
    graphs = [s for s in dec._steps.values() if isinstance(s, CapturedStep) and s.graph]
    assert 0 < len(graphs) < len(steps)
    assert rot_pass.launches == 2 * len(steps)
    assert postfilter.launches == sum(c is not None for c in got["chunks"]) > 0
    assert all(g.launches.get(rot_pass) == 2 for g in graphs)


@pytest.mark.cuda
def test_one_graph_serves_different_uploads(card_traffic, cuda_device):
    """On the mixed plan path with mode and bandwidth switches (the SILK
    rate of the switching streams changes), steps served by one graph
    upload different word counts and different counts of streams a SILK
    rate; the ring stays within 1e-4 of the port's CPU run of streams 0-5
    before any device concealment (none in this traffic)."""
    import chip_smoke as cs
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    steps = card_traffic["switch"]
    dec = BatchedOpusDecoder(64, 2, transfer="plan", silk_transfer="internal",
                             device=cuda_device)
    seen = {}
    real = dec._mixed_plan_serving_step

    def spy(*args):
        slot = dec._plan_slots[0]
        khz = slot["meta"][:, 12] & 0x1F
        rates = tuple(int((khz == k).sum()) for k in (8, 12, 16))
        seen.setdefault(args, set()).add((slot["upload_words"], rates))
        return real(*args)

    dec._mixed_plan_serving_step = spy
    got = cs.serve_mixed_steps(dec, steps)
    assert dec.plan_fallbacks == 0
    shared = [v for v in seen.values() if len({w for w, _ in v}) > 1 and len({r for _, r in v}) > 1]
    assert shared, seen
    cpu = BatchedOpusDecoder(6, 2, transfer="plan", silk_transfer="internal", device="cpu")
    want = cs.serve_mixed_steps(cpu, [pk[:6] for pk in steps])
    assert float(np.abs(got["pcm"] - want["pcm"]).max()) < 1e-4
    assert got["ranges"] == want["ranges"]
