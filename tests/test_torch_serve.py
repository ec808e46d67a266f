"""The port's BatchedCeltDecoder against the reference's, on the CPU.

Both decoders run the same native plane A on the same payloads, so the
entropy decode is shared and final ranges must be equal; PCM differs only
by float reassociation between XLA and torch (gate 1e-5 on PCM in +-1,
against an observed ~5e-7).  Payloads come from the repo's own native
CELT encoder at 240 B per 20 ms (96 kbps stereo): a tone plus noise with
clicks at stream-dependent times, so steps mix short and long blocks.
"""

import subprocess
import sys

import numpy as np
import pytest

from opus_tpu.native.frontend import NativeBatchFrontEnd, NativeCeltEncoderBatch, available

pytestmark = pytest.mark.skipif(not available(), reason="native engine not built")

FRAME = 960
PCM_TOL = 1e-5


def _payloads(B, NF, seed=3, lose=()):
    """batches[step][stream] of CELT payloads; `lose` = (step, stream) pairs
    that arrive as None (lost packets)."""
    rng = np.random.default_rng(seed)
    t = np.arange(FRAME * NF) / 48000.0
    f0 = 440.0 * (1.0 + 0.1 * np.arange(B))[:, None]
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, t.size))
    for i in range(B):
        sig[i, 1500 + 1700 * i :: 4801] += 0.9  # clicks -> short blocks
    pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
    enc = NativeCeltEncoderBatch(B, 2)
    batches = []
    for f in range(NF):
        pay = enc.encode_batch(pcm[:, f * FRAME : (f + 1) * FRAME], 240)
        batches.append([None if (f, i) in lose else bytes(pay[i]) for i in range(B)])
    return batches


@pytest.mark.parametrize("mode", ["p10", "q14"])
def test_serve_matches_jax(mode):
    """serve() one step per call, then four steps in one call over two
    slots (slot reuse), with a loss burst on two streams, against the JAX
    serve loop.  The reference serves one step per call throughout: its
    threaded loop, on the CPU backend with two slots, can upload a slot
    after the next decode rewrote it (seen in cold processes)."""
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    batches = _payloads(B, 6, lose={(s, i) for s in (2, 3) for i in (0, 3)})
    ref = JaxDecoder(B, 2, use_native=True, transfer=mode)
    port = BatchedCeltDecoder(B, 2, transfer=mode, device="cpu")
    for calls in ([batches[0]], [batches[1]], batches[2:]):
        for packets in calls:
            dj = ref.serve([packets], FRAME)
        dt = port.serve(calls, FRAME, n_slots=2)
        want = np.asarray(ref._serve_ring)
        assert float(np.abs(port._serve_ring.numpy() - want).max()) < PCM_TOL
        assert float(np.abs(dt - dj).max()) < PCM_TOL
    assert port.final_ranges() == ref.final_ranges()


def test_decode_frames_f32_matches_jax():
    """decode_frames (f32 planes), with steps that mix short and long
    blocks (both variants run and are selected per stream)."""
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    batches = _payloads(B, 5, seed=8, lose={(2, 1)})
    ref = JaxDecoder(B, 2, use_native=True, transfer="f32")
    port = BatchedCeltDecoder(B, 2, transfer="f32", device="cpu")
    for packets in batches:
        want = np.asarray(ref.decode_frames(packets, FRAME))
        got = port.decode_frames(packets, FRAME)
        assert got.shape == want.shape == (B, FRAME, 2)
        assert float(np.abs(got - want).max()) < PCM_TOL
    assert port.final_ranges() == ref.final_ranges()


@pytest.mark.parametrize("mode", ["q14", "p10"])
def test_slots_match_frontend_layout(mode):
    """The port's own slots take the native decode at exactly the offsets
    of frontend.alloc_packed_slots: both buffers come out word-equal."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    packets = _payloads(B, 1, seed=2)[0]
    front = NativeBatchFrontEnd(B, 2)
    want = front.alloc_packed_slots(1, mode)[0]
    front.decode_batch_q15_into(packets, FRAME, want)
    port = BatchedCeltDecoder(B, 2, transfer=mode, device="cpu")
    got = port._alloc_slots(1, mode)[0]
    port.native.decode_batch_q15_into(packets, FRAME, got)
    assert np.array_equal(got["buf"], want["buf"])
    assert np.array_equal(got["host"].numpy(), want["buf"])


def test_plan_serve_matches_jax():
    """serve(transfer="plan") one step per call against the JAX plan serve
    loop on the same payloads (short and long blocks, several arena fills and
    size classes): equal final ranges, PCM within 1e-5."""
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    batches = _payloads(B, 5, seed=6)
    ref = JaxDecoder(B, 2, use_native=True, transfer="plan")
    port = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    for packets in batches:
        dj = ref.serve([packets], FRAME)
        dt = port.serve([packets], FRAME)
        want = np.asarray(ref._serve_ring)
        assert float(np.abs(port._serve_ring.numpy() - want).max()) < PCM_TOL
        assert float(np.abs(dt - dj).max()) < PCM_TOL
    assert port.final_ranges() == ref.final_ranges()


def test_plan_serve_matches_f32_decode():
    """The plan transfer against the port's own f32 path: within the
    reference's 4e-3 and at or above the conformance pass mark
    (tests/test_native.py plan conformance gate)."""
    from opus_tpu.conformance import PASS_QUALITY, compare
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    batches = _payloads(B, 6, seed=4)
    f32 = BatchedCeltDecoder(B, 2, transfer="f32", device="cpu")
    plan = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    refs, ours = [], []
    for packets in batches:
        refs.append(f32.decode_frames(packets, FRAME))
        plan.serve([packets], FRAME)
        ours.append(plan._serve_ring.numpy().copy())
    a, b = np.concatenate(refs, axis=1), np.concatenate(ours, axis=1)
    assert float(np.abs(a - b).max()) < 4e-3
    for i in range(B):
        assert compare(a[i], b[i]) >= PASS_QUALITY
    assert plan.final_ranges() == f32.final_ranges()


def test_plan_serve_overflow_falls_back_per_step():
    """A step whose plan overflows the arena ships as a q14 spectrum for
    just that step (the synthesis state is shared by both step kinds):
    the output stays within the reference's 5e-4 of the plain plan run
    and every step first tries the plan path."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B, NF = 4, 5
    batches = _payloads(B, NF, seed=7)
    ref = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    ref.serve(batches, FRAME)
    front = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    orig = front.native.decode_batch_plan_into
    calls = {"n": 0}

    def patched(packets, frame_size, slot, stream_channels=None, want_xdbg=False):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OverflowError("synthetic arena overflow")
        return orig(packets, frame_size, slot, stream_channels, want_xdbg)

    front.native.decode_batch_plan_into = patched
    front.serve(batches, FRAME)
    assert calls["n"] == NF and front.plan_fallbacks == 1
    assert float(np.abs(front._serve_ring.numpy() - ref._serve_ring.numpy()).max()) < 5e-4
    assert front.final_ranges() == ref.final_ranges()


@pytest.mark.parametrize("transfer", ["p10", "plan"])
def test_four_streams_match_scalar_decoder(transfer):
    """The port's serve loop against the scalar CeltDecoder per stream:
    equal final ranges (bit-exact entropy decode), PCM within 4e-3 and
    conformance at or above PASS_QUALITY.  The p10 run loses stream 0's
    packet in one step (plane A conceals it in the noise regime, as the
    scalar decoder does with skip_plc); the plan run loses none (its
    pitch-regime losses are held to the scalar decoder in
    test_plan_pitch_plc_matches_scalar_decoder)."""
    from opus_tpu.celt.decoder import CeltDecoder
    from opus_tpu.conformance import PASS_QUALITY, compare
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 4
    lose = {(3, 0)} if transfer == "p10" else set()
    batches = _payloads(B, 6, seed=12, lose=lose)
    port = BatchedCeltDecoder(B, 2, transfer=transfer, device="cpu")
    pcm = []
    for packets in batches:
        port.serve([packets], FRAME)
        pcm.append(port._serve_ring.numpy().copy())
    pcm = np.concatenate(pcm, axis=1)
    for i in range(B):
        dec = CeltDecoder(2, 1)
        ref = []
        for packets in batches:
            if packets[i] is None:
                dec.skip_plc = True
            ref.append(dec.decode(packets[i], FRAME))
        ref = np.concatenate(ref)
        assert port.final_ranges()[i] == dec.rng
        assert float(np.abs(pcm[i] - ref).max()) < 4e-3
        assert compare(ref, pcm[i]) >= PASS_QUALITY


# PCM gate with pitch-regime losses: the conceal is numerically touchy (a
# 1e-7 relative change of the decode memory moves a concealed frame by up
# to 3.9e-4 of its peak in the reference itself; tests/test_torch_plc.py).
PLC_PCM_TOL = 1e-3


def _serve_lossy_against_jax(B, lose, compact_k=None, NF=9, seed=9):
    """Serve one step per call through the port's and the JAX plan loop;
    return the worst PCM error over the steps after a stream's first loss
    and before it, and check ranges and the carried pitch."""
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    batches = _payloads(B, NF, seed=seed, lose=lose)
    ref = JaxDecoder(B, 2, use_native=True, transfer="plan")
    port = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    if compact_k is not None:
        ref.PLC_COMPACT_K = port.PLC_COMPACT_K = compact_k
    first = {i: min((f for f, j in lose if j == i), default=NF) for i in range(B)}
    variants = []
    for f, packets in enumerate(batches):
        meta = {}
        orig = port.native.decode_batch_plan_into

        def spy(*a, **k):
            slot = orig(*a, **k)
            meta["variant"] = port._plc_variant(a[2]["meta"])
            return slot

        port.native.decode_batch_plan_into = spy
        ref.serve([packets], FRAME)
        port.serve([packets], FRAME)
        port.native.decode_batch_plan_into = orig
        variants.append(meta["variant"])
        want = np.asarray(ref._serve_ring)
        got = port._serve_ring.numpy()
        assert np.isfinite(got).all()
        for i in range(B):
            err = float(np.abs(got[i] - want[i]).max())
            assert err < (PCM_TOL if f < first[i] else PLC_PCM_TOL), (f, i, err)
    assert port.final_ranges() == ref.final_ranges()
    np.testing.assert_array_equal(port._serve_plc_pitch.numpy(), np.asarray(ref._serve_plc_pitch))
    return variants


def test_plan_pitch_loss_matches_jax():
    """Pitch-regime losses on the plan path (plane A ships an empty plan
    flagged for device concealment) against the JAX plan serve loop, one
    step per call at B=4: an isolated first loss (stream 0), a two-frame
    loss (stream 1, a continued loss) and a six-frame burst (stream 2: five
    pitch-regime frames, then the noise regime).  Equal final ranges and
    carried pitch, PCM within 1e-3 (1e-5 before a stream's first loss).
    B=4 is at most the compact capacity, so every lossy step conceals the
    whole batch."""
    lose = {(2, 0), (2, 1), (3, 1)} | {(f, 2) for f in range(1, 7)}
    variants = _serve_lossy_against_jax(4, lose)
    assert variants == [False, True, True, True, True, True, False, False, False]


def test_plan_pitch_loss_compact_matches_jax():
    """B=8 with the compact capacity set to 2 on both decoders: steps with
    one or two losses conceal a 2-row sub-batch (with a padding row when
    one), the step with four conceals the whole batch."""
    lose = {(2, 0), (2, 1), (3, 1), (3, 2), (3, 3), (3, 4), (4, 5), (5, 5), (5, 6)}
    variants = _serve_lossy_against_jax(8, lose, compact_k=2, NF=7)
    assert variants == [False, False, 2, True, 2, 2, False]


def test_plan_pitch_plc_matches_scalar_decoder():
    """The port of tests/test_native.py's device-PLC conformance test:
    libopus-encoded harmonic CELT at 96 kbps, losses {3, 6, 7} and a
    six-frame burst 9-14 (crossing into the noise regime), B=3, against
    the scalar CeltDecoder under the same losses: conformance at or above
    PASS_QUALITY (f32 on the device vs the scalar's f64: near-tie pitch
    candidates may differ, and both are legal concealments)."""
    from opus_tpu import oracle, parse_packet
    from opus_tpu.celt.decoder import CeltDecoder
    from opus_tpu.conformance import PASS_QUALITY, compare
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    if not oracle.available():
        pytest.skip("libopus not present")
    F, NF, B = 960, 16, 3
    rng = np.random.default_rng(5)
    t = np.arange(F * NF) / 48000.0
    ph = np.cumsum(2 * np.pi * (160 + 8 * np.sin(2 * np.pi * 1.5 * t)) / 48000.0)
    sig = (0.5 * np.sin(ph) + 0.25 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
           + 0.01 * rng.standard_normal(t.size))
    pcm = np.stack([sig, np.roll(sig, 11) * 0.9], -1).astype(np.float32)
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_BITRATE, 96000)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    pays = []
    for i in range(NF):
        p = enc.encode_float(pcm[i * F : (i + 1) * F].ravel(), F)
        pays.append(p[parse_packet(p).payload_offset :])
    lose = {3, 6, 7} | set(range(9, 15))
    scal = CeltDecoder(2, 1)
    ref = np.concatenate([scal.decode(None if i in lose else pays[i], F) for i in range(NF)])
    front = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    outs = []
    for i in range(NF):
        front.serve([[None if i in lose else pays[i]] * B], F)
        outs.append(front._serve_ring.numpy().copy())
    ours = np.stack(outs, 1).reshape(B, NF * F, 2)
    for b in range(B):
        assert compare(ref, ours[b]) >= PASS_QUALITY


def test_port_imports_no_jax():
    """Every module of opus_tpu_torch imports without pulling in jax (the
    machine with the card has none) or any module of opus_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import opus_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(opus_tpu_torch.__path__, 'opus_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'opus_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 59, names\n"
        "new = {'opus_tpu_torch.silk', 'opus_tpu_torch.silk.decoder', 'opus_tpu_torch.silk.nlsf',\n"
        "       'opus_tpu_torch.batch.silk_pipeline', 'opus_tpu_torch.dsp.silk_synthesis',\n"
        "       'opus_tpu_torch.batch.multistream_pipeline', 'opus_tpu_torch.celt.encoder',\n"
        "       'opus_tpu_torch.celt.energy_encode', 'opus_tpu_torch.celt.plan_encoder',\n"
        "       'opus_tpu_torch.dsp.encode_exec', 'opus_tpu_torch.dsp.pvq_search',\n"
        "       'opus_tpu_torch.batch.encode_pipeline', 'opus_tpu_torch.mesh',\n"
        "       'opus_tpu_torch.batch.sharded', 'opus_tpu_torch.dryrun',\n"
        "       'opus_tpu_torch.dsp.graphs', 'opus_tpu_torch.oracle',\n"
        "       'opus_tpu_torch.bench'}\n"
        "assert new <= set(names), new - set(names)\n"
    )
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_nothing_of_the_reference():
    """chip_smoke.py runs where jax and the reference cannot: no import in
    it, at any depth, names jax or opus_tpu."""
    import ast
    import pathlib

    src = (pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py").read_text()
    names = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    roots = {n.split(".")[0] for n in names}
    assert "opus_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "opus_tpu", ""}, sorted(names)
