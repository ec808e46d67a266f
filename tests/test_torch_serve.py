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
    scalar decoder does with skip_plc); the plan transfer serves no
    pitch-regime loss yet, so its run loses none."""
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


def test_plan_pitch_loss_not_served_yet():
    """A step with a pitch-regime loss (a first loss: plane A ships an
    empty plan and flags it for device concealment) raises until device
    PLC is ported."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    batches = _payloads(2, 2, lose={(1, 0)})
    dec = BatchedCeltDecoder(2, 2, transfer="plan", device="cpu")
    dec.serve(batches[:1], FRAME)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dec.serve(batches[1:], FRAME)


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
        "assert len(names) >= 14, names\n"
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
