"""Two loss gates of the reference's mixed serving loop, held on the port's
BatchedOpusDecoder against the JAX BatchedOpusDecoder on the same packets,
on the CPU.

* A corrupt or truncated packet on one stream harms that stream only
  (the port of tests/test_mixed_plan.py:387), on the plan and p10
  transfers: plane A decodes what it can of the damaged payload, as the
  reference's does, and the batch goes on.  Both streams stay within
  1e-5 of the reference's PCM, the clean neighbour also within the
  reference's own 5e-3 of the scalar decoder; final ranges and carried
  pitch are equal.
* A step where every stream is lost reuses the previous step's frame
  size, and losing the very first step raises ValueError (the port of
  tests/test_opus_plc.py:87), through decode_frames and through serve()
  on both transfers.  In serve() a CELT stream's first lost frames are
  concealed on the device (the whole-batch variant: every stream is
  flagged), so it is held to 1e-3 from its first loss on (the device
  conceal's gate, tests/test_torch_opus.py).

* Random-byte payloads through the port's BatchedCeltDecoder decode or
  raise ValueError, never crash or hang (the port of
  tests/test_native.py:277), through decode_frames and through serve()
  with losses on the p10 and plan transfers.
* The packed mixed path's device pitch conceal under isolated, double and
  6-frame burst losses holds the reference's conformance gate against the
  scalar CELT decoder (the port of tests/test_mixed_plan.py:416).

Packets come from libopus (the reference's oracle encoders).
"""

from __future__ import annotations

import numpy as np
import pytest

F, NF = 960, 8
PCM_TOL = 1e-5
PLC_PCM_TOL = 1e-3
SCALAR_TOL = 5e-3  # the reference's gate for the clean neighbour


def _oracle():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _celt_packets(nf: int) -> list:
    """96 kbps stereo CELT of two tones and noise (the reference test's
    music)."""
    oracle = _oracle()
    rng = np.random.default_rng(5)
    t = np.arange(F * nf) / 48000
    music = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1763 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    m2 = np.stack([music, np.roll(music, 7) * 0.8], -1).astype(np.float32)
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    enc.ctl(oracle.SET_BITRATE, 96000)
    return [enc.encode_float(np.ascontiguousarray(m2[f * F : (f + 1) * F]).ravel(), F)
            for f in range(nf)]


def _silk_packets(nf: int) -> list:
    """SILK WB 24 kbps mono of a pulse-train voice (the reference test's)."""
    oracle = _oracle()
    rng = np.random.default_rng(3)
    t = np.arange(F * nf) / 48000
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    v = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    enc = oracle.Encoder(48000, 1)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    enc.ctl(oracle.SET_BITRATE, 24000)
    enc.ctl(oracle.SET_MAX_BANDWIDTH, 1103)
    return [enc.encode_float(v[f * F : (f + 1) * F], F) for f in range(nf)]


def _decoders(transfer: str, batch: int = 2):
    """(the JAX decoder, the port's on the CPU), 48 kHz SILK transfer."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return JaxDecoder(batch, 2, transfer=transfer), BatchedOpusDecoder(
        batch, 2, transfer=transfer, device="cpu")


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_corrupt_stream_conceals_only_itself(transfer):
    """Stream 1 gets garbage after its ToC at step 3 and a payload cut to
    one byte at step 5; stream 0 is clean throughout."""
    from opus_tpu import Decoder

    pkts = _celt_packets(NF)
    scalar = Decoder()
    refs = [np.asarray(scalar.decode_float(p, F)).reshape(F, 2) for p in pkts]
    ref, port = _decoders(transfer)
    for f in range(NF):
        row = [pkts[f], pkts[f]]
        if f == 3:
            row[1] = pkts[f][:1] + bytes([0xFF] * 4) + pkts[f][5:]
        if f == 5:
            row[1] = pkts[f][:2]
        ref.serve([row])
        port.serve([row])
        got, want = port._serve_ring.numpy(), np.asarray(ref._serve_ring)
        assert got.shape == want.shape == (2, F, 2) and np.isfinite(got).all()
        assert float(np.abs(got[0] - want[0]).max()) < PCM_TOL, f
        assert float(np.abs(got[0] - refs[f]).max()) < SCALAR_TOL, f
        err1 = float(np.abs(got[1] - want[1]).max())
        assert err1 < PCM_TOL, (f, err1)
        if f >= 3:  # the damage shows on stream 1 only
            assert float(np.abs(got[1] - got[0]).max()) > 0.1, f
    assert port.final_ranges() == ref.final_ranges()
    assert port.plan_fallbacks == 0
    np.testing.assert_array_equal(port._serve_plc_pitch.numpy(),
                                  np.asarray(ref._serve_plc_pitch))


def test_all_streams_lost_step_decode_frames():
    """decode_frames: an all-lost first step raises; later all-lost steps
    conceal at the previous frame size, equal to the JAX decoder's and to
    the scalar decoder's within 1e-6 (the reference's gate)."""
    from opus_tpu import Decoder

    pkts = _silk_packets(4)
    steps = [pkts[0], None, None, pkts[3]]
    scalar = Decoder()
    want = np.stack([np.asarray(scalar.decode_float(s, F)).reshape(F, 2) for s in steps])
    ref, port = _decoders("p10")
    with pytest.raises(ValueError):
        _decoders("p10")[1].decode_frames([None, None])
    for f, s in enumerate(steps):
        got = port.decode_frames([s] * 2)
        jax_pcm = np.asarray(ref.decode_frames([s] * 2))
        assert got.shape == jax_pcm.shape == (2, F, 2)
        assert float(np.abs(got - jax_pcm).max()) < PCM_TOL, f
        assert float(np.abs(got[0] - want[f]).max()) < 1e-6, f
    assert port.final_ranges() == ref.final_ranges()


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_all_streams_lost_step_serve(transfer):
    """serve() on a SILK and a CELT stream: a first call whose every
    packet is lost raises, and so does a first step with every packet
    lost ahead of a good one; after good steps, all-lost steps (one per
    call, then two inside one call) serve at their frame size, equal to
    the JAX loop, with equal final ranges and carried pitch."""
    silk, celt = _silk_packets(7), _celt_packets(7)
    row = [[silk[f], celt[f]] for f in range(7)]
    _, fresh = _decoders(transfer)
    with pytest.raises(ValueError):
        fresh.serve([[None, None]])
    with pytest.raises(ValueError):
        fresh.serve([[None, None], row[0]])
    ref, port = _decoders(transfer)
    variants = []  # the concealment variant of each of the port's steps
    for attr in ("_mixed_plan_serving_step", "_mixed_serving_step"):
        def spy(*args, _real=getattr(port, attr)):
            variants.append(args[-1])  # with_plc is the last argument of both
            return _real(*args)

        setattr(port, attr, spy)
    lost = [None, None]
    for f, calls in enumerate(([row[0]], [row[1]], [lost], [lost, lost], [row[5]], [row[6]])):
        ref.serve(calls)
        port.serve(calls)
        got, want = port._serve_ring.numpy(), np.asarray(ref._serve_ring)
        assert got.shape == want.shape == (2, F, 2) and np.isfinite(got).all()
        assert float(np.abs(got[0] - want[0]).max()) < PCM_TOL, f
        assert float(np.abs(got[1] - want[1]).max()) < (PCM_TOL if f < 2 else PLC_PCM_TOL), f
    # the first all-lost step concealed the whole batch on the device
    assert variants[:3] == [False, False, True], variants
    assert port.final_ranges() == ref.final_ranges()
    np.testing.assert_array_equal(port._serve_plc_pitch.numpy(),
                                  np.asarray(ref._serve_plc_pitch))


@pytest.mark.parametrize("transfer", ["p10", "plan"])
def test_batch_fuzz_robustness(transfer):
    """tests/test_native.py:277 through the port's BatchedCeltDecoder:
    random-byte payloads through decode_frames, and through serve() with
    interleaved losses on the p10 and plan transfers: each step decodes
    (the range coder saturates on corrupt data, as libopus's does) or
    raises ValueError, never crashes or hangs; what decodes is finite."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    rng = np.random.default_rng(0)
    B = 4
    d = BatchedCeltDecoder(B, 2, transfer=transfer, device="cpu")
    decoded = served = 0
    for _ in range(40):
        n = int(rng.integers(2, 200))
        payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for _ in range(B)]
        try:
            pcm = d.decode_frames(payloads, F)
        except ValueError:
            continue
        assert np.isfinite(pcm).all()
        decoded += 1
    for _ in range(8):
        n = int(rng.integers(2, 100))
        payloads = [None if rng.random() < 0.3
                    else bytes(rng.integers(0, 256, n, dtype=np.uint8)) for _ in range(B)]
        try:
            d.serve([payloads], F)
        except ValueError:
            continue
        assert bool(np.isfinite(d._serve_ring.numpy()).all())
        served += 1
    assert decoded > 0 and served > 0


def test_packed_fallback_pitch_plc_tracks_scalar():
    """tests/test_mixed_plan.py:416 through the port's BatchedOpusDecoder
    on the packed (p10) transfer: CELT losses, isolated, double and a
    6-frame burst (the pitch regime, then the noise regime), concealed on
    the device, against the scalar CeltDecoder under the same losses at
    the conformance gate (the device conceals in f32, the scalar decoder
    in f64, so near-tie pitch candidates may differ)."""
    from opus_tpu import parse_packet
    from opus_tpu.celt.decoder import CeltDecoder
    from opus_tpu.conformance import PASS_QUALITY, compare
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    oracle = _oracle()
    nf, B = 16, 2
    rng = np.random.default_rng(5)
    t = np.arange(F * nf) / 48000.0
    ph = np.cumsum(2 * np.pi * (160 + 8 * np.sin(2 * np.pi * 1.5 * t)) / 48000.0)
    sig = (0.5 * np.sin(ph) + 0.25 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
           + 0.01 * rng.standard_normal(t.size))
    pcm = np.stack([sig, np.roll(sig, 11) * 0.9], -1).astype(np.float32)
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_BITRATE, 96000)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    pkts = [enc.encode_float(pcm[i * F : (i + 1) * F].ravel(), F) for i in range(nf)]
    lose = {3, 6, 7} | set(range(9, 15))
    scal = CeltDecoder(2, 1)
    pays = [p[parse_packet(p).payload_offset :] for p in pkts]
    ref = np.concatenate([scal.decode(None if i in lose else pays[i], F) for i in range(nf)])
    dec = BatchedOpusDecoder(B, 2, transfer="p10", device="cpu")
    outs = []
    for i in range(nf):
        dec.serve([[None if i in lose else pkts[i]] * B])
        outs.append(dec._serve_ring.numpy().copy())
    ours = np.stack(outs, 1).reshape(B, nf * F, 2)
    assert np.isfinite(ours).all()
    for b in range(B):
        assert compare(ref, ours[b]) >= PASS_QUALITY
