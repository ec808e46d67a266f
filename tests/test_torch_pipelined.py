"""run_pipelined of the port's two decoders, and 40/60 ms SILK-only
frames, against libopus and the JAX package on the CPU.

Ports of tests/test_opus_pipeline.py:68 (40/60 ms SILK-only
decode_frames, within 1e-6 of libopus with equal final ranges), :86
(mixed run_pipelined, within 2e-5 of libopus) and :109 (mixed serve()
equals run_pipelined: equal final ranges, within 2e-3, and the RFC 8251
quality gate); the CELT run_pipelined against the JAX one (within 1e-5,
as tests/test_torch_serve.py).  On 40/60 ms frames run_pipelined returns
the reference's raw int16 SILK region [B, frame48 * C], not
decode_frames' float PCM (a fault already in the reference, matched on
purpose).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def _libopus():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _enc(mode, bitrate, ch, max_bw=None):
    oracle = _libopus()
    e = oracle.Encoder(48000, ch)
    e.ctl(oracle.SET_FORCE_MODE, mode)
    e.ctl(oracle.SET_BITRATE, bitrate)
    if max_bw is not None:
        e.ctl(oracle.SET_MAX_BANDWIDTH, max_bw)
    return e


def _signals(nsamp, seed=9):
    """The voice and music of tests/test_opus_pipeline.py."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(nsamp)).astype(np.float32)
    music = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 2930 * t)
             + 0.05 * rng.standard_normal(nsamp)).astype(np.float32)
    return voice, music


def _port(batch: int, silk: str = "pcm48"):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(batch, 2, silk_transfer=silk, device="cpu")


def _encode_steps(cases, frame: int, nf: int) -> list:
    return [[enc.encode_float(np.ascontiguousarray(sig[f * frame : (f + 1) * frame]).ravel(),
                              frame) for enc, sig in cases] for f in range(nf)]


def test_pipelined_mixed_vs_libopus():
    """The port of tests/test_opus_pipeline.py:86: a CELT and a SILK
    stream through four steps; the last step's PCM, a device tensor,
    within 2e-5 of libopus, whose decoders ran every step."""
    oracle = _libopus()
    F, NF = 960, 4
    voice, music = _signals(F * NF)
    cases = [(_enc(oracle.MODE_CELT_ONLY, 96000, 1), music),
             (_enc(oracle.MODE_SILK_ONLY, 24000, 1, 1103), voice)]
    steps = _encode_steps(cases, F, NF)
    last = _port(2).run_pipelined(steps)
    assert isinstance(last, torch.Tensor) and last.dtype == torch.float32
    assert tuple(last.shape) == (2, F, 2)
    refs = [oracle.Decoder(48000, 2) for _ in range(2)]
    for row in steps:
        want = [np.asarray(refs[b].decode_float(row[b], F)).reshape(F, 2) for b in range(2)]
    for b in range(2):
        assert float(np.abs(last.numpy()[b] - want[b]).max()) < 2e-5, b


def test_mixed_serve_matches_run_pipelined():
    """The port of tests/test_opus_pipeline.py:109: CELT, SILK and hybrid
    rows, five steps run_pipelined one per call against the p10 serve loop
    in one call: equal final ranges, the last frame within 2e-3 and of
    conformant quality."""
    from opus_tpu.conformance import PASS_QUALITY, compare

    oracle = _libopus()
    F, NF = 960, 5
    voice, music = _signals(F * NF)
    voice2 = np.stack([voice, np.roll(voice, 13) * 0.7], -1)
    music2 = np.stack([music, np.roll(music, 7) * 0.8], -1)
    cases = [(_enc(oracle.MODE_CELT_ONLY, 96000, 2), music2),
             (_enc(oracle.MODE_SILK_ONLY, 24000, 1, 1103), voice[:, None]),
             (_enc(oracle.MODE_HYBRID, 64000, 2), voice2),
             (_enc(oracle.MODE_SILK_ONLY, 40000, 2, 1103), voice2)]
    steps = _encode_steps(cases, F, NF)
    ref = _port(4)
    outs = [ref.run_pipelined([row]).numpy() for row in steps]
    srv = _port(4)
    srv.serve(steps)
    got = srv._serve_ring.numpy()
    assert srv.final_ranges() == ref.final_ranges()
    assert float(np.abs(got - outs[-1]).max()) < 2e-3
    for b in range(4):
        assert compare(outs[-1][b], got[b]) >= PASS_QUALITY, b


def test_mixed_run_pipelined_matches_jax():
    """A CELT, a SILK and a hybrid stream through both packages'
    run_pipelined in one call of five steps: the last step within 1e-5,
    equal final ranges."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder

    oracle = _libopus()
    F, NF = 960, 5
    voice, music = _signals(F * NF, seed=3)
    cases = [(_enc(oracle.MODE_CELT_ONLY, 96000, 1), music),
             (_enc(oracle.MODE_SILK_ONLY, 24000, 1, 1103), voice),
             (_enc(oracle.MODE_HYBRID, 40000, 1), voice)]
    steps = _encode_steps(cases, F, NF)
    ref, port = JaxDecoder(3, 2), _port(3)
    want = np.asarray(ref.run_pipelined(steps))
    got = port.run_pipelined(steps).numpy()
    assert got.shape == want.shape == (3, F, 2)
    assert float(np.abs(got - want).max()) < 1e-5
    assert port.final_ranges() == ref.final_ranges()


def _celt_payloads(B: int, nf: int, F: int) -> list:
    """CELT payloads (no ToC) from the port's native encoder at 240 B per
    20 ms: tones, noise and clicks at stream-dependent times (short
    blocks); stream 2 loses step 3."""
    from opus_tpu_torch.native.frontend import NativeCeltEncoderBatch

    rng = np.random.default_rng(8)
    t = np.arange(F * nf) / 48000.0
    sig = (0.4 * np.sin(2 * np.pi * 440.0 * (1.0 + 0.1 * np.arange(B))[:, None] * t)
           + 0.05 * rng.standard_normal((B, t.size)))
    for i in range(B):
        sig[i, 1500 + 1700 * i :: 4801] += 0.9
    pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
    enc = NativeCeltEncoderBatch(B, 2)
    out = []
    for f in range(nf):
        pay = enc.encode_batch(pcm[:, f * F : (f + 1) * F], 240)
        out.append([None if (f, i) == (3, 2) else bytes(pay[i]) for i in range(B)])
    return out


def test_celt_run_pipelined_matches_jax():
    """BatchedCeltDecoder.run_pipelined (f32 planes, steps mixing short
    and long blocks, a lost packet) against the JAX one: the last step
    within 1e-5, equal final ranges; a run of one step equals
    decode_frames."""
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B, F = 4, 960
    batches = _celt_payloads(B, 5, F)
    ref = JaxDecoder(B, 2, use_native=True, transfer="f32")
    port = BatchedCeltDecoder(B, 2, transfer="f32", device="cpu")
    want = np.asarray(ref.run_pipelined(batches, F))
    got = port.run_pipelined(batches, F)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (B, F, 2)
    assert float(np.abs(got.numpy() - want).max()) < 1e-5
    assert port.final_ranges() == ref.final_ranges()
    one, frames = (BatchedCeltDecoder(B, 2, transfer="f32", device="cpu") for _ in range(2))
    assert np.array_equal(one.run_pipelined(batches[:1], F).numpy(),
                          frames.decode_frames(batches[0], F))


@pytest.mark.parametrize("frame", [2880, 1920])
def test_silk_only_long_frames(frame):
    """The port of tests/test_opus_pipeline.py:68 at 60 and 40 ms:
    decode_frames within 1e-6 of libopus with equal final ranges; on the
    same traffic run_pipelined returns the int16 SILK region [B, frame *
    C], equal to the JAX run_pipelined's."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder

    oracle = _libopus()
    NF = 3
    voice, _ = _signals(frame * NF)
    encs = [_enc(oracle.MODE_SILK_ONLY, 20000, 1, 1103) for _ in range(4)]
    steps = [[e.encode_float(voice[f * frame : (f + 1) * frame], frame) for e in encs]
             for f in range(NF)]
    dec = _port(4)
    refs = [oracle.Decoder(48000, 2) for _ in range(4)]
    for row in steps:
        out = dec.decode_frames(row)
        assert out.shape == (4, frame, 2) and out.dtype == np.float32
        for b in range(4):
            r = np.asarray(refs[b].decode_float(row[b], frame)).reshape(frame, 2)
            assert dec.final_ranges()[b] == refs[b].final_range
            assert float(np.abs(out[b] - r).max()) < 1e-6, b
    got = _port(4).run_pipelined(steps)
    want = np.asarray(JaxDecoder(4, 2).run_pipelined(steps))
    assert got.dtype == torch.int16 and tuple(got.shape) == (4, frame * 2)
    assert want.dtype == np.int16 and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy().reshape(4, frame, 2) / np.float32(32768.0), out)


def test_run_pipelined_needs_pcm48():
    with pytest.raises(ValueError, match="pcm48"):
        _port(2, "internal").run_pipelined([[b"\x00", b"\x00"]])
