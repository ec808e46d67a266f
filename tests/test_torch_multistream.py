"""The port's BatchedMultistreamDecoder against libopus and the JAX
package, on the CPU.

* The reference's multistream gates through the port, with libopus
  (opus_tpu.oracle) as they use it: tests/test_native.py:77 (CELT
  sessions, final ranges equal and PCM < 1e-5 of libopus; p10 serve()
  within 2e-3 of decode_frames), :424 (40 ms code-3 CELT packets < 1e-5,
  SILK sessions on the mixed-mode core < 1e-4) and :676 (the plan
  transfer, coupled and mono elementary streams, < 4e-3).  The first
  also holds the port to the JAX BatchedMultistreamDecoder on the same
  packets (< 1e-5).
* split_multistream_packet and the self-delimited parse_packet equal the
  reference's on real and fuzzed packets.
* The committed traffic fixture (tools/make_multistream_traffic.py) has
  the shape its generator describes, and the port reproduces libopus's
  recorded final range of every packet.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "multistream_traffic.npz"
PCM_TOL = 1e-5  # vs libopus and vs the JAX decoder (tests/test_native.py:77)
SERVE_TOL = 2e-3  # p10 serve() vs decode_frames (the packed transfer's precision)
SILK_TOL = 1e-4  # SILK sessions vs libopus (tests/test_native.py:424)
PLAN_TOL = 4e-3  # plan serve() vs libopus (tests/test_native.py:676)


def _oracle():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _msd(*args, **kw):
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    return BatchedMultistreamDecoder(*args, device="cpu", **kw)


def test_batched_multistream_vs_libopus():
    """tests/test_native.py:77 through the port, and the port against the
    JAX BatchedMultistreamDecoder on the same packets."""
    from opus_tpu.batch.multistream_pipeline import BatchedMultistreamDecoder as JaxDecoder

    oracle = _oracle()
    B, streams, coupled, ch = 3, 6, 2, 8
    mapping = list(range(8))
    encs, refs = [], []
    for _ in range(B):
        e = oracle.MultistreamEncoder(48000, ch, streams, coupled, mapping)
        e.ctl(oracle.SET_BITRATE, 384000)
        e.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
        encs.append(e)
        refs.append(oracle.MultistreamDecoder(48000, ch, streams, coupled, mapping))
    frame, nf = 960, 3
    t = np.arange(frame * nf) / 48000
    rng = np.random.default_rng(5)
    bmd = _msd(B, ch, streams, coupled, mapping)
    jax_bmd = JaxDecoder(B, ch, streams, coupled, mapping)
    all_steps, all_outs = [], []
    for f in range(nf):
        pkts = []
        for b in range(B):
            pcm = np.stack(
                [0.3 * np.sin(2 * np.pi * (200 + 60 * k + 15 * b) * t[f * frame : (f + 1) * frame])
                 + 0.02 * rng.standard_normal(frame) for k in range(ch)], -1).astype(np.float32)
            pkts.append(encs[b].encode_float(pcm.ravel(), frame))
        out = bmd.decode_frames(pkts, frame)
        assert out.shape == (B, frame, ch)
        frs = bmd.final_ranges()
        for b in range(B):
            r = np.asarray(refs[b].decode_float(pkts[b], frame)).reshape(frame, ch)
            assert frs[b] == refs[b].final_range
            assert float(np.abs(out[b] - r).max()) < PCM_TOL
        want = jax_bmd.decode_frames(pkts, frame)
        assert float(np.abs(out - want).max()) < PCM_TOL, f
        assert frs == jax_bmd.final_ranges()
        all_steps.append(pkts)
        all_outs.append(out)
    # p10 serve() of the same steps: equal ranges, within the packed
    # transfer's precision of decode_frames; the transfer set on the core
    # after construction, as the reference's gate does
    bmd2 = _msd(B, ch, streams, coupled, mapping)
    bmd2.core.transfer = "p10"
    bmd2.serve(all_steps, frame)
    got = bmd2._serve_ring.numpy()
    assert got.shape == (B, frame, ch)
    assert bmd2.final_ranges() == frs
    assert float(np.abs(got - all_outs[-1]).max()) < SERVE_TOL


def test_multistream_multiframe_and_silk_sessions():
    """tests/test_native.py:424 through the port: 40 ms code-3 CELT
    packets (two 20 ms frames per elementary stream) and SILK elementary
    streams on the mixed-mode core, against libopus."""
    oracle = _oracle()
    rng = np.random.default_rng(9)

    B, streams, coupled, ch = 2, 3, 1, 4
    mapping = [0, 1, 2, 3]
    encs = [oracle.MultistreamEncoder(48000, ch, streams, coupled, mapping) for _ in range(B)]
    refs = [oracle.MultistreamDecoder(48000, ch, streams, coupled, mapping) for _ in range(B)]
    for e in encs:
        e.ctl(oracle.SET_BITRATE, 256000)
        e.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    bmd = _msd(B, ch, streams, coupled, mapping)
    frame, dur = 960, 1920
    t = np.arange(dur * 2) / 48000
    for f in range(2):
        pkts = []
        for b in range(B):
            pcm = np.stack(
                [0.3 * np.sin(2 * np.pi * (180 + 70 * k + 11 * b) * t[f * dur : (f + 1) * dur])
                 + 0.02 * rng.standard_normal(dur) for k in range(ch)], -1).astype(np.float32)
            pkts.append(encs[b].encode_float(pcm.ravel(), dur))
        out = bmd.decode_frames(pkts, frame)
        assert out.shape == (B, dur, ch)
        for b in range(B):
            r = np.asarray(refs[b].decode_float(pkts[b], dur)).reshape(dur, ch)
            assert bmd.final_ranges()[b] == refs[b].final_range
            assert float(np.abs(out[b] - r).max()) < PCM_TOL

    B2, streams2, coupled2, ch2 = 2, 2, 1, 3
    mapping2 = [0, 1, 2]
    encs2 = [oracle.MultistreamEncoder(48000, ch2, streams2, coupled2, mapping2,
                                       application=oracle.APPLICATION_VOIP) for _ in range(B2)]
    refs2 = [oracle.MultistreamDecoder(48000, ch2, streams2, coupled2, mapping2)
             for _ in range(B2)]
    for e in encs2:
        e.ctl(oracle.SET_BITRATE, 48000)
        e.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
        e.ctl(oracle.SET_MAX_BANDWIDTH, 1103)
    bms = _msd(B2, ch2, streams2, coupled2, mapping2, mode="opus")
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    for f in range(3):
        pkts = []
        for b in range(B2):
            pcm = np.stack([np.roll(voice, 17 * k + 5 * b)[f * frame : (f + 1) * frame]
                            for k in range(ch2)], -1).astype(np.float32)
            pkts.append(encs2[b].encode_float(pcm.ravel(), frame))
        out = bms.decode_frames(pkts, frame)
        for b in range(B2):
            r = np.asarray(refs2[b].decode_float(pkts[b], frame)).reshape(frame, ch2)
            assert bms.final_ranges()[b] == refs2[b].final_range
            assert float(np.abs(out[b] - r).max()) < SILK_TOL, (f, b)


def test_batched_multistream_plan_transfer():
    """tests/test_native.py:676 through the port: 8-channel sessions (5
    streams, 3 coupled) on the plan transfer, against libopus."""
    oracle = _oracle()
    B, streams, coupled, ch, FRAME = 3, 5, 3, 8, 960
    mapping = list(range(ch))
    enc = oracle.MultistreamEncoder(48000, ch, streams, coupled, mapping)
    enc.ctl(oracle.SET_BITRATE, 256000)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    rng = np.random.default_rng(1)
    t = np.arange(FRAME * 4) / 48000.0
    steps = []
    for f in range(4):
        pcm = np.stack(
            [0.3 * np.sin(2 * np.pi * (200 + 60 * k) * t[f * FRAME : (f + 1) * FRAME])
             + 0.02 * rng.standard_normal(FRAME) for k in range(ch)], -1).astype(np.float32)
        steps.append([enc.encode_float(pcm.ravel(), FRAME)] * B)
    ref = oracle.MultistreamDecoder(48000, ch, streams, coupled, mapping)
    refs = [np.asarray(ref.decode_float(steps[f][0], FRAME)).reshape(FRAME, ch)
            for f in range(4)]
    bmd = _msd(B, ch, streams, coupled, mapping)
    bmd.core.transfer = "plan"
    bmd.serve(steps, FRAME)
    out = bmd._serve_ring.numpy()
    assert out.shape == (B, FRAME, ch)
    assert float(np.abs(out[0] - refs[-1]).max()) < PLAN_TOL
    assert bmd.core.plan_fallbacks == 0
    assert bmd.final_ranges() == [ref.final_range] * B


def _fixture():
    data = np.load(FIXTURE, allow_pickle=False)
    return {k: data[k] for k in data.files}


def _sessions(data: dict, group: str) -> list[list[bytes]]:
    """sessions[s][p]: the group's packets."""
    blob, lengths = data[f"{group}_packets"].tobytes(), data[f"{group}_lengths"]
    ends = np.cumsum(lengths.ravel())
    flat = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    return [flat[s * lengths.shape[1] : (s + 1) * lengths.shape[1]]
            for s in range(lengths.shape[0])]


def _packet_cases():
    """(name, packet, streams): the fixture's packets, their elementary
    streams alone, and fuzzed packets (random bytes, and real packets
    with bytes flipped or cut)."""
    data = _fixture()
    cases = []
    for group in ("ambi", "silk", "c40"):
        streams = int(data[f"{group}_layout"][1])
        for pk in (p for sess in _sessions(data, group) for p in sess[:2]):
            cases.append((group, pk, streams))
    rng = np.random.default_rng(3)
    real = [c[1] for c in cases]
    for i in range(120):
        if i % 3 == 0:
            pk = bytes(rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8))
        else:
            pk = bytearray(real[i % len(real)])
            for _ in range(int(rng.integers(1, 4))):
                pk[int(rng.integers(0, len(pk)))] = int(rng.integers(0, 256))
            if i % 3 == 2:
                pk = pk[: int(rng.integers(1, len(pk)))]
            pk = bytes(pk)
        cases.append(("fuzzed", pk, int(rng.integers(1, 6))))
    return cases


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001  (the outcome is compared, not handled)
        return type(e).__name__


@pytest.mark.parametrize("kind", ["ambi", "silk", "c40", "fuzzed"])
def test_split_and_self_delimited_parse_match_reference(kind):
    """split_multistream_packet and parse_packet (both framings) give the
    reference's result on every packet, or raise where it raises, with the
    port's one InvalidPacket (errors.InvalidPacket, an OpusError)."""
    from opus_tpu import packet as ref_packet
    from opus_tpu.batch.multistream_pipeline import split_multistream_packet as ref_split
    from opus_tpu_torch import errors, packet
    from opus_tpu_torch.batch.multistream_pipeline import split_multistream_packet

    cases = [c for c in _packet_cases() if c[0] == kind]
    assert len(cases) >= 8
    raised = 0
    for _, pk, streams in cases:
        want, got = _outcome(ref_split, pk, streams), _outcome(split_multistream_packet, pk,
                                                               streams)
        if isinstance(want, str):
            assert got == "InvalidPacket" and want == "InvalidPacket", (pk, want, got)
            raised += 1
        else:
            assert got == want, pk
        for sd in (False, True):
            want = _outcome(ref_packet.parse_packet, pk, sd)
            got = _outcome(packet.parse_packet, pk, sd)
            if isinstance(want, str):
                assert got == want == "InvalidPacket", (pk, sd)
            else:
                fields = ("toc", "frame_offsets", "frame_sizes", "payload_offset",
                          "packet_offset")
                assert [getattr(got, k) for k in fields] == [getattr(want, k) for k in fields], \
                    (pk, sd)
    if kind == "fuzzed":
        assert raised > 0
    else:
        assert raised == 0
    assert packet.InvalidPacket is errors.InvalidPacket


def test_fixture_matches_its_description():
    """tests/data/multistream_traffic.npz: the layouts and shapes that
    tools/make_multistream_traffic.py writes, and libopus's recorded final
    range of every packet reproduced by the port on the CPU (ambi on the
    plan transfer's serve(), silk through the mixed-mode core, c40's 40 ms
    packets through decode_frames)."""
    from opus_tpu_torch.batch.multistream_pipeline import split_multistream_packet

    assert FIXTURE.stat().st_size < 150_000
    data = _fixture()
    want_layouts = {"ambi": ([8, 5, 3] + list(range(8)), (8, 8), 1),
                    "silk": ([3, 2, 1, 0, 1, 2], (4, 8), 1),
                    "c40": ([4, 3, 1, 0, 1, 2, 3], (4, 4), 2)}
    for group, (layout, shape, frames) in want_layouts.items():
        assert data[f"{group}_layout"].tolist() == layout
        assert data[f"{group}_lengths"].shape == data[f"{group}_ranges"].shape == shape
        assert data[f"{group}_ranges"].dtype == np.uint32
        assert data[f"{group}_packets"].size == data[f"{group}_lengths"].sum()
        ch, streams, coupled, *mapping = layout
        sessions = _sessions(data, group)
        for pk in (p for s in sessions for p in s):
            assert {len(fr) for _, fr in split_multistream_packet(pk, streams)} == {frames}
        mode = "opus" if group == "silk" else "celt"
        bmd = _msd(shape[0], ch, streams, coupled, mapping, mode=mode)
        if group == "ambi":
            bmd.core.transfer = "plan"
        for p in range(shape[1]):
            step = [s[p] for s in sessions]
            if group == "ambi":
                bmd.serve([step], 960)
                out = bmd._serve_ring.numpy()
            else:
                out = bmd.decode_frames(step, 960)
            assert out.shape == (shape[0], 960 * frames, ch) and np.isfinite(out).all()
            assert bmd.final_ranges() == data[f"{group}_ranges"][:, p].tolist(), (group, p)
