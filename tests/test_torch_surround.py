"""RFC 7845 7.1 surround sessions through the port's multistream decoder,
on the CPU, against the benchmark's plain multistream reference.

The traffic is the benchmark's recorded libopus pool `surround71_fb_416k`
(opusbench/traffic/): 8 channels, 5 elementary streams a session, 3 of
them coupled, mapping 0 6 1 2 3 4 5 7, streams 0-3 CELT fullband and the
LFE (stream 4) CELT narrowband in every frame.  The schedule is the
cell's own (`opusbench.traffic.schedule.Schedule`, seeded sequences and
offsets).  The reference is `opusbench/reference/multistream.py`
`family_decoder`: a numpy float64 scalar decoder, independent of the
batched path, which reads every pool packet to libopus's final range.

* BatchedMultistreamDecoder(mode="celt").serve() on the plan transfer
  (one plane A call, and the same on three host shards) and on p10: each
  session's XOR of final ranges equals the reference's and libopus's at
  every step, and the PCM lies within the cell's `pcm_max_abs` (plan) of
  the reference's;
* a planted fault, every elementary stream decoded fullband as before
  each ToC's band limit was read, fails the range check;
* a stream whose bandwidth changes between steps decodes as the
  reference does from the frame that carries the change;
* an elementary packet that is not CELT-only is refused, naming its
  session and stream;
* the split, which reads a code-0 elementary packet in place, gives what
  parse_packet gives stream by stream, or raises as it does, on the pool
  and on fuzzed packets;
* serve() returns no host PCM: `_serve_ring` is [B, 960, 8] on the
  decoder's device, and the tracer's `band_limited_streams` counts one
  stream (the LFE) a session a step.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from opus_tpu_torch import trace
from opus_tpu_torch.batch.multistream_pipeline import (
    BatchedMultistreamDecoder,
    split_multistream_packet,
)
from opus_tpu_torch.errors import InvalidPacket
from opus_tpu_torch.packet import parse_packet
from opus_tpu_torch.native import frontend as fe
from opusbench.reference.multistream import family_decoder
from opusbench.traffic.schedule import Schedule

pytestmark = pytest.mark.skipif(not fe.available(), reason="native engine not built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "opusbench"
FRAME = 960
SESSIONS, STEPS = 4, 20
SEED = 2**31 + 2023
#: p10 against the reference: the packed transfer's mantissas (the plan
#: transfer is held to the cell's own limit)
P10_TOL = 4e-3


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


CONFIG = _json("configs", "surround71_fb_416k")
LAYOUT = CONFIG["layout"]
PCM_LIMIT = _json("workloads", "surround71.live")["check"]["limits"]["pcm_max_abs"]


@pytest.fixture(scope="module")
def schedule():
    return Schedule(CONFIG, {"streams": SESSIONS, "loss": 0.0}, SEED)


@pytest.fixture(scope="module")
def steps(schedule):
    return [[schedule.packet(b, t) for b in range(SESSIONS)] for t in range(STEPS)]


def _reference(steps: list) -> tuple:
    """(PCM [steps, sessions, 960, 8] float64, ranges [steps][sessions])."""
    decs = [family_decoder(LAYOUT) for _ in steps[0]]
    pcm, ranges = [], []
    for packets in steps:
        pcm.append([d.decode_float(p, FRAME) for d, p in zip(decs, packets)])
        ranges.append([d.final_range for d in decs])
    return np.asarray(pcm), ranges


@pytest.fixture(scope="module")
def reference(steps):
    return _reference(steps)


def _decoder(B: int, transfer: str = "plan") -> BatchedMultistreamDecoder:
    dec = BatchedMultistreamDecoder(B, LAYOUT["channels"], LAYOUT["streams"], LAYOUT["coupled"],
                                    LAYOUT["mapping"], "celt", device="cpu")
    dec.core.transfer = transfer
    return dec


def _serve(dec, steps: list) -> tuple:
    """Serve one step a call: (PCM [steps, B, 960, 8], ranges, digests)."""
    pcm, ranges, digests = [], [], []
    for packets in steps:
        digests.append(dec.serve([packets], FRAME))
        pcm.append(dec._serve_ring.numpy().copy())
        ranges.append(dec.final_ranges())
    return np.asarray(pcm), ranges, digests


@pytest.mark.parametrize("transfer,shards", [("plan", 1), ("plan", 3), ("p10", 1)])
def test_serve_holds_to_the_reference(monkeypatch, schedule, steps, reference, transfer,
                                      shards):
    with monkeypatch.context() as m:
        m.setattr(fe, "plan_shards", lambda batch: shards)
        dec = _decoder(SESSIONS, transfer)
    assert dec.core.native.shards == shards
    pcm, ranges, digests = _serve(dec, steps)
    want_pcm, want_ranges = reference
    assert ranges == want_ranges
    assert want_ranges == [schedule.libopus_ranges(t).tolist() for t in range(STEPS)]
    assert dec.core.plan_fallbacks == 0
    # every step but the first follows a decoded frame (the cell's check)
    err = float(np.abs(pcm[1:] - want_pcm[1:]).max())
    assert err <= (PCM_LIMIT if transfer == "plan" else P10_TOL), err
    # the LFE rows decode at CELT NB's 13 bands, the rest fullband
    want_bands = [[21] * 4 + [13]] * SESSIONS
    assert dec.core.native.end_bands.reshape(SESSIONS, 5).tolist() == want_bands
    assert all(d.shape == (2,) for d in digests)


def test_ignoring_the_band_limits_fails_the_range_check(monkeypatch, steps, reference):
    """The planted fault: every row fullband, as when each ToC's bandwidth
    was thrown away; the LFE's ranges then differ from the first step."""
    monkeypatch.setattr(fe.NativeBatchFrontEnd, "set_end_bands", lambda self, end_bands: None)
    _, ranges, _ = _serve(_decoder(SESSIONS), steps[:3])
    wrong = [[g != w for g, w in zip(got, want)] for got, want in zip(ranges, reference[1])]
    assert all(all(row) for row in wrong), wrong


def _with_lfe(packet: bytes, lfe: bytes) -> bytes:
    """The multistream packet with its last (LFE) elementary packet replaced."""
    toc, frames = split_multistream_packet(packet, LAYOUT["streams"])[-1]
    return packet[: len(packet) - 1 - len(frames[0])] + lfe


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_a_bandwidth_change_applies_from_its_frame(steps, transfer):
    """The LFE re-coded by the port's CELT encoder at a bandwidth that
    changes every step (NB, FB, WB, SWB, NB, ...): its ToC's end band
    takes effect from the frame that carries it, as in the reference."""
    bands = [(13, 19), (21, 31), (17, 23), (19, 27)]  # (end band, 20 ms mono ToC config)
    rng = np.random.default_rng(7)
    t = np.arange(FRAME * 8) / 48000.0
    sig = (0.4 * np.sin(2 * np.pi * 70.0 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)
    enc = fe.NativeCeltEncoder(1)
    switched = []
    for f in range(8):
        end, config = bands[f % 4]
        enc.end_band = end
        lfe = bytes([config << 3]) + enc.encode(sig[f * FRAME : (f + 1) * FRAME, None], 60)
        switched.append([_with_lfe(p, lfe) for p in steps[f][:2]])
    want_pcm, want_ranges = _reference(switched)
    dec = _decoder(2, transfer)
    pcm, ranges, _ = _serve(dec, switched)
    assert ranges == want_ranges
    err = float(np.abs(pcm[1:] - want_pcm[1:]).max())
    assert err <= (PCM_LIMIT if transfer == "plan" else P10_TOL), err
    got = dec.decode_frames(switched[0], FRAME)  # decode_frames reads the ToCs too
    assert got.shape == (2, FRAME, 8) and dec.core.native.end_bands[4] == 13


@pytest.mark.parametrize("config", [1, 9, 13, 15])
def test_a_packet_that_is_not_celt_only_is_refused(steps, config):
    """SILK (configs 0-11) and hybrid (12-15) elementary packets have no
    CELT-only decode: mode="celt" refuses them, naming session and stream."""
    packets = list(steps[0])
    lfe = split_multistream_packet(packets[2], LAYOUT["streams"])[-1][1][0]
    packets[2] = _with_lfe(packets[2], bytes([config << 3]) + lfe)
    dec = _decoder(SESSIONS)
    with pytest.raises(ValueError, match="session 2 stream 4: ToC config"):
        dec.serve([packets], FRAME)
    with pytest.raises(ValueError, match="session 2 stream 4: ToC config"):
        dec.decode_frames(packets, FRAME)


def test_serve_leaves_the_sessions_pcm_on_the_device_and_counts_the_lfe(steps):
    dec = _decoder(SESSIONS)
    trace.clear()
    trace.enable()
    try:
        out = dec.serve(steps[:3], FRAME)
        per_step = [trace.counters(steps=(t, t + 1))["band_limited_streams"] for t in range(3)]
        spans = trace.spans()
    finally:
        trace.disable()
        trace.clear()
    assert isinstance(out, np.ndarray) and out.shape == (2,)
    ring = dec._serve_ring
    assert tuple(ring.shape) == (SESSIONS, FRAME, 8) and ring.device == dec.device
    assert per_step == [SESSIONS] * 3
    assert [s.name for s in spans if s.parent is None] == ["split", "serve_call", "unmap"]


def _parsed(packet: bytes, streams: int):
    """The split as parse_packet reads it stream by stream: (ToC, frames)
    of each elementary packet, all but the last self-delimited."""
    out, at = [], 0
    for s in range(streams):
        parsed = parse_packet(packet[at:], s < streams - 1)
        out.append((packet[at], list(parsed.frames(packet[at:]))))
        at += parsed.packet_offset
    return out


def _either(split, packet: bytes):
    """split's answer, or the type of what it raised."""
    try:
        return split(packet, 5)
    except (InvalidPacket, IndexError) as e:
        return type(e)


def test_the_single_frame_split_is_the_general_one():
    """Every pool packet, and packets cut, padded and garbled at seeded
    places: split_multistream_packet, which reads code-0 elementary
    packets in place, answers as parse_packet does stream by stream, and
    raises where it raises."""
    from opusbench.traffic.schedule import Pool

    pool = Pool("surround71_fb_416k")
    packets = [p for seq in pool.packets[:16] for p in seq]
    for p in packets:
        split = split_multistream_packet(p, 5)
        assert split == _parsed(p, 5)
        assert all(len(frames) == 1 and not toc & 3 for toc, frames in split)
    rng = np.random.default_rng(23)
    refused = 0
    for p in packets[:400]:
        q = bytearray(p)
        kind = rng.integers(4)
        if kind == 0:
            q = q[: rng.integers(len(q))]
        elif kind == 1:
            q[rng.integers(len(q))] = rng.integers(256)
        elif kind == 2:
            q[0] |= int(rng.integers(1, 4))
        else:
            q += bytes(rng.integers(0, 256, int(rng.integers(1, 1400)), np.uint8))
        q = bytes(q)
        want = _either(_parsed, q)
        assert _either(split_multistream_packet, q) == want, (kind, q.hex())
        refused += not isinstance(want, list)
    assert refused > 50
