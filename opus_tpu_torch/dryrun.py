"""The multi-rank dry run (the port of `__graft_entry__.py:175-441`
`dryrun_multichip`).

    from opus_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(torch.cuda.device_count(), device="cuda")  # NCCL
    dryrun_multichip(2, device="cpu")                           # gloo

Starts `world` ranks (mesh.run_ranks), each serving its block of the
batch, and runs the reference's three phases on them:

* synthetic: the CELT synthesis step (lm=0, 2.5 ms frames, post-filter
  active) on each rank's rows of the reference's example inputs, the
  multistream regroup (sessions of 4 stereo streams -> one 8-channel frame)
  and the SILK synthesis step (WB voiced rows).  The gathered regroup must
  be the exact interleave of the gathered PCM, and every gathered output
  within 1e-5 of the unsharded step;
* real bitstream: 96 kbps CELT payloads of the port's native encoder
  through each rank's BatchedCeltDecoder.decode_frames_on_device (q14,
  plane A then the raw step), gathered, for 3 frames: within 1e-5 of the unsharded decoder and within 2e-3
  of the scalar celt/decoder.py;
* mixed plan: 4 streams a rank (CELT, SILK, hybrid and one switching CELT
  -> SILK), one loss, 2 frames through each rank's
  BatchedOpusDecoder(transfer="plan"):
  every step within 1e-5 of the unsharded BatchedOpusDecoder, final ranges
  equal, the CELT streams' tails (from sample 240 on) within 2e-3 of the
  scalar CELT decoder.

The reference's `tp` axis (a stream's channels over two devices) is not
ported: ranks split streams only.  Returns rank 0's summary, with the mixed
phase's packets and gathered PCM, so that a caller with a scalar Opus
decoder can hold every stream's tail to it.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import DEVICE_BACKEND, ShardSpec, all_gather_rows, run_ranks

GROUP = 4  # multistream regroup: 4 stereo streams -> one 8-channel frame
FRAME = 960
REAL_FRAMES, MIXED_FRAMES = 3, 2
SHARD_TOL = 1e-5  # sharded vs unsharded (tests/test_mesh_serve.py:81,190)
SCALAR_TOL = 2e-3  # vs the scalar decoder, at transfer precision
TAIL = 240  # the first <= 5 ms of a switch into CELT is approximate
# ToC bytes: CELT FB 20 ms stereo (config 31), SILK WB 20 ms mono (9),
# hybrid SWB 20 ms mono (13)
TOC_CELT, TOC_SILK, TOC_HYBRID = bytes([31 << 3 | 4]), bytes([9 << 3]), bytes([13 << 3])


def _example_args(batch: int, lm: int, channels: int) -> tuple:
    """The reference's `_example_args` (without the state) as numpy."""
    n = (1 << lm) * 120
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, channels, n)).astype(np.float32) * 0.1
    loge = rng.standard_normal((batch, channels, 21)).astype(np.float32)
    bound = np.full((batch,), (1 << lm) * 100, np.int32)
    periods = np.tile(np.asarray([[15, 120, 240]], np.int32), (batch, 1))
    gains = np.tile(np.asarray([[0.0, 0.1875, 0.375]], np.float32), (batch, 1))
    tapsets = np.zeros((batch, 3), np.int32)
    return x, loge, bound, periods, gains, tapsets


def _silk_args(sb: int, fs_khz: int = 16, order: int = 16) -> tuple:
    """The reference's SILK rows: WB 20 ms voiced frames at lag 80."""
    L = 20 * fs_khz
    rng = np.random.default_rng(7)
    gexc = rng.standard_normal((sb, L)).astype(np.float32) * 100.0
    a1 = rng.standard_normal((sb, order)).astype(np.float32) * 0.05
    a2 = rng.standard_normal((sb, order)).astype(np.float32) * 0.05
    b = rng.standard_normal((sb, 4, 5)).astype(np.float32) * 0.1
    head = rng.standard_normal((sb, 18 * fs_khz + 2)).astype(np.float32) * 10.0
    return (gexc, a1, a2, np.ones(sb, bool), np.full((sb, 4), 80, np.int32), b, head,
            np.zeros((sb, order), np.float32))


def real_traffic(frames: int = REAL_FRAMES) -> list[bytes]:
    """CELT payloads of one stereo stream at 96 kbps (240 B a 20 ms frame)
    from the native encoder: the reference's two-tone test signal."""
    from .native.frontend import NativeCeltEncoderBatch

    enc = NativeCeltEncoderBatch(1, 2)
    t = np.arange(FRAME * frames) / 48000.0
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1870 * t)
    pcm = np.stack([sig, 0.8 * np.roll(sig, 9)], -1).astype(np.float32)
    return [bytes(enc.encode_batch(pcm[None, f * FRAME : (f + 1) * FRAME], 240)[0])
            for f in range(frames)]


def mixed_traffic(batch: int, frames: int = MIXED_FRAMES) -> list[list]:
    """steps[frame][stream] of whole Opus packets: stream b of kind b % 4,
    CELT stereo at 96 kbps, SILK WB mono at 60 B, hybrid SWB mono at 160 B,
    and a switching stream (a CELT stereo frame at 64 kbps, then SILK
    frames of another encoder, as the reference builds it).  Stream 1 loses
    frame 1 (a SILK loss, concealed in plane A)."""
    from .native.frontend import NativeCeltEncoderBatch, NativeHybridEncoderBatch
    from .native.frontend import NativeSilkEncoderBatch

    rng = np.random.default_rng(3)
    t48 = np.arange(FRAME * frames) / 48000.0
    music = 0.4 * np.sin(2 * np.pi * 440 * t48) + 0.2 * np.sin(2 * np.pi * 1763 * t48)
    m2 = np.stack([music, 0.8 * np.roll(music, 7)], -1).astype(np.float32)

    def voice(rate):
        t = np.arange(rate // 50 * frames) / rate
        return 0.3 * np.sign(np.sin(2 * np.pi * 140 * t)) + 0.02 * rng.standard_normal(t.size)

    v16 = np.round(voice(16000) * 32767).astype(np.int16)
    v48 = voice(48000).astype(np.float32)
    celt96, celt64 = NativeCeltEncoderBatch(1, 2), NativeCeltEncoderBatch(1, 2)
    silk, silk_sw = NativeSilkEncoderBatch(1, 16), NativeSilkEncoderBatch(1, 16)
    hybrid = NativeHybridEncoderBatch(1)
    kinds = {"m": [], "v": [], "h": [], "sw": []}
    for f in range(frames):
        m = m2[None, f * FRAME : (f + 1) * FRAME]
        v = v16[None, f * 320 : (f + 1) * 320]
        kinds["m"].append(TOC_CELT + bytes(celt96.encode_batch(m, 240)[0]))
        pay, n = silk.encode_batch(v, 60)
        kinds["v"].append(TOC_SILK + bytes(pay[0, : n[0]]))
        pay, n = hybrid.encode_batch(v48[None, f * FRAME : (f + 1) * FRAME], 160)
        kinds["h"].append(TOC_HYBRID + bytes(pay[0, : n[0]]))
        if f == 0:
            kinds["sw"].append(TOC_CELT + bytes(celt64.encode_batch(m, 160)[0]))
        else:
            pay, n = silk_sw.encode_batch(v, 60)
            kinds["sw"].append(TOC_SILK + bytes(pay[0, : n[0]]))
    order = ("m", "v", "h", "sw")
    return [[None if (f, b) == (1, 1) else kinds[order[b % 4]][f] for b in range(batch)]
            for f in range(frames)]


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _synthetic_phase(rank: int, world: int, dev) -> dict:
    from .dsp.silk_synthesis import silk_synthesis_step
    from .dsp.synthesis import DECODE_BUFFER_SIZE, OVERLAP, make_synthesis_step
    from .state import synth_state_from_numpy

    lm, channels = 0, 2
    n = (1 << lm) * 120
    batch = GROUP * 2 * world
    spec = ShardSpec(batch, world, rank)
    args = _example_args(batch, lm, channels)
    step = make_synthesis_step(lm, False, channels, 1, device=dev)
    zeros = (np.zeros((batch, channels, DECODE_BUFFER_SIZE + OVERLAP), np.float32),
             np.zeros((batch, channels), np.float32))

    def celt(spec_):
        state = synth_state_from_numpy(*[spec_.rows(z) for z in zeros], dev)
        return step(state, *[torch.as_tensor(spec_.rows(a)).to(dev) for a in args])[1]

    pcm_local = celt(spec)
    grouped_local = (pcm_local.reshape(spec.local // GROUP, GROUP, n, channels)
                     .permute(0, 2, 1, 3).reshape(spec.local // GROUP, n, GROUP * channels))
    pcm, grouped = all_gather_rows(pcm_local), all_gather_rows(grouped_local)
    whole = celt(ShardSpec(batch, 1, 0))
    if tuple(pcm.shape) != (batch, n, channels) or tuple(grouped.shape) != (
            batch // GROUP, n, GROUP * channels):
        raise AssertionError(f"pcm {tuple(pcm.shape)}, regrouped {tuple(grouped.shape)}")
    if not (bool(torch.isfinite(pcm).all()) and bool(torch.isfinite(grouped).all())):
        raise AssertionError("the synthetic CELT step produced non-finite PCM")
    interleave = (pcm.reshape(batch // GROUP, GROUP, n, channels).permute(0, 2, 1, 3)
                  .reshape(batch // GROUP, n, GROUP * channels))
    if not torch.equal(grouped, interleave):
        raise AssertionError("the regroup is not the exact interleave of the gathered PCM")
    celt_err = _max_abs(pcm, whole)
    if not celt_err <= SHARD_TOL:
        raise AssertionError(f"sharded synthetic CELT step off the unsharded one: {celt_err}")

    sb, fs_khz = 2 * world, 16
    sargs = _silk_args(sb, fs_khz)
    kw = dict(subfr_len=5 * fs_khz, nb_subfr=4, chunk=20)

    def silk(spec_):
        return silk_synthesis_step(*[torch.as_tensor(spec_.rows(a)).to(dev) for a in sargs],
                                   **kw)[0]

    xq = all_gather_rows(silk(ShardSpec(sb, world, rank)))
    xq_whole = silk(ShardSpec(sb, 1, 0))
    if tuple(xq.shape) != (sb, 20 * fs_khz) or not bool(torch.isfinite(xq).all()):
        raise AssertionError(f"SILK step gave {tuple(xq.shape)} or non-finite output")
    silk_err = _max_abs(xq, xq_whole) / max(1.0, float(xq_whole.abs().max()))
    if not silk_err <= SHARD_TOL:
        raise AssertionError(f"sharded SILK step off the unsharded one: {silk_err} of the peak")
    return {"celt_batch": batch, "pcm_shape": tuple(pcm.shape),
            "regrouped_shape": tuple(grouped.shape), "silk_rows": sb,
            "celt_err_vs_unsharded": celt_err, "silk_err_vs_unsharded": silk_err}


def _real_phase(rank: int, world: int, dev, payloads: list) -> dict:
    from .batch.pipeline import BatchedCeltDecoder
    from .celt.decoder import CeltDecoder

    B = GROUP * world
    spec = ShardSpec(B, world, rank)
    dec = BatchedCeltDecoder(spec.local, 2, transfer="q14", device=dev)
    whole = BatchedCeltDecoder(B, 2, transfer="q14", device=dev)
    scalar = CeltDecoder(2, 1)
    shard_err = scalar_err = 0.0
    for pay in payloads:
        got = all_gather_rows(dec.decode_frames_on_device(spec.rows([pay] * B), FRAME))
        want = whole.decode_frames_on_device([pay] * B, FRAME)
        ref = torch.as_tensor(np.asarray(scalar.decode(pay, FRAME), np.float32)).to(dev)
        shard_err = max(shard_err, _max_abs(got, want))
        scalar_err = max(scalar_err, _max_abs(got, ref[None]))
    if not shard_err <= SHARD_TOL:
        raise AssertionError(f"sharded real-bitstream step off the unsharded one: {shard_err}")
    if not scalar_err < SCALAR_TOL:
        raise AssertionError(f"sharded decode diverges from the scalar decoder: {scalar_err}")
    return {"streams": B, "frames": len(payloads), "err_vs_unsharded": shard_err,
            "err_vs_scalar": scalar_err}


def _mixed_phase(rank: int, world: int, dev, steps: list) -> dict:
    from .batch.opus_pipeline import BatchedOpusDecoder
    from .batch.sharded import gather_fallbacks, gather_final_ranges, gather_ring
    from .celt.decoder import CeltDecoder

    B = len(steps[0])
    spec = ShardSpec(B, world, rank)
    dec = BatchedOpusDecoder(spec.local, 2, transfer="plan", device=dev)
    whole = BatchedOpusDecoder(B, 2, transfer="plan", device=dev)
    rings, shard_err = [], 0.0
    for packets in steps:
        dec.serve([spec.rows(packets)])
        whole.serve([packets])
        ring = gather_ring(dec)
        shard_err = max(shard_err, _max_abs(ring, whole._serve_ring))
        rings.append(ring.cpu().numpy())
    ranges, want = gather_final_ranges(dec), whole.final_ranges()
    fallbacks = gather_fallbacks(dec)
    # the CELT streams (kind 0) against the scalar CELT decoder
    tail_err = 0.0
    for b in range(0, B, 4):
        scalar = CeltDecoder(2, 1)
        for f, packets in enumerate(steps):
            ref = np.asarray(scalar.decode(packets[b][1:], FRAME), np.float32)
            tail_err = max(tail_err, float(np.abs(rings[f][b][TAIL:] - ref[TAIL:]).max()))
    if not shard_err <= SHARD_TOL:
        raise AssertionError(f"sharded mixed plan serve off the unsharded one: {shard_err}")
    if ranges != want:
        raise AssertionError("sharded final ranges differ from the unsharded run's")
    if not tail_err < SCALAR_TOL:
        raise AssertionError(f"CELT streams' tails off the scalar decoder: {tail_err}")
    return {"streams": B, "frames": len(steps), "err_vs_unsharded": shard_err,
            "celt_tail_err_vs_scalar": tail_err, "plan_fallbacks": fallbacks,
            "final_ranges": ranges, "steps": steps, "rings": rings}


def _dryrun_rank(rank: int, world: int, dev, traffic: dict) -> dict | None:
    out = {"world": world, "device": str(dev),
           "synthetic": _synthetic_phase(rank, world, dev),
           "real": _real_phase(rank, world, dev, traffic["real"]),
           "mixed": _mixed_phase(rank, world, dev, traffic["mixed"])}
    return out if rank == 0 else None


def dryrun_multichip(world: int, *, device: str) -> dict:
    """Run the three phases over `world` ranks on `device` ("cuda": NCCL,
    rank r on cuda:r; "cpu": gloo); raises if a phase's gate fails on any
    rank.  Returns rank 0's summary."""
    traffic = {"real": real_traffic(), "mixed": mixed_traffic(GROUP * world)}
    out = run_ranks(_dryrun_rank, world, device=device, args=(traffic,))[0]
    syn, real, mixed = out["synthetic"], out["real"], out["mixed"]
    print(f"dryrun_multichip ok: {world} ranks ({DEVICE_BACKEND[device]}, {out['device']} "
          f"on rank 0); "
          f"synthetic: CELT batch {syn['celt_batch']} pcm {syn['pcm_shape']}, regrouped "
          f"{syn['regrouped_shape']} (exact interleave), SILK rows {syn['silk_rows']}, off the "
          f"unsharded step by {syn['celt_err_vs_unsharded']} / {syn['silk_err_vs_unsharded']}; "
          f"real bitstream: {real['streams']} streams x {real['frames']} frames, "
          f"|sharded - unsharded| {real['err_vs_unsharded']}, |sharded - scalar| "
          f"{real['err_vs_scalar']}; mixed plan: {mixed['streams']} streams x "
          f"{mixed['frames']} frames, |sharded - unsharded| {mixed['err_vs_unsharded']}, CELT "
          f"tails vs scalar {mixed['celt_tail_err_vs_scalar']}, plan fallbacks "
          f"{mixed['plan_fallbacks']}")
    return out
