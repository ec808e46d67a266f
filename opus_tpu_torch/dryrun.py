"""The multi-rank dry run (the port of `__graft_entry__.py:175-441`
`dryrun_multichip`).

    from opus_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(torch.cuda.device_count(), device="cuda")  # NCCL
    dryrun_multichip(2, device="cpu")                           # gloo

    dryrun_multichip(4, device="cuda", ranks_per_card=4)      # gloo, one card

Starts `world` ranks (mesh.run_ranks) laid out as the reference's mesh
(`__graft_entry__.py:180-182`): tp = 2 when the world is even and above
1, else 1, and dp = world / tp; rank r is (d, t) = divmod(r, tp)
(mesh.GridSpec).  It runs the reference's three phases on them:

* synthetic: the CELT synthesis step (lm=0, 2.5 ms frames, post-filter
  active) of a batch of 8 dp stereo streams, each rank on its dp block of
  rows and its tp share of the channels (`P("dp", "tp", None)`: a
  channels=1 step when tp = 2), the channels joined over the tp group (the
  interleave), the rows over the dp group and regrouped (sessions of 4
  stereo streams -> one 8-channel frame, each dp block its slice, as
  `regroup_local`), and the SILK synthesis step (WB voiced rows) sharded
  over dp and replicated over tp.  The regroup must be the exact
  interleave of the gathered PCM, every gathered output within 1e-5 of
  the unsharded step (a channels=1 step may sum its products in another
  order), and the tp replicas of the SILK rows equal bit for bit;
* real bitstream: 96 kbps CELT payloads of the port's native encoder
  through each rank's BatchedCeltDecoder.decode_frames_on_device (q14,
  plane A then the raw step), 4 streams a dp block, replicated over tp,
  for 3 frames: within 1e-5 of the unsharded decoder, final ranges equal,
  within 2e-3 of the scalar celt/decoder.py;
* mixed plan: 4 streams a dp block (CELT, SILK, hybrid and one switching
  CELT -> SILK; the reference serves one), replicated over tp, one loss, 2
  frames through each rank's BatchedOpusDecoder(transfer="plan"): every
  step within 1e-5 of the unsharded BatchedOpusDecoder, final ranges
  equal, the CELT streams' tails (from sample 240 on) within 2e-3 of the
  scalar CELT decoder.

The tp replicas of every served ring are equal bit for bit.  Returns rank
0's summary, with the mixed phase's packets and gathered PCM, so that a
caller with a scalar Opus decoder can hold every stream's tail to it.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (GridSpec, ShardSpec, all_gather_channels, all_gather_rows, gather_ints,
                   grid_groups, replicas_equal, run_ranks)

GROUP = 4  # multistream regroup: 4 stereo streams -> one 8-channel frame
FRAME = 960
REAL_FRAMES, MIXED_FRAMES = 3, 2
SHARD_TOL = 1e-5  # sharded vs unsharded (tests/test_mesh_serve.py:81,190)
SCALAR_TOL = 2e-3  # vs the scalar decoder, at transfer precision
STEP_REPS = 20  # calls a rank's synthetic CELT step is timed over, on the card
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


def layout(world: int) -> tuple[int, int]:
    """(dp, tp) of the reference's mesh for `world` devices
    (`__graft_entry__.py:180-181`): a stream's channels over two ranks
    when the world is even and above 1."""
    tp = 2 if world % 2 == 0 and world > 1 else 1
    return world // tp, tp


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` calls on the current card (CUDA
    events), after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grid_synthesis(grid: GridSpec, groups: tuple, lm: int, args: tuple, state: tuple, *,
                   device, frames: int = 1) -> dict:
    """`frames` CELT synthesis steps (long blocks) of this rank's block of
    a dp x tp grid: make_synthesis_step(lm, channels=C / tp) on its rows
    and channels of the whole batch's numpy inputs (`args`: x, band_log_e,
    bound, post-filter periods, gains and tapsets; `state`: decode memory
    and pre-emphasis, the per-row arrays split by rows alone), its PCM
    joined over the tp group (the channel interleave) and then over the dp
    group, frame after frame from the carried state.  Returns the local
    PCM [B / dp, frames * n, C / tp], the gathered PCM [B, frames * n, C],
    the gathers' ms, and `step`, which runs this rank's step once more
    from the carried state (for timing; its output is dropped)."""
    from .dsp.synthesis import make_synthesis_step
    from .state import synth_state_from_numpy

    dp_group, tp_group = groups
    dev = torch.device(device)
    x, loge, bound, periods, gains, tapsets = args
    rows = grid.dp_spec
    st = synth_state_from_numpy(grid.block(state[0]), grid.block(state[1]), dev)
    step = make_synthesis_step(lm, False, grid.local_channels, 1, device=dev)
    inputs = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
              for a in (grid.block(x), grid.block(loge), *map(rows.rows, (bound, periods, gains,
                                                                         tapsets)))]
    local = []
    for _ in range(frames):
        st, pcm = step(st, *inputs)
        local.append(pcm)
    local = torch.cat(local, dim=1)
    _sync(dev)
    t0 = time.perf_counter()
    interleaved = all_gather_channels(local, tp_group)
    _sync(dev)
    t1 = time.perf_counter()
    pcm = all_gather_rows(interleaved, dp_group)
    _sync(dev)
    t2 = time.perf_counter()
    return {"local": local, "interleaved": interleaved, "pcm": pcm,
            "step": lambda: step(st, *inputs),
            "tp_gather_ms": (t1 - t0) * 1e3, "dp_gather_ms": (t2 - t1) * 1e3}


def _synthetic_phase(rank: int, dp: int, tp: int, groups: tuple, dev) -> dict:
    """The reference's `_dryrun_body` on a dp x tp grid: the CELT step on
    each rank's rows and channels (lm=0, post-filter active), the channel
    interleave over tp and the regroup over dp (`regroup_local`,
    `__graft_entry__.py:229-239`), and the SILK step sharded over dp and
    replicated over tp (`P("dp")`)."""
    from .dsp.silk_synthesis import silk_synthesis_step
    from .dsp.synthesis import DECODE_BUFFER_SIZE, OVERLAP, make_synthesis_step
    from .state import synth_state_from_numpy

    dp_group, tp_group = groups
    lm, channels = 0, 2
    n = (1 << lm) * 120
    batch = GROUP * 2 * dp
    grid = GridSpec(batch, channels, dp, tp, rank)
    d = grid.coords[0]
    args = _example_args(batch, lm, channels)
    zeros = (np.zeros((batch, channels, DECODE_BUFFER_SIZE + OVERLAP), np.float32),
             np.zeros((batch, channels), np.float32))
    out = grid_synthesis(grid, groups, lm, args, zeros, device=dev)
    local, interleaved, pcm = out["local"], out["interleaved"], out["pcm"]

    # regroup_local: the dp group's whole batch, regrouped, this dp
    # block's slice of the 8-channel frames; then every block, gathered
    per = (batch // GROUP) // dp
    regrouped = (pcm.reshape(batch // GROUP, GROUP, n, channels).permute(0, 2, 1, 3)
                 .reshape(batch // GROUP, n, GROUP * channels))
    grouped = all_gather_rows(regrouped[d * per : (d + 1) * per].contiguous(), dp_group)

    step = make_synthesis_step(lm, False, channels, 1, device=dev)
    with uncounted():
        whole = step(synth_state_from_numpy(*zeros, dev),
                     *[torch.as_tensor(a).to(dev) for a in args])[1]
    if tuple(local.shape) != (batch // dp, n, channels // tp) or tuple(pcm.shape) != (
            batch, n, channels) or tuple(grouped.shape) != (batch // GROUP, n,
                                                            GROUP * channels):
        raise AssertionError(f"local pcm {tuple(local.shape)}, pcm {tuple(pcm.shape)}, "
                             f"regrouped {tuple(grouped.shape)}")
    if not (bool(torch.isfinite(pcm).all()) and bool(torch.isfinite(grouped).all())):
        raise AssertionError("the synthetic CELT step produced non-finite PCM")
    interleave = (pcm.reshape(batch // GROUP, GROUP, n, channels).permute(0, 2, 1, 3)
                  .reshape(batch // GROUP, n, GROUP * channels))
    if not torch.equal(grouped, interleave):
        raise AssertionError("the regroup is not the exact interleave of the gathered PCM")
    if not torch.equal(interleaved[..., grid.channel_start : grid.channel_stop], local):
        raise AssertionError("the channel gather moved this rank's channels")
    celt_err = _max_abs(pcm, whole)
    if not celt_err <= SHARD_TOL:
        raise AssertionError(f"sharded synthetic CELT step off the unsharded one: {celt_err}")
    celt_ms = None
    if dev.type == "cuda":
        with uncounted():
            celt_ms = device_ms(out["step"], STEP_REPS)

    sb, fs_khz = 2 * dp, 16
    sargs = _silk_args(sb, fs_khz)
    kw = dict(subfr_len=5 * fs_khz, nb_subfr=4, chunk=20)

    def silk(spec_):
        return silk_synthesis_step(*[torch.as_tensor(spec_.rows(a)).to(dev) for a in sargs],
                                   **kw)[0]

    xq_local = silk(ShardSpec(sb, dp, d))
    xq = all_gather_rows(xq_local, dp_group)
    with uncounted():
        xq_whole = silk(ShardSpec(sb, 1, 0))
    if tuple(xq.shape) != (sb, 20 * fs_khz) or not bool(torch.isfinite(xq).all()):
        raise AssertionError(f"SILK step gave {tuple(xq.shape)} or non-finite output")
    if not replicas_equal(xq_local, tp_group):
        raise AssertionError("the tp replicas of the SILK rows differ")
    silk_err = _max_abs(xq, xq_whole) / max(1.0, float(xq_whole.abs().max()))
    if not silk_err <= SHARD_TOL:
        raise AssertionError(f"sharded SILK step off the unsharded one: {silk_err} of the peak")
    return {"celt_batch": batch, "local_pcm_shape": tuple(local.shape),
            "pcm_shape": tuple(pcm.shape), "regrouped_shape": tuple(grouped.shape),
            "silk_rows": sb, "celt_err_vs_unsharded": celt_err,
            "silk_err_vs_unsharded": silk_err, "celt_step_ms": celt_ms,
            "tp_gather_ms": out["tp_gather_ms"], "dp_gather_ms": out["dp_gather_ms"]}


def _real_phase(rank: int, dp: int, tp: int, groups: tuple, dev, payloads: list) -> dict:
    """Real CELT payloads served over dp, replicated over tp."""
    from .batch.pipeline import BatchedCeltDecoder
    from .celt.decoder import CeltDecoder

    dp_group, tp_group = groups
    B = GROUP * dp
    spec = ShardSpec(B, dp, rank // tp)
    dec = BatchedCeltDecoder(spec.local, 2, transfer="q14", device=dev)
    whole = BatchedCeltDecoder(B, 2, transfer="q14", device=dev)
    scalar = CeltDecoder(2, 1)
    shard_err = scalar_err = 0.0
    same = True
    for pay in payloads:
        local = dec.decode_frames_on_device(spec.rows([pay] * B), FRAME)
        same &= replicas_equal(local, tp_group)
        got = all_gather_rows(local, dp_group)
        with uncounted():
            want = whole.decode_frames_on_device([pay] * B, FRAME)
        ref = torch.as_tensor(np.asarray(scalar.decode(pay, FRAME), np.float32)).to(dev)
        shard_err = max(shard_err, _max_abs(got, want))
        scalar_err = max(scalar_err, _max_abs(got, ref[None]))
    ranges, want_ranges = gather_ints(dec.final_ranges(), dp_group), whole.final_ranges()
    if not same:
        raise AssertionError("the tp replicas of the real-bitstream PCM differ")
    if not shard_err <= SHARD_TOL:
        raise AssertionError(f"sharded real-bitstream step off the unsharded one: {shard_err}")
    if ranges != want_ranges:
        raise AssertionError("sharded real-bitstream final ranges differ from the unsharded")
    if not scalar_err < SCALAR_TOL:
        raise AssertionError(f"sharded decode diverges from the scalar decoder: {scalar_err}")
    return {"streams": B, "frames": len(payloads), "err_vs_unsharded": shard_err,
            "err_vs_scalar": scalar_err}


def _mixed_phase(rank: int, dp: int, tp: int, groups: tuple, dev, steps: list) -> dict:
    """Mixed plan serving over dp, replicated over tp."""
    from .batch.opus_pipeline import BatchedOpusDecoder
    from .batch.sharded import gather_fallbacks, gather_final_ranges, gather_ring
    from .celt.decoder import CeltDecoder

    dp_group, tp_group = groups
    B = len(steps[0])
    spec = ShardSpec(B, dp, rank // tp)
    dec = BatchedOpusDecoder(spec.local, 2, transfer="plan", device=dev)
    whole = BatchedOpusDecoder(B, 2, transfer="plan", device=dev)
    rings, shard_err = [], 0.0
    same = True
    for packets in steps:
        dec.serve([spec.rows(packets)])
        with uncounted():
            whole.serve([packets])
        same &= replicas_equal(dec._serve_ring, tp_group)
        ring = gather_ring(dec, dp_group)
        shard_err = max(shard_err, _max_abs(ring, whole._serve_ring))
        rings.append(ring.cpu().numpy())
    ranges, want = gather_final_ranges(dec, dp_group), whole.final_ranges()
    fallbacks = gather_fallbacks(dec, dp_group)
    # the CELT streams (kind 0) against the scalar CELT decoder
    tail_err = 0.0
    for b in range(0, B, 4):
        scalar = CeltDecoder(2, 1)
        for f, packets in enumerate(steps):
            ref = np.asarray(scalar.decode(packets[b][1:], FRAME), np.float32)
            tail_err = max(tail_err, float(np.abs(rings[f][b][TAIL:] - ref[TAIL:]).max()))
    if not same:
        raise AssertionError("the tp replicas of the served rings differ")
    if not shard_err <= SHARD_TOL:
        raise AssertionError(f"sharded mixed plan serve off the unsharded one: {shard_err}")
    if ranges != want:
        raise AssertionError("sharded final ranges differ from the unsharded run's")
    if not tail_err < SCALAR_TOL:
        raise AssertionError(f"CELT streams' tails off the scalar decoder: {tail_err}")
    return {"streams": B, "frames": len(steps), "err_vs_unsharded": shard_err,
            "celt_tail_err_vs_scalar": tail_err, "plan_fallbacks": fallbacks,
            "final_ranges": ranges, "steps": steps, "rings": rings}


def kernel_wrappers() -> dict:
    """The kernel wrappers of the package by kernel name; each counts the
    launches of its kernel in `.launches` (on a CUDA tensor only)."""
    from .dsp.band_walk import band_walk
    from .dsp.plc_scan import lpc_synth, pitch_track
    from .dsp.postfilter import postfilter
    from .dsp.pvq_search import pvq_search
    from .dsp.rotation import rot_pass
    from .dsp.silk_synthesis import silk_synthesis_step

    return {"postfilter": postfilter, "rotation": rot_pass, "pitch_track": pitch_track,
            "lpc_synth": lpc_synth, "silk_synth": silk_synthesis_step, "pvq_search": pvq_search,
            "band_walk": band_walk}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are not counted: the unsharded runs a
    sharded path is held to, and timing repeats."""
    counters = kernel_wrappers()
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        yield
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


def _dryrun_rank(rank: int, world: int, dev, traffic: dict) -> dict:
    dp, tp = layout(world)
    groups = grid_groups(dp, tp)
    counters = kernel_wrappers()
    for fn in counters.values():
        fn.launches = 0
    out = {"world": world, "dp": dp, "tp": tp, "device": str(dev),
           "backend": dist.get_backend(),
           "synthetic": _synthetic_phase(rank, dp, tp, groups, dev),
           "real": _real_phase(rank, dp, tp, groups, dev, traffic["real"]),
           "mixed": _mixed_phase(rank, dp, tp, groups, dev, traffic["mixed"])}
    syn = out["synthetic"]
    mine = {"device": str(dev), "launches": {k: fn.launches for k, fn in counters.items()},
            **{k: syn[k] for k in ("celt_step_ms", "tp_gather_ms", "dp_gather_ms")}}
    return out | {"rank": mine} if rank == 0 else {"rank": mine}


def dryrun_multichip(world: int, *, device: str, ranks_per_card: int = 1) -> dict:
    """Run the three phases over `world` ranks on `device` ("cuda": rank r
    on cuda:(r // ranks_per_card), NCCL with one rank a card, gloo when
    ranks share one; "cpu": gloo), laid out as the reference's dp x tp
    mesh (`layout`); raises if a phase's gate fails on any rank.  Returns
    rank 0's summary, with `ranks`: each rank's device, kernel launches,
    CELT step ms (CUDA events, on the card) and gather ms."""
    dp, tp = layout(world)
    traffic = {"real": real_traffic(), "mixed": mixed_traffic(GROUP * dp)}
    ranks = run_ranks(_dryrun_rank, world, device=device, args=(traffic,),
                      ranks_per_card=ranks_per_card)
    out = ranks[0]
    out["ranks"] = [r["rank"] for r in ranks]
    syn, real, mixed = out["synthetic"], out["real"], out["mixed"]
    print(f"dryrun_multichip ok: {world} ranks, mesh dp={dp} tp={tp} ({out['backend']}, "
          f"{out['device']} on rank 0); "
          f"synthetic: CELT batch {syn['celt_batch']} pcm {syn['pcm_shape']} (a rank's block "
          f"{syn['local_pcm_shape']}), regrouped {syn['regrouped_shape']} via all_gather(dp) "
          f"(exact interleave), SILK rows {syn['silk_rows']}, off the unsharded step by "
          f"{syn['celt_err_vs_unsharded']} / {syn['silk_err_vs_unsharded']}; "
          f"real bitstream: {real['streams']} streams x {real['frames']} frames, "
          f"|sharded - unsharded| {real['err_vs_unsharded']}, |sharded - scalar| "
          f"{real['err_vs_scalar']}; mixed plan: {mixed['streams']} streams x "
          f"{mixed['frames']} frames, |sharded - unsharded| {mixed['err_vs_unsharded']}, CELT "
          f"tails vs scalar {mixed['celt_tail_err_vs_scalar']}, plan fallbacks "
          f"{mixed['plan_fallbacks']}; tp replicas equal")
    return out
