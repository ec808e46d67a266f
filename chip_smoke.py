"""End-to-end smoke run of opus_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds plane A (g++) and the CUDA kernels (nvcc, sm_90a; post-filter and
spreading rotation) from the sources in the checkout, in parallel, and
holds each kernel to its plain torch version at the serving shapes.  Then
it serves 1024 stereo 48 kHz CELT streams (20 ms frames at 96 kbps,
payloads from the port's native encoder) through both serving paths of
BatchedCeltDecoder:

* transfer="p10", 13 steps, one of them with lost packets: the post-filter
  kernel must launch on every step with an active filter;
* transfer="plan", the same 13 steps without the losses (the plan path
  does not serve pitch-regime losses yet): no step may fall back to the
  q14 spectrum, the rotation kernel must launch twice per step, the
  post-filter as on the p10 path.  The inputs of the first step's two
  rotation passes and of its post-filter call (periods and tapsets as
  the strided views of `meta` the serving core passes) are recorded, and
  each kernel is held to its plain version on those real inputs too.

Each kernel is timed three ways, on the synthetic inputs and on the
recorded ones: the wrapper's whole call, the bare library call on C
arguments converted in advance (the kernel alone), and the plain
version.  Streams 0-3 of each card run are checked against the port's
own CPU run of the same packets at B=4 (streams decode independently):
equal final ranges, PCM within 1e-4.  Prints the card's name and power
limit, those times with each kernel's bound, the serve rates end to end,
the device step times, a JSON line describing each kernel, and as its
last line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

B, C, FRAME, NBYTES = 1024, 2, 960, 240  # 240 B per 20 ms = 96 kbps
STEPS = 13
LOST_STEP = 6
W = 2048  # post-filter row: DECODE_BUFFER_SIZE samples of history + frame
PF_CASES = [(3, 12), (3, 60), (3, 120), (3, 240), (2, 60), (1, 12), (0, 12), (0, 240)]
PF_REL_TOL = 1e-6  # the reference's own gate (tests/test_pallas_pf.py)
ROT_ABS_TOL = 2e-6  # the reference's scalar gate (tests/test_pallas_rot.py)
ROT_LENGTHS = [1, 1, 2, 3, 5, 8, 21, 44, 87, 176]
CPU_PCM_TOL = 1e-4  # card run vs the port's CPU run, streams 0-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def card() -> str:
    """`name, power limit` of GPU 0 as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def best_ms(fn, reps: int, windows: int = 3) -> float:
    """The smallest of `windows` cuda_ms readings: a kernel's time, with
    any window in which the host stalled the issue left out."""
    return min(cuda_ms(fn, reps) for _ in range(windows))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate or operations
    over the float32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def build() -> None:
    """Plane A (g++) and the CUDA kernels (nvcc) at once, from the checkout."""
    from opus_tpu_torch import _build
    from opus_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    done, errors = {}, []

    def plane_a():
        try:
            native_build.build()
            done["plane A"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)

    th = threading.Thread(target=plane_a)
    th.start()
    try:
        so = _build.build()
        done["CUDA kernels"] = time.perf_counter() - t0
    finally:
        th.join()
    if errors:
        raise errors[0]
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in done.items()))
    print(so.with_suffix(".log").read_text().strip())


def cycled(make, copies: int):
    """fn() calling make(inputs) on `copies` copies in turn, so that each
    call finds its inputs outside the 50 MB L2, as the serving step does."""
    turn = iter(range(10**9))
    return lambda: make(copies[next(turn) % len(copies)])


def postfilter_inputs(lm, chunk, seed, dev):
    """Serving-shape post-filter inputs: rows 0-7 zero-gain with garbage
    lags, rows 8-15 with filter 1 equal to filter 0."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, W)).astype(np.float32) * 1000.0
    periods = rng.integers(max(15, chunk + 2), 1025, (B, 3)).astype(np.int32)
    gains = (rng.integers(0, 5, (B, 3)) * 0.09375).astype(np.float32)
    gains[:8] = 0.0
    periods[:8] = rng.integers(-5, 5000, (8, 3))
    periods[8:16, 1] = periods[8:16, 0]
    gains[8:16, 1] = gains[8:16, 0]
    tapsets = rng.integers(0, 3, (B, 3)).astype(np.int32)
    return [torch.tensor(a, device=dev) for a in (y, periods, gains, tapsets)]


def pf_bytes(periods, gains, n: int, lm: int) -> tuple[int, int]:
    """Bytes the post-filter must move for these inputs: (what the data
    needs, whole rows).  A row reads its frame and the lagged history its
    longest active lag reaches (lag + 2 back) and writes its frame; a row
    whose filters all have zero gain moves nothing.  Whole rows: every
    row of W read and its frame written, as a kernel that ignores the
    gains would."""
    nf = 2 if lm == 0 else 3
    p = np.clip(periods[:, :nf].cpu().numpy().astype(np.int64), 15, 1024)
    g = gains[:, :nf].cpu().numpy()
    longest = np.where(g != 0, p, 0).max(axis=1)
    live = (g != 0).any(axis=1)
    meta = periods.shape[0] * 9 * 4
    needed = int(np.where(live, 2 * n + longest + 2, 0).sum()) * C * 4 + meta
    whole = B * C * (W + n) * 4 + meta
    return needed, whole


def pf_row_chunks(periods, gains, lm: int) -> np.ndarray:
    """Each stream's largest safe chunk: its shortest active lag - 2
    (0 for a stream with no active filter)."""
    nf = 2 if lm == 0 else 3
    p = np.clip(periods[:, :nf].cpu().numpy().astype(np.int64), 15, 1024)
    g = gains[:, :nf].cpu().numpy()
    return np.where((g != 0).any(axis=1), np.where(g != 0, p, 10**6).min(axis=1) - 2, 0)


def bare(entry: str, prepared: list):
    """fn() calling the library's `entry` on C arguments converted in
    advance, cycling through `prepared`: the kernel alone, without the
    wrapper's checks and conversions (the return code is checked once)."""
    from opus_tpu_torch import _build

    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    if fn(*prepared[0], stream) != 0:
        raise RuntimeError(f"{entry} launch failed")
    return cycled(lambda args: fn(*args, stream), prepared)


def postfilter_times(y, hist, n, lm, periods, gains, tapsets, chunk) -> dict:
    """ms of the wrapper's whole call, of the bare kernel launch on
    arguments prepared in advance, and of the plain version; four copies
    of y (67 MB) cycle beyond the 50 MB L2."""
    from opus_tpu_torch.dsp import postfilter as pf

    ys = [y.clone() for _ in range(4)]
    prepared = [pf._kernel_args(yy, hist, n, lm, periods, gains, tapsets) for yy in ys]

    def run(fn):
        return cycled(lambda yy: fn(yy, hist, n, lm, periods, gains, tapsets, chunk), ys)

    return {"ms": best_ms(run(pf.postfilter), 40),
            "kernel_ms": best_ms(bare("opus_postfilter", prepared), 40),
            "plain_ms": cuda_ms(run(pf._postfilter_ref), 5)}


def postfilter_phase(dev, where: str) -> dict:
    """Post-filter kernel vs _postfilter_ref on the card, every case."""
    from opus_tpu_torch.dsp.postfilter import _postfilter_ref, postfilter

    max_abs = max_rel = 0.0
    times = {}
    for lm, chunk in PF_CASES:
        n = 120 << lm
        y, periods, gains, tapsets = postfilter_inputs(lm, chunk, 100 * lm + chunk, dev)
        ref = _postfilter_ref(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
        got = postfilter(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"post-filter output not finite at lm={lm} chunk={chunk}")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        print(f"kernel postfilter lm={lm} chunk={chunk}: max_abs_err={err} max_rel_err={rel}")
        if not rel < PF_REL_TOL:
            raise AssertionError(f"post-filter kernel disagrees with plain version: rel {rel} "
                                 f"at lm={lm} chunk={chunk}")
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
        if lm == 3:
            t = postfilter_times(y, W - n, n, lm, periods, gains, tapsets, chunk)
            t["bytes"] = pf_bytes(periods, gains, n, lm)
            times[chunk] = t
            print(f"time postfilter B={B} C={C} lm=3 chunk={chunk}: wrapper_ms={t['ms']} "
                  f"kernel_alone_ms={t['kernel_ms']} plain_ms={t['plain_ms']} "
                  f"bytes_needed={t['bytes'][0]} bytes_whole_rows={t['bytes'][1]} ({where})")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "times": times}


def rotation_inputs(seed: int, n2: int, dev):
    """x ~ N(0,1) [B, n2] with random chain geometry: chain lengths from
    ROT_LENGTHS, one chain in five with identity coefficients."""
    rng = np.random.default_rng(seed)
    k_pos = np.zeros((B, n2), np.int32)
    m_pos = np.ones((B, n2), np.int32)
    cc = np.ones((B, n2), np.float32)
    ss = np.zeros((B, n2), np.float32)
    for r in range(B):
        t = 0
        while t < n2:
            m = min(int(rng.choice(ROT_LENGTHS)), n2 - t)
            th = 0.5 * rng.uniform(0.1, 1.0) ** 2
            k_pos[r, t : t + m] = np.arange(m)
            m_pos[r, t : t + m] = m
            if rng.random() < 0.8:
                cc[r, t : t + m] = np.cos(0.5 * np.pi * th)
                ss[r, t : t + m] = np.cos(0.5 * np.pi * (1.0 - th))
            t += m
    x = rng.standard_normal((B, n2)).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (x, cc, ss, k_pos, m_pos)]


def rotation_times(args) -> dict:
    """ms of the wrapper's whole call, of the bare kernel launch into an
    output allocated in advance, and of the plain version; three copies
    of the five planes and the output (141 MB) cycle beyond the L2."""
    from opus_tpu_torch.dsp import rotation as rot

    sets = [[a.clone() for a in args] + [torch.empty_like(args[0])] for _ in range(3)]
    prepared = [rot._kernel_args(*a) for a in sets]
    return {"ms": best_ms(cycled(lambda a: rot.rot_pass(*a[:5]), sets), 40),
            "kernel_ms": best_ms(bare("opus_rot_pass", prepared), 40),
            "plain_ms": cuda_ms(cycled(lambda a: rot._rot_pass_ref(*a[:5]), sets), 5)}


def rotation_phase(dev, where: str) -> dict:
    """Rotation kernel vs _rot_pass_ref on the card, at the lm=3 and lm=2
    planes; times at lm=3."""
    from opus_tpu_torch.dsp.rotation import _rot_pass_ref, rot_pass

    max_abs = 0.0
    times = None
    for lm in (3, 2):
        n2 = 2 * (120 << lm)
        args = rotation_inputs(30 + lm, n2, dev)
        ref = _rot_pass_ref(*args)
        got = rot_pass(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rotation output not finite at n2={n2}")
        err = float((got - ref).abs().max())
        print(f"kernel rotation B={B} n2={n2}: max_abs_err={err}")
        if not err < ROT_ABS_TOL:
            raise AssertionError(f"rotation kernel disagrees with plain version: {err} at n2={n2}")
        max_abs = max(max_abs, err)
        if lm == 3:
            times = rotation_times(args)
            print(f"time rotation B={B} n2={n2} random chains: wrapper_ms={times['ms']} "
                  f"kernel_alone_ms={times['kernel_ms']} plain_ms={times['plain_ms']} ({where})")
    return {"max_abs_err": max_abs, "times": times}


def make_payloads(seed: int = 1) -> list:
    """batches[step][stream]: 20 ms CELT payloads from the native encoder.

    Each stream is a tone (220-880 Hz) plus noise, with a click every
    4801 samples at a stream-dependent phase so that some frames code
    short blocks.
    """
    from opus_tpu_torch.native.frontend import NativeCeltEncoderBatch

    rng = np.random.default_rng(seed)
    f0 = 220.0 * 2.0 ** ((np.arange(B) % 24) / 12.0)
    phase = rng.uniform(0, 2 * np.pi, B)
    enc = NativeCeltEncoderBatch(B, C)
    batches = []
    for f in range(STEPS):
        t = (f * FRAME + np.arange(FRAME)) / 48000.0
        sig = 0.4 * np.sin(2 * np.pi * f0[:, None] * t + phase[:, None])
        sig += 0.05 * rng.standard_normal((B, FRAME))
        pos = f * FRAME + np.arange(FRAME)
        sig += 0.9 * (((pos[None, :] + 97 * np.arange(B)[:, None]) % 4801) == 0)
        pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
        batches.append([bytes(p) for p in enc.encode_batch(pcm, NBYTES)])
    return batches


def with_losses(batches) -> list:
    """In step LOST_STEP every third stream's packet is lost."""
    return [[None if f == LOST_STEP and i % 3 == 0 else p for i, p in enumerate(pk)]
            for f, pk in enumerate(batches)]


def serve_steps(dec, batches) -> dict:
    """Serve one step per call; keep streams 0-3's PCM and each step's
    post-filter activity (from the slot the step used)."""
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    pcm, chunks = [], []
    for packets in batches:
        fallbacks = dec.plan_fallbacks
        digest = dec.serve([packets], FRAME)
        ring = dec._serve_ring
        if not bool(torch.isfinite(ring).all()) or not np.isfinite(digest).all():
            raise AssertionError("serve produced non-finite PCM")
        pcm.append(ring[:4].cpu().numpy().copy())  # the ring is rewritten in place
        if dec.transfer != "plan":
            slot = dec._slots[0]
        elif dec.plan_fallbacks > fallbacks:
            slot = dec._plan_q14_slots[(dec.plan_fallbacks - 1) % 2]
        else:
            slot = dec._plan_slots[0]
        chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
        chunks.append(chunk if active else None)
    if tuple(ring.shape) != (dec.batch, FRAME, C):
        raise AssertionError(f"serve produced {tuple(ring.shape)} PCM")
    return {"pcm": np.concatenate(pcm, axis=1), "ranges": dec.final_ranges()[:4],
            "chunks": chunks}


def same_layout(t):
    """A copy of t with t's strides (a view of `meta` stays a strided view)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def recording_inputs(captured: dict):
    """Context manager: while it is open, the main path's rotation passes
    and post-filter calls run as before, and the inputs of the first two
    rotation passes and of the first post-filter call are copied into
    captured["rotation"] and captured["postfilter"]."""
    import contextlib

    from opus_tpu_torch.dsp import plan_exec, synthesis

    real_rot, real_pf = plan_exec.rot_pass, synthesis.postfilter
    captured.update(rotation=[], postfilter=[])

    def rot(*args):
        if len(captured["rotation"]) < 2:
            captured["rotation"].append([a.clone() for a in args])
        return real_rot(*args)

    def pf(y, hist, n, lm, periods, gains, tapsets, chunk):
        if not captured["postfilter"]:
            captured["postfilter"].append(
                (y.clone(), hist, n, lm, same_layout(periods), same_layout(gains),
                 same_layout(tapsets), chunk))
        return real_pf(y, hist, n, lm, periods, gains, tapsets, chunk)

    @contextlib.contextmanager
    def patched():
        plan_exec.rot_pass, synthesis.postfilter = rot, pf
        try:
            yield
        finally:
            plan_exec.rot_pass, synthesis.postfilter = real_rot, real_pf

    return patched()


def rotation_on_real_chains(captured: list, where: str) -> dict:
    """The rotation kernel vs _rot_pass_ref on recorded main-path inputs,
    and its times there."""
    from opus_tpu_torch.dsp.rotation import _rot_pass_ref, rot_pass

    max_abs = 0.0
    times = {}
    for name, args in zip(("A", "B"), captured):
        got, ref = rot_pass(*args), _rot_pass_ref(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        heads = args[3] == 0
        chains = int(heads.sum())
        long_chains = int((heads & (args[4] >= 3)).sum())
        print(f"kernel rotation on plan step pass {name} B={B} n2={args[0].shape[1]}: "
              f"{chains} chains, {long_chains} of length >= 3, max_abs_err={err}")
        if long_chains == 0:
            raise AssertionError(f"plan step pass {name} rotated no chain of length >= 3")
        if not bool(torch.isfinite(got).all()) or not err < ROT_ABS_TOL:
            raise AssertionError(f"rotation kernel disagrees with plain version on the plan "
                                 f"step's pass {name}: {err}")
        max_abs = max(max_abs, err)
        times[name] = rotation_times(args)
        print(f"time rotation B={B} n2={args[0].shape[1]} plan step pass {name}: "
              f"wrapper_ms={times[name]['ms']} kernel_alone_ms={times[name]['kernel_ms']} "
              f"plain_ms={times[name]['plain_ms']} ({where})")
    return {"max_abs_err": max_abs, "times": times}


def postfilter_on_real_inputs(rec: tuple, where: str) -> dict:
    """The post-filter kernel vs _postfilter_ref on the first plan step's
    recorded inputs (periods and tapsets are the strided views of `meta`
    that the serving core passes), and its times there."""
    from opus_tpu_torch.dsp.postfilter import _postfilter_ref, postfilter

    y, hist, n, lm, periods, gains, tapsets, chunk = rec
    ref = _postfilter_ref(y.clone(), hist, n, lm, periods, gains, tapsets, chunk)
    got = postfilter(y.clone(), hist, n, lm, periods, gains, tapsets, chunk)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    rows = pf_row_chunks(periods, gains, lm)
    live = rows[rows > 0]
    print(f"kernel postfilter on plan step 1 B={B} lm={lm} batch chunk={chunk}: "
          f"{live.size} of {rows.size} streams active, per-stream chunk min={live.min()} "
          f"median={int(np.median(live))}, periods strides {periods.stride()}: "
          f"max_abs_err={err} max_rel_err={rel}")
    if not bool(torch.isfinite(got).all()) or not rel < PF_REL_TOL:
        raise AssertionError(f"post-filter kernel disagrees with plain version on the plan "
                             f"step's inputs: rel {rel}")
    t = postfilter_times(y, hist, n, lm, periods, gains, tapsets, chunk)
    t["bytes"] = pf_bytes(periods, gains, n, lm)
    print(f"time postfilter B={B} C={C} lm={lm} chunk={chunk} plan step 1: wrapper_ms={t['ms']} "
          f"kernel_alone_ms={t['kernel_ms']} plain_ms={t['plain_ms']} "
          f"bytes_needed={t['bytes'][0]} bytes_whole_rows={t['bytes'][1]} ({where})")
    return {"max_abs_err": err, "max_rel_err": rel, "times": t}


def main_path(dev, transfer: str, batches, where: str) -> dict:
    """Serve every step through the port at B=1024 with the launch counts
    set to 0 just before and read just after; then check streams 0-3
    against the port's CPU run of the same packets at B=4.  On the plan
    transfer no step may fall back to q14, and the rotation kernel is
    held to its plain version on the first step's recorded inputs."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.postfilter import postfilter
    from opus_tpu_torch.dsp.rotation import rot_pass

    dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
    captured = {}
    with recording_inputs(captured):
        postfilter.launches = 0
        rot_pass.launches = 0
        got = serve_steps(dec, batches)
        launches = {"postfilter": postfilter.launches, "rotation": rot_pass.launches}
    active = sum(c is not None for c in got["chunks"])
    plan_steps = len(batches) if transfer == "plan" else 0
    print(f"main path {transfer}: {len(batches)} steps, post-filter chunks {got['chunks']}, "
          f"plan fallbacks {dec.plan_fallbacks}, kernel launches {launches}")
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} of {len(batches)} plan steps fell back "
                             f"to the q14 spectrum")
    if launches["postfilter"] == 0 or launches["postfilter"] != active:
        raise AssertionError(f"post-filter kernel launched {launches['postfilter']} times over "
                             f"{active} post-filter steps")
    if launches["rotation"] != 2 * plan_steps:
        raise AssertionError(f"rotation kernel launched {launches['rotation']} times over "
                             f"{plan_steps} plan steps (2 passes each)")
    real = None
    if transfer == "plan":
        real = {"rotation": rotation_on_real_chains(captured["rotation"], where),
                "postfilter": postfilter_on_real_inputs(captured["postfilter"][0], where)}

    cpu = BatchedCeltDecoder(4, C, transfer=transfer, device="cpu")
    want = serve_steps(cpu, [pk[:4] for pk in batches])
    for i in range(4):
        err = float(np.abs(got["pcm"][i] - want["pcm"][i]).max())
        print(f"stream {i} {transfer}: final_range {got['ranges'][i]} vs CPU "
              f"{want['ranges'][i]}, max_abs_err={err}")
        if got["ranges"][i] != want["ranges"][i]:
            raise AssertionError(f"stream {i}: final range differs from the CPU run")
        if not err < CPU_PCM_TOL:
            raise AssertionError(f"stream {i}: PCM err {err} against the CPU run")
    return {"launches": launches, "chunks": got["chunks"], "real": real}


def serve_rate(dev, transfer: str, batches, where: str) -> float:
    """End-to-end serve rate, audio-s/s at B=1024: median of 5 runs of
    every step after a warm-up run (each ends by fetching the digest).
    A plan rate counts only when no step fell back to q14."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
    dec.serve(batches, FRAME)  # warm-up: cuBLAS, step factories, slots
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        dec.serve(batches, FRAME)
        runs.append(time.perf_counter() - t0)
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} {transfer} steps fell back to q14 "
                             f"while timing the rate")
    audio_s = B * len(batches) * FRAME / 48000.0
    rates = sorted(audio_s / r for r in runs)
    print(f"serve e2e B={B} {transfer} {len(batches)} steps/run: audio_s_per_s median="
          f"{statistics.median(rates)} runs={rates} ({where})")
    return statistics.median(rates)


def p10_device(dev, batches, where: str) -> None:
    """Plane A time and the device step time of the p10 path."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.synthesis import init_state, make_serving_step
    from opus_tpu_torch.dsp.tables import packed_offsets, pf_chunk_for

    dec = BatchedCeltDecoder(B, C, transfer="p10", device=dev)
    slot = dec._alloc_slots(1, "p10")[0]
    plane_a = []
    for packets in batches:
        t0 = time.perf_counter()
        dec.native.decode_batch_q15_into(packets, FRAME, slot)
        plane_a.append(time.perf_counter() - t0)
    chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
    lm = int(slot["meta"][0, 2])
    step = make_serving_step(lm, B, C, pf_chunk=chunk, pf_active=active, transfer="p10",
                             device=dev)
    buf = slot["host"].to(dev)
    state = init_state(B, C, device=dev)
    ring = torch.zeros(B, FRAME, C, device=dev)
    step_ms = cuda_ms(lambda: step(state, ring, buf), 30)
    print(f"plane A p10 B={B}: ms/step median={statistics.median(plane_a) * 1e3} ({where})")
    print(f"device step B={B} p10 lm={lm} chunk={chunk}: ms={step_ms} audio_s_per_s="
          f"{B * FRAME / 48000.0 / (step_ms / 1e3)} upload_words="
          f"{packed_offsets(B, 'p10')['end']} ({where})")


def plan_device(dev, batches, where: str) -> None:
    """Plane A plan time, upload words per step and the plan device step."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    dec = BatchedCeltDecoder(B, C, transfer="plan", device=dev)
    slot = dec._alloc_plan_slots(1)[0]
    plane_a, words, classes = [], [], []
    for packets in batches:
        t0 = time.perf_counter()
        dec.native.decode_batch_plan_into(packets, FRAME, slot)
        plane_a.append(time.perf_counter() - t0)
        words.append(dec._plan_upload_words(slot))
        classes.append(dec._plan_size_class(slot))
    chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
    lm = int(slot["meta"][0, 2])
    step = dec._plan_serving_step(lm, chunk, active, classes[-1])
    buf = slot["host"][: words[-1]].to(dev)
    state = init_state(B, C, device=dev)
    ring = torch.zeros(B, FRAME, C, device=dev)
    step_ms = cuda_ms(lambda: step(state, ring, buf), 30)
    print(f"plane A plan B={B}: ms/step median={statistics.median(plane_a) * 1e3} ({where})")
    print(f"upload plan B={B}: words/step median={statistics.median(words)} "
          f"per_stream={statistics.median(words) / B} classes={sorted(set(classes))}")
    print(f"device step B={B} plan lm={lm} chunk={chunk} words={words[-1]} class={classes[-1]}: "
          f"ms={step_ms} audio_s_per_s={B * FRAME / 48000.0 / (step_ms / 1e3)} ({where})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    where = card()
    print(where)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    import opus_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)

    build()
    pf = postfilter_phase(dev, where)
    rot = rotation_phase(dev, where)

    clean = make_payloads()
    lossy = with_losses(clean)
    p10 = main_path(dev, "p10", lossy, where)
    plan = main_path(dev, "plan", clean, where)

    rate_p10 = serve_rate(dev, "p10", lossy, where)
    rate_plan = serve_rate(dev, "plan", clean, where)
    p10_device(dev, lossy, where)
    plan_device(dev, clean, where)
    print(f"serve e2e summary B={B}: p10={rate_p10} plan={rate_plan} audio_s_per_s, "
          f"plan fallbacks 0 ({where})")

    chunks = [c for c in p10["chunks"] + plan["chunks"] if c]
    main_chunk = max(set(chunks), key=chunks.count)
    pf_t = pf["times"][main_chunk]
    pf_real = plan["real"]["postfilter"]
    # Post-filter: the bytes these inputs need (pf_bytes); the arithmetic,
    # 3 filters x (5 taps: 3 mul + 4 add, envelope mul + add) per output
    # sample, is far below the byte time.
    pf_flops = B * C * 960 * 3 * 9
    pf_bound, pf_by = bound_ms(pf_t["bytes"][0], pf_flops)
    pf_bound_real = bound_ms(pf_real["times"]["bytes"][0], pf_flops)[0]
    # Rotation at the plan step's plane: x, cc, ss, k_pos, m_pos read,
    # out written; about 12 operations per element over both recurrences.
    n2 = 1920
    rot_bound, rot_by = bound_ms(6 * B * n2 * 4, 12 * B * n2)
    rot_real = plan["real"]["rotation"]
    print(json.dumps({"kernels": [
        {"name": "postfilter", "route": "cuda", "source": "opus_tpu_torch/csrc/postfilter.cu",
         "replaces": "opus_tpu/dsp/pallas_pf.py:89",
         "launches": p10["launches"]["postfilter"] + plan["launches"]["postfilter"],
         "launches_by_path": {"p10": p10["launches"]["postfilter"],
                              "plan": plan["launches"]["postfilter"]},
         "max_abs_err": max(pf["max_abs_err"], pf_real["max_abs_err"]),
         "ms": pf_t["ms"], "plain_ms": pf_t["plain_ms"],
         "bound_ms": pf_bound, "bound_by": pf_by, "library_ms": None,
         "shape": f"B={B} C={C} lm=3 chunk={main_chunk}",
         "kernel_ms": pf_t["kernel_ms"],
         "bound_ms_whole_rows": bound_ms(pf_t["bytes"][1], pf_flops)[0],
         "ms_real": pf_real["times"]["ms"], "kernel_ms_real": pf_real["times"]["kernel_ms"],
         "plain_ms_real": pf_real["times"]["plain_ms"], "bound_ms_real": pf_bound_real},
        {"name": "rotation", "route": "cuda", "source": "opus_tpu_torch/csrc/rotation.cu",
         "replaces": "opus_tpu/dsp/pallas_rot.py:46",
         "launches": plan["launches"]["rotation"],
         "launches_by_path": {"p10": p10["launches"]["rotation"],
                              "plan": plan["launches"]["rotation"]},
         "max_abs_err": max(rot["max_abs_err"], rot_real["max_abs_err"]),
         "ms": rot["times"]["ms"], "plain_ms": rot["times"]["plain_ms"],
         "bound_ms": rot_bound, "bound_by": rot_by, "library_ms": None,
         "shape": f"B={B} n2={n2}",
         "kernel_ms": rot["times"]["kernel_ms"],
         **{f"{key}_real_{p}": rot_real["times"][p][key]
            for p in ("A", "B") for key in ("ms", "kernel_ms", "plain_ms")}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
