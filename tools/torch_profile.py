"""Profile the port's serving steps on one NVIDIA GPU.

    python3 tools/torch_profile.py [--steps N]

Makes the payloads as chip_smoke.py does (B=1024 stereo 48 kHz CELT, 20 ms
frames, 96 kbps, 13 steps).  For each main path (p10, plan, plan-loss:
the plan transfer with chip_smoke.py's losses) it serves them once to
warm up and once more with the port's tracer on (opus_tpu_torch/trace.py),
and prints where a serve() step's wall time goes: the host ms a step of
every span of the serve loop (plane A, the ToC parse, the slot wait, the
step issue with its upload and replay, the shadow decode and crossfades,
the final device wait; the step's self time), the device phases of the
captured steps, and the device's busy and idle share under
torch.profiler.  Then, for single serving steps on one slot, run eagerly
(the factory's step, whose launches are the graph's kernels), it prints
beside the card's name and power limit:

* the host time to issue one step (host clock around the call, no sync);
* the device time per step by CUDA events over N back-to-back steps;
* under torch.profiler over N steps: the device busy time and the number
  of kernels per step, each hand-written kernel's device time and
  launches per step by its symbol name, and the ops that take the most
  device and host time.

The steps: the first p10 and plan steps, each also replayed from its CUDA
graph; and on plan-loss, step 1 (a compact concealment) and step 6 (a
whole-batch one), each through its concealing variant and through the
clean variant on the same slot, with the difference in kernels per step.

The mixed traffic (chip_smoke.py's: one stream in three each of CELT,
SILK WB and hybrid SWB, the plan transfer with the internal SILK
transfer) gets the same: a serve breakdown of mixed, mixed-loss and
mixed-switch, and a profile of the first mixed step and of the first
mixed-loss step that conceals, with the device time of the SILK
resampler's products (`_silk_resample`, under a profiler range).

The slice's paths (chip_smoke.py's traffic) get a breakdown too: the
multistream serve loop, 256 8-channel sessions on plan and on p10 (its
`split` and `unmap` spans beside the core's), and the SILK-only decoder
at B=1024 WB (no serve loop, so its host front end and device step are
timed by wrappers), each with the device's busy and idle share.

The full profiler tables go to chiprun_out/torch_profile.txt.  Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: The symbols of the kernels in opus_tpu_torch/csrc/.
KERNELS = ("postfilter_kernel", "rot_pass_kernel", "pitch_track_kernel", "lpc_synth_kernel",
           "silk_synth_kernel", "band_walk_kernel")
#: Profiler ranges put around functions of the port while profiling.
RANGES = ("silk_resample",)


def _kernels(ka) -> list:
    """The device events of a profile that are kernels (or copies): the
    device-side spans of the profiler ranges are left out."""
    return [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in RANGES]


def _ranged(module, name: str, label: str) -> None:
    """Run module.name under a profiler range called `label`."""
    fn = getattr(module, name)

    def run(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)

    setattr(module, name, run)


def _device_us(evt, total: bool = False) -> float:
    """An event's own device time (or, with total, that of everything it
    launched: a profiler range's kernels)."""
    names = (("device_time_total", "cuda_time_total") if total
             else ("self_device_time_total", "self_cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(name, step_fn, steps: int, where: str, out) -> float:
    """Profile `steps` calls of step_fn; returns its kernels per step."""
    from chip_smoke import cuda_ms

    torch.cuda.synchronize()
    issue = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step_fn()
        issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    ev_ms = cuda_ms(step_fn, steps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = _kernels(ka)
    busy_ms = sum(_device_us(e) for e in cuda) / 1e3 / steps
    kernels = sum(e.count for e in cuda) / steps
    issue_ms = sorted(issue)[len(issue) // 2] * 1e3
    print(f"{name}: host issue ms/step median={issue_ms} device ms/step by events={ev_ms} "
          f"device busy ms/step={busy_ms} kernels/step={kernels} ({where})")
    for sym in KERNELS:
        hits = [e for e in cuda if sym in e.key]
        print(f"  {name} kernel {sym}: device ms/step="
              f"{sum(_device_us(e) for e in hits) / 1e3 / steps} "
              f"launches/step={sum(e.count for e in hits) / steps} ({where})")
    for rng in RANGES:
        # The range's host event carries the device time of the kernels
        # launched inside it; its device-side twin spans first to last
        # kernel, host gaps included.
        host = [e for e in ka if e.key == rng and e.device_type != torch.autograd.DeviceType.CUDA]
        span = [e for e in ka if e.key == rng and e.device_type == torch.autograd.DeviceType.CUDA]
        if host:
            print(f"  {name} range {rng}: kernels' device ms/step="
                  f"{sum(_device_us(e, total=True) for e in host) / 1e3 / steps} span ms/step="
                  f"{sum(_device_us(e) for e in span) / 1e3 / steps} "
                  f"calls/step={sum(e.count for e in host) / steps} ({where})")
    top = sorted(cuda, key=_device_us, reverse=True)[:12]
    for e in top:
        print(f"  {name} device {_device_us(e) / 1e3 / steps:.4f} ms/step x{e.count // steps} "
              f"{e.key[:90]}")
    out.write(f"==== {name} ({where})\n")
    for key in ("self_cuda_time_total", "self_cpu_time_total"):
        try:
            out.write(ka.table(sort_by=key, row_limit=40) + "\n")
        except (KeyError, AttributeError, ValueError) as err:
            out.write(f"(no table by {key}: {err})\n")
    return kernels


def _busy_run(run) -> tuple[float, float]:
    """(wall s, device busy s) of run() under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    return wall, sum(_device_us(e) for e in _kernels(prof.key_averages())) / 1e6


def breakdown(name: str, warm, run, n: int, where: str) -> None:
    """Where a serve() run's wall time goes, per step, read from the port's
    tracer (opus_tpu_torch/trace.py): the host ms of every span (`step`'s
    self time is what its children leave), the device phases of the
    captured steps (the tracer is on from the warm-up, whose captures
    record them), and the device's busy share of the run under
    torch.profiler."""
    from opus_tpu_torch import trace

    trace.enable()
    try:
        warm()
        trace.clear()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        trace.disable()
    spans = trace.spans()
    trace.clear()
    host, device, children = {}, {}, {}
    for s in spans:
        ms = (s.end_ns - s.start_ns) / 1e6
        kind = device if s.device else host
        kind[s.name] = kind.get(s.name, 0.0) + ms
        if not s.device and s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + ms
    step_self = sum((s.end_ns - s.start_ns) / 1e6 - children.get(s.id, 0.0)
                    for s in spans if not s.device and s.name == "step")
    wall_prof, busy = _busy_run(run)
    print(f"serve {name} breakdown, {n} steps: wall ms/step={wall / n * 1e3} "
          + " ".join(f"{k}={v / n}" for k, v in sorted(host.items()))
          + f" step_self={step_self / n}; device phases ms/step "
          + " ".join(f"{k}={v / n}" for k, v in sorted(device.items()))
          + f"; under the profiler: wall ms/step={wall_prof / n * 1e3} device_busy="
          f"{busy / n * 1e3} device_idle_share={1 - busy / wall_prof} ({where})")


def serve_breakdown(transfer: str, batches, where: str, name: str = "") -> None:
    """breakdown() of the CELT serve loop at B=1024 on `transfer`."""
    import chip_smoke as cs

    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    dec = BatchedCeltDecoder(cs.B, cs.C, transfer=transfer, device=torch.device("cuda"))
    run = lambda: dec.serve(batches, cs.FRAME)  # noqa: E731
    breakdown(f"{name or transfer} B={cs.B}", run, run, len(batches), where)


def mixed_breakdown(batches, where: str, name: str) -> None:
    """breakdown() of the mixed plan loop (internal SILK) at B=1024."""
    import chip_smoke as cs

    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    dec = BatchedOpusDecoder(cs.B, cs.C, transfer="plan", silk_transfer="internal",
                             device=torch.device("cuda"))
    run = lambda: dec.serve(batches)  # noqa: E731
    breakdown(f"{name} B={cs.B}", run, run, len(batches), where)
    print(f"serve {name}: plan fallbacks {dec.plan_fallbacks} ({where})")


def multistream_breakdown(name: str, where: str) -> None:
    """breakdown() of a multistream serve() run (chip_smoke MS_PATHS[name],
    every fixture step): the split into elementary payloads and the
    un-mapping on the card (no fetch: serve() leaves the sessions' PCM in
    `_serve_ring`) are spans of their own."""
    import chip_smoke as cs

    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    group, sessions, mode, transfer, _ = cs.MS_PATHS[name]
    (ch, streams, coupled, *mapping), steps, _ = cs.load_ms_group(group, sessions)
    bmd = BatchedMultistreamDecoder(sessions, ch, streams, coupled, mapping, mode=mode,
                                    device=torch.device("cuda"))
    bmd.core.transfer = transfer
    run = lambda: bmd.serve(steps, cs.FRAME)  # noqa: E731
    breakdown(f"{name} {sessions} sessions ({sessions * streams} elementary)", run, run,
              len(steps), where)


def silk_breakdown(steps: int, where: str) -> None:
    """Where a SILK-only decode_frames step's wall time goes at B=1024 WB
    (chip_smoke.py's payloads): the host front end (planes), the device
    step (synthesize: the uploads and the silk_synth launch) and the rest
    (the fetch and the feedback of the output); the device busy share.
    The SILK-only decoder has no serve loop, so no span of the tracer:
    its two phases are timed by wrapping them here."""
    import chip_smoke as cs

    from opus_tpu_torch.batch.silk_pipeline import BatchedSilkDecoder

    batches = cs.make_silk_payloads(cs.B, 16, steps)
    dec = BatchedSilkDecoder(cs.B, 16, device=torch.device("cuda"))
    dec.decode_frames(batches[0])  # warm-up
    spent = dict.fromkeys(("front end", "device step"), 0.0)

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    dec.planes = timed(dec.planes, "front end")
    dec.synthesize = timed(dec.synthesize, "device step")
    t0 = time.perf_counter()
    for payloads in batches[1:]:
        dec.decode_frames(payloads)
    wall = time.perf_counter() - t0
    n = len(batches) - 1
    parts = {k: v / n * 1e3 for k, v in spent.items()}
    wall_prof, busy = _busy_run(lambda: dec.decode_frames(batches[-1]))
    print(f"silk-only breakdown B={cs.B} WB, {n} steps: wall ms/step={wall / n * 1e3} "
          + " ".join(f"{k.replace(' ', '_')}={v}" for k, v in parts.items())
          + f" rest={wall / n * 1e3 - sum(parts.values())}; under the profiler, one step: wall "
          f"ms={wall_prof * 1e3} device_busy ms={busy * 1e3} device_idle_share="
          f"{1 - busy / wall_prof} ({where})")


def mixed_steps(batches, lossy, steps: int, where: str, out) -> None:
    """Profile the first mixed step, and the first mixed-loss step that
    conceals through its concealing and its clean variant on one slot."""
    import chip_smoke as cs

    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.dsp.graphs import eager
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.native.frontend import pack_plan_silk

    B, C, F = cs.B, cs.C, cs.FRAME
    dev = torch.device("cuda")
    for label, traffic in (("mixed", batches), ("mixed-loss", lossy)):
        dec = BatchedOpusDecoder(B, C, transfer="plan", silk_transfer="internal", device=dev)
        slot = dec._alloc_plan_slots(F, 1)[0][0]
        for t, pk in enumerate(traffic):
            dec._plane_a_plan(pk, slot)
            lm, chunk, active, with_plc = dec._step_picks(slot)
            if label == "mixed" or with_plc is not False:
                break
        silk_at, words = pack_plan_silk(slot)
        buf = slot["host"][:words].to(dev)
        state = init_state(B, C, device=dev, silk_hist=True)
        ring = torch.zeros(B, F, C, device=dev)
        lpc = torch.zeros(B, C, 24, device=dev)
        pitch = torch.full((B,), 15, dtype=torch.int32, device=dev)
        cls = dec._plan_size_class(slot)
        kw = dict(silk_at=silk_at)
        clean = eager(dec._mixed_plan_serving_step(lm, chunk, active, cls, False))
        n_lost = int((slot["meta"][:, 14] & 1).sum())
        name = (f"{label} step {t} ({int((slot['meta'][:, 4] == 17).sum())} hybrid, "
                f"{len(slot['silk_rows'])} SILK rows, {words} words, class {cls})")
        k_clean = profile(name if label == "mixed" else f"{name} clean variant",
                          lambda: clean(state, ring, buf, **kw), steps, where, out)
        if label == "mixed-loss":
            lossy_step = eager(dec._mixed_plan_serving_step(lm, chunk, active, cls, with_plc))
            k_loss = profile(f"{name} concealing {n_lost} (k={with_plc})",
                             lambda: lossy_step(state, ring, buf, lpc, pitch, **kw),
                             steps, where, out)
            print(f"{label} step {t}: concealment adds {k_loss - k_clean} kernels per step "
                  f"({k_loss} vs {k_clean}) ({where})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.graphs import eager
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    where = cs.card()
    print(where)
    dev = torch.device("cuda")
    batches = cs.make_payloads()
    packets = batches[0]
    B, C, F = cs.B, cs.C, cs.FRAME
    lossy = cs.with_plan_losses(batches)
    serve_breakdown("p10", cs.with_losses(batches), where)
    serve_breakdown("plan", batches, where)
    serve_breakdown("plan", lossy, where, "plan-loss")
    from opus_tpu_torch.dsp import synthesis

    _ranged(synthesis, "_silk_resample", "silk_resample")
    mixed = cs.make_mixed_payloads(batches)
    mixed_lossy = cs.with_mixed_losses(mixed)
    mixed_breakdown(mixed, where, "mixed")
    mixed_breakdown(mixed_lossy, where, "mixed-loss")
    mixed_breakdown(cs.with_switches(mixed), where, "mixed-switch")
    multistream_breakdown("multistream", where)
    multistream_breakdown("multistream-p10", where)
    silk_breakdown(4, where)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with open(ROOT / "chiprun_out" / "torch_profile.txt", "w") as out:
        for transfer in ("p10", "plan"):
            dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
            if transfer == "plan":
                slot = dec._alloc_plan_slots(1)[0]
                dec.native.decode_batch_plan_into(packets, F, slot)
            else:
                slot = dec._alloc_slots(1, "p10")[0]
                dec.native.decode_batch_q15_into(packets, F, slot)
            chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
            lm = int(slot["meta"][0, 2])
            if transfer == "plan":
                step = dec._plan_serving_step(lm, chunk, active, dec._plan_size_class(slot))
                buf = slot["host"][: dec._plan_upload_words(slot)].to(dev)
            else:
                step = dec._serving_step(lm, chunk, active, "p10")
                buf = slot["host"].to(dev)
            state = init_state(B, C, device=dev)
            ring = torch.zeros(B, F, C, device=dev)
            profile(f"{transfer} step", lambda: eager(step)(state, ring, buf), args.steps, where,
                    out)
            profile(f"{transfer} step replayed", lambda: step(state, ring, buf), args.steps,
                    where, out)
        # plan-loss: decode up to each profiled step on the host, then
        # profile that slot's concealing and clean variants.
        dec = BatchedCeltDecoder(B, C, transfer="plan", device=dev)
        slot = dec._alloc_plan_slots(1)[0]
        for t, pk in enumerate(lossy[: cs.LOST_STEP + 1]):
            dec.native.decode_batch_plan_into(pk, F, slot)
            if t not in (1, cs.LOST_STEP):
                continue
            chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
            lm = int(slot["meta"][0, 2])
            cls = dec._plan_size_class(slot)
            variant = dec._plc_variant(slot["meta"])
            n_lost = int((slot["meta"][:, 14] & 1).sum())
            buf = slot["host"][: dec._plan_upload_words(slot)].to(dev)
            state = init_state(B, C, device=dev)
            ring = torch.zeros(B, F, C, device=dev)
            lpc = torch.zeros(B, C, 24, device=dev)
            pitch = torch.full((B,), 15, dtype=torch.int32, device=dev)
            lossy_step = eager(dec._plan_serving_step(lm, chunk, active, cls, variant))
            clean_step = eager(dec._plan_serving_step(lm, chunk, active, cls))
            kind = "compact" if variant is not True else "whole-batch"
            name = f"plan-loss step {t} ({n_lost} concealed, {kind} k={variant}, class {cls})"
            k_loss = profile(name, lambda: lossy_step(state, ring, buf, lpc, pitch),
                             args.steps, where, out)
            k_clean = profile(f"plan-loss step {t} clean variant, same slot",
                              lambda: clean_step(state, ring, buf), args.steps, where, out)
            print(f"plan-loss step {t} ({kind}): concealment adds {k_loss - k_clean} kernels "
                  f"per step ({k_loss} vs {k_clean}; budget 1000) ({where})")
        mixed_steps(mixed, mixed_lossy, args.steps, where, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
