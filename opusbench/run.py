"""Run one cell of the benchmark of `opus_tpu_torch` and print its result.

    python3 -m opusbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  The run:

1. set-up (`setup_s`, from the start of this module): torch and the card,
   the cell's files (spec.py), the packet pools and the seed's schedule
   (traffic/schedule.py), the program's decoder through its adapter
   (decoders/), and the regime's warm-up, which serves two periods of the
   traffic so that every step variant is built and captured;
2. the window: the regime (regimes/) serves the traffic for `--seconds`,
   keeping the final ranges of every stream at every step and the PCM of a
   seeded sample of streams after each serve() call (check.py);
3. with `--trace 1`, the program's calls named by the per-layer metrics
   are timed through the window, and then one more period is served under
   torch.profiler (profile.py);
4. the device's peak memory is read, the decoder freed, and the kept
   outputs are compared with the plain reference (check.py);
5. the metrics' readers (metrics/) make the result: the cell's end-to-end
   metrics with `--trace 0`, its per-layer metrics with `--trace 1`.

Its last line on standard output is the result (one JSON object); the
numbers compared, each beside its limit, are the last lines on standard
error.  Without a card, or with fewer than the cell asks for, it exits 3
and prints no result.  It exits 4 without a result if jax, jaxlib, flax
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import check, profile  # noqa: E402
from .spec import Cell, load_module  # noqa: E402
from .traffic.schedule import Schedule  # noqa: E402

#: Top-level module names a run must not have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "opus_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What a regime drives: the decoder, the seed's traffic, the step
    counter, the outputs kept after each call and, in a traced run, the
    program's timed calls and the profiler's host ranges."""

    def __init__(self, traffic: dict, adapter, dec, schedule: Schedule, captures):
        self.traffic, self.adapter, self.dec = traffic, adapter, dec
        self.schedule, self.captures = schedule, captures
        self.streams = schedule.streams
        self.period_len = schedule.steps_per_period
        self.t = 0  # global steps served
        self.step = 0  # global index of the step under way inside serve()
        self.capturing = False
        self.ranged = False  # open a profiler range around each labelled span
        self.spans: dict = {}
        self.timing = False
        self._chunks: dict = {}

    def chunk(self, n: int) -> list:
        """The next n steps' packet lists (made once per n, at set-up)."""
        P = self.period_len
        if n not in self._chunks:
            if P % n:
                raise ValueError(f"{n} steps a call do not divide the period of {P}")
            self._chunks[n] = [self.schedule.period[i : i + n] for i in range(0, P, n)]
        return self._chunks[n][(self.t % P) // n]

    def serve(self, steps: list) -> None:
        self.step = self.t
        self.adapter.serve(self.dec, steps)
        self.t += len(steps)

    def capture(self) -> None:
        if self.capturing:
            self.captures.take(self.dec, self.t - 1)

    def label(self, name: str):
        if not self.ranged:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(profile.PREFIX + name)

    def time_calls(self, path: str) -> None:
        """Time every call of the decoder's `path` (dotted attributes, e.g.
        "native.decode_batch_plan_into") into spans[path] while `timing`;
        in the traced segment the call is a profiler range too."""
        *owners, attr = path.split(".")
        obj = self.dec
        for name in owners:
            obj = getattr(obj, name)
        fn = getattr(obj, attr)
        spent = self.spans.setdefault(path, [])

        def timed(*a, **k):
            with self.label(attr.strip("_")):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    if self.timing:
                        spent.append(time.perf_counter() - t0)

        setattr(obj, attr, timed)


class Run:
    """What a metric's reader reads (metrics/<name>.py `read(run)`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_ms(self, path: str):
        """Mean host ms of a timed call of the program over the window."""
        spent = self.spans.get(path) or []
        return float(np.mean(spent) * 1e3) if spent else None


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m opusbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="serve the configuration's named control (a lower-precision path of "
                         "the program) in place of its decoder; for measuring the limits only")
    return ap.parse_args(argv)


def prepare(cell: Cell, seed: int, device, control=None, streams=None, seconds: float = 0.0):
    """The cell's decoder, traffic and Context, ready to warm up; the
    decoder is the configuration's, or its named control's, over
    `streams` streams (the traffic's count by default), with room for
    what a window of `seconds` keeps."""
    decoder = dict(cell.config["decoder"])
    if control is not None:
        decoder.update(cell.config["controls"][control])
    adapter = load_module("decoders", decoder["adapter"])
    regime = load_module("regimes", cell.traffic["regime"])
    traffic = dict(cell.traffic, streams=streams or cell.traffic["streams"])
    schedule = Schedule(cell.config, traffic, seed, adapter.entry)
    sampled = check.sample_streams(schedule, int(cell.workload["check"]["pcm_streams"]), seed)
    dec = adapter.make(decoder, schedule.streams, device)
    caps = check.Captures(adapter, sampled, device,
                          regime.captures(traffic, seconds, schedule.steps_per_period))
    return Context(traffic, adapter, dec, schedule, caps), regime


def main(argv=None, device=None) -> int:
    """`device` None: the card, checked.  The tests pass "cpu" to drive a
    run on the host; its numbers are then no device's."""
    args = parse(argv)
    cell = Cell(args.workload)
    import torch

    if device is None:
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"needs {chips} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = "cuda"
        torch.cuda.init()
    on_card = device == "cuda"
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    ctx, regime = prepare(cell, args.seed, device, args.control, seconds=args.seconds)
    schedule, streams, dec = ctx.schedule, ctx.captures.streams, ctx.dec
    regime.warm(ctx)
    ctx.captures.take(dec, ctx.t - 1)  # the capture's own kernels load here, not in the window
    ctx.captures.clear()
    if on_card:
        torch.cuda.synchronize()
    if args.trace:
        for r in readers.values():
            for path in getattr(r, "WRAPS", ()):
                if path not in ctx.spans:
                    ctx.time_calls(path)
        with torch.profiler.profile(activities=_activities(on_card)):
            pass  # the profiler's own first start, out of the traced segment
    if getattr(regime, "RANGES_EACH_STEP", False):
        ctx.captures.hook(ctx)  # outermost: a plane A span leaves the read out
    # set-up's objects live as long as the run: a full collection in the
    # window then scans only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0

    ctx.capturing = ctx.timing = True
    window = regime.window(ctx, args.seconds)
    ctx.timing = False
    trace = None
    if args.trace:
        ctx.ranged = True
        with torch.profiler.profile(activities=_activities(on_card)) as prof:
            with torch.profiler.record_function(profile.SEGMENT):
                seg = regime.segment(ctx)
                if on_card:
                    torch.cuda.synchronize()
        ctx.ranged = False
        trace = profile.summarize(prof, seg["steps"])
        del prof
    if on_card:
        torch.cuda.synchronize()
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    if trace is not None:
        device_info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    caps, spans, served = ctx.captures, ctx.spans, ctx.t
    fallbacks = getattr(dec, "plan_fallbacks", None)
    caps.to_host()
    del ctx, dec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = check.reference_pcm(cell.name, args.seed, streams, caps.steps)
    numbers = check.compare(schedule, caps, ref, streams)
    correct, checks = check.decide(numbers, cell.workload["check"]["limits"])
    ref_s = time.perf_counter() - t_ref

    run = Run(cell=cell, streams=schedule.streams, setup_s=setup_s, window=window,
              trace=trace, spans=spans)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    log(f"cell {cell.name}: {schedule.streams} streams, seed {args.seed}, control "
        f"{args.control}; set-up {setup_s} s; window {window['window_s']} s, "
        f"{window['steps']} steps; {served} steps served in all; plan fallbacks {fallbacks}")
    if "latency_s" in window:
        lat = window["latency_s"] * 1e3
        log(f"ticks {lat.size}: latency ms p50 {np.percentile(lat, 50)} p95 "
            f"{np.percentile(lat, 95)} p99 {np.percentile(lat, 99)} max {lat.max()}; "
            f"ticks over 20 ms {int((lat > 20).sum())}; late start ms max "
            f"{window['late_s'].max() * 1e3} (tick {int(window['late_s'].argmax())})")
    log(f"check: {numbers['ranges_compared']} final ranges compared; PCM of streams "
        f"{streams.tolist()} at {len(caps.steps)} steps ({numbers['pcm_frames']} decoded "
        f"frames, worst at (stream, step) {numbers['pcm_worst_at']}; "
        f"{numbers['plc_frames']} concealed or after a loss, worst "
        f"{numbers['plc_max_abs']} at {numbers['plc_worst_at']}; "
        f"{numbers['sampled_lost_frames']} of their steps lost); reference {ref_s} s")
    bad = forbidden_modules()
    if bad:
        log(f"modules a run must not load are loaded: {bad}")
        return 4
    result = {"correct": correct, "attempted": window["steps"] * schedule.streams,
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace is not None:
        result["breakdown"] = profile.breakdown(trace)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def _activities(on_card: bool) -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


if __name__ == "__main__":
    sys.exit(main())
