"""The program's own tracer (`opus_tpu_torch.trace`), read by the per-layer
metrics of its spans and device phases.

Importing this module turns the tracer on, each span also a profiler
range named `profile.PREFIX + <span>` while the traced segment runs, so
that profile.py puts the device's idle time down to the program's spans.
Only the per-layer metrics' readers import it, and they load only in
`--trace 1` runs: the end-to-end runs keep the tracer off.

The window's steps: the tracer keeps each span with the decoder's own
count of steps served; the traced segment served the last
`run.trace["steps"]` steps, and the window the `run.window["steps"]`
before them.  Once a run, the first read prints on standard error the
window's mean ms a step of every span, the step's self time (what its
children leave), the same spans in the traced segment, the device phases
and the window's counters.

A program without the tracer (an older commit) reads None everywhere,
and the run goes on without these metrics.
"""

from __future__ import annotations

import sys

from . import profile

try:
    from opus_tpu_torch import trace as _trace
except ImportError:
    _trace = None
else:
    _trace.enable(range_prefix=profile.PREFIX)


def window_steps(spans: list, run):
    """(first, stop) step ids of the window, from the last step traced."""
    ids = [s.step for s in spans if not s.device and s.name == "step"]
    if not ids or run.trace is None:
        return None
    stop = max(ids) + 1 - int(run.trace["steps"])
    return stop - int(run.window["steps"]), stop


def _summary(run):
    """What the readers read, made once a run: mean ms a step of each
    host span and each device phase over the window, and its counters."""
    if _trace is None:
        return None
    if "_program_trace" in run.__dict__:
        return run._program_trace
    spans = _trace.spans()
    steps = window_steps(spans, run)
    out = None
    if steps is not None:
        first, stop = steps
        mine = [s for s in spans if first <= s.step < stop]
        host, device, children = {}, {}, {}
        for s in mine:
            ms = (s.end_ns - s.start_ns) / 1e6
            (device if s.device else host).setdefault(s.name, []).append(ms)
            if not s.device and s.parent is not None:
                children[s.parent] = children.get(s.parent, 0.0) + ms
        n = stop - first
        step_self = [(s.end_ns - s.start_ns) / 1e6 - children.get(s.id, 0.0)
                     for s in mine if not s.device and s.name == "step"]
        seg, seg_n = {}, int(run.trace["steps"])
        for s in spans:
            if not s.device and s.step >= stop:
                seg[s.name] = seg.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6 / seg_n
        out = {"steps": steps, "segment_host_ms": seg,
               "host_ms": {k: sum(v) / n for k, v in host.items()},
               "device_ms": {k: sum(v) / len(device["step"]) for k, v in device.items()},
               "device_steps": len(device.get("step", ())),
               "step_self_ms": sum(step_self) / n if step_self else None,
               "counters": _trace.counters(steps), "totals": _trace.counters()}
        _log(out)
    run._program_trace = out
    return out


def _log(out: dict) -> None:
    first, stop = out["steps"]
    host = out["host_ms"]

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    log(f"program trace: window steps {first}-{stop - 1}; host ms a step "
        + ", ".join(f"{k} {v}" for k, v in sorted(host.items())))
    if host.get("step"):
        self_ms = out["step_self_ms"]
        log(f"program trace: step self time {self_ms} ms a step; its children cover "
            f"{100.0 * (1 - self_ms / host['step'])}% of it")
    log("program trace: the traced segment (under torch.profiler), host ms a step "
        + ", ".join(f"{k} {v}" for k, v in sorted(out["segment_host_ms"].items())))
    log(f"program trace: device ms a step over {out['device_steps']} replays read "
        + ", ".join(f"{k} {v}" for k, v in sorted(out["device_ms"].items())))
    log(f"program trace: window counters {out['counters']}; run totals {out['totals']}")


def span_ms(run, name: str):
    """Mean host ms a step of the program's span `name` over the window's
    steps (None where it never ran there)."""
    s = _summary(run)
    return None if s is None else s["host_ms"].get(name)


def device_ms(run, name: str):
    """Mean device ms a step of the in-graph phase `name` ("step": first to
    last event) over the window's replays whose phases were read."""
    s = _summary(run)
    return None if s is None else s["device_ms"].get(name)
