"""What a torch.profiler trace of a served segment says about the device.

The arithmetic follows tools/torch_profile.py (commit e93197f): device
events are the kernels and copies the card ran, found by their symbol;
the device-side twins of the harness's own ranges are left out.  Busy
time is the union of the device events' intervals inside the segment (two
overlapping kernels count once), idle is the rest of the segment; idle
time is put down to the innermost of the harness's host ranges
(`opusbench.<name>`) open at each moment of it ("other" where none is).
"""

from __future__ import annotations

PREFIX = "opusbench."
SEGMENT = PREFIX + "segment"


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        on_device = e.device_type() == cuda
        if on_device and (name.startswith(PREFIX) or e.is_user_annotation()):
            continue
        out.append((name, on_device, start, start + e.duration_ns()))
    return out


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host: list, s0: int, s1: int) -> list:
    """[s0, s1] cut into (start, end, name) pieces of the innermost host
    range open in each ("other" where none is).  `host` is sorted by start,
    outer first; the harness's ranges nest, an inner one ending before its
    outer."""
    pieces, stack, at = [], [], s0

    def upto(t):
        nonlocal at
        t = min(max(t, at), s1)
        if t > at:
            pieces.append((at, t, stack[-1][2] if stack else "other"))
            at = t

    for rng in host:
        while stack and stack[-1][1] <= rng[0]:
            upto(stack[-1][1])
            stack.pop()
        upto(rng[0])
        stack.append(rng)
    while stack:
        upto(stack[-1][1])
        stack.pop()
    upto(s1)
    return pieces


def summarize(prof, steps: int) -> dict:
    """busy_s, window_s (the segment's length), steps, the durations of
    each device op's launches by name (`launches`), and idle seconds by
    the host range open at the time (`idle_by_host`)."""
    events = _events(prof)
    seg = [(s, e) for n, dev, s, e in events if not dev and n == SEGMENT]
    if len(seg) != 1:
        raise RuntimeError(f"the trace holds {len(seg)} segment ranges, not 1")
    s0, s1 = seg[0]
    dev = [(n, max(s, s0), min(e, s1)) for n, d, s, e in events if d and e > s0 and s < s1]
    busy = _union([(s, e) for _, s, e in dev])
    launches = {}
    for n, s, e in dev:
        launches.setdefault(n, []).append((e - s) / 1e9)
    # outer before inner where two ranges start together
    host = sorted(((s, e, n[len(PREFIX):]) for n, d, s, e in events
                   if not d and n.startswith(PREFIX) and n != SEGMENT),
                  key=lambda h: (h[0], -h[1]))
    gaps, edge = [], s0
    for s, e in busy + [[s1, s1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle, i = {}, 0
    for s, e, name in _innermost(host, s0, s1):
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        for gs, ge in gaps[i:]:
            if gs >= e:
                break
            idle[name] = idle.get(name, 0.0) + (min(e, ge) - max(s, gs)) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9, "window_s": (s1 - s0) / 1e9,
            "steps": steps, "launches": launches, "idle_by_host": idle}


def breakdown(summary: dict) -> dict:
    """The result's `breakdown`: the ten device ops that took most time
    (their names cut to 120 characters) and the idle time by what the
    host was doing, in seconds."""
    spent = {n: sum(ds) for n, ds in summary["launches"].items()}
    top = [(n[:120], s) for n, s in sorted(spent.items(), key=lambda kv: -kv[1])[:10]]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}
