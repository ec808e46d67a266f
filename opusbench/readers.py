"""What the metrics' readers (metrics/<name>.py) share: each reads one
number from a finished run (run.py `Run`), or None where the run has
nothing to read."""

from __future__ import annotations

import numpy as np

from . import roofline


def percentile_ms(run, q: float):
    """The q-th percentile of every tick's latency in the window, in ms."""
    lat = run.window.get("latency_s")
    return None if lat is None or lat.size == 0 else float(np.percentile(lat, q) * 1e3)


def device_busy_ms(run):
    """Device busy ms a step in the traced segment (union of the device
    events' intervals over the segment's steps)."""
    t = run.trace
    return None if t is None or t["busy_s"] <= 0 else t["busy_s"] / t["steps"] * 1e3


def device_idle_pct(run):
    """The share of the traced segment with nothing running on the device."""
    t = run.trace
    return None if t is None or t["busy_s"] <= 0 else 100.0 * (1 - t["busy_s"] / t["window_s"])


def kernel_roofline_pct(run, symbol: str, bound_ms):
    """A hand-written kernel's share of its roofline over the traced
    segment: its launches' bound (bound_ms(run), the least time one
    launch could take) over their profiled time; None if it never ran."""
    t = run.trace
    if t is None:
        return None
    spent = [d for name, ds in t["launches"].items() if symbol in name for d in ds]
    if not spent:
        return None
    return 100.0 * len(spent) * bound_ms(run) * 1e-3 / sum(spent)


def rotation_bound_ms(run) -> float:
    dec = run.cell.config["decoder"]
    return roofline.rotation_bound_ms(run.streams, dec["channels"],
                                      run.cell.config["codec"]["frame_samples"])
