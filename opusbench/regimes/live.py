"""Live regime: an open loop at the codec's 20 ms cadence.

A conferencing mixer gets every stream's next frame 20 ms after the last,
so tick k is due at start + k x 20 ms whatever happened before it: the
harness sleeps (then spins the last 1.5 ms) until the tick is due, unless
it is already late, and calls serve() with one step.  A tick's latency
runs from its due time to the return of its serve() call, which ends when
the step's PCM is complete on the device; a stall therefore counts
against every tick behind it.  `late_s` is how late each tick began.
"""

from __future__ import annotations

import time

import numpy as np

STEP_S = 0.02


def warm(ctx) -> None:
    """Two periods of ticks, back to back, so every step variant of the
    window, the first period's included, is captured before timing."""
    for _ in range(2 * ctx.period_len):
        ctx.serve(ctx.chunk(1))


def captures(traffic: dict, seconds: float, period: int) -> int:
    """Ticks of a window of `seconds` and of the traced segment."""
    return int(round(seconds / STEP_S)) + period


def _wait_until(due: float) -> None:
    while True:
        left = due - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.0015)


def ticks(ctx, n: int) -> dict:
    latency, late = np.zeros(n), np.zeros(n)
    start = time.perf_counter() + STEP_S
    for k in range(n):
        due = start + k * STEP_S
        with ctx.label("tick_wait"):
            _wait_until(due)
        began = time.perf_counter()
        with ctx.label("serve"):
            ctx.serve(ctx.chunk(1))
        done = time.perf_counter()
        latency[k], late[k] = done - due, began - due
        with ctx.label("capture"):
            ctx.capture()
    return {"window_s": time.perf_counter() - start, "steps": n, "latency_s": latency,
            "late_s": late}


def window(ctx, seconds: float) -> dict:
    return ticks(ctx, int(round(seconds / STEP_S)))


def segment(ctx) -> dict:
    """One period of ticks, for the device trace."""
    return ticks(ctx, ctx.period_len)
