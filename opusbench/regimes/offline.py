"""Offline regime: a backlog drained as fast as the program can.

A transcoding fleet has every stream's next frames at hand, so serve() is
called back to back, `steps_per_call` steps a call (one second of audio a
stream at 50 steps), for as long as the window lasts: a closed loop.  The
window ends with the first call that returns `seconds` or more after it
began, and counts every step of every call in it.
"""

from __future__ import annotations

import time

STEP_S = 0.02
#: a call serves many steps: keep each step's final ranges from inside it
RANGES_EACH_STEP = True


def warm(ctx) -> None:
    """Two periods, so every step variant of the window, the first
    period's included, is captured before timing."""
    for _ in range(2 * ctx.period_len // ctx.traffic["steps_per_call"]):
        _call(ctx, capture=False)


def captures(traffic: dict, seconds: float, period: int) -> int:
    """Calls a window of `seconds` and the traced segment make when a call
    takes the audio's own time (a faster program makes more, which
    check.Captures makes room for)."""
    return int(seconds / (traffic["steps_per_call"] * STEP_S)) + 2


def _call(ctx, capture: bool = True) -> None:
    with ctx.label("serve"):
        ctx.serve(ctx.chunk(ctx.traffic["steps_per_call"]))
    if capture:
        with ctx.label("capture"):
            ctx.capture()


def window(ctx, seconds: float) -> dict:
    calls, t0 = 0, time.perf_counter()
    while True:
        _call(ctx)
        calls += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    steps = calls * ctx.traffic["steps_per_call"]
    return {"window_s": elapsed, "calls": calls, "steps": steps,
            "audio_s": steps * ctx.streams * STEP_S}


def segment(ctx) -> dict:
    """One call, for the device trace."""
    _call(ctx)
    return {"steps": ctx.traffic["steps_per_call"]}
