"""device_step_ms.live: device ms a tick of the serving step's CUDA graph,
from its first to its last in-graph timing event, over the window's
replays (the program's tracer, opusbench/program_trace.py; None on the
CPU and where the tracer was off at the capture)."""

from opusbench.program_trace import device_ms


def read(run):
    return device_ms(run, "step")
