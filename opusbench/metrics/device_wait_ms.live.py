"""device_wait_ms.live: host ms a tick of the program's `device_wait`
span, serve()'s read of the last step's digest, which waits for the
device to finish the step, over the window's ticks (the program's
tracer, opusbench/program_trace.py)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "device_wait")
