"""unmap_span_ms.live: host ms a tick of the program's `unmap` span, the
multistream decoder's gather of the elementary streams' PCM into the
sessions' channels on the device, until it completes, over the window's
ticks (the program's tracer, opusbench/program_trace.py; None where the
program has no such span)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "unmap")
