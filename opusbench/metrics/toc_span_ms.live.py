"""toc_span_ms.live: host ms a tick of the program's `toc` span, the mixed
decoder's ToC parse of every packet, over the window's ticks (the
program's tracer, opusbench/program_trace.py)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "toc")
