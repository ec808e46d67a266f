"""split_span_ms.live: host ms a tick of the program's `split` span, the
multistream decoder's split of every session's packet into its
elementary payloads and each stream's CELT end band from its ToC, over
the window's ticks (the program's tracer, opusbench/program_trace.py;
None where the program has no such span)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "split")
