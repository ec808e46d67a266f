"""plane_a_span_ms.offline: host ms a step of the program's `plane_a`
span, its native decode of every stream into the step's plan slot, over
the window's steps (the program's tracer, opusbench/program_trace.py)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "plane_a")
