"""step_issue_ms.offline: host ms a step of the program's `issue` span:
the step's picks, the upload's enqueue and the serving step's call (a
CUDA graph's replay), over the window's steps (the program's tracer,
opusbench/program_trace.py)."""

from opusbench.program_trace import span_ms


def read(run):
    return span_ms(run, "issue")
