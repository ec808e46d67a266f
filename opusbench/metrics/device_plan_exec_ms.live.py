"""device_plan_exec_ms.live: device ms a tick of the serving step's
`plan_exec` phase (the upload's unpacking and the plan executor, which
rebuilds the band spectra), between two in-graph timing events, over the
window's replays (the program's tracer, opusbench/program_trace.py; None
on the CPU)."""

from opusbench.program_trace import device_ms


def read(run):
    return device_ms(run, "plan_exec")
