"""device_busy_ms.offline: device ms a step with a kernel or copy running,
over the traced period (torch.profiler)."""

from opusbench.readers import device_busy_ms


def read(run):
    return device_busy_ms(run)
