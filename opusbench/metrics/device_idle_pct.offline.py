"""device_idle_pct.offline: the share of the traced period with nothing
running on the device (torch.profiler)."""

from opusbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
