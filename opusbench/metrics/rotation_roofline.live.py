"""rotation_roofline.live: the spreading rotation kernel's share of its
roofline over the traced period: its launches' least time (roofline.py,
from the batch's shape) over their profiled time."""

from opusbench.readers import kernel_roofline_pct, rotation_bound_ms

KERNEL = "rot_pass_kernel"


def read(run):
    return kernel_roofline_pct(run, KERNEL, rotation_bound_ms)
