"""The yardstick's peaks and the operations and bytes of the program's
hand-written kernels, counted from the shapes and data of a cell's
traffic, the same whatever implements the kernel.

The peaks and `bound_ms` are frozen copies of chip_smoke.py's (commit
e93197f): NVIDIA's data sheet for one H100 SXM, dense, at the full 700 W
power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate or operations
    over the float32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rotation_bytes(streams: int, channels: int, frame: int) -> int:
    """Bytes one pass of the spreading rotation (`rot_pass`) must move
    over a step's spectra: the plane x [streams, channels * frame] and its
    four coefficient planes (cos, sin, chain offset, chain length; 4 bytes
    each) read once, the rotated plane written once.  Every position takes
    part (an unrotated one as the identity), so the count does not depend
    on the data."""
    return streams * channels * frame * 6 * 4


def rotation_bound_ms(streams: int, channels: int, frame: int) -> float:
    """A launch's least time: no operation count reaches its bytes' time
    (a rotation is 6 flops a position against 24 bytes)."""
    n = streams * channels * frame
    return bound_ms(rotation_bytes(streams, channels, frame), 6 * n)[0]
