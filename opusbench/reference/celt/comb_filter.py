"""CELT pitch post-filter on the host (a copy of opus_tpu.celt.comb_filter).

The 5-tap comb filter at pitch lag T, blocked into lag-sized chunks so
numpy vectorises each chunk.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import numpy as np

MIN_PERIOD = 15

#: Filter taps per tapset (reference comb_filter/mod.rs:45-55).
GAINS = (
    (0.3066406250, 0.2170410156, 0.1296386719),
    (0.4638671875, 0.2680664062, 0.0),
    (0.7998046875, 0.1000976562, 0.0),
)


def comb_filter_const_inplace(x: np.ndarray, offset: int, t: int, n: int, g0: float, g1: float, g2: float) -> None:
    """y[i] = x[i] + g0*y[i-T] + g1*(y[i-T+1]+y[i-T-1]) + g2*(y[i-T+2]+y[i-T-2])
    over x[offset:offset+n], in place."""
    if n <= 0:
        return
    # Safe chunk: outputs i..i+L-1 only read indices < i when L <= t-2.
    step = max(1, t - 2)
    i = 0
    while i < n:
        m = min(step, n - i)
        base = offset + i
        lag = base - t
        seg = (
            x[base : base + m]
            + g0 * x[lag : lag + m]
            + g1 * (x[lag + 1 : lag + 1 + m] + x[lag - 1 : lag - 1 + m])
            + g2 * (x[lag + 2 : lag + 2 + m] + x[lag - 2 : lag - 2 + m])
        )
        x[base : base + m] = seg
        i += m


def comb_filter(
    x: np.ndarray, offset: int, t0: int, t1: int, n: int,
    g0: float, g1: float, tapset0: int, tapset1: int,
    window: np.ndarray, overlap: int,
) -> None:
    """Apply the post-filter in place on x[offset:offset+n], cross-fading
    from (g0,t0,tapset0) to (g1,t1,tapset1) over ``overlap`` samples with
    the squared MDCT window (libopus comb_filter)."""
    if g0 == 0.0 and g1 == 0.0:
        return
    t0 = max(t0, MIN_PERIOD)
    t1 = max(t1, MIN_PERIOD)
    g00 = g0 * GAINS[tapset0][0]
    g01 = g0 * GAINS[tapset0][1]
    g02 = g0 * GAINS[tapset0][2]
    g10 = g1 * GAINS[tapset1][0]
    g11 = g1 * GAINS[tapset1][1]
    g12 = g1 * GAINS[tapset1][2]

    if g0 == g1 and t0 == t1 and tapset0 == tapset1:
        ov = 0
    else:
        ov = min(overlap, n)

    # Cross-fade region: sequential because the new-filter taps read the
    # in-place history at lag t1 (a rolling 5-tap delay line).
    x1 = x[offset - t1 + 1]
    x2 = x[offset - t1]
    x3 = x[offset - t1 - 1]
    x4 = x[offset - t1 - 2]
    for i in range(ov):
        x0 = x[offset + i - t1 + 2]
        f = float(window[i]) * float(window[i])
        x[offset + i] = (
            x[offset + i]
            + (1.0 - f) * g00 * x[offset + i - t0]
            + (1.0 - f) * g01 * (x[offset + i - t0 + 1] + x[offset + i - t0 - 1])
            + (1.0 - f) * g02 * (x[offset + i - t0 + 2] + x[offset + i - t0 - 2])
            + f * g10 * x2
            + f * g11 * (x1 + x3)
            + f * g12 * (x0 + x4)
        )
        x4 = x3
        x3 = x2
        x2 = x1
        x1 = x0
    if g1 == 0.0:
        return
    comb_filter_const_inplace(x, offset + ov, t1, n - ov, g10, g11, g12)
