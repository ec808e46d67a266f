"""The CELT mode constants the port reads: 48 kHz, 21 energy bands.

Each is a copy of the reference's and must stay bit-identical to it
(tests/test_torch_tables.py); the port keeps its own copy so that it
imports nothing of `opus_tpu`.
"""

from __future__ import annotations

import numpy as np

# From opus_tpu/celt/modes.py.
#: MDCT low-overlap region length.
OVERLAP = 120
MAX_LM = 3
SHORT_MDCT_SIZE = 120
NB_E_BANDS = 21

#: De-emphasis filter coefficient.
PREEMPH = np.float32(0.8500061)

#: Band boundaries in units of 4 bins at LM=0.
E_BANDS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100],
    dtype=np.int32,
)


def _make_window(overlap: int = OVERLAP) -> np.ndarray:
    """The CELT low-overlap MDCT window: W(n) = sin(pi/2 * sin^2(pi/2 *
    (n+.5)/L)) (Vorbis window)."""
    n = (np.arange(overlap, dtype=np.float64) + 0.5) / overlap
    inner = np.sin(0.5 * np.pi * n)
    return np.sin(0.5 * np.pi * inner * inner).astype(np.float32)


WINDOW = _make_window()

# From opus_tpu/celt/decoder.py: decode-memory history per channel.
DECODE_BUFFER_SIZE = 2048

# From opus_tpu/celt/comb_filter.py: comb filter tap gains per tapset.
GAINS = (
    (0.3066406250, 0.2170410156, 0.1296386719),
    (0.4638671875, 0.2680664062, 0.0),
    (0.7998046875, 0.1000976562, 0.0),
)

# From opus_tpu/celt/energy.py: mean log-energy per band (float build).
E_MEANS = np.array(
    [6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
     4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
     3.75, 3.75, 3.75, 3.75, 3.75],
    dtype=np.float32,
)
