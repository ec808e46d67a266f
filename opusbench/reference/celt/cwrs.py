"""CWRS: indexing of PVQ codewords (RFC 6716 sec. 4.3.4.3), a copy of
opus_tpu.celt.cwrs.

V(N, K) counts the N-dimensional integer vectors with sum(|y|) = K;
rows of the U table come from its recurrence in exact Python integers.

Below this docstring the code is the reference's decode side, unchanged;
the encoder's functions are taken out.
"""

from __future__ import annotations

import numpy as np

# _U_ROWS[n] is the list [U(n,0), U(n,1), ...], grown lazily.
_U_ROWS: list[list[int]] = []


def _row(n: int, kmax: int) -> list[int]:
    """Return U(n, .) valid through index kmax."""
    while len(_U_ROWS) <= n:
        _U_ROWS.append([])
    row = _U_ROWS[n]
    if len(row) > kmax:
        return row
    if n == 0:
        # U(0,0)=1 anchors the recurrence; no pulses fit in zero dims.
        if not row:
            row.append(1)
        row.extend([0] * (kmax + 1 - len(row)))
        return row
    if not row:
        row.append(0)  # U(n,0) = 0 for n > 0
    if n == 1:
        row.extend([1] * (kmax + 1 - len(row)))
        return row
    prev = _row(n - 1, kmax)
    for k in range(len(row), kmax + 1):
        row.append(prev[k] + row[k - 1] + prev[k - 1])
    return row


def pvq_u(n: int, k: int) -> int:
    """U(n, k), exploiting U(n, k) == U(k, n) to keep rows short."""
    if n < k:
        n, k = k, n
    return _row(n, k)[k]


def pvq_v(n: int, k: int) -> int:
    """V(n, k) = U(n, k) + U(n, k+1): number of PVQ codewords."""
    return pvq_u(n, k) + pvq_u(n, k + 1)


def cwrsi(n: int, k: int, i: int) -> np.ndarray:
    """Index -> codeword (reference: pvc.rs:182-284).

    Walks dimensions from the first, peeling off how many pulses (and what
    sign) each one holds by locating ``i`` within the stacked U ranges.
    """
    assert k > 0 and n > 1
    y = np.zeros(n, dtype=np.int32)
    out = 0
    while n > 2:
        if k >= n:
            # More pulses than dimensions: this coefficient is likely big.
            p = pvq_u(n, k + 1)
            s = i >= p
            if s:
                i -= p
            k0 = k
            q = pvq_u(n, n)
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = pvq_u(n, k)
                    if p <= i:
                        break
            else:
                while True:
                    p = pvq_u(n, k)
                    if p <= i:
                        break
                    k -= 1
            i -= p
            val = k0 - k
            y[out] = -val if s else val
        else:
            # More dimensions than pulses: this coefficient is likely zero.
            p = pvq_u(k, n)
            q = pvq_u(k + 1, n)
            if p <= i < q:
                i -= p
                y[out] = 0
            else:
                s = i >= q
                if s:
                    i -= q
                k0 = k
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
                i -= p
                val = k0 - k
                y[out] = -val if s else val
        out += 1
        n -= 1
    # n == 2: U(2,k) = 2k-1 in closed form.
    p = 2 * k + 1
    s = i >= p
    if s:
        i -= p
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    val = k0 - k
    y[out] = -val if s else val
    # n == 1: only the sign remains.
    y[out + 1] = -k if i else k
    return y


def decode_pulses(dec, n: int, k: int) -> tuple[np.ndarray, int]:
    """Range-decode a PVQ codeword; returns (y, sum(y^2)) — the energy is
    needed for unit-norm scaling (reference: pvc.rs:156-160)."""
    y = cwrsi(n, k, dec.decode_uint(pvq_v(n, k)))
    return y, int(np.sum(y.astype(np.int64) ** 2))


# ---------------------------------------------------------------------------
# Pulse-count <-> pseudo-pulse scale and codebook bit costs (rate.c analogs).
# ---------------------------------------------------------------------------

MAX_PSEUDO = 40
MAX_PULSES = 128


def get_pulses(i: int) -> int:
    """Pseudo-pulse index -> actual pulse count (geometric above 8)."""
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def fits_in32(n: int, k: int) -> bool:
    """Whether V(n, k) fits a 32-bit word (exact; replaces libopus'
    conservative max-N/max-K lookup with a direct check)."""
    return pvq_v(n, k) < (1 << 32)


def log2_frac(val: int, frac: int) -> int:
    """log2(val) in 1/2**frac units, rounded up with libopus' exact
    fixed-point schedule (entcode semantics).

    This is *almost* ceil(log2(val)*2**frac) but must match bit-for-bit:
    the mantissa is first rounded up to 16 bits, then squared frac+1 times
    with round-to-nearest, extracting one result bit per squaring — the
    slight upward bias occasionally lands one unit above the true ceiling
    (e.g. V(11,9): true 176.99997 -> 178, not 177), and the allocator
    tables depend on it.
    """
    assert val > 0
    l = val.bit_length()
    if val & (val - 1):
        # Round the mantissa up into (2^15, 2^16].
        if l > 16:
            val = ((val - 1) >> (l - 16)) + 1
        else:
            val <<= 16 - l
        l = (l - 1) << frac
        while True:
            b = val >> 16
            l += b << frac
            val >>= b
            val = (val * val + 0x7FFF) >> 15
            if frac == 0:
                break
            frac -= 1
        return l + (1 if val > 0x8000 else 0)
    # Exact powers of two need no rounding.
    return (l - 1) << frac
