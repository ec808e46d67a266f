"""The encode plane's greedy PVQ search: the CUDA kernel's wrapper and its
plain version.

`pvq_search` computes what the reference's `make_encode_search` computes
(opus_tpu/dsp/encode_exec.py:165): for every leaf of the host's leaf
table it applies the per-band stereo op the plan pass chose to the
unit-normalised spectra, gathers the leaf's span, and places its K
pulses by the greedy projection search of libopus's op_pvq_search (the
projection prefill when K > n / 2, then one pulse a trip at the first
maximum of (xy + |x_j|)^2 / (yy + 1 + 2 iy_j)).

It is not a TPU kernel: the reference runs the trips as a
`lax.while_loop` (:265) of up to t_max trips over the whole [B, P, NMAX]
leaf area, whose exit test `any(left > 0)` would cost eager torch a
device-to-host read a trip.  On a CUDA tensor `pvq_search` launches one
hand-written kernel for the whole batch (csrc/pvq.cu, one warp a leaf,
each leaf its own loop), counts the launch, and raises if it does not
build or launch.  On a CPU tensor it runs `_pvq_search_ref`, a fixed loop
of t_max trips in plain torch.

Both fix every rounding the same way, so that kernel and plain version
agree pulse for pulse: each product, sum and quotient is one IEEE float32
operation (the quotient correctly rounded, never a multiply by a
reciprocal); the only order-dependent sums, sum |x| and xy of the
prefill, are taken in the kernel's lane order (`_lane_sum`: lane l holds
positions l, l + 32, ..., summed in that order, then a butterfly over
the 32 lane sums); every other sum is of integers or of a one-hot, and
exact.  The reference sums in XLA's order, so the plain version equals
it up to that rounding.

`left`: a leaf with left0 = K - (prefill pulses) > 0 places min(left0,
t_max) pulses and returns max(left0 - t_max, 0), as the reference does
(t_max = 128 < NMAX = 176 is the reference's, kept).  A leaf whose
prefill overshot K would return 0 here, and in the reference only if some
leaf of the batch ran a trip; no batch shows it: the prefill places at
most floor of a sum within a few float32 roundings of K + 0.8, so it
overshoots only for K of about 10^4, and a CELT leaf has K <= 128.
"""

from __future__ import annotations

import numpy as np
import torch

from ..celt import modes

NB = modes.NB_E_BANDS
LANES = 32
SLOTS = 6  # positions a lane holds in the kernel: NMAX <= 192
EPSILON = float(np.float32(1e-15))
RT2 = float(np.float32(np.sqrt(0.5)))


def _lane_sum(v):
    """Sum over the last axis (at most LANES * SLOTS long) in the kernel's
    order: lane l sums positions l, l + 32, ... from the first, then the
    32 lane sums meet in a butterfly (16, 8, 4, 2, 1 apart)."""
    n = v.shape[-1]
    v = torch.nn.functional.pad(v, (0, LANES * SLOTS - n)).unflatten(-1, (SLOTS, LANES))
    s = v[..., 0, :]
    for i in range(1, SLOTS):
        s = s + v[..., i, :]
    w = LANES
    while w > 1:
        w //= 2
        s = s[..., :w] + s[..., w : 2 * w]
    return s[..., 0]


def _band_of_position(lm: int, n2: int, device) -> torch.Tensor:
    """[n2] int64: the band that holds each position, NB past the last."""
    e = modes.E_BANDS.astype(np.int64) << lm
    return torch.tensor(np.searchsorted(e, np.arange(n2), side="right") - 1,
                        device=device).clamp(max=NB)


def _prefill(x, band_ops, leaves, lm: int, n_max: int):
    """The search up to its first trip: each leaf's span after its band's
    stereo op, gathered, and the projection prefill.  Returns (ax, sign,
    inside, iy, left0, xy, yy): |x| [B, P, n_max] (e1 where the prefill
    collapsed it), the sign of the source, the leaf mask, the prefill's
    pulses (float32), the pulses still to place (int64) and the two
    running sums."""
    B, C, n2 = x.shape
    P = leaves.shape[1]
    dev = x.device
    ops = torch.cat([band_ops, band_ops.new_zeros(B, 1, 4)], dim=1)  # band NB: op 0
    per_pos = ops[:, _band_of_position(lm, n2, dev)]  # [B, n2, 4]
    op, a1, a2 = per_pos[..., 0], per_pos[..., 1], per_pos[..., 2]
    x0, x1 = x[:, 0], x[:, C - 1]
    mid = torch.where(op == 2, (x0 + x1) * RT2, torch.where(op == 3, a1 * x0 + a2 * x1, x0))
    side = torch.where(op == 2, (x1 - x0) * RT2, x1)
    flat = torch.stack([mid, side], dim=1).reshape(B, 2 * n2)

    pl, off, ln, kk = leaves.to(torch.int64).unbind(-1)
    valid = ln > 0
    j = torch.arange(n_max, device=dev)
    idx = pl.clamp(0, 1)[..., None] * n2 + (off[..., None] + j).clamp(0, n2 - 1)
    src = torch.gather(flat, 1, idx.reshape(B, P * n_max)).reshape(B, P, n_max)
    inn = (j < ln[..., None]) & valid[..., None]
    ax = torch.where(inn, src.abs(), 0.0)
    sg = torch.where(src < 0, -1, 1)

    prel = kk > (ln >> 1)
    sum_ax = _lane_sum(ax)
    degen = prel & ~((sum_ax > EPSILON) & (sum_ax < 64.0))
    e1 = ((j == 0) & inn).to(ax.dtype)
    ax = torch.where(degen[..., None], e1, ax)
    sum_ax = torch.where(degen, 1.0, sum_ax)
    rcp = (kk.to(torch.float32) + 0.8) / sum_ax.clamp_min(EPSILON)
    iy = torch.where(prel[..., None] & inn, torch.floor(rcp[..., None] * ax), 0.0)
    left = torch.where(valid, kk - iy.sum(-1).to(torch.int64), 0)
    return ax, sg, inn, iy, left, _lane_sum(ax * iy), (iy * iy).sum(-1)


def _pvq_search_ref(x, band_ops, leaves, lm: int = 3, n_max: int = 176, t_max: int = 128):
    """Plain torch search: (iy [B, P, n_max] int32, left [B, P] int32)."""
    ax, sg, inn, iy, left, xy, yy = _prefill(x, band_ops, leaves, lm, n_max)
    j = torch.arange(n_max, device=x.device)
    for _ in range(t_max):
        act = left > 0
        yy_ = torch.where(act, yy + 1.0, yy)
        s = xy[..., None] + ax
        den = yy_[..., None] + 2.0 * iy
        sc = torch.where(inn, (s * s) / den.clamp_min(EPSILON), -1.0)
        best = sc.argmax(-1, keepdim=True)  # the first maximum
        ohf = ((j == best) & inn & act[..., None]).to(ax.dtype)
        xy = xy + (ohf * ax).sum(-1)
        yy = yy_ + 2.0 * (ohf * iy).sum(-1)
        iy = iy + ohf
        left = (left - 1).clamp_min(0)
    out = torch.where(inn, sg * iy.to(torch.int32), 0).to(torch.int32)
    return out, left.to(torch.int32)


def _check(x, band_ops, leaves, lm: int, n_max: int, t_max: int) -> None:
    if x.dim() != 3 or x.shape[1] not in (1, 2) or x.shape[2] != modes.SHORT_MDCT_SIZE << lm:
        raise ValueError(f"x must be [B, 1 or 2, {modes.SHORT_MDCT_SIZE << lm}], got "
                         f"{tuple(x.shape)}")
    B = x.shape[0]
    if leaves.dim() != 3 or leaves.shape[0] != B or leaves.shape[2] != 4:
        raise ValueError(f"leaves must be [{B}, P, 4], got {tuple(leaves.shape)}")
    for name, t, shape, dtype in (("x", x, tuple(x.shape), torch.float32),
                                  ("band_ops", band_ops, (B, NB, 4), torch.float32),
                                  ("leaves", leaves, tuple(leaves.shape), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < n_max <= LANES * SLOTS or t_max < 0:
        raise ValueError(f"n_max must be in 1..{LANES * SLOTS} and t_max >= 0, got "
                         f"{n_max}, {t_max}")


def _kernel_args(x, band_ops, leaves, iy, left, lm: int, n_max: int, t_max: int) -> tuple:
    """The C arguments of one launch into iy, left on checked CUDA tensors,
    but the stream (which `_build.launch` adds)."""
    B, C, n2 = x.shape
    return (x.data_ptr(), band_ops.data_ptr(), leaves.data_ptr(), iy.data_ptr(),
            left.data_ptr(), B, leaves.shape[1], C, n2, 1 << lm, n_max, t_max)


def pvq_search(x, band_ops, leaves, lm: int = 3, n_max: int = 176, t_max: int = 128):
    """Greedy PVQ search of every leaf: x [B, C, N2] float32 unit-normalised
    spectra, band_ops [B, NB, 4] float32 (op, a1, a2, _: op 2 mid/side, 3
    intensity mix a1 x0 + a2 x1, else the channel planes as they are),
    leaves [B, P, 4] int32 (plane, flat offset, n, K; n == 0 an unused
    row), all contiguous on one device.  Returns (iy [B, P, n_max] int32,
    the signed pulses of each leaf in its leaf-local order and zero past
    n, left [B, P] int32, the pulses t_max trips left unplaced).  A CUDA
    tensor goes through the kernel (each launch adds one to
    `pvq_search.launches`); a CPU tensor through `_pvq_search_ref`."""
    _check(x, band_ops, leaves, lm, n_max, t_max)
    if x.device.type == "cpu":
        return _pvq_search_ref(x, band_ops, leaves, lm, n_max, t_max)
    if x.device.type != "cuda":
        raise ValueError(f"pvq_search runs on cpu or cuda, not {x.device}")
    if leaves.data_ptr() % 16:
        raise ValueError("leaves must be 16-byte aligned (the kernel reads a row as int4)")
    from .. import _build

    B, P = leaves.shape[:2]
    iy = torch.empty((B, P, n_max), dtype=torch.int32, device=x.device)
    left = torch.empty((B, P), dtype=torch.int32, device=x.device)
    _build.launch("opus_pvq_search", x.device,
                  _kernel_args(x, band_ops, leaves, iy, left, lm, n_max, t_max))
    pvq_search.launches += 1
    return iy, left


pvq_search.launches = 0
