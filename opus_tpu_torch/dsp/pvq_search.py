"""The encode plane's greedy PVQ search: the CUDA kernel's wrapper and its
plain version, and the packed layout of the pulses.

`pvq_search` computes what the reference's `make_encode_search` computes
(opus_tpu/dsp/encode_exec.py:165): for every leaf of the host's leaf
table it applies the per-band stereo op the plan pass chose to the
unit-normalised spectra, gathers the leaf's span, and places its K
pulses by the greedy projection search of libopus's op_pvq_search (the
projection prefill when K > n / 2, then one pulse a trip at the first
maximum of (xy + |x_j|)^2 / (yy + 1 + 2 iy_j)).

The pulses are packed.  A leaf of the table [B, P, 4] (plane, offset, n,
K; n == 0 an unused row) has the width min(n, n_max); `iy` is one flat
int16 buffer of every used leaf's signed pulses, stream by stream and
within a stream in plan order (row p ascending), so leaf (b, p) starts
at the exclusive cumulative sum of the widths before it.  `leaf_order`
makes, with one numpy pass over the table, the row list the kernel
walks: (b * P + p, start) of every used leaf, grouped into the width
classes of CLASS_TILES (`class_ranges`), and `pvq_search` takes that
`LeafOrder` whole, with the row list already on the card where the
caller uploaded it (`LeafOrder.on`).  `pack` / `unpack` convert between
this layout and the reference's padded [B, P, n_max]; `PackedRows` gives
one stream's rows as the emit pass reads them.

It is not a TPU kernel: the reference runs the trips as a
`lax.while_loop` (:265) of up to t_max trips over the whole [B, P, NMAX]
leaf area, whose exit test `any(left > 0)` would cost eager torch a
device-to-host read a trip.  On a CUDA tensor `pvq_search` launches one
hand-written kernel for the whole batch (csrc/pvq.cu: a leaf of width <=
8, 16 or 32 on a tile of that many lanes, a wider one on a warp; each
leaf its own loop; unused rows launch nothing), counts the launch, and
raises if it does not build or launch.  On a CPU tensor it packs
`_pvq_search_ref`, a fixed loop of t_max trips in plain torch.

Both fix every rounding the same way, so that kernel and plain version
agree pulse for pulse: each product, sum and quotient is one IEEE float32
operation (the quotient correctly rounded, never a multiply by a
reciprocal); the only order-dependent sums, sum |x| and xy of the
prefill, are taken in the kernel's lane order (`_lane_sum`: lane l holds
positions l, l + 32, ..., summed in that order, then a butterfly over
the 32 lane sums; a tile of w lanes skips the levels whose partners
hold only zeros, which gives the same sums); every other sum is of
integers or of a one-hot, and exact.  The reference sums in XLA's order,
so the plain version equals it up to that rounding.

`left`: a leaf with left0 = K - (prefill pulses) > 0 places min(left0,
t_max) pulses and returns max(left0 - t_max, 0), as the reference does
(t_max = 128 < NMAX = 176 is the reference's, kept); an unused row 0.  A
leaf whose prefill overshot K would return 0 here, and in the reference
only if some leaf of the batch ran a trip; no batch shows it: the prefill
places at most floor of a sum within a few float32 roundings of K + 0.8,
so it overshoots only for K of about 10^4, and a CELT leaf has K <= 128.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..celt import modes

NB = modes.NB_E_BANDS
LANES = 32
SLOTS = 6  # positions a lane of the widest class holds in the kernel: NMAX <= 192
#: lanes a leaf takes in each width class, in the row list's order (csrc/pvq.cu's
#: kTiles): class 0 a warp a leaf, ceil(n / 32) slots a lane, for every n wider
#: than the next class holds; class c > 0 a tile of CLASS_TILES[c] lanes, one
#: position a lane, for n up to CLASS_TILES[c]
CLASS_TILES = (32, 32, 16, 8)
EPSILON = float(np.float32(1e-15))
RT2 = float(np.float32(np.sqrt(0.5)))


def class_ranges(n_max: int = 176) -> tuple:
    """(least n, greatest n) of each width class, in the row list's order:
    ((33, n_max), (17, 32), (9, 16), (1, 8))."""
    edges = CLASS_TILES[1:]
    return tuple(zip((*(e + 1 for e in edges), 1), (n_max, *edges)))


def _class_of(widths: np.ndarray) -> np.ndarray:
    """The width class of each width >= 1."""
    return len(CLASS_TILES) - 1 - np.searchsorted(np.array(CLASS_TILES[:0:-1]), widths,
                                                  side="left")


class LeafOrder(NamedTuple):
    """The packed layout of one leaf table (`leaf_order`)."""

    rows: np.ndarray  # [R, 2] int32: (b * P + p, start in iy) of the used leaves, by class
    counts: tuple  # the used leaves of each class of CLASS_TILES
    starts: np.ndarray  # [B, P] int64: each leaf's first pulse in iy
    widths: np.ndarray  # [B, P] int64: min(n, n_max), 0 on an unused row
    total: int  # the pulses of iy
    n_max: int  # the widest leaf the widths count
    device_rows: torch.Tensor | None = None  # `rows` on the search's device (`on`)

    def on(self, device_rows: torch.Tensor) -> LeafOrder:
        """This layout with its row list already on the search's device
        (a caller that uploads it with other inputs in one copy)."""
        return self._replace(device_rows=device_rows)


def leaf_order(leaves: np.ndarray, n_max: int = 176) -> LeafOrder:
    """The packed layout of leaves [B, P, 4] (numpy): the starts are the
    exclusive cumulative sum of the widths in (b, p) order; the row list
    holds every used row once, grouped by class and in row order within
    one."""
    B, P = leaves.shape[:2]
    widths = np.clip(leaves[..., 2].reshape(-1).astype(np.int64), 0, n_max)
    ends = np.cumsum(widths)
    starts = ends - widths
    used = np.flatnonzero(widths)
    cls = _class_of(widths[used])
    rows = used[np.argsort(cls, kind="stable")]
    return LeafOrder(np.stack([rows, starts[rows]], -1).astype(np.int32),
                     tuple(int(c) for c in np.bincount(cls, minlength=len(CLASS_TILES))),
                     starts.reshape(B, P), widths.reshape(B, P),
                     int(ends[-1]) if ends.size else 0, n_max)


def _packed_mask(leaves, n_max: int):
    """[B, P, n_max] bool: the positions the packed layout keeps."""
    n = leaves[..., 2].to(torch.int64).clamp(max=n_max)
    return torch.arange(n_max, device=leaves.device) < n[..., None]


def pack(iy, leaves, n_max: int = 176):
    """Padded iy [B, P, n_max] -> the packed int16 iy of these leaves."""
    return iy[_packed_mask(leaves, n_max)].to(torch.int16)


def unpack(iy, leaves, n_max: int = 176):
    """Packed iy -> the padded [B, P, n_max] int32 (zero past each width
    and on unused rows)."""
    mask = _packed_mask(leaves, n_max)
    out = torch.zeros(mask.shape, dtype=torch.int32, device=iy.device)
    out[mask] = iy.to(torch.int32)
    return out


class PackedRows:
    """Stream b's rows of a packed iy (numpy) as the emit pass reads them:
    len() runs to the stream's last used row, so emit's iterator stops
    there and fills zeros past it, and row r is padded to n_max: its
    leaf's pulses, then zeros, as the padded layout's row."""

    def __init__(self, flat: np.ndarray, order: LeafOrder, b: int, n_max: int):
        self._flat = flat
        self._starts, self._widths = order.starts[b], order.widths[b]
        used = np.flatnonzero(self._widths)
        self._count = int(used[-1]) + 1 if used.size else 0
        self._n_max = n_max

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, r: int) -> np.ndarray:
        if not 0 <= r < self._count:
            raise IndexError(r)
        s, w = self._starts[r], self._widths[r]
        row = np.zeros(self._n_max, self._flat.dtype)
        row[:w] = self._flat[s : s + w]
        return row


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


def _check(x, band_ops, leaves, order: LeafOrder, lm: int, n_max: int, t_max: int):
    """Validate the inputs; return the row list on x's device."""
    if x.dim() != 3 or x.shape[1] not in (1, 2) or x.shape[2] != modes.SHORT_MDCT_SIZE << lm:
        raise ValueError(f"x must be [B, 1 or 2, {modes.SHORT_MDCT_SIZE << lm}], got "
                         f"{tuple(x.shape)}")
    B = x.shape[0]
    if leaves.dim() != 3 or leaves.shape[0] != B or leaves.shape[2] != 4:
        raise ValueError(f"leaves must be [{B}, P, 4], got {tuple(leaves.shape)}")
    if not 0 < n_max <= LANES * SLOTS or t_max < 0:
        raise ValueError(f"n_max must be in 1..{LANES * SLOTS} and t_max >= 0, got "
                         f"{n_max}, {t_max}")
    # The layout against itself and the table's shape, in a few us: the
    # rows, the total against the last start, and each class's first and
    # last row inside its n range (a count moved from one class to the
    # next moves a row across the edge).  The widths against the table's n
    # are checked on the CPU only: on the card that is a device-to-host read.
    widths = order.widths
    if order.n_max != n_max or widths.shape != tuple(leaves.shape[:2]):
        raise ValueError(f"the leaf order is of a {widths.shape} table at n_max "
                         f"{order.n_max}, the search of {tuple(leaves.shape[:2])} at {n_max}")
    if (len(order.counts) != len(CLASS_TILES) or min(order.counts) < 0
            or order.rows.shape != (sum(order.counts), 2)
            or order.total != (int(order.starts.flat[-1] + widths.flat[-1]) if widths.size else 0)):
        raise ValueError(f"the leaf order's counts {order.counts}, rows {order.rows.shape} and "
                         f"total {order.total} do not agree with each other and its widths")
    flat, end = widths.reshape(-1), 0
    for (lo, hi), n in zip(class_ranges(n_max), order.counts):
        end += n
        for i in (end - n, end - 1) if n else ():
            r = int(order.rows[i, 0])
            if not (0 <= r < flat.size and lo <= flat[r] <= hi):
                raise ValueError(f"the leaf order's counts {order.counts} do not group its "
                                 f"rows by width class")
    if x.device.type == "cpu" and not np.array_equal(
            widths, np.clip(leaves[..., 2].numpy(), 0, n_max)):
        raise ValueError("the leaf order is not that of these leaves")
    rows = order.device_rows
    if rows is None:
        rows = torch.from_numpy(order.rows).to(x.device)
    for name, t, shape, dtype in (("x", x, tuple(x.shape), torch.float32),
                                  ("band_ops", band_ops, (B, NB, 4), torch.float32),
                                  ("leaves", leaves, tuple(leaves.shape), torch.int32),
                                  ("rows", rows, order.rows.shape, torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rows


def _kernel_args(x, band_ops, leaves, rows, order: LeafOrder, iy, left, lm: int, t_max: int):
    """The C arguments of one launch into iy, left on checked CUDA tensors
    (rows: the order's row list on the card), but the stream (which
    `_build.launch` adds)."""
    B, C, n2 = x.shape
    return (x.data_ptr(), band_ops.data_ptr(), leaves.data_ptr(), rows.data_ptr(),
            iy.data_ptr(), left.data_ptr(), B, leaves.shape[1], C, n2, lm, order.n_max, t_max,
            *order.counts, order.total)


def pvq_search(x, band_ops, leaves, order: LeafOrder, lm: int = 3, n_max: int = 176,
               t_max: int = 128):
    """Greedy PVQ search of every used leaf: x [B, C, N2] float32
    unit-normalised spectra, band_ops [B, NB, 4] float32 (op, a1, a2, _: op
    2 mid/side, 3 intensity mix a1 x0 + a2 x1, else the channel planes as
    they are), leaves [B, P, 4] int32 (plane, flat offset, n, K; n == 0 an
    unused row), all contiguous on one device, and the table's packed
    layout (`leaf_order(leaves, n_max)`; its row list is copied to the
    device here unless the caller put it there, `LeafOrder.on`).  Returns
    (iy [order.total] int16, the signed pulses packed in plan order, left
    [B, P] int32, the pulses t_max trips left unplaced).  A CUDA tensor
    goes through the kernel (each launch adds one to `pvq_search.launches`;
    a table with no used leaf launches nothing); a CPU tensor through
    `_pvq_search_ref`, packed."""
    rows = _check(x, band_ops, leaves, order, lm, n_max, t_max)
    if x.device.type == "cpu":
        iy, left = _pvq_search_ref(x, band_ops, leaves, lm, n_max, t_max)
        return pack(iy, leaves, n_max), left
    if x.device.type != "cuda":
        raise ValueError(f"pvq_search runs on cpu or cuda, not {x.device}")
    for name, t, align in (("band_ops", band_ops, 16), ("leaves", leaves, 16), ("rows", rows, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned (the kernel reads a row "
                             f"as one vector)")
    from .. import _build

    iy = torch.empty(order.total, dtype=torch.int16, device=x.device)
    left = torch.empty(leaves.shape[:2], dtype=torch.int32, device=x.device)
    _build.launch("opus_pvq_search", x.device,
                  _kernel_args(x, band_ops, leaves, rows, order, iy, left, lm, t_max))
    if order.total:
        pvq_search.launches += 1
    return iy, left


pvq_search.launches = 0
