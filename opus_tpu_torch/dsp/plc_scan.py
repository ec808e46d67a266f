"""The two sequential scans of the device loss concealment: the CUDA
kernels' wrappers and their plain versions.

* `pitch_track` walks the lags of a pitch search keeping the two best
  normalised correlations (the reference's `_find_best_pitch`,
  opus_tpu/dsp/plc_exec.py:53, a `lax.scan` over the lags);
* `lpc_synth` runs the order-24 LPC synthesis filter over the extrapolated
  excitation (the reference's `iir_step` scan, plc_exec.py:293-299).

Neither is a TPU kernel: XLA runs each as one device loop.  In eager torch
a loop over lags or samples would cost a launch per operation per step
(thousands per concealing step), so on a CUDA tensor each wrapper launches
a hand-written kernel (csrc/plc.cu), counts the launch, and raises if the
kernel does not build or launch.  On a CPU tensor it runs the plain
version (`_pitch_track_ref`, `_lpc_synth_ref`), which defines what the
kernel computes.

`pitch_track` is exact: its plain version sums the initial energy in the
kernel's order (32 lane partial sums, each in order, then a fixed
butterfly, then 1 added) and rounds every product before it is compared,
as the kernel does, so the two agree index for index.  It differs from
the reference's `_find_best_pitch` only in that initial sum (the
reference sums in XLA's order), so near-ties may break differently there.

`lpc_synth`'s kernel filters a row in chunks and carries the history
across them, which rounds differently from the sequential walk; its
plain version stays the sequential definition, and the kernel is held to
it through a float64 run (within 1e-3 of each row's peak).
"""

from __future__ import annotations

import torch

LPC_ORDER = 24
_LANES = 32  # pitch_track's initial energy: the kernel's warp width


def _pitch_track_ref(xcorr, y, length: int, n_lags: int):
    """Plain two-best pitch tracking over lags 0..n_lags-1.

    xcorr [R, >= n_lags] f32, y [R, >= length + n_lags] f32 -> (bp0, bp1)
    int32 [R]: the best and second-best lag.  syy starts at 1 + the
    energy of y[:length] and moves by y[i+length]^2 - y[i]^2 after lag i,
    clamped at 1.  The energy is summed as the kernel's warp sums it:
    partial l adds y[t]^2 for t = l, l + 32, ... in order, then halves
    of the 32 partials are added (16, 8, 4, 2, 1), then 1."""
    R = xcorr.shape[0]
    dev = xcorr.device
    y2 = y * y
    head = y2[:, :length]
    head = torch.cat([head, head.new_zeros(R, -length % _LANES)], dim=1)
    part = torch.zeros(R, _LANES, dtype=torch.float32, device=dev)
    for c in range(head.shape[1] // _LANES):
        part = part + head[:, c * _LANES : (c + 1) * _LANES]
    k = _LANES // 2
    while k:
        part = part[:, :k] + part[:, k : 2 * k]
        k //= 2
    syy = 1.0 + part[:, 0]
    deltas = y2[:, length : length + n_lags] - y2[:, :n_lags]
    bn0 = torch.full((R,), -1.0, device=dev)
    bd0 = torch.zeros(R, device=dev)
    bp0 = torch.zeros(R, dtype=torch.int32, device=dev)
    bn1 = torch.full((R,), -1.0, device=dev)
    bd1 = torch.zeros(R, device=dev)
    bp1 = torch.ones(R, dtype=torch.int32, device=dev)
    for i in range(n_lags):
        xc = xcorr[:, i]
        x16 = xc * 1e-12
        num = x16 * x16
        better1 = (xc > 0) & (num * bd1 > bn1 * syy)
        # the second-best check only runs when the first passed
        better0 = better1 & (num * bd0 > bn0 * syy)
        bn1 = torch.where(better0, bn0, torch.where(better1, num, bn1))
        bd1 = torch.where(better0, bd0, torch.where(better1, syy, bd1))
        bp1 = torch.where(better0, bp0, torch.where(better1, i, bp1))
        bn0 = torch.where(better0, num, bn0)
        bd0 = torch.where(better0, syy, bd0)
        bp0 = torch.where(better0, i, bp0)
        syy = torch.clamp_min(syy + deltas[:, i], 1.0)
    return bp0, bp1


def _lpc_synth_ref(ext, lpc, hist0):
    """Plain LPC synthesis: out[t] = ext[t] - sum_j lpc[j] * out[t-1-j],
    with out[-1-j] = hist0[j].  ext [R, el], lpc / hist0 [R, 24], any
    float dtype (the smoke runs it in float64 as the yardstick)."""
    hist = hist0
    outs = []
    for t in range(ext.shape[1]):
        acc = ext[:, t] - torch.sum(lpc * hist, dim=-1)
        hist = torch.cat([acc[:, None], hist[:, :-1]], dim=1)
        outs.append(acc)
    return torch.stack(outs, dim=1)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_pitch(xcorr, y, length, n_lags):
    R = xcorr.shape[0]
    if xcorr.dim() != 2 or y.dim() != 2 or y.shape[0] != R:
        raise ValueError(f"xcorr [R, L] and y [R, W], got {tuple(xcorr.shape)} and "
                         f"{tuple(y.shape)}")
    if not (0 < n_lags <= xcorr.shape[1] and length > 0 and length + n_lags <= y.shape[1]):
        raise ValueError(f"length={length} n_lags={n_lags} do not fit xcorr "
                         f"{tuple(xcorr.shape)} and y {tuple(y.shape)}")
    _check("xcorr", xcorr, xcorr.shape, torch.float32, y.device)
    _check("y", y, y.shape, torch.float32, xcorr.device)
    if xcorr.stride(1) != 1:
        raise ValueError("xcorr rows must be contiguous")


def _pitch_kernel_args(xcorr, y, length, n_lags, bp0, bp1) -> tuple:
    """The C arguments of one pitch_track launch, but the stream: y is read
    at its strides (the coarse search passes a stride-2 view)."""
    return (xcorr.data_ptr(), xcorr.stride(0), y.data_ptr(), y.stride(0), y.stride(1),
            xcorr.shape[0], length, n_lags, bp0.data_ptr(), bp1.data_ptr())


def pitch_track(xcorr, y, length: int, n_lags: int):
    """Two-best pitch tracking: (bp0, bp1) int32 [R].  A CUDA tensor goes
    through the kernel (each launch adds one to `pitch_track.launches`);
    a CPU tensor through `_pitch_track_ref`."""
    _check_pitch(xcorr, y, length, n_lags)
    if xcorr.device.type == "cpu":
        return _pitch_track_ref(xcorr, y, length, n_lags)
    if xcorr.device.type != "cuda":
        raise ValueError(f"pitch_track runs on cpu or cuda, not {xcorr.device}")
    from .. import _build

    R = xcorr.shape[0]
    bp = torch.empty(2, R, dtype=torch.int32, device=xcorr.device)
    _build.launch("opus_pitch_track", xcorr.device,
                  _pitch_kernel_args(xcorr, y, length, n_lags, bp[0], bp[1]))
    pitch_track.launches += 1
    return bp[0], bp[1]


pitch_track.launches = 0


def _check_synth(ext, lpc, hist0):
    if ext.dim() != 2:
        raise ValueError(f"ext must be [R, el], got {tuple(ext.shape)}")
    R = ext.shape[0]
    _check("ext", ext, ext.shape, torch.float32, ext.device)
    _check("lpc", lpc, (R, LPC_ORDER), torch.float32, ext.device)
    _check("hist0", hist0, (R, LPC_ORDER), torch.float32, ext.device)
    for name, t in (("ext", ext), ("lpc", lpc), ("hist0", hist0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _synth_kernel_args(ext, lpc, hist0, out) -> tuple:
    """The C arguments of one lpc_synth launch into `out`, but the stream."""
    return (ext.data_ptr(), lpc.data_ptr(), hist0.data_ptr(), out.data_ptr(),
            ext.shape[0], ext.shape[1])


def lpc_synth(ext, lpc, hist0):
    """Order-24 LPC synthesis of ext [R, el] f32 with lpc [R, 24] and the
    history hist0 [R, 24] (hist0[j] = the sample 1+j before ext[0]); all
    contiguous f32 on one device.  Returns a new [R, el] tensor.  A CUDA
    tensor goes through the kernel (each launch adds one to
    `lpc_synth.launches`); a CPU tensor through `_lpc_synth_ref`."""
    _check_synth(ext, lpc, hist0)
    if ext.device.type == "cpu":
        return _lpc_synth_ref(ext, lpc, hist0)
    if ext.device.type != "cuda":
        raise ValueError(f"lpc_synth runs on cpu or cuda, not {ext.device}")
    from .. import _build

    out = torch.empty_like(ext)
    _build.launch("opus_lpc_synth", ext.device, _synth_kernel_args(ext, lpc, hist0, out))
    lpc_synth.launches += 1
    return out


lpc_synth.launches = 0
