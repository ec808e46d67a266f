"""CELT pitch post-filter: the CUDA kernel's wrapper and its plain version.

`postfilter` applies the post-filter in place over y[..., hist:hist+n].
On a CUDA tensor it launches the hand-written kernel (csrc/postfilter.cu,
the port of opus_tpu/dsp/pallas_pf.py::_pf_kernel) and raises if the
kernel does not build or launch: one launch and no other device work,
since the kernel reads periods, gains and tapsets in place and picks
each row's chunk itself.  On a CPU tensor it runs `_postfilter_ref`, the
plain torch port of opus_tpu.dsp.synthesis._postfilter, which defines the
semantics the kernel is held to.
"""

from __future__ import annotations

import torch

from ..celt import modes
from .tables import PF_CHUNKS, _tap_gains, _window_sq, on_device

OVERLAP = modes.OVERLAP
_MIN_PERIOD, _MAX_PERIOD = 15, 1024


def _pf_window(y, i0, t, chunk):
    """One gather: y[i0-t-2 : i0-t+chunk+2] per stream.  [B, C, chunk+4]."""
    w = chunk + 4
    start = torch.clamp(i0 - 2 - t, 0, y.shape[-1] - w)
    idx = start[:, None, None] + torch.arange(w, device=y.device)[None, None, :]
    return torch.gather(y, -1, idx.expand(y.shape[0], y.shape[1], w))


def _pf_tap5(win, taps, chunk):
    """5-tap symmetric comb from a gathered window (static slices)."""
    s = win[..., 2 : 2 + chunk]
    s1 = win[..., 1 : 1 + chunk] + win[..., 3 : 3 + chunk]
    s2 = win[..., 0:chunk] + win[..., 4 : 4 + chunk]
    return (
        taps[:, 0][:, None, None] * s
        + taps[:, 1][:, None, None] * s1
        + taps[:, 2][:, None, None] * s2
    )


def _postfilter_ref(y, hist, n, lm, pf_periods, pf_gains, pf_tapsets, chunk=12):
    """Plain torch post-filter, in place over y[..., hist:hist+n]; returns y.

    Two segments like libopus' comb_filter calls (decoder side): the first
    SHORT_MDCT_SIZE samples crossfade filter 0 -> 1, the remainder
    crossfades 1 -> 2 over OVERLAP samples then runs filter 2 alone.
    `chunk` must satisfy chunk+2 <= every active lag (see pf_chunk_for).
    """
    w2 = on_device(_window_sq, y.device)
    gains_tbl = on_device(_tap_gains, y.device)
    chunk_cf = min(chunk, OVERLAP)
    periods = pf_periods.long()
    tapsets = pf_tapsets.long()

    def seg(off, ln, a, b):
        p_a, g_a, t_a = periods[:, a], pf_gains[:, a], tapsets[:, a]
        p_b, g_b, t_b = periods[:, b], pf_gains[:, b], tapsets[:, b]
        ga = gains_tbl[t_a] * g_a[..., None]
        gb = gains_tbl[t_b] * g_b[..., None]
        same = ((g_a == g_b) & (p_a == p_b) & (t_a == t_b))[:, None, None]
        zero = ((g_a == 0.0) & (g_b == 0.0))[:, None, None]
        zero_b = (g_b == 0.0)[:, None, None]
        # Lags clamped to >= MIN_PERIOD like libopus (zero-gain filters
        # still evaluate); the window clamp keeps garbage lags in range.
        pa = torch.clamp_min(p_a, _MIN_PERIOD)
        pb = torch.clamp_min(p_b, _MIN_PERIOD)

        ncf = min(ln, OVERLAP) // chunk_cf
        for ci in range(ncf):
            i0 = off + ci * chunk_cf
            wh = torch.where(same, 1.0, w2[ci * chunk_cf : (ci + 1) * chunk_cf][None, None, :])
            wa = _pf_window(y, i0, pa, chunk_cf)
            wb = _pf_window(y, i0, pb, chunk_cf)
            contrib = (1.0 - wh) * _pf_tap5(wa, ga, chunk_cf) + wh * _pf_tap5(wb, gb, chunk_cf)
            y[..., i0 : i0 + chunk_cf] += torch.where(zero, 0.0, contrib)

        for ci in range((ln - ncf * chunk_cf) // chunk):
            i0 = off + ncf * chunk_cf + ci * chunk
            contrib = _pf_tap5(_pf_window(y, i0, pb, chunk), gb, chunk)
            y[..., i0 : i0 + chunk] += torch.where(zero_b, 0.0, contrib)

    seg(hist, modes.SHORT_MDCT_SIZE, 0, 1)
    if lm != 0:
        seg(hist + modes.SHORT_MDCT_SIZE, n - modes.SHORT_MDCT_SIZE, 1, 2)
    return y


def _check(y, hist, n, lm, periods, gains, tapsets, chunk):
    if y.dtype != torch.float32 or y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous float32 [B, C, W] tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    if lm not in (0, 1, 2, 3) or n != modes.SHORT_MDCT_SIZE << lm:
        raise ValueError(f"bad frame: lm={lm} n={n}")
    if not 0 <= hist <= y.shape[-1] - n:
        raise ValueError(f"frame [{hist}, {hist + n}) outside a row of {y.shape[-1]}")
    if chunk not in PF_CHUNKS:
        raise ValueError(f"chunk {chunk} not in {PF_CHUNKS}")
    for name, t, is_float in (("periods", periods, False), ("gains", gains, True),
                              ("tapsets", tapsets, False)):
        if t.shape != (y.shape[0], 3) or t.device != y.device:
            raise ValueError(f"{name} must be [{y.shape[0]}, 3] on {y.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.is_floating_point() != is_float or (is_float and t.dtype != torch.float32):
            raise ValueError(f"{name} has dtype {t.dtype}")


def postfilter(y, hist, n, lm, periods, gains, tapsets, chunk=12):
    """Apply the CELT pitch post-filter in place over y[..., hist:hist+n].

    y [B, C, W] f32 contiguous; periods/tapsets [B, 3] int, gains [B, 3]
    f32 (filters old/current/new), any strides; chunk from pf_chunk_for.
    Returns y.  A CUDA tensor goes through the kernel (each launch adds
    one to `postfilter.launches`), which takes int32 periods and tapsets
    and chooses each row's chunk itself (the result does not depend on
    it); a CPU tensor through `_postfilter_ref` at `chunk`.
    """
    _check(y, hist, n, lm, periods, gains, tapsets, chunk)
    if y.device.type == "cpu":
        return _postfilter_ref(y, hist, n, lm, periods, gains, tapsets, chunk)
    if y.device.type != "cuda":
        raise ValueError(f"postfilter runs on cpu or cuda, not {y.device}")
    if hist < _MAX_PERIOD + 2:
        raise ValueError(f"hist={hist}: the kernel needs {_MAX_PERIOD + 2} samples "
                         "of history before the frame")
    if periods.dtype != torch.int32 or tapsets.dtype != torch.int32:
        raise ValueError(f"the kernel reads int32 periods and tapsets, got "
                         f"{periods.dtype} and {tapsets.dtype}")
    from .. import _build

    _build.launch("opus_postfilter", y.device, _kernel_args(y, hist, n, lm, periods, gains,
                                                           tapsets))
    postfilter.launches += 1
    return y


postfilter.launches = 0


def _kernel_args(y, hist, n, lm, periods, gains, tapsets) -> tuple:
    """The C arguments of one launch on checked CUDA tensors, but the
    stream (which `_build.launch` adds): the per-stream parameters in
    place at their strides, and WINDOW^2 (uploaded once per device)."""
    B, C, W = y.shape
    return (y.data_ptr(), periods.data_ptr(), *periods.stride(), gains.data_ptr(),
            *gains.stride(), tapsets.data_ptr(), *tapsets.stride(),
            on_device(_window_sq, y.device).data_ptr(), B * C, C, W, hist, n, lm)
