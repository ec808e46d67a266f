"""Batched pitch-regime CELT loss concealment on the device (the port of
opus_tpu.dsp.plc_exec).

A stream's first lost frames (loss_duration < 40) are concealed from its
decode memory, which lives on the device.  Plane A ships an empty plan
with meta[14] flags (bit 0 conceal, bit 1 first loss) and, in meta[15],
the post-filter state the conceal undoes; the serving step runs
`make_plc_conceal` (every stream) or `make_plc_conceal_compact` (the
flagged streams only) and merges the result into the synthesis:

* pitch search: 2x downsample and order-4 whitening, coarse (4x) and fine
  (2x) cross-correlations, two-best tracking (the `pitch_track` kernel),
  pseudo-interpolation;
* LPC: windowed autocorrelation, lag window, order-24 Levinson-Durbin with
  a per-stream early stop;
* excitation FIR, periodic extrapolation with closed-form wrap counts and
  decay powers, order-24 LPC synthesis (the `lpc_synth` kernel);
* explosion check, fade blend, post-filter undo and TDAC on the tail.

The formulas where rounding shows are the reference's (the decay power as
exp(log(decay) * wraps), the 1.0001 and lag-window factors, the blend).
The conceal is numerically touchy: a relative change of 1e-7 in the decode
memory moves the concealed frame by up to 4e-4 of its peak in the
reference itself, so the port is held to the reference at 2e-3 of the peak
with equal pitch indices (tests/test_torch_plc.py).  The TPU's one-hot
matmuls of the compact variant are index_select / index_copy here, which
are exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..celt import modes
from ..celt.modes import DECODE_BUFFER_SIZE, GAINS
from .plc_scan import LPC_ORDER, lpc_synth, pitch_track

MAX_PERIOD = 1024
LAG_MAX = 720
LAG_MIN = 100
OVERLAP = modes.OVERLAP


def _xcorr(x, y, n_lags: int):
    """xcorr[r, i] = dot(x[r], y[r, i:i+len(x)]) for i in [0, n_lags).

    One grouped 1-D convolution (a cross-correlation per row, one group
    per row) over views of x and y.  A batched matmul over the sliding
    windows (y.unfold) would have to lay the [R, n_lags, len(x)] windows
    out in memory first (843 MB at B=1024 for the fine search): its rows
    overlap, which no matmul layout takes.  The float32 CUDA path of a
    depthwise convolution is a direct sum, not cuDNN (no TF32, no FFT)."""
    R, lx = x.shape
    inp = y[:, : n_lags + lx - 1].contiguous()[None]
    return F.conv1d(inp, x.contiguous()[:, None, :], groups=R)[0]


def _autocorr(x, lags: int):
    """ac[r, k] = sum_t x[r, t] * x[r, t + k] for k < lags, as one
    product over the sliding windows of x padded by zeros and one sum
    (a tree sum, as accurate as the reference's; a correlation by
    convolution sums in order and moved the LPC by 1e-3)."""
    n = x.shape[-1]
    win = F.pad(x, (0, lags - 1)).unfold(-1, n, 1)  # [R, lags, n] view
    return torch.sum(win * x[:, None, :], dim=-1)


def _levinson(ac, order: int):
    """Batched Levinson-Durbin: ac [R, order+1] -> lpc [R, order].

    The symmetric update new[p] = old[p] + r * old[i-1-p] for p < i; a
    stream stops (its lpc and error freeze) once the error falls below
    0.001 * ac[0], and a stream with ac[0] == 0 never starts."""
    R = ac.shape[0]
    lpc = torch.zeros(R, order, dtype=ac.dtype, device=ac.device)
    ac0 = ac[:, 0]
    error = ac0
    floor = 0.001 * ac0
    dead = ac0 == 0.0
    acr = ac.flip(-1)  # acr[:, order - q] = ac[:, q]
    for i in range(order):
        rr = ac[:, i + 1]
        if i:
            rr = torch.sum(lpc[:, :i] * acr[:, order - i : order], dim=1) + rr
        r = -rr / torch.where(error == 0, 1.0, error)
        upd = torch.cat([lpc[:, :i] + r[:, None] * lpc[:, :i].flip(-1), r[:, None],
                         lpc[:, i + 1 :]], dim=1)
        err_new = error - r * r * error
        lpc = torch.where(dead[:, None], lpc, upd)
        error = torch.where(dead, error, err_new)
        dead = dead | (err_new < floor)
    return lpc


def _lag_window(lags: int, device):
    w = torch.tensor([1.0] + [1.0 - (0.008 * k) ** 2 for k in range(1, lags)],
                     dtype=torch.float32)
    return w.to(device)


def make_pitch_search(*, device):
    """Batched plc_pitch_search: mem [B, C, >=2048] -> pitch index [B] int64."""
    lagw5 = _lag_window(5, device)
    damp = torch.tensor([0.9, 0.81, 0.729, 0.6561], dtype=torch.float32, device=device)
    half = 1024
    length = 2048 - LAG_MAX
    max_pitch = LAG_MAX - LAG_MIN
    mp2 = max_pitch >> 1
    lag_i = torch.arange(mp2, device=device)[None, :]

    def search(mem):
        x = mem[:, :, :2048]
        # pitch_downsample: sum over channels of the 3-tap smoother
        xs = x.sum(dim=1) if x.shape[1] > 1 else x[:, 0]
        lp = torch.cat([(0.25 * xs[:, 1] + 0.5 * xs[:, 0])[:, None],
                        0.25 * (xs[:, 1 : 2 * half - 2 : 2] + xs[:, 3 : 2 * half : 2])
                        + 0.5 * xs[:, 2 : 2 * half - 1 : 2]], dim=1)
        # autocorrelation to lag 4, the 1.0001 bias and the lag window
        ac = _autocorr(lp, 5)
        ac = torch.cat([ac[:, :1] * 1.0001, ac[:, 1:]], dim=1) * lagw5
        lpc4 = _levinson(ac, 4) * damp
        c1 = 0.8
        lpc5 = torch.stack([lpc4[:, 0] + c1, lpc4[:, 1] + c1 * lpc4[:, 0],
                            lpc4[:, 2] + c1 * lpc4[:, 1], lpc4[:, 3] + c1 * lpc4[:, 2],
                            c1 * lpc4[:, 3]], dim=1)
        y = lp.clone()
        for j in range(5):
            y[:, j + 1 :] += lpc5[:, j : j + 1] * lp[:, : half - 1 - j]

        # plc_pitch_search: x_lp = y[360:], length 1328, max_pitch 620
        x_lp = y[:, LAG_MAX // 2 :]
        h = length >> 1
        n4 = h >> 1
        x4 = x_lp[:, : 2 * n4 : 2]
        ymax4 = (length + max_pitch) >> 2
        y4 = y[:, : 2 * ymax4 : 2]
        mp4 = max_pitch >> 2
        b0, b1 = pitch_track(_xcorr(x4, y4, mp4), y4, length >> 2, mp4)
        # fine 2x search next to the two coarse candidates
        xc2 = _xcorr(x_lp[:, :h], y, mp2)
        b0, b1 = b0.long(), b1.long()
        near = ((lag_i - 2 * b0[:, None]).abs() <= 2) | ((lag_i - 2 * b1[:, None]).abs() <= 2)
        xc2 = torch.where(near, torch.clamp_min(xc2, -1.0), 0.0)
        bp = pitch_track(xc2, y, length >> 1, mp2)[0].long()
        # pseudo-interpolation
        abc = xc2.gather(1, torch.stack([(bp - 1).clamp(0, mp2 - 1), bp,
                                         (bp + 1).clamp(0, mp2 - 1)], dim=1))
        a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
        off = torch.where((c - a) > 0.7 * (b - a), 1, torch.where((a - c) > 0.7 * (b - c), -1, 0))
        off = torch.where((bp > 0) & (bp < mp2 - 1), off, 0)
        return LAG_MAX - (2 * bp - off)

    return search


def make_plc_conceal(lm: int, batch: int, channels: int = 2, *, device):
    """Batched pitch-regime concealment of one frame.

    conceal(mem, lpc_state, pitch_state, first, pf_period, pf_gain,
    pf_tapset) -> (new_mem, new_lpc, new_pitch, out_f)

    mem [B, C, DBS+OV] is the serving decode memory (read, not written);
    lpc_state [B, C, 24] f32, pitch_state [B] int, first [B] bool,
    pf_period / pf_tapset [B] int and pf_gain [B] f32 the post-filter to
    undo.  new_mem is a tensor of its own; out_f [B, C, n] is its view of
    the concealed frame BEFORE de-emphasis; new_pitch is int32.
    Everything is computed for every stream; the caller merges by mask.
    """
    device = torch.device(device)
    n = (1 << lm) * modes.SHORT_MDCT_SIZE
    ov = OVERLAP
    B, C = batch, channels
    dbs = DECODE_BUFFER_SIZE
    el = n + ov
    search = make_pitch_search(device=device)
    window = torch.as_tensor(modes.WINDOW, device=device)
    gains_tbl = torch.as_tensor(np.array(GAINS, np.float32), device=device)
    w_full = torch.cat([window, torch.ones(MAX_PERIOD - 2 * ov, device=device),
                        window.flip(0)])
    lagw = _lag_window(LPC_ORDER + 1, device)
    pos = torch.arange(MAX_PERIOD, device=device)
    i_ = torch.arange(el, device=device)[None, :]
    iov = torch.arange(ov, device=device)[None, :]
    taps5 = torch.arange(-2, 3, device=device)
    half = ov // 2
    win_lo, win_hi_r = window[:half], window[half:].flip(0)

    @torch.no_grad()
    def conceal(mem, lpc_state, pitch_state, first, pf_period, pf_gain, pf_tapset):
        pitch = torch.where(first, search(mem), pitch_state.long()).clamp(LAG_MIN, LAG_MAX)
        fade = torch.where(first, 1.0, 0.8)

        full_exc = mem[:, :, dbs - MAX_PERIOD - LPC_ORDER : dbs]
        exc = full_exc[:, :, LPC_ORDER:]  # [B, C, 1024]

        # LPC on a first loss: windowed autocorrelation + lag window
        excw = exc * w_full
        ac = _autocorr(excw.reshape(B * C, MAX_PERIOD), LPC_ORDER + 1)  # [B*C, 25]
        ac = torch.cat([ac[:, :1] * 1.0001, ac[:, 1:]], dim=1) * lagw
        lpc_new = _levinson(ac, LPC_ORDER).reshape(B, C, LPC_ORDER)
        lpc = torch.where(first[:, None, None], lpc_new, lpc_state)

        # excitation FIR over the last exc_length samples
        exc_length = torch.clamp_max(2 * pitch, MAX_PERIOD)  # [B]
        # fir[i] = exc[i] + sum_j lpc[j] * full_exc[23 - j + i]: one
        # correlation of full_exc with the reversed lpc
        fir = exc + _xcorr(lpc.reshape(B * C, LPC_ORDER).flip(-1),
                           full_exc.reshape(B * C, -1), MAX_PERIOD).reshape(B, C, MAX_PERIOD)
        in_fir = pos >= (MAX_PERIOD - exc_length)[:, None, None]
        exc_f = torch.where(in_fir, fir, exc)

        # decay from the last two half-periods
        half_len = (exc_length >> 1)[:, None, None]
        m1 = pos >= MAX_PERIOD - half_len
        m2 = (pos >= MAX_PERIOD - 2 * half_len) & ~m1
        e2f = exc_f * exc_f
        e1 = 1.0 + torch.sum(torch.where(m1, e2f, 0.0), dim=-1)
        e2 = 1.0 + torch.sum(torch.where(m2, e2f, 0.0), dim=-1)
        decay = torch.sqrt(torch.minimum(e1, e2) / e2)  # [B, C]

        # the memory shifted by one frame
        shifted = torch.cat([mem[:, :, n:dbs], torch.zeros(B, C, n, device=mem.device),
                             mem[:, :, dbs:]], dim=-1)

        # periodic extrapolation of the excitation
        pit = pitch[:, None]
        j_ = torch.remainder(i_, pit)  # [B, el]
        wraps = torch.div(i_, pit, rounding_mode="floor")
        att = (fade[:, None, None] * decay[..., None]
               * torch.exp(torch.log(torch.clamp_min(decay[..., None], 1e-30))
                           * wraps[:, None, :].to(torch.float32)))
        extrap_off = (MAX_PERIOD - pitch)[:, None]
        src_idx = (extrap_off + j_).clamp(0, MAX_PERIOD - 1)[:, None, :].expand(B, C, el)
        ext = att * torch.gather(exc_f, -1, src_idx)  # [B, C, el]
        # s1: energy of the same region one MAX_PERIOD earlier (after the shift)
        s1_idx = (dbs - MAX_PERIOD - n + extrap_off + j_).clamp(0, shifted.shape[-1] - 1)
        s1v = torch.gather(shifted, -1, s1_idx[:, None, :].expand(B, C, el))
        s1 = torch.sum(s1v * s1v, dim=-1) / 1024.0

        # order-24 LPC synthesis (the lpc_synth kernel on the card)
        hist0 = shifted[:, :, dbs - n - LPC_ORDER : dbs - n].flip(-1)  # [j] = shifted[dbs-n-1-j]
        synth = lpc_synth(ext.reshape(B * C, el), lpc.reshape(B * C, LPC_ORDER).contiguous(),
                          hist0.reshape(B * C, LPC_ORDER)).reshape(B, C, el)

        # explosion check and fade blend
        s2 = torch.sum(synth * synth, dim=-1) / 1024.0
        dead = ~(s1 > 0.2 * s2)
        ratio = torch.sqrt((s1 + 1.0) / (s2 + 1.0))
        gwin = 1.0 - window * (1.0 - ratio[..., None])
        blend = torch.cat([synth[:, :, :ov] * gwin, synth[:, :, ov:] * ratio[..., None]], dim=-1)
        synth = torch.where(dead[..., None], 0.0,
                            torch.where((s1 < s2)[..., None], blend, synth))
        buf = shifted
        buf[:, :, dbs - n :] = synth

        # undo the post-filter on the TDAC tail
        t_ = torch.clamp_min(pf_period.long(), 15)[:, None]
        taps = gains_tbl[pf_tapset.long()] * pf_gain[:, None]  # [B, 3]
        idx = (dbs + iov - t_)[:, None, :, None] + taps5
        idx = idx.clamp(0, buf.shape[-1] - 1).reshape(B, 1, ov * 5).expand(B, C, ov * 5)
        tap = torch.gather(buf, -1, idx).reshape(B, C, ov, 5)
        tail = buf[:, :, dbs : dbs + ov]
        etmp = tail - (taps[:, 0, None, None] * tap[..., 2]
                       + taps[:, 1, None, None] * (tap[..., 3] + tap[..., 1])
                       + taps[:, 2, None, None] * (tap[..., 4] + tap[..., 0]))
        tdac = win_lo * etmp[:, :, half:].flip(-1) + win_hi_r * etmp[:, :, :half]
        buf[:, :, dbs : dbs + half] = tdac
        buf[:, :, dbs + half : dbs + ov] = etmp[:, :, half:]

        return buf, lpc, pitch.to(torch.int32), buf[:, :, dbs - n : dbs]

    return conceal


def make_plc_conceal_compact(lm: int, batch: int, k: int, channels: int = 2, *, device):
    """Fixed-capacity concealment: conceal only the flagged streams.

    conceal(mem, lpc_state, pitch_state, plc_mask, first, pf_period,
    pf_gain, pf_tapset) -> (mem_c, lpc_c, pitch_c, out_f), the shapes and
    merge contract of make_plc_conceal; rows outside plc_mask are zero.

    A stable sort over the mask, on the device, puts the flagged streams
    first in stream order (no upload, no host sync); the first k rows are
    gathered into a [k, ...] sub-batch, concealed at batch k, and copied
    back with index_copy.  The caller picks this variant only when the
    step's loss count is at most k; rows of the sub-batch beyond that
    count (padding) conceal an impulse memory and come back as zeros.
    """
    inner = make_plc_conceal(lm, k, channels, device=device)
    imp = torch.zeros(DECODE_BUFFER_SIZE + OVERLAP, device=device)
    imp[DECODE_BUFFER_SIZE - 1] = 1.0

    @torch.no_grad()
    def conceal(mem, lpc_state, pitch_state, plc_mask, first, pf_period, pf_gain, pf_tapset):
        order = torch.sort((~plc_mask).to(torch.uint8), stable=True).indices
        idx = order[:k]
        valid = plc_mask[idx]
        v3 = valid[:, None, None]
        memk = torch.where(v3, mem.index_select(0, idx), imp)
        lpck = torch.where(v3, lpc_state.index_select(0, idx), 0.0)
        pitchk = torch.where(valid, pitch_state.index_select(0, idx), LAG_MIN)
        firstk = first.index_select(0, idx) & valid
        periodk = torch.where(valid, pf_period.index_select(0, idx), 15)
        gaink = torch.where(valid, pf_gain.index_select(0, idx), 0.0)
        tapsetk = torch.where(valid, pf_tapset.index_select(0, idx), 0)
        mem_ck, lpc_ck, pitch_ck, out_fk = inner(memk, lpck, pitchk, firstk, periodk, gaink,
                                                 tapsetk)

        def expand(a):
            z = torch.where(valid.reshape((k,) + (1,) * (a.dim() - 1)), a, 0)
            return torch.zeros((mem.shape[0],) + a.shape[1:], dtype=a.dtype,
                               device=a.device).index_copy_(0, idx, z)

        mem_c = expand(mem_ck)
        n = out_fk.shape[-1]
        return (mem_c, expand(lpc_ck), expand(pitch_ck),
                mem_c[:, :, DECODE_BUFFER_SIZE - n : DECODE_BUFFER_SIZE])

    return conceal
