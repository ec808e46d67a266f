"""The SILK synthesis of the SILK-only batch decoder: the CUDA kernel's
wrapper and its plain version (the port of opus_tpu/dsp/silk_synthesis.py).

The host walks the range-coded symbols and dequantises the parameters
exactly (silk/, batch/silk_pipeline.py); this module runs the two dense
recurrences for the whole batch, in float32 in the output domain, where
every gain and Q-format rescale of the fixed-point reference is folded in:

    P[t] = g_k * exc_n[t] + sum_j b_j * P[t - lag + 2 - j]   (voiced LTP)
    x[t] = P[t] + sum_j a_j * x[t - 1 - j]                   (LPC)

Neither is a TPU kernel: the reference runs each as a `lax.scan` (the LTP
in chunks of at most min lag - 2 samples, whose taps all read finished
samples; the LPC a sample at a time).  In eager torch either loop would
cost hundreds of launches a frame, so on a CUDA tensor
`silk_synthesis_step` launches one hand-written kernel for the whole
frame (csrc/silk.cu `silk_synth`), counts the launch, and raises if it
does not build or launch.  On a CPU tensor it runs the plain version,
`_silk_synth_ref`, the torch form of the reference's `_ltp_chunked` and
`_lpc_scan`.

The plain version fixes every rounding: each product and sum is one
float32 operation, the LTP taps summed from j = 0 up, the LPC prediction
from the newest sample's tap up (a[0] x[t-1] first) and added to P[t]
last.  That is the order in which XLA:CPU evaluates the reference at the
test suite's optimisation level, so the plain version equals the JAX
step bit for bit.  The kernel's LTP rounds the same way, but its LPC is
a chunked recurrence (`lpc_chunks` gives its layout: the history carried
across chunks in double), which rounds otherwise: it is held to a
float64 run of the plain version, not to the plain version's bits.
"""

from __future__ import annotations

import torch

LTP_ORDER = 5
LPC_ORDERS = (10, 16)
MAX_CHUNK = 32  # the kernel's LTP chunk is one warp wide
WARP = 32  # the kernel's LPC runs one chunk a lane


def lpc_chunks(subfr_len: int, nb_subfr: int, order: int) -> tuple[int, int]:
    """(samples a chunk, chunks a frame) of the kernel's chunked LPC: the
    shortest divisor of subfr_len at least `order` long that cuts the
    frame into at most 32 chunks, so that chunks meet at every subframe
    boundary (the a1/a2 half boundary among them) and each chunk's last
    `order` samples are its own.  ValueError where there is none."""
    for n in range(order, subfr_len + 1):
        if subfr_len % n == 0 and nb_subfr * (subfr_len // n) <= WARP:
            return n, nb_subfr * (subfr_len // n)
    raise ValueError(f"no LPC chunk layout for subfr_len={subfr_len}, nb_subfr={nb_subfr}, "
                     f"order={order}: the kernel needs a divisor of subfr_len of at least "
                     f"the order that gives at most {WARP} chunks")


def _ltp_chunked(gexc, b_taps, lag, head, chunk: int):
    """Voiced LTP over one subframe in the output domain.

    gexc [B, S] gain-scaled excitation; b_taps [B, 5]; lag [B]; head
    [B, H] P-history (index H is the first sample of this subframe).
    Returns (pres [B, S], buf [B, H + S]).  Chunk by chunk, every tap
    reads the buffer as it stood before the chunk (samples of the chunk
    and beyond read 0), with its index clamped at 0: with lag >= chunk + 2
    that is the sample-by-sample recurrence."""
    B, S = gexc.shape
    H = head.shape[1]
    n_chunks = -(-S // chunk)
    buf = torch.cat([head, head.new_zeros(B, n_chunks * chunk)], dim=1)
    gexc_p = torch.cat([gexc, gexc.new_zeros(B, n_chunks * chunk - S)], dim=1)
    idx = torch.arange(chunk, device=gexc.device)
    lag = lag.to(torch.int64)
    outs = []
    for ci in range(n_chunks):
        t0 = ci * chunk
        base = H + t0 + idx[None, :] - lag[:, None] + 2
        pred = gexc.new_zeros(B, chunk)
        for j in range(LTP_ORDER):
            vals = torch.gather(buf, 1, torch.clamp(base - j, 0, buf.shape[1] - 1))
            pred = pred + b_taps[:, j : j + 1] * vals
        pres = gexc_p[:, t0 : t0 + chunk] + pred
        buf[:, H + t0 : H + t0 + chunk] = pres
        outs.append(pres)
    return torch.cat(outs, dim=1)[:, :S], buf[:, : H + S]


def _lpc_scan(pres, a, hist):
    """x[t] = pres[t] + sum_j a[j] x[t-1-j], the sum from j = 0 up;
    hist[:, -1] = x[-1].  Returns (x, the new hist)."""
    order = a.shape[1]
    h = [hist[:, order - 1 - j] for j in range(order)]  # h[j] = x[t-1-j]
    xs = []
    for t in range(pres.shape[1]):
        pred = torch.zeros_like(pres[:, t])
        for j in range(order):
            pred = pred + a[:, j] * h[j]
        x = pres[:, t] + pred
        h = [x] + h[:-1]
        xs.append(x)
    return torch.stack(xs, dim=1), torch.stack(h[::-1], dim=1)


def _silk_synth_ref(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, *,
                    subfr_len: int, nb_subfr: int, chunk: int):
    """Plain SILK synthesis of one frame for B streams: the LTP buffer
    grows across the subframes (subframe k reads P of the earlier ones)
    and takes the LTP output of every row; the LPC filters the LTP output
    of voiced rows and the excitation of the others, with a1 for
    subframes k < (nb_subfr + 1) // 2 and a2 for the rest.  Any float
    dtype.  Returns (xq [B, L], the new lpc_hist)."""
    outs = []
    buf = head
    for k in range(nb_subfr):
        ex = gexc[:, k * subfr_len : (k + 1) * subfr_len]
        pres_v, buf = _ltp_chunked(ex, b_taps[:, k, :], lags[:, k], buf, chunk)
        pres = torch.where(voiced[:, None], pres_v, ex)
        a = a1 if k < (nb_subfr + 1) // 2 else a2
        x, lpc_hist = _lpc_scan(pres, a, lpc_hist)
        outs.append(x)
    return torch.cat(outs, dim=1), lpc_hist


def _check(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, subfr_len, nb_subfr, chunk):
    B = gexc.shape[0]
    order = a1.shape[-1]
    dev = gexc.device
    if gexc.dim() != 2 or head.dim() != 2 or a1.dim() != 2:
        raise ValueError(f"gexc [B, L], head [B, H] and a1 [B, order], got "
                         f"{tuple(gexc.shape)}, {tuple(head.shape)}, {tuple(a1.shape)}")
    if order not in LPC_ORDERS:
        raise ValueError(f"LPC order must be one of {LPC_ORDERS}, got {order}")
    if not (0 < chunk <= MAX_CHUNK and subfr_len > 0 and nb_subfr > 0):
        raise ValueError(f"chunk={chunk} (1..{MAX_CHUNK}), subfr_len={subfr_len} and "
                         f"nb_subfr={nb_subfr} must be positive")
    shapes = (("gexc", gexc, (B, subfr_len * nb_subfr), torch.float32),
              ("a1", a1, (B, order), torch.float32), ("a2", a2, (B, order), torch.float32),
              ("voiced", voiced, (B,), torch.bool),
              ("lags", lags, (B, nb_subfr), torch.int32),
              ("b_taps", b_taps, (B, nb_subfr, LTP_ORDER), torch.float32),
              ("head", head, (B, head.shape[1]), torch.float32),
              ("lpc_hist", lpc_hist, (B, order), torch.float32))
    for name, t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_args(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, xq, hist_out,
                 subfr_len: int, nb_subfr: int, chunk: int) -> tuple:
    """The C arguments of one silk_synth launch into xq and hist_out, but
    the stream."""
    return (gexc.data_ptr(), a1.data_ptr(), a2.data_ptr(), voiced.data_ptr(), lags.data_ptr(),
            b_taps.data_ptr(), head.data_ptr(), lpc_hist.data_ptr(), xq.data_ptr(),
            hist_out.data_ptr(), gexc.shape[0], a1.shape[1], head.shape[1], subfr_len,
            nb_subfr, chunk)


def silk_synthesis_step(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, *,
                        subfr_len: int, nb_subfr: int, chunk: int):
    """One SILK frame for B streams -> (xq [B, L], the new lpc_hist).

    gexc [B, L] f32, the excitation at output scale (L = subfr_len x
    nb_subfr); a1, a2 [B, order] f32, the LPC of the first and second
    half (order 10 or 16); voiced [B] bool; lags [B, nb_subfr] int32;
    b_taps [B, nb_subfr, 5] f32; head [B, H] f32, the rewhitened LTP
    history; lpc_hist [B, order] f32 (lpc_hist[:, -1] the newest sample);
    all contiguous on one device.  A CUDA tensor goes through the kernel
    (each launch adds one to `silk_synthesis_step.launches`; ValueError
    past 6 subframes or where `lpc_chunks` finds no layout); a CPU tensor
    through `_silk_synth_ref`."""
    _check(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, subfr_len, nb_subfr, chunk)
    kw = dict(subfr_len=subfr_len, nb_subfr=nb_subfr, chunk=chunk)
    if gexc.device.type == "cpu":
        return _silk_synth_ref(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, **kw)
    if gexc.device.type != "cuda":
        raise ValueError(f"silk_synthesis_step runs on cpu or cuda, not {gexc.device}")
    if nb_subfr * LTP_ORDER > WARP:
        raise ValueError(f"the kernel takes at most {WARP // LTP_ORDER} subframes (a lane per "
                         f"LTP tap of the frame), got {nb_subfr}")
    lpc_chunks(subfr_len, nb_subfr, a1.shape[1])  # raises where the kernel has no layout
    from .. import _build

    xq = torch.empty_like(gexc)
    hist_out = torch.empty_like(lpc_hist)
    _build.launch("opus_silk_synth", gexc.device,
                  _kernel_args(gexc, a1, a2, voiced, lags, b_taps, head, lpc_hist, xq,
                               hist_out, **kw))
    silk_synthesis_step.launches += 1
    return xq, hist_out


silk_synthesis_step.launches = 0
