"""Batched CELT synthesis in PyTorch (the port of opus_tpu.dsp.synthesis).

Plane A (the native front end) emits per-frame symbol planes; a step
turns them into PCM for a whole batch of streams:

* denormalise: band gains expanded to bins by a one-hot [21, N] matmul;
* IMDCT: a dense matmul against a precomputed synthesis basis;
* TDAC overlap-add with the CELT window;
* pitch post-filter: the hand-written CUDA kernel on the card
  (dsp/postfilter.py), its plain torch version on the CPU;
* de-emphasis: a Toeplitz matmul per 120-sample block plus a carry chain.

Mixed-mode serving (silk_mix) adds the SILK PCM of SILK and hybrid
streams after synthesis (decoder.rs:722-729: out = celt + silk/32768):
shipped at 48 kHz, or at the internal rate and resampled on the device by
one matmul per rate over every stream, each stream keeping the product of
its own rate (`_silk_resample`, banks from dsp/resample.py).

Layouts are the reference's: planes [B, C, N], PCM [B, n, C], and the same
packed-slot and plan-slot word offsets.  `make_synthesis_step` is
functional (it returns a new state); the serving steps (packed:
make_serving_step; plan: make_plan_serving_step, whose spectra come from
the plan executor) update state and PCM ring in place, which stands in
for the reference's buffer donation.  Their shapes depend on the step
variant alone, never on a step's data, so that each variant can be
captured once as a CUDA graph (dsp/graphs.py): a plan step reads where
its upload ends from a device scalar.  Each serving step marks its
device phases for the tracer (opus_tpu_torch/trace.py `mark`: events
only while a traced capture records them): `plan_exec` (unpack and plan
executor) or `unpack`, `silk` (row expansion and resampling), `conceal`
and `synthesis` (the core).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..celt import modes
from ..celt.modes import DECODE_BUFFER_SIZE
from .postfilter import postfilter
from .resample import TAIL, resample_matrices
from .tables import (
    _DEEMPH_BLK,
    PACK_BITS,
    _band_onehot,
    _deemph_powers,
    _deemph_toeplitz,
    _e_bands,
    _e_means,
    _synthesis_basis,
    _tap_gains,
    _tdac_windows,
    _unpack_index,
    _window_sq,
    on_device,
    packed_offsets,
)

OVERLAP = modes.OVERLAP
_HALF = OVERLAP // 2
_CHUNK = 12  # post-filter chunk that is safe for every lag (MIN_PERIOD=15)


@dataclass
class SynthState:
    """Per-stream synthesis state (leading axes [B, C])."""

    mem: torch.Tensor  # [B, C, DECODE_BUFFER_SIZE + OVERLAP]
    preemph: torch.Tensor  # [B, C]
    #: the internal-rate SILK input tail of the device resampler [B, C,
    #: resample.TAIL] (mixed serving with the internal SILK transfer only)
    silk_hist: torch.Tensor | None = None


def init_state(batch: int, channels: int = 2, *, device, silk_hist: bool = False) -> SynthState:
    return SynthState(
        mem=torch.zeros(batch, channels, DECODE_BUFFER_SIZE + OVERLAP, device=device),
        preemph=torch.zeros(batch, channels, device=device),
        silk_hist=torch.zeros(batch, channels, TAIL, device=device) if silk_hist else None,
    )


def _load_tables(lm: int, device) -> None:
    """Upload every constant a step of frame size 120<<lm reads, so that
    no step pays a host-to-device copy for them."""
    n = modes.SHORT_MDCT_SIZE << lm
    on_device(_band_onehot, device, lm)
    on_device(_e_means, device)
    on_device(_e_bands, device)
    on_device(_synthesis_basis, device, n)
    on_device(_synthesis_basis, device, modes.SHORT_MDCT_SIZE)
    on_device(_tdac_windows, device)
    on_device(_deemph_toeplitz, device)
    on_device(_deemph_powers, device)
    on_device(_tap_gains, device)
    on_device(_window_sq, device)


def _denormalise(x, band_log_e, lm, bound):
    """freq = x * exp2(logE + eMeans), masked above `bound` bins."""
    n = modes.SHORT_MDCT_SIZE << lm
    lg = band_log_e + on_device(_e_means, x.device)
    g = torch.exp2(torch.clamp_max(lg, 32.0))  # [B, C, 21]
    gain_bins = torch.matmul(g, on_device(_band_onehot, x.device, lm))
    mask = torch.arange(n, device=x.device)[None, None, :] < bound[:, None, None]
    return torch.where(mask, x * gain_bins, 0.0)


def _imdct_blocks(freq, lm: int, short_blocks: bool):
    """freq [B, C, N] -> mids [B, C, nb_blocks, NB] by one matmul."""
    n = modes.SHORT_MDCT_SIZE << lm
    nb_blocks, nb = (1 << lm, modes.SHORT_MDCT_SIZE) if short_blocks else (1, n)
    b_, c_ = freq.shape[0], freq.shape[1]
    # De-interleave short blocks: spec_b[k] = freq[b + k*nb_blocks].  One
    # 2-D product over all rows: a batched product here would run as
    # B*C matrix-vector products.
    spec = freq.reshape(b_, c_, nb, nb_blocks).transpose(2, 3).reshape(-1, nb)
    mids = torch.matmul(spec, on_device(_synthesis_basis, freq.device, nb))
    return mids.reshape(b_, c_, nb_blocks, nb)


def _overlap_add(mids, prev_tail):
    """Chain TDAC across blocks; returns out [B,C,N] + new tail [B,C,ov/2]."""
    w_lo, w_hi, w_hi_r, w_lo_r = on_device(_tdac_windows, mids.device)
    nb = mids.shape[3]
    tail = prev_tail  # [B, C, half]
    outs = []
    for blk in range(mids.shape[2]):
        mid = mids[:, :, blk, :]  # [B, C, nb]
        first = w_hi * tail - w_lo * mid[..., :_HALF].flip(-1)  # out[0:ov/2]
        second = w_hi_r * mid[..., :_HALF] + w_lo_r * tail.flip(-1)  # out[ov/2:ov]
        # This block's first ov samples + flat body; its last half-overlap
        # of `mid` becomes the next block's previous tail.
        outs.append(torch.cat([first, second, mid[..., _HALF : nb - _HALF]], dim=-1))
        tail = mid[..., nb - _HALF :]
    return torch.cat(outs, dim=-1), tail


def _deemphasis(out_f, preemph):
    """De-emphasis IIR over the frame; returns (y [B,C,N], new_preemph).

    y[t] = x[t] + PREEMPH*y[t-1], exactly, as 120-sample blocks: inside a
    block y_local = x @ T (T lower-triangular Toeplitz of PREEMPH^k), and a
    carry chain of at most 8 blocks stitches them.
    """
    coef = float(modes.PREEMPH)
    xin = out_f + 1e-30
    b_, c_, n = xin.shape
    g = n // _DEEMPH_BLK
    xb = xin.reshape(b_, c_, g, _DEEMPH_BLK)
    y_local = torch.matmul(xb, on_device(_deemph_toeplitz, xin.device))
    pow_vec = on_device(_deemph_powers, xin.device)
    last_pow = pow_vec[-1]
    a = preemph  # [B, C]; equals coef * y[-1] of the previous frame
    carries = []
    for gi in range(g):
        carries.append(a)
        a = coef * (y_local[..., gi, -1] + last_pow * a)
    carry = torch.stack(carries, dim=-1)  # [B, C, g]
    ys = y_local + pow_vec * carry[..., None]
    return ys.reshape(b_, c_, n), a


def make_synthesis_step(lm: int, short_blocks: bool, channels: int = 2,
                        downsample: int = 1, *, device):
    """Batched synthesis step for one frame shape.

    Returns step(state, x, band_log_e, bound, pf_periods, pf_gains,
    pf_tapsets) -> (new_state, pcm [B, frame, C]); the input state is left
    as it was (a mixed transient/long batch runs two variants on it).
    x [B,C,N], band_log_e [B,C,21], bound [B]; pf_* [B,3] old/current/new.
    """
    n = modes.SHORT_MDCT_SIZE << lm
    hist = DECODE_BUFFER_SIZE - n
    _load_tables(lm, device)

    @torch.no_grad()
    def step(state: SynthState, x, band_log_e, bound, pf_periods, pf_gains, pf_tapsets):
        freq = _denormalise(x, band_log_e, lm, bound)
        mids = _imdct_blocks(freq, lm, short_blocks)
        prev_tail = state.mem[..., DECODE_BUFFER_SIZE : DECODE_BUFFER_SIZE + _HALF]
        out, tail = _overlap_add(mids, prev_tail)

        # History before the frame, then the frame: post-filtered in place.
        y = torch.cat([state.mem[..., n:DECODE_BUFFER_SIZE], out], dim=-1)
        postfilter(y, hist, n, lm, pf_periods, pf_gains, pf_tapsets)
        ys, new_preemph = _deemphasis(y[..., hist:], state.preemph)
        pcm = ys[..., ::downsample] * (1.0 / 32768.0)

        pad = torch.zeros_like(state.mem[..., : OVERLAP - _HALF])
        new_mem = torch.cat([y, tail, pad], dim=-1)
        return SynthState(mem=new_mem, preemph=new_preemph), pcm.transpose(1, 2)

    return step


def make_pipeline_step(lm: int, short_blocks: bool, channels: int = 2, downsample: int = 1,
                       quantized: bool = False, *, device):
    """Variant of make_synthesis_step taking raw plane-A output.

    The native front end emits x as a flat [B, 2*960] buffer (first
    stream_channels*N entries valid; Q14 int16 when `quantized`) and band
    log-energies as [B, 2, 21]; mono broadcast and reshape happen here.

    step(state, xraw, mono, band_log_e2, bound, pf_periods, pf_gains,
    pf_tapsets) -> (new_state, pcm).
    """
    n = modes.SHORT_MDCT_SIZE << lm
    inner = make_synthesis_step(lm, short_blocks, channels, downsample, device=device)

    @torch.no_grad()
    def step(state, xraw, mono, band_log_e2, bound, pf_periods, pf_gains, pf_tapsets):
        if quantized:
            xraw = xraw.to(torch.float32) * (1.0 / 16384.0)
        if channels == 2:
            x = xraw[:, : 2 * n].reshape(-1, 2, n)
            x = torch.where(mono[:, None, None], x[:, :1], x)
            le = torch.where(mono[:, None, None], band_log_e2[:, :1], band_log_e2)
        else:
            x = xraw[:, :n].reshape(-1, 1, n)
            le = band_log_e2[:, :1]
        return inner(state, x, le, bound, pf_periods, pf_gains, pf_tapsets)

    return step


def _unpack_pw(words, batch: int, n: int, w_bits: int):
    """[B, 2, 30*W] int32 words -> [B, 2, n] f32 mantissas/16384.

    Each coefficient is a W-bit offset-binary field of a little-endian bit
    stream: the low bits from its word, the rest from the next one.  The
    words are uint32 in the reference; torch has no uint32 shift on the
    CPU, so they are widened to int64 and masked to 32 bits.  The final
    W-bit mask drops whatever a uint32 shift would have wrapped away.
    """
    widx, wnext, sh = on_device(_unpack_index, words.device, w_bits)
    u = words.to(torch.int64) & 0xFFFFFFFF
    lo = torch.index_select(u, -1, widx) >> sh
    hi = torch.where(sh == 0, 0, torch.index_select(u, -1, wnext) << (32 - sh))
    m = ((lo | hi) & ((1 << w_bits) - 1)) - (1 << (w_bits - 1))
    return m[..., :n].to(torch.float32) * (1.0 / 16384.0)


def _make_serving_core(lm: int, channels: int, downsample: int, pf_chunk: int,
                       pf_active: bool, *, device):
    """Shared serving-step body: core(state, ring, xs, ble, meta, gains,
    plc=None, silk=None) -> digest [2], with state and the PCM ring
    [B, frame, C] updated in place.

    xs [B, 2, N] is the unit-norm band-shape plane, ble [B, 2, 21] the band
    log-energies, meta [B, 16] and gains [B, 3] the packed-slot planes.
    Long and short blocks are both synthesised and selected per stream.
    silk [B, frame, C] (int16 scale, f32) is added to the PCM at 1/32768.
    """
    n = modes.SHORT_MDCT_SIZE << lm
    hist = DECODE_BUFFER_SIZE - n
    _load_tables(lm, device)

    def core(state: SynthState, ring, xs, ble, meta, gains, plc=None, silk=None):
        silence = meta[:, 0] != 0
        short = meta[:, 1] != 0
        mono = meta[:, 3] == 1
        eff_end = meta[:, 5]
        periods = meta[:, 6:9]
        tapsets = meta[:, 9:12]

        if channels == 2:
            x = torch.where(mono[:, None, None], xs[:, :1], xs)
            le = torch.where(mono[:, None, None], ble[:, :1], ble)
        else:
            x = xs[:, :1]
            le = ble[:, :1]

        bound = (1 << lm) * on_device(_e_bands, xs.device)[eff_end.long()]
        if downsample != 1:
            bound = torch.clamp_max(bound, n // downsample)
        bound = torch.where(silence, 0, bound)

        freq = _denormalise(x, le, lm, bound)
        prev_tail = state.mem[..., DECODE_BUFFER_SIZE : DECODE_BUFFER_SIZE + _HALF]
        out, tail = _overlap_add(_imdct_blocks(freq, lm, False), prev_tail)
        if lm != 0:
            out_s, tail_s = _overlap_add(_imdct_blocks(freq, lm, True), prev_tail)
            sel = short[:, None, None]
            out = torch.where(sel, out_s, out)
            tail = torch.where(sel, tail_s, tail)

        y = torch.cat([state.mem[..., n:DECODE_BUFFER_SIZE], out], dim=-1)
        if pf_active:
            postfilter(y, hist, n, lm, periods, gains, tapsets, pf_chunk)
        if plc is not None:
            # Device pitch-regime loss concealment (dsp/plc_exec.py): the
            # lost streams' frame (before de-emphasis) is the conceal's.
            plc_mask, out_f_c, mem_c = plc
            sel = plc_mask[:, None, None]
            y[..., hist:] = torch.where(sel, out_f_c, y[..., hist:])
        ys, new_preemph = _deemphasis(y[..., hist:], state.preemph)
        pcm = ys[..., ::downsample] * (1.0 / 32768.0)

        # The new decode memory is y (history shifted by n, then the
        # post-filtered frame), the block tail, and zero padding; a lost
        # stream's is the conceal's (mem_c, a tensor of its own: the
        # conceal read state.mem before this overwrites it).
        state.mem[..., :DECODE_BUFFER_SIZE].copy_(y)
        state.mem[..., DECODE_BUFFER_SIZE : DECODE_BUFFER_SIZE + _HALF].copy_(tail)
        state.mem[..., DECODE_BUFFER_SIZE + _HALF :].zero_()
        if plc is not None:
            state.mem.copy_(torch.where(sel, mem_c, state.mem))
        state.preemph.copy_(new_preemph)
        out = pcm.transpose(1, 2)
        if silk is not None:
            # decoder.rs:722-729: the SILK layer is added in the time domain
            out = out + silk * (1.0 / 32768.0)
        ring.copy_(out)
        return torch.stack([ring[0, 0, 0], ring[-1, -1, -1]])

    return core


#: SILK internal rates, in the order of the resampler banks.
SILK_KHZ = (8, 12, 16)


@functools.lru_cache(maxsize=None)
def _resample_banks(frame48: int) -> np.ndarray:
    """[3, TAIL + frame48/3, frame48] per-rate resampler banks (8/12/16 kHz)."""
    return resample_matrices(frame48)[0]


def _silk_resample(y16, desc, hist, lm: int, channels: int):
    """The device SILK resampler: internal-rate planar rows -> 48 kHz.

    y16 [B, channels*Lmax] f32 (int16 scale, Lmax = frame48/3): channel-
    planar internal-rate PCM as plane A writes it.  desc [B] int =
    khz | (nrows-1)<<5 | reset<<6, 0 for a stream without SILK this frame.
    hist [B, C, TAIL] is the carried input tail (SynthState.silk_hist).

    Fixed capacity: each rate is one [B*C, TAIL+n_in] x [TAIL+n_in,
    frame48] product over every stream, and a stream keeps the product
    (and the next tail) of its own rate, so no shape depends on how many
    streams ship each rate.  A stream without SILK gets zero PCM and a
    zero tail, as the reference's one-hot selection gives (the resampler
    reset libopus performs when SILK restarts).  Returns (silk48 [B,
    frame48, C], new_hist).
    """
    frame48 = (1 << lm) * modes.SHORT_MDCT_SIZE
    lmax = frame48 // 3
    B = y16.shape[0]
    banks = on_device(_resample_banks, y16.device, frame48)
    khz = desc & 0x1F
    reset = ((desc >> 6) & 1) == 1
    y = y16.reshape(B, channels, lmax)
    if channels == 2:
        # nrows == 1: one internal row (mono SILK in a stereo stream)
        # goes to both output channels.
        two_rows = ((desc >> 5) & 1) == 1
        y = torch.where(two_rows[:, None, None], y, y[:, :1].expand(-1, 2, -1))
    hist = torch.where(reset[:, None, None], 0.0, hist)
    xext = torch.cat([hist, y], dim=-1)  # [B, C, TAIL + lmax]
    out = torch.zeros(B, channels, frame48, device=y16.device)
    new_hist = torch.zeros_like(hist)
    for r, k in enumerate(SILK_KHZ):
        n_in = frame48 * k // 48
        x = xext[..., : TAIL + n_in]
        o = torch.matmul(x.reshape(B * channels, TAIL + n_in), banks[r, : TAIL + n_in])
        sel = (khz == k)[:, None, None]
        out = torch.where(sel, o.reshape(B, channels, frame48), out)
        # the next step's tail: the last TAIL input samples at this rate
        new_hist = torch.where(sel, x[..., n_in:], new_hist)
    return out.transpose(1, 2), new_hist


def _silk_words(lm: int, channels: int, silk_internal: bool) -> tuple[int, int]:
    """(int16 samples, int32 words) of one stream's SILK PCM in a slot."""
    n = modes.SHORT_MDCT_SIZE << lm
    samps = ((n // 3) if silk_internal else n) * channels
    return samps, (samps + 1) // 2


def _make_silk(lm: int, channels: int, silk_internal: bool, *, device):
    """silk(state, pcm, meta) -> (silk [B, frame, C] f32, the new
    resampler tail or None): pcm [B, samps] int16-scale rows of the slot."""
    n = modes.SHORT_MDCT_SIZE << lm
    if silk_internal:
        on_device(_resample_banks, device, n)

    def silk(state, pcm, meta):
        if not silk_internal:
            return pcm.reshape(-1, n, channels), None
        return _silk_resample(pcm, meta[:, 12] & 0xFF, state.silk_hist, lm, channels)

    return silk


def _make_conceal(lm: int, batch: int, channels: int, with_plc, *, device):
    """The device pitch-regime conceal around a serving core (dsp/plc_exec.py):
    around(state, meta, plc_lpc, plc_pitch, run_core) -> digest.  Streams
    flagged in meta[14] are concealed from the decode memory, undoing the
    post-filter of meta[15]; run_core(plc) runs the core with the merge,
    then the flagged rows of plc_lpc [B, C, 24] and plc_pitch [B] are
    updated in place.  with_plc=True conceals the whole batch; an int k
    conceals a k-capacity sub-batch of the flagged streams."""
    from .plan_exec import _f16_to_f32
    from .plc_exec import make_plc_conceal, make_plc_conceal_compact

    if with_plc is True:
        conceal = make_plc_conceal(lm, batch, channels, device=device)
    else:
        conceal = make_plc_conceal_compact(lm, batch, int(with_plc), channels, device=device)

    def around(state, meta, plc_lpc, plc_pitch, run_core):
        plc_mask = (meta[:, 14] & 1) == 1
        first = ((meta[:, 14] >> 1) & 1) == 1
        m15 = meta[:, 15].to(torch.int64) & 0xFFFFFFFF  # the u32 word
        u_period = m15 & 0x7FF
        u_tapset = (m15 >> 11) & 3
        u_gain = _f16_to_f32(m15 >> 16)
        # The conceal reads state.mem before the core overwrites it.
        if with_plc is True:
            mem_c, new_lpc, new_pitch, out_f_c = conceal(
                state.mem, plc_lpc, plc_pitch, first, u_period, u_gain, u_tapset)
        else:
            mem_c, new_lpc, new_pitch, out_f_c = conceal(
                state.mem, plc_lpc, plc_pitch, plc_mask, first, u_period, u_gain, u_tapset)
        trace.mark("conceal")
        digest = run_core((plc_mask, out_f_c, mem_c))
        plc_lpc.copy_(torch.where(plc_mask[:, None, None], new_lpc, plc_lpc))
        plc_pitch.copy_(torch.where(plc_mask, new_pitch, plc_pitch))
        return digest

    return around


def make_serving_step(lm: int, batch: int, channels: int = 2, downsample: int = 1,
                      pf_chunk: int = _CHUNK, pf_active: bool = True,
                      transfer: str = "q14", silk_mix: bool = False,
                      silk_internal: bool = False, with_plc: bool | int = False, *, device):
    """Single-launch-sequence serving step over one packed plane-A buffer.

    step(state, ring, buf) -> (state, ring, digest[2]): `buf` is the slot's
    int32 words on the device (packed_offsets layout for `transfer`), and
    state and ring [B, frame, C] are updated in place and returned.

    pf_chunk/pf_active specialise the post-filter to the step's actual
    lags and gains; the host picks them per step with pf_chunk_for().

    silk_mix adds the mixed pipeline's SILK region (packed_offsets with
    silk_words): 48 kHz interleaved int16, or with silk_internal the
    internal-rate rows that `_silk_resample` takes to 48 kHz, the step
    then updating state.silk_hist in place.  with_plc adds the device
    conceal (`_make_conceal`): step(state, ring, buf, plc_lpc, plc_pitch).
    """
    if transfer != "q14" and transfer not in PACK_BITS:
        raise ValueError(f"packed transfer {transfer!r} is not q14 or one of {list(PACK_BITS)}")
    if silk_mix and downsample != 1:
        raise ValueError("mixed serving mixes at 48 kHz")
    n = modes.SHORT_MDCT_SIZE << lm
    silk_samps, silk_words = _silk_words(lm, channels, silk_internal)
    off = packed_offsets(batch, transfer, silk_words if silk_mix else 0)
    core = _make_serving_core(lm, channels, downsample, pf_chunk, pf_active, device=device)
    if transfer in PACK_BITS:
        on_device(_unpack_index, device, PACK_BITS[transfer])
    silk_of = _make_silk(lm, channels, silk_internal, device=device) if silk_mix else None
    around = _make_conceal(lm, batch, channels, with_plc, device=device) if with_plc else None

    def unpack(buf):
        xq_w = buf[off["xq"] : off["silk"]]
        if transfer in PACK_BITS:
            w_bits = PACK_BITS[transfer]
            xs = _unpack_pw(xq_w.reshape(batch, 2, 30 * w_bits), batch, n, w_bits)
        else:
            xq = xq_w.view(torch.int16).reshape(batch, 1920)
            xs = (xq[:, : 2 * n].to(torch.float32) * (1.0 / 16384.0)).reshape(batch, 2, n)
        ble = buf[off["ble"] : off["meta"]].view(torch.float32).reshape(batch, 2, 21)
        meta = buf[off["meta"] : off["gains"]].reshape(batch, 16)
        gains = buf[off["gains"] : off["end"]].view(torch.float32).reshape(batch, 3)
        return xs, ble, meta, gains

    @torch.no_grad()
    def step(state: SynthState, ring, buf, *plc):
        xs, ble, meta, gains = unpack(buf)
        trace.mark("unpack")
        silk = (None, None)
        if silk_mix:
            rows = buf[off["silk"] : off["ble"]].view(torch.int16).reshape(batch, 2 * silk_words)
            silk = silk_of(state, rows[:, :silk_samps].to(torch.float32), meta)
            trace.mark("silk")
        return _run_core(core, around, state, ring, (xs, ble, meta, gains), plc, silk)

    return step


def _run_core(core, around, state, ring, planes, plc, silk):
    """A serving step's tail: the core (inside the conceal when the step
    has one), then the new resampler tail into state.silk_hist.
    planes = (xs, ble, meta, gains); silk = (PCM or None, tail or None)."""
    pcm, new_hist = silk

    def run(conceal=None):
        return core(state, ring, *planes, plc=conceal, silk=pcm)

    digest = around(state, planes[2], *plc, run) if around is not None else run()
    if new_hist is not None:
        state.silk_hist.copy_(new_hist)
    trace.mark("synthesis")
    return state, ring, digest


def expand_silk_rows(buf, at, end, smap, silk_words: int, silk_samps: int):
    """The compacted SILK block -> [B, silk_samps] f32, each stream's row.

    The rows are int32 words (int16 pairs) of `buf`, silk_words each, from
    word `at` to word `end` (ints, or 0-d int tensors on the device);
    smap [B] is the row of each stream, and an out-of-range smap selects a
    zero row.  One gather of every stream's words, whatever the row count."""
    nrows = (end - at) // silk_words
    ok = (smap >= 0) & (smap < nrows)
    first = at + torch.where(ok, smap, 0).to(torch.int64) * silk_words
    idx = first[:, None] + torch.arange(silk_words, device=buf.device)
    pcm = buf[idx.clamp_max(buf.shape[0] - 1)].view(torch.int16)[:, :silk_samps]
    return torch.where(ok[:, None], pcm.to(torch.float32), 0.0)


def make_plan_serving_step(lm: int, batch: int, channels: int = 2, downsample: int = 1,
                           pf_chunk: int = _CHUNK, pf_active: bool = True,
                           size_class: tuple = (224, 64, 192), with_plc: bool | int = False,
                           silk_mix: bool = False, silk_internal: bool = False, *, device):
    """Serving step over a plan slot (dsp/plan_exec.py).

    Same contract as make_serving_step, but `buf` holds plane A's pulse-
    vector plan: the packed fixed regions (header [B,2], ble Q9 pairs
    [B,21], dmeta [B,5], bands [B,16+8]; native/frontend.py
    pack_plan_fixed), then the arena.  The step reads `buf` up to word
    step(..., end=...) (the uploaded prefix's length; default the whole of
    `buf`), an int or a 0-d int tensor on the device: the serve loop
    passes its whole device buffer and the end as a device scalar of the
    same upload, so one captured step serves every upload length.  The
    plan executor rebuilds the band spectra, then the shared synthesis
    core runs.  size_class = (p_max, f_max, iyw) is the executor's size
    class, picked per step by the serve loop.

    with_plc adds the device pitch-regime loss concealment
    (dsp/plc_exec.py): streams flagged in meta[14] are concealed from the
    decode memory, with the post-filter to undo from meta[15], and the
    step becomes step(state, ring, buf, plc_lpc, plc_pitch), where
    plc_lpc [B, C, 24] f32 and plc_pitch [B] int32 carry the conceal's
    LPC and pitch and are updated in place on the flagged rows only.
    with_plc=True conceals the whole batch; an int k conceals a
    k-capacity sub-batch of the flagged streams (the serve loop picks it
    when the step's loss count fits).

    silk_mix adds the mixed pipeline's SILK PCM: an smap [B] word after
    the fixed regions maps each stream to a row of the compacted int16
    PCM block that follows the used arena (native/frontend.py
    compact_plan_silk, pack_plan_silk).  The host passes the block's word
    offset as step(..., silk_at=...), an int or a device scalar like
    `end`: the arena ends there and the rows run from there to `end`.
    Each stream gathers its row, or a zero row for an out-of-range smap
    (CELT-only streams and silent SILK frames): exact, as the reference's
    one-hot product is.
    """
    from .plan_exec import _f16_to_f32, make_plan_executor

    if silk_mix and downsample != 1:
        raise ValueError("mixed serving mixes at 48 kHz")
    B = batch
    nbv = modes.NB_E_BANDS
    o_ble = B * 2
    o_dmeta = o_ble + B * nbv
    o_bw0 = o_dmeta + B * 5
    o_beff = o_bw0 + B * 16
    o_smap = o_beff + B * 8
    o_arena = o_smap + (B if silk_mix else 0)
    silk_samps, silk_words = _silk_words(lm, channels, silk_internal)
    p_max, f_max, iyw = size_class
    executor = make_plan_executor(lm, batch, p_max=p_max, f_max=f_max, iyw=iyw, device=device)
    core = _make_serving_core(lm, channels, downsample, pf_chunk, pf_active, device=device)
    silk_of = _make_silk(lm, channels, silk_internal, device=device) if silk_mix else None
    around = _make_conceal(lm, batch, channels, with_plc, device=device) if with_plc else None

    def unpack(buf):
        header = buf[:o_ble].reshape(B, 2)
        blew = buf[o_ble:o_dmeta].reshape(B, nbv)
        # Q9 int16 pairs -> f32 log-energies (int32 >> is arithmetic, so
        # the << 16 >> 16 round trip sign-extends the low half).
        ble = torch.stack([((blew << 16) >> 16).to(torch.float32),
                           (blew >> 16).to(torch.float32)], dim=1) * (1.0 / 512.0)
        d = buf[o_dmeta:o_bw0].reshape(B, 5).to(torch.int64)
        d0, d1 = d[:, 0], d[:, 1]
        d2u = d[:, 2] & 0xFFFFFFFF
        d3u = d[:, 3] & 0xFFFFFFFF
        meta = torch.stack([
            d0 & 1,                                   # 0 silence
            (d0 >> 1) & 1,                            # 1 short blocks
            torch.full_like(d0, lm),                  # 2 lm
            torch.where(((d0 >> 2) & 1) == 1, 1, 2),  # 3 coded channels
            torch.where(((d0 >> 3) & 1) == 1, 17, 0),  # 4 start band
            (d0 >> 8) & 0x1F,                         # 5 eff_end
            d1 & 0x7FF,                               # 6 pf period0
            (d1 >> 11) & 0x7FF,                       # 7 pf period1
            (d0 >> 19) & 0x7FF,                       # 8 pf period2
            (d0 >> 13) & 3,                           # 9 pf tapset0
            (d0 >> 15) & 3,                           # 10 pf tapset1
            (d0 >> 17) & 3,                           # 11 pf tapset2
            (d3u >> 16) & 0xFF,                       # 12 silk descriptor
            (d0 >> 6) & 3,                            # 13 spread
            (d0 >> 4) & 3,                            # 14 plc flags
            d[:, 4],                                  # 15 plc params
        ], dim=1).to(torch.int32)
        gains = torch.stack([_f16_to_f32(d2u), _f16_to_f32(d2u >> 16), _f16_to_f32(d3u)],
                            dim=1)
        bands = torch.cat([buf[o_bw0:o_beff].reshape(B, 16),
                           buf[o_beff:o_smap].reshape(B, 8)], dim=1)
        return header, ble, meta, gains, bands

    @torch.no_grad()
    def step(state: SynthState, ring, buf, *plc, end=None, silk_at=None):
        if silk_mix and silk_at is None:
            raise ValueError("a mixed plan step needs the SILK rows' offset (silk_at)")
        end = buf.shape[0] if end is None else end
        header, ble, meta, gains, bands = unpack(buf)
        arena_end = silk_at if silk_mix else end
        xs = executor(header, bands, meta, buf[o_arena:], arena_end - o_arena)
        trace.mark("plan_exec")
        silk = (None, None)
        if silk_mix:
            rows = expand_silk_rows(buf, silk_at, end, buf[o_smap:o_arena], silk_words,
                                    silk_samps)
            silk = silk_of(state, rows, meta)
            trace.mark("silk")
        return _run_core(core, around, state, ring, (xs, ble, meta, gains), plc, silk)

    return step


def make_opus_step(lm: int, short_blocks: bool, channels: int = 2, downsample: int = 1,
                   *, device):
    """Mode-mux step of decode_frames: make_pipeline_step's CELT synthesis
    plus the SILK layer (decoder.rs:722-729).  silk48 is interleaved
    int16 PCM at the output rate from plane A (zeros for CELT-only
    streams; the whole signal for SILK-only streams, whose CELT spectra
    are bound-masked to silence): out = celt + silk/32768.

    step(state, xraw, mono, band_log_e2, bound, pf_periods, pf_gains,
    pf_tapsets, silk48) -> (new_state, pcm [B, frame, C])."""
    n = modes.SHORT_MDCT_SIZE << lm
    inner = make_pipeline_step(lm, short_blocks, channels, downsample, device=device)

    @torch.no_grad()
    def step(state, xraw, mono, band_log_e2, bound, pf_periods, pf_gains, pf_tapsets, silk48):
        state, pcm = inner(state, xraw, mono, band_log_e2, bound, pf_periods, pf_gains,
                           pf_tapsets)
        silk = silk48[:, : (n // downsample) * channels].reshape(-1, n // downsample, channels)
        return state, pcm + silk.to(torch.float32) * (1.0 / 32768.0)

    return step
