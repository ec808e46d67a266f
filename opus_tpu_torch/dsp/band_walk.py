"""The plan executor's band walk, stereo merge and anti-collapse: the CUDA
kernel's wrapper and its plain version.

After the spreading rotation (dsp/plan_exec.py), the executor holds the
coded leaves of every band in a flat [B, 2N] plane.  What is left of the
reference decoder's work is serial across bands: each band fills its fold
leaves from the `norm` that the bands below it wrote, through the band's
selected forward transform, renormalises each fold leaf, undoes the
transform and writes its own `norm`; then the stereo merge and inversion
and the anti-collapse fill run over every band.

`band_walk` does all of that in one call.  On a CUDA tensor it launches
the hand-written kernel (csrc/band_walk.cu: one block a stream walks the
21 bands with the stream's spectrum and norm in shared memory) and raises
if the kernel does not build or launch.  On a CPU tensor it runs
`_band_walk_ref`, the executor's plain torch code for this region, which
defines the semantics the kernel is held to.  It replaces no TPU kernel:
the reference runs this region as XLA operations, which the port first
ran as some 840 small torch launches a step.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..celt import modes
from ..native.frontend import PLAN_A_MAX
from .plan_tables import (
    EPSILON,
    NB,
    _LCG_MAX,
    _TF_CFGS,
    _lcg_jump_table,
    _plan_band_of_bin,
    _valid_cfg,
    band_transforms,
)

_U32 = 0xFFFFFFFF
#: Nonzeros a row of any band transform has at most (2^3 haar butterflies
#: at lm 3); csrc/band_walk.cu's kTerms.
TERMS = 8


@functools.lru_cache(maxsize=None)
def _band_stacks(lm: int):
    """Per band (forward stack, undo stack), and the slot table (numpy).

    A stack is [nb, S*nb] f32, block s = T_s^T: slot 0 the identity, then
    the transform of each config reachable in the band, then zeros, so
    that one matmul applies every candidate and a gather picks each
    stream's.  The slot table [NB, 32] maps a band's config code
    rec | td<<2 | lb<<4 to its slot; a config the band cannot take maps
    to the zero slot (the reference's selected matrix is 0 there)."""
    m = 1 << lm
    e = modes.E_BANDS.astype(np.int64) * m
    cfgs = [(rec, td, lb) for lb in (True, False) for rec, td in _TF_CFGS[lm][lb]
            if (rec, td, lb) != (0, 0, True)]
    stacks = []
    lut = np.zeros((NB, 32), np.int64)
    for bi in range(NB):
        nb_ = int(e[bi + 1] - e[bi])
        eye = np.eye(nb_, dtype=np.float32)
        slot_of = {16: 0}  # identity: rec 0, td 0, longblocks
        fwd, und = [eye], [eye]
        for rec, td, lb in cfgs:
            if _valid_cfg(nb_, 1 if lb else m, rec, td):
                fw, un = band_transforms(nb_, 1 if lb else m, rec, td, lb)
                slot_of[rec | td << 2 | int(lb) << 4] = len(fwd)
                fwd.append(fw)
                und.append(un)
        lut[bi] = len(fwd)
        for code, slot in slot_of.items():
            lut[bi, code] = slot
        zero = np.zeros_like(eye)
        cat = lambda ts: np.ascontiguousarray(  # noqa: E731
            np.concatenate([t.T for t in ts + [zero]], axis=1))
        stacks.append((cat(fwd), cat(und)))
    return stacks, lut


@functools.lru_cache(maxsize=None)
def walk_tables(lm: int, device: torch.device) -> SimpleNamespace:
    """The band walk's constant tables of one frame size on one device,
    uploaded once: the plain version's (the transform stacks and slot
    table, the LCG jump table, the band geometry) and the kernel's (each
    slot's transform as its rows' nonzeros, `transform_terms`; the slot
    table and the LCG table as int32)."""
    m = 1 << lm
    n = m * modes.SHORT_MDCT_SIZE
    e = modes.E_BANDS.astype(np.int64) * m
    widths = e[1:] - e[:-1]
    norm_len = int(e[NB - 1])
    stacks, lut = _band_stacks(lm)
    term_w, term_c, term_off = transform_terms(stacks)
    bb = _plan_band_of_bin(lm).astype(np.int64)
    oh = np.zeros((n, NB), np.float32)
    oh[np.arange(int(e[NB])), bb[: int(e[NB])]] = 1.0
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    lcg = _lcg_jump_table()
    return SimpleNamespace(
        lm=lm, n=n, e=e, norm_len=norm_len,
        stacks=[(dev(f), dev(u)) for f, u in stacks], slot_lut=dev(lut), lcg_tbl=dev(lcg),
        e_dev=dev(e), bb=dev(bb), in_band=torch.arange(n, device=device) < int(e[NB]),
        eff_max=dev(np.maximum(norm_len - widths, 0)),
        band_ar=[torch.arange(int(w), device=device) for w in widths],
        popcount=dev(np.array([bin(v).count("1") for v in range(256)], np.int64)),
        oh=dev(oh),
        w0_word=dev(np.array([(24 * i) >> 5 for i in range(NB)])),
        w0_sh=dev(np.array([(24 * i) & 31 for i in range(NB)])),
        eff_word=dev(np.array([(11 * i) >> 5 for i in range(NB)])),
        eff_sh=dev(np.array([(11 * i) & 31 for i in range(NB)])),
        term_w=dev(term_w), term_c=dev(term_c), term_off=dev(term_off),
        slots32=dev(lut.astype(np.int32)), lcg32=dev(lcg.astype(np.uint32).view(np.int32)))


def transform_terms(stacks) -> tuple:
    """Every band's transform slots as their rows' nonzeros, for the
    kernel: (w int32, c f32, off int32 [NB, 2]).  Slot s of band i in
    direction d (0 forward, 1 undo) is TERMS x nb entries at off[i, d] +
    s * TERMS * nb, term k of output row j at k * nb + j: the row's k-th
    nonzero T[j, w] in ascending w (the order a dense product adds them
    in), padded with (0, 0.0)."""
    ws, cs, off, at = [], [], np.zeros((NB, 2), np.int32), 0
    for bi, pair in enumerate(stacks):
        nb_ = pair[0].shape[0]
        for d, stack in enumerate(pair):
            blk = stack.reshape(nb_, -1, nb_).transpose(1, 0, 2)  # [S, w, j] = T_s[j, w]
            nz = blk != 0
            if int(nz.sum(axis=1).max()) > TERMS:
                raise ValueError(f"band {bi}: a transform row has more than {TERMS} nonzeros")
            # each column's nonzero rows first, in ascending w (a band
            # narrower than TERMS pads its rows)
            pad = ((0, 0), (0, max(TERMS - nb_, 0)), (0, 0))
            order = np.pad(np.argsort(~nz, axis=1, kind="stable"), pad)[:, :TERMS]
            keep = np.pad(np.take_along_axis(nz, order[:, :nb_], axis=1), pad)[:, :TERMS]
            ws.append(np.where(keep, order, 0).astype(np.int32).ravel())
            cs.append(np.where(keep, np.take_along_axis(blk, order, axis=1), 0.0)
                      .astype(np.float32).ravel())
            off[bi, d] = at
            at += ws[-1].size
    return np.concatenate(ws), np.concatenate(cs), off


def _bitfields(words, word_idx, shift, nwords, bits):
    """Fields of `bits` bits at (word_idx, shift) of a little-endian u32
    word stream [B, nwords] (int64) -> [B, NB]."""
    lo = words[:, word_idx] >> shift
    hi = words[:, (word_idx + 1).clamp_max(nwords - 1)] << (32 - shift)
    return (lo | hi) & ((1 << bits) - 1)


def _apply_selected(xb, stack, sel):
    """xb [B, 2, nb] through each stream's selected transform: y[j] =
    sum_w xb[w] T[j, w] with T = slot sel[b] of `stack`."""
    B, _, nb_ = xb.shape
    S = stack.shape[1] // nb_
    ys = torch.matmul(xb.reshape(B * 2, nb_), stack).reshape(B, 2, S, nb_)
    return ys.gather(2, sel[:, None, None, None].expand(B, 2, 1, nb_))[:, :, 0]


def _band_walk_ref(x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither):
    """Plain torch band walk, stereo merge and anti-collapse (the
    executor's code for this region, op for op; see `band_walk`)."""
    from .plan_exec import _f16_to_f32, _lcg_jump  # plan_exec imports this module

    B, n2 = x.shape
    T = walk_tables(_lm_of(n2 // 2), x.device)
    n, e, norm_len, m, lm = T.n, T.e, T.norm_len, 1 << T.lm, T.lm
    dev = x.device
    stacks, slot_lut, lcg_tbl, e_dev, bb = T.stacks, T.slot_lut, T.lcg_tbl, T.e_dev, T.bb
    in_band, eff_max, band_ar, popcount, oh = T.in_band, T.eff_max, T.band_ar, T.popcount, T.oh
    c2 = meta[:, 3] == 2
    n_ac = header[:, 1].to(torch.int64) >> 18
    fold_v, srcw_v, fgain_v, dith_v = fold, srcw, fgain, dither

    X = x.reshape(B, 2, n).clone()
    bw0 = _bitfields(bands[:, :16].to(torch.int64) & _U32, T.w0_word, T.w0_sh, 16, 24)
    beff = _bitfields(bands[:, 16:24].to(torch.int64) & _U32, T.eff_word, T.eff_sh, 8, 11)
    rec_b = bw0 & 3
    td_b = (bw0 >> 2) & 3
    lb_b = (bw0 >> 4) & 1
    dual_b = (bw0 >> 5) & 1
    isw_b = (bw0 >> 6) & 1
    inv_b = (bw0 >> 7) & 1
    imid_b = ((bw0 >> 8) & 0x7FFF).to(torch.float32) / 32768.0
    ster_b = (bw0 >> 23) & 1
    sel = slot_lut[torch.arange(NB, device=dev), rec_b | td_b << 2 | lb_b << 4]

    norm = torch.zeros((B, 2, norm_len), dtype=torch.float32, device=dev)
    # Hybrid streams (start band 17): plane A emits eff fold offsets
    # relative to its norm buffer (which starts at e[17]); the norm
    # here is absolute, so hybrid streams shift eff by e[17].
    hyb = meta[:, 4] == 17
    e17m = int(e[17])
    effv = torch.minimum((beff + torch.where(hyb, e17m, 0)[:, None]).clamp_min(0), eff_max)
    isw_m = isw_b == 1
    dual_m = dual_b == 1

    for i in range(NB):
        lo_, hi_ = int(e[i]), int(e[i + 1])
        nb_ = hi_ - lo_
        if i == 18:
            # special_hybrid_folding (bands.py): duplicate band 17's
            # folding data so band 18 can fold; plane 1 only while
            # dual stereo was still on at band 17.
            n1h = int(e[18] - e[17])
            n2h = int(e[19] - e[18])
            a0 = e17m + 2 * n1h - n2h
            b0, b1 = e17m + n1h, e17m + n2h
            hmask = torch.stack([hyb, hyb & (dual_b[:, 17] == 1)], dim=1)[:, :, None]
            norm[:, :, b0:b1] = torch.where(hmask, norm[:, :, a0 : a0 + (b1 - b0)],
                                            norm[:, :, b0:b1])
        t_fwd, t_und = stacks[i]

        # intensity switch: average the norm planes below this band
        if lo_ > 0:
            swm = isw_m[:, i, None]
            pref = 0.5 * (norm[:, 0, :lo_] + norm[:, 1, :lo_])
            norm[:, 0, :lo_] = torch.where(swm, pref, norm[:, 0, :lo_])

        # fold sources: the norm window at eff, forward-transformed
        widx = (effv[:, i, None, None] + band_ar[i]).expand(B, 2, nb_)
        ld2 = _apply_selected(norm.gather(2, widx), t_fwd, sel[:, i])
        # fold fill: value = ld2[src plane][srcrel + rel] + dither
        srcw = srcw_v[:, :, lo_:hi_].reshape(B, 2 * nb_)
        lval = ld2.reshape(B, 2 * nb_).gather(1, srcw).reshape(B, 2, nb_)
        has_fold = fold_v[:, :, lo_:hi_]
        fill = torch.where(has_fold, lval + dith_v[:, :, lo_:hi_], 0.0)
        # per-leaf renormalisation over this band's positions
        csum = F.pad(torch.cumsum((fill * fill).reshape(B, 2 * nb_).double(), 1), (1, 0))
        ends = [r[:, :, lo_:hi_].reshape(B, 2 * nb_) for r in (run_lo, run_hi)]
        leafsum = (csum.gather(1, ends[1]) - csum.gather(1, ends[0])).to(torch.float32)
        scale = fgain_v[:, :, lo_:hi_] / torch.sqrt(EPSILON + leafsum.reshape(B, 2, nb_))
        xb = torch.where(has_fold, fill * scale, X[:, :, lo_:hi_])

        # undo transform; the stereo merge waits until after the walk
        # (only the pre-merge values feed later bands, through norm)
        xn = _apply_selected(xb, t_und, sel[:, i])
        X[:, :, lo_:hi_] = xn
        # norm write (pre-merge)
        if i < NB - 1 and hi_ <= norm_len:
            sc = float(np.float32(math.sqrt(nb_)))
            norm[:, 0, lo_:hi_] = sc * xn[:, 0]
            norm[:, 1, lo_:hi_] = torch.where(dual_m[:, i, None], sc * xn[:, 1],
                                              norm[:, 1, lo_:hi_])

    # ---- stereo merge and inversion, every band at once ----
    x0 = X[:, 0]
    y0 = X[:, 1]
    sums = torch.matmul(torch.stack([y0 * x0, y0 * y0], dim=1), oh)  # [B, 2, NB]
    xp = imid_b * sums[:, 0]
    sdd = sums[:, 1]
    el = imid_b * imid_b + sdd - 2 * xp
    er = imid_b * imid_b + sdd + 2 * xp
    degen = ((er < 6e-4) | (el < 6e-4))[:, bb]
    lg = (1.0 / torch.sqrt(el.clamp_min(1e-30)))[:, bb]
    rg = (1.0 / torch.sqrt(er.clamp_min(1e-30)))[:, bb]
    l_ = imid_b[:, bb] * x0
    mx = torch.where(degen, x0, lg * (l_ - y0))
    my = torch.where(degen, x0, rg * (l_ + y0))
    do_m = ((ster_b == 1) & c2[:, None])[:, bb] & in_band
    iv = ((inv_b == 1) & c2[:, None])[:, bb] & in_band
    my = torch.where(do_m, my, y0)
    X = torch.stack([torch.where(do_m, mx, x0), torch.where(iv, -my, my)], dim=1)

    # ---- anti-collapse ----
    avalid = torch.arange(PLAN_A_MAX, device=dev) < n_ac[:, None]
    arec = ac.reshape(B, PLAN_A_MAX, 2)
    a0 = torch.where(avalid, arec[:, :, 0], 0)
    a1 = torch.where(avalid, arec[:, :, 1], 0)
    ab = a0 & 0x1F
    ach = (a0 >> 5) & 1
    amask = (a0 >> 8) & 0xFF
    ar = _f16_to_f32(a0 >> 16)
    # Records into [B, NB, 2] (at most one per band and channel).
    slot = torch.where(avalid & (ab < NB), ab * 2 + ach, 2 * NB)
    r_bc = torch.zeros(B, 2 * NB + 1, device=dev).scatter_add_(1, slot, ar)
    ints = torch.zeros(3, B, 2 * NB + 1, dtype=torch.int64, device=dev)
    ints[0].scatter_add_(1, slot, a1)
    ints[1].scatter_add_(1, slot, amask)
    ints[2].scatter_add_(1, slot, torch.ones_like(slot))

    def bcast(tbl):  # [B, 2*NB(+1)] by (band, ch) -> [B, 2, n], 0 above e[NB]
        t = tbl[:, : 2 * NB].reshape(B, NB, 2)[:, bb, :].permute(0, 2, 1)
        return torch.where(in_band, t, 0)

    has_bc = ints[2, :, : 2 * NB].reshape(B, NB, 2) > 0
    msk = bcast(ints[1])
    has = bcast(ints[2]) > 0
    rr = bcast(r_bc)
    sd = bcast(ints[0]) & _U32
    posn = torch.arange(n, device=dev)
    off_in = posn - e_dev[bb]
    kblk = off_in & (m - 1)
    jj = off_in >> lm
    n0_b = (e_dev[bb + 1] - e_dev[bb]) >> lm
    cleared = ((msk >> kblk) & 1) == 0
    # rank of a cleared block k = cleared blocks below k
    rank = kblk - popcount[msk & ((1 << kblk) - 1)]
    sv_ = _lcg_jump((rank * n0_b + jj + 1).clamp(0, _LCG_MAX - 1), sd, lcg_tbl)
    val = torch.where((sv_ & 0x8000) != 0, rr, -rr)
    newx = torch.where(has & cleared, val, X)
    # renormalise bands with any record
    s2b = torch.matmul(newx * newx, oh)  # [B, 2, NB]
    scl = torch.where(has_bc.permute(0, 2, 1), 1.0 / torch.sqrt(EPSILON + s2b), 1.0)
    return newx * torch.matmul(scl, oh.T)


def _lm_of(n: int) -> int:
    """The frame size of a plane of n bins a channel, 120 << lm, lm 0-3."""
    for lm in range(4):
        if n == modes.SHORT_MDCT_SIZE << lm:
            return lm
    raise ValueError(f"{n} bins a channel is no CELT frame size (120 << lm, lm 0-3)")


def _check(x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither) -> int:
    """Raise ValueError on what the kernel does not take; return lm."""
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[1] % 2:
        raise ValueError(f"x must be float32 [B, 2N], got {x.dtype} {tuple(x.shape)}")
    B, n = x.shape[0], x.shape[1] // 2
    lm = _lm_of(n)
    plane = (2, n)
    for name, t, dtype, shape in (
            ("x", x, torch.float32, (2 * n,)), ("bands", bands, torch.int32, (24,)),
            ("meta", meta, torch.int32, (16,)), ("header", header, torch.int32, (2,)),
            ("ac", ac, torch.int64, (2 * PLAN_A_MAX,)), ("fold", fold, torch.bool, plane),
            ("srcw", srcw, torch.int64, plane), ("run_lo", run_lo, torch.int64, plane),
            ("run_hi", run_hi, torch.int64, plane), ("fgain", fgain, torch.float32, plane),
            ("dither", dither, torch.float32, plane)):
        if t.dtype != dtype or tuple(t.shape) != (B, *shape) or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {(B, *shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not (t.stride(-1) == 1 if t is ac else t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous" + (" along its rows" if t is ac else ""))
    return lm


def _kernel_args(x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither,
                 tables, out) -> tuple:
    """The C arguments of one launch into `out` on checked CUDA tensors,
    but the stream (which `_build.launch` adds)."""
    return (x.data_ptr(), bands.data_ptr(), meta.data_ptr(), header.data_ptr(), ac.data_ptr(),
            ac.stride(0), fold.data_ptr(), srcw.data_ptr(), run_lo.data_ptr(),
            run_hi.data_ptr(), fgain.data_ptr(), dither.data_ptr(), tables.term_w.data_ptr(),
            tables.term_c.data_ptr(), tables.term_off.data_ptr(), tables.slots32.data_ptr(),
            tables.lcg32.data_ptr(), out.data_ptr(), x.shape[0], tables.lm)


def band_walk(x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither):
    """Band spectra [B, 2, N] f32 from the rotated plane of the plan
    executor.

    x [B, 2N] f32, the rotated leaf plane (N = 120 << lm, lm 0-3); bands
    [B, 24], meta [B, 16], header [B, 2] int32, the step's unpacked plan
    words; ac [B, 2 * PLAN_A_MAX] int64, each stream's anti-collapse
    window of u32 arena words (rows may be strided); the fold planes
    [B, 2, N]: fold (bool, a fold leaf's position), srcw (int64, the
    source index into the band's forward-transformed [plane 0 | plane 1]
    norm window), run_lo / run_hi (int64, the position's leaf run within
    its band, band-local [plane 0 | plane 1] indices), fgain and dither
    (f32).  All on one device, contiguous.  A CUDA tensor goes through
    the kernel (each launch adds one to `band_walk.launches`); a CPU
    tensor through `_band_walk_ref`."""
    args = (x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither)
    lm = _check(*args)
    if x.device.type == "cpu":
        return _band_walk_ref(*args)
    if x.device.type != "cuda":
        raise ValueError(f"band_walk runs on cpu or cuda, not {x.device}")
    from .. import _build

    out = torch.empty((x.shape[0], 2, x.shape[1] // 2), dtype=torch.float32, device=x.device)
    _build.launch("opus_band_walk", x.device, _kernel_args(*args, walk_tables(lm, x.device), out))
    band_walk.launches += 1
    return out


band_walk.launches = 0
