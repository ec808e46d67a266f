"""Plan executor: rebuild CELT band spectra on the device from plane A's plan
(the port of opus_tpu.dsp.plan_exec.make_plan_executor).

Plane A (native/celt_frontend.cpp, celt_fe_decode_batch_plan) emits per
stream one-word PVQ leaf records and a bit-packed stream of integer pulse
vectors, three-word fill (fold/noise) leaf records with explicit LCG
seeds, per-band transform/stereo records and sparse anti-collapse
records.  The executor replays everything the reference decoder does
after the pulse decode: normalisation, the spreading rotation (two
exp_rotation1 passes, through the rotation kernel, dsp/rotation.py),
noise filling, then the band walk (fold filling, interleave/haar undo,
stereo merge and anti-collapse, through the band-walk kernel,
dsp/band_walk.py), for the whole batch at once.

The TPU formulations that existed only because the TPU has no fast
gather or scatter are direct indexing here, with equal output as the
gate (tests/test_torch_plan_exec.py): the leaf-table window fetch is one
gather, the per-position leaf fields come from a leaf-id plane (each
leaf's start scattered, a running maximum along the row, a coverage
check) instead of interval one-hot matmuls, per-leaf sums are
scatter-adds (exact: integer sums of squares stay below 2^24), the
pulse-word fetch is a two-word gather and the chain permutation of the
stride-2 rotation pass is a gather.  The fold leaves' float energy sums
(in the band walk) are differences of a float64 prefix sum over the band
at each leaf run's ends: a float scatter-add's atomics would sum in
another order on every call (a step captured as a CUDA graph must equal
its eager run bit for bit), and a one-hot product's order would change
with the size class.
Integers ride in int64: the wire's u32 words are masked to 32 bits, and
products that the reference takes mod 2^32 are split so that no int64
product overflows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..celt import modes
from ..native.frontend import PLAN_A_MAX, PLAN_IYW
from .band_walk import band_walk, walk_tables
from .plan_tables import EPSILON, NB, _LCG_MAX, _lcg_jump_table, _plan_band_of_bin
from .rotation import rot_pass
from .tables import on_device

_U32 = 0xFFFFFFFF


def _f16_to_f32(h):
    """Integer tensor holding f16 bits in its low 16 bits -> float32.

    IEEE half conversion, exact; exponent 31 decodes as the reference's
    `_f16_to_f32_j` decodes it, to the finite +-(1 + m/1024) * 2^16 (no
    inf or NaN reaches the executor)."""
    h = h & 0xFFFF
    ieee = ((h ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16).to(torch.float32)
    big = (1.0 + (h & 0x3FF).to(torch.float32) / 1024.0) * 65536.0
    big = torch.where((h >> 15) == 1, -big, big)
    return torch.where(((h >> 10) & 0x1F) == 31, big, ieee)


def _mul_u32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding u32 values, without
    overflowing int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _lcg_jump(t, seed, table):
    """LCG seed after t steps from `seed` (int64 u32 values), t in
    [0, _LCG_MAX)."""
    return (_mul_u32(table[0][t], seed) + table[1][t]) & _U32


def _leaf_plane(start, length, n2: int):
    """Per-position leaf of a table of non-overlapping leaves.

    start/length [B, P] int64 (a leaf whose start is outside [0, n2)
    covers nothing).  Returns (leaf [B, n2] index into P, cov [B, n2]
    bool, first [B, n2] the covering leaf's start or 0): each leaf's start
    is scattered, the running maximum along the row finds the latest
    start at or before every position, and the position is covered when
    it lies within that leaf's length."""
    B, P = start.shape
    ok = (start >= 0) & (start < n2)
    idx = torch.where(ok, start, n2)
    starts = torch.full((B, n2 + 1), -1, dtype=torch.int64, device=start.device)
    starts.scatter_(1, idx, torch.where(ok, start, -1))
    lid = torch.zeros((B, n2 + 1), dtype=torch.int64, device=start.device)
    lid.scatter_(1, idx, torch.arange(P, device=start.device).expand(B, P))
    last = torch.cummax(starts[:, :n2], dim=1).values
    leaf = lid.gather(1, last.clamp_min(0))
    pos = torch.arange(n2, device=start.device)
    cov = (last >= 0) & (pos - last < length.gather(1, leaf))
    return leaf, cov, torch.where(cov, last, 0)


def make_plan_executor(lm: int, batch: int, p_max: int = 224, f_max: int = 64,
                       iyw: int = PLAN_IYW, *, device):
    """Build the plan executor for one frame shape.

    Returns f(header [B,2] i32, bands [B,24] i32, meta [B,16] i32,
    arena [AW] i32, used=None) -> X [B, 2, N] f32 natural-domain band
    spectra, with header = {arena offset, n_pvq | n_fill<<9 | n_ac<<18}
    and bands = 16 words of 21x24-bit config fields + 8 words of 21x11-bit
    eff fields (native/frontend.py pack_plan_fixed).  `used` is how many
    of the arena's words the step uploaded (an int or a 0-d int tensor on
    the device; default all AW): the window fetch clamps to the last of
    them, so a whole buffer with a device count fetches the words its
    uploaded prefix would.

    p_max / f_max / iyw are the size class (the serve loop's
    PLAN_CLASSES): the leaf-table and pulse-word windows.  A step whose
    maxima fit a class gives the same output in every class that fits.
    The anti-collapse window is always PLAN_A_MAX = 2 * NB records (at
    most one per band and channel).
    """
    if iyw % 16 or not 0 < iyw <= PLAN_IYW:
        raise ValueError(f"iyw={iyw}: a multiple of 16 up to {PLAN_IYW}")
    device = torch.device(device)
    m = 1 << lm
    n = m * modes.SHORT_MDCT_SIZE
    e = modes.E_BANDS.astype(np.int64) * m
    n2 = 2 * n
    walk_tables(lm, device)  # the band walk's tables, uploaded before any capture
    lcg_tbl = on_device(_lcg_jump_table, device)
    e_dev = torch.as_tensor(e, device=device)
    bb = torch.as_tensor(_plan_band_of_bin(lm).astype(np.int64), device=device)
    widths = e[1:] - e[:-1]
    width_p = torch.as_tensor(widths, device=device)[bb]  # width of each bin's band
    st2_thr = torch.tensor([t * t + t for t in range(1, 15)], device=device)
    factor_tbl = torch.tensor([15, 15, 10, 5], dtype=torch.int64, device=device)
    # band start, width and plane offset (plane * width - start) of each bin
    blo = e_dev[bb]
    bhi = e_dev[(bb + 1).clamp_max(NB)]
    plane_off = torch.arange(2, device=device)[:, None] * (bhi - blo) - blo
    s0 = p_max
    s1 = s0 + 3 * f_max
    s2 = s1 + 2 * PLAN_A_MAX
    wins = (p_max, 3 * f_max, 2 * PLAN_A_MAX, iyw)
    win_off = torch.cat([torch.arange(w, device=device) for w in wins])

    @torch.no_grad()
    def executor(header, bands, meta, arena_i32, used=None):
        B = batch
        dev = arena_i32.device
        amax = (arena_i32.shape[0] if used is None else used) - 1
        hdr_off = header[:, 0].to(torch.int64)
        counts = header[:, 1].to(torch.int64)
        # The arena layout is [pvq 1w][fill 3w][ac 2w][iy]: every offset
        # derives from the counts word.
        n_pvq = counts & 0x1FF
        n_fill = (counts >> 9) & 0x1FF
        n_ac = counts >> 18
        iy_rel = n_pvq + 3 * n_fill + 2 * n_ac
        spread = meta[:, 13].to(torch.int64)
        c2 = meta[:, 3] == 2
        pos = torch.arange(n2, device=dev)

        # ---- one window fetch for all four leaf tables ----
        # Reads past a stream's records land in its neighbours' data;
        # every use is masked by a valid/coverage flag downstream.
        fill_off = hdr_off + n_pvq
        ac_off = fill_off + 3 * n_fill
        starts = torch.cat([
            hdr_off[:, None].expand(B, p_max), fill_off[:, None].expand(B, 3 * f_max),
            ac_off[:, None].expand(B, 2 * PLAN_A_MAX),
            (hdr_off + iy_rel)[:, None].expand(B, iyw),
        ], dim=1)
        at = (starts + win_off).clamp_min(0)
        at = torch.minimum(at, amax) if torch.is_tensor(amax) else at.clamp_max(amax)
        merged = arena_i32[at].to(torch.int64) & _U32

        # ---- pvq leaf table [B, P] (one-word records) ----
        p = torch.arange(p_max, device=dev)
        valid = p < n_pvq[:, None]
        vcat = merged[:, :s0]
        ln = (vcat & 0xFF) + 1
        wid = (vcat >> 8) & 0xF  # 0 = zero partition
        bq = ((vcat >> 12) & 0xF) + 1
        gain = torch.where(valid, _f16_to_f32(vcat >> 16), 0.0)
        iyb = torch.where(valid, ln * wid, 0)
        iybase = torch.cumsum(iyb, dim=1) - iyb

        # ---- fill leaf table [B, F] (3-word records) ----
        fvalid = torch.arange(f_max, device=dev) < n_fill[:, None]
        frec = merged[:, s0:s1].reshape(B, f_max, 3)
        fw0 = frec[:, :, 0]
        fw1 = frec[:, :, 1]
        fseed = torch.where(fvalid, frec[:, :, 2], 0)
        fdst = fw0 & 0x7FF
        fplane = (fw0 >> 11) & 1
        fln = ((fw0 >> 12) & 0xFF) + 1
        fnoise = (fw0 >> 20) & 1
        fnorm2 = (fw0 >> 21) & 1
        fpb = (fw0 >> 22) & 0x1FF
        fsrc = fw1 & 0x7FF
        fgain = torch.where(fvalid, _f16_to_f32(fw1 >> 16), 0.0)

        # ---- pvq flat positions from the tiling invariant ----
        # pvq + zero + fill leaves tile each coded plane contiguously, so a
        # pvq leaf's coded rank is its exclusive length prefix plus the
        # lengths of the fills sorted before it (pvq_before <= p); rank ->
        # flat position is a two-segment affine map.
        ln_z = torch.where(valid, ln, 0)
        excl = torch.cumsum(ln_z, dim=1) - ln_z
        fln_z = torch.where(fvalid, fln, 0)
        before = torch.zeros(B, p_max + 1, dtype=torch.int64, device=dev)
        before.scatter_add_(1, fpb.clamp_max(p_max), fln_z)
        r_rank = excl + torch.cumsum(before[:, :p_max], dim=1)
        e_s = torch.where(meta[:, 4] == 17, int(e[17]), 0)[:, None]
        e_e = e_dev[meta[:, 5].to(torch.int64).clamp(0, NB)][:, None]
        L0 = e_e - e_s
        flatdst = torch.where(
            valid, torch.where(r_rank < L0, e_s + r_rank, n + e_s + (r_rank - L0)), n2)

        # ---- per-position fields of the pvq leaves ----
        L_l = ln // bq
        # stride2 = 1 + #{t in 1..14 : (t*t + t) * bq + bq/4 < n}
        st2 = 1 + ((st2_thr * bq[..., None] + (bq >> 2)[..., None]) < ln[..., None]).sum(-1)
        st2 = torch.where(ln >= 8 * bq, st2, 0)

        leaf, cov, fd_p = _leaf_plane(flatdst, ln, n2)

        def at(table, empty=0):
            return torch.where(cov, table.gather(1, leaf), empty)

        wid_p = at(wid)
        iyb_p = at(iybase)
        L_p = at(L_l).clamp_min(1)
        st2_p = at(st2)
        bq_p = at(bq).clamp_min(1)
        rel = pos - fd_p

        # ---- per-position fields of the fill leaves ----
        fflat = torch.where(fvalid, fplane * n + fdst, n2)
        fleaf, fcov, ffd_p = _leaf_plane(fflat, fln, n2)

        def fat(table, empty=0):
            return torch.where(fcov, table.gather(1, fleaf), empty)

        fsrc_p = fat(fsrc)
        fnorm2_p = fat(fnorm2)
        seed_p = fat(fseed)
        fnoise_p = fat(fnoise)
        frel = pos - ffd_p

        # ---- pulse unpack: two-word gather from the iy window ----
        rows = torch.cat([merged[:, s2:], torch.zeros(B, 1, dtype=torch.int64, device=dev)], 1)
        bit = iyb_p + rel * wid_p
        wloc = (bit >> 5).clamp(0, iyw - 1)
        sh = bit & 31
        lo = rows.gather(1, wloc) >> sh
        hi = torch.where(sh == 0, 0, (rows.gather(1, wloc + 1) << (32 - sh)) & _U32)
        wp_c = wid_p.clamp_min(1)  # avoid negative shifts off-leaf
        iy = ((lo | hi) & ((1 << wp_c) - 1)) - (1 << (wp_c - 1))
        iy = torch.where(cov, iy, 0)

        # ---- pvq normalise and per-leaf K recovery ----
        lidx = torch.where(cov, leaf, p_max)
        sums = torch.zeros(2, B, p_max + 1, dtype=torch.int64, device=dev)
        sums[0].scatter_add_(1, lidx, iy * iy)
        sums[1].scatter_add_(1, lidx, iy.abs())
        ryy = sums[0, :, :p_max].to(torch.float32)
        kk = sums[1, :, :p_max]
        gl = gain / torch.sqrt(ryy.clamp_min(1e-30))
        x = iy.to(torch.float32) * at(gl, 0.0)

        # ---- rotation parameters (celt/vq.py exp_rotation) ----
        factor = factor_tbl[spread.clamp(0, 3)][:, None]
        active = (2 * kk < ln) & (spread[:, None] > 0) & valid
        gr = ln.to(torch.float32) / (ln + factor * kk).to(torch.float32)
        th = 0.5 * gr * gr
        c_l = torch.cos(0.5 * math.pi * th)
        s_l = torch.cos(0.5 * math.pi * (1.0 - th))
        act_p = at(active, False)
        c_p = at(c_l, 0.0)
        s_p = at(s_l, 0.0)

        # ---- noise leaves ----
        sv = _lcg_jump((frel + 1).clamp(0, _LCG_MAX - 1), seed_p, lcg_tbl)
        s32 = sv - ((sv >> 31) << 32)  # reinterpret as int32
        is_noise = fcov & (fnoise_p == 1)
        nzi = torch.where(is_noise, s32 >> 20, 0)
        ncsum = torch.cumsum(nzi * nzi, dim=1)  # exact in int64
        fend = (fflat + fln - 1).clamp(0, n2 - 1)
        fstart = fflat - 1
        nat_end = ncsum.gather(1, fend)
        nat_start = torch.where(fstart < 0, 0, ncsum.gather(1, fstart.clamp(0, n2 - 1)))
        nsum = (nat_end - nat_start).to(torch.float32)
        nscale = fgain / torch.sqrt(EPSILON + nsum)
        x = torch.where(is_noise, nzi.to(torch.float32) * fat(nscale, 0.0), x)

        # ---- rotation: pass A (stride2) then pass B (stride 1) ----
        # Both passes run on every step: on positions without a stride-2
        # (pass A) or any (pass B) rotation the permutations are the
        # identity and the chains have length 1, so a pass is exactly the
        # identity there.
        act_pp = act_p & cov
        seg = torch.minimum(rel // L_p, (bq_p - 1).clamp_min(0))
        rel2 = rel - seg * L_p
        in_rot = act_pp & (rel < bq_p * L_p)
        segbase = fd_p + seg * L_p

        def permute(xsrc, idx):
            """xsrc at idx where the position rotates, else in place (the
            reference's banded permutation transport)."""
            return xsrc.gather(1, torch.where(in_rot, idx, pos).clamp(0, n2 - 1))

        rot_a = in_rot & (st2_p >= 2)
        stA = torch.where(rot_a, st2_p, 1)
        q_ = L_p // stA
        r0 = L_p - q_ * stA  # L % stA
        # forward map: chain-order slot t -> natural offset
        big = rel2 < r0 * (q_ + 1)
        rem = rel2 - r0 * (q_ + 1)
        q1 = (q_ + 1).clamp_min(1)
        qc = q_.clamp_min(1)
        row = torch.where(big, rel2 // q1, r0 + rem // qc)
        col = torch.where(big, rel2 % q1, rem % qc)
        xa = permute(x, segbase + col * stA + row)
        # pass A coefficients are swapped: exp_rotation1(seg, L, st2, s, c)
        mA = torch.where(rot_a, torch.where(big, q_ + 1, q_), 1)
        kA = torch.where(rot_a, col, 0)
        ccA = torch.where(rot_a, s_p, 1.0)
        ssA = torch.where(rot_a, c_p, 0.0)
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        xa = rot_pass(xa.contiguous(), ccA.contiguous(), ssA.contiguous(), i32(kA), i32(mA))
        # inverse map: natural offset -> chain slot
        rowI = rel2 % stA
        tI = rowI * q_ + torch.minimum(rowI, r0) + rel2 // stA
        x = permute(xa, segbase + tI)

        ccB = torch.where(in_rot, c_p, 1.0)
        ssB = torch.where(in_rot, s_p, 0.0)
        mB = torch.where(in_rot, L_p, 1)
        kB = torch.where(in_rot, rel2, 0)
        x = rot_pass(x.contiguous(), ccB.contiguous(), ssB.contiguous(), i32(kB), i32(mB))

        # ---- fold planes of the band walk ----
        fold_v = (fcov & (fnoise_p == 0)).reshape(B, 2, n)
        # fold source index into [ld2 plane 0 | plane 1] of the band
        sr = torch.minimum((fsrc_p + frel).reshape(B, 2, n).clamp_min(0), width_p - 1)
        srcw_v = fnorm2_p.reshape(B, 2, n).clamp(0, 1) * width_p + sr
        # Each fold position's leaf run within its band (the leaf clipped
        # to the band), as band-local [plane 0 | plane 1] indices of the
        # run's first position and one past its last, for the prefix sums
        # of the band walk; any other position is a run of its own.
        fstart = ffd_p.reshape(B, 2, n) - torch.arange(2, device=dev)[:, None] * n
        fend = fstart + fat(fln).reshape(B, 2, n)
        q = torch.arange(n, device=dev)
        run_lo = torch.where(fold_v, torch.maximum(fstart, blo), q) + plane_off
        run_hi = torch.where(fold_v, torch.minimum(fend, bhi), q + 1) + plane_off
        fgain_v = fat(fgain, 0.0).reshape(B, 2, n)
        # Fold dither reuses the noise section's jumped LCG draws (same
        # t = frel + 1 seeds); garbage outside fold leaves is masked.
        dith_v = torch.where((sv & 0x8000) != 0, 1.0 / 256.0, -1.0 / 256.0).reshape(B, 2, n)

        # ---- band walk, stereo merge and anti-collapse (dsp/band_walk.py) ----
        return band_walk(x, bands, meta, header, merged[:, s1:s2], fold_v, srcw_v, run_lo,
                         run_hi, fgain_v, dith_v)

    return executor
