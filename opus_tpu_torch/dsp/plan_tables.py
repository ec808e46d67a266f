"""Constant builders of the plan executor, and its numpy oracle.

Each function or table named after one in `opus_tpu.dsp.plan_exec` is a
copy of it and must stay bit-identical to it (tests/test_torch_tables.py
and tests/test_torch_plan_exec.py); they are copied rather than imported
because the port imports nothing of `opus_tpu`.  `_lcg_jump_table` is the
port's own: the LCG jump coefficients as one table instead of the
reference's double-and-add.

The numpy oracle (`execute_plan_numpy` with `parse_leaves`, `unpack_iy`,
`rotate_leaf` and `_exp_rotation1`) replays a plan slot per leaf in
Python, the executor's test reference; `plan_executor_args` assembles the
executor's inputs from a slot.  Their syntax trees equal the reference's
(tests/test_torch_plan_exec.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..celt import modes

NB = modes.NB_E_BANDS
EPSILON = 1e-15
_SPREAD_FACTOR = (15, 10, 5)

# Merged-view leaf types (oracle; the wire format splits the tables).
LEAF_PVQ, LEAF_FOLD, LEAF_NOISE = 0, 1, 2


def f16_bits_to_f32(h: np.ndarray) -> np.ndarray:
    """uint16 IEEE half bits -> float32 (vectorised)."""
    h = h.astype(np.uint32)
    sign = (h >> 15) & 1
    exp = (h >> 10) & 0x1F
    man = h & 0x3FF
    # normal
    f = np.where(
        exp == 0,
        (man / 1024.0) * 2.0 ** (-14),
        (1.0 + man / 1024.0) * (2.0 ** (exp.astype(np.int32) - 15)),
    )
    f = np.where(exp == 31, np.inf, f)
    return np.where(sign == 1, -f, f).astype(np.float32)


def lcg(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def rotation_params(n: int, k: int, spread: int, bq: int):
    """(c, s, stride2, L) of the decode-side spreading rotation, or None
    when the rotation is a no-op (celt/vq.py exp_rotation)."""
    if 2 * k >= n or spread == 0:
        return None
    factor = _SPREAD_FACTOR[spread - 1]
    gain = float(n) / (n + factor * k)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if n >= 8 * bq:
        stride2 = 1
        while (stride2 * stride2 + stride2) * bq + (bq >> 2) < n:
            stride2 += 1
    return c, s, stride2, n // bq


def _exp_rotation1(x, length, stride, c, s):
    ms = -s
    for i in range(length - stride):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = x[i]
        x2 = x[i + stride]
        x[i + stride] = c * x2 + s * x1
        x[i] = c * x1 + ms * x2


def rotate_leaf(x: np.ndarray, n: int, k: int, spread: int, bq: int) -> None:
    """Decode-direction spreading rotation in place (reference replay)."""
    p = rotation_params(n, k, spread, bq)
    if p is None:
        return
    c, s, stride2, L = p
    for i in range(bq):
        seg = x[i * L : (i + 1) * L]
        if stride2:
            _exp_rotation1(seg, L, stride2, s, c)
        _exp_rotation1(seg, L, 1, c, s)


# --- band transform matrices ------------------------------------------------

def _haar1_cols(x: np.ndarray, n0: int, stride: int) -> None:
    """haar1 on the leading axis of a [n, cols] array (bands.py haar1)."""
    n0 >>= 1
    c = 0.70710678
    for i in range(stride):
        idx = i + stride * 2 * np.arange(n0)
        a = c * x[idx]
        b = c * x[idx + stride]
        x[idx] = a + b
        x[idx + stride] = a - b


_ORDERY = {2: (1, 0), 4: (3, 0, 2, 1), 8: (7, 0, 4, 3, 6, 1, 5, 2),
           16: (15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5)}


def _deinterleave_cols(x, n0, stride, hadamard):
    n = n0 * stride
    tmp = np.empty_like(x[:n])
    if hadamard:
        o = _ORDERY[stride]
        for i in range(stride):
            tmp[o[i] * n0 : o[i] * n0 + n0] = x[i:n:stride]
    else:
        for i in range(stride):
            tmp[i * n0 : (i + 1) * n0] = x[i:n:stride]
    x[:n] = tmp


def _interleave_cols(x, n0, stride, hadamard):
    n = n0 * stride
    tmp = np.empty_like(x[:n])
    if hadamard:
        o = _ORDERY[stride]
        for i in range(stride):
            tmp[i:n:stride] = x[o[i] * n0 : o[i] * n0 + n0]
    else:
        for i in range(stride):
            tmp[i:n:stride] = x[i * n0 : (i + 1) * n0]
    x[:n] = tmp


@functools.lru_cache(maxsize=None)
def band_transforms(n: int, b_frame: int, recombine: int, time_divide: int,
                    longblocks: bool):
    """(T_fwd, T_undo) [n, n] f32 for one band config.

    T_undo maps the coded (deinterleaved) domain back to natural order
    (quant_band's resynth reshaping); T_fwd is the forward transform the
    fold source (lowband) receives before leaf filling.  Built by op
    replay on identity columns so float semantics match the reference.
    """
    eye = np.eye(n, dtype=np.float64)

    fwd = eye.copy()
    B = b_frame
    n_b = n // B
    for kk in range(recombine):
        _haar1_cols(fwd, n >> kk, 1 << kk)
    B >>= recombine
    n_b <<= recombine
    for _ in range(time_divide):
        _haar1_cols(fwd, n_b, B)
        B <<= 1
        n_b >>= 1
    b_final = B
    if b_final > 1:
        _deinterleave_cols(fwd, n_b >> recombine, b_final << recombine, longblocks)

    undo = eye.copy()
    if b_final > 1:
        _interleave_cols(undo, n_b >> recombine, b_final << recombine, longblocks)
    B2 = b_final
    n_b2 = n_b
    for _ in range(time_divide):
        B2 >>= 1
        n_b2 <<= 1
        _haar1_cols(undo, n_b2, B2)
    for kk in range(recombine):
        _haar1_cols(undo, n >> kk, 1 << kk)
    return fwd.astype(np.float32), undo.astype(np.float32)


#: Bound on LCG jump distances appearing in any leaf/anti-collapse replay.
_LCG_MAX = 1600


@functools.lru_cache(maxsize=None)
def _lcg_pow2() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(a_k, c_k) of the 2^k-step LCG jump, k = 0..10 (covers _LCG_MAX)."""
    a, c = 1664525, 1013904223
    aa, cc = [], []
    for _ in range(11):
        aa.append(a)
        cc.append(c)
        c = ((a + 1) * c) & 0xFFFFFFFF
        a = (a * a) & 0xFFFFFFFF
    return tuple(aa), tuple(cc)


@functools.lru_cache(maxsize=None)
def _lcg_jump_table() -> np.ndarray:
    """[2, _LCG_MAX] int64: (A_t, C_t) with seed_t = A_t * seed_0 + C_t
    (mod 2^32), composed from _lcg_pow2 by the reference's double-and-add
    (its `_lcg_jump_j`), so every entry is the same integer."""
    aa, cc = _lcg_pow2()
    t = np.arange(_LCG_MAX, dtype=np.int64)
    A = np.ones(_LCG_MAX, np.uint64)
    C = np.zeros(_LCG_MAX, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    for k in range(11):
        bit = ((t >> k) & 1) == 1
        A = np.where(bit, (np.uint64(aa[k]) * A) & m, A)
        C = np.where(bit, (np.uint64(aa[k]) * C + np.uint64(cc[k])) & m, C)
    return np.stack([A, C]).astype(np.int64)


#: Reachable (recombine, time_divide) pairs by longblocks, per lm, from
#: TF_SELECT_TABLE (celt_tables.h): long frames only shrink (td>0), short
#: frames recombine (rec>0) or shrink once.
_TF_CFGS = {
    0: {True: [(0, 0), (0, 1)], False: []},
    1: {True: [(0, 0), (0, 1), (0, 2)], False: [(0, 0), (1, 0), (0, 1)]},
    2: {True: [(0, 0), (0, 2), (0, 3)], False: [(0, 0), (1, 0), (2, 0), (0, 1)]},
    3: {True: [(0, 0), (0, 2), (0, 3)], False: [(0, 0), (1, 0), (3, 0), (0, 1)]},
}


def _valid_cfg(n: int, b_frame: int, rec: int, td: int) -> bool:
    if b_frame >> rec < 1:
        return False
    n_b = (n // b_frame) << rec
    for _ in range(td):
        if n_b & 1:
            return False
        n_b >>= 1
    return True


@functools.lru_cache(maxsize=None)
def _plan_band_of_bin(lm: int) -> np.ndarray:
    m = 1 << lm
    n = m * modes.SHORT_MDCT_SIZE
    widths = (modes.E_BANDS[1:] - modes.E_BANDS[:-1]).astype(np.int64) * m
    idx = np.repeat(np.arange(NB, dtype=np.int32), widths)
    # Bins above the top band never carry anti-collapse content; map them
    # to band 20 (they are masked by `has` anyway).
    return np.concatenate([idx, np.full(n - idx.size, NB - 1, np.int32)])


def plan_executor_args(slot: dict):
    """Assemble the jit executor's inputs from a decoded plan slot
    (numpy; mirrors the device-side unpack in dsp/synthesis.py).
    Returns (header [B,2], bands [B,24], meta [B,16], arena)."""
    bands = np.concatenate([slot["bw0_p"], slot["beff_p"]], axis=1)
    return slot["hdr_p"], bands, slot["meta"], slot["arena"]  # [B,2],[B,24]


# --- record parsing (numpy oracle side) -------------------------------------

def parse_leaves(arena: np.ndarray, hdr: np.ndarray, n_total: int,
                 e_s: int, e_e: int):
    """Decode one stream's leaf tables -> merged dict of field arrays.

    hdr is the 4-word staging header {off, n_pvq|n_fill<<9|n_ac<<18,
    n_ac, iy_rel}.  The merged view (pvq leaves first, then fills)
    carries per-leaf seeds explicitly.  v4: pvq records are one u32
    word and carry neither dst/plane (derived from the tiling
    invariant, which needs the frame geometry: n_total = bins per
    plane, e_s/e_e = coded span bounds in bins) nor K (derived as
    sum(|iy|) after the pulse unpack)."""
    off, counts, iy_off = int(hdr[0]), int(hdr[1]), int(hdr[3])
    np_, nf = counts & 0x1FF, (counts >> 9) & 0x1FF
    na = counts >> 18
    words = arena[off:].astype(np.uint32)
    nl = np_ + nf
    dst = np.zeros(nl, np.int64)
    plane = np.zeros(nl, np.int64)
    n = np.zeros(nl, np.int64)
    typ = np.zeros(nl, np.int64)
    width = np.zeros(nl, np.int64)
    bq = np.ones(nl, np.int64)
    norm2 = np.zeros(nl, np.int64)
    srcrel = np.zeros(nl, np.int64)
    gain = np.zeros(nl, np.float32)
    seeds = np.zeros(nl, np.uint32)
    pb = np.zeros(nf, np.int64)
    for i in range(np_):
        v = int(words[i])
        n[i] = (v & 0xFF) + 1
        width[i] = (v >> 8) & 0xF  # 0 = zero partition
        bq[i] = ((v >> 12) & 0xF) + 1
        gain[i] = f16_bits_to_f32(np.array([(v >> 16) & 0xFFFF], np.uint16))[0]
        typ[i] = LEAF_PVQ
    pvq_words = np_
    for j in range(nf):
        w0 = int(words[pvq_words + 3 * j])
        w1 = int(words[pvq_words + 3 * j + 1])
        i = np_ + j
        dst[i] = w0 & 0x7FF
        plane[i] = (w0 >> 11) & 1
        n[i] = ((w0 >> 12) & 0xFF) + 1
        typ[i] = LEAF_NOISE if (w0 >> 20) & 1 else LEAF_FOLD
        norm2[i] = (w0 >> 21) & 1
        pb[j] = (w0 >> 22) & 0x1FF
        srcrel[i] = w1 & 0x7FF
        gain[i] = f16_bits_to_f32(np.array([(w1 >> 16) & 0xFFFF], np.uint16))[0]
        seeds[i] = np.uint32(words[pvq_words + 3 * j + 2])
    # Derive pvq dst/plane: exclusive length prefix + fills sorted before
    # (pvq_before), mapped through the two-segment coded-span layout.
    if np_:
        fl = n[np_:nl]
        excl = np.cumsum(n[:np_]) - n[:np_]
        fb = ((pb[None, :] <= np.arange(np_)[:, None]) * fl[None, :]).sum(axis=1)
        r = excl + fb
        L0 = e_e - e_s
        flat = np.where(r < L0, e_s + r, n_total + e_s + (r - L0))
        plane[:np_] = flat >= n_total
        dst[:np_] = flat - plane[:np_] * n_total
    ac = words[pvq_words + 3 * nf : pvq_words + 3 * nf + 2 * na].reshape(na, 2)
    iy_words = words[iy_off:]
    return dict(dst=dst, plane=plane, n=n, typ=typ, width=width, bq=bq,
                norm2=norm2, srcrel=srcrel, gain=gain, seeds=seeds,
                acents=ac, iy_words=iy_words, n_pvq=np_)


def unpack_iy(leaves: dict) -> list:
    """Per-leaf integer pulse vectors from the packed bit stream."""
    out = []
    words = leaves["iy_words"].astype(np.uint32)
    bit = 0
    for li in range(leaves["dst"].size):
        if leaves["typ"][li] != LEAF_PVQ or leaves["width"][li] == 0:
            out.append(None)  # fill leaf or zero partition: no iy bits
            continue
        w = int(leaves["width"][li])
        n = int(leaves["n"][li])
        vals = np.zeros(n, np.int64)
        for j in range(n):
            b0 = bit
            wi = b0 >> 5
            sh = b0 & 31
            v = int(words[wi]) >> sh
            if sh + w > 32:
                v |= int(words[wi + 1]) << (32 - sh)
            vals[j] = (v & ((1 << w) - 1)) - (1 << (w - 1))
            bit += w
        out.append(vals)
    return out


# --- the numpy oracle -------------------------------------------------------

def execute_plan_numpy(slot: dict, lm: int) -> np.ndarray:
    """Replay every stream's plan -> X [B, 2, n] natural-domain spectra.

    The numpy oracle for the jitted executor; mirrors the device
    algorithm (band-ordered walk), not the reference's recursion — the
    results agree because every float op is replayed identically.
    Reads the STAGING header/meta/bands (full-precision host arrays)."""
    header, arena = slot["header"], slot["arena"]
    meta, bands = slot["meta"], slot["bands"]
    B = header.shape[0]
    m = 1 << lm
    n_total = m * modes.SHORT_MDCT_SIZE
    e = modes.E_BANDS.astype(np.int64) * m
    norm_len = int(e[NB - 1])
    out = np.zeros((B, 2, n_total), np.float32)

    for bi in range(B):
        mt = meta[bi]
        c_ = int(mt[3])
        spread = int(mt[13])
        hyb = int(mt[4]) == 17  # hybrid: eff offsets are e[17]-relative
        e_s = int(e[17]) if hyb else 0
        e_e = int(e[min(max(int(mt[5]), 0), NB)])
        lv = parse_leaves(arena, header[bi], n_total, e_s, e_e)
        iys = unpack_iy(lv)
        X = np.zeros((2, n_total), np.float64)
        norm = np.zeros((2, norm_len), np.float64)

        nl = lv["dst"].size
        band_w0 = bands[bi, :, 0].astype(np.uint32)
        band_w1 = bands[bi, :, 1].astype(np.uint32)

        # Phase A: PVQ + noise leaves (order-free).
        leaf_seed = lv["seeds"]
        for li in range(nl):
            t = int(lv["typ"][li])
            pl, dst, n = int(lv["plane"][li]), int(lv["dst"][li]), int(lv["n"][li])
            gain = float(lv["gain"][li])
            if t == LEAF_PVQ:
                if int(lv["width"][li]) == 0:
                    continue  # zero partition: X stays 0
                iy = iys[li]
                ryy = float(np.sum(iy.astype(np.float64) ** 2))
                g = gain / math.sqrt(np.float32(ryy))
                x = (g * iy).astype(np.float64)
                # v4: K is not on the wire — derive it from the pulses.
                rotate_leaf(x, n, int(np.abs(iy).sum()), spread,
                            int(lv["bq"][li]))
                X[pl, dst : dst + n] = x
            elif t == LEAF_NOISE:
                seed = int(leaf_seed[li])
                x = np.zeros(n, np.float64)
                for j in range(n):
                    seed = lcg(seed)
                    s32 = seed - (1 << 32) if seed & 0x80000000 else seed
                    x[j] = float(s32 >> 20)
                ee = EPSILON + float(np.sum(x * x))
                X[pl, dst : dst + n] = x * (gain / math.sqrt(ee))

        # Phase B: band walk (folds + undo transforms + norm + merge).
        for i in range(NB):
            base, hi = int(e[i]), int(e[i + 1])
            n = hi - base
            w0, w1 = int(band_w0[i]), int(band_w1[i])
            rec = w0 & 3
            td = (w0 >> 2) & 3
            lb = bool(w0 & 0x10)
            dual = bool(w0 & 0x20)
            int_switch = bool(w0 & 0x40)
            inv = bool(w0 & 0x80)
            imid = (w0 >> 8) & 0x7FFF
            stereo = bool(w0 & (1 << 23))
            eff = (w1 >> 16) & 0x7FF
            if hyb:
                if eff != 0x7FF:
                    eff += int(e[17])
                if i == 18:
                    # special_hybrid_folding (bands.py:605), absolute form
                    n1h = int(e[18] - e[17])
                    n2h = int(e[19] - e[18])
                    a0 = int(e[17]) + 2 * n1h - n2h
                    b0, b1 = int(e[17]) + n1h, int(e[17]) + n2h
                    norm[0, b0:b1] = norm[0, a0 : a0 + (b1 - b0)]
                    if bool(int(band_w0[17]) & 0x20):  # dual at band 17
                        norm[1, b0:b1] = norm[1, a0 : a0 + (b1 - b0)]
            if int_switch:
                norm[0, :base] = 0.5 * (norm[0, :base] + norm[1, :base])
            # fold leaves of this band
            fold_lis = [li for li in range(nl)
                        if lv["typ"][li] == LEAF_FOLD
                        and base <= lv["dst"][li] < hi]
            b_frame = 1 if lb else m
            if fold_lis:
                tf_fwd, _ = band_transforms(n, b_frame, rec, td, lb)
                lbands = {}
                for li in fold_lis:
                    npl = int(lv["norm2"][li])
                    if npl not in lbands:
                        src = norm[npl, eff : eff + n].astype(np.float32)
                        lbands[npl] = tf_fwd @ src
                    ln = int(lv["n"][li])
                    dst = int(lv["dst"][li])
                    pl = int(lv["plane"][li])
                    sr = int(lv["srcrel"][li])
                    seed = int(leaf_seed[li])
                    x = np.zeros(ln, np.float64)
                    for j in range(ln):
                        seed = lcg(seed)
                        dith = 1.0 / 256.0 if (seed & 0x8000) else -1.0 / 256.0
                        x[j] = float(lbands[npl][sr + j]) + dith
                    ee = EPSILON + float(np.sum(x * x))
                    X[pl, dst : dst + ln] = x * (float(lv["gain"][li]) / math.sqrt(ee))
            # undo transforms
            _, t_undo = band_transforms(n, b_frame, rec, td, lb)
            X[0, base:hi] = t_undo @ X[0, base:hi].astype(np.float32)
            if c_ == 2:
                X[1, base:hi] = t_undo @ X[1, base:hi].astype(np.float32)
            # norm write (pre-merge), not for the last band
            if i < NB - 1 and hi <= norm_len:
                norm[0, base:hi] = math.sqrt(n) * X[0, base:hi]
                if dual:
                    norm[1, base:hi] = math.sqrt(n) * X[1, base:hi]
            # stereo merge
            if stereo and c_ == 2:
                mid = imid / 32768.0
                x = X[0, base:hi]
                y = X[1, base:hi]
                xp = mid * float(np.dot(y, x))
                side = float(np.dot(y, y))
                el = mid * mid + side - 2 * xp
                er = mid * mid + side + 2 * xp
                if er < 6e-4 or el < 6e-4:
                    X[1, base:hi] = x
                else:
                    lg = 1.0 / math.sqrt(el)
                    rg = 1.0 / math.sqrt(er)
                    l_ = mid * x
                    X[0, base:hi] = lg * (l_ - y)
                    X[1, base:hi] = rg * (l_ + y)
            if inv and c_ == 2:
                X[1, base:hi] = -X[1, base:hi]

        # Phase C: anti-collapse.
        for r in range(lv["acents"].shape[0]):
            a0, seed = int(lv["acents"][r, 0]), int(lv["acents"][r, 1])
            band = a0 & 0x1F
            ch = (a0 >> 5) & 1
            mask = (a0 >> 8) & 0xFF
            rr = float(f16_bits_to_f32(np.array([(a0 >> 16) & 0xFFFF], np.uint16))[0])
            n0 = int(modes.E_BANDS[band + 1] - modes.E_BANDS[band])
            base = int(e[band])
            for kblk in range(1 << lm):
                if mask & (1 << kblk):
                    continue
                for j in range(n0):
                    seed = lcg(seed)
                    X[ch, base + (j << lm) + kblk] = rr if (seed & 0x8000) else -rr
            seg = X[ch, base : base + (n0 << lm)]
            ee = EPSILON + float(np.sum(seg * seg))
            X[ch, base : base + (n0 << lm)] = seg / math.sqrt(ee)

        out[bi] = X.astype(np.float32)
    return out
