"""Host plane of the batched CELT music encoder, a copy of
opus_tpu.celt.plan_encoder: the PLAN pass runs a frame's whole coding
flow against a scratch range coder from the device's band energies and
dyadic cell stats, records every PVQ leaf (plane, offset, n, K) and the
per-band stereo ops; after the device's pulse search (dsp/encode_exec.py
and its kernel) the EMIT pass runs the same flow again into the packet,
the searched pulse vectors injected at each leaf.

v1 scope, as the reference's: long blocks, tf off, spread SPREAD_NONE,
prefilter off.  `_CellStats` reads the cell table from dsp/encode_exec.py.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_encode.py holds the two equal).
"""

from __future__ import annotations

import math

import numpy as np

from ..mathops import bitexact_cos, bitexact_log2tan, celt_sudiv, frac_mul16
from ..rc import RangeEncoder
from . import modes
from .bands import QTHETA_OFFSET, compute_qn
from .cwrs import encode_pulses, get_pulses
from .decoder import SPREAD_ICDF, TF_SELECT_TABLE, TRIM_ICDF
from .encoder import CeltEncoder
from .energy_encode import (
    amp2_log2, quant_coarse_energy, quant_energy_finalise, quant_fine_energy,
)
from .rate import BITRES, bits2pulses, compute_allocation, init_caps, pulses2bits
from .vq import SPREAD_NONE

EPS = 1e-15


class _CellStats:
    """Span-energy oracle over the device cell stats for one stream."""

    def __init__(self, cells: np.ndarray, lm: int):
        from ..dsp.encode_exec import cell_table

        starts, lens, bands, offs = cell_table(lm)
        self.cs = starts.astype(np.int64)
        self.ce = (starts + lens).astype(np.int64)
        self.cells = cells.astype(np.float64)  # [NC, 3] = Ex, Ey, Exy

    def span(self, off: int, n: int, w: tuple) -> float:
        """Energy of the linear combo (a*x0 + b*x1) over [off, off+n):
        w = (a*a, b*b, 2ab)."""
        sel = (self.cs >= off) & (self.ce <= off + n)
        ex, ey, exy = self.cells[sel].sum(axis=0)
        return w[0] * ex + w[1] * ey + w[2] * exy


_W_X = (1.0, 0.0, 0.0)
_W_Y = (0.0, 1.0, 0.0)
_W_MID = (0.5, 0.5, 1.0)   # .7071(x+y)
_W_SIDE = (0.5, 0.5, -1.0)  # .7071(y-x): energy same as (x-y)


def _itheta_from(emid: float, eside: float) -> int:
    # f32 cell-stat cancellation can push a tiny true energy (near-
    # identical channels: .5Ex+.5Ey-Exy) slightly negative — clamp.
    mid = math.sqrt(EPS + max(0.0, emid))
    side = math.sqrt(EPS + max(0.0, eside))
    return int(math.floor(0.5 + 16384 * 0.63662 * math.atan2(side, mid)))


class _BandWalk:
    """quant_all_bands mirror over the cell-stat domain (encode side,
    resynth off, long blocks, tf zeros)."""

    def __init__(self, enc, stats: _CellStats, band_e, lm: int, c_: int,
                 intensity: int, dual_stereo: bool, total_bits: int,
                 balance: int, pulses, coded_bands: int, start: int, end: int,
                 leaf_cb, band_ops_out):
        self.ec = enc
        self.st = stats
        self.band_e = band_e
        self.lm = lm
        self.m = 1 << lm
        self.c_ = c_
        self.intensity = intensity
        self.dual = dual_stereo
        self.total_bits = total_bits
        self.balance = balance
        self.pulses = pulses
        self.coded_bands = coded_bands
        self.start = start
        self.end = end
        self.leaf_cb = leaf_cb
        self.band_ops = band_ops_out  # [NB, 4] f32
        self.remaining_bits = 0
        self.band = 0

    # -- leaf ------------------------------------------------------------
    def _partition(self, plane: int, w: tuple, off: int, n: int, b: int,
                   lm: int) -> None:
        band = self.band
        cache_off = int(modes.CACHE_INDEX[lm + 1][band])
        cache = modes.CACHE_BITS
        if lm != -1 and b > int(cache[cache_off + int(cache[cache_off])]) + 12 and n > 2:
            h = n >> 1
            lm -= 1
            # compute_theta, mono flavour (B=B0=1, triangular pdf)
            pulse_cap = int(modes.LOG_N[band]) + lm * (1 << BITRES)
            offset = (pulse_cap >> 1) - QTHETA_OFFSET
            qn = compute_qn(h, b, offset, pulse_cap, False)
            itheta = _itheta_from(self.st.span(off, h, w),
                                  self.st.span(off + h, h, w))
            tell = self.ec.tell_frac()
            if qn != 1:
                itheta = (itheta * qn + 8192) >> 14
                # triangular pdf (B0==1, not stereo)
                ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
                if itheta <= qn >> 1:
                    fs = itheta + 1
                    fl = itheta * (itheta + 1) >> 1
                else:
                    fs = qn + 1 - itheta
                    fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
                self.ec.encode(fl, fl + fs, ft)
                itheta = (itheta * 16384) // qn
            else:
                itheta = 0
            qalloc = self.ec.tell_frac() - tell
            b -= qalloc
            if itheta == 0:
                delta = -16384
            elif itheta == 16384:
                delta = 16384
            else:
                imid = bitexact_cos(itheta)
                iside = bitexact_cos(16384 - itheta)
                delta = frac_mul16((h - 1) << 7, bitexact_log2tan(iside, imid))
            mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
            sbits = b - mbits
            self.remaining_bits -= qalloc
            rebalance = self.remaining_bits
            if mbits >= sbits:
                self._partition(plane, w, off, h, mbits, lm)
                rebalance = mbits - (rebalance - self.remaining_bits)
                if rebalance > 3 << BITRES and itheta != 0:
                    sbits += rebalance - (3 << BITRES)
                self._partition(plane, w, off + h, h, sbits, lm)
            else:
                self._partition(plane, w, off + h, h, sbits, lm)
                rebalance = sbits - (rebalance - self.remaining_bits)
                if rebalance > 3 << BITRES and itheta != 16384:
                    mbits += rebalance - (3 << BITRES)
                self._partition(plane, w, off, h, mbits, lm)
            return
        # leaf
        q = bits2pulses(band, lm, b)
        curr = pulses2bits(band, lm, q)
        self.remaining_bits -= curr
        while self.remaining_bits < 0 and q > 0:
            self.remaining_bits += curr
            q -= 1
            curr = pulses2bits(band, lm, q)
            self.remaining_bits -= curr
        if q != 0:
            k = get_pulses(q)
            self.leaf_cb(self.ec, plane, off, n, k)
        # q == 0: fold/noise leaf — nothing coded (resynth off)

    # -- bands -----------------------------------------------------------
    def _band_mono(self, plane: int, w: tuple, i: int, b: int) -> None:
        n = self.m * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i])
        off = self.m * int(modes.E_BANDS[i])
        assert n > 1, "n==1 bands unreachable at lm>=1"
        self._partition(plane, w, off, n, b, self.lm)

    def _band_stereo(self, i: int, b: int) -> None:
        n = self.m * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i])
        off = self.m * int(modes.E_BANDS[i])
        assert n > 2, "2-sample stereo special unreachable at lm>=1"
        band = self.band
        # compute_theta, stereo flavour
        pulse_cap = int(modes.LOG_N[band]) + self.lm * (1 << BITRES)
        offset = (pulse_cap >> 1) - QTHETA_OFFSET
        qn = compute_qn(n, b, offset, pulse_cap, True)
        if band >= self.intensity:
            qn = 1
        itheta = _itheta_from(self.st.span(off, n, _W_MID),
                              self.st.span(off, n, _W_SIDE))
        inv = False
        tell = self.ec.tell_frac()
        if qn != 1:
            itheta = (itheta * qn + 8192) >> 14
            # step pdf (stereo, n > 2)
            p0, x0 = 3, qn // 2
            ft = p0 * (x0 + 1) + x0
            t = itheta
            fl = p0 * t if t <= x0 else (t - 1 - x0) + (x0 + 1) * p0
            fh = p0 * (t + 1) if t <= x0 else (t - x0) + (x0 + 1) * p0
            self.ec.encode(fl, fh, ft)
            itheta = (itheta * 16384) // qn
            if itheta == 0:
                self._set_intensity_op(i)
            else:
                self.band_ops[i, 0] = 2.0  # mid/side split
        else:
            inv = itheta > 8192
            self._set_intensity_op(i, inv)
            if b > 2 << BITRES and self.remaining_bits > 2 << BITRES:
                self.ec.encode_bit_logp(1 if inv else 0, 2)
            else:
                inv = False
            itheta = 0
        qalloc = self.ec.tell_frac() - tell
        b -= qalloc
        if itheta == 0:
            delta = -16384
        elif itheta == 16384:
            delta = 16384
        else:
            imid = bitexact_cos(itheta)
            iside = bitexact_cos(16384 - itheta)
            delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid))
        op = self.band_ops[i, 0]
        wm = (_W_MID if op == 2.0 else
              (self.band_ops[i, 1] ** 2, self.band_ops[i, 2] ** 2,
               2.0 * self.band_ops[i, 1] * self.band_ops[i, 2]))
        mbits = max(0, min(b, celt_sudiv(b - delta, 2)))
        sbits = b - mbits
        self.remaining_bits -= qalloc
        rebalance = self.remaining_bits
        if mbits >= sbits:
            self._partition(0, wm, off, n, mbits, self.lm)
            rebalance = mbits - (rebalance - self.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            self._partition(1, _W_SIDE, off, n, sbits, self.lm)
        else:
            self._partition(1, _W_SIDE, off, n, sbits, self.lm)
            rebalance = sbits - (rebalance - self.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            self._partition(0, wm, off, n, mbits, self.lm)

    def _set_intensity_op(self, i: int, inv: bool = False) -> None:
        left = float(self.band_e[0][i])
        right = float(self.band_e[1][i])
        norm = EPS + math.sqrt(EPS + left * left + right * right)
        self.band_ops[i, 0] = 3.0
        self.band_ops[i, 1] = left / norm
        self.band_ops[i, 2] = (-1.0 if inv else 1.0) * (right / norm)

    def run(self) -> None:
        dual = self.dual
        for i in range(self.start, self.end):
            self.band = i
            tell = self.ec.tell_frac()
            if i != self.start:
                self.balance -= tell
            remaining = self.total_bits - tell - 1
            self.remaining_bits = remaining
            if i <= self.coded_bands - 1:
                curr = celt_sudiv(self.balance, min(3, self.coded_bands - i))
                b = max(0, min(16383, min(remaining + 1, self.pulses[i] + curr)))
            else:
                b = 0
            if dual and i == self.intensity:
                dual = False
            if self.c_ == 2 and not dual:
                self._band_stereo(i, b)
            elif self.c_ == 2:
                self.band_ops[i, 0] = 1.0  # dual: planes coded separately
                self._band_mono(0, _W_X, i, b // 2)
                self._band_mono(1, _W_Y, i, b // 2)
            else:
                self._band_mono(0, _W_X, i, b)
            self.balance += self.pulses[i] + tell


class PlanCeltEncoder:
    """Two-pass (plan/emit) CELT music encoder over device analyze
    outputs, for one stream of a batch.  Holds the cross-frame state a
    CeltEncoder would (energy prediction, frame counter, rng)."""

    def __init__(self, channels: int):
        self.channels = channels
        self.stream_channels = channels
        self.host = CeltEncoder(channels)  # state container (old_band_e...)
        self.rng = 0

    def plan_frame(self, band_e, cells, dots, nb_bytes: int, lm: int):
        """PLAN pass -> (leaves [P, 4] i32, band_ops [NB, 4] f32) or
        (None, None) for a silent frame."""
        leaves: list = []
        band_ops = np.zeros((modes.NB_E_BANDS, 4), np.float32)

        def leaf_rec(enc, plane, off, n, k):
            leaves.append((plane, off, n, k))
            dummy = np.zeros(n, np.int64)
            dummy[0] = k
            encode_pulses(enc, dummy)

        self._run(band_e, cells, dots, nb_bytes, lm, leaf_rec, band_ops,
                  emit=False)
        return (np.asarray(leaves, np.int32).reshape(-1, 4), band_ops)

    def emit_frame(self, band_e, cells, dots, nb_bytes: int, lm: int,
                   iy_rows: np.ndarray) -> bytes:
        """EMIT pass with device iy rows (aligned with plan_frame's leaf
        order; [P, NMAX] i32) -> final packet payload."""
        it = iter(range(len(iy_rows)))

        def leaf_emit(enc, plane, off, n, k):
            try:
                r = next(it)
                iy = iy_rows[r][:n].astype(np.int64).copy()
            except StopIteration:
                iy = np.zeros(n, np.int64)
            have = int(np.abs(iy).sum())
            while have > k:  # K drifted down between passes: drop pulses
                j = int(np.argmax(np.abs(iy)))
                iy[j] -= np.sign(iy[j])
                have -= 1
            while have < k:  # K drifted up: stack onto the largest slot
                j = int(np.argmax(np.abs(iy)))
                if iy[j] == 0:
                    iy[0] += 1
                else:
                    iy[j] += np.sign(iy[j])
                have += 1
            encode_pulses(enc, iy)

        return self._run(band_e, cells, dots, nb_bytes, lm, leaf_emit,
                         np.zeros((modes.NB_E_BANDS, 4), np.float32),
                         emit=True)

    # -- the shared frame flow -------------------------------------------
    def _run(self, band_e, cells, dots, nb_bytes, lm, leaf_cb, band_ops,
             emit: bool):
        h = self.host
        c_ = self.stream_channels
        n = (1 << lm) * modes.SHORT_MDCT_SIZE
        nb_bytes = min(int(nb_bytes), 1275)
        buf = bytearray(nb_bytes)
        enc = RangeEncoder(buf)
        total_bits = nb_bytes * 8
        start, end = 0, h.end_band
        eff_end = min(end, modes.EFF_E_BANDS)
        be = np.zeros((2, modes.NB_E_BANDS))
        be[:c_, :eff_end] = np.asarray(band_e, np.float64)[:c_, :eff_end]
        band_log_e = amp2_log2(be, eff_end, c_)
        old_e = h.old_band_e if emit else h.old_band_e.copy()

        tell = enc.tell()
        if tell == 1:
            silence = bool(np.max(band_log_e[:c_, :eff_end]) < -25.0)
            enc.encode_bit_logp(1 if silence else 0, 15)
            if silence:
                if emit:
                    h.old_band_e[:, :] = -28.0
                    self.rng = enc.rng
                    h.frame_count += 1
                    enc.done()
                    self.rng = enc.rng
                    return bytes(buf)
                return None
        tell = enc.tell()
        if tell + 16 <= total_bits:
            enc.encode_bit_logp(0, 1)  # prefilter off (v1 static scope)
            tell = enc.tell()
        if lm > 0 and tell + 3 <= total_bits:
            enc.encode_bit_logp(0, 3)  # long blocks only (v1)
            tell = enc.tell()

        intra = h.frame_count == 0
        error = quant_coarse_energy(
            enc, band_log_e, old_e, start, end, intra, lm, c_,
            total_bits, nb_bytes,
        )
        # tf: all zeros (v1) — mirrors encoder.py _tf_encode with
        # tf_res == 0 and is_transient False (logp 4 then 5; select bit
        # only when it would change an executed value)
        budget = nb_bytes * 8
        tell = enc.tell()
        logp = 4
        tf_select_rsv = 1 if (lm > 0 and tell + logp + 1 <= budget) else 0
        budget -= tf_select_rsv
        for _ in range(start, end):
            if tell + logp <= budget:
                enc.encode_bit_logp(0, logp)
                tell = enc.tell()
            logp = 5
        if tf_select_rsv and TF_SELECT_TABLE[lm][0] != TF_SELECT_TABLE[lm][2]:
            enc.encode_bit_logp(0, 1)
        spread = SPREAD_NONE
        if enc.tell() + 4 <= total_bits:
            enc.encode_icdf(spread, SPREAD_ICDF, 5)

        cap = init_caps(lm, c_)
        want = h._dynalloc_analysis(band_log_e, start, eff_end, lm, c_, cap,
                                    is_transient=False,
                                    effective_bytes=nb_bytes)
        dynalloc_logp = 6
        total_bits_frac = total_bits << BITRES
        tell_frac = enc.tell_frac()
        offsets = [0] * modes.NB_E_BANDS
        for i in range(start, end):
            width = c_ * int(modes.E_BANDS[i + 1] - modes.E_BANDS[i]) << lm
            quanta = min(width << BITRES, max(6 << BITRES, width))
            loop_logp = dynalloc_logp
            boost = 0
            while (tell_frac + (loop_logp << BITRES) < total_bits_frac
                   and boost < int(cap[i])):
                flag = 1 if boost + quanta <= want[i] else 0
                enc.encode_bit_logp(flag, loop_logp)
                tell_frac = enc.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits_frac -= quanta
                loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = h._trim_decision(band_log_e, start, eff_end, c_)
        if tell_frac + (6 << BITRES) <= total_bits_frac:
            enc.encode_icdf(alloc_trim, TRIM_ICDF, 7)
        else:
            alloc_trim = 5

        bits = (nb_bytes * 8 << BITRES) - enc.tell_frac() - 1
        intensity = end
        if c_ == 2:
            bps = nb_bytes * 8 * 48000 // n
            if bps < 44000:
                intensity = min(8, end)
            elif bps < 52000:
                intensity = min(12, end)
            elif bps < 56000:
                intensity = min(16, end)
        dual_stereo = False
        if c_ == 2:
            aa, bb, ab = (float(dots[0]), float(dots[1]), float(dots[2]))
            den = (aa * bb) ** 0.5
            if den > 1e-9 and abs(ab) / den < 0.3:
                dual_stereo = True
        (pulses, fine_quant, fine_priority, coded_bands, intensity,
         dual_stereo, balance) = compute_allocation(
            start, end, offsets, cap, alloc_trim, intensity, dual_stereo,
            bits, c_, lm, enc, True, 0, end,
        )
        quant_fine_energy(enc, old_e, error, fine_quant, start, end, c_)

        stats = _CellStats(np.asarray(cells), lm)
        walk = _BandWalk(
            enc, stats, be, lm, c_, intensity, dual_stereo,
            nb_bytes * (8 << BITRES), balance, pulses, coded_bands,
            start, end, leaf_cb, band_ops,
        )
        walk.run()

        quant_energy_finalise(
            enc, old_e, error, fine_quant, fine_priority,
            nb_bytes * 8 - enc.tell(), start, end, c_,
        )
        if not emit:
            return None
        if c_ == 1:
            old_e[1, :] = old_e[0, :]
        for c in range(2):
            old_e[c, :start] = 0.0
            old_e[c, end:] = 0.0
        h.frame_count += 1
        enc.done()
        self.rng = enc.rng
        return bytes(buf)
