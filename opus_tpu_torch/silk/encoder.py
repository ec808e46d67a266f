"""The Python SILK encoder, a copy of opus_tpu.silk.encoder.

The Encoder builds it beside the native voice and hybrid encoders of
native/frontend.py, which encode the packets whenever the native engine
loads.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T
from .bitstream import NLSF_CB_NB_MB, NLSF_CB_WB, NLSF_QUANT_MAX_AMPLITUDE, NlsfCodebook, nlsf_unpack
from .fixed_math import i16, i32, silk_rand, smulbb
from .nlsf import nlsf2a, nlsf_decode, nlsf_stabilize

SHELL_FRAME = 16


# ---------------------------------------------------------------------------
# Analysis (float; encoder-side choices only, never decoder-visible state).
# ---------------------------------------------------------------------------

def burg_lpc(x: np.ndarray, order: int) -> np.ndarray:
    """Burg AR coefficients a[0..order-1]: x[n] ~= sum a_k x[n-1-k]."""
    x = x.astype(np.float64)
    f = x[1:].copy()
    b = x[:-1].copy()
    a = np.zeros(order)
    for k in range(order):
        den = float(np.dot(f, f) + np.dot(b, b))
        mu = 0.0 if den <= 1e-12 else 2.0 * float(np.dot(f, b)) / den
        mu = max(-0.999, min(0.999, mu))
        a_prev = a.copy()
        a[k] = mu
        for i in range(k):
            a[i] = a_prev[i] - mu * a_prev[k - 1 - i]
        f_new = f - mu * b
        b_new = b - mu * f
        f = f_new[1:]
        b = b_new[:-1]
    return a


def lpc_to_nlsf_q15(a: np.ndarray, order: int) -> list:
    """LPC -> NLSF (Q15) via sign-change scan of the symmetric/antisymmetric
    LSP test functions on a dense frequency grid."""
    coefs = np.concatenate([[1.0], -a[:order]])  # A(z) in powers of z^-1

    def eval_a(w):
        z = np.exp(-1j * w * np.arange(order + 1))
        return np.dot(coefs, z)

    half = (order + 1) / 2.0

    def fp(w):
        return (np.exp(1j * half * w) * eval_a(w)).real

    def fq(w):
        return (np.exp(1j * half * w) * eval_a(w)).imag

    grid = np.linspace(1e-4, math.pi - 1e-4, 64 * order)
    roots = []
    for g in (fp, fq):
        vals = np.array([g(w) for w in grid])
        sign_change = np.nonzero(np.diff(np.sign(vals)) != 0)[0]
        for i in sign_change:
            lo, hi = grid[i], grid[i + 1]
            flo = g(lo)
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                fm = g(mid)
                if (fm < 0) == (flo < 0):
                    lo, flo = mid, fm
                else:
                    hi = mid
            roots.append(0.5 * (lo + hi))
    roots = sorted(roots)[:order]
    while len(roots) < order:
        roots.append((roots[-1] + math.pi) / 2 if roots else 1.0)
    return [int(max(1, min(32766, round(w / math.pi * 32768)))) for w in roots]


# ---------------------------------------------------------------------------
# Quantisation: exact bitstream-level inverses of the decoder.
# ---------------------------------------------------------------------------

def quantize_nlsf(nlsf_q15: list, cb: NlsfCodebook, max_amp: int = 10):
    """Greedy two-stage NLSF quantisation; returns indices[1+order].
    max_amp clamps the residual indices (out-of-range values escape-code
    at ~8-10 bits each; tiny CBR budgets cap them at the base range)."""
    order = cb.order
    target = np.array(nlsf_q15[:order], dtype=np.float64)
    best_i, best_err = 0, None
    for i in range(cb.n_vectors):
        base = np.array([int(cb.cb1_q8[i][j]) << 7 for j in range(order)], dtype=np.float64)
        w = np.array([int(cb.cb1_wght_q9[i][j]) for j in range(order)], dtype=np.float64)
        err = float(np.sum(w * (target - base) ** 2))
        if best_err is None or err < best_err:
            best_i, best_err = i, err
    indices = [best_i] + [0] * order
    _, pred_q8 = nlsf_unpack(cb, best_i)
    # Residual targets in the decoder's Q10 domain.
    res_target_q10 = [0.0] * order
    for j in range(order):
        base = int(cb.cb1_q8[best_i][j]) << 7
        w = int(cb.cb1_wght_q9[best_i][j])
        res_target_q10[j] = (target[j] - base) * w / (1 << 14)
    # Choose idx back-to-front, replaying the decoder's dequant recurrence.
    out_q10_next = 0
    for j in range(order - 1, -1, -1):
        pred_q10 = smulbb(out_q10_next, pred_q8[j]) >> 8
        want = res_target_q10[j] - pred_q10
        step = cb.quant_step_size_q16 / 65536.0
        idx = int(round(want / (1024.0 * step)))
        idx = max(-max_amp, min(max_amp, idx))
        indices[1 + j] = idx
        out_q10 = i16(idx << 10)
        if out_q10 > 0:
            out_q10 = i16(out_q10 - 102)
        elif out_q10 < 0:
            out_q10 = i16(out_q10 + 102)
        out_q10_next = i32(pred_q10 + ((out_q10 * cb.quant_step_size_q16) >> 16))
    return indices


def encode_nlsf_indices(enc, cb: NlsfCodebook, indices, signal_type: int):
    enc.encode_icdf(
        indices[0], cb.cb1_icdf[(signal_type >> 1) * cb.n_vectors :][: cb.n_vectors], 8
    )
    ec_ix, _ = nlsf_unpack(cb, indices[0])
    for i in range(cb.order):
        ix = indices[1 + i]
        table = cb.ec_icdf[ec_ix[i] : ec_ix[i] + 2 * NLSF_QUANT_MAX_AMPLITUDE + 1]
        if ix <= -NLSF_QUANT_MAX_AMPLITUDE:
            enc.encode_icdf(0, table, 8)
            enc.encode_icdf(-ix - NLSF_QUANT_MAX_AMPLITUDE, T.NLSF_EXT_ICDF, 8)
        elif ix >= NLSF_QUANT_MAX_AMPLITUDE:
            enc.encode_icdf(2 * NLSF_QUANT_MAX_AMPLITUDE, table, 8)
            enc.encode_icdf(ix - NLSF_QUANT_MAX_AMPLITUDE, T.NLSF_EXT_ICDF, 8)
        else:
            enc.encode_icdf(ix + NLSF_QUANT_MAX_AMPLITUDE, table, 8)


def _gain_dequant_step(idx: int, prev_ind: int, k: int, conditional: bool):
    """One step of the decoder's gains_dequant; returns (gain_q16, prev')."""
    from .decoder import N_LEVELS_QGAIN
    from .fixed_math import silk_log2lin, smulwb

    if k == 0 and not conditional:
        prev_ind = max(idx, prev_ind - 16)
    else:
        ind_tmp = idx - 4
        thresh = 2 * 36 - N_LEVELS_QGAIN + prev_ind
        if ind_tmp > thresh:
            prev_ind += (ind_tmp << 1) - thresh
        else:
            prev_ind += ind_tmp
    prev_ind = max(0, min(N_LEVELS_QGAIN - 1, prev_ind))
    return silk_log2lin(min(smulwb(1907825, prev_ind) + 2090, 3967)), prev_ind


def quantize_gains(target_gains_q16: list, prev_ind: int, conditional: bool):
    """Pick gain indices by searching the decoder's own dequant step for the
    closest realisable gain; exact replay, no drift possible."""
    indices = []
    gains = []
    for k, tgt in enumerate(target_gains_q16):
        lo, hi = (0, 63) if (k == 0 and not conditional) else (0, 40)
        best = None
        for idx in range(lo, hi + 1):
            g, p2 = _gain_dequant_step(idx, prev_ind, k, conditional)
            err = abs(math.log(max(g, 1)) - math.log(max(tgt, 1)))
            if best is None or err < best[0]:
                best = (err, idx, g, p2)
        _, idx, g, prev_ind = best
        indices.append(idx)
        gains.append(g)
    return indices, gains, prev_ind


def _encode_split(enc, a: int, p: int, table) -> None:
    if p > 0:
        off = int(T.SHELL_CODE_TABLE_OFFSETS[p])
        enc.encode_icdf(a, table[off : off + p + 1], 8)


def shell_encoder(enc, pulses16: list) -> None:
    """Inverse of bitstream.shell_decoder (same traversal order)."""
    p1 = [pulses16[i] + pulses16[i + 1] for i in range(0, 16, 2)]
    p2 = [p1[0] + p1[1], p1[2] + p1[3], p1[4] + p1[5], p1[6] + p1[7]]
    p3 = [p2[0] + p2[1], p2[2] + p2[3]]
    p4 = p3[0] + p3[1]
    _encode_split(enc, p3[0], p4, T.SHELL_CODE_TABLE3)
    for half in range(2):
        if p3[half] == 0:
            continue
        _encode_split(enc, p2[2 * half], p3[half], T.SHELL_CODE_TABLE2)
        for quarter in range(2):
            q = 2 * half + quarter
            if p2[q] == 0:
                continue
            _encode_split(enc, p1[2 * q], p2[q], T.SHELL_CODE_TABLE1)
            for eighth in range(2):
                e = 2 * q + eighth
                if p1[e] == 0:
                    continue
                _encode_split(enc, pulses16[2 * e], p1[e], T.SHELL_CODE_TABLE0)


def encode_pulses(enc, signal_type: int, quant_offset_type: int, pulses: list, frame_length: int):
    """Inverse of bitstream.decode_pulses."""
    n_blocks = frame_length >> 4
    if n_blocks * SHELL_FRAME < frame_length:
        n_blocks += 1
    work = list(pulses) + [0] * (n_blocks * SHELL_FRAME - frame_length)
    mags = [abs(v) for v in work]

    n_lshifts = [0] * n_blocks
    tops = [0] * (n_blocks * SHELL_FRAME)
    sums = [0] * n_blocks
    for i in range(n_blocks):
        blk = mags[i * SHELL_FRAME : (i + 1) * SHELL_FRAME]
        nls = 0
        while sum(v >> nls for v in blk) > 16:
            nls += 1
        n_lshifts[i] = nls
        for k in range(SHELL_FRAME):
            tops[i * SHELL_FRAME + k] = blk[k] >> nls
        sums[i] = sum(tops[i * SHELL_FRAME : (i + 1) * SHELL_FRAME])

    best_level, best_cost = 0, None
    for lev in range(9):
        cost = 0.0
        row = T.PULSES_PER_BLOCK_ICDF[lev]
        for i in range(n_blocks):
            s = sums[i] if n_lshifts[i] == 0 else 17
            p_hi = 256 if s == 0 else row[s - 1]
            prob = max(1, int(p_hi) - int(row[s]))
            cost += -math.log2(prob / 256.0)
        if best_cost is None or cost < best_cost:
            best_level, best_cost = lev, cost
    enc.encode_icdf(best_level, T.RATE_LEVELS_ICDF[signal_type >> 1], 8)

    for i in range(n_blocks):
        if n_lshifts[i] == 0:
            enc.encode_icdf(sums[i], T.PULSES_PER_BLOCK_ICDF[best_level], 8)
        else:
            # value 17 repeated nls times (first from the chosen level's row,
            # subsequent from row 9), then the top sum.
            enc.encode_icdf(17, T.PULSES_PER_BLOCK_ICDF[best_level], 8)
            for j in range(1, n_lshifts[i]):
                row = T.PULSES_PER_BLOCK_ICDF[9]
                enc.encode_icdf(17, row, 8)
            row = T.PULSES_PER_BLOCK_ICDF[9]
            if n_lshifts[i] == 10:
                row = row[1:]
            enc.encode_icdf(sums[i], row, 8)

    for i in range(n_blocks):
        if sums[i] > 0:
            shell_encoder(enc, tops[i * SHELL_FRAME : (i + 1) * SHELL_FRAME])

    for i in range(n_blocks):
        nls = n_lshifts[i]
        if nls > 0:
            for k in range(SHELL_FRAME):
                mag = mags[i * SHELL_FRAME + k]
                for j in range(nls - 1, -1, -1):
                    enc.encode_icdf((mag >> j) & 1, T.LSB_ICDF, 8)

    base = 7 * (quant_offset_type + (signal_type << 1))
    icdf_ptr = T.SIGN_ICDF[base : base + 7]
    for i in range(n_blocks):
        p = sums[i]
        if n_lshifts[i] > 0:
            p |= n_lshifts[i] << 5
        if p > 0:
            icdf0 = int(icdf_ptr[min(p & 0x1F, 6)])
            for j in range(SHELL_FRAME):
                if mags[i * SHELL_FRAME + j] > 0:
                    enc.encode_icdf(1 if work[i * SHELL_FRAME + j] > 0 else 0, (icdf0, 0), 8)


class SilkEncoder:
    """One-channel SILK encoder at a fixed internal rate (8/12/16 kHz).

    encode_frame() consumes one 20 ms frame of int16 samples at the
    internal rate and appends one SILK frame (header flags + indices +
    pulses) to a RangeEncoder.
    """

    #: NLSF-interpolation selection bias: index 4 (no interpolation) wins
    #: unless the interpolated first-half residual beats it by this
    #: factor.  Voiced frames are more conservative because the LTP taps
    #: were searched against the end-of-frame LPC residual.
    UNVOICED_INTERP_BIAS = 0.98
    VOICED_INTERP_BIAS = 0.97

    def __init__(self, fs_khz: int):
        self.fs_khz = fs_khz
        self.nb_subfr = 4
        self.frame_length = 20 * fs_khz
        self.subfr_length = self.frame_length // 4
        self.lpc_order = 16 if fs_khz == 16 else 10
        self.cb = NLSF_CB_WB if fs_khz == 16 else NLSF_CB_NB_MB
        self.gain_state = 10  # decoder LastGainIndex replay
        self.x_hist = np.zeros(self.lpc_order)
        self.xq_hist = np.zeros(self.lpc_order)
        self.xq_buf = np.zeros(20 * fs_khz)  # quantised-signal history (LTP)
        # Noise-shaping feedback: (quantiser-domain, output-domain) error
        # histories for the two-filter NSQ form.
        self.nsq_err_hist = (np.zeros(16), np.zeros(16))
        self.last_range = 0
        # Inter-frame entropy context for conditional coding inside
        # multi-frame (40/60 ms) packets; mirrors the decoder's
        # ec_prev_signal_type / ec_prev_lag_index replay.
        self.ec_prev_signal_type = 0
        self.ec_prev_lag_index = 0
        # Open-loop LPC residual history (LTP search context: without it a
        # 10 ms frame can never see its own pitch period and the voiced
        # gate would never pass).
        self.res_hist = np.zeros(18 * fs_khz + 3)
        # Decoder-replayed previous dequantised NLSF (Q15) for the NLSF
        # interpolation decision; first frame must code index 4 (the
        # decoder forces it after reset).
        self.prev_dec_nlsf = None

    def encode_frame_cbr(self, x: np.ndarray, budget_bytes: int) -> bytes:
        """Encode one 20 ms frame, iterating the gain headroom until the
        payload fits the byte budget (simple CBR outer loop).  Headroom
        floor ~0.35: past it quantisation-offset noise dominates and forces
        pulses right back (practical floor ~20 kbps at WB; packets stay
        valid, they just overshoot tiny budgets)."""
        return self.encode_packet_cbr(x, budget_bytes)

    def _pitch_search(self, xf: np.ndarray):
        """Normalised-autocorrelation pitch over [2, 18] ms; None if weak."""
        x = np.concatenate([self.xq_buf[-18 * self.fs_khz :], xf])
        n0 = len(self.xq_buf[-18 * self.fs_khz :])
        seg = xf
        e0 = float(np.dot(seg, seg)) + 1e-9
        best_c, best_lag = 0.0, None
        for lag in range(2 * self.fs_khz, 18 * self.fs_khz):
            past = x[n0 - lag : n0 - lag + len(seg)]
            num = float(np.dot(seg, past))
            den = (e0 * (float(np.dot(past, past)) + 1e-9)) ** 0.5
            c = num / den
            if c > best_c:
                best_c, best_lag = c, lag
        return best_lag if best_c > 0.45 else None

    @staticmethod
    def _icdf_bits(icdf) -> np.ndarray:
        """Symbol cost in bits from an 8-bit inverse-CDF table."""
        c = np.concatenate([[256], np.asarray(icdf, np.float64)])
        p = np.maximum(c[:-1] - c[1:], 0.5) / 256.0
        return -np.log2(p)

    def _ltp_search(self, res: np.ndarray, sub_lags, vq: np.ndarray,
                    bits: np.ndarray | None = None):
        """Per subframe, pick the VQ row by rate-distortion over the
        open-loop LPC residual (with cross-frame residual history);
        returns (total_rd_cost_bits, total_energy, row_indices).

        RD model: a Gaussian residual of energy e over `sub` samples costs
        (sub/2)*log2(e) bits at fixed distortion, plus the row's entropy
        cost — this is what lets the 3 LTP codebooks compete fairly
        (libopus silk_find_LTP VQ + per_index selection)."""
        sub = self.subfr_length
        h0 = 18 * self.fs_khz + 3
        hist = np.concatenate([self.res_hist, res])
        idx = np.zeros(len(sub_lags), np.int32)
        e_tot = 0.0
        rd_tot = 0.0
        if bits is None:
            bits = np.zeros(vq.shape[0])
        for k in range(len(sub_lags)):
            L = sub_lags[k]
            tgt = res[k * sub : (k + 1) * sub]
            cols = np.stack([
                hist[h0 + k * sub - L + 2 - j : h0 + (k + 1) * sub - L + 2 - j]
                for j in range(5)
            ])
            pred = vq @ cols                  # [rows, sub]
            errs = ((tgt[None, :] - pred) ** 2).sum(axis=1)
            rd = 0.5 * sub * np.log2(np.maximum(errs, 1e-3)) + bits
            r = int(np.argmin(rd))
            idx[k] = r
            e_tot += float(errs[r])
            rd_tot += float(rd[r])
        return rd_tot, e_tot, idx

    def snapshot(self):
        return (self.gain_state, self.x_hist.copy(), self.xq_hist.copy(), self.xq_buf.copy(),
                self.ec_prev_signal_type, self.ec_prev_lag_index, self.res_hist.copy(),
                (self.nsq_err_hist[0].copy(), self.nsq_err_hist[1].copy()),
                None if self.prev_dec_nlsf is None else list(self.prev_dec_nlsf))

    def restore(self, s) -> None:
        (self.gain_state, self.x_hist, self.xq_hist, self.xq_buf,
         self.ec_prev_signal_type, self.ec_prev_lag_index) = (
            s[0], s[1].copy(), s[2].copy(), s[3].copy(), s[4], s[5])
        self.res_hist = s[6].copy()
        self.nsq_err_hist = (s[7][0].copy(), s[7][1].copy())
        self.prev_dec_nlsf = None if s[8] is None else list(s[8])

    def encode_packet_cbr(self, x: np.ndarray, budget_bytes: int,
                          lbrr_x: np.ndarray | None = None,
                          lbrr_enc: "SilkEncoder | None" = None) -> bytes:
        """Encode a 10-60 ms block as one SILK payload (1-3 frames).

        Multi-frame layout per RFC 6716 / silk_Decode: all per-frame VAD
        flags first, then the LBRR flag, then (when ``lbrr_x`` is given)
        the LBRR frames, then each regular frame — frame 0 coded
        independently, later frames conditionally (delta gains, delta
        pitch).  CBR outer loop as in encode_frame_cbr.

        In-band FEC: ``lbrr_x`` is the PREVIOUS block's input; it is
        re-encoded coarsely by ``lbrr_enc`` (a separate SilkEncoder whose
        signal state tracks the LBRR stream) into LBRR frames a receiver
        decodes after a loss (silk/api.py skip path / FLAG_DECODE_LBRR).
        The entropy context (ec_prev_signal_type / lag) threads one chain
        through LBRR frames then regular frames, in packet parse order.
        """
        from ..rc.encoder import RangeEncoder

        if len(x) == self.frame_length // 2:
            nf, flen = 1, self.frame_length // 2  # one 10 ms frame
        else:
            nf, flen = len(x) // self.frame_length, self.frame_length
            assert nf * self.frame_length == len(x) and 1 <= nf <= 3
        headroom = 1.8
        # In-band FEC costs rate: LBRR frames ride along with a ~25%%
        # budget allowance (libopus likewise raises the effective rate
        # when FEC is requested) rather than being dropped or coded
        # uselessly coarse.
        budget_eff = budget_bytes if lbrr_x is None else (budget_bytes * 5) // 4 + 2
        saved = self.snapshot()
        saved_lbrr = lbrr_enc.snapshot() if lbrr_enc is not None else None
        payload = b""
        for it in range(9):
            self.restore(saved)
            if saved_lbrr is not None:
                lbrr_enc.restore(saved_lbrr)
            buf = bytearray(1400)
            enc = RangeEncoder(buf)
            for f in range(nf):
                enc.encode_bit_logp(1, 1)  # VAD
            has_lbrr = lbrr_x is not None and lbrr_enc is not None
            enc.encode_bit_logp(1 if has_lbrr else 0, 1)  # LBRR
            if has_lbrr:
                if nf > 1:  # per-frame LBRR flags, all set
                    tbl = T.LBRR_FLAGS_2_ICDF if nf == 2 else T.LBRR_FLAGS_3_ICDF
                    enc.encode_icdf((1 << nf) - 2, tbl, 8)
                lbrr_enc.ec_prev_signal_type = self.ec_prev_signal_type
                lbrr_enc.ec_prev_lag_index = self.ec_prev_lag_index
                for f in range(nf):
                    # LBRR stays usable even when the primary frame is
                    # squeezed: a coarse-but-intelligible floor of 1.2.
                    lbrr_enc.encode_frame(enc, lbrr_x[f * flen : (f + 1) * flen],
                                          headroom=max(headroom * 2.0, 1.2),
                                          write_header=False, cond=f > 0)
                self.ec_prev_signal_type = lbrr_enc.ec_prev_signal_type
                self.ec_prev_lag_index = lbrr_enc.ec_prev_lag_index
            for f in range(nf):
                self.encode_frame(enc, x[f * flen : (f + 1) * flen],
                                  headroom=headroom, write_header=False, cond=f > 0,
                                  zero_pulses=headroom < 0.052)
            nbytes = min((enc.tell() + 7) >> 3, 1275)
            enc.shrink(nbytes)
            enc.done()
            payload = bytes(enc.data())
            self.last_range = enc.rng & 0xFFFFFFFF
            if len(payload) <= budget_eff or headroom <= 0.051:
                break
            # Headroom floor 0.35 for the first retries (quality: below it
            # quantisation-offset noise dominates); deeper retries drop the
            # voiced side info, clamp NLSF residuals, and finally code a
            # zero-pulse excitation — CBR wins over detail at tiny budgets.
            if it >= 6:
                headroom = 0.05  # final fallback: side info + zero pulses
            else:
                floor = 0.35 if it < 4 else 0.06
                headroom = max(floor, headroom / (1.15 * max(1.0, len(payload) / max(budget_eff, 1)) ** 0.5))
        return payload

    def encode_frame(self, enc, x: np.ndarray, headroom: float = 1.8,
                     write_header: bool = True, cond: bool = False,
                     zero_pulses: bool = False) -> None:
        flen = len(x)
        assert flen in (self.frame_length, self.frame_length // 2)
        nsf = 4 if flen == self.frame_length else 2  # 20 ms / 10 ms frame
        xf = x.astype(np.float64)
        order = self.lpc_order
        sub = self.subfr_length

        # ---- analysis: LPC, open-loop residual, pitch/LTP decision -------
        a = burg_lpc(np.concatenate([self.x_hist, xf]) * (1.0 / 32768.0), order)
        nlsf_q15 = lpc_to_nlsf_q15(a, order)
        nlsf_stabilize(nlsf_q15, self.cb.delta_min_q15, order)
        nlsf_indices = quantize_nlsf(nlsf_q15, self.cb,
                                     max_amp=3 if headroom < 0.30 else 10)
        dec_nlsf = nlsf_decode(nlsf_indices, self.cb)
        a_q12 = nlsf2a(dec_nlsf, order)
        af = np.array(a_q12, dtype=np.float64) / 4096.0

        interp_q2 = 4
        af0 = af
        ext = np.concatenate([self.x_hist, xf])
        res = np.empty(flen)
        for i in range(flen):
            pred = float(np.dot(af, ext[order + i - 1 :: -1][:order]))
            res[i] = xf[i] - pred
        self.x_hist = xf[-order:]

        lag = self._pitch_search(xf)
        signal_type, quant_offset_type = 1, 0
        contour = 0
        per_index = 1
        b_taps = np.zeros((nsf, 5), np.float64)
        ltp_idx = np.zeros(nsf, np.int32)
        sub_lags = [0] * nsf
        ltp_scale = 0.0
        e_plain = float(np.dot(res, res)) + 1e-9
        # Energy gate: a near-silent frame after loud speech must never go
        # voiced — LTP would "explain" the LPC ring-out from history and
        # the decoder would synthesise a full loud frame from past output.
        if float(np.dot(xf, xf)) / flen < 30.0**2:
            lag = None
        # Deep CBR retries: voiced side info (pitch/contour/LTP/scale) alone
        # can exceed a tiny byte budget — drop to unvoiced coding.
        if headroom < 0.30:
            lag = None
        if lag is not None:
            min_lag = 2 * self.fs_khz
            lag = max(min_lag + 2, min(18 * self.fs_khz, lag))
            vq_tables = [np.array(t, np.float64) * (1.0 / 128.0)
                         for t in (T.LTP_GAIN_VQ_0, T.LTP_GAIN_VQ_1, T.LTP_GAIN_VQ_2)]
            vq_bits = [self._icdf_bits(t)
                       for t in (T.LTP_GAIN_ICDF_0, T.LTP_GAIN_ICDF_1, T.LTP_GAIN_ICDF_2)]
            per_bits = self._icdf_bits(T.LTP_PER_INDEX_ICDF)
            if nsf == 4:
                cb_lags = T.CB_LAGS_STAGE3 if self.fs_khz != 8 else T.CB_LAGS_STAGE2
            else:
                cb_lags = T.CB_LAGS_STAGE3_10MS if self.fs_khz != 8 else T.CB_LAGS_STAGE2_10MS
            n_ctr = len(cb_lags[0])
            # Contour by energy with the mid codebook, then codebook
            # (per_index) by rate-distortion at the chosen contour.
            best = None
            for ctr in range(n_ctr):
                lags_k = [max(min_lag, min(18 * self.fs_khz, lag + int(cb_lags[k][ctr])))
                          for k in range(nsf)]
                _, e_tot, idxs = self._ltp_search(res, lags_k, vq_tables[1], vq_bits[1])
                if best is None or e_tot < best[1]:
                    best = (None, e_tot, ctr, idxs, lags_k)
            _, e_ltp, contour, ltp_idx, sub_lags = best
            best_tab = None
            for pi in range(3):
                rd, e_t, idxs = self._ltp_search(res, sub_lags, vq_tables[pi], vq_bits[pi])
                rd += float(per_bits[pi])
                if best_tab is None or rd < best_tab[0]:
                    best_tab = (rd, e_t, pi, idxs)
            _, e_ltp, per_index, ltp_idx = best_tab
            vq = vq_tables[per_index]
            if e_ltp < 0.55 * e_plain:
                signal_type = 2
                for k in range(nsf):
                    b_taps[k] = vq[ltp_idx[k]]
                ltp_scale = int(T.LTP_SCALES_TABLE_Q14[0]) / 16384.0

        # ---- NLSF interpolation (RFC 6716 4.2.7.5.5) ---------------------
        # 20 ms frames: the candidate a0 replays the decoder's INTEGER
        # interpolation of the dequantised NLSFs, so the encoder's model
        # stays coefficient-exact with the decoder.  Voiced frames model
        # the decoder's k==0/k==2 LTP re-whitening in the closed-loop
        # quantiser below (silk/decoder.py:321-341), so they may
        # interpolate too; the stronger bias keeps index 4 unless the
        # first-half envelope clearly moved (the LTP taps were searched
        # against the end-of-frame LPC residual).
        if nsf == 4 and self.prev_dec_nlsf is not None:
            half = flen // 2
            best = None
            # Voiced interpolation is disabled on CBR retries (shrunken
            # headroom): a worse first-half LPC there can tip the frame
            # into the budget-degradation ladder, costing far more than
            # interpolation saves.
            if signal_type != 2:
                bias = self.UNVOICED_INTERP_BIAS
            else:
                bias = self.VOICED_INTERP_BIAS if headroom >= 1.5 else -1e30
            for idx in range(5):
                if idx < 4:
                    nl0 = [int(self.prev_dec_nlsf[j])
                           + ((idx * (int(dec_nlsf[j]) - int(self.prev_dec_nlsf[j]))) >> 2)
                           for j in range(order)]
                    cand = np.array(nlsf2a(nl0, order), np.float64) / 4096.0
                else:
                    cand = af
                e = 1e-9
                for i in range(half):
                    pred = float(np.dot(cand, ext[order + i - 1 :: -1][:order]))
                    e += (xf[i] - pred) ** 2
                score = e if idx < 4 else e * bias  # bias toward 4
                if best is None or score < best[0]:
                    best = (score, idx, cand)
            _, interp_q2, af0 = best
            if interp_q2 < 4:
                for i in range(half):
                    pred = float(np.dot(af0, ext[order + i - 1 :: -1][:order]))
                    res[i] = xf[i] - pred
        self.prev_dec_nlsf = list(dec_nlsf)
        self.last_interp_q2 = interp_q2  # observability / tests

        # ---- gains from the coding residual ------------------------------
        if signal_type == 2:
            gain_res = self._ltp_residual(res, sub_lags, b_taps)
        else:
            gain_res = res
        self.res_hist = np.concatenate([self.res_hist, res])[-len(self.res_hist):]
        targets = []
        for k in range(nsf):
            seg = gain_res[k * sub : (k + 1) * sub]
            rms = math.sqrt(float(np.mean(seg * seg)) + 1e-9)
            targets.append(max(int(rms * 65536.0 / headroom), 65536 // 8))
        gains_idx, gains_q16, self.gain_state = quantize_gains(targets, self.gain_state, cond)

        # ---- bitstream ----------------------------------------------------
        if write_header:
            enc.encode_bit_logp(1, 1)  # VAD
            enc.encode_bit_logp(0, 1)  # LBRR
        enc.encode_icdf(2 * signal_type + quant_offset_type - 2, T.TYPE_OFFSET_VAD_ICDF, 8)
        if cond:
            enc.encode_icdf(gains_idx[0], T.DELTA_GAIN_ICDF, 8)
        else:
            enc.encode_icdf(gains_idx[0] >> 3, T.GAIN_ICDF[signal_type], 8)
            enc.encode_icdf(gains_idx[0] & 7, T.UNIFORM8_ICDF, 8)
        for k in range(1, nsf):
            enc.encode_icdf(gains_idx[k], T.DELTA_GAIN_ICDF, 8)
        encode_nlsf_indices(enc, self.cb, nlsf_indices, signal_type)
        if nsf == 4:
            enc.encode_icdf(interp_q2, T.NLSF_INTERP_FACTOR_ICDF, 8)
        if signal_type == 2:
            min_lag = 2 * self.fs_khz
            lag_index = lag - min_lag
            half = self.fs_khz >> 1
            delta_idx = lag_index - self.ec_prev_lag_index + 9
            if cond and self.ec_prev_signal_type == 2 and 1 <= delta_idx <= 20:
                enc.encode_icdf(delta_idx, T.PITCH_DELTA_ICDF, 8)
            else:
                if cond and self.ec_prev_signal_type == 2:
                    enc.encode_icdf(0, T.PITCH_DELTA_ICDF, 8)  # escape: absolute follows
                enc.encode_icdf(lag_index // half, T.PITCH_LAG_ICDF, 8)
                low_tbl = {4: T.UNIFORM4_ICDF, 6: T.UNIFORM6_ICDF, 8: T.UNIFORM8_ICDF}[half]
                enc.encode_icdf(lag_index % half, low_tbl, 8)
            self.ec_prev_lag_index = lag_index
            if nsf == 4:
                contour_tbl = T.PITCH_CONTOUR_ICDF if self.fs_khz != 8 else T.PITCH_CONTOUR_NB_ICDF
            else:
                contour_tbl = T.PITCH_CONTOUR_10MS_ICDF if self.fs_khz != 8 else T.PITCH_CONTOUR_10MS_NB_ICDF
            enc.encode_icdf(contour, contour_tbl, 8)
            enc.encode_icdf(per_index, T.LTP_PER_INDEX_ICDF, 8)
            gain_icdf = (T.LTP_GAIN_ICDF_0, T.LTP_GAIN_ICDF_1, T.LTP_GAIN_ICDF_2)[per_index]
            for k in range(nsf):
                enc.encode_icdf(int(ltp_idx[k]), gain_icdf, 8)
            if not cond:
                enc.encode_icdf(0, T.LTPSCALE_ICDF, 8)  # CODE_INDEPENDENTLY
        self.ec_prev_signal_type = signal_type
        seed = 0
        enc.encode_icdf(seed, T.UNIFORM4_ICDF, 8)

        # ---- closed-loop excitation quantisation --------------------------
        offset16 = int(T.QUANTIZATION_OFFSETS_Q10[signal_type >> 1][quant_offset_type]) << 4
        adj16 = 80 << 4
        pulses = [0] * flen
        rand_seed = seed
        xq_ext = np.concatenate([self.xq_hist, np.zeros(flen)])
        head_len = 18 * self.fs_khz + 2
        P = np.zeros(head_len + flen)
        if signal_type == 2:
            # Decoder k==0 re-whitening (silk/decoder.py:321-341): the LTP
            # state is the output history filtered by the FIRST subframe's
            # LPC — the interpolated a0 when interp_q2 < 4 — and scaled by
            # ltp_scale.
            a_head = af0 if interp_q2 < 4 else af
            hist = np.concatenate([np.zeros(order), self.xq_buf])
            white = np.empty(len(self.xq_buf))
            for i in range(len(self.xq_buf)):
                white[i] = hist[order + i] - float(np.dot(a_head, hist[order + i - 1 :: -1][:order]))
            P[:head_len] = white[-head_len:] * ltp_scale
        # Noise shaping (the role of libopus's NSQ shaping filter): the
        # coding-noise spectrum becomes E(z)*A(z/g1)/A(z/g2) with g2 > g1,
        # i.e. the noise partially FOLLOWS the spectral envelope so it
        # hides under formants instead of being white in the valleys.
        # f_i = Shp1*e_hist - Shp2*n_hist; e = quantiser-domain error,
        # n = output-domain error (t - q).
        # Shaping off for coarse re-encodes (LBRR at 2x headroom): error
        # feedback at very coarse quantisation saturates and de-correlates
        # the recovered frame.
        g1, g2 = (0.8, 0.93) if headroom < 2.0 else (0.0, 0.0)
        shp1 = af * (g1 ** np.arange(1, order + 1))
        shp2 = af * (g2 ** np.arange(1, order + 1))
        e_hist, n_hist = self.nsq_err_hist
        for i in range(flen):
            rand_seed = silk_rand(rand_seed)
            flip = -1 if rand_seed < 0 else 1
            k = i // sub
            if (signal_type == 2 and interp_q2 < 4 and nsf == 4
                    and i == 2 * sub):
                # Decoder k==2 re-whitening under NLSF interpolation
                # (silk/decoder.py:326-331): the LTP state window is
                # replaced by the decoded OUTPUT (history + this frame's
                # first half) filtered with the second-half LPC, no
                # ltp_scale.
                w_len = min(head_len + i, int(sub_lags[2]) + 2 + 4 + order)
                full = np.concatenate([self.xq_buf, xq_ext[order : order + i]])
                for t in range(w_len - order):
                    gpos = len(full) - (w_len - order) + t
                    P[head_len + i - (w_len - order) + t] = full[gpos] - float(
                        np.dot(af, full[gpos - order : gpos][::-1])
                    )
            g = max(gains_q16[k], 1)
            a_i = af0 if (interp_q2 < 4 and k < nsf // 2) else af
            pred = float(np.dot(a_i, xq_ext[order + i - 1 :: -1][:order]))
            ltp_pred = 0.0
            if signal_type == 2:
                base = head_len + i - sub_lags[k] + 2
                for j in range(5):
                    ltp_pred += b_taps[k][j] * P[base - j]
            feedback = (float(np.dot(shp1, e_hist[:order]))
                        - float(np.dot(shp2, n_hist[:order])))
            t_sig = xf[i] - pred - ltp_pred
            want = (t_sig + feedback) * (1 << 30) / g
            v = want * flip
            p0 = int(round((v - offset16) / 16384.0))
            best = None
            if zero_pulses:
                p0 = 0
            for p in ((0,) if zero_pulses else (p0 - 1, p0, p0 + 1)):
                pc = max(-31, min(31, p))
                dv = pc << 14
                if dv > 0:
                    dv -= adj16
                elif dv < 0:
                    dv += adj16
                dv += offset16
                err = abs(dv - v)
                if best is None or err < best[0]:
                    best = (err, pc, dv)
            _, pulses[i], dv = best
            q_sig = (dv * flip) * g / (1 << 30)
            e_new = (t_sig + feedback) - q_sig
            n_new = t_sig - q_sig
            e_hist[1:] = e_hist[:-1]
            e_hist[0] = max(-3000.0, min(3000.0, e_new))
            n_hist[1:] = n_hist[:-1]
            n_hist[0] = max(-3000.0, min(3000.0, n_new))
            pres = q_sig + ltp_pred
            P[head_len + i] = pres
            xq_ext[order + i] = pred + pres
            rand_seed = i32(rand_seed + pulses[i])
        self.nsq_err_hist = (e_hist, n_hist)
        self.xq_hist = xq_ext[flen : flen + order].copy()
        self.xq_buf = np.concatenate([self.xq_buf, xq_ext[order:]])[-len(self.xq_buf):]

        encode_pulses(enc, signal_type, quant_offset_type, pulses, flen)

    def _ltp_residual(self, res, sub_lags, b_taps):
        sub = self.subfr_length
        out = res.copy()
        h0 = 18 * self.fs_khz + 3
        hist = np.concatenate([self.res_hist, res])
        for k in range(len(sub_lags)):
            L = sub_lags[k]
            for i in range(k * sub, (k + 1) * sub):
                p = 0.0
                for j in range(5):
                    p += b_taps[k][j] * hist[h0 + i - L + 2 - j]
                out[i] = res[i] - p
        return out
