// SILK bitstream front end + synthesis (plane A) — native engine.
//
// C++ translation of the validated bit-exact Python decoder
// (opus_tpu/silk/*.py, itself pinned sample-exact against libopus).
// Decodes one mono SILK frame: side info, excitation, and the full
// normative fixed-point synthesis, and also emits the parameter planes
// the batched TPU synthesis kernel consumes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <memory>

#include "ec.h"
#include "silk_tables.h"

using namespace opusfe;
using namespace silk_tables;

namespace {

// ---------------------------------------------------------------------------
// Fixed-point primitives (opus_tpu/silk/fixed_math.py).
// ---------------------------------------------------------------------------

static inline int32_t sat16i(int32_t x) { return std::max(-32768, std::min(32767, x)); }
static inline int64_t sat32(int64_t x) {
    return std::max<int64_t>(INT32_MIN, std::min<int64_t>(INT32_MAX, x));
}
static inline int32_t smulbb(int32_t a, int32_t b) { return (int32_t)((int16_t)a * (int16_t)b); }
static inline int32_t smulwb(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * (int16_t)b) >> 16);
}
static inline int32_t smlawb(int32_t a, int32_t b, int32_t c) {
    return (int32_t)(a + (((int64_t)b * (int16_t)c) >> 16));
}
static inline int32_t smulww(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * b) >> 16);
}
static inline int32_t smlaww(int32_t a, int32_t b, int32_t c) {
    return (int32_t)(a + (((int64_t)b * c) >> 16));
}
static inline int32_t rshift_round(int32_t a, int shift) {
    return shift == 1 ? (a >> 1) + (a & 1) : ((a >> (shift - 1)) + 1) >> 1;
}
static inline int64_t rshift_round64(int64_t a, int shift) {
    return ((a >> (shift - 1)) + 1) >> 1;
}
static inline int32_t lshift_sat32(int32_t a, int shift) {
    return (int32_t)sat32((int64_t)a << shift);
}
static inline int32_t add_sat32i(int32_t a, int32_t b) { return (int32_t)sat32((int64_t)a + b); }
static inline int clz32i(uint32_t x) { return x ? __builtin_clz(x) : 32; }
static inline int32_t silk_rand(int32_t seed) {
    return (int32_t)(907633515u + (uint32_t)seed * 196314165u);
}
static inline int32_t div32_16(int32_t a, int16_t b) { return a / b; }

static int32_t inverse32_varq(int32_t b32, int qres) {
    int b_headrm = clz32i((uint32_t)std::abs(b32)) - 1;
    int32_t b32_nrm = (int32_t)((uint32_t)b32 << b_headrm);
    int32_t b32_inv = div32_16(INT32_MAX >> 2, (int16_t)(b32_nrm >> 16));
    int32_t result = (int32_t)((uint32_t)b32_inv << 16);
    int32_t err_q32 = (int32_t)((uint32_t)((1 << 29) - smulwb(b32_nrm, b32_inv)) << 3);
    result = smlaww(result, err_q32, b32_inv);
    int lshift = 61 - b_headrm - qres;
    if (lshift <= 0) return lshift_sat32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static int32_t div32_varq(int32_t a32, int32_t b32, int qres) {
    int a_headrm = clz32i((uint32_t)std::abs(a32)) - 1;
    int32_t a32_nrm = (int32_t)((uint32_t)a32 << a_headrm);
    int b_headrm = clz32i((uint32_t)std::abs(b32)) - 1;
    int32_t b32_nrm = (int32_t)((uint32_t)b32 << b_headrm);
    int32_t b32_inv = div32_16(INT32_MAX >> 2, (int16_t)(b32_nrm >> 16));
    int32_t result = smulwb(a32_nrm, b32_inv);
    a32_nrm = (int32_t)((uint32_t)a32_nrm -
                        ((uint32_t)((int32_t)(((int64_t)b32_nrm * result) >> 32)) << 3));
    result = smlawb(result, a32_nrm, b32_inv);
    int lshift = 29 + a_headrm - b_headrm - qres;
    if (lshift < 0) return lshift_sat32(result, -lshift);
    if (lshift < 32) return result >> lshift;
    return 0;
}

static int32_t silk_log2lin(int32_t in_log_q7) {
    if (in_log_q7 < 0) return 0;
    if (in_log_q7 >= 3967) return INT32_MAX;
    int32_t out = 1 << (in_log_q7 >> 7);
    int32_t frac_q7 = in_log_q7 & 0x7F;
    if (in_log_q7 < 2048) {
        out = (int32_t)((uint32_t)out +
                        (uint32_t)(((int64_t)out *
                                    smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)) >> 7));
    } else {
        out = (int32_t)((uint32_t)out +
                        (uint32_t)((out / 128) *
                                   smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)));
    }
    return out;
}

// ---------------------------------------------------------------------------
// NLSF machinery (opus_tpu/silk/nlsf.py).
// ---------------------------------------------------------------------------

struct NlsfCB {
    int order;
    int n_vectors;
    int quant_step_size_q16;
    const uint8_t* cb1_q8;
    const int16_t* cb1_wght_q9;
    const uint8_t* cb1_icdf;
    const uint8_t* pred_q8;
    const uint8_t* ec_sel;
    const uint8_t* ec_icdf;
    const int16_t* delta_min_q15;
};

static const NlsfCB CB_NB_MB = {
    10, 32, 11796,
    &NLSF_CB1_NB_MB_Q8[0][0], &NLSF_CB1_WGHT_NB_MB_Q9[0][0], NLSF_CB1_ICDF_NB_MB,
    NLSF_PRED_NB_MB_Q8, NLSF_CB2_SELECT_NB_MB, NLSF_CB2_ICDF_NB_MB, NLSF_DELTA_MIN_NB_MB_Q15,
};
static const NlsfCB CB_WB = {
    16, 32, 9830,
    &NLSF_CB1_WB_Q8[0][0], &NLSF_CB1_WGHT_WB_Q9[0][0], NLSF_CB1_ICDF_WB,
    NLSF_PRED_WB_Q8, NLSF_CB2_SELECT_WB, NLSF_CB2_ICDF_WB, NLSF_DELTA_MIN_WB_Q15,
};

constexpr int NLSF_QMA = 4;  // NLSF_QUANT_MAX_AMPLITUDE
constexpr int MAX_LPC_ORDER = 16;
constexpr int LTP_ORDER = 5;

static void nlsf_unpack(const NlsfCB& cb, int cb1, int* ec_ix, int* pred_q8) {
    const uint8_t* sel = &cb.ec_sel[cb1 * cb.order / 2];
    for (int i = 0; i < cb.order; i += 2) {
        int entry = sel[i / 2];
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QMA + 1);
        pred_q8[i] = cb.pred_q8[i + (entry & 1) * (cb.order - 1)];
        ec_ix[i + 1] = ((entry >> 5) & 7) * (2 * NLSF_QMA + 1);
        pred_q8[i + 1] = cb.pred_q8[i + 1 + ((entry >> 4) & 1) * (cb.order - 1)];
    }
}

static void nlsf_stabilize(int* nlsf, const int16_t* dmin, int order) {
    for (int loops = 0; loops < 20; loops++) {
        int min_diff = nlsf[0] - dmin[0];
        int idx = 0;
        for (int i = 1; i < order; i++) {
            int diff = nlsf[i] - (nlsf[i - 1] + dmin[i]);
            if (diff < min_diff) { min_diff = diff; idx = i; }
        }
        int diff = (1 << 15) - (nlsf[order - 1] + dmin[order]);
        if (diff < min_diff) { min_diff = diff; idx = order; }
        if (min_diff >= 0) return;
        if (idx == 0) {
            nlsf[0] = dmin[0];
        } else if (idx == order) {
            nlsf[order - 1] = (1 << 15) - dmin[order];
        } else {
            int min_c = 0;
            for (int k = 0; k < idx; k++) min_c += dmin[k];
            min_c += dmin[idx] >> 1;
            int max_c = 1 << 15;
            for (int k = order; k > idx; k--) max_c -= dmin[k];
            max_c -= dmin[idx] >> 1;
            int center = rshift_round(nlsf[idx - 1] + nlsf[idx], 1);
            center = std::max(min_c, std::min(max_c, center));
            nlsf[idx - 1] = center - (dmin[idx] >> 1);
            nlsf[idx] = nlsf[idx - 1] + dmin[idx];
        }
    }
    std::sort(nlsf, nlsf + order);
    nlsf[0] = std::max(nlsf[0], (int)dmin[0]);
    for (int i = 1; i < order; i++)
        nlsf[i] = std::max(nlsf[i], (int)sat16i(nlsf[i - 1] + dmin[i]));
    nlsf[order - 1] = std::min(nlsf[order - 1], (1 << 15) - dmin[order]);
    for (int i = order - 2; i >= 0; i--)
        nlsf[i] = std::min(nlsf[i], nlsf[i + 1] - dmin[i + 1]);
}

static void nlsf_decode(const int* indices, const NlsfCB& cb, int* nlsf_q15) {
    int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
    nlsf_unpack(cb, indices[0], ec_ix, pred_q8);
    int res_q10[MAX_LPC_ORDER];
    int out_q10 = 0;
    for (int i = cb.order - 1; i >= 0; i--) {
        int pred_q10 = smulbb(out_q10, pred_q8[i]) >> 8;
        out_q10 = (int16_t)(indices[1 + i] << 10);
        if (out_q10 > 0) out_q10 = (int16_t)(out_q10 - 102);
        else if (out_q10 < 0) out_q10 = (int16_t)(out_q10 + 102);
        out_q10 = (int32_t)(pred_q10 + (((int64_t)out_q10 * cb.quant_step_size_q16) >> 16));
        res_q10[i] = out_q10;
    }
    for (int i = 0; i < cb.order; i++) {
        int w = cb.cb1_wght_q9[indices[0] * cb.order + i];
        int base = (int)cb.cb1_q8[indices[0] * cb.order + i] << 7;
        int val = div32_16(res_q10[i] << 14, (int16_t)w) + base;
        nlsf_q15[i] = std::max(0, std::min(32767, val));
    }
    nlsf_stabilize(nlsf_q15, cb.delta_min_q15, cb.order);
}

constexpr int QA16 = 16;
constexpr int QA24 = 24;
constexpr int A_LIMIT_Q24 = 16773022;
constexpr int INV_MAX_PRED_GAIN_Q30 = 107374;
constexpr int ORDERING16[16] = {0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1};
constexpr int ORDERING10[10] = {0, 9, 6, 3, 4, 5, 8, 1, 2, 7};

static void find_poly(const int32_t* c_lsf, int off, int dd, int32_t* out) {
    out[0] = 1 << QA16;
    out[1] = -c_lsf[off];
    for (int k = 1; k < dd; k++) {
        int32_t ftmp = c_lsf[off + 2 * k];
        out[k + 1] = (int32_t)(((uint32_t)out[k - 1] << 1) -
                               (uint32_t)(int32_t)rshift_round64((int64_t)ftmp * out[k], QA16));
        for (int n = k; n > 1; n--)
            out[n] = (int32_t)((uint32_t)out[n] + (uint32_t)out[n - 2] -
                               (uint32_t)(int32_t)rshift_round64((int64_t)ftmp * out[n - 1], QA16));
        out[1] = (int32_t)((uint32_t)out[1] - (uint32_t)ftmp);
    }
}

static void bwexpander_32(int32_t* ar, int d, int32_t chirp_q16) {
    int32_t cm1 = chirp_q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = smulww(chirp_q16, ar[i]);
        chirp_q16 = (int32_t)((uint32_t)chirp_q16 +
                              (uint32_t)rshift_round((int32_t)((int64_t)chirp_q16 * cm1), 16));
    }
    ar[d - 1] = smulww(chirp_q16, ar[d - 1]);
}

static void bwexpander_16(int16_t* ar, int d, int32_t chirp_q16) {
    int32_t cm1 = chirp_q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = (int16_t)rshift_round((int32_t)((int64_t)chirp_q16 * ar[i]), 16);
        chirp_q16 = (int32_t)((uint32_t)chirp_q16 +
                              (uint32_t)rshift_round((int32_t)((int64_t)chirp_q16 * cm1), 16));
    }
    ar[d - 1] = (int16_t)rshift_round((int32_t)((int64_t)chirp_q16 * ar[d - 1]), 16);
}

static inline int32_t smmul(int32_t a, int32_t b) { return (int32_t)(((int64_t)a * b) >> 32); }

static int32_t lpc_inverse_pred_gain(const int16_t* a_q12, int order) {
    int32_t dc = 0;
    for (int k = 0; k < order; k++) dc += a_q12[k];
    if (dc >= 4096) return 0;
    int64_t a_qa[MAX_LPC_ORDER];
    for (int k = 0; k < order; k++) a_qa[k] = (int32_t)((uint32_t)a_q12[k] << (QA24 - 12));
    int32_t inv_gain = 1 << 30;
    for (int k = order - 1; k > 0; k--) {
        if (a_qa[k] > A_LIMIT_Q24 || a_qa[k] < -A_LIMIT_Q24) return 0;
        int32_t rc_q31 = (int32_t)(-((uint32_t)(int32_t)a_qa[k] << (31 - QA24)));
        int32_t rc_mult1 = (int32_t)((1 << 30) - smmul(rc_q31, rc_q31));
        inv_gain = (int32_t)((uint32_t)smmul(inv_gain, rc_mult1) << 2);
        if (inv_gain < INV_MAX_PRED_GAIN_Q30) return 0;
        int mult2q = 32 - clz32i((uint32_t)std::abs(rc_mult1));
        int32_t rc_mult2 = inverse32_varq(rc_mult1, mult2q + 30);
        for (int n = 0; n < (k + 1) >> 1; n++) {
            int64_t tmp1 = a_qa[n];
            int64_t tmp2 = a_qa[k - n - 1];
            int64_t t64 = rshift_round64(
                (tmp1 - (int32_t)rshift_round64(tmp2 * rc_q31, 31)) * (int64_t)rc_mult2, mult2q);
            if (t64 > INT32_MAX || t64 < INT32_MIN) return 0;
            a_qa[n] = t64;
            t64 = rshift_round64(
                (tmp2 - (int32_t)rshift_round64(tmp1 * rc_q31, 31)) * (int64_t)rc_mult2, mult2q);
            if (t64 > INT32_MAX || t64 < INT32_MIN) return 0;
            a_qa[k - n - 1] = t64;
        }
    }
    if (a_qa[0] > A_LIMIT_Q24 || a_qa[0] < -A_LIMIT_Q24) return 0;
    int32_t rc_q31 = (int32_t)(-((uint32_t)(int32_t)a_qa[0] << (31 - QA24)));
    int32_t rc_mult1 = (int32_t)((1 << 30) - smmul(rc_q31, rc_q31));
    inv_gain = (int32_t)((uint32_t)smmul(inv_gain, rc_mult1) << 2);
    if (inv_gain < INV_MAX_PRED_GAIN_Q30) return 0;
    return inv_gain;
}

static void lpc_fit(int32_t* a_qin, int16_t* a_qout, int qout, int qin, int d) {
    int i;
    for (i = 0; i < 10; i++) {
        int32_t maxabs = 0;
        int idx = 0;
        for (int k = 0; k < d; k++) {
            int32_t absval = std::abs(a_qin[k]);
            if (absval > maxabs) { maxabs = absval; idx = k; }
        }
        maxabs = rshift_round(maxabs, qin - qout);
        if (maxabs > 32767) {
            maxabs = std::min(maxabs, 163838);
            int32_t denom = (int32_t)(((int64_t)maxabs * (idx + 1))) >> 2;
            int32_t chirp = 65470 - ((int32_t)((uint32_t)(maxabs - 32767) << 14)) / denom;
            bwexpander_32(a_qin, d, chirp);
        } else {
            break;
        }
    }
    if (i == 10) {
        for (int k = 0; k < d; k++) {
            a_qout[k] = (int16_t)sat16i(rshift_round(a_qin[k], qin - qout));
            a_qin[k] = (int32_t)((uint32_t)a_qout[k] << (qin - qout));
        }
    } else {
        for (int k = 0; k < d; k++)
            a_qout[k] = (int16_t)rshift_round(a_qin[k], qin - qout);
    }
}

static void nlsf2a(const int* nlsf_q15, int d, int16_t* a_q12) {
    const int* ordering = d == 16 ? ORDERING16 : ORDERING10;
    int32_t c_lsf[MAX_LPC_ORDER];
    for (int k = 0; k < d; k++) {
        int f_int = nlsf_q15[k] >> 8;
        int f_frac = nlsf_q15[k] - (f_int << 8);
        int cos_val = LSF_COS_TAB_Q12[f_int];
        int delta = LSF_COS_TAB_Q12[f_int + 1] - cos_val;
        c_lsf[ordering[k]] = rshift_round((cos_val << 8) + delta * f_frac, 20 - QA16);
    }
    int dd = d >> 1;
    int32_t p[MAX_LPC_ORDER / 2 + 1], q[MAX_LPC_ORDER / 2 + 1];
    find_poly(c_lsf, 0, dd, p);
    find_poly(c_lsf, 1, dd, q);
    int32_t a32[MAX_LPC_ORDER];
    for (int k = 0; k < dd; k++) {
        int32_t ptmp = (int32_t)((uint32_t)p[k + 1] + (uint32_t)p[k]);
        int32_t qtmp = (int32_t)((uint32_t)q[k + 1] - (uint32_t)q[k]);
        a32[k] = (int32_t)(-(uint32_t)qtmp - (uint32_t)ptmp);
        a32[d - k - 1] = (int32_t)((uint32_t)qtmp - (uint32_t)ptmp);
    }
    lpc_fit(a32, a_q12, 12, QA16 + 1, d);
    for (int it = 0; lpc_inverse_pred_gain(a_q12, d) == 0 && it < 16; it++) {
        bwexpander_32(a32, d, 65536 - (2 << it));
        for (int k = 0; k < d; k++)
            a_q12[k] = (int16_t)rshift_round(a32[k], QA16 + 1 - 12);
    }
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// Bitstream front end (opus_tpu/silk/bitstream.py).
// ---------------------------------------------------------------------------

struct SideInfo {
    int signal_type = 0;
    int quant_offset_type = 0;
    int gains_indices[4] = {0};
    int nlsf_indices[17] = {0};
    int nlsf_interp_q2 = 4;
    int lag_index = 0;
    int contour_index = 0;
    int per_index = 0;
    int ltp_index[4] = {0};
    int ltp_scale_index = 0;
    int seed = 0;
};

// PLC state (opus_tpu/silk/plc.py PlcState; silk/PLC.c semantics).
struct PlcC {
    int32_t pitch_l_q8 = 0;
    int32_t ltp_coef_q14[LTP_ORDER] = {0};
    int16_t prev_lpc_q12[MAX_LPC_ORDER] = {0};
    int last_frame_lost = 0;
    int32_t rand_seed = 0;
    int32_t rand_scale_q14 = 1 << 14;
    int32_t conc_energy = 0;
    int conc_energy_shift = 0;
    int32_t prev_ltp_scale_q14 = 0;
    int32_t prev_gain_q16[2] = {1 << 16, 1 << 16};
    int fs_khz = 0;
    int nb_subfr = 2;
    int subfr_length = 20;
};

struct SilkState {
    int fs_khz = 0;   // 0 = unset; set_fs(16) runs at create time
    int nb_subfr = 4; // caller sets before set_fs (silk_decoder_set_fs contract)
    int frame_length = 0;
    int subfr_length = 0;
    int ltp_mem_length = 320;
    int lpc_order = 16;
    const NlsfCB* cb = &CB_WB;
    const uint8_t* lag_low_icdf = UNIFORM8_ICDF;
    const uint8_t* contour_icdf = PITCH_CONTOUR_ICDF;
    int prev_nlsf_q15[MAX_LPC_ORDER] = {0};
    int ec_prev_signal_type = 0;
    int ec_prev_lag_index = 0;
    int last_gain_index = 10;
    int32_t prev_gain_q16 = 1 << 16;
    int first_frame_after_reset = 1;
    int prev_signal_type = 0;
    int lag_prev = 100;
    int loss_cnt = 0;
    int16_t out_buf[20 * 16 + 2 * 5 * 16] = {0};
    int32_t s_lpc_q14[MAX_LPC_ORDER] = {0};
    std::vector<int32_t> exc_q14;
    int vad_flag = 1;
    // PLC + CNG state (plc.py).
    PlcC plc;
    bool plc_init = false;
    int cng_fs_khz = 0;
    int32_t cng_exc_buf_q14[4 * 5 * 16] = {0};
    int cng_smth_nlsf_q15[MAX_LPC_ORDER] = {0};
    int32_t cng_smth_gain_q16 = 0;
    int32_t cng_rand_seed = 3176576;
    int32_t cng_synth_state[MAX_LPC_ORDER] = {0};
    // Packet-level flags (driver path).
    int vad_flags[3] = {0, 0, 0};
    int lbrr_flag = 0;
    int lbrr_flags[3] = {0, 0, 0};
    int n_frames_per_packet = 0;
    int n_frames_decoded = 0;

    void reset_decoder_state() {
        first_frame_after_reset = 1;
        lag_prev = 100;
        last_gain_index = 10;
        prev_signal_type = 0;
        std::memset(out_buf, 0, sizeof(out_buf));
        std::memset(s_lpc_q14, 0, sizeof(s_lpc_q14));
        std::memset(prev_nlsf_q15, 0, sizeof(prev_nlsf_q15));
    }

    void set_fs(int fs) {
        // silk_decoder_set_fs: nb_subfr is set by the caller beforehand.
        subfr_length = 5 * fs;
        int new_frame_length = nb_subfr * subfr_length;
        if (fs_khz != fs || new_frame_length != frame_length) {
            if (fs == 8)
                contour_icdf = nb_subfr == 4 ? PITCH_CONTOUR_NB_ICDF : PITCH_CONTOUR_10MS_NB_ICDF;
            else
                contour_icdf = nb_subfr == 4 ? PITCH_CONTOUR_ICDF : PITCH_CONTOUR_10MS_ICDF;
            if (fs_khz != fs) {
                ltp_mem_length = 20 * fs;
                if (fs == 16) {
                    lpc_order = 16; cb = &CB_WB; lag_low_icdf = UNIFORM8_ICDF;
                } else if (fs == 12) {
                    lpc_order = 10; cb = &CB_NB_MB; lag_low_icdf = UNIFORM6_ICDF;
                } else {
                    lpc_order = 10; cb = &CB_NB_MB; lag_low_icdf = UNIFORM4_ICDF;
                }
                reset_decoder_state();
            }
            fs_khz = fs;
            frame_length = new_frame_length;
        }
    }
};

static const uint8_t* LTP_GAIN_ICDFS[3] = {LTP_GAIN_ICDF_0, LTP_GAIN_ICDF_1, LTP_GAIN_ICDF_2};
static const int8_t* LTP_VQS[3] = {&LTP_GAIN_VQ_0[0][0], &LTP_GAIN_VQ_1[0][0], &LTP_GAIN_VQ_2[0][0]};

// Inter-frame conditional-coding modes (silk/bitstream.py).
constexpr int CODE_INDEP = 0;
constexpr int CODE_COND = 1;
constexpr int CODE_INDEP_NO_LTP = 2;

static void decode_indices(RangeDec& dec, SilkState& st, SideInfo& ind, bool vad, int cond) {
    int ix;
    if (vad) ix = dec.decode_icdf(TYPE_OFFSET_VAD_ICDF, 8) + 2;
    else ix = dec.decode_icdf(TYPE_OFFSET_NO_VAD_ICDF, 8);
    ind.signal_type = ix >> 1;
    ind.quant_offset_type = ix & 1;

    if (cond == CODE_COND) {
        ind.gains_indices[0] = dec.decode_icdf(DELTA_GAIN_ICDF, 8);
    } else {
        ind.gains_indices[0] = dec.decode_icdf(GAIN_ICDF[ind.signal_type], 8) << 3;
        ind.gains_indices[0] += dec.decode_icdf(UNIFORM8_ICDF, 8);
    }
    for (int i = 1; i < st.nb_subfr; i++)
        ind.gains_indices[i] = dec.decode_icdf(DELTA_GAIN_ICDF, 8);

    const NlsfCB& cb = *st.cb;
    ind.nlsf_indices[0] =
        dec.decode_icdf(&cb.cb1_icdf[(ind.signal_type >> 1) * cb.n_vectors], 8);
    int ec_ix[MAX_LPC_ORDER], pred_q8[MAX_LPC_ORDER];
    nlsf_unpack(cb, ind.nlsf_indices[0], ec_ix, pred_q8);
    for (int i = 0; i < cb.order; i++) {
        int v = dec.decode_icdf(&cb.ec_icdf[ec_ix[i]], 8);
        if (v == 0) v -= dec.decode_icdf(NLSF_EXT_ICDF, 8);
        else if (v == 2 * NLSF_QMA) v += dec.decode_icdf(NLSF_EXT_ICDF, 8);
        ind.nlsf_indices[i + 1] = v - NLSF_QMA;
    }
    if (st.nb_subfr == 4) ind.nlsf_interp_q2 = dec.decode_icdf(NLSF_INTERP_FACTOR_ICDF, 8);
    else ind.nlsf_interp_q2 = 4;

    if (ind.signal_type == 2) {
        bool decode_absolute = true;
        if (cond == CODE_COND && st.ec_prev_signal_type == 2) {
            int delta = dec.decode_icdf(PITCH_DELTA_ICDF, 8);
            if (delta > 0) {
                ind.lag_index = st.ec_prev_lag_index + (delta - 9);
                decode_absolute = false;
            }
        }
        if (decode_absolute) {
            ind.lag_index = dec.decode_icdf(PITCH_LAG_ICDF, 8) * (st.fs_khz >> 1);
            ind.lag_index += dec.decode_icdf(st.lag_low_icdf, 8);
        }
        st.ec_prev_lag_index = ind.lag_index;
        ind.contour_index = dec.decode_icdf(st.contour_icdf, 8);
        ind.per_index = dec.decode_icdf(LTP_PER_INDEX_ICDF, 8);
        for (int k = 0; k < st.nb_subfr; k++)
            ind.ltp_index[k] = dec.decode_icdf(LTP_GAIN_ICDFS[ind.per_index], 8);
        ind.ltp_scale_index = cond == CODE_INDEP ? dec.decode_icdf(LTPSCALE_ICDF, 8) : 0;
    }
    st.ec_prev_signal_type = ind.signal_type;
    ind.seed = dec.decode_icdf(UNIFORM4_ICDF, 8);
}

static void decode_split(RangeDec& dec, int p, const uint8_t* table, int* c1, int* c2) {
    if (p > 0) {
        int off = SHELL_CODE_TABLE_OFFSETS[p];
        *c1 = dec.decode_icdf(&table[off], 8);
        *c2 = p - *c1;
    } else {
        *c1 = *c2 = 0;
    }
}

static void shell_decoder(RangeDec& dec, int pulses4, int* out) {
    int p3[2], p2[4], p1[8];
    decode_split(dec, pulses4, SHELL_CODE_TABLE3, &p3[0], &p3[1]);
    for (int h = 0; h < 2; h++) {
        decode_split(dec, p3[h], SHELL_CODE_TABLE2, &p2[2 * h], &p2[2 * h + 1]);
        for (int q = 0; q < 2; q++) {
            int e = 2 * h + q;
            decode_split(dec, p2[e], SHELL_CODE_TABLE1, &p1[2 * e], &p1[2 * e + 1]);
            for (int b = 0; b < 2; b++) {
                int leaf = 2 * e + b;
                decode_split(dec, p1[leaf], SHELL_CODE_TABLE0, &out[2 * leaf], &out[2 * leaf + 1]);
            }
        }
    }
}

static void decode_pulses(RangeDec& dec, int signal_type, int quant_offset_type,
                          int frame_length, int* pulses) {
    int rate_level = dec.decode_icdf(RATE_LEVELS_ICDF[signal_type >> 1], 8);
    int n_blocks = frame_length >> 4;
    if (n_blocks * 16 < frame_length) n_blocks++;

    int sums[24], nls[24];
    for (int i = 0; i < n_blocks; i++) {
        nls[i] = 0;
        sums[i] = dec.decode_icdf(PULSES_PER_BLOCK_ICDF[rate_level], 8);
        while (sums[i] == 17) {
            nls[i]++;
            const uint8_t* row = PULSES_PER_BLOCK_ICDF[9];
            sums[i] = dec.decode_icdf(nls[i] == 10 ? row + 1 : row, 8);
        }
    }
    std::memset(pulses, 0, n_blocks * 16 * sizeof(int));
    for (int i = 0; i < n_blocks; i++)
        if (sums[i] > 0) shell_decoder(dec, sums[i], &pulses[i * 16]);
    for (int i = 0; i < n_blocks; i++) {
        if (nls[i] > 0) {
            for (int k = 0; k < 16; k++) {
                int q = pulses[i * 16 + k];
                for (int j = 0; j < nls[i]; j++)
                    q = (q << 1) + dec.decode_icdf(LSB_ICDF, 8);
                pulses[i * 16 + k] = q;
            }
            sums[i] |= nls[i] << 5;
        }
    }
    int base = 7 * (quant_offset_type + (signal_type << 1));
    for (int i = 0; i < n_blocks; i++) {
        int p = sums[i];
        if (p > 0) {
            uint8_t icdf[2] = {SIGN_ICDF[base + std::min(p & 0x1F, 6)], 0};
            for (int j = 0; j < 16; j++)
                if (pulses[i * 16 + j] > 0)
                    pulses[i * 16 + j] *= 2 * dec.decode_icdf(icdf, 8) - 1;
        }
    }
}

// ---------------------------------------------------------------------------
// Parameters + core synthesis (opus_tpu/silk/decoder.py).
// ---------------------------------------------------------------------------

struct Control {
    int pitch_l[4] = {0};
    int32_t gains_q16[4] = {0};
    int16_t pred_coef_q12[2][MAX_LPC_ORDER] = {{0}};
    int32_t ltp_coef_q14[4 * LTP_ORDER] = {0};
    int32_t ltp_scale_q14 = 0;
};

static void gains_dequant(const int* idx, int* prev_ind, bool conditional, int nb,
                          int32_t* gains_q16) {
    int pi = *prev_ind;
    for (int k = 0; k < nb; k++) {
        if (k == 0 && !conditional) {
            pi = std::max(idx[k], pi - 16);
        } else {
            int ind_tmp = idx[k] - 4;
            int thresh = 2 * 36 - 64 + pi;
            if (ind_tmp > thresh) pi += (ind_tmp << 1) - thresh;
            else pi += ind_tmp;
        }
        pi = std::max(0, std::min(63, pi));
        gains_q16[k] = silk_log2lin(std::min(smulwb(1907825, pi) + 2090, 3967));
    }
    *prev_ind = pi;
}

static void decode_pitch(int lag_index, int contour, int fs_khz, int nb_subfr, int* pitch_l) {
    const int8_t* cb;
    int stride;
    if (fs_khz == 8) {
        if (nb_subfr == 4) { cb = &CB_LAGS_STAGE2[0][0]; stride = 11; }
        else { cb = &CB_LAGS_STAGE2_10MS[0][0]; stride = 3; }
    } else if (nb_subfr == 4) { cb = &CB_LAGS_STAGE3[0][0]; stride = 34; }
    else { cb = &CB_LAGS_STAGE3_10MS[0][0]; stride = 12; }
    int min_lag = 2 * fs_khz, max_lag = 18 * fs_khz;
    int lag = min_lag + lag_index;
    for (int k = 0; k < nb_subfr; k++)
        pitch_l[k] = std::max(min_lag, std::min(max_lag, lag + cb[k * stride + contour]));
}

static void decode_parameters(SilkState& st, SideInfo& ind, Control& ctrl, int cond = CODE_INDEP) {
    gains_dequant(ind.gains_indices, &st.last_gain_index, cond == CODE_COND, st.nb_subfr,
                  ctrl.gains_q16);
    int nlsf_q15[MAX_LPC_ORDER];
    nlsf_decode(ind.nlsf_indices, *st.cb, nlsf_q15);
    nlsf2a(nlsf_q15, st.lpc_order, ctrl.pred_coef_q12[1]);
    if (st.first_frame_after_reset) ind.nlsf_interp_q2 = 4;
    if (ind.nlsf_interp_q2 < 4) {
        int nlsf0[MAX_LPC_ORDER];
        for (int i = 0; i < st.lpc_order; i++)
            nlsf0[i] = st.prev_nlsf_q15[i] +
                       ((ind.nlsf_interp_q2 * (nlsf_q15[i] - st.prev_nlsf_q15[i])) >> 2);
        nlsf2a(nlsf0, st.lpc_order, ctrl.pred_coef_q12[0]);
    } else {
        std::memcpy(ctrl.pred_coef_q12[0], ctrl.pred_coef_q12[1],
                    st.lpc_order * sizeof(int16_t));
    }
    std::memcpy(st.prev_nlsf_q15, nlsf_q15, st.lpc_order * sizeof(int));
    if (st.loss_cnt) {
        for (int h = 0; h < 2; h++)
            bwexpander_16(ctrl.pred_coef_q12[h], st.lpc_order, 63570);
    }
    if (ind.signal_type == 2) {
        decode_pitch(ind.lag_index, ind.contour_index, st.fs_khz, st.nb_subfr, ctrl.pitch_l);
        const int8_t* vq = LTP_VQS[ind.per_index];
        for (int k = 0; k < st.nb_subfr; k++)
            for (int i = 0; i < LTP_ORDER; i++)
                ctrl.ltp_coef_q14[k * LTP_ORDER + i] =
                    (int32_t)((int)vq[ind.ltp_index[k] * LTP_ORDER + i] << 7);
        ctrl.ltp_scale_q14 = LTP_SCALES_TABLE_Q14[ind.ltp_scale_index];
    } else {
        std::memset(ctrl.pitch_l, 0, sizeof(ctrl.pitch_l));
        std::memset(ctrl.ltp_coef_q14, 0, sizeof(ctrl.ltp_coef_q14));
        ctrl.ltp_scale_q14 = 0;
    }
}

static void lpc_analysis_filter(int16_t* out, int out_off, const int16_t* in, int in_off,
                                const int16_t* b_q12, int len, int order) {
    for (int ix = order; ix < len; ix++) {
        int in_ptr = in_off + ix - 1;
        int32_t acc = smulbb(in[in_ptr], b_q12[0]);
        for (int j = 1; j < order; j++)
            acc = (int32_t)((uint32_t)acc + (uint32_t)smulbb(in[in_ptr - j], b_q12[j]));
        acc = (int32_t)(((uint32_t)in[in_ptr + 1] << 12) - (uint32_t)acc);
        out[out_off + ix] = (int16_t)sat16i(rshift_round(acc, 12));
    }
    std::memset(&out[out_off], 0, order * sizeof(int16_t));
}

static void decode_core(SilkState& st, Control& ctrl, SideInfo& ind, const int* pulses,
                        int16_t* xq) {
    int order = st.lpc_order;
    int L = st.frame_length;
    int sub = st.subfr_length;
    int offset_q10 = QUANTIZATION_OFFSETS_Q10[ind.signal_type >> 1][ind.quant_offset_type];
    int interp_flag = ind.nlsf_interp_q2 < 4 ? 1 : 0;

    st.exc_q14.resize(L);
    int32_t rand_seed = ind.seed;
    for (int i = 0; i < L; i++) {
        rand_seed = silk_rand(rand_seed);
        int32_t v = pulses[i] << 14;
        if (v > 0) v -= 80 << 4;
        else if (v < 0) v += 80 << 4;
        v += offset_q10 << 4;
        if (rand_seed < 0) v = -v;
        st.exc_q14[i] = v;
        rand_seed = (int32_t)((uint32_t)rand_seed + (uint32_t)pulses[i]);
    }

    std::vector<int16_t> s_ltp(st.ltp_mem_length, 0);
    std::vector<int32_t> s_ltp_q15(st.ltp_mem_length + L, 0);
    std::vector<int32_t> s_lpc(MAX_LPC_ORDER + sub);
    std::memcpy(s_lpc.data(), st.s_lpc_q14, MAX_LPC_ORDER * sizeof(int32_t));
    int s_ltp_buf_idx = st.ltp_mem_length;
    int lag = 0;

    for (int k = 0; k < st.nb_subfr; k++) {
        const int32_t* pexc = &st.exc_q14[k * sub];
        const int16_t* a_q12 = ctrl.pred_coef_q12[k >> 1];
        const int32_t* b_q14 = &ctrl.ltp_coef_q14[k * LTP_ORDER];
        int signal_type = ind.signal_type;
        int32_t gain_q10 = ctrl.gains_q16[k] >> 6;
        int32_t inv_gain_q31 = inverse32_varq(ctrl.gains_q16[k], 47);
        int32_t gain_adj_q16 = 1 << 16;
        if (ctrl.gains_q16[k] != st.prev_gain_q16) {
            gain_adj_q16 = div32_varq(st.prev_gain_q16, ctrl.gains_q16[k], 16);
            for (int i = 0; i < MAX_LPC_ORDER; i++)
                s_lpc[i] = smulww(gain_adj_q16, s_lpc[i]);
        }
        st.prev_gain_q16 = ctrl.gains_q16[k];

        // Avoid an abrupt transition from voiced PLC to unvoiced normal
        // decoding (decoder.py:307; silk_decode_core lossCnt path).
        static const int32_t plc_fade_b_q14[LTP_ORDER] = {0, 0, 4096, 0, 0};
        if (st.loss_cnt && st.prev_signal_type == 2 && ind.signal_type != 2 &&
            k < 4 / 2) {
            b_q14 = plc_fade_b_q14;
            signal_type = 2;
            ctrl.pitch_l[k] = st.lag_prev;
        }

        if (signal_type == 2) {
            lag = ctrl.pitch_l[k];
            if (k == 0 || (k == 2 && interp_flag)) {
                int start_idx = st.ltp_mem_length - lag - order - LTP_ORDER / 2;
                if (start_idx <= 0) start_idx = 1;
                if (k == 2)
                    std::memcpy(&st.out_buf[st.ltp_mem_length], xq, 2 * sub * sizeof(int16_t));
                lpc_analysis_filter(s_ltp.data(), start_idx, st.out_buf,
                                    start_idx + k * sub, a_q12,
                                    st.ltp_mem_length - start_idx, order);
                int32_t ig = inv_gain_q31;
                if (k == 0)
                    ig = (int32_t)((uint32_t)smulwb(inv_gain_q31, ctrl.ltp_scale_q14) << 2);
                for (int i = 0; i < lag + LTP_ORDER / 2; i++)
                    s_ltp_q15[s_ltp_buf_idx - i - 1] =
                        smulwb(ig, s_ltp[st.ltp_mem_length - i - 1]);
                if (k == 0) inv_gain_q31 = ig;
            } else if (gain_adj_q16 != 1 << 16) {
                for (int i = 0; i < lag + LTP_ORDER / 2; i++)
                    s_ltp_q15[s_ltp_buf_idx - i - 1] =
                        smulww(gain_adj_q16, s_ltp_q15[s_ltp_buf_idx - i - 1]);
            }
        }

        std::vector<int32_t> pres_buf;
        const int32_t* pres;
        if (signal_type == 2) {
            pres_buf.resize(sub);
            int pred_lag = s_ltp_buf_idx - lag + LTP_ORDER / 2;
            for (int i = 0; i < sub; i++) {
                int32_t lp = 2;
                lp = smlawb(lp, s_ltp_q15[pred_lag + 0], b_q14[0]);
                lp = smlawb(lp, s_ltp_q15[pred_lag - 1], b_q14[1]);
                lp = smlawb(lp, s_ltp_q15[pred_lag - 2], b_q14[2]);
                lp = smlawb(lp, s_ltp_q15[pred_lag - 3], b_q14[3]);
                lp = smlawb(lp, s_ltp_q15[pred_lag - 4], b_q14[4]);
                pred_lag++;
                pres_buf[i] = (int32_t)((uint32_t)pexc[i] + ((uint32_t)lp << 1));
                s_ltp_q15[s_ltp_buf_idx] = (int32_t)((uint32_t)pres_buf[i] << 1);
                s_ltp_buf_idx++;
            }
            pres = pres_buf.data();
        } else {
            pres = pexc;
        }

        for (int i = 0; i < sub; i++) {
            int32_t lpc_pred = order >> 1;
            for (int j = 0; j < order; j++)
                lpc_pred = smlawb(lpc_pred, s_lpc[MAX_LPC_ORDER + i - 1 - j], a_q12[j]);
            s_lpc[MAX_LPC_ORDER + i] = add_sat32i(pres[i], lshift_sat32(lpc_pred, 4));
            xq[k * sub + i] =
                (int16_t)sat16i(rshift_round(smulww(s_lpc[MAX_LPC_ORDER + i], gain_q10), 8));
        }
        std::memmove(s_lpc.data(), &s_lpc[sub], MAX_LPC_ORDER * sizeof(int32_t));
    }
    std::memcpy(st.s_lpc_q14, s_lpc.data(), MAX_LPC_ORDER * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// PLC + CNG (opus_tpu/silk/plc.py; silk/PLC.c + silk/CNG.c semantics; fills
// the /root/reference/src/silk/decoder.rs stub's loss path for plane A).
// ---------------------------------------------------------------------------

constexpr int PLC_NB_ATT = 2;
constexpr int32_t HARM_ATT_Q15[PLC_NB_ATT] = {32440, 31130};
constexpr int32_t PLC_RAND_ATTENUATE_V_Q15[PLC_NB_ATT] = {31130, 26214};
constexpr int32_t PLC_RAND_ATTENUATE_UV_Q15[PLC_NB_ATT] = {32440, 29491};
constexpr int32_t V_PITCH_GAIN_START_MIN_Q14 = 11469;
constexpr int32_t V_PITCH_GAIN_START_MAX_Q14 = 15565;
constexpr int32_t PLC_BWE_COEF_Q16 = 64881;
constexpr int32_t PITCH_DRIFT_FAC_Q16 = 655;
constexpr int RAND_BUF_SIZE = 128;
constexpr int RAND_BUF_MASK = RAND_BUF_SIZE - 1;
constexpr int MAX_PITCH_LAG_MS = 18;
constexpr int CNG_BUF_MASK_MAX = 255;
constexpr int32_t CNG_GAIN_SMTH_Q16 = 4634;
constexpr int32_t CNG_NLSF_SMTH_Q16 = 16348;

// silk_sum_sqr_shift (plc.py sum_sqr_shift): two-pass wrap-faithful.
static void sum_sqr_shift(const int16_t* x, int len, int32_t* nrg_out, int* shift_out) {
    int shft = 31 - clz32i((uint32_t)len);
    uint32_t nrg = 0;
    for (int pass = 0; pass < 2; pass++) {
        nrg = pass == 0 ? (uint32_t)len : 0u;
        int i = 0;
        for (; i < len - 1; i += 2) {
            uint32_t t = (uint32_t)((int32_t)x[i] * x[i]) + (uint32_t)((int32_t)x[i + 1] * x[i + 1]);
            nrg += t >> shft;
        }
        if (i < len) nrg += (uint32_t)((int32_t)x[i] * x[i]) >> shft;
        if (pass == 0) shft = std::max(0, shft + 3 - clz32i(nrg));
    }
    *nrg_out = (int32_t)nrg;
    *shift_out = shft;
}

static int32_t sqrt_approx(int32_t x) {
    if (x <= 0) return 0;
    int lz = clz32i((uint32_t)x);
    int32_t frac_q7 = lz < 32 ? (int32_t)((((uint32_t)x << lz) >> 24) & 0x7F) : 0;
    int32_t y = (lz & 1) ? 32768 : 46214;
    y >>= (lz >> 1);
    return smlawb(y, y, smulbb(213, frac_q7));
}

static PlcC& ensure_plc(SilkState& st) {
    if (!st.plc_init || st.plc.fs_khz != st.fs_khz) {
        st.plc = PlcC();
        st.plc.pitch_l_q8 = st.frame_length << 7;
        st.plc.fs_khz = st.fs_khz;
        st.plc_init = true;
    }
    return st.plc;
}

// silk_PLC_update: remember the last good frame's parameters.
static void plc_save(SilkState& st, const Control& ctrl, const SideInfo& ind) {
    PlcC& plc = ensure_plc(st);
    int32_t ltp_gain_q14 = 0;
    if (ind.signal_type == 2) {
        int j = 0;
        while (j * st.subfr_length < ctrl.pitch_l[st.nb_subfr - 1]) {
            if (j == st.nb_subfr) break;
            int32_t temp = 0;
            for (int i = 0; i < LTP_ORDER; i++)
                temp += ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER + i];
            if (temp > ltp_gain_q14) {
                ltp_gain_q14 = temp;
                for (int i = 0; i < LTP_ORDER; i++)
                    plc.ltp_coef_q14[i] = ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER + i];
                plc.pitch_l_q8 = ctrl.pitch_l[st.nb_subfr - 1 - j] << 8;
            }
            j++;
        }
        std::memset(plc.ltp_coef_q14, 0, sizeof(plc.ltp_coef_q14));
        plc.ltp_coef_q14[LTP_ORDER / 2] = ltp_gain_q14;
        if (ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14) {
            int32_t scale_q10 = (V_PITCH_GAIN_START_MIN_Q14 << 10) / std::max(ltp_gain_q14, 1);
            for (int i = 0; i < LTP_ORDER; i++)
                plc.ltp_coef_q14[i] = smulbb(plc.ltp_coef_q14[i], scale_q10) >> 10;
        } else if (ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14) {
            int32_t scale_q14 = (V_PITCH_GAIN_START_MAX_Q14 << 14) / ltp_gain_q14;
            for (int i = 0; i < LTP_ORDER; i++)
                plc.ltp_coef_q14[i] = smulbb(plc.ltp_coef_q14[i], scale_q14) >> 14;
        }
    } else {
        plc.pitch_l_q8 = (st.fs_khz * 18) << 8;
        std::memset(plc.ltp_coef_q14, 0, sizeof(plc.ltp_coef_q14));
    }
    for (int i = 0; i < st.lpc_order; i++) plc.prev_lpc_q12[i] = ctrl.pred_coef_q12[1][i];
    for (int i = st.lpc_order; i < MAX_LPC_ORDER; i++) plc.prev_lpc_q12[i] = 0;
    plc.prev_ltp_scale_q14 = ctrl.ltp_scale_q14;
    plc.prev_gain_q16[0] = ctrl.gains_q16[st.nb_subfr - 2];
    plc.prev_gain_q16[1] = ctrl.gains_q16[st.nb_subfr - 1];
    plc.subfr_length = st.subfr_length;
    plc.nb_subfr = st.nb_subfr;
}

// silk_PLC_conceal: extrapolate one frame from the saved parameters.
static void plc_conceal(SilkState& st, int16_t* frame) {
    PlcC& plc = ensure_plc(st);
    int L = st.frame_length, order = st.lpc_order;
    int32_t prev_gain_q10[2] = {plc.prev_gain_q16[0] >> 6, plc.prev_gain_q16[1] >> 6};
    if (st.first_frame_after_reset) std::memset(plc.prev_lpc_q12, 0, sizeof(plc.prev_lpc_q12));

    // Energy of the last two excitation subframes -> noise source choice.
    int exc_len = (int)st.exc_q14.size();
    int16_t ebuf[2][5 * 16];
    for (int k = 0; k < 2; k++) {
        int base = (k + st.nb_subfr - 2) * st.subfr_length;
        for (int i = 0; i < st.subfr_length; i++) {
            int32_t e = (base + i < exc_len) ? st.exc_q14[base + i] : 0;
            ebuf[k][i] = (int16_t)sat16i(smulww(e, prev_gain_q10[k]) >> 8);
        }
    }
    int32_t e1, e2;
    int s1, s2;
    sum_sqr_shift(ebuf[0], st.subfr_length, &e1, &s1);
    sum_sqr_shift(ebuf[1], st.subfr_length, &e2, &s2);
    int rand_base;
    if ((e1 >> s2) < (e2 >> s1))
        rand_base = std::max(0, (plc.nb_subfr - 1) * plc.subfr_length - RAND_BUF_SIZE);
    else
        rand_base = std::max(0, plc.nb_subfr * plc.subfr_length - RAND_BUF_SIZE);
    int32_t rand_ptr[RAND_BUF_SIZE];
    for (int i = 0; i < RAND_BUF_SIZE; i++)
        rand_ptr[i] = (rand_base + i < exc_len) ? st.exc_q14[rand_base + i] : 0;

    int32_t* b_q14 = plc.ltp_coef_q14;  // aliased: decay persists in PLC state
    int32_t rand_scale_q14 = plc.rand_scale_q14;
    int32_t harm_gain_q15 = HARM_ATT_Q15[std::min(PLC_NB_ATT - 1, st.loss_cnt)];
    int32_t rand_gain_q15 = st.prev_signal_type == 2
                                ? PLC_RAND_ATTENUATE_V_Q15[std::min(PLC_NB_ATT - 1, st.loss_cnt)]
                                : PLC_RAND_ATTENUATE_UV_Q15[std::min(PLC_NB_ATT - 1, st.loss_cnt)];

    bwexpander_16(plc.prev_lpc_q12, order, PLC_BWE_COEF_Q16);
    int16_t a_q12[MAX_LPC_ORDER] = {0};
    std::memcpy(a_q12, plc.prev_lpc_q12, order * sizeof(int16_t));

    if (st.loss_cnt == 0) {
        rand_scale_q14 = 1 << 14;
        if (st.prev_signal_type == 2) {
            for (int i = 0; i < LTP_ORDER; i++) rand_scale_q14 -= b_q14[i];
            rand_scale_q14 = std::max(3277, rand_scale_q14);
            rand_scale_q14 = (int32_t)(int16_t)(smulbb(rand_scale_q14, plc.prev_ltp_scale_q14) >> 14);
        } else {
            int32_t inv_gain_q30 = lpc_inverse_pred_gain(a_q12, order);
            int32_t down_scale_q30 = std::min((int32_t)((1 << 30) >> 3), inv_gain_q30);
            down_scale_q30 = std::max((int32_t)((1 << 30) >> 8), down_scale_q30);
            down_scale_q30 = (int32_t)((uint32_t)down_scale_q30 << 3);
            rand_gain_q15 = smulwb(down_scale_q30, rand_gain_q15) >> 14;
        }
    }

    int32_t rand_seed = plc.rand_seed;
    int lag = rshift_round(plc.pitch_l_q8, 8);
    int s_ltp_buf_idx = st.ltp_mem_length;
    std::vector<int16_t> s_ltp(st.ltp_mem_length, 0);
    std::vector<int32_t> s_ltp_q14(st.ltp_mem_length + L, 0);
    int idx = st.ltp_mem_length - lag - order - LTP_ORDER / 2;
    if (idx <= 0) idx = 1;
    lpc_analysis_filter(s_ltp.data(), idx, st.out_buf, idx, a_q12, st.ltp_mem_length - idx, order);
    int32_t inv_gain_q30 = inverse32_varq(plc.prev_gain_q16[1], 46);
    inv_gain_q30 = std::min(inv_gain_q30, (int32_t)(0x7FFFFFFF >> 1));
    for (int i = idx + order; i < st.ltp_mem_length; i++)
        s_ltp_q14[i] = smulwb(inv_gain_q30, s_ltp[i]);

    for (int k = 0; k < st.nb_subfr; k++) {
        int pred_lag = s_ltp_buf_idx - lag + LTP_ORDER / 2;
        for (int i = 0; i < st.subfr_length; i++) {
            int32_t lp = 2;
            lp = smlawb(lp, s_ltp_q14[pred_lag + 0], b_q14[0]);
            lp = smlawb(lp, s_ltp_q14[pred_lag - 1], b_q14[1]);
            lp = smlawb(lp, s_ltp_q14[pred_lag - 2], b_q14[2]);
            lp = smlawb(lp, s_ltp_q14[pred_lag - 3], b_q14[3]);
            lp = smlawb(lp, s_ltp_q14[pred_lag - 4], b_q14[4]);
            pred_lag++;
            rand_seed = silk_rand(rand_seed);
            int ridx = (rand_seed >> 25) & RAND_BUF_MASK;
            s_ltp_q14[s_ltp_buf_idx] =
                (int32_t)((uint32_t)smlawb(lp, rand_ptr[ridx], rand_scale_q14) << 2);
            s_ltp_buf_idx++;
        }
        for (int j = 0; j < LTP_ORDER; j++)
            b_q14[j] = smulbb(harm_gain_q15, b_q14[j]) >> 15;
        if (st.prev_signal_type != 0)
            rand_scale_q14 = (int32_t)(int16_t)(smulbb(rand_scale_q14, rand_gain_q15) >> 15);
        plc.pitch_l_q8 = smlawb(plc.pitch_l_q8, plc.pitch_l_q8, PITCH_DRIFT_FAC_Q16);
        plc.pitch_l_q8 = std::min(plc.pitch_l_q8, (int32_t)((MAX_PITCH_LAG_MS * st.fs_khz) << 8));
        lag = rshift_round(plc.pitch_l_q8, 8);
    }

    // LPC synthesis over the whole frame.
    int base = st.ltp_mem_length - MAX_LPC_ORDER;
    std::memcpy(&s_ltp_q14[base], st.s_lpc_q14, MAX_LPC_ORDER * sizeof(int32_t));
    for (int i = 0; i < L; i++) {
        int32_t lpc_pred_q10 = order >> 1;
        for (int j = 0; j < order; j++)
            lpc_pred_q10 = smlawb(lpc_pred_q10, s_ltp_q14[base + MAX_LPC_ORDER + i - 1 - j], a_q12[j]);
        s_ltp_q14[base + MAX_LPC_ORDER + i] =
            add_sat32i(s_ltp_q14[base + MAX_LPC_ORDER + i], lshift_sat32(lpc_pred_q10, 4));
        frame[i] = (int16_t)sat16i(
            rshift_round(smulww(s_ltp_q14[base + MAX_LPC_ORDER + i], prev_gain_q10[1]), 8));
    }
    std::memcpy(st.s_lpc_q14, &s_ltp_q14[base + L], MAX_LPC_ORDER * sizeof(int32_t));

    plc.rand_seed = rand_seed;
    plc.rand_scale_q14 = rand_scale_q14;
    st.loss_cnt++;
    st.lag_prev = lag;
}

// silk_PLC_glue_frames: fade-in after concealment.
static void plc_glue(SilkState& st, int16_t* frame, int length) {
    PlcC& plc = ensure_plc(st);
    if (st.loss_cnt) {
        sum_sqr_shift(frame, length, &plc.conc_energy, &plc.conc_energy_shift);
        plc.last_frame_lost = 1;
    } else {
        if (plc.last_frame_lost) {
            int32_t energy;
            int energy_shift;
            sum_sqr_shift(frame, length, &energy, &energy_shift);
            if (energy_shift > plc.conc_energy_shift)
                plc.conc_energy >>= (energy_shift - plc.conc_energy_shift);
            else if (energy_shift < plc.conc_energy_shift)
                energy >>= (plc.conc_energy_shift - energy_shift);
            if (energy > plc.conc_energy) {
                int lz = clz32i((uint32_t)plc.conc_energy) - 1;
                plc.conc_energy = (int32_t)((uint32_t)plc.conc_energy << lz);
                energy >>= std::max(24 - lz, 0);
                int32_t frac_q24 = plc.conc_energy / std::max(energy, 1);
                int32_t gain_q16 = (int32_t)((uint32_t)sqrt_approx(frac_q24) << 4);
                int32_t slope_q16 = (int32_t)((uint32_t)(((1 << 16) - gain_q16) / length) << 2);
                for (int i = 0; i < length; i++) {
                    frame[i] = (int16_t)smulwb(gain_q16, frame[i]);
                    gain_q16 += slope_q16;
                    if (gain_q16 > (1 << 16)) break;
                }
            }
        }
        plc.last_frame_lost = 0;
    }
}

// silk_CNG: update the noise estimate on clean no-activity frames; mix
// comfort noise into concealed frames.  ctrl == nullptr on concealment.
static void cng(SilkState& st, const Control* ctrl, int16_t* frame, int length) {
    if (st.cng_fs_khz != st.fs_khz) {
        // silk_CNG_Reset (plc.py cng_reset): exc buf is NOT cleared.
        int step = 32767 / (st.lpc_order + 1);
        int acc = 0;
        for (int i = 0; i < st.lpc_order; i++) {
            acc += step;
            st.cng_smth_nlsf_q15[i] = acc;
        }
        st.cng_smth_gain_q16 = 0;
        st.cng_rand_seed = 3176576;
        st.cng_fs_khz = st.fs_khz;
        std::memset(st.cng_synth_state, 0, sizeof(st.cng_synth_state));
    }

    if (st.loss_cnt == 0 && st.prev_signal_type == 0 && ctrl != nullptr) {
        for (int i = 0; i < st.lpc_order; i++)
            st.cng_smth_nlsf_q15[i] +=
                smulwb(st.prev_nlsf_q15[i] - st.cng_smth_nlsf_q15[i], CNG_NLSF_SMTH_Q16);
        int32_t max_gain = 0;
        int subfr = 0;
        for (int i = 0; i < st.nb_subfr; i++)
            if (ctrl->gains_q16[i] > max_gain) {
                max_gain = ctrl->gains_q16[i];
                subfr = i;
            }
        int sl = st.subfr_length;
        std::memmove(&st.cng_exc_buf_q14[sl], st.cng_exc_buf_q14,
                     (size_t)(st.nb_subfr - 1) * sl * sizeof(int32_t));
        std::memcpy(st.cng_exc_buf_q14, &st.exc_q14[(size_t)subfr * sl], sl * sizeof(int32_t));
        for (int i = 0; i < st.nb_subfr; i++)
            st.cng_smth_gain_q16 +=
                smulwb(ctrl->gains_q16[i] - st.cng_smth_gain_q16, CNG_GAIN_SMTH_Q16);
    }

    if (st.loss_cnt) {
        PlcC& plc = ensure_plc(st);
        int32_t gain_q16 = smulww(plc.rand_scale_q14, plc.prev_gain_q16[1]);
        if (gain_q16 >= (1 << 21) || st.cng_smth_gain_q16 > (1 << 23)) {
            gain_q16 = (gain_q16 >> 16) * (gain_q16 >> 16);
            gain_q16 = (int32_t)((uint32_t)((st.cng_smth_gain_q16 >> 16) * (st.cng_smth_gain_q16 >> 16)) -
                                 ((uint32_t)gain_q16 << 5));
            gain_q16 = (int32_t)((uint32_t)sqrt_approx(gain_q16) << 16);
        } else {
            gain_q16 = smulww(gain_q16, gain_q16);
            gain_q16 = (int32_t)((uint32_t)smulww(st.cng_smth_gain_q16, st.cng_smth_gain_q16) -
                                 ((uint32_t)gain_q16 << 5));
            gain_q16 = (int32_t)((uint32_t)sqrt_approx(gain_q16) << 8);
        }
        int32_t gain_q10 = gain_q16 >> 6;
        int exc_mask = CNG_BUF_MASK_MAX;
        while (exc_mask > length) exc_mask >>= 1;
        int32_t seed = st.cng_rand_seed;
        std::vector<int32_t> sig_q14(MAX_LPC_ORDER + length);
        for (int i = 0; i < length; i++) {
            seed = silk_rand(seed);
            sig_q14[MAX_LPC_ORDER + i] = st.cng_exc_buf_q14[(seed >> 24) & exc_mask];
        }
        st.cng_rand_seed = seed;
        int16_t a_q12[MAX_LPC_ORDER];
        nlsf2a(st.cng_smth_nlsf_q15, st.lpc_order, a_q12);
        std::memcpy(sig_q14.data(), st.cng_synth_state, MAX_LPC_ORDER * sizeof(int32_t));
        for (int i = 0; i < length; i++) {
            int32_t lp = st.lpc_order >> 1;
            for (int j = 0; j < st.lpc_order; j++)
                lp = smlawb(lp, sig_q14[MAX_LPC_ORDER + i - 1 - j], a_q12[j]);
            sig_q14[MAX_LPC_ORDER + i] = add_sat32i(sig_q14[MAX_LPC_ORDER + i], lshift_sat32(lp, 4));
            frame[i] = (int16_t)sat16i(
                (int32_t)frame[i] +
                (int32_t)sat16i(rshift_round(smulww(sig_q14[MAX_LPC_ORDER + i], gain_q10), 8)));
        }
        std::memcpy(st.cng_synth_state, &sig_q14[length], MAX_LPC_ORDER * sizeof(int32_t));
    } else {
        std::memset(st.cng_synth_state, 0, sizeof(st.cng_synth_state));
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: one 20 ms mono SILK frame decode (+ parameter planes).
// ---------------------------------------------------------------------------

extern "C" {

void* silk_fe_create(int fs_khz) {
    SilkState* st = new SilkState();
    st->set_fs(fs_khz);
    return st;
}

void silk_fe_destroy(void* h) { delete (SilkState*)h; }

// meta: 0 voiced, 1 rng-lo32 written via out param, 2.. lags[4]
// plane outputs sized: gexc[L] f32, a1/a2[order] f32, btaps[20] f32,
// head[18*fs+2] f32.  Returns 0, or negative on error.
int silk_fe_decode(void* h, const uint8_t* data, int len, int16_t* xq,
                   float* gexc, float* a1, float* a2, float* btaps, float* head,
                   int32_t* meta, uint32_t* rng_out) {
    SilkState& st = *(SilkState*)h;
    RangeDec dec;
    dec.init(data, len);
    int vad = dec.decode_bit_logp(1) ? 1 : 0;
    dec.decode_bit_logp(1);  // LBRR (absent on this fast path)
    SideInfo ind;
    decode_indices(dec, st, ind, vad != 0, CODE_INDEP);
    int pulses[24 * 16];
    decode_pulses(dec, ind.signal_type, ind.quant_offset_type, st.frame_length, pulses);
    Control ctrl;
    decode_parameters(st, ind, ctrl);
    st.first_frame_after_reset = 0;
    st.prev_signal_type = ind.signal_type;

    // Parameter planes for the device path (output-domain formulation).
    int L = st.frame_length, sub = st.subfr_length, order = st.lpc_order;
    if (gexc) {
        int offset_q10 = QUANTIZATION_OFFSETS_Q10[ind.signal_type >> 1][ind.quant_offset_type];
        int32_t rs = ind.seed;
        for (int i = 0; i < L; i++) {
            rs = silk_rand(rs);
            int32_t v = pulses[i] << 14;
            if (v > 0) v -= 1280;
            else if (v < 0) v += 1280;
            v += offset_q10 << 4;
            if (rs < 0) v = -v;
            gexc[i] = (float)((double)v / 16384.0 *
                              ((double)ctrl.gains_q16[i / sub] / 65536.0));
            rs = (int32_t)((uint32_t)rs + (uint32_t)pulses[i]);
        }
        for (int j = 0; j < order; j++) {
            a1[j] = ctrl.pred_coef_q12[0][j] / 4096.0f;
            a2[j] = ctrl.pred_coef_q12[1][j] / 4096.0f;
        }
        for (int k = 0; k < 4; k++)
            for (int j = 0; j < 5; j++)
                btaps[k * 5 + j] = ctrl.ltp_coef_q14[k * 5 + j] / 16384.0f;
        int head_len = 18 * st.fs_khz + 2;
        std::memset(head, 0, head_len * sizeof(float));
        if (ind.signal_type == 2) {
            std::vector<int16_t> white(st.ltp_mem_length, 0);
            int lag0 = ctrl.pitch_l[0];
            int start_idx = std::max(1, st.ltp_mem_length - lag0 - order - 2);
            lpc_analysis_filter(white.data(), start_idx, st.out_buf, start_idx,
                                ctrl.pred_coef_q12[0], st.ltp_mem_length - start_idx, order);
            double scale = (double)ctrl.ltp_scale_q14 / 16384.0;
            for (int i = 0; i < head_len && i < st.ltp_mem_length; i++)
                head[head_len - 1 - i] =
                    (float)(white[st.ltp_mem_length - 1 - i] * scale);
        }
        meta[0] = ind.signal_type == 2 ? 1 : 0;
        for (int k = 0; k < 4; k++)
            meta[2 + k] = std::max(ctrl.pitch_l[k], 2 * st.fs_khz + 2);
    }

    // Normative host synthesis.
    decode_core(st, ctrl, ind, pulses, xq);

    // Roll the LTP history.
    int mv = st.ltp_mem_length - L;
    if (mv > 0)
        std::memmove(st.out_buf, &st.out_buf[L], mv * sizeof(int16_t));
    std::memcpy(&st.out_buf[std::max(mv, 0)], xq, std::min(L, st.ltp_mem_length) * sizeof(int16_t));
    st.lag_prev = ctrl.pitch_l[st.nb_subfr - 1];
    st.loss_cnt = 0;

    *rng_out = dec.rng;
    return dec.error ? -2 : 0;
}

// Batch over independent stream handles (OpenMP across streams).
int silk_fe_decode_batch(void** handles, const uint8_t* data, const int32_t* lens,
                         int n, int16_t* xq, int64_t xq_stride, uint32_t* rngs) {
    std::vector<int64_t> offs(n + 1, 0);
    for (int i = 0; i < n; i++) offs[i + 1] = offs[i] + lens[i];
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 8)
    for (int i = 0; i < n; i++) {
        int rc = silk_fe_decode(handles[i], data + offs[i], lens[i],
                                xq + (int64_t)i * xq_stride, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, &rngs[i]);
        if (rc != 0) {
#pragma omp critical
            bad = i + 1;
        }
    }
    return bad ? -bad : n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full SILK decoder driver: resampler + stereo + multi-frame packets.
// C++ translation of opus_tpu/silk/{api,stereo,resampler}.py (bit-exact,
// validated against libopus through the Python reference).  Serves the
// batched mixed-mode pipeline (SILK-only and hybrid streams).
// ---------------------------------------------------------------------------

namespace {

// ----- resampler (opus_tpu/silk/resampler.py) ------------------------------

constexpr int16_t UP2_HQ_0c[3] = {1746, 14986, -26453};
constexpr int16_t UP2_HQ_1c[3] = {6854, 25769, -9994};

constexpr int16_t COEFS_3_4[] = {-20694, -13867,
    -49, 64, 17, -157, 353, -496, 163, 11047, 22205,
    -39, 6, 91, -170, 186, 23, -896, 6336, 19928,
    -19, -36, 102, -89, -24, 328, -951, 2568, 15909};
constexpr int16_t COEFS_2_3[] = {-14457, -14019,
    64, 128, -122, 36, 310, -768, 584, 9267, 17733,
    12, 128, 18, -142, 288, -117, -865, 4123, 14459};
constexpr int16_t COEFS_1_2[] = {616, -14323,
    -10, 39, 58, -46, -84, 120, 184, -315, -541, 1284, 5380, 9024};
constexpr int16_t COEFS_1_3[] = {16102, -15162,
    -13, 0, 20, 26, 5, -31, -43, -4, 65, 90, 7, -157, -248, -44, 593, 1583, 2612, 3271};
constexpr int16_t COEFS_1_4[] = {22500, -15099,
    3, -14, -20, -15, 2, 25, 37, 25, -16, -71, -107, -79, 50, 292, 623, 982, 1288, 1464};
constexpr int16_t COEFS_1_6[] = {27540, -15257,
    17, 12, 8, 1, -10, -22, -30, -32, -22, 3, 44, 100, 168, 243, 317, 381, 429, 455};

constexpr int ORDER_FIR0 = 18, ORDER_FIR1 = 24, ORDER_FIR2 = 36, ORDER_FIR_12 = 8;

// resampler.c delay_matrix_dec (decoder direction), input-rate samples.
static int delay_dec(int in_khz, int out_khz) {
    // Rows for 24/48 kHz inputs are zero (encoder-direction use; matches
    // opus_tpu/silk/resampler.py _DELAY_DEC) — falling through to the
    // 16 kHz row would add a spurious 12-sample input delay at 48->16,
    // skewing the hybrid encoder's SILK band against its CELT band.
    if (in_khz > 16) return 0;
    static const int tab[3][5] = {
        // out:      8  12  16  24  48
        /* in 8 */ { 4,  0,  2,  0,  0},
        /* in 12*/ { 0,  9,  4,  7,  4},
        /* in 16*/ { 0,  3, 12,  7,  7},
    };
    int r = in_khz == 8 ? 0 : in_khz == 12 ? 1 : 2;
    int c = out_khz == 8 ? 0 : out_khz == 12 ? 1 : out_khz == 16 ? 2 : out_khz == 24 ? 3 : 4;
    return tab[r][c];
}

struct ResamplerC {
    int fs_in_khz = 0, fs_out_khz = 0;
    int batch_size = 0, input_delay = 0;
    int16_t delay_buf[48] = {0};
    int32_t s_iir[6] = {0};
    int32_t s_fir[ORDER_FIR2] = {0};  // holds i16 (iirfir) or i32 (downfir) history
    int fir_order = 0, fir_fracs = 0;
    const int16_t* coefs = nullptr;
    int mode = 0;  // 0 copy, 1 up2hq, 2 iirfir, 3 downfir
    int32_t inv_ratio_q16 = 0;

    void init(int fs_in_hz, int fs_out_hz) {
        fs_in_khz = fs_in_hz / 1000;
        fs_out_khz = fs_out_hz / 1000;
        batch_size = fs_in_khz * 10;
        input_delay = delay_dec(fs_in_khz, fs_out_khz);
        std::memset(delay_buf, 0, sizeof(delay_buf));
        std::memset(s_iir, 0, sizeof(s_iir));
        std::memset(s_fir, 0, sizeof(s_fir));
        int up2x = 0;
        if (fs_out_hz > fs_in_hz) {
            if (fs_out_hz == 2 * fs_in_hz) mode = 1;
            else { mode = 2; up2x = 1; }
        } else if (fs_out_hz < fs_in_hz) {
            mode = 3;
            if (fs_out_hz * 4 == fs_in_hz * 3) { fir_fracs = 3; fir_order = ORDER_FIR0; coefs = COEFS_3_4; }
            else if (fs_out_hz * 3 == fs_in_hz * 2) { fir_fracs = 2; fir_order = ORDER_FIR0; coefs = COEFS_2_3; }
            else if (fs_out_hz * 2 == fs_in_hz) { fir_fracs = 1; fir_order = ORDER_FIR1; coefs = COEFS_1_2; }
            else if (fs_out_hz * 3 == fs_in_hz) { fir_fracs = 1; fir_order = ORDER_FIR2; coefs = COEFS_1_3; }
            else if (fs_out_hz * 4 == fs_in_hz) { fir_fracs = 1; fir_order = ORDER_FIR2; coefs = COEFS_1_4; }
            else { fir_fracs = 1; fir_order = ORDER_FIR2; coefs = COEFS_1_6; }
        } else {
            mode = 0;
        }
        int32_t inv = (int32_t)((((int64_t)fs_in_hz << (14 + up2x)) / fs_out_hz) << 2);
        while (smulww(inv, fs_out_hz) < (int32_t)((uint32_t)fs_in_hz << up2x)) inv++;
        inv_ratio_q16 = inv;
    }

    static void up2_hq(int32_t* s, int16_t* out, int out_off, const int16_t* in, int in_off, int len) {
        for (int k = 0; k < len; k++) {
            int32_t in32 = (int32_t)((uint32_t)in[in_off + k] << 10);
            int32_t y = (int32_t)((uint32_t)in32 - (uint32_t)s[0]);
            int32_t x = smulwb(y, UP2_HQ_0c[0]);
            int32_t out1 = (int32_t)((uint32_t)s[0] + (uint32_t)x);
            s[0] = (int32_t)((uint32_t)in32 + (uint32_t)x);
            y = (int32_t)((uint32_t)out1 - (uint32_t)s[1]);
            x = smulwb(y, UP2_HQ_0c[1]);
            int32_t out2 = (int32_t)((uint32_t)s[1] + (uint32_t)x);
            s[1] = (int32_t)((uint32_t)out1 + (uint32_t)x);
            y = (int32_t)((uint32_t)out2 - (uint32_t)s[2]);
            x = smlawb(y, y, UP2_HQ_0c[2]);
            out1 = (int32_t)((uint32_t)s[2] + (uint32_t)x);
            s[2] = (int32_t)((uint32_t)out2 + (uint32_t)x);
            out[out_off + 2 * k] = (int16_t)sat16i(rshift_round(out1, 10));
            y = (int32_t)((uint32_t)in32 - (uint32_t)s[3]);
            x = smulwb(y, UP2_HQ_1c[0]);
            out1 = (int32_t)((uint32_t)s[3] + (uint32_t)x);
            s[3] = (int32_t)((uint32_t)in32 + (uint32_t)x);
            y = (int32_t)((uint32_t)out1 - (uint32_t)s[4]);
            x = smulwb(y, UP2_HQ_1c[1]);
            out2 = (int32_t)((uint32_t)s[4] + (uint32_t)x);
            s[4] = (int32_t)((uint32_t)out1 + (uint32_t)x);
            y = (int32_t)((uint32_t)out2 - (uint32_t)s[5]);
            x = smlawb(y, y, UP2_HQ_1c[2]);
            out1 = (int32_t)((uint32_t)s[5] + (uint32_t)x);
            s[5] = (int32_t)((uint32_t)out2 + (uint32_t)x);
            out[out_off + 2 * k + 1] = (int16_t)sat16i(rshift_round(out1, 10));
        }
    }

    static void ar2(int32_t* s, int32_t* out_q8, int out_off, const int16_t* in, int in_off,
                    const int16_t* a_q14, int len) {
        for (int k = 0; k < len; k++) {
            int32_t out32 = (int32_t)((uint32_t)s[0] + ((uint32_t)in[in_off + k] << 8));
            out_q8[out_off + k] = out32;
            out32 = (int32_t)((uint32_t)out32 << 2);
            s[0] = smlawb(s[1], out32, a_q14[0]);
            s[1] = smulwb(out32, a_q14[1]);
        }
    }

    void iir_fir(std::vector<int16_t>& out, const int16_t* in, int in_off, int length) {
        std::vector<int16_t> buf(2 * batch_size + ORDER_FIR_12);
        int16_t* sfir16 = (int16_t*)s_fir;
        for (int i = 0; i < ORDER_FIR_12; i++) buf[i] = sfir16[i];
        int32_t increment = inv_ratio_q16;
        int n = 0;
        for (;;) {
            n = std::min(length, batch_size);
            up2_hq(s_iir, buf.data(), ORDER_FIR_12, in, in_off, n);
            int64_t max_index_q16 = (int64_t)n << 17;
            for (int64_t index_q16 = 0; index_q16 < max_index_q16; index_q16 += increment) {
                int table_index = smulwb((int32_t)(index_q16 & 0xFFFF), 12);
                int b = (int)(index_q16 >> 16);
                int32_t res = smulbb(buf[b + 0], RESAMPLER_FRAC_FIR_12[table_index][0]);
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 1], RESAMPLER_FRAC_FIR_12[table_index][1]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 2], RESAMPLER_FRAC_FIR_12[table_index][2]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 3], RESAMPLER_FRAC_FIR_12[table_index][3]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 4], RESAMPLER_FRAC_FIR_12[11 - table_index][3]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 5], RESAMPLER_FRAC_FIR_12[11 - table_index][2]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 6], RESAMPLER_FRAC_FIR_12[11 - table_index][1]));
                res = (int32_t)((uint32_t)res + (uint32_t)smulbb(buf[b + 7], RESAMPLER_FRAC_FIR_12[11 - table_index][0]));
                out.push_back((int16_t)sat16i(rshift_round(res, 15)));
            }
            in_off += n;
            length -= n;
            if (length > 0) {
                for (int i = 0; i < ORDER_FIR_12; i++) buf[i] = buf[2 * n + i];
            } else break;
        }
        for (int i = 0; i < ORDER_FIR_12; i++) sfir16[i] = buf[2 * n + i];
    }

    void down_fir(std::vector<int16_t>& out, const int16_t* in, int in_off, int length) {
        std::vector<int32_t> buf(batch_size + fir_order);
        for (int i = 0; i < fir_order; i++) buf[i] = s_fir[i];
        const int16_t* fir = coefs + 2;
        int32_t increment = inv_ratio_q16;
        int n = 0;
        for (;;) {
            n = std::min(length, batch_size);
            ar2(s_iir, buf.data(), fir_order, in, in_off, coefs, n);
            int64_t max_index_q16 = (int64_t)n << 16;
            for (int64_t index_q16 = 0; index_q16 < max_index_q16; index_q16 += increment) {
                int b = (int)(index_q16 >> 16);
                int32_t res;
                if (fir_order == ORDER_FIR0) {
                    int interpol_ind = smulwb((int32_t)(index_q16 & 0xFFFF), fir_fracs);
                    int p1 = 9 * interpol_ind;
                    int p2 = 9 * (fir_fracs - 1 - interpol_ind);
                    res = smulwb(buf[b + 0], fir[p1 + 0]);
                    for (int j = 1; j < 9; j++) res = smlawb(res, buf[b + j], fir[p1 + j]);
                    for (int j = 0; j < 9; j++) res = smlawb(res, buf[b + 17 - j], fir[p2 + j]);
                } else if (fir_order == ORDER_FIR1) {
                    res = smulwb((int32_t)((uint32_t)buf[b + 0] + (uint32_t)buf[b + 23]), fir[0]);
                    for (int j = 1; j < 12; j++)
                        res = smlawb(res, (int32_t)((uint32_t)buf[b + j] + (uint32_t)buf[b + 23 - j]), fir[j]);
                } else {
                    res = smulwb((int32_t)((uint32_t)buf[b + 0] + (uint32_t)buf[b + 35]), fir[0]);
                    for (int j = 1; j < 18; j++)
                        res = smlawb(res, (int32_t)((uint32_t)buf[b + j] + (uint32_t)buf[b + 35 - j]), fir[j]);
                }
                out.push_back((int16_t)sat16i(rshift_round(res, 6)));
            }
            in_off += n;
            length -= n;
            if (length > 1) {
                for (int i = 0; i < fir_order; i++) buf[i] = buf[n + i];
            } else break;
        }
        for (int i = 0; i < fir_order; i++) s_fir[i] = buf[n + i];
    }

    void run(std::vector<int16_t>& out, const int16_t* in, int in_off, int length) {
        if (mode == 0) {
            for (int i = 0; i < length; i++) out.push_back(in[in_off + i]);
        } else if (mode == 1) {
            size_t base = out.size();
            out.resize(base + 2 * length);
            up2_hq(s_iir, out.data(), (int)base, in, in_off, length);
        } else if (mode == 2) {
            iir_fir(out, in, in_off, length);
        } else {
            down_fir(out, in, in_off, length);
        }
    }

    // silk_resampler: 1 ms delay-buffer phase then the rest.
    void process(std::vector<int16_t>& out, const int16_t* in, int in_len) {
        int n = fs_in_khz - input_delay;
        for (int i = 0; i < n; i++) delay_buf[input_delay + i] = in[i];
        run(out, delay_buf, 0, fs_in_khz);
        run(out, in, n, in_len - fs_in_khz);
        for (int i = 0; i < input_delay; i++) delay_buf[i] = in[in_len - input_delay + i];
    }
};

// ----- stereo prediction / unmix (opus_tpu/silk/stereo.py) -----------------

constexpr int STEREO_INTERP_LEN_MS = 8;

struct StereoDecStateC {
    int pred_prev_q13[2] = {0, 0};
    int16_t s_mid[2] = {0, 0};
    int16_t s_side[2] = {0, 0};
};

static void stereo_decode_pred(RangeDec& dec, int pred_q13[2]) {
    int n = dec.decode_icdf(STEREO_PRED_JOINT_ICDF, 8);
    int ix[2][3];
    ix[0][2] = n / 5;
    ix[1][2] = n - 5 * ix[0][2];
    for (int ch = 0; ch < 2; ch++) {
        ix[ch][0] = dec.decode_icdf(UNIFORM3_ICDF, 8);
        ix[ch][1] = dec.decode_icdf(UNIFORM5_ICDF, 8);
    }
    for (int ch = 0; ch < 2; ch++) {
        ix[ch][0] += 3 * ix[ch][2];
        int low = STEREO_PRED_QUANT_Q13[ix[ch][0]];
        int step = (int)(((int64_t)(STEREO_PRED_QUANT_Q13[ix[ch][0] + 1] - low) * 6554) >> 16);
        pred_q13[ch] = (int32_t)(low + smulbb(step, 2 * ix[ch][1] + 1));
    }
    pred_q13[0] = (int32_t)((uint32_t)pred_q13[0] - (uint32_t)pred_q13[1]);
}

static int stereo_decode_mid_only(RangeDec& dec) {
    return dec.decode_icdf(STEREO_ONLY_CODE_MID_ICDF, 8);
}

static inline void stereo_apply_pred(int16_t* x1, int16_t* x2, int n, int pred0_q13, int pred1_q13) {
    int32_t s = (int32_t)((uint32_t)(x1[n] + x1[n + 2] + 2 * x1[n + 1]) << 9);
    s = smlawb((int32_t)((uint32_t)x2[n + 1] << 8), s, pred0_q13);
    s = smlawb(s, (int32_t)((uint32_t)x1[n + 1] << 11), pred1_q13);
    x2[n + 1] = (int16_t)sat16i(rshift_round(s, 8));
}

static void stereo_ms_to_lr(StereoDecStateC& st, int16_t* x1, int16_t* x2,
                            const int pred_q13[2], int fs_khz, int frame_length) {
    x1[0] = st.s_mid[0]; x1[1] = st.s_mid[1];
    x2[0] = st.s_side[0]; x2[1] = st.s_side[1];
    st.s_mid[0] = x1[frame_length]; st.s_mid[1] = x1[frame_length + 1];
    st.s_side[0] = x2[frame_length]; st.s_side[1] = x2[frame_length + 1];

    int pred0 = st.pred_prev_q13[0];
    int pred1 = st.pred_prev_q13[1];
    int interp_len = STEREO_INTERP_LEN_MS * fs_khz;
    int denom_q16 = (1 << 16) / interp_len;
    int delta0 = rshift_round(smulbb(pred_q13[0] - st.pred_prev_q13[0], denom_q16), 16);
    int delta1 = rshift_round(smulbb(pred_q13[1] - st.pred_prev_q13[1], denom_q16), 16);
    for (int n = 0; n < interp_len; n++) {
        pred0 += delta0;
        pred1 += delta1;
        stereo_apply_pred(x1, x2, n, pred0, pred1);
    }
    for (int n = interp_len; n < frame_length; n++)
        stereo_apply_pred(x1, x2, n, pred_q13[0], pred_q13[1]);
    st.pred_prev_q13[0] = pred_q13[0];
    st.pred_prev_q13[1] = pred_q13[1];

    for (int n = 0; n < frame_length; n++) {
        int s = x1[n + 1] + x2[n + 1];
        int d = x1[n + 1] - x2[n + 1];
        x1[n + 1] = (int16_t)sat16i(s);
        x2[n + 1] = (int16_t)sat16i(d);
    }
}

// ----- one channel-frame decode (api.py decode_frame, normal path) ---------

static int decode_channel_frame(SilkState& st, RangeDec& dec, bool vad, int cond, int16_t* xq) {
    SideInfo ind;
    decode_indices(dec, st, ind, vad, cond);
    int pulses[24 * 16];
    decode_pulses(dec, ind.signal_type, ind.quant_offset_type, st.frame_length, pulses);
    Control ctrl;
    decode_parameters(st, ind, ctrl, cond);
    decode_core(st, ctrl, ind, pulses, xq);
    plc_save(st, ctrl, ind);  // silk_PLC(lost=0)
    st.loss_cnt = 0;
    st.prev_signal_type = ind.signal_type;
    st.first_frame_after_reset = 0;
    // Roll the LTP history.
    int L = st.frame_length;
    int mv = st.ltp_mem_length - L;
    if (mv > 0) std::memmove(st.out_buf, &st.out_buf[L], mv * sizeof(int16_t));
    std::memcpy(&st.out_buf[std::max(mv, 0)], xq, std::min(L, st.ltp_mem_length) * sizeof(int16_t));
    cng(st, &ctrl, xq, L);   // noise-estimate update (clean frames)
    plc_glue(st, xq, L);     // fade-in after a concealment run
    st.lag_prev = ctrl.pitch_l[st.nb_subfr - 1];
    return 0;
}

// One concealed channel frame (api.py decode_frame, lost path).
static void conceal_channel_frame(SilkState& st, int16_t* xq) {
    plc_conceal(st, xq);
    int L = st.frame_length;
    int mv = st.ltp_mem_length - L;
    if (mv > 0) std::memmove(st.out_buf, &st.out_buf[L], mv * sizeof(int16_t));
    std::memcpy(&st.out_buf[std::max(mv, 0)], xq, std::min(L, st.ltp_mem_length) * sizeof(int16_t));
    cng(st, nullptr, xq, L);  // mixes comfort noise into the concealed frame
    plc_glue(st, xq, L);      // records concealment energy
}

// ----- silk_Decode-level driver (api.py SilkDecoder) ------------------------

struct SilkDriver {
    SilkState ch[2];
    StereoDecStateC stereo;
    ResamplerC rs[2];
    int n_channels_api = 0;
    int n_channels_internal = 0;
    int prev_decode_only_middle = 0;
    int fs_api_hz = 0;
};

// Raw internal-rate output mode (fs_api_hz == 0): instead of resampling
// to the API rate, write the post-unmix internal-rate PCM channel-PLANAR
// (row n at out + n*lmax, lmax = 16*payload_ms, zero-padded past
// frame_len) and report a descriptor word:
//   desc = internal_khz | (nrows-1) << 5 | resampler_reset << 6
// The device then resamples the whole batch as one dense matmul per rate
// (opus_tpu/dsp/resample.py) — a 3-6x host->device byte reduction for
// the mixed serving loop.  The reset bit mirrors exactly the condition
// under which libopus re-initialises its resampler state (rate change),
// which on device zeroes the carried input-history tail.
static void raw_internal_out(const int16_t* x1, const int16_t* x2, int frame_len,
                             int payload_ms, int internal_khz, int nci, int nca,
                             int rs_reset, int16_t* out, int32_t* desc) {
    int lmax = 16 * payload_ms;
    int nrows = std::min(nca, nci);
    for (int n = 0; n < nrows; n++) {
        const int16_t* src = (n == 0 ? x1 : x2) + 1;
        std::memcpy(out + (int64_t)n * lmax, src, (size_t)frame_len * sizeof(int16_t));
        std::memset(out + (int64_t)n * lmax + frame_len, 0,
                    (size_t)(lmax - frame_len) * sizeof(int16_t));
    }
    for (int n = nrows; n < nca; n++)
        std::memset(out + (int64_t)n * lmax, 0, (size_t)lmax * sizeof(int16_t));
    if (desc) *desc = internal_khz | ((nrows - 1) << 5) | (rs_reset << 6);
}

// Decode one whole SILK payload (1-3 frames) -> interleaved int16 at the
// API rate.  out must hold (ms*fs_api/1000)*n_api samples.  Returns 0 ok.
// fs_api_hz == 0 selects the raw internal-rate planar output (see
// raw_internal_out; single-frame payloads only).
static int silk_driver_decode(SilkDriver& d, RangeDec& dec, int internal_khz, int payload_ms,
                              int nci, int nca, int fs_api_hz, int16_t* out,
                              int32_t* desc = nullptr) {
    SilkState* cs = d.ch;
    for (int n = 0; n < nci; n++) cs[n].n_frames_decoded = 0;
    if (nci > d.n_channels_internal) cs[1] = SilkState();

    const bool raw = fs_api_hz == 0;
    const int eff_api_hz = raw ? 48000 : fs_api_hz;
    int rs_reset = 0;
    int fpp = payload_ms <= 20 ? 1 : payload_ms == 40 ? 2 : 3;
    if (raw && fpp > 1) return -3;
    int nb_subfr = payload_ms <= 10 ? 2 : 4;
    for (int n = 0; n < nci; n++) {
        cs[n].n_frames_per_packet = fpp;
        cs[n].nb_subfr = nb_subfr;
        cs[n].set_fs(internal_khz);
        if (d.rs[n].fs_in_khz != internal_khz || d.rs[n].fs_out_khz * 1000 != eff_api_hz) {
            d.rs[n].init(internal_khz * 1000, eff_api_hz);
            rs_reset = 1;
        }
    }
    if (nca == 2 && nci == 2 && (d.n_channels_api == 1 || d.n_channels_internal == 1)) {
        d.stereo.pred_prev_q13[0] = d.stereo.pred_prev_q13[1] = 0;
        d.stereo.s_side[0] = d.stereo.s_side[1] = 0;
        d.rs[1] = d.rs[0];
    }
    d.n_channels_api = nca;
    d.n_channels_internal = nci;

    // Header flags (VAD per frame + LBRR), then LBRR skip.
    for (int n = 0; n < nci; n++) {
        for (int i = 0; i < fpp; i++) cs[n].vad_flags[i] = dec.decode_bit_logp(1) ? 1 : 0;
        cs[n].lbrr_flag = dec.decode_bit_logp(1) ? 1 : 0;
    }
    for (int n = 0; n < nci; n++) {
        cs[n].lbrr_flags[0] = cs[n].lbrr_flags[1] = cs[n].lbrr_flags[2] = 0;
        if (cs[n].lbrr_flag) {
            if (fpp == 1) {
                cs[n].lbrr_flags[0] = 1;
            } else {
                int sym = dec.decode_icdf(fpp == 2 ? LBRR_FLAGS_2_ICDF : LBRR_FLAGS_3_ICDF, 8) + 1;
                for (int i = 0; i < fpp; i++) cs[n].lbrr_flags[i] = (sym >> i) & 1;
            }
        }
    }
    for (int i = 0; i < fpp; i++) {
        for (int n = 0; n < nci; n++) {
            if (cs[n].lbrr_flags[i]) {
                if (nci == 2 && n == 0) {
                    int pq[2];
                    stereo_decode_pred(dec, pq);
                    if (cs[1].lbrr_flags[i] == 0) stereo_decode_mid_only(dec);
                }
                int cond = (i > 0 && cs[n].lbrr_flags[i - 1]) ? CODE_COND : CODE_INDEP;
                SideInfo ind;
                decode_indices(dec, cs[n], ind, true, cond);
                int pulses[24 * 16];
                decode_pulses(dec, ind.signal_type, ind.quant_offset_type,
                              cs[n].frame_length, pulses);
            }
        }
    }

    int frame_len = cs[0].frame_length;
    int out_per_frame = frame_len * (eff_api_hz / 1000) / internal_khz;
    std::vector<int16_t> x1(frame_len + 2), x2(frame_len + 2);
    std::vector<int16_t> res;
    res.reserve(out_per_frame + 16);

    for (int fi = 0; fi < fpp; fi++) {
        int ms_pred_q13[2] = {0, 0};
        int decode_only_middle = 0;
        if (nci == 2) {
            stereo_decode_pred(dec, ms_pred_q13);
            if (cs[1].vad_flags[cs[0].n_frames_decoded] == 0)
                decode_only_middle = stereo_decode_mid_only(dec);
        }
        if (nci == 2 && decode_only_middle == 0 && d.prev_decode_only_middle == 1) {
            SilkState& s = cs[1];
            std::memset(s.out_buf, 0, sizeof(s.out_buf));
            std::memset(s.s_lpc_q14, 0, sizeof(s.s_lpc_q14));
            s.lag_prev = 100;
            s.last_gain_index = 10;
            s.prev_signal_type = 0;
            s.first_frame_after_reset = 1;
        }
        bool has_side = !decode_only_middle;

        std::fill(x1.begin(), x1.end(), 0);
        std::fill(x2.begin(), x2.end(), 0);
        for (int n = 0; n < nci; n++) {
            if (n == 0 || has_side) {
                int frame_index = cs[0].n_frames_decoded - n;
                int cond;
                if (frame_index <= 0) cond = CODE_INDEP;
                else if (n > 0 && d.prev_decode_only_middle) cond = CODE_INDEP_NO_LTP;
                else cond = CODE_COND;
                bool vad = cs[n].vad_flags[cs[n].n_frames_decoded] != 0;
                int16_t* dst = (n == 0 ? x1.data() : x2.data()) + 2;
                decode_channel_frame(cs[n], dec, vad, cond, dst);
            }
            cs[n].n_frames_decoded += 1;
        }

        if (nca == 2 && nci == 2) {
            stereo_ms_to_lr(d.stereo, x1.data(), x2.data(), ms_pred_q13,
                            cs[0].fs_khz, frame_len);
        } else {
            x1[0] = d.stereo.s_mid[0];
            x1[1] = d.stereo.s_mid[1];
            d.stereo.s_mid[0] = x1[frame_len];
            d.stereo.s_mid[1] = x1[frame_len + 1];
        }

        if (raw) {
            raw_internal_out(x1.data(), x2.data(), frame_len, payload_ms,
                             internal_khz, nci, nca, rs_reset, out, desc);
            // Keep the (otherwise unused) resampler state WARM in raw
            // mode: mode-switch transition PLC rows resample at 48 kHz
            // through this state and must match the scalar decoder's.
            for (int n = 0; n < std::min(nca, nci); n++) {
                res.clear();
                d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
            }
        } else {
            int16_t* out_f = out + (int64_t)fi * out_per_frame * nca;
            for (int n = 0; n < std::min(nca, nci); n++) {
                res.clear();
                d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
                for (int i = 0; i < out_per_frame; i++) out_f[i * nca + n] = res[i];
            }
            if (nca == 2 && nci == 1)
                for (int i = 0; i < out_per_frame; i++) out_f[i * nca + 1] = out_f[i * nca];
        }
        d.prev_decode_only_middle = decode_only_middle;
    }
    return dec.error ? -2 : 0;
}

// FEC: decode the LBRR frame of a <=20 ms payload in place of the lost
// previous frame (api.py lost_flag=FLAG_DECODE_LBRR; single-frame
// packets only — the serving path never carries 40/60 ms).  A channel
// without LBRR conceals (api.py decode_frame's else branch), so a
// packet with no LBRR at all degenerates to PLC.
static int silk_driver_decode_lbrr(SilkDriver& d, RangeDec& dec, int internal_khz,
                                   int payload_ms, int nci, int nca,
                                   int fs_api_hz, int16_t* out,
                                   int32_t* desc = nullptr) {
    if (payload_ms > 20) return -3;
    SilkState* cs = d.ch;
    for (int n = 0; n < nci; n++) cs[n].n_frames_decoded = 0;
    if (nci > d.n_channels_internal) cs[1] = SilkState();
    const bool raw = fs_api_hz == 0;
    const int eff_api_hz = raw ? 48000 : fs_api_hz;
    int rs_reset = 0;
    int nb_subfr = payload_ms <= 10 ? 2 : 4;
    for (int n = 0; n < nci; n++) {
        cs[n].n_frames_per_packet = 1;
        cs[n].nb_subfr = nb_subfr;
        cs[n].set_fs(internal_khz);
        if (d.rs[n].fs_in_khz != internal_khz || d.rs[n].fs_out_khz * 1000 != eff_api_hz) {
            d.rs[n].init(internal_khz * 1000, eff_api_hz);
            rs_reset = 1;
        }
    }
    if (nca == 2 && nci == 2 && (d.n_channels_api == 1 || d.n_channels_internal == 1)) {
        d.stereo.pred_prev_q13[0] = d.stereo.pred_prev_q13[1] = 0;
        d.stereo.s_side[0] = d.stereo.s_side[1] = 0;
        d.rs[1] = d.rs[0];
    }
    d.n_channels_api = nca;
    d.n_channels_internal = nci;

    // Header flags (VAD + LBRR; fpp == 1 so no flag symbol follows).
    for (int n = 0; n < nci; n++) {
        cs[n].vad_flags[0] = dec.decode_bit_logp(1) ? 1 : 0;
        cs[n].lbrr_flag = dec.decode_bit_logp(1) ? 1 : 0;
    }
    for (int n = 0; n < nci; n++) {
        cs[n].lbrr_flags[0] = cs[n].lbrr_flags[1] = cs[n].lbrr_flags[2] = 0;
        if (cs[n].lbrr_flag) cs[n].lbrr_flags[0] = 1;
    }

    int ms_pred_q13[2] = {0, 0};
    int decode_only_middle = 0;
    if (nci == 2) {
        if (cs[0].lbrr_flags[0] == 1) {
            stereo_decode_pred(dec, ms_pred_q13);
            if (cs[1].lbrr_flags[0] == 0)
                decode_only_middle = stereo_decode_mid_only(dec);
        } else {
            ms_pred_q13[0] = d.stereo.pred_prev_q13[0];
            ms_pred_q13[1] = d.stereo.pred_prev_q13[1];
        }
    }
    if (nci == 2 && decode_only_middle == 0 && d.prev_decode_only_middle == 1) {
        SilkState& s = cs[1];
        std::memset(s.out_buf, 0, sizeof(s.out_buf));
        std::memset(s.s_lpc_q14, 0, sizeof(s.s_lpc_q14));
        s.lag_prev = 100;
        s.last_gain_index = 10;
        s.prev_signal_type = 0;
        s.first_frame_after_reset = 1;
    }
    bool has_side = (!d.prev_decode_only_middle)
                    || (nci == 2 && cs[1].lbrr_flags[0] == 1);

    int frame_len = cs[0].frame_length;
    int out_per_frame = frame_len * (eff_api_hz / 1000) / internal_khz;
    std::vector<int16_t> x1(frame_len + 2, 0), x2(frame_len + 2, 0);
    std::vector<int16_t> res;
    res.reserve(out_per_frame + 16);

    for (int n = 0; n < nci; n++) {
        if (n == 0 || has_side) {
            int16_t* dst = (n == 0 ? x1.data() : x2.data()) + 2;
            if (cs[n].lbrr_flags[0])
                decode_channel_frame(cs[n], dec, /*vad(lbrr)=*/true, CODE_INDEP, dst);
            else
                conceal_channel_frame(cs[n], dst);
        }
        cs[n].n_frames_decoded += 1;
    }

    if (nca == 2 && nci == 2) {
        stereo_ms_to_lr(d.stereo, x1.data(), x2.data(), ms_pred_q13,
                        cs[0].fs_khz, frame_len);
    } else {
        x1[0] = d.stereo.s_mid[0];
        x1[1] = d.stereo.s_mid[1];
        d.stereo.s_mid[0] = x1[frame_len];
        d.stereo.s_mid[1] = x1[frame_len + 1];
    }

    if (raw) {
        raw_internal_out(x1.data(), x2.data(), frame_len, payload_ms,
                         internal_khz, nci, nca, rs_reset, out, desc);
        for (int n = 0; n < std::min(nca, nci); n++) {  // warm rs (see above)
            res.clear();
            d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
        }
    } else {
        for (int n = 0; n < std::min(nca, nci); n++) {
            res.clear();
            d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
            for (int i = 0; i < out_per_frame; i++) out[i * nca + n] = res[i];
        }
        if (nca == 2 && nci == 1)
            for (int i = 0; i < out_per_frame; i++) out[i * nca + 1] = out[i * nca];
    }
    d.prev_decode_only_middle = decode_only_middle;
    return dec.error ? -2 : 0;
}

// Conceal one whole lost SILK payload (api.py SilkDecoder.decode with
// lost_flag=FLAG_PACKET_LOST, looped over the packet's frames): PLC
// extrapolation per channel + CNG + stereo unmix with the previous
// prediction weights + resampling.  Parameters (rate/duration/channels)
// are the last good packet's, cached by the caller.
static int silk_driver_conceal(SilkDriver& d, int internal_khz, int payload_ms,
                               int nci, int nca, int fs_api_hz, int16_t* out,
                               int32_t* desc = nullptr) {
    SilkState* cs = d.ch;
    for (int n = 0; n < nci; n++) cs[n].n_frames_decoded = 0;
    if (nci > d.n_channels_internal) cs[1] = SilkState();
    const bool raw = fs_api_hz == 0;
    const int eff_api_hz = raw ? 48000 : fs_api_hz;
    int rs_reset = 0;
    int fpp = payload_ms <= 20 ? 1 : payload_ms == 40 ? 2 : 3;
    if (raw && fpp > 1) return -3;
    int nb_subfr = payload_ms <= 10 ? 2 : 4;
    for (int n = 0; n < nci; n++) {
        cs[n].n_frames_per_packet = fpp;
        cs[n].nb_subfr = nb_subfr;
        cs[n].set_fs(internal_khz);
        if (d.rs[n].fs_in_khz != internal_khz || d.rs[n].fs_out_khz * 1000 != eff_api_hz) {
            d.rs[n].init(internal_khz * 1000, eff_api_hz);
            rs_reset = 1;
        }
    }
    if (nca == 2 && nci == 2 && (d.n_channels_api == 1 || d.n_channels_internal == 1)) {
        d.stereo.pred_prev_q13[0] = d.stereo.pred_prev_q13[1] = 0;
        d.stereo.s_side[0] = d.stereo.s_side[1] = 0;
        d.rs[1] = d.rs[0];
    }
    d.n_channels_api = nca;
    d.n_channels_internal = nci;

    int frame_len = cs[0].frame_length;
    int out_per_frame = frame_len * (eff_api_hz / 1000) / internal_khz;
    std::vector<int16_t> x1(frame_len + 2), x2(frame_len + 2);
    std::vector<int16_t> res;
    res.reserve(out_per_frame + 16);

    for (int fi = 0; fi < fpp; fi++) {
        // Loss keeps the previous stereo weights and mid-only choice.
        int ms_pred_q13[2] = {d.stereo.pred_prev_q13[0], d.stereo.pred_prev_q13[1]};
        if (nci == 2 && d.prev_decode_only_middle == 1) {
            // decode_only_middle defaults to 0 on the lost path, so the
            // side-state reset fires exactly as in api.py:200.
            SilkState& s = cs[1];
            std::memset(s.out_buf, 0, sizeof(s.out_buf));
            std::memset(s.s_lpc_q14, 0, sizeof(s.s_lpc_q14));
            s.lag_prev = 100;
            s.last_gain_index = 10;
            s.prev_signal_type = 0;
            s.first_frame_after_reset = 1;
        }
        bool has_side = !d.prev_decode_only_middle;

        std::fill(x1.begin(), x1.end(), 0);
        std::fill(x2.begin(), x2.end(), 0);
        for (int n = 0; n < nci; n++) {
            if (n == 0 || has_side)
                conceal_channel_frame(cs[n], (n == 0 ? x1.data() : x2.data()) + 2);
            cs[n].n_frames_decoded += 1;
        }

        if (nca == 2 && nci == 2) {
            stereo_ms_to_lr(d.stereo, x1.data(), x2.data(), ms_pred_q13,
                            cs[0].fs_khz, frame_len);
        } else {
            x1[0] = d.stereo.s_mid[0];
            x1[1] = d.stereo.s_mid[1];
            d.stereo.s_mid[0] = x1[frame_len];
            d.stereo.s_mid[1] = x1[frame_len + 1];
        }

        if (raw) {
            raw_internal_out(x1.data(), x2.data(), frame_len, payload_ms,
                             internal_khz, nci, nca, rs_reset, out, desc);
            for (int n = 0; n < std::min(nca, nci); n++) {  // warm rs
                res.clear();
                d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
            }
        } else {
            int16_t* out_f = out + (int64_t)fi * out_per_frame * nca;
            for (int n = 0; n < std::min(nca, nci); n++) {
                res.clear();
                d.rs[n].process(res, (n == 0 ? x1.data() : x2.data()) + 1, frame_len);
                for (int i = 0; i < out_per_frame; i++) out_f[i * nca + n] = res[i];
            }
            if (nca == 2 && nci == 1)
                for (int i = 0; i < out_per_frame; i++) out_f[i * nca + 1] = out_f[i * nca];
        }
        // prev_decode_only_middle is NOT updated on loss (api.py:249).
    }
    return 0;
}

}  // namespace

extern "C" {

void* silk_dec_create() { return new SilkDriver(); }
void silk_dec_destroy(void* h) { delete (SilkDriver*)h; }

// Full decoder reset (CELT->SILK mode switch: the SILK state is stale —
// opus_decoder.c resets the silk layer before decoding the new mode).
void silk_dec_reset(void* h) { *(SilkDriver*)h = SilkDriver(); }

// Snapshot/restore into a reused pool (SilkDriver is value-copyable:
// its only heap member is exc_q14, whose capacity copy-assignment
// reuses, and table pointers reference statics) — used by
// opus_frontend.cpp to make plan attempts transactional without
// per-step heap churn.
static std::vector<SilkDriver>& silk_snap_pool(int n) {
    static std::vector<SilkDriver> pool;
    if ((int)pool.size() < n) pool.resize(n);
    return pool;
}
void silk_dec_snapshot(void** handles_silk, int n) {
    auto& pool = silk_snap_pool(n);
    for (int i = 0; i < n; i++) pool[i] = *(SilkDriver*)handles_silk[i];
}
void silk_dec_restore_all(void** handles_silk, int n) {
    auto& pool = silk_snap_pool(n);
    for (int i = 0; i < n; i++) *(SilkDriver*)handles_silk[i] = pool[i];
}
void silk_dec_restore_one(void* handle_silk, int i) {
    *(SilkDriver*)handle_silk = silk_snap_pool(i + 1)[i];
}
// Pre-size the pool BEFORE parallel per-stream snapshots: the lazy
// resize inside silk_snap_pool would race across OpenMP threads.
void silk_dec_pool_reserve(int n) { silk_snap_pool(n); }
void silk_dec_snapshot_one(void* handle_silk, int i) {
    silk_snap_pool(i + 1)[i] = *(SilkDriver*)handle_silk;
}

// fs_api_hz == 0 selects the raw internal-rate planar output for the
// device-side resampler (desc receives khz/rows/reset; see
// raw_internal_out); desc may be null in the 48 kHz mode.
int silk_dec_run(void* h, opusfe::RangeDec* dec, int internal_khz, int payload_ms,
                 int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc) {
    return silk_driver_decode(*(SilkDriver*)h, *dec, internal_khz, payload_ms,
                              nci, nca, fs_api_hz, out, desc);
}

int silk_dec_run_fec(void* h, opusfe::RangeDec* dec, int internal_khz, int payload_ms,
                     int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc) {
    return silk_driver_decode_lbrr(*(SilkDriver*)h, *dec, internal_khz, payload_ms,
                                   nci, nca, fs_api_hz, out, desc);
}

int silk_dec_conceal(void* h, int internal_khz, int payload_ms,
                     int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc) {
    return silk_driver_conceal(*(SilkDriver*)h, internal_khz, payload_ms,
                               nci, nca, fs_api_hz, out, desc);
}

// Debug: dump channel-0 decoder+PLC state for test-side comparison with
// the Python SilkChannelState (tests only; not a stable ABI).
void silk_dec_dump(void* h, int32_t* out) {
    SilkState& st = ((SilkDriver*)h)->ch[0];
    int k = 0;
    out[k++] = st.loss_cnt;
    out[k++] = st.lag_prev;
    out[k++] = st.last_gain_index;
    out[k++] = st.prev_gain_q16;
    out[k++] = st.prev_signal_type;
    out[k++] = st.first_frame_after_reset;
    int32_t ob = 0;
    for (int i = 0; i < st.ltp_mem_length; i++) ob = ob * 31 + st.out_buf[i];
    out[k++] = ob;
    for (int i = 0; i < MAX_LPC_ORDER; i++) out[k++] = st.s_lpc_q14[i];
    PlcC& plc = st.plc;
    out[k++] = plc.pitch_l_q8;
    out[k++] = plc.rand_seed;
    out[k++] = plc.rand_scale_q14;
    out[k++] = plc.conc_energy;
    out[k++] = plc.conc_energy_shift;
    out[k++] = plc.last_frame_lost;
    out[k++] = plc.prev_ltp_scale_q14;
    out[k++] = plc.prev_gain_q16[0];
    out[k++] = plc.prev_gain_q16[1];
    for (int i = 0; i < LTP_ORDER; i++) out[k++] = plc.ltp_coef_q14[i];
    for (int i = 0; i < MAX_LPC_ORDER; i++) out[k++] = plc.prev_lpc_q12[i];
}

}  // extern "C"

#include "silk_encoder.inc"
