// Combined Opus mode-mux front end (plane A) for the batched serving path.
//
// One handle per stream composes the CELT front end and the SILK driver
// behind the shared range decoder (the defining Opus constraint,
// /root/reference/src/decoder.rs:603/:711: SILK then CELT consume ONE
// bitstream).  Handles SilkOnly / Hybrid / CeltOnly packets, PLC/FEC,
// and (approximately) mode switches and redundancy frames: the incoming
// codec's state resets at a switch and redundant CELT blocks are
// parsed-and-skipped, so the serving session survives real traffic; the
// 2.5-5 ms transition crossfades remain exact only in the scalar path
// (opus_tpu.decoder) — see approx_mode_switch/skip_redundancy.
//
// Emits, per stream: the CELT symbol planes consumed by the batched TPU
// synthesis step, plus SILK PCM at the API rate (bit-exact fixed-point
// synthesis + normative resampler) for the device-side mix
// (decoder.rs:722-729 semantics: out = celt + silk/32768).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#include "ec.h"

extern "C" {
// celt_frontend.cpp
void celt_fe_pack_pw(const float* x, int n, int lm, int W, int32_t* dst, float* ble_row);
void* celt_fe_create(int channels, int downsample);
void celt_fe_destroy(void* h);
void celt_fe_config(void* h, int start_band, int end_band, int disable_inv);
void celt_fe_reset(void* h);
uint32_t celt_fe_rng(void* h);
int celt_fe_decode_ec(void* h, void* ec, int frame_bytes, int frame_size48,
                      int stream_channels, float* x_out, float* band_log_e_out,
                      int32_t* meta, double* pf_gains);
int celt_fe_decode_lost(void* h, int frame_size48, float* x_out,
                        float* band_log_e_out, int32_t* meta, double* pf_gains);
int celt_fe_decode_lost_dispatch(void* h, int frame_size48, float* x_out,
                                 float* band_log_e_out, int32_t* meta,
                                 double* pf_gains);
// plan-sink pool (celt_frontend.cpp; the mixed plan serving path)
void celt_fe_plan_prepare(int n);
void celt_fe_plan_clear(int sink_idx);
int celt_fe_decode_ec_plan(void* h, void* ec, int frame_bytes, int frame_size48,
                           int stream_channels, int sink_idx, float* ble_out,
                           int32_t* meta, double* pf_gains);
int celt_fe_plan_lost(void* h, int frame_size48, int sink_idx, float* ble_out,
                      int32_t* meta, double* pf_gains);
int celt_fe_plan_lost_dispatch(void* h, int frame_size48, int sink_idx,
                               float* ble_out, int32_t* meta, double* pf_gains);
int64_t celt_fe_plan_headers(int n, int32_t* header, int64_t arena_words);
void celt_fe_plan_pack(int n, int32_t* arena, const int32_t* header);
void celt_fe_plan_bands(int sink_idx, int32_t* bands_out);
int celt_fe_state_bytes();
void celt_fe_state_get(void* h, void* buf);
void celt_fe_state_set(void* h, const void* buf);
// silk_frontend.cpp
void* silk_dec_create();
void silk_dec_destroy(void* h);
void silk_dec_reset(void* h);
void silk_dec_snapshot(void** handles_silk, int n);
void silk_dec_restore_all(void** handles_silk, int n);
void silk_dec_restore_one(void* handle_silk, int i);
void silk_dec_pool_reserve(int n);
void silk_dec_snapshot_one(void* handle_silk, int i);
// fs_api_hz == 0: raw internal-rate planar output + desc word for the
// device-side resampler (silk_frontend.cpp raw_internal_out).
int silk_dec_run(void* h, opusfe::RangeDec* dec, int internal_khz, int payload_ms,
                 int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc);
int silk_dec_run_fec(void* h, opusfe::RangeDec* dec, int internal_khz, int payload_ms,
                     int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc);
int silk_dec_conceal(void* h, int internal_khz, int payload_ms,
                     int nci, int nca, int fs_api_hz, int16_t* out, int32_t* desc);
}

namespace {

constexpr int MODE_SILK = 0;
constexpr int MODE_HYBRID = 1;
constexpr int MODE_CELT = 2;

// ToC bandwidth code (0=NB..4=FB) -> CELT end band (opus_decoder.c mapping).
constexpr int CELT_END_BAND[5] = {13, 17, 17, 19, 21};

struct OpusFE {
    void* celt;
    void* silk;
    int channels;   // API channels (1 or 2)
    int prev_mode;  // -1 until the first frame
    int last_bw;    // ToC bandwidth of the last good frame (PLC params)
    int last_sch;   // coded channels of the last good frame
    bool prev_redundancy = false;  // last frame carried a redundant CELT
                                   // block (its decode warmed celt state,
                                   // so the next switch must NOT reset)
    bool silk_internal = false;    // SILK PCM ships at the INTERNAL rate
                                   // (planar, desc in meta[12]); the
                                   // device resamples (dsp/resample.py)
};

// int16 samples the SILK region holds per stream for one frame: the
// internal-rate planar layout is channels rows of frame48/3 (the 16 kHz
// worst case), a 3x cut vs resampled 48 kHz PCM.
static inline size_t silk_out_samps(const OpusFE* st, int frame48) {
    return st->silk_internal ? (size_t)st->channels * (frame48 / 3)
                             : (size_t)frame48 * st->channels;
}

// Approximate transition semantics for the batched paths.  The scalar
// decoder.py keeps the EXACT libopus behaviour (2.5/5 ms crossfades and
// the decoded 5 ms redundant CELT frame), which needs the CELT time
// domain — device-resident here.  The batched approximation:
//  * mode switch: reset the incoming codec's state and decode fresh
//    (the same resets opus_decoder.c performs; only the short fade is
//    missing, bounded to 2.5-5 ms at the switch boundary);
//  * redundancy blocks: parse the flags/length and SKIP the redundant
//    CELT frame, shrinking the range budget as the spec requires so
//    the main content decodes identically (decoder.rs:626-656).
static void approx_mode_switch(OpusFE* st, int mode) {
    if (st->prev_mode >= 0 && mode != st->prev_mode) {
        // decoder.py: a redundant block in the previous frame already
        // warmed the celt state the new mode's bitstream predicts from.
        if (mode != MODE_SILK && !st->prev_redundancy)
            celt_fe_reset(st->celt);
        if (mode != MODE_CELT && st->prev_mode == MODE_CELT)
            silk_dec_reset(st->silk);
    }
}

// Redundancy blocks are fully decoded for their CELT STATE effect (the
// scalar path additionally crossfades their PCM — the only dropped
// piece here), in the scalar decoder's exact order: celt_to_silk
// redundancy BEFORE the main CELT decode with the current state,
// silk_to_celt redundancy AFTER it from a reset state (warming the
// energy prediction the NEXT frame's bitstream was coded against).
struct RedInfo {
    bool present = false;
    bool celt_to_silk = false;
    int len_eff = 0;  // main-frame bytes for the following CELT decode
    int bytes = 0;
    uint32_t rng = 0;
};

static RedInfo parse_redundancy(opusfe::RangeDec& dec, int mode, int len) {
    RedInfo r;
    r.len_eff = len;
    if (dec.tell() + 17 + (mode == MODE_HYBRID ? 20 : 0) > 8 * len) return r;
    int redundancy = mode == MODE_HYBRID ? (int)dec.decode_bit_logp(12) : 1;
    if (!redundancy) return r;
    r.celt_to_silk = (bool)dec.decode_bit_logp(1);
    int64_t red = mode == MODE_HYBRID ? (int64_t)dec.decode_uint(256) + 2
                                      : (int64_t)len - ((dec.tell() + 7) >> 3);
    int64_t len_eff = (int64_t)len - red;
    if (len_eff * 8 < dec.tell()) return r;  // corrupt; not normative
    dec.storage = (int)len_eff;  // hide the tail from the raw-bit reader
    r.present = true;
    r.len_eff = (int)len_eff;
    r.bytes = (int)red;
    return r;
}

// Decode the 5 ms redundant CELT frame (payload tail) to advance state.
static void decode_redundant(OpusFE* st, const uint8_t* payload, RedInfo& r,
                             int bw, int sch) {
    if (!r.present) return;
    if (!r.celt_to_silk) celt_fe_reset(st->celt);
    celt_fe_config(st->celt, 0, CELT_END_BAND[bw], -1);
    static thread_local std::vector<float> xscr(2 * 240);
    float blescr[2 * 21];
    int32_t metascr[16];
    double gscr[3];
    opusfe::RangeDec rdec;
    rdec.init(payload + r.len_eff, r.bytes);
    int rc = celt_fe_decode_ec(st->celt, &rdec, r.bytes, 240, sch,
                               xscr.data(), blescr, metascr, gscr);
    if (rc == 0) r.rng = rdec.rng;
}

// "Silent spectra" meta row: the device step's bound mask zeroes the
// CELT plane for this stream.
static void silent_celt_meta(int frame48, int sch, int32_t* meta, float* pf_gains_out) {
    int lm = 3;
    for (int l = 0; l <= 3; l++)
        if ((120 << l) == frame48) lm = l;
    meta[0] = 1;  // silence -> bound 0
    meta[1] = 0;
    meta[2] = lm;
    meta[3] = sch;
    meta[4] = 0;
    meta[5] = 0;
    meta[6] = meta[7] = meta[8] = 15;
    meta[9] = meta[10] = meta[11] = 0;
    meta[12] = 0;
    pf_gains_out[0] = pf_gains_out[1] = pf_gains_out[2] = 0.0f;
}

}  // namespace

extern "C" {

void* opus_fe_create(int channels) {
    OpusFE* st = new OpusFE();
    st->celt = celt_fe_create(channels, 1);
    st->silk = silk_dec_create();
    st->channels = channels;
    st->prev_mode = -1;
    st->last_bw = 4;
    st->last_sch = channels;
    return st;
}

void opus_fe_destroy(void* h) {
    OpusFE* st = (OpusFE*)h;
    celt_fe_destroy(st->celt);
    silk_dec_destroy(st->silk);
    delete st;
}

uint32_t opus_fe_celt_rng(void* h) { return celt_fe_rng(((OpusFE*)h)->celt); }

// Select the SILK transfer form for this stream's serving slots:
// enable=1 ships internal-rate planar PCM + desc (meta[12]); 0 ships
// resampled 48 kHz interleaved PCM (the default).  Must be set before
// the first decode and never changed mid-stream (the device's resampler
// history and the native resampler state are not interchangeable).
void opus_fe_set_silk_internal(void* h, int enable) {
    ((OpusFE*)h)->silk_internal = enable != 0;
}

// Decode ONE Opus frame (already split out of the packet; payload only).
// mode: 0 silk / 1 hybrid / 2 celt; bw: ToC bandwidth code 0..4;
// frame48: frame duration in 48 kHz samples; sch: coded channels (1/2).
// Outputs: CELT planes (x/ble/meta/pf_gains, untouched for silk-only
// except meta), silk48 (interleaved int16 at 48 kHz, API channels;
// zeroed for celt-only), final_range.
// Returns 0 or a negative codec error.  Mode switches reset the
// incoming codec's state (approx_mode_switch); redundancy blocks are
// parsed and skipped (skip_redundancy) — both approximations bounded
// to the 2.5-5 ms crossfade the scalar path performs exactly.
// tdesc (nullable): transition descriptor for the EXACT batched
// crossfades (opus_pipeline._apply_transitions):
//   bit0 redundancy present | bit1 celt_to_silk | bits2-12 red bytes |
//   bits13-23 red offset (len_eff) | bit24 to-CELT transition PLC row
//   written to trans_out (480*cc int16 @48 kHz, the scalar's 10 ms SILK
//   PLC whose first 5 ms crossfades the frame head — decoder.py:268).
int opus_fe_decode(void* h, const uint8_t* payload, int len, int mode, int bw,
                   int frame48, int sch, float* x_out, float* ble_out,
                   int32_t* meta, float* pf_gains_out, int16_t* silk48,
                   uint32_t* final_range, int device_plc = 0,
                   int32_t* tdesc = nullptr, int16_t* trans_out = nullptr) {
    OpusFE* st = (OpusFE*)h;
    int cc = st->channels;
    const int fs_silk = st->silk_internal ? 0 : 48000;
    int32_t sdesc = 0;
    const size_t silk_samps = silk_out_samps(st, frame48);
    if (len == 0) {
        // Packet loss: conceal from the previous mode's state (PLC).
        // SILK extrapolation is the exact silk/PLC.c+CNG.c port in
        // silk_frontend.cpp; the CELT contribution uses the noise-regime
        // concealment (the CELT-only plan path conceals the pitch-LPC
        // regime on device instead).
        *final_range = 0;
        int pm = st->prev_mode;
        if (pm < 0) {  // nothing decoded yet: silence
            std::memset(silk48, 0, silk_samps * sizeof(int16_t));
            silent_celt_meta(frame48, st->last_sch, meta, pf_gains_out);
            if (st->silk_internal) meta[12] = 0;
            return 0;
        }
        if (pm != MODE_CELT) {
            int khz = pm == MODE_HYBRID
                          ? 16
                          : (st->last_bw == 0 ? 8 : st->last_bw == 1 ? 12 : 16);
            int ms = frame48 / 48;
            if (ms != 10 && ms != 20 && ms != 40 && ms != 60) return -3;
            int rc = silk_dec_conceal(st->silk, khz, ms, st->last_sch, cc, fs_silk,
                                      silk48, &sdesc);
            if (rc != 0) return rc;
        } else {
            std::memset(silk48, 0, silk_samps * sizeof(int16_t));
        }
        if (pm != MODE_SILK) {
            double g[3];
            // device_plc: pitch-regime losses ship zero spectra + the
            // meta[14]/[15] flags for the device conceal (plc_exec.py);
            // noise regime (hybrid, long bursts) stays in plane A.
            int rc = device_plc
                         ? celt_fe_decode_lost_dispatch(st->celt, frame48, x_out,
                                                        ble_out, meta, g)
                         : celt_fe_decode_lost(st->celt, frame48, x_out, ble_out,
                                               meta, g);
            if (rc != 0) return rc;
            for (int j = 0; j < 3; j++) pf_gains_out[j] = (float)g[j];
        } else {
            silent_celt_meta(frame48, st->last_sch, meta, pf_gains_out);
        }
        if (st->silk_internal) meta[12] = sdesc;
        return 0;
    }
    if (len < 0) {
        // FEC: len = -(bytes) of the NEXT packet; recover the lost frame
        // from its SILK LBRR (decoder.py decode(decode_fec=True): LBRR
        // for the silk layer, loss concealment for any CELT layer).
        len = -len;
        if (len < 1 || len > 1275 || bw < 0 || bw > 4) return -1;
        if (mode == MODE_CELT) {
            // CELT has no FEC: identical to a plain loss.
            return opus_fe_decode(h, payload, 0, mode, bw, frame48, sch, x_out,
                                  ble_out, meta, pf_gains_out, silk48,
                                  final_range);
        }
        approx_mode_switch(st, mode);
        st->prev_mode = mode;
        st->last_bw = bw;
        st->last_sch = sch;
        st->prev_redundancy = false;
        opusfe::RangeDec dec;
        dec.init(payload, len);
        int khz = mode == MODE_HYBRID ? 16 : (bw == 0 ? 8 : bw == 1 ? 12 : 16);
        int ms = frame48 / 48;
        if (ms != 10 && ms != 20) return -3;
        int rc = silk_dec_run_fec(st->silk, &dec, khz, ms, sch, cc, fs_silk,
                                  silk48, &sdesc);
        if (rc != 0) return rc;
        if (mode == MODE_HYBRID) {
            double g[3];
            rc = device_plc
                     ? celt_fe_decode_lost_dispatch(st->celt, frame48, x_out,
                                                    ble_out, meta, g)
                     : celt_fe_decode_lost(st->celt, frame48, x_out, ble_out,
                                           meta, g);
            if (rc != 0) return rc;
            for (int j = 0; j < 3; j++) pf_gains_out[j] = (float)g[j];
        } else {
            silent_celt_meta(frame48, sch, meta, pf_gains_out);
        }
        if (st->silk_internal) meta[12] = sdesc;
        *final_range = dec.rng;
        return 0;
    }
    if (len < 1 || len > 1275 || bw < 0 || bw > 4) return -1;
    // SILK/hybrid -> CELT transition: the scalar decodes a 5 ms PLC from
    // the OLD SILK state before anything else (decoder.py:268-271) and
    // crossfades it into the frame head.  Emit that PCM (exact, plane A)
    // so the batched path can apply the same fade on device.
    if (mode == MODE_CELT && st->prev_mode >= 0 && st->prev_mode != MODE_CELT
        && !st->prev_redundancy && trans_out) {
        int khz = st->prev_mode == MODE_HYBRID
                      ? 16
                      : (st->last_bw == 0 ? 8 : st->last_bw == 1 ? 12 : 16);
        int32_t dummy = 0;
        if (silk_dec_conceal(st->silk, khz, 10, st->last_sch, cc, 48000,
                             trans_out, &dummy) == 0 && tdesc)
            *tdesc |= 1 << 24;
    }
    approx_mode_switch(st, mode);
    st->prev_mode = mode;
    st->last_bw = bw;
    st->last_sch = sch;

    opusfe::RangeDec dec;
    dec.init(payload, len);
    RedInfo red;

    if (mode != MODE_CELT) {
        int khz = mode == MODE_HYBRID ? 16 : (bw == 0 ? 8 : bw == 1 ? 12 : 16);
        int ms = frame48 / 48;
        if (ms != 10 && ms != 20 && ms != 40 && ms != 60) return -3;
        if (mode == MODE_HYBRID && ms > 20) return -3;
        if (st->silk_internal && ms > 20) return -3;  // serve path only
        int rc = silk_dec_run(st->silk, &dec, khz, ms, sch, cc, fs_silk,
                              silk48, &sdesc);
        if (rc != 0) return rc;
        red = parse_redundancy(dec, mode, len);
        if (red.celt_to_silk) decode_redundant(st, payload, red, bw, sch);
    } else {
        std::memset(silk48, 0, silk_samps * sizeof(int16_t));
        red.len_eff = len;
    }

    if (mode != MODE_SILK) {
        celt_fe_config(st->celt, mode == MODE_HYBRID ? 17 : 0, CELT_END_BAND[bw], -1);
        double g[3];
        int rc = celt_fe_decode_ec(st->celt, &dec, red.len_eff, frame48, sch, x_out,
                                   ble_out, meta, g);
        if (rc != 0) return rc;
        for (int j = 0; j < 3; j++) pf_gains_out[j] = (float)g[j];
    } else {
        // No CELT contribution: emit a "silent spectra" meta row so the
        // device step's bound mask zeroes the CELT plane.
        int lm = 3;
        for (int l = 0; l <= 3; l++)
            if ((120 << l) == frame48) lm = l;
        meta[0] = 1;  // silence -> bound 0
        meta[1] = 0;
        meta[2] = lm;
        meta[3] = sch;
        meta[4] = 0;
        meta[5] = 0;
        meta[6] = meta[7] = meta[8] = 15;
        meta[9] = meta[10] = meta[11] = 0;
        meta[12] = 0;
        pf_gains_out[0] = pf_gains_out[1] = pf_gains_out[2] = 0.0f;
    }
    if (red.present && !red.celt_to_silk)
        decode_redundant(st, payload, red, bw, sch);
    st->prev_redundancy = red.present;
    if (st->silk_internal) meta[12] = sdesc;
    if (tdesc && red.present)
        *tdesc |= 1 | (red.celt_to_silk ? 2 : 0) | (red.bytes << 2)
                | (red.len_eff << 13);
    *final_range = dec.rng ^ red.rng;  // decoder.py range_final semantics
    return 0;
}

// Packed batch entry for the single-upload mixed serving loop: CELT
// band shapes bit-packed to `mant_bits` (see celt_fe_pack_pw; per-band
// exponents folded into ble), SILK PCM as int16 at 48 kHz.  Only valid
// for frame48 <= 960 (longer SILK-only frames skip the device step).
// xq_stride/silk_stride in their element types; rows for modes that do
// not use a plane are zeroed so recycled slots stay deterministic.
int opus_fe_decode_batch_packed(void** handles, const uint8_t* data, const int32_t* lens,
                                int n, const int32_t* modes, const int32_t* bws,
                                int frame48, const int32_t* schs, int mant_bits,
                                int device_plc, int16_t* trans_out,
                                int32_t* xq_out, int64_t xq_stride,
                                int16_t* silk48_out, int64_t silk_stride,
                                float* ble_out, int32_t* meta_out, float* gains_out,
                                uint32_t* ranges, int32_t* rcs) {
    std::vector<int64_t> offs(n + 1, 0);
    // lens[i] < 0 marks an FEC entry of |lens[i]| bytes (decode the
    // lost frame from that packet's SILK LBRR).
    for (int i = 0; i < n; i++) offs[i + 1] = offs[i] + std::abs(lens[i]);
    int bad = 0;
    silk_dec_pool_reserve(n);
    const int cbp = celt_fe_state_bytes();
#pragma omp parallel
    {
        std::vector<float> xbuf(2 * 960);
        std::vector<uint8_t> csnap(cbp);
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n; i++) {
            float* ble = ble_out + i * 2 * 21;
            int32_t* meta = meta_out + i * 16;
            OpusFE* st = (OpusFE*)handles[i];
            OpusFE fe_save = *st;
            celt_fe_state_get(st->celt, csnap.data());
            silk_dec_snapshot_one(st->silk, i);
            int32_t tdesc = 0;
            int rc = opus_fe_decode(handles[i], data + offs[i], lens[i], modes[i], bws[i],
                                    frame48, schs[i], xbuf.data(), ble, meta,
                                    gains_out + i * 3,
                                    silk48_out + (int64_t)i * silk_stride, &ranges[i],
                                    device_plc, &tdesc,
                                    trans_out ? trans_out + (int64_t)i * 480 * st->channels
                                              : nullptr);
            rcs[i] = rc == 0 ? tdesc : rc;
            if (rc != 0 && lens[i] != 0) {
                // Corrupt/invalid packet on ONE stream must not kill the
                // batch: restore this stream's state and conceal the
                // frame as a loss (rcs[i] keeps the original code).
                void *c = st->celt, *sk = st->silk;
                celt_fe_state_set(c, csnap.data());
                silk_dec_restore_one(sk, i);
                *st = fe_save;
                st->celt = c;
                st->silk = sk;
                rc = opus_fe_decode(handles[i], data + offs[i], 0, modes[i], bws[i],
                                    frame48, schs[i], xbuf.data(), ble, meta,
                                    gains_out + i * 3,
                                    silk48_out + (int64_t)i * silk_stride, &ranges[i],
                                    device_plc);
            }
            if (rc != 0) {
                rcs[i] = rc;
#pragma omp critical
                bad = i + 1;
            } else {
                int32_t* dst = xq_out + (int64_t)i * xq_stride;
                // Lost packets conceal from the previous mode's state; a
                // loss before any good frame behaves like silent SILK.
                int eff_mode = lens[i] ? modes[i]
                                       : std::max(((OpusFE*)handles[i])->prev_mode, 0);
                if (eff_mode == MODE_SILK) {
                    std::memset(dst, 0, (size_t)xq_stride * sizeof(int32_t));
                    std::memset(ble, 0, 2 * 21 * sizeof(float));
                } else {
                    int lm = meta[2];
                    int c_ = meta[3];
                    int nn = 120 << lm;
                    for (int c = 0; c < c_; c++)
                        celt_fe_pack_pw(xbuf.data() + c * nn, nn, lm, mant_bits,
                                        dst + c * (xq_stride / 2), ble + c * 21);
                }
            }
        }
    }
    return bad ? -bad : n;
}

// Plan-mode batch entry for the mixed single-upload serving loop: the
// CELT contribution of CELT/hybrid streams ships as a plan (pulse
// vectors + band plan, spectra rebuilt on device by the executor —
// opus_tpu/dsp/plan_exec.py, now start/end aware), SILK PCM as int16 at
// 48 kHz; SILK-only streams carry a zero-leaf plan.  Losses conceal in
// plane A (exact SILK PLC + noise-regime CELT, as opus_fe_decode).
// Returns n, -(i+1) on stream i failing (rc in rcs[i]; -30 = plan
// overflow -> caller falls back to the packed path), or -(n+1) if the
// shared arena is exhausted.
int opus_fe_decode_batch_plan(void** handles, const uint8_t* data, const int32_t* lens,
                              int n, const int32_t* modes, const int32_t* bws,
                              int frame48, const int32_t* schs,
                              int32_t* header, float* ble_out, int32_t* meta_out,
                              float* gains_out, int32_t* bands_out,
                              int32_t* arena, int64_t arena_words, int64_t* used_words_out,
                              int16_t* silk48_out, int64_t silk_stride,
                              int16_t* trans_out,
                              uint32_t* ranges, int32_t* rcs) {
    std::vector<int64_t> offs(n + 1, 0);
    // lens[i] < 0 marks an FEC entry of |lens[i]| bytes (decode the
    // lost frame from that packet's SILK LBRR).
    for (int i = 0; i < n; i++) offs[i + 1] = offs[i] + std::abs(lens[i]);
    celt_fe_plan_prepare(n);
    // Transactional: any failure (decode error, mode switch, plan
    // capacity) makes the caller re-decode the SAME packets through the
    // packed path, so the attempt must not advance decoder state.
    const int cb = celt_fe_state_bytes();
    static std::vector<uint8_t> celt_snap;
    static std::vector<void*> silk_handles;
    static std::vector<OpusFE> fe_snap;
    celt_snap.resize((size_t)n * cb);
    silk_handles.resize(n);
    fe_snap.resize(n);
    for (int i = 0; i < n; i++) {
        OpusFE* st = (OpusFE*)handles[i];
        fe_snap[i] = *st;
        celt_fe_state_get(st->celt, celt_snap.data() + (size_t)i * cb);
        silk_handles[i] = st->silk;
    }
    silk_dec_snapshot(silk_handles.data(), n);
    auto finish = [&](bool restore) {
        if (!restore) return;
        for (int i = 0; i < n; i++) {
            OpusFE* st = (OpusFE*)handles[i];
            void *c = st->celt, *s = st->silk;
            celt_fe_state_set(c, celt_snap.data() + (size_t)i * cb);
            *st = fe_snap[i];
            st->celt = c;
            st->silk = s;
        }
        silk_dec_restore_all(silk_handles.data(), n);
    };
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 8)
    for (int i = 0; i < n; i++) {
        OpusFE* st = (OpusFE*)handles[i];
        int cc = st->channels;
        float* ble = ble_out + i * 2 * 21;
        int32_t* meta = meta_out + i * 16;
        float* gains = gains_out + i * 3;
        int16_t* silk48 = silk48_out + (int64_t)i * silk_stride;
        double g[3] = {0.0, 0.0, 0.0};
        int rc = 0;
        int rc_desc = 0;  // transition descriptor on success (see tdesc)
        int mode = modes[i];
        const int fs_silk = st->silk_internal ? 0 : 48000;
        const size_t silk_samps = silk_out_samps(st, frame48);
        int32_t sdesc = 0;
        // Conceal stream i from its previous mode's state (the lens==0
        // loss path, also reused to absorb corrupt packets below).
        auto conceal_i = [&]() -> int {
            int crc = 0;
            ranges[i] = 0;
            sdesc = 0;
            int pm = st->prev_mode;
            if (pm != MODE_CELT)
                std::memset(silk48, 0, silk_samps * sizeof(int16_t));
            if (pm >= 0 && pm != MODE_CELT) {
                int khz = pm == MODE_HYBRID
                              ? 16
                              : (st->last_bw == 0 ? 8 : st->last_bw == 1 ? 12 : 16);
                crc = silk_dec_conceal(st->silk, khz, frame48 / 48, st->last_sch, cc,
                                       fs_silk, silk48, &sdesc);
            } else if (pm == MODE_CELT) {
                std::memset(silk48, 0, silk_samps * sizeof(int16_t));
            }
            if (crc == 0 && pm > MODE_SILK) {
                // Regime dispatch: pitch-LPC for CELT-only streams (device
                // conceals from its decode memory), noise for hybrid
                // (start_band != 0 always routes noise inside).
                crc = celt_fe_plan_lost_dispatch(st->celt, frame48, i, ble, meta, g);
            } else {
                std::memset(ble, 0, 2 * 21 * sizeof(float));
                silent_celt_meta(frame48, st->last_sch, meta, gains);
                celt_fe_plan_clear(i);
            }
            return crc;
        };
        if (lens[i] == 0 || (lens[i] < 0 && mode == MODE_CELT)) {
            rc = conceal_i();
        } else if (lens[i] < 0) {
            // FEC: recover the lost frame from this (next) packet's SILK
            // LBRR; the CELT layer concelas as a loss (it has no FEC).
            int flen = -lens[i];
            int pm = mode;  // the FEC packet's ToC mode
            ranges[i] = 0;
            if (flen > 1275 || bws[i] < 0 || bws[i] > 4) {
                rc = -1;
            } else {
                approx_mode_switch(st, pm);
                st->prev_mode = pm;
                st->last_bw = bws[i];
                st->last_sch = schs[i];
                st->prev_redundancy = false;
                opusfe::RangeDec dec;
                dec.init(data + offs[i], flen);
                int khz = pm == MODE_HYBRID
                              ? 16
                              : (bws[i] == 0 ? 8 : bws[i] == 1 ? 12 : 16);
                int ms = frame48 / 48;
                if (ms != 10 && ms != 20) rc = -3;
                if (rc == 0)
                    rc = silk_dec_run_fec(st->silk, &dec, khz, ms, schs[i], cc,
                                          fs_silk, silk48, &sdesc);
                if (rc == 0) {
                    if (pm == MODE_HYBRID) {
                        rc = celt_fe_plan_lost(st->celt, frame48, i, ble, meta, g);
                    } else {
                        std::memset(ble, 0, 2 * 21 * sizeof(float));
                        silent_celt_meta(frame48, schs[i], meta, gains);
                        celt_fe_plan_clear(i);
                    }
                    if (rc == 0) ranges[i] = dec.rng;
                }
            }
        } else if (lens[i] > 1275 || bws[i] < 0 || bws[i] > 4) {
            rc = -1;
        } else {
            // to-CELT transition PLC row + descriptor (see opus_fe_decode)
            int32_t tdesc = 0;
            if (mode == MODE_CELT && st->prev_mode >= 0
                && st->prev_mode != MODE_CELT && !st->prev_redundancy
                && trans_out) {
                int khz = st->prev_mode == MODE_HYBRID
                              ? 16
                              : (st->last_bw == 0 ? 8 : st->last_bw == 1 ? 12 : 16);
                int32_t dummy = 0;
                if (silk_dec_conceal(st->silk, khz, 10, st->last_sch, cc, 48000,
                                     trans_out + (int64_t)i * 480 * cc,
                                     &dummy) == 0)
                    tdesc |= 1 << 24;
            }
            approx_mode_switch(st, mode);
            st->prev_mode = mode;
            st->last_bw = bws[i];
            st->last_sch = schs[i];
            opusfe::RangeDec dec;
            dec.init(data + offs[i], lens[i]);
            RedInfo red;
            red.len_eff = lens[i];
            if (mode != MODE_CELT) {
                int khz = mode == MODE_HYBRID
                              ? 16
                              : (bws[i] == 0 ? 8 : bws[i] == 1 ? 12 : 16);
                int ms = frame48 / 48;
                if (ms != 10 && ms != 20) rc = -3;  // serve path: <=20 ms
                if (rc == 0)
                    rc = silk_dec_run(st->silk, &dec, khz, ms, schs[i], cc, fs_silk,
                                      silk48, &sdesc);
                if (rc == 0) {
                    red = parse_redundancy(dec, mode, lens[i]);
                    if (red.celt_to_silk)
                        decode_redundant(st, data + offs[i], red, bws[i], schs[i]);
                }
            } else {
                std::memset(silk48, 0, silk_samps * sizeof(int16_t));
            }
            if (rc == 0 && mode != MODE_SILK) {
                celt_fe_config(st->celt, mode == MODE_HYBRID ? 17 : 0,
                               CELT_END_BAND[bws[i]], -1);
                rc = celt_fe_decode_ec_plan(st->celt, &dec, red.len_eff, frame48,
                                            schs[i], i, ble, meta, g);
            } else if (rc == 0) {
                std::memset(ble, 0, 2 * 21 * sizeof(float));
                silent_celt_meta(frame48, schs[i], meta, gains);
                celt_fe_plan_clear(i);
            }
            if (rc == 0) {
                if (red.present && !red.celt_to_silk)
                    decode_redundant(st, data + offs[i], red, bws[i], schs[i]);
                st->prev_redundancy = red.present;
                ranges[i] = dec.rng ^ red.rng;
                if (red.present)
                    tdesc |= 1 | (red.celt_to_silk ? 2 : 0) | (red.bytes << 2)
                           | (red.len_eff << 13);
            }
            if (rc == 0) rc_desc = tdesc;
        }
        rcs[i] = rc == 0 ? rc_desc : rc;
        if (rc != 0 && lens[i] != 0) {
            // A corrupt/invalid packet on ONE stream must not kill the
            // batch (availability): restore this stream's state and
            // conceal the frame as a loss.  rcs[i] keeps the original
            // code for observability; the call still succeeds.
            void *c = st->celt, *sk = st->silk;
            celt_fe_state_set(c, celt_snap.data() + (size_t)i * cb);
            silk_dec_restore_one(sk, i);
            *st = fe_snap[i];
            st->celt = c;
            st->silk = sk;
            rc = conceal_i();
        }
        if (rc == 0) {
            for (int j = 0; j < 3; j++) gains[j] = (float)g[j];
            if (mode == MODE_SILK && lens[i] != 0)
                gains[0] = gains[1] = gains[2] = 0.0f;
            if (st->silk_internal) meta[12] = sdesc;
            celt_fe_plan_bands(i, bands_out + i * 21 * 2);
        }
        if (rc != 0) {
            rcs[i] = rc;
#pragma omp critical
            bad = i + 1;
        }
    }
    if (bad) { finish(true); return -bad; }
    int64_t total = celt_fe_plan_headers(n, header, arena_words);
    if (total < 0) { finish(true); return -(n + 1); }
    *used_words_out = total;
    celt_fe_plan_pack(n, arena, header);
    finish(false);
    return n;
}

// Batch entry: one call decodes every stream (OpenMP across streams).
// silk48 stride = frame48 * api_channels int16s.  Returns n on success or
// -(i+1) where stream i failed; per-stream rc values land in rcs[].
int opus_fe_decode_batch(void** handles, const uint8_t* data, const int32_t* lens,
                         int n, const int32_t* modes, const int32_t* bws,
                         int frame48, const int32_t* schs,
                         float* x_out, int64_t x_stride,
                         float* ble_out, int32_t* meta_out, float* gains_out,
                         int16_t* silk48_out, int64_t silk_stride,
                         uint32_t* ranges, int32_t* rcs) {
    std::vector<int64_t> offs(n + 1, 0);
    // lens[i] < 0 marks an FEC entry of |lens[i]| bytes (decode the
    // lost frame from that packet's SILK LBRR).
    for (int i = 0; i < n; i++) offs[i + 1] = offs[i] + std::abs(lens[i]);
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 8)
    for (int i = 0; i < n; i++) {
        int rc = opus_fe_decode(handles[i], data + offs[i], lens[i], modes[i], bws[i],
                                frame48, schs[i], x_out + (int64_t)i * x_stride,
                                ble_out + i * 2 * 21, meta_out + i * 16,
                                gains_out + i * 3, silk48_out + (int64_t)i * silk_stride,
                                &ranges[i]);
        rcs[i] = rc;
        if (rc != 0) {
#pragma omp critical
            bad = i + 1;
        }
    }
    return bad ? -bad : n;
}

}  // extern "C"
