// CELT bitstream front end (plane A) — native engine.
//
// Self-contained C++ translation of the validated Python front end
// (opus_tpu/celt/*.py, opus_tpu/rc/*.py), which is itself pinned
// bit-exact against libopus.  Decodes one CELT frame's symbols and emits
// the dense planes (normalised band coefficients, band log-energies,
// postfilter params, flags) consumed by the batched TPU synthesis kernel.
// No DSP here: synthesis runs on the device.
//
// Build: python opus_tpu/native/build.py  ->  libceltfe.so (ctypes).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>
#include <algorithm>

#include "celt_tables.h"

using namespace celt_tables;

#include "ec.h"

namespace {
using namespace opusfe;

// ---------------------------------------------------------------------------
// Bit-exact integer math helpers (opus_tpu/mathops.py).
// ---------------------------------------------------------------------------

static inline int16_t frac_mul16(int a, int b) {
    return (int16_t)((16384 + a * b) >> 15);
}
static int bitexact_cos(int x) {
    int x2 = x * x;
    int y = (int16_t)((x2 + 4096) >> 13);
    return (int16_t)(1 + (32767 - y) + frac_mul16(y, -7651 + frac_mul16(y, 8277 + frac_mul16(-626, y))));
}
static int bitexact_log2tan(int isin, int icos) {
    int ls = ilog32((uint32_t)isin);
    int lc = ilog32((uint32_t)icos);
    icos = (int16_t)(icos << (15 - lc));
    isin = (int16_t)(isin << (15 - ls));
    int a = frac_mul16(isin, frac_mul16(isin, -2597) + 7932);
    int b = frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
    return (ls - lc) * (1 << 11) + a - b;
}
static inline int celt_sudiv(int n, int d) {
    int q = std::abs(n) / d;
    return n < 0 ? -q : q;
}
static inline uint32_t lcg_rand(uint32_t seed) {
    return 1664525u * seed + 1013904223u;
}
static inline double celt_exp2d(double x) { return std::exp(0.6931471805599453094 * x); }

// ---------------------------------------------------------------------------
// CWRS: lazy saturating U rows (opus_tpu/celt/cwrs.py).
// ---------------------------------------------------------------------------

struct URows {
    std::vector<std::vector<uint64_t>> rows;
    static constexpr uint64_t SAT = ~0ull >> 1;

    static uint64_t sat_add(uint64_t a, uint64_t b) {
        uint64_t s = a + b;
        return (s < a || s > SAT) ? SAT : s;
    }
    const std::vector<uint64_t>& row(int n, int kmax) {
        if ((int)rows.size() <= n) rows.resize(n + 1);
        auto& r = rows[n];
        if ((int)r.size() > kmax) return r;
        if (n == 0) {
            if (r.empty()) r.push_back(1);
            r.resize(kmax + 1, 0);
            return r;
        }
        if (r.empty()) r.push_back(0);
        if (n == 1) {
            r.resize(kmax + 1, 1);
            return r;
        }
        const auto& prev = row(n - 1, kmax);
        for (int k = (int)r.size(); k <= kmax; k++)
            r.push_back(sat_add(sat_add(prev[k], r[k - 1]), prev[k - 1]));
        return r;
    }
    uint64_t u(int n, int k) {
        if (n < k) std::swap(n, k);
        return row(n, k)[k];
    }
    uint64_t v(int n, int k) { return sat_add(u(n, k), u(n, k + 1)); }
};

static URows g_urows;  // warmed read-only before decode (thread-safe after warm)

// Flat saturating-uint32 copy of the U triangle: g_U[n*U_STRIDE+k] =
// min(U(n,k), UINT32_MAX) for n in [0,256], k in [0,193].  cwrsi() only ever
// compares U values against a 32-bit index, so saturation preserves every
// comparison; the flat row layout turns the hot per-coefficient scans into
// linear walks of one cached row.
constexpr int U_NMAX = 256;
constexpr int U_KMAX = 193;
constexpr int U_STRIDE = U_KMAX + 1;
static std::vector<uint32_t> g_uflat;
// Flat u64 V(n,k) = U(n,k) + U(n,k+1) (saturating) for the decode_uint
// codebook sizes — avoids the vector-of-vectors walk in the hot path.
static std::vector<uint64_t> g_vflat;

static inline uint32_t u32sat(uint64_t v) {
    return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
}

static void warm_urows() {
    // Precompute every row reachable by the decoder: leaf sizes after the
    // split rule stay <= 176 dims and <= 128+1 pulses; 256/192 is safely
    // above.  After this, concurrent readers never mutate the table.
    static bool warmed = false;
    if (warmed) return;
    for (int n = 0; n <= U_NMAX; n++) g_urows.row(n, U_KMAX);
    g_uflat.assign((U_NMAX + 1) * U_STRIDE, 0);
    for (int n = 0; n <= U_NMAX; n++) {
        const auto& r = g_urows.rows[n];
        for (int k = 0; k <= U_KMAX; k++) g_uflat[n * U_STRIDE + k] = u32sat(r[k]);
    }
    g_vflat.assign((U_NMAX + 1) * U_STRIDE, 0);
    for (int n = 0; n <= U_NMAX; n++)
        for (int k = 0; k + 1 <= U_KMAX; k++) g_vflat[n * U_STRIDE + k] = g_urows.v(n, k);
    warmed = true;
}

static int get_pulses(int i) { return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1); }

// Index -> codeword (cwrsi).  y must hold n entries.  U(a,b) with a>=b is
// g_uflat row a at column b; both scan branches below walk the fixed row
// `n`, so one row pointer per outer iteration keeps the scans in cache.
static void cwrsi(int n, int k, uint32_t i, int32_t* y) {
    int out = 0;
    while (n > 2) {
        const uint32_t* row = &g_uflat[n * U_STRIDE];
        uint32_t p;
        int s, val, k0;
        if (k >= n) {
            // U(n, k+1) with k+1 possibly > n: pick the larger as the row.
            p = (k + 1 >= n) ? g_uflat[(k + 1) * U_STRIDE + n] : row[k + 1];
            s = i >= p;
            if (s) i -= p;
            k0 = k;
            uint32_t q = row[n];
            if (q > i) {
                k = n;
                do { k--; p = row[k]; } while (p > i);
            } else {
                for (;;) {
                    p = (k >= n) ? g_uflat[k * U_STRIDE + n] : row[k];
                    if (p <= i) break;
                    k--;
                }
            }
            i -= p;
            val = k0 - k;
            y[out] = s ? -val : val;
        } else {
            p = row[k];
            uint32_t q = row[k + 1];
            if (p <= i && i < q) {
                i -= p;
                y[out] = 0;
            } else {
                s = i >= q;
                if (s) i -= q;
                k0 = k;
                do { k--; p = row[k]; } while (p > i);
                i -= p;
                val = k0 - k;
                y[out] = s ? -val : val;
            }
        }
        out++;
        n--;
    }
    // n == 2
    {
        uint32_t p = 2u * k + 1;
        int s = i >= p;
        if (s) i -= p;
        int k0 = k;
        k = (i + 1) >> 1;
        if (k) i -= 2u * k - 1;
        int val = k0 - k;
        y[out] = s ? -val : val;
        out++;
    }
    // n == 1
    y[out] = i ? -k : k;
}

static uint32_t decode_pulses(RangeDec& dec, int n, int k, int32_t* y, uint64_t* ryy_out) {
    uint64_t vnk = (n <= U_NMAX && k + 1 <= U_KMAX) ? g_vflat[n * U_STRIDE + k]
                                                    : g_urows.v(n, k);
    uint32_t idx = dec.decode_uint((uint32_t)vnk);
    cwrsi(n, k, idx, y);
    uint64_t ryy = 0;
    for (int j = 0; j < n; j++) ryy += (int64_t)y[j] * y[j];
    *ryy_out = ryy;
    return idx;
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// Energy envelope decode (opus_tpu/celt/energy.py).  float32 arithmetic.
// ---------------------------------------------------------------------------

constexpr float PRED_COEF[4] = {0.8984375f, 0.796875f, 0.6484375f, 0.5f};
constexpr float BETA_COEF[4] = {30147.f / 32768.f, 22282.f / 32768.f, 12124.f / 32768.f, 6554.f / 32768.f};
constexpr float BETA_INTRA = 4915.f / 32768.f;

static void unquant_coarse_energy(RangeDec& dec, float old_ebands[2][NB_E_BANDS],
                                  int start, int end, bool intra, int lm, int channels) {
    const int16_t* prob = E_PROB_MODEL[lm][intra ? 1 : 0];
    float coef = intra ? 0.0f : PRED_COEF[lm];
    float beta = intra ? BETA_INTRA : BETA_COEF[lm];
    int budget = dec.storage * 8;
    float prev[2] = {0.0f, 0.0f};
    for (int band = start; band < end; band++) {
        for (int c = 0; c < channels; c++) {
            int tell = dec.tell();
            int qi;
            if (budget - tell >= 15) {
                int pi = 2 * std::min(band, 20);
                qi = decode_laplace(dec, (int)prob[pi] << 7, (int)prob[pi + 1] << 6);
            } else if (budget - tell >= 2) {
                qi = dec.decode_icdf(SMALL_ENERGY_ICDF, 2);
                qi = (qi >> 1) ^ -(qi & 1);
            } else if (budget - tell >= 1) {
                qi = -(int)dec.decode_bit_logp(1);
            } else {
                qi = -1;
            }
            float q = (float)qi;
            float old = std::max(-9.0f, old_ebands[c][band]);
            old_ebands[c][band] = coef * old + prev[c] + q;
            prev[c] = prev[c] + q - beta * q;
        }
    }
}

static void unquant_fine_energy(RangeDec& dec, float old_ebands[2][NB_E_BANDS],
                                const int* fine_quant, int start, int end, int channels) {
    for (int band = start; band < end; band++) {
        int bits = fine_quant[band];
        if (bits <= 0) continue;
        for (int c = 0; c < channels; c++) {
            int q2 = (int)dec.decode_bits(bits);
            float offset = ((float)q2 + 0.5f) * (float)(1 << (14 - bits)) * (1.0f / 16384.0f) - 0.5f;
            old_ebands[c][band] = old_ebands[c][band] + offset;
        }
    }
}

static void unquant_energy_finalise(RangeDec& dec, float old_ebands[2][NB_E_BANDS],
                                    const int* fine_quant, const int* fine_priority,
                                    int bits_left, int start, int end, int channels) {
    for (int prio = 0; prio < 2; prio++) {
        for (int band = start; band < end && bits_left >= channels; ) {
            if (fine_quant[band] >= MAX_FINE_BITS || fine_priority[band] != prio) { band++; continue; }
            for (int c = 0; c < channels; c++) {
                int q2 = (int)dec.decode_bits(1);
                float offset = ((float)q2 - 0.5f) * (float)(1 << (14 - fine_quant[band] - 1)) * (1.0f / 16384.0f);
                old_ebands[c][band] = old_ebands[c][band] + offset;
                bits_left -= 1;
            }
            band++;
        }
    }
}

// ---------------------------------------------------------------------------
// tf_decode (opus_tpu/celt/decoder.py).
// ---------------------------------------------------------------------------

static void tf_decode(int start, int end, bool is_transient, int* tf_res, int lm, RangeDec& dec) {
    int budget = dec.storage * 8;
    int tell = dec.tell();
    int logp = is_transient ? 2 : 4;
    int tf_select_rsv = (lm > 0 && tell + logp + 1 <= budget) ? 1 : 0;
    budget -= tf_select_rsv;
    int tf_changed = 0, curr = 0;
    for (int i = start; i < end; i++) {
        if (tell + logp <= budget) {
            curr ^= dec.decode_bit_logp(logp) ? 1 : 0;
            tell = dec.tell();
            tf_changed |= curr;
        }
        tf_res[i] = curr;
        logp = is_transient ? 4 : 5;
    }
    int tf_select = 0;
    int base = is_transient ? 4 : 0;
    if (tf_select_rsv &&
        TF_SELECT_TABLE[lm][base + 0 + tf_changed] != TF_SELECT_TABLE[lm][base + 2 + tf_changed]) {
        tf_select = dec.decode_bit_logp(1) ? 1 : 0;
    }
    for (int i = start; i < end; i++)
        tf_res[i] = TF_SELECT_TABLE[lm][base + 2 * tf_select + tf_res[i]];
}

// ---------------------------------------------------------------------------
// Allocation (opus_tpu/celt/rate.py).
// ---------------------------------------------------------------------------

constexpr int ALLOC_STEPS = 6;
constexpr int LOG_MAX_PSEUDO = 6;
constexpr int FINE_OFFSET = 21;

static void init_caps(int lm, int channels, int64_t* cap) {
    const uint8_t* caps_row = &CACHE_CAPS[(lm * 2 + (channels - 1)) * NB_E_BANDS];
    for (int j = 0; j < NB_E_BANDS; j++) {
        int64_t n = (int64_t)(E_BANDS[j + 1] - E_BANDS[j]) << lm;
        cap[j] = (((int64_t)caps_row[j] + 64) * channels * n) >> 2;
    }
}

static int bits2pulses(int band, int lm, int bits) {
    int cache_off = CACHE_INDEX[lm + 1][band];
    const uint8_t* cache = &CACHE_BITS[cache_off];
    int lo = 0, hi = cache[0];
    bits -= 1;
    for (int it = 0; it < LOG_MAX_PSEUDO; it++) {
        int mid = (lo + hi + 1) >> 1;
        if ((int)cache[mid] >= bits) hi = mid; else lo = mid;
    }
    int lo_cost = lo == 0 ? -1 : (int)cache[lo];
    return (bits - lo_cost <= (int)cache[hi] - bits) ? lo : hi;
}

static int pulses2bits(int band, int lm, int pulses) {
    if (pulses == 0) return 0;
    int cache_off = CACHE_INDEX[lm + 1][band];
    return (int)CACHE_BITS[cache_off + pulses] + 1;
}

struct AllocResult {
    int pulses[NB_E_BANDS];
    int ebits[NB_E_BANDS];
    int fine_priority[NB_E_BANDS];
    int coded_bands;
    int intensity;
    bool dual_stereo;
    int64_t balance;
};

static void interp_bits2pulses(int start, int end, int skip_start,
                               const int64_t* bits1, const int64_t* bits2,
                               const int64_t* thresh, const int64_t* cap,
                               int64_t total, int64_t skip_rsv,
                               int intensity, int64_t intensity_rsv,
                               bool dual_stereo, int64_t dual_stereo_rsv,
                               AllocResult& out, int C, int lm, RangeDec& ec) {
    int64_t alloc_floor = (int64_t)C << BITRES;
    int stereo = C > 1 ? 1 : 0;
    int log_m = lm << BITRES;
    int64_t bits[NB_E_BANDS] = {0};

    int lo = 0, hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        int64_t psum = 0;
        bool done = false;
        for (int j = end - 1; j >= start; j--) {
            int64_t tmp = bits1[j] + (((int64_t)mid * bits2[j]) >> ALLOC_STEPS);
            if (tmp >= thresh[j] || done) {
                done = true;
                psum += std::min(tmp, cap[j]);
            } else if (tmp >= alloc_floor) {
                psum += alloc_floor;
            }
        }
        if (psum > total) hi = mid; else lo = mid;
    }
    int64_t psum = 0;
    bool done = false;
    for (int j = end - 1; j >= start; j--) {
        int64_t tmp = bits1[j] + (((int64_t)lo * bits2[j]) >> ALLOC_STEPS);
        if (tmp < thresh[j] && !done) {
            tmp = tmp >= alloc_floor ? alloc_floor : 0;
        } else {
            done = true;
        }
        tmp = std::min(tmp, cap[j]);
        bits[j] = tmp;
        psum += tmp;
    }

    int coded_bands = end;
    for (;;) {
        int j = coded_bands - 1;
        if (j <= skip_start) { total += skip_rsv; break; }
        int64_t left = total - psum;
        int64_t denom = E_BANDS[coded_bands] - E_BANDS[start];
        int64_t percoeff = left / denom;
        left -= denom * percoeff;
        int64_t rem = std::max<int64_t>(left - (E_BANDS[j] - E_BANDS[start]), 0);
        int band_width = E_BANDS[coded_bands] - E_BANDS[j];
        int64_t band_bits = bits[j] + percoeff * band_width + rem;
        if (band_bits >= std::max(thresh[j], alloc_floor + (1 << BITRES))) {
            if (ec.decode_bit_logp(1)) break;
            psum += 1 << BITRES;
            band_bits -= 1 << BITRES;
        }
        psum -= bits[j] + intensity_rsv;
        if (intensity_rsv > 0) intensity_rsv = LOG2_FRAC_TABLE[j - start];
        psum += intensity_rsv;
        if (band_bits >= alloc_floor) {
            psum += alloc_floor;
            bits[j] = alloc_floor;
        } else {
            bits[j] = 0;
        }
        coded_bands--;
    }

    if (intensity_rsv > 0) {
        intensity = start + (int)ec.decode_uint((uint32_t)(coded_bands + 1 - start));
    } else {
        intensity = 0;
    }
    if (intensity <= start) {
        total += dual_stereo_rsv;
        dual_stereo_rsv = 0;
    }
    if (dual_stereo_rsv > 0) {
        dual_stereo = ec.decode_bit_logp(1);
    } else {
        dual_stereo = false;
    }

    int64_t left = total - psum;
    int64_t denom = E_BANDS[coded_bands] - E_BANDS[start];
    int64_t percoeff = left / denom;
    left -= denom * percoeff;
    for (int i = start; i < coded_bands; i++)
        bits[i] += percoeff * (E_BANDS[i + 1] - E_BANDS[i]);
    for (int i = start; i < coded_bands; i++) {
        int64_t tmp = std::min<int64_t>(left, E_BANDS[i + 1] - E_BANDS[i]);
        bits[i] += tmp;
        left -= tmp;
    }

    int64_t balance = 0;
    for (int i = start; i < coded_bands; i++) {
        int n0 = E_BANDS[i + 1] - E_BANDS[i];
        int n = n0 << lm;
        int64_t bit = bits[i] + balance;
        int64_t excess = 0;
        if (n > 1) {
            excess = std::max<int64_t>(bit - cap[i], 0);
            bits[i] = bit - excess;
            int den = C * n + ((C == 2 && n > 2 && !dual_stereo && i < intensity) ? 1 : 0);
            int64_t nclogn = (int64_t)den * (LOG_N[i] + log_m);
            int64_t offset = (nclogn >> 1) - (int64_t)den * FINE_OFFSET;
            if (n == 2) offset += ((int64_t)den << BITRES) >> 2;
            if (bits[i] + offset < ((int64_t)den * 2) << BITRES) offset += nclogn >> 2;
            else if (bits[i] + offset < ((int64_t)den * 3) << BITRES) offset += nclogn >> 3;
            int64_t eb = std::max<int64_t>(0, bits[i] + offset + ((int64_t)den << (BITRES - 1)));
            eb = (eb / den) >> BITRES;
            if ((int64_t)C * eb > (bits[i] >> BITRES)) eb = bits[i] >> stereo >> BITRES;
            eb = std::min<int64_t>(eb, MAX_FINE_BITS);
            out.fine_priority[i] = eb * ((int64_t)den << BITRES) >= bits[i] + offset ? 1 : 0;
            bits[i] -= ((int64_t)C * eb) << BITRES;
            out.ebits[i] = (int)eb;
        } else {
            excess = std::max<int64_t>(0, bit - ((int64_t)C << BITRES));
            bits[i] = bit - excess;
            out.ebits[i] = 0;
            out.fine_priority[i] = 1;
        }
        if (excess > 0) {
            int extra_fine = (int)std::min<int64_t>(excess >> (stereo + BITRES), MAX_FINE_BITS - out.ebits[i]);
            out.ebits[i] += extra_fine;
            int64_t extra_bits = ((int64_t)extra_fine * C) << BITRES;
            out.fine_priority[i] = extra_bits >= excess - balance ? 1 : 0;
            excess -= extra_bits;
        }
        balance = excess;
        out.pulses[i] = (int)bits[i];
    }
    for (int i = coded_bands; i < end; i++) {
        out.ebits[i] = (int)(bits[i] >> stereo >> BITRES);
        out.pulses[i] = 0;
        out.fine_priority[i] = out.ebits[i] < 1 ? 1 : 0;
    }
    out.coded_bands = coded_bands;
    out.intensity = intensity;
    out.dual_stereo = dual_stereo;
    out.balance = balance;
}

static void compute_allocation(int start, int end, const int64_t* offsets, const int64_t* cap,
                               int alloc_trim, int64_t total, int C, int lm,
                               RangeDec& ec, AllocResult& out) {
    total = std::max<int64_t>(total, 0);
    int skip_start = start;
    int64_t skip_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
    total -= skip_rsv;
    int64_t intensity_rsv = 0, dual_stereo_rsv = 0;
    if (C == 2) {
        intensity_rsv = LOG2_FRAC_TABLE[end - start];
        if (intensity_rsv > total) {
            intensity_rsv = 0;
        } else {
            total -= intensity_rsv;
            dual_stereo_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
            total -= dual_stereo_rsv;
        }
    }

    int64_t thresh[NB_E_BANDS], trim_offset[NB_E_BANDS];
    for (int j = start; j < end; j++) {
        int width = E_BANDS[j + 1] - E_BANDS[j];
        thresh[j] = std::max<int64_t>((int64_t)C << BITRES, ((int64_t)(3 * width) << lm << BITRES) >> 4);
        trim_offset[j] = ((int64_t)C * width * (alloc_trim - 5 - lm) * (end - j - 1) * (1 << (lm + BITRES))) >> 6;
        if ((width << lm) == 1) trim_offset[j] -= (int64_t)C << BITRES;
    }

    int lo = 1, hi = NB_ALLOC_VECTORS - 1;
    while (lo <= hi) {
        int mid = (lo + hi) >> 1;
        int64_t psum = 0;
        bool done = false;
        for (int j = end - 1; j >= start; j--) {
            int width = E_BANDS[j + 1] - E_BANDS[j];
            int64_t bitsj = ((int64_t)C * width * ALLOC_VECTORS[mid][j] << lm) >> 2;
            if (bitsj > 0) bitsj = std::max<int64_t>(0, bitsj + trim_offset[j]);
            bitsj += offsets[j];
            if (bitsj >= thresh[j] || done) {
                done = true;
                psum += std::min(bitsj, cap[j]);
            } else if (bitsj >= (int64_t)C << BITRES) {
                psum += (int64_t)C << BITRES;
            }
        }
        if (psum > total) hi = mid - 1; else lo = mid + 1;
    }
    hi = lo;
    lo -= 1;

    int64_t bits1[NB_E_BANDS] = {0}, bits2[NB_E_BANDS] = {0};
    for (int j = start; j < end; j++) {
        int width = E_BANDS[j + 1] - E_BANDS[j];
        int64_t bits1j = ((int64_t)C * width * ALLOC_VECTORS[lo][j] << lm) >> 2;
        int64_t bits2j = hi >= NB_ALLOC_VECTORS
                             ? cap[j]
                             : ((int64_t)C * width * ALLOC_VECTORS[hi][j] << lm) >> 2;
        if (bits1j > 0) bits1j = std::max<int64_t>(0, bits1j + trim_offset[j]);
        if (bits2j > 0) bits2j = std::max<int64_t>(0, bits2j + trim_offset[j]);
        if (lo > 0) bits1j += offsets[j];
        bits2j += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        bits2j = std::max<int64_t>(0, bits2j - bits1j);
        bits1[j] = bits1j;
        bits2[j] = bits2j;
    }
    interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh, cap, total, skip_rsv,
                       0, intensity_rsv, false, dual_stereo_rsv, out, C, lm, ec);
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// PVQ shape decode (opus_tpu/celt/vq.py), decode side only.
// ---------------------------------------------------------------------------

constexpr int SPREAD_NONE_ = 0;
constexpr int SPREAD_AGGRESSIVE_ = 3;
constexpr int SPREAD_FACTOR[3] = {15, 10, 5};
constexpr float EPSILON = 1e-15;

template <typename F>
static void exp_rotation1(F* x, int len, int stride, F c, F s) {
    F ms = -s;
    if (stride == 1) {
        // Forward pass: iteration i+1's x1 is the value just written to
        // x[i+1] — carry it in a register (same FP ops, one load less,
        // shorter address chain on the latency-bound recurrence).
        F x1 = x[0];
        for (int i = 0; i < len - 1; i++) {
            F x2 = x[i + 1];
            F nx2 = c * x2 + s * x1;
            x[i] = c * x1 + ms * x2;
            x[i + 1] = nx2;
            x1 = nx2;
        }
        // Backward pass: iteration i-1's x2 is the value just written to
        // x[i] — carry it the same way.
        if (len >= 3) {
            F x2 = x[len - 2];
            for (int i = len - 3; i >= 0; i--) {
                F x1b = x[i];
                x[i + 1] = c * x2 + s * x1b;
                F nx1 = c * x1b + ms * x2;
                x[i] = nx1;
                x2 = nx1;
            }
        }
        return;
    }
    for (int i = 0; i < len - stride; i++) {
        F x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 + ms * x2;
    }
    for (int i = len - 2 * stride - 1; i >= 0; i--) {
        F x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 + ms * x2;
    }
}

template <typename F>
static void exp_rotation(F* x, int len, int direction, int stride, int k, int spread) {
    if (2 * k >= len || spread == SPREAD_NONE_) return;
    int factor = SPREAD_FACTOR[spread - 1];
    F gain = (F)((double)len / (double)(len + factor * k));
    F theta = (F)(0.5 * (double)gain * (double)gain);
    F c = (F)std::cos(0.5 * M_PI * (double)theta);
    F s = (F)std::cos(0.5 * M_PI * (1.0 - (double)theta));
    int stride2 = 0;
    if (len >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len) stride2++;
    }
    len /= stride;
    for (int i = 0; i < stride; i++) {
        F* seg = x + i * len;
        if (direction < 0) {
            if (stride2) exp_rotation1(seg, len, stride2, s, c);
            exp_rotation1(seg, len, 1, c, s);
        } else {
            exp_rotation1(seg, len, 1, c, -s);
            if (stride2) exp_rotation1(seg, len, stride2, s, -c);
        }
    }
}

static uint32_t extract_collapse_mask(const int32_t* iy, int n, int b) {
    if (b <= 1) return 1;
    int n0 = n / b;
    uint32_t mask = 0;
    for (int i = 0; i < b; i++) {
        bool any = false;
        for (int j = 0; j < n0; j++) any |= iy[i * n0 + j] != 0;
        if (any) mask |= 1u << i;
    }
    return mask;
}

template <typename F>
static void renormalise_vector(F* x, int n, F gain) {
    F e = (F)EPSILON;
    for (int j = 0; j < n; j++) e += x[j] * x[j];
    F g = gain / std::sqrt(e);
    for (int j = 0; j < n; j++) x[j] *= g;
}

static uint32_t alg_unquant(float* x, int n, int k, int spread, int b, RangeDec& dec, float gain) {
    int32_t iy[256];
    uint64_t ryy;
    decode_pulses(dec, n, k, iy, &ryy);
    float g = gain / std::sqrt((float)ryy);
    for (int j = 0; j < n; j++) x[j] = g * iy[j];
    exp_rotation(x, n, -1, b, k, spread);
    return extract_collapse_mask(iy, n, b);
}

// ---------------------------------------------------------------------------
// Band coding (opus_tpu/celt/bands.py), decode side.
// ---------------------------------------------------------------------------

constexpr int QTHETA_OFFSET = 4;
constexpr int QTHETA_OFFSET_TWOPHASE = 16;

static const int ORDERY2[2] = {1, 0};
static const int ORDERY4[4] = {3, 0, 2, 1};
static const int ORDERY8[8] = {7, 0, 4, 3, 6, 1, 5, 2};
static const int ORDERY16[16] = {15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5};
static const int* ordery_for(int stride) {
    switch (stride) {
        case 2: return ORDERY2;
        case 4: return ORDERY4;
        case 8: return ORDERY8;
        default: return ORDERY16;
    }
}

constexpr uint8_t BIT_INTERLEAVE[16] = {0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3};
constexpr uint8_t BIT_DEINTERLEAVE[16] = {0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                                          0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF};
constexpr int EXP2_TABLE8[8] = {16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048};

template <typename F>
static void haar1(F* x, int n0, int stride) {
    n0 >>= 1;
    const F c = (F)0.70710678;
    for (int i = 0; i < stride; i++) {
        for (int j = 0; j < n0; j++) {
            int idx = i + stride * 2 * j;
            F a = c * x[idx];
            F b = c * x[idx + stride];
            x[idx] = a + b;
            x[idx + stride] = a - b;
        }
    }
}

template <typename F>
static void deinterleave_hadamard(F* x, int n0, int stride, bool hadamard, std::vector<F>& tmpbuf) {
    int n = n0 * stride;
    if ((int)tmpbuf.size() < n) tmpbuf.resize(n);
    F* tmp = tmpbuf.data();
    if (hadamard) {
        const int* ordery = ordery_for(stride);
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++) tmp[ordery[i] * n0 + j] = x[i + j * stride];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++) tmp[i * n0 + j] = x[i + j * stride];
    }
    std::memcpy(x, tmp, n * sizeof(F));
}

template <typename F>
static void interleave_hadamard(F* x, int n0, int stride, bool hadamard, std::vector<F>& tmpbuf) {
    int n = n0 * stride;
    if ((int)tmpbuf.size() < n) tmpbuf.resize(n);
    F* tmp = tmpbuf.data();
    if (hadamard) {
        const int* ordery = ordery_for(stride);
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++) tmp[i + j * stride] = x[ordery[i] * n0 + j];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++) tmp[i + j * stride] = x[i * n0 + j];
    }
    std::memcpy(x, tmp, n * sizeof(F));
}

static int compute_qn(int n, int b, int offset, int pulse_cap, bool stereo) {
    int n2 = 2 * n - 1;
    if (stereo && n == 2) n2--;
    int qb = celt_sudiv(b + n2 * offset, n2);
    qb = std::min(b - pulse_cap - (4 << BITRES), qb);
    qb = std::min(8 << BITRES, qb);
    if (qb < (1 << BITRES >> 1)) return 1;
    int qn = EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> BITRES));
    qn = ((qn + 1) >> 1) << 1;
    return qn;
}

static void stereo_merge(float* x, float* y, float mid, int n) {
    float xp = 0, side = 0;
    for (int j = 0; j < n; j++) { xp += y[j] * x[j]; side += y[j] * y[j]; }
    xp *= mid;
    float el = mid * mid + side - 2 * xp;
    float er = mid * mid + side + 2 * xp;
    if (er < 6e-4 || el < 6e-4) {
        std::memcpy(y, x, n * sizeof(float));
        return;
    }
    float lgain = 1.0 / std::sqrt(el);
    float rgain = 1.0 / std::sqrt(er);
    for (int j = 0; j < n; j++) {
        float l = mid * x[j];
        float r = y[j];
        x[j] = lgain * (l - r);
        y[j] = rgain * (l + r);
    }
}

static uint32_t isqrt32(uint32_t v) {
    uint32_t r = (uint32_t)std::sqrt((double)v);
    while (r > 0 && (uint64_t)r * r > v) r--;
    while ((uint64_t)(r + 1) * (r + 1) <= v) r++;
    return r;
}

// ---------------------------------------------------------------------------
// Plan emission (the "plan executor" transfer mode).
//
// Instead of uploading the decoded spectrum, plane A can emit the integer
// PVQ pulse vectors plus a compact execution plan; the device then replays
// normalise -> spreading rotation -> fold/noise fill -> interleave/haar undo
// -> stereo merge -> anti-collapse inside the jitted serving step
// (opus_tpu/dsp/plan_exec.py).  Cuts upload bytes ~1.7x vs the p10 packed
// spectrum and removes the spectral packer from the host's critical path.
// Reference anchor: the PVQ decode contract /root/reference/src/celt/pvc.rs
// :156-284 (cwrsi stays on host; everything after it moves on device).
//
// Record formats, v4 (contract shared with opus_tpu/dsp/plan_exec.py):
//   pvq leaf: ONE u32 word per record, sorted by (plane, dst).
//   dst/plane are NOT shipped: the leaves (pvq + zero + fill) tile each
//   coded plane contiguously from e[start], so the device derives
//   flatdst from the record lengths + the fills' pvq_before field (see
//   plan_exec.py make_plan_executor).  K is NOT shipped either: the
//   device derives it as sum(|iy|) from the pulse vector it unpacks
//   anyway.  Zero partitions (the !fill memset path) emit w==0 records
//   so the tiling has no holes.
//     bits [0:8]   n-1
//     bits [8:12]  w       (0 = zero partition: no iy bits, gain 0)
//     bits [12:16] Bq-1
//     bits [16:32] gain_f16
//   fill leaf (3 words, sorted by (plane, dst)):
//     w0: dst[0:11] | plane[11] | (n-1)[12:20] | is_noise[20] | norm2[21]
//         | pvq_before[22:31]  (# pvq/zero leaves sorted before this fill)
//     w1: srcrel[0:11] | gain_f16[16:32]  (srcrel only for folds)
//     w2: lcg seed *before* the leaf's first lcg_rand call
//   band (2 words x 21, STAGING only — the uploaded form packs w0 as-is
//   and the eff fields as a 21x11-bit stream, see frontend.py):
//     w0: recombine[0:2] | time_divide[2:4] | longblocks[4] | dual[5]
//         | int_switch[6] | inv[7] | imid[8:23] | stereo[23]
//     w1: cmask0[0:8] | cmask1[8:16] | eff_lowband[16:27] (0x7FF = none)
//   acent (2 words): w0: band[0:5] | ch[5] | mask[8:16] | r_f16[16:32]
//                    w1: lcg seed at this record's first draw
// Per-stream arena layout: [pvq 1w records][fill 3w records][acents 2w]
//   [iy words].
// iy: little-endian bit stream of per-leaf w-bit offset-binary pulses,
//   in sorted pvq-leaf order.

static uint32_t f32_to_f16_bits(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t e = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    uint32_t m = x & 0x7FFFFFu;
    if (e <= 0) {
        if (e < -10) return sign;
        m |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - e);
        uint32_t half = (m >> shift) + ((m >> (shift - 1)) & 1u);
        return sign | half;
    }
    if (e >= 31) return sign | 0x7C00u;
    uint32_t half = ((uint32_t)e << 10) | (m >> 13);
    half += (m >> 12) & 1u;  // round-to-nearest
    return sign | half;
}

struct PlanSink {
    struct PvqLeaf {
        int n, w, bq;      // w == 0 marks a zero partition
        uint32_t gain16;
        int iy_off;        // offset into iy_store
        int key;           // (plane << 11) | dst for sorting
    };
    struct FillLeaf {
        uint32_t w0, w1, seed;
        int key;
    };
    std::vector<PvqLeaf> pvq;
    std::vector<FillLeaf> fills;
    std::vector<int32_t> iy_store;
    uint32_t bands_w0[NB_E_BANDS];
    uint32_t bands_w1[NB_E_BANDS];
    std::vector<uint32_t> acents;
    const float* x0 = nullptr;  // X plane base
    const float* y0 = nullptr;  // Y plane base
    const float* lb0 = nullptr;  // current quant_band lowband base
    bool lb_norm2 = false;
    bool overflow = false;

    void reset(const float* x, const float* y) {
        pvq.clear();
        fills.clear();
        iy_store.clear();
        acents.clear();
        std::memset(bands_w0, 0, sizeof(bands_w0));
        for (int i = 0; i < NB_E_BANDS; i++) bands_w1[i] = 0x7FFu << 16;
        x0 = x;
        y0 = y;
        lb0 = nullptr;
        lb_norm2 = false;
        overflow = false;
    }

    // (plane, dst) of a leaf written at pointer p.
    bool locate(const float* p, int* plane, int* dst) {
        if (y0 && p >= y0) {
            *plane = 1;
            *dst = (int)(p - y0);
        } else {
            *plane = 0;
            *dst = (int)(p - x0);
        }
        return *dst >= 0 && *dst < 2048;
    }

    void emit_pvq(const float* x, int n, int k, int bq, float gain, const int32_t* iy) {
        int plane, dst;
        if (!locate(x, &plane, &dst) || n > 256 || k > 256 || bq > 16 || bq < 1) {
            overflow = true;
            return;
        }
        int maxa = 0;
        for (int j = 0; j < n; j++) maxa = std::max(maxa, std::abs((int)iy[j]));
        int w = 1;
        while ((1 << (w - 1)) - 1 < maxa) w++;  // offset-binary [-2^(w-1), 2^(w-1)-1]
        if (w > 15) {
            overflow = true;
            return;
        }
        PvqLeaf lf;
        lf.n = n;
        lf.w = w;
        lf.bq = bq;
        lf.gain16 = f32_to_f16_bits(gain);
        lf.iy_off = (int)iy_store.size();
        lf.key = (plane << 11) | dst;
        iy_store.insert(iy_store.end(), iy, iy + n);
        pvq.push_back(lf);
    }

    // Zero partition (quant_partition's !fill memset path): emitted so
    // the leaf tiling stays contiguous — the device derives every pvq
    // leaf's dst from the cumulative record lengths.  Adjacent zero
    // partitions merge into one record (recursion emits them in
    // position order) to bound the leaf-count inflation.
    void emit_zero(const float* x, int n) {
        int plane, dst;
        if (!locate(x, &plane, &dst) || n > 256) {
            overflow = true;
            return;
        }
        int key = (plane << 11) | dst;
        if (!pvq.empty()) {
            PvqLeaf& prev = pvq.back();
            if (prev.w == 0 && prev.key + prev.n == key && prev.n + n <= 256) {
                prev.n += n;
                return;
            }
        }
        PvqLeaf lf;
        lf.n = n;
        lf.w = 0;
        lf.bq = 1;
        lf.gain16 = 0;
        lf.iy_off = (int)iy_store.size();
        lf.key = key;
        pvq.push_back(lf);
    }

    void emit_fill(const float* x, int n, float gain, const float* lowband,
                   uint32_t seed_before) {
        int plane, dst;
        if (!locate(x, &plane, &dst) || n > 256) {
            overflow = true;
            return;
        }
        FillLeaf lf;
        uint32_t w1 = f32_to_f16_bits(gain) << 16;
        bool is_noise = lowband == nullptr;
        if (!is_noise) {
            int srcrel = (int)(lowband - lb0);
            if (srcrel < 0 || srcrel >= 2048 || !lb0) {
                overflow = true;
                return;
            }
            w1 |= (uint32_t)srcrel;
        }
        lf.w0 = (uint32_t)dst | ((uint32_t)plane << 11) | ((uint32_t)(n - 1) << 12) |
                (is_noise ? (1u << 20) : 0u) | (lb_norm2 ? (1u << 21) : 0u);
        lf.w1 = w1;
        lf.seed = seed_before;
        lf.key = (plane << 11) | dst;
        fills.push_back(lf);
    }

    void band_cfg(int band, int recombine, int time_divide, bool longblocks) {
        bands_w0[band] = (bands_w0[band] & ~0x1Fu) | (uint32_t)(recombine & 3) |
                         ((uint32_t)(time_divide & 3) << 2) | (longblocks ? 0x10u : 0u);
    }
    void band_stereo(int band, int imid, bool inv) {
        bands_w0[band] = (bands_w0[band] & ~(0xFFFFFFu << 7)) |
                         (inv ? (1u << 7) : 0u) | ((uint32_t)(imid & 0x7FFF) << 8) |
                         (1u << 23);
    }
    void band_flags(int band, bool dual, bool int_switch, int eff_lowband) {
        bands_w0[band] |= (dual ? (1u << 5) : 0u) | (int_switch ? (1u << 6) : 0u);
        uint32_t eff = eff_lowband < 0 ? 0x7FFu : (uint32_t)(eff_lowband & 0x7FF);
        bands_w1[band] = (bands_w1[band] & ~(0x7FFu << 16)) | (eff << 16);
    }
    void band_masks(int band, uint32_t cm0, uint32_t cm1) {
        bands_w1[band] = (bands_w1[band] & ~0xFFFFu) | (cm0 & 0xFF) | ((cm1 & 0xFF) << 8);
    }
    void emit_acent(int band, int ch, uint32_t mask, float r, uint32_t seed) {
        acents.push_back(((uint32_t)band & 0x1F) | ((uint32_t)ch << 5) |
                         ((mask & 0xFF) << 8) | (f32_to_f16_bits(r) << 16));
        acents.push_back(seed);
    }

    int pvq_words() const { return (int)pvq.size(); }  // one u32 per record (v4)
    int iy_bits() const {
        int64_t bits = 0;
        for (auto& l : pvq) bits += (int64_t)l.n * l.w;
        return (int)bits;
    }
    int iy_rel_words() const {
        return pvq_words() + 3 * (int)fills.size() + (int)acents.size();
    }
    int arena_words() const { return iy_rel_words() + (iy_bits() + 31) / 32; }

    // Pack into dst (arena_words() int32s); each table sorted by
    // (plane, dst) — the executor's scatter+cumsum position->leaf map
    // requires position order within each table.
    void pack(int32_t* dst) {
        std::vector<int> order(pvq.size());
        for (size_t i = 0; i < order.size(); i++) order[i] = (int)i;
        std::sort(order.begin(), order.end(),
                  [&](int a, int b) { return pvq[a].key < pvq[b].key; });
        std::sort(fills.begin(), fills.end(),
                  [](const FillLeaf& a, const FillLeaf& b) { return a.key < b.key; });
        int np = (int)pvq.size();
        int32_t* pw = dst;
        // pvq records: one u32 word each, sorted order (v4).
        for (int i = 0; i < np; i++) {
            const PvqLeaf& lf = pvq[order[i]];
            *pw++ = (int32_t)((uint32_t)(lf.n - 1) | ((uint32_t)lf.w << 8) |
                              ((uint32_t)(lf.bq - 1) << 12) |
                              ((uint32_t)lf.gain16 << 16));
        }
        // fills: stamp pvq_before (count of sorted pvq leaves whose key
        // precedes this fill) so the device can order the merged tiling.
        {
            size_t pi = 0;
            for (auto& f : fills) {
                while (pi < order.size() && pvq[order[pi]].key < f.key) pi++;
                f.w0 = (f.w0 & ~(0x1FFu << 22)) | (((uint32_t)pi & 0x1FF) << 22);
            }
        }
        for (auto& f : fills) {
            *pw++ = (int32_t)f.w0;
            *pw++ = (int32_t)f.w1;
            *pw++ = (int32_t)f.seed;
        }
        for (uint32_t a : acents) *pw++ = (int32_t)a;
        // iy bit stream in sorted pvq-leaf order (w==0 zero leaves ship
        // no bits).
        uint64_t cur = 0;
        int nbits = 0;
        for (int i = 0; i < np; i++) {
            const PvqLeaf& lf = pvq[order[i]];
            if (lf.w == 0) continue;
            uint32_t bias = 1u << (lf.w - 1);
            uint32_t msk = (1u << lf.w) - 1;
            for (int j = 0; j < lf.n; j++) {
                cur |= (uint64_t)(((uint32_t)(iy_store[lf.iy_off + j] + (int32_t)bias)) & msk)
                       << nbits;
                nbits += lf.w;
                if (nbits >= 32) {
                    *pw++ = (int32_t)(uint32_t)cur;
                    cur >>= 32;
                    nbits -= 32;
                }
            }
        }
        if (nbits) *pw++ = (int32_t)(uint32_t)cur;
    }
};

struct BandCtx {
    int band;
    int intensity;
    int spread;
    int tf_change;
    RangeDec* ec;
    int64_t remaining_bits;
    uint32_t seed;
    bool disable_inv;
    PlanSink* plan = nullptr;
    // Plan fast path: skip ALL float band math.  Safe because nothing on
    // the host consumes the float values in plan mode — fold content is
    // rebuilt on device from recorded seeds/srcrel, and no bitstream
    // decision depends on them.  Only the LCG consumption counts must be
    // replayed so st.rng stays exact.
    bool plan_skip = false;
};

struct SplitCtx {
    bool inv = false;
    int imid = 0, iside = 0, delta = 0, itheta = 0;
    int64_t qalloc = 0;
};

// Decode-side compute_theta.
static void compute_theta_dec(BandCtx& ctx, SplitCtx& sctx, int n, int64_t& b, int B, int B0,
                              int lm, bool stereo, uint32_t& fill) {
    RangeDec& ec = *ctx.ec;
    int band = ctx.band;
    int pulse_cap = LOG_N[band] + lm * (1 << BITRES);
    int offset = (pulse_cap >> 1) - ((stereo && n == 2) ? QTHETA_OFFSET_TWOPHASE : QTHETA_OFFSET);
    int qn = compute_qn(n, (int)b, offset, pulse_cap, stereo);
    if (stereo && band >= ctx.intensity) qn = 1;
    int itheta = 0;
    bool inv = false;
    uint32_t tell = ec.tell_frac();
    if (qn != 1) {
        if (stereo && n > 2) {
            const int p0 = 3;
            int x0 = qn / 2;
            uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
            uint32_t fs = ec.decode(ft);
            int t = fs < (uint32_t)((x0 + 1) * p0) ? (int)(fs / p0) : x0 + 1 + (int)(fs - (x0 + 1) * p0);
            uint32_t fl = t <= x0 ? (uint32_t)(p0 * t) : (uint32_t)((t - 1 - x0) + (x0 + 1) * p0);
            uint32_t fh = t <= x0 ? (uint32_t)(p0 * (t + 1)) : (uint32_t)((t - x0) + (x0 + 1) * p0);
            ec.update(fl, fh, ft);
            itheta = t;
        } else if (B0 > 1 || stereo) {
            itheta = (int)ec.decode_uint((uint32_t)qn + 1);
        } else {
            uint32_t ft = (uint32_t)(((qn >> 1) + 1) * ((qn >> 1) + 1));
            uint32_t fm = ec.decode(ft);
            uint32_t fl, fs;
            if (fm < (uint32_t)((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
                itheta = (int)((isqrt32(8 * fm + 1) - 1) >> 1);
                fs = itheta + 1;
                fl = (uint32_t)(itheta * (itheta + 1) >> 1);
            } else {
                itheta = (int)((2 * (qn + 1) - isqrt32(8 * (ft - fm - 1) + 1)) >> 1);
                fs = qn + 1 - itheta;
                fl = ft - (uint32_t)((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
            }
            ec.update(fl, fl + fs, ft);
        }
        itheta = (int)(((int64_t)itheta * 16384) / qn);
    } else if (stereo) {
        if (b > (int64_t)(2 << BITRES) && ctx.remaining_bits > (int64_t)(2 << BITRES)) {
            inv = ec.decode_bit_logp(2);
        } else {
            inv = false;
        }
        if (ctx.disable_inv) inv = false;
        itheta = 0;
    }
    int64_t qalloc = (int64_t)(int32_t)(ec.tell_frac() - tell);
    b -= qalloc;

    int imid, iside, delta;
    if (itheta == 0) {
        imid = 32767; iside = 0;
        fill &= (1u << B) - 1;
        delta = -16384;
    } else if (itheta == 16384) {
        imid = 0; iside = 32767;
        fill &= ((1u << B) - 1) << B;
        delta = 16384;
    } else {
        imid = bitexact_cos(itheta);
        iside = bitexact_cos(16384 - itheta);
        delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid));
    }
    sctx.inv = inv;
    sctx.imid = imid;
    sctx.iside = iside;
    sctx.delta = delta;
    sctx.itheta = itheta;
    sctx.qalloc = qalloc;
}

static uint32_t quant_band_n1(BandCtx& ctx, float* x, float* y, float* lowband_out) {
    if (ctx.plan) ctx.plan->overflow = true;  // n==1 bands never occur at 48 kHz
    float* vec = x;
    int count = y ? 2 : 1;
    for (int c = 0; c < count; c++) {
        int sign = 0;
        if (ctx.remaining_bits >= (1 << BITRES)) {
            sign = (int)ctx.ec->decode_bits(1);
            ctx.remaining_bits -= 1 << BITRES;
        }
        vec[0] = sign ? -1.0 : 1.0;
        vec = y;
    }
    if (lowband_out) lowband_out[0] = x[0];
    return 1;
}

static uint32_t quant_partition(BandCtx& ctx, float* x, int n, int64_t b, int B,
                                float* lowband, int lm, float gain, uint32_t fill) {
    int band = ctx.band;
    int B0 = B;
    int cache_off = CACHE_INDEX[lm + 1][band];
    const uint8_t* cache = CACHE_BITS;
    if (lm != -1 && b > (int64_t)cache[cache_off + cache[cache_off]] + 12 && n > 2) {
        n >>= 1;
        float* y = x + n;
        lm -= 1;
        if (B == 1) fill = (fill & 1) | (fill << 1);
        B = (B + 1) >> 1;

        SplitCtx sctx;
        compute_theta_dec(ctx, sctx, n, b, B, B0, lm, false, fill);
        int imid = sctx.imid, iside = sctx.iside;
        int64_t delta = sctx.delta;
        int itheta = sctx.itheta;
        int64_t qalloc = sctx.qalloc;
        float mid = imid / 32768.0;
        float side = iside / 32768.0;

        if (B0 > 1 && (itheta & 0x3FFF)) {
            if (itheta > 8192) {
                delta -= delta >> (4 - lm);
            } else {
                delta = std::min<int64_t>(0, delta + ((int64_t)n << BITRES >> (5 - lm)));
            }
        }
        int64_t mbits = std::max<int64_t>(0, std::min<int64_t>(b, celt_sudiv((int)(b - delta), 2)));
        int64_t sbits = b - mbits;
        ctx.remaining_bits -= qalloc;

        float* next_lowband2 = lowband ? lowband + n : nullptr;
        int64_t rebalance = ctx.remaining_bits;
        uint32_t cm;
        if (mbits >= sbits) {
            cm = quant_partition(ctx, x, n, mbits, B, lowband, lm, gain * mid, fill);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > (int64_t)(3 << BITRES) && itheta != 0)
                sbits += rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, y, n, sbits, B, next_lowband2, lm, gain * side, fill >> B) << (B0 >> 1);
        } else {
            cm = quant_partition(ctx, y, n, sbits, B, next_lowband2, lm, gain * side, fill >> B) << (B0 >> 1);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > (int64_t)(3 << BITRES) && itheta != 16384)
                mbits += rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, x, n, mbits, B, lowband, lm, gain * mid, fill);
        }
        return cm;
    }

    // Leaf.
    int q = bits2pulses(band, lm, (int)b);
    int curr_bits = pulses2bits(band, lm, q);
    ctx.remaining_bits -= curr_bits;
    while (ctx.remaining_bits < 0 && q > 0) {
        ctx.remaining_bits += curr_bits;
        q--;
        curr_bits = pulses2bits(band, lm, q);
        ctx.remaining_bits -= curr_bits;
    }
    if (q != 0) {
        int k = get_pulses(q);
        if (ctx.plan) {
            // Plan mode: record the integer pulse vector + leaf params; the
            // debug path (plan_skip=false) still produces the float content
            // the executor conformance tests compare against.
            int32_t iy[256];
            uint64_t ryy;
            decode_pulses(*ctx.ec, n, k, iy, &ryy);
            ctx.plan->emit_pvq(x, n, k, B, gain, iy);
            if (!ctx.plan_skip) {
                float g = gain / std::sqrt((float)ryy);
                for (int j = 0; j < n; j++) x[j] = g * iy[j];
                exp_rotation(x, n, -1, B, k, ctx.spread);
            }
            return extract_collapse_mask(iy, n, B);
        }
        return alg_unquant(x, n, k, ctx.spread, B, *ctx.ec, gain);
    }
    uint32_t cm_mask = (1u << B) - 1;
    fill &= cm_mask;
    uint32_t cm = 0;
    if (!fill) {
        // Zero partition: emit a w==0 leaf so the plan's tiling stays
        // contiguous (the device derives pvq dst from cumulative lengths).
        if (ctx.plan) ctx.plan->emit_zero(x, n);
        if (!ctx.plan_skip) std::memset(x, 0, n * sizeof(float));
    } else {
        if (ctx.plan) ctx.plan->emit_fill(x, n, gain, lowband, ctx.seed);
        if (ctx.plan_skip) {
            // Only the LCG consumption count matters on the fast path.
            for (int j = 0; j < n; j++) ctx.seed = lcg_rand(ctx.seed);
            return lowband == nullptr ? cm_mask : fill;
        }
        if (lowband == nullptr) {
            for (int j = 0; j < n; j++) {
                ctx.seed = lcg_rand(ctx.seed);
                x[j] = (float)((int32_t)ctx.seed >> 20);
            }
            cm = cm_mask;
        } else {
            for (int j = 0; j < n; j++) {
                ctx.seed = lcg_rand(ctx.seed);
                float tmp = 1.0 / 256.0;
                if (!(ctx.seed & 0x8000)) tmp = -tmp;
                x[j] = lowband[j] + tmp;
            }
            cm = fill;
        }
        renormalise_vector(x, n, gain);
    }
    return cm;
}

static uint32_t quant_band(BandCtx& ctx, float* x, int n, int64_t b, int B,
                           float* lowband, int lm, float* lowband_out, float gain,
                           float* lowband_scratch, uint32_t fill, std::vector<float>& tmpbuf) {
    int n0 = n;
    int n_b = n / B;
    int B0 = B;
    int time_divide = 0;
    int recombine = 0;
    bool long_blocks = B0 == 1;
    int tf_change = ctx.tf_change;

    if (n == 1) return quant_band_n1(ctx, x, nullptr, lowband_out);

    if (tf_change > 0) recombine = tf_change;

    bool skip = ctx.plan_skip;
    if (!skip && lowband_scratch && lowband &&
        (recombine || ((n_b & 1) == 0 && tf_change < 0) || B0 > 1)) {
        std::memcpy(lowband_scratch, lowband, n * sizeof(float));
        lowband = lowband_scratch;
    }
    if (ctx.plan) ctx.plan->lb0 = lowband;  // srcrel base for this band's folds

    for (int k = 0; k < recombine; k++) {
        if (lowband && !skip) haar1(lowband, n >> k, 1 << k);
        fill = BIT_INTERLEAVE[fill & 0xF] | (uint32_t)BIT_INTERLEAVE[fill >> 4] << 2;
    }
    B >>= recombine;
    n_b <<= recombine;

    while ((n_b & 1) == 0 && tf_change < 0) {
        if (lowband && !skip) haar1(lowband, n_b, B);
        fill |= fill << B;
        B <<= 1;
        n_b >>= 1;
        time_divide++;
        tf_change++;
    }
    B0 = B;
    int n_b0 = n_b;

    if (B0 > 1 && lowband && !skip)
        deinterleave_hadamard(lowband, n_b >> recombine, B0 << recombine, long_blocks, tmpbuf);

    if (ctx.plan) ctx.plan->band_cfg(ctx.band, recombine, time_divide, long_blocks);
    uint32_t cm = quant_partition(ctx, x, n, b, B, lowband, lm, gain, fill);

    // Resynthesis reshaping (decode side always resynthesises).
    if (B0 > 1 && !skip)
        interleave_hadamard(x, n_b >> recombine, B0 << recombine, long_blocks, tmpbuf);
    n_b = n_b0;
    B = B0;
    for (int k = 0; k < time_divide; k++) {
        B >>= 1;
        n_b <<= 1;
        cm |= cm >> B;
        if (!skip) haar1(x, n_b, B);
    }
    for (int k = 0; k < recombine; k++) {
        cm = BIT_DEINTERLEAVE[cm];
        if (!skip) haar1(x, n0 >> k, 1 << k);
    }
    B <<= recombine;

    if (lowband_out && !skip) {
        float scale = std::sqrt((float)n0);
        for (int j = 0; j < n0; j++) lowband_out[j] = scale * x[j];
    }
    cm &= (1u << B) - 1;
    return cm;
}

static uint32_t quant_band_stereo(BandCtx& ctx, float* x, float* y, int n, int64_t b, int B,
                                  float* lowband, int lm, float* lowband_out,
                                  float* lowband_scratch, uint32_t fill, std::vector<float>& tmpbuf) {
    if (n == 1) return quant_band_n1(ctx, x, y, lowband_out);

    uint32_t orig_fill = fill;
    SplitCtx sctx;
    compute_theta_dec(ctx, sctx, n, b, B, B, lm, true, fill);
    bool inv = sctx.inv;
    int imid = sctx.imid, iside = sctx.iside;
    int64_t delta = sctx.delta;
    int itheta = sctx.itheta;
    int64_t qalloc = sctx.qalloc;
    float mid = imid / 32768.0;
    float side = iside / 32768.0;
    uint32_t cm;
    if (ctx.plan) {
        ctx.plan->band_stereo(ctx.band, imid, inv);
        if (n == 2) ctx.plan->overflow = true;  // whole bands of n==2: not at 48 kHz
    }

    if (n == 2) {
        int64_t mbits = b;
        int64_t sbits = 0;
        if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
        mbits -= sbits;
        bool c = itheta > 8192;
        ctx.remaining_bits -= qalloc + sbits;
        float* x2 = c ? y : x;
        float* y2 = c ? x : y;
        int sign = 0;
        if (sbits) sign = (int)ctx.ec->decode_bits(1);
        sign = 1 - 2 * sign;
        cm = quant_band(ctx, x2, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, orig_fill, tmpbuf);
        y2[0] = -sign * x2[1];
        y2[1] = sign * x2[0];
        x[0] = mid * x[0];
        x[1] = mid * x[1];
        y[0] = side * y[0];
        y[1] = side * y[1];
        float tmp = x[0];
        x[0] = tmp - y[0];
        y[0] = tmp + y[0];
        tmp = x[1];
        x[1] = tmp - y[1];
        y[1] = tmp + y[1];
    } else {
        int64_t mbits = std::max<int64_t>(0, std::min<int64_t>(b, celt_sudiv((int)(b - delta), 2)));
        int64_t sbits = b - mbits;
        ctx.remaining_bits -= qalloc;
        int64_t rebalance = ctx.remaining_bits;
        if (mbits >= sbits) {
            cm = quant_band(ctx, x, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, fill, tmpbuf);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > (int64_t)(3 << BITRES) && itheta != 0)
                sbits += rebalance - (3 << BITRES);
            cm |= quant_band(ctx, y, n, sbits, B, nullptr, lm, nullptr, side, nullptr, fill >> B, tmpbuf);
        } else {
            cm = quant_band(ctx, y, n, sbits, B, nullptr, lm, nullptr, side, nullptr, fill >> B, tmpbuf);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > (int64_t)(3 << BITRES) && itheta != 16384)
                mbits += rebalance - (3 << BITRES);
            cm |= quant_band(ctx, x, n, mbits, B, lowband, lm, lowband_out, 1.0, lowband_scratch, fill, tmpbuf);
        }
    }
    if (!ctx.plan_skip) {
        if (n != 2) stereo_merge(x, y, mid, n);
        if (inv)
            for (int j = 0; j < n; j++) y[j] = -y[j];
    }
    return cm;
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// quant_all_bands + anti_collapse (opus_tpu/celt/bands.py), decode side.
// ---------------------------------------------------------------------------

static uint32_t quant_all_bands_dec(int start, int end, float* x_, float* y_,
                                    int32_t collapse_masks[NB_E_BANDS][2],
                                    const int* pulses, bool short_blocks, int spread,
                                    bool dual_stereo, int intensity, const int* tf_res,
                                    int64_t total_bits, int64_t balance, RangeDec& ec,
                                    int lm, int coded_bands, uint32_t seed, bool disable_inv,
                                    PlanSink* plan = nullptr, bool plan_skip = false) {
    int M = 1 << lm;
    int B = short_blocks ? M : 1;
    int C = y_ ? 2 : 1;
    int norm_offset = M * E_BANDS[start];
    int norm_len = M * E_BANDS[NB_E_BANDS - 1] - norm_offset;
    static thread_local std::vector<float> norm_buf, norm2_buf, scratch_buf, tmpbuf;
    norm_buf.assign(norm_len, 0.0);
    float* norm = norm_buf.data();
    float* norm2 = norm;
    if (C == 2) {
        norm2_buf.assign(norm_len, 0.0);
        norm2 = norm2_buf.data();
    }
    scratch_buf.assign(M * (E_BANDS[NB_E_BANDS] - E_BANDS[NB_E_BANDS - 1]), 0.0);

    BandCtx ctx;
    ctx.band = 0;
    ctx.intensity = intensity;
    ctx.spread = spread;
    ctx.tf_change = 0;
    ctx.ec = &ec;
    ctx.remaining_bits = 0;
    ctx.seed = seed;
    ctx.disable_inv = disable_inv;
    ctx.plan = plan;
    ctx.plan_skip = plan != nullptr && plan_skip;
    if (plan) plan->reset(x_, y_);

    int lowband_offset = 0;
    bool update_lowband = true;
    for (int i = start; i < end; i++) {
        ctx.band = i;
        bool last = i == end - 1;
        float* X = x_ + M * E_BANDS[i];
        float* Y = y_ ? y_ + M * E_BANDS[i] : nullptr;
        int n = M * E_BANDS[i + 1] - M * E_BANDS[i];
        int64_t tell = (int64_t)(int32_t)ec.tell_frac();

        if (i != start) balance -= tell;
        int64_t remaining_bits = total_bits - tell - 1;
        ctx.remaining_bits = remaining_bits;
        int64_t b = 0;
        if (i <= coded_bands - 1) {
            int64_t curr_balance = celt_sudiv((int)balance, std::min(3, coded_bands - i));
            b = std::max<int64_t>(0, std::min<int64_t>(16383,
                    std::min<int64_t>(remaining_bits + 1, pulses[i] + curr_balance)));
        }

        if ((M * E_BANDS[i] - n >= M * E_BANDS[start] || i == start + 1) &&
            (update_lowband || lowband_offset == 0))
            lowband_offset = i;
        if (i == start + 1) {
            // special_hybrid_folding
            int n1 = M * (E_BANDS[start + 1] - E_BANDS[start]);
            int n2 = M * (E_BANDS[start + 2] - E_BANDS[start + 1]);
            std::memcpy(norm + n1, norm + 2 * n1 - n2, (n2 - n1) * sizeof(float));
            if (dual_stereo)
                std::memcpy(norm2 + n1, norm2 + 2 * n1 - n2, (n2 - n1) * sizeof(float));
        }

        ctx.tf_change = tf_res[i];
        float* scratch = scratch_buf.data();
        if (i >= EFF_E_BANDS) {
            X = norm;
            Y = y_ ? norm : nullptr;
            scratch = nullptr;
        }
        if (last) scratch = nullptr;

        int effective_lowband = -1;
        uint32_t x_cm, y_cm;
        if (lowband_offset != 0 && (spread != SPREAD_AGGRESSIVE_ || B > 1 || ctx.tf_change < 0)) {
            effective_lowband = std::max(0, M * E_BANDS[lowband_offset] - norm_offset - n);
            int fold_start = lowband_offset - 1;
            while (M * E_BANDS[fold_start] > effective_lowband + norm_offset) fold_start--;
            int fold_end = lowband_offset - 1;
            do {
                fold_end++;
            } while (fold_end < i && M * E_BANDS[fold_end] < effective_lowband + norm_offset + n);
            x_cm = y_cm = 0;
            for (int fi = fold_start; fi < std::max(fold_end, fold_start + 1); fi++) {
                x_cm |= (uint32_t)collapse_masks[fi][0];
                y_cm |= (uint32_t)collapse_masks[fi][C - 1];
            }
        } else {
            x_cm = y_cm = (1u << B) - 1;
        }

        bool int_switch = dual_stereo && i == intensity;
        if (int_switch) {
            dual_stereo = false;
            if (!ctx.plan_skip) {
                int upto = M * E_BANDS[i] - norm_offset;
                for (int j = 0; j < upto; j++) norm[j] = 0.5 * (norm[j] + norm2[j]);
            }
        }
        if (plan) plan->band_flags(i, dual_stereo, int_switch, effective_lowband);

        float* lowband = effective_lowband != -1 ? norm + effective_lowband : nullptr;
        float* lowband2 = effective_lowband != -1 ? norm2 + effective_lowband : nullptr;
        float* lowband_out = last ? nullptr : norm + (M * E_BANDS[i] - norm_offset);
        float* lowband_out2 = last ? nullptr : norm2 + (M * E_BANDS[i] - norm_offset);

        if (dual_stereo) {
            x_cm = quant_band(ctx, X, n, b / 2, B, lowband, lm, lowband_out, 1.0, scratch, x_cm, tmpbuf);
            if (plan) plan->lb_norm2 = true;
            y_cm = quant_band(ctx, Y, n, b / 2, B, lowband2, lm, lowband_out2, 1.0, scratch, y_cm, tmpbuf);
            if (plan) plan->lb_norm2 = false;
        } else {
            if (Y) {
                x_cm = quant_band_stereo(ctx, X, Y, n, b, B, lowband, lm, lowband_out, scratch, x_cm | y_cm, tmpbuf);
            } else {
                x_cm = quant_band(ctx, X, n, b, B, lowband, lm, lowband_out, 1.0, scratch, x_cm, tmpbuf);
            }
            y_cm = x_cm;
        }
        collapse_masks[i][0] = (int32_t)(x_cm & 0xFF);
        collapse_masks[i][C - 1] = (int32_t)(y_cm & 0xFF);
        if (plan) plan->band_masks(i, x_cm & 0xFF, y_cm & 0xFF);
        balance += pulses[i] + tell;
        update_lowband = b > ((int64_t)n << BITRES);
    }
    return ctx.seed;
}

static uint32_t anti_collapse_c(float* x_, const int32_t collapse_masks[NB_E_BANDS][2],
                                int lm, int C, int size, int start, int end,
                                const float log_e[2][NB_E_BANDS],
                                const float prev1_log_e[2][NB_E_BANDS],
                                const float prev2_log_e[2][NB_E_BANDS],
                                const int* pulses, uint32_t seed,
                                PlanSink* plan = nullptr, bool plan_skip = false) {
    for (int i = start; i < end; i++) {
        int n0 = E_BANDS[i + 1] - E_BANDS[i];
        int depth = ((1 + pulses[i]) / n0) >> lm;
        float thresh = 0.5 * celt_exp2d(-0.125 * depth);
        float sqrt_1 = 1.0 / std::sqrt((float)(n0 << lm));
        for (int c = 0; c < C; c++) {
            float prev1 = prev1_log_e[c][i];
            float prev2 = prev2_log_e[c][i];
            if (C == 1) {
                prev1 = std::max(prev1, prev1_log_e[1][i]);
                prev2 = std::max(prev2, prev2_log_e[1][i]);
            }
            float ediff = std::max(0.0f, (float)log_e[c][i] - (float)std::min(prev1, prev2));
            float r = 2.0 * celt_exp2d(-ediff);
            if (lm == 3) r *= 1.41421356;
            r = std::min(thresh, r) * sqrt_1;
            int base = c * size + (E_BANDS[i] << lm);
            bool renorm = false;
            if (plan) {
                uint32_t m = 0;
                for (int k = 0; k < (1 << lm); k++)
                    if (collapse_masks[i][c] & (1 << k)) m |= 1u << k;
                if (m != ((1u << (1 << lm)) - 1))
                    plan->emit_acent(i, c, m, r, seed);
            }
            for (int k = 0; k < (1 << lm); k++) {
                if (!(collapse_masks[i][c] & (1 << k))) {
                    if (plan_skip) {
                        for (int j = 0; j < n0; j++) seed = lcg_rand(seed);
                    } else {
                        for (int j = 0; j < n0; j++) {
                            seed = lcg_rand(seed);
                            x_[base + (j << lm) + k] = (seed & 0x8000) ? r : -r;
                        }
                    }
                    renorm = true;
                }
            }
            if (renorm && !plan_skip) renormalise_vector(x_ + base, n0 << lm, 1.0f);
        }
    }
    return seed;
}

// ---------------------------------------------------------------------------
// Front-end state + frame decode (opus_tpu/celt/decoder.py, plane path).
// ---------------------------------------------------------------------------

constexpr int SPREAD_NORMAL = 2;
constexpr int MIN_PERIOD = 15;

struct FrontEnd {
    int channels;
    int downsample;
    int start_band;
    int end_band;
    bool disable_inv;
    uint32_t rng;
    float old_band_e[2][NB_E_BANDS];
    float old_log_e[2][NB_E_BANDS];
    float old_log_e2[2][NB_E_BANDS];
    float background_log_e[2][NB_E_BANDS];
    int postfilter_period, postfilter_period_old;
    double postfilter_gain, postfilter_gain_old;
    int postfilter_tapset, postfilter_tapset_old;
    int loss_duration;  // lost time in 2.5 ms units (libopus 1.3 semantics)
    bool skip_plc;      // set on the first good frame after a loss run:
                        // the next loss then conceals noise-based (libopus)
    bool error;

    void reset() {
        std::memset(old_band_e, 0, sizeof(old_band_e));
        for (int c = 0; c < 2; c++)
            for (int j = 0; j < NB_E_BANDS; j++) {
                old_log_e[c][j] = -28.0f;
                old_log_e2[c][j] = -28.0f;
                // libopus clears backgroundLogE to 0 (not -28): the noise
                // floor tracker falls instantly but rises at 2.4 dB/s, so
                // the init value is the FIRST frames' concealment floor.
                // Verified sample-exact against libopus 1.3.1 deep-loss
                // concealment (tests/test_celt_decoder.py PLC suite).
                background_log_e[c][j] = 0.0f;
            }
        postfilter_period = postfilter_period_old = 0;
        postfilter_gain = postfilter_gain_old = 0.0;
        postfilter_tapset = postfilter_tapset_old = 0;
        loss_duration = 0;
        skip_plc = false;
        rng = 0;
        error = false;
    }
};

// meta layout (int32): 0 silence, 1 short_blocks, 2 lm, 3 stream_channels,
// 4 start, 5 eff_end, 6 pf_period0, 7 pf_period1, 8 pf_period2,
// 9 pf_tapset0, 10 pf_tapset1, 11 pf_tapset2, 12 error
// pf_gains (double[3]): gain0, gain1, gain2

static int decode_frame_ec(FrontEnd& st, RangeDec& dec, int frame_bytes, int frame_size48,
                           int stream_channels, float* x_out, float* band_log_e_out,
                           int32_t* meta, double* pf_gains, PlanSink* plan = nullptr,
                           bool plan_skip = false) {
    // dec is already initialised (and, for hybrid frames, advanced past the
    // SILK symbols — the shared-range-coder contract, decoder.rs:603/:711).
    int frame_size = frame_size48;  // caller passes samples at 48 kHz
    int lm = -1;
    for (int l = 0; l <= MAX_LM; l++)
        if (SHORT_MDCT_SIZE << l == frame_size) { lm = l; break; }
    if (lm < 0 || frame_bytes < 2 || frame_bytes > 1275) return -1;
    int m = 1 << lm;
    int n = m * SHORT_MDCT_SIZE;
    int c_ = stream_channels;
    int cc = st.channels;
    int start = st.start_band, end = st.end_band;
    int eff_end = std::min(end, (int)EFF_E_BANDS);

    float(*old_band_e)[NB_E_BANDS] = st.old_band_e;
    if (c_ == 1)
        for (int j = 0; j < NB_E_BANDS; j++)
            old_band_e[0][j] = std::max(old_band_e[0][j], old_band_e[1][j]);

    st.skip_plc = st.loss_duration != 0;
    int total_bits = frame_bytes * 8;
    int tell = dec.tell();
    bool silence;
    if (tell >= total_bits) silence = true;
    else if (tell == 1) silence = dec.decode_bit_logp(15);
    else silence = false;
    if (silence) {
        dec.bits_total += total_bits - dec.tell();
        tell = total_bits;
    }

    double postfilter_gain = 0.0;
    int postfilter_pitch = 0;
    int postfilter_tapset = 0;
    if (start == 0 && tell + 16 <= total_bits) {
        if (dec.decode_bit_logp(1)) {
            int octave = (int)dec.decode_uint(6);
            postfilter_pitch = (16 << octave) + (int)dec.decode_bits(4 + octave) - 1;
            int qg = (int)dec.decode_bits(3);
            if (dec.tell() + 2 <= total_bits)
                postfilter_tapset = dec.decode_icdf(TAPSET_ICDF, 2);
            postfilter_gain = 0.09375 * (qg + 1);
        }
        tell = dec.tell();
    }

    bool is_transient = false;
    if (lm > 0 && tell + 3 <= total_bits) {
        is_transient = dec.decode_bit_logp(3);
        tell = dec.tell();
    }
    bool short_blocks = is_transient;

    bool intra_ener = tell + 3 <= total_bits ? dec.decode_bit_logp(3) : false;
    unquant_coarse_energy(dec, old_band_e, start, end, intra_ener, lm, c_);

    int tf_res[NB_E_BANDS] = {0};
    tf_decode(start, end, is_transient, tf_res, lm, dec);

    tell = dec.tell();
    int spread_decision = SPREAD_NORMAL;
    if (tell + 4 <= total_bits) spread_decision = dec.decode_icdf(SPREAD_ICDF, 5);

    int64_t cap[NB_E_BANDS];
    init_caps(lm, c_, cap);

    int64_t offsets[NB_E_BANDS] = {0};
    int dynalloc_logp = 6;
    int64_t total_bits_frac = (int64_t)total_bits << BITRES;
    int64_t tell_frac = (int64_t)(int32_t)dec.tell_frac();
    for (int i = start; i < end; i++) {
        int width = (c_ * (E_BANDS[i + 1] - E_BANDS[i])) << lm;
        int64_t quanta = std::min<int64_t>((int64_t)width << BITRES,
                                           std::max<int64_t>(6 << BITRES, width));
        int dynalloc_loop_logp = dynalloc_logp;
        int64_t boost = 0;
        while (tell_frac + ((int64_t)dynalloc_loop_logp << BITRES) < total_bits_frac && boost < cap[i]) {
            bool flag = dec.decode_bit_logp(dynalloc_loop_logp);
            tell_frac = (int64_t)(int32_t)dec.tell_frac();
            if (!flag) break;
            boost += quanta;
            total_bits_frac -= quanta;
            dynalloc_loop_logp = 1;
        }
        offsets[i] = boost;
        if (boost > 0) dynalloc_logp = std::max(2, dynalloc_logp - 1);
    }

    int alloc_trim = 5;
    if (tell_frac + (6 << BITRES) <= total_bits_frac)
        alloc_trim = dec.decode_icdf(TRIM_ICDF, 7);

    int64_t bits = ((int64_t)frame_bytes * 8 << BITRES) - (int64_t)(int32_t)dec.tell_frac() - 1;
    int64_t anti_collapse_rsv =
        (is_transient && lm >= 2 && bits >= ((int64_t)(lm + 2) << BITRES)) ? (1 << BITRES) : 0;
    bits -= anti_collapse_rsv;

    AllocResult alloc;
    compute_allocation(start, end, offsets, cap, alloc_trim, bits, c_, lm, dec, alloc);

    unquant_fine_energy(dec, old_band_e, alloc.ebits, start, end, c_);

    int32_t collapse_masks[NB_E_BANDS][2];
    std::memset(collapse_masks, 0, sizeof(collapse_masks));
    bool skip = plan != nullptr && plan_skip;
    if (!skip) std::memset(x_out, 0, (size_t)c_ * n * sizeof(float));
    float* y_ = c_ == 2 ? x_out + n : nullptr;

    // Plan emission handles start 0 (CELT) and 17 (hybrid high bands) at
    // any end band; the executor's bands beyond `end` simply carry no
    // records (opus_tpu/dsp/plan_exec.py).
    if (plan && start != 0 && start != 17) return -3;
    st.rng = quant_all_bands_dec(start, end, x_out, y_, collapse_masks, alloc.pulses,
                                 short_blocks, spread_decision, alloc.dual_stereo,
                                 alloc.intensity, tf_res,
                                 (int64_t)frame_bytes * (8 << BITRES) - anti_collapse_rsv,
                                 alloc.balance, dec, lm, alloc.coded_bands, st.rng,
                                 st.disable_inv, plan, skip);

    bool anti_collapse_on = false;
    if (anti_collapse_rsv > 0) anti_collapse_on = dec.decode_bits(1) != 0;

    unquant_energy_finalise(dec, old_band_e, alloc.ebits, alloc.fine_priority,
                            frame_bytes * 8 - dec.tell(), start, end, c_);

    if (anti_collapse_on)
        st.rng = anti_collapse_c(x_out, collapse_masks, lm, c_, n, start, end,
                                 (const float(*)[NB_E_BANDS])old_band_e, st.old_log_e,
                                 st.old_log_e2, alloc.pulses, st.rng, plan, skip);

    if (silence)
        for (int c = 0; c < 2; c++)
            for (int j = 0; j < NB_E_BANDS; j++) old_band_e[c][j] = -28.0f;

    // Emit planes.
    for (int c = 0; c < cc; c++)
        for (int j = 0; j < NB_E_BANDS; j++)
            band_log_e_out[c * NB_E_BANDS + j] = old_band_e[c][j];
    meta[0] = silence ? 1 : 0;
    meta[1] = short_blocks ? 1 : 0;
    meta[2] = lm;
    meta[3] = c_;
    meta[4] = start;
    meta[5] = eff_end;
    meta[6] = std::max(st.postfilter_period_old, MIN_PERIOD);
    meta[7] = std::max(st.postfilter_period, MIN_PERIOD);
    meta[8] = postfilter_pitch;
    meta[9] = st.postfilter_tapset_old;
    meta[10] = st.postfilter_tapset;
    meta[11] = postfilter_tapset;
    meta[13] = spread_decision;
    meta[14] = 0;  // plan-PLC flags: coded frames clear the reused slot
    meta[15] = 0;
    pf_gains[0] = st.postfilter_gain_old;
    pf_gains[1] = st.postfilter_gain;
    pf_gains[2] = postfilter_gain;

    // Rotate postfilter state (decoder.py _rotate_postfilter).
    st.postfilter_period_old = st.postfilter_period;
    st.postfilter_gain_old = st.postfilter_gain;
    st.postfilter_tapset_old = st.postfilter_tapset;
    st.postfilter_period = postfilter_pitch;
    st.postfilter_gain = postfilter_gain;
    st.postfilter_tapset = postfilter_tapset;
    if (lm != 0) {
        st.postfilter_period_old = st.postfilter_period;
        st.postfilter_gain_old = st.postfilter_gain;
        st.postfilter_tapset_old = st.postfilter_tapset;
    }

    // Energy history (decoder.py _update_energy_history).
    if (c_ == 1)
        for (int j = 0; j < NB_E_BANDS; j++) old_band_e[1][j] = old_band_e[0][j];
    if (!is_transient) {
        std::memcpy(st.old_log_e2, st.old_log_e, sizeof(st.old_log_e2));
        std::memcpy(st.old_log_e, old_band_e, sizeof(st.old_log_e));
        // libopus 1.3: IMIN(160, loss_duration + M) * 0.001 in log2 units
        // (2.4 dB/s steady state; after a burst the first update may jump
        // by the whole missed span).
        float max_inc = (float)std::min(160, st.loss_duration + m) * 0.001f;
        for (int c = 0; c < 2; c++)
            for (int j = 0; j < NB_E_BANDS; j++)
                st.background_log_e[c][j] =
                    std::min(st.background_log_e[c][j] + max_inc, st.old_log_e[c][j]);
    } else {
        for (int c = 0; c < 2; c++)
            for (int j = 0; j < NB_E_BANDS; j++)
                st.old_log_e[c][j] = std::min(st.old_log_e[c][j], old_band_e[c][j]);
    }
    for (int c = 0; c < 2; c++) {
        for (int j = 0; j < start; j++) {
            old_band_e[c][j] = 0.0f;
            st.old_log_e[c][j] = -28.0f;
            st.old_log_e2[c][j] = -28.0f;
        }
        for (int j = end; j < NB_E_BANDS; j++) {
            old_band_e[c][j] = 0.0f;
            st.old_log_e[c][j] = -28.0f;
            st.old_log_e2[c][j] = -28.0f;
        }
    }
    st.rng = dec.rng;
    st.loss_duration = 0;
    if (dec.tell() > 8 * frame_bytes) return -2;
    st.error = dec.error;
    meta[12] = dec.error ? 1 : 0;
    return 0;
}

static int decode_frame(FrontEnd& st, const uint8_t* data, int len, int frame_size48,
                        int stream_channels, float* x_out, float* band_log_e_out,
                        int32_t* meta, double* pf_gains) {
    if (len < 2 || len > 1275) return -1;
    RangeDec dec;
    dec.init(data, len);
    return decode_frame_ec(st, dec, len, frame_size48, stream_channels, x_out,
                           band_log_e_out, meta, pf_gains);
}

// Serving-path loss concealment: the noise-based CELT PLC regime
// (celt_decoder.c celt_decode_lost noise branch) as normal-looking
// symbol planes — decayed band energies + per-band renormalised LCG
// noise shapes — so the device synthesis step conceals with zero extra
// code.  This is the regime libopus itself uses for hybrid streams
// (start != 0) and for loss bursts >= 100 ms; the batched loop does not
// run the pitch-LPC regime (it needs the decode memory, which lives on
// device) — the scalar decoder remains the fully-conformant path.
// Replays opus_tpu/celt/plc.py::decode_lost (noise branch) exactly.
static int decode_lost_noise(FrontEnd& st, int frame_size48, float* x_out,
                             float* band_log_e_out, int32_t* meta, double* pf_gains,
                             PlanSink* plan = nullptr) {
    int lm = -1;
    for (int l = 0; l <= MAX_LM; l++)
        if (SHORT_MDCT_SIZE << l == frame_size48) { lm = l; break; }
    if (lm < 0) return -1;
    int m = 1 << lm;
    int n = m * SHORT_MDCT_SIZE;
    int cc = st.channels;
    int start = st.start_band, end = st.end_band;
    int eff_end = std::max(start, std::min(end, (int)EFF_E_BANDS));

    float decay = st.loss_duration == 0 ? 1.5f : 0.5f;
    for (int c = 0; c < cc; c++)
        for (int i = start; i < end; i++)
            st.old_band_e[c][i] =
                std::max(st.background_log_e[c][i], st.old_band_e[c][i] - decay);

    uint32_t seed = st.rng;
    std::memset(x_out, 0, (size_t)cc * n * sizeof(float));
    if (plan) {
        plan->reset(x_out, cc == 2 ? x_out + n : nullptr);
        // PLC planes carry no band transforms: longblocks identity config.
        for (int i = 0; i < NB_E_BANDS; i++) plan->band_cfg(i, 0, 0, true);
    }
    for (int c = 0; c < cc; c++) {
        for (int i = start; i < eff_end; i++) {
            int boffs = n * c + (E_BANDS[i] << lm);
            int blen = (E_BANDS[i + 1] - E_BANDS[i]) << lm;
            if (plan) plan->emit_fill(x_out + boffs, blen, 1.0f, nullptr, seed);
            for (int j = 0; j < blen; j++) {
                seed = lcg_rand(seed);
                x_out[boffs + j] = (float)((int32_t)seed >> 20);
            }
            renormalise_vector(x_out + boffs, blen, 1.0f);
        }
    }
    st.rng = seed;

    for (int c = 0; c < cc; c++)
        for (int j = 0; j < NB_E_BANDS; j++)
            band_log_e_out[c * NB_E_BANDS + j] = st.old_band_e[c][j];
    meta[0] = 0;
    meta[1] = 0;  // long blocks
    meta[2] = lm;
    meta[3] = cc;  // per-channel independent noise, like the scalar PLC
    meta[4] = start;
    meta[5] = eff_end;
    meta[6] = meta[7] = meta[8] = MIN_PERIOD;
    meta[9] = meta[10] = meta[11] = 0;
    meta[12] = 0;
    meta[13] = 0;
    meta[14] = 0;
    meta[15] = 0;
    pf_gains[0] = pf_gains[1] = pf_gains[2] = 0.0;  // lost frames skip the comb
    st.loss_duration = std::min(10000, st.loss_duration + m);
    return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI.
// ---------------------------------------------------------------------------

extern "C" {

void* celt_fe_create(int channels, int downsample) {
    warm_urows();
    FrontEnd* st = new FrontEnd();
    st->channels = channels;
    st->downsample = downsample;
    st->start_band = 0;
    st->end_band = NB_E_BANDS;
    st->disable_inv = channels == 1;
    st->reset();
    return st;
}

void celt_fe_destroy(void* h) { delete (FrontEnd*)h; }
void celt_fe_reset(void* h) { ((FrontEnd*)h)->reset(); }

void celt_fe_config(void* h, int start_band, int end_band, int disable_inv) {
    FrontEnd* st = (FrontEnd*)h;
    st->start_band = start_band;
    st->end_band = end_band;
    if (disable_inv >= 0) st->disable_inv = disable_inv != 0;
}

uint32_t celt_fe_rng(void* h) { return ((FrontEnd*)h)->rng; }

int celt_fe_decode(void* h, const uint8_t* data, int len, int frame_size48,
                   int stream_channels, double* x_out, float* band_log_e_out,
                   int32_t* meta, double* pf_gains) {
    // The internal band plane is float32 (libopus float build semantics);
    // this legacy entry keeps its f64 ABI by converting on the way out.
    static thread_local std::vector<float> scratch(2 * 960);
    int rc = decode_frame(*(FrontEnd*)h, data, len, frame_size48, stream_channels,
                          scratch.data(), band_log_e_out, meta, pf_gains);
    if (rc == 0) {
        int n = 120 << meta[2];
        for (int j = 0; j < meta[3] * n; j++) x_out[j] = (double)scratch[j];
    }
    return rc;
}

int celt_fe_decode_ec(void* h, void* ec, int frame_bytes, int frame_size48,
                      int stream_channels, float* x_out, float* band_log_e_out,
                      int32_t* meta, double* pf_gains) {
    return decode_frame_ec(*(FrontEnd*)h, *(opusfe::RangeDec*)ec, frame_bytes,
                           frame_size48, stream_channels, x_out, band_log_e_out,
                           meta, pf_gains);
}

// Noise-regime loss concealment (plc.py decode_lost noise branch) for the
// mixed serving loop's plane A; the CELT-only plan path conceals the
// pitch-LPC regime on device instead (opus_tpu/dsp/plc_exec.py).
int celt_fe_decode_lost(void* h, int frame_size48, float* x_out,
                        float* band_log_e_out, int32_t* meta, double* pf_gains) {
    return decode_lost_noise(*(FrontEnd*)h, frame_size48, x_out, band_log_e_out,
                             meta, pf_gains);
}

// POD state copy-in/out, for transactional plan attempts across TUs
// (opus_frontend.cpp restores state when a plan batch falls back).
int celt_fe_state_bytes() { return (int)sizeof(FrontEnd); }
void celt_fe_state_get(void* h, void* buf) { std::memcpy(buf, h, sizeof(FrontEnd)); }
void celt_fe_state_set(void* h, const void* buf) { std::memcpy(h, buf, sizeof(FrontEnd)); }

}  // extern "C"

extern "C" {

// Batch decode: one packet per stream handle, stacked outputs.
// data: concatenated payloads; lens[i] gives each length.
// x_out stride: x_stride doubles; ble stride: 2*21 floats; meta stride 16;
// gains stride 3.  Returns number of frames decoded, negative on error.
int celt_fe_decode_batch(void** handles, const uint8_t* data, const int32_t* lens,
                         int n_packets, int frame_size48, const int32_t* stream_channels,
                         double* x_out, int64_t x_stride,
                         float* ble_out, int32_t* meta_out, double* gains_out) {
    std::vector<int64_t> offs(n_packets + 1, 0);
    for (int i = 0; i < n_packets; i++) offs[i + 1] = offs[i] + lens[i];
    int bad = 0;
#pragma omp parallel
    {
        std::vector<float> scratch(2 * 960, 0.0f);
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n_packets; i++) {
            FrontEnd* st = (FrontEnd*)handles[i];
            int rc = lens[i] > 0
                         ? decode_frame(*st, data + offs[i], lens[i], frame_size48,
                                        stream_channels[i], scratch.data(),
                                        ble_out + i * 2 * NB_E_BANDS,
                                        meta_out + i * 16, gains_out + i * 3)
                         : decode_lost_noise(*st, frame_size48, scratch.data(),
                                             ble_out + i * 2 * NB_E_BANDS,
                                             meta_out + i * 16, gains_out + i * 3);
            if (rc != 0) {
#pragma omp critical
                bad = i + 1;
            } else {
                double* dst = x_out + (int64_t)i * x_stride;
                for (int64_t j = 0; j < x_stride; j++) dst[j] = (double)scratch[j];
            }
        }
    }
    if (bad) return -bad;
    return n_packets;
}

// f32 output variant for the device-plane feed: the internal band plane is
// already float32, so frames decode straight into the batch array.
int celt_fe_decode_batch_f32(void** handles, const uint8_t* data, const int32_t* lens,
                             int n_packets, int frame_size48, const int32_t* stream_channels,
                             float* x_out, int64_t x_stride,
                             float* ble_out, int32_t* meta_out, float* gains_out) {
    std::vector<int64_t> offs(n_packets + 1, 0);
    for (int i = 0; i < n_packets; i++) offs[i + 1] = offs[i] + lens[i];
    int bad = 0;
#pragma omp parallel
    {
        double g[3];
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n_packets; i++) {
            FrontEnd* st = (FrontEnd*)handles[i];
            int rc = lens[i] > 0
                         ? decode_frame(*st, data + offs[i], lens[i], frame_size48,
                                        stream_channels[i], x_out + (int64_t)i * x_stride,
                                        ble_out + i * 2 * NB_E_BANDS, meta_out + i * 16, g)
                         : decode_lost_noise(*st, frame_size48,
                                             x_out + (int64_t)i * x_stride,
                                             ble_out + i * 2 * NB_E_BANDS,
                                             meta_out + i * 16, g);
            if (rc != 0) {
#pragma omp critical
                bad = i + 1;
            } else {
                for (int j = 0; j < 3; j++) gains_out[i * 3 + j] = (float)g[j];
            }
        }
    }
    if (bad) return -bad;
    return n_packets;
}

}  // extern "C"

extern "C" {

// Bit-packed variant: W-bit mantissas (W = 12/10/8) with a per-band
// exponent folded into the uploaded band log-energies.
// x ~= mant * 2^s / 16384 and the emitted ble row gets +s, so the
// device's denormalise (mant/16384 * exp2(ble'+eMeans)) reproduces
// x * exp2(ble+eMeans) exactly — no extra scale plane, no device-side
// changes beyond the bit unpack.  Every coefficient keeps >= W
// significant bits relative to its band's peak (the Q14 int16 mode
// keeps 14 absolute); each width is gated by the RFC 8251-style
// conformance metric in tests/test_native.py.
//
// Word layout per channel: a little-endian bit stream of W-bit
// offset-binary (m + 2^(W-1)) fields, 30*W uint32 words per 960
// coefficients.  x_stride is in int32 words (2*30*W for stereo rows).
static void pack_pw_channel(const float* x, int n, int lm, int W, int32_t* dst,
                            float* ble_row) {
    int m = 1 << lm;
    int lim = (1 << (W - 1)) - 1;
    // Quantise per band with one hoisted scale (no per-element divide);
    // the tails of each loop auto-vectorise.
    int16_t mant[960];
    int coded = std::min(n, m * (int)E_BANDS[NB_E_BANDS]);
    for (int b = 0; b < NB_E_BANDS; b++) {
        int lo = m * E_BANDS[b];
        int hi = std::min(n, m * E_BANDS[b + 1]);
        float bandmax = 0.0f;
        for (int j = lo; j < hi; j++) bandmax = std::max(bandmax, std::fabs(x[j]));
        bandmax *= 16384.0f;
        int s = 0;
        while (std::floor(bandmax / (float)(1 << s) + 0.5f) > (float)lim) s++;
        ble_row[b] += (float)s;
        float scale = 16384.0f / (float)(1 << s);
        for (int j = lo; j < hi; j++) {
            int mq = (int)std::lrintf(x[j] * scale);
            mant[j] = (int16_t)std::max(-lim - 1, std::min(lim, mq));
        }
    }
    for (int j = coded; j < n; j++) mant[j] = 0;
    uint64_t cur = 0;
    int nbits = 0, wi = 0;
    uint32_t mask = (1u << W) - 1;
    int bias = lim + 1;
    for (int j = 0; j < n; j++) {
        cur |= (uint64_t)(((uint32_t)(mant[j] + bias)) & mask) << nbits;
        nbits += W;
        if (nbits >= 32) {
            dst[wi++] = (int32_t)(uint32_t)cur;
            cur >>= 32;
            nbits -= 32;
        }
    }
    if (nbits) dst[wi++] = (int32_t)(uint32_t)cur;
}

// Exported for the mixed-mode (opus_frontend.cpp) packed batch path.
void celt_fe_pack_pw(const float* x, int n, int lm, int W, int32_t* dst,
                     float* ble_row) {
    pack_pw_channel(x, n, lm, W, dst, ble_row);
}

}  // extern "C"

namespace {

// Plan-mode loss concealment dispatch: the noise regime (loss >= 100 ms)
// emits noise leaves as before; the pitch-LPC regime emits an EMPTY plan
// with meta flags so the DEVICE conceals from its own decode memory
// (opus_tpu/dsp/plc_exec.py) — lost frames never leave the packed loop.
// meta[14]: bit0 = pitch-regime PLC, bit1 = first loss (run pitch search).
// meta[15]: postfilter-undo params: period[0:11] | tapset[11:13]
//           | gain_f16[16:32] (the state the scalar undo reads).
static int decode_lost_plan(FrontEnd& st, int frame_size48, float* x_out,
                            float* band_log_e_out, int32_t* meta, double* pf_gains,
                            PlanSink* plan) {
    bool noise = st.loss_duration >= 40 || st.start_band != 0 || st.skip_plc;
    if (noise)
        return decode_lost_noise(st, frame_size48, x_out, band_log_e_out, meta,
                                 pf_gains, plan);
    int lm = -1;
    for (int l = 0; l <= MAX_LM; l++)
        if (SHORT_MDCT_SIZE << l == frame_size48) { lm = l; break; }
    if (lm < 0) return -1;
    int cc = st.channels;
    int n = (1 << lm) * SHORT_MDCT_SIZE;
    std::memset(x_out, 0, (size_t)cc * n * sizeof(float));
    plan->reset(x_out, cc == 2 ? x_out + n : nullptr);
    for (int i = 0; i < NB_E_BANDS; i++) plan->band_cfg(i, 0, 0, true);
    for (int c = 0; c < cc; c++)
        for (int j = 0; j < NB_E_BANDS; j++)
            band_log_e_out[c * NB_E_BANDS + j] = st.old_band_e[c][j];
    meta[0] = 1;  // silence: the coded-path synthesis is discarded anyway
    meta[1] = 0;
    meta[2] = lm;
    meta[3] = cc;
    meta[4] = st.start_band;
    meta[5] = st.start_band;
    meta[6] = meta[7] = meta[8] = MIN_PERIOD;
    meta[9] = meta[10] = meta[11] = 0;
    meta[12] = 0;
    meta[13] = 0;
    meta[14] = 1 | (st.loss_duration == 0 ? 2 : 0);
    int period = std::max(st.postfilter_period, MIN_PERIOD) & 0x7FF;
    meta[15] = period | ((st.postfilter_tapset & 3) << 11) |
               (int32_t)(f32_to_f16_bits((float)st.postfilter_gain) << 16);
    pf_gains[0] = pf_gains[1] = pf_gains[2] = 0.0;
    st.loss_duration = std::min(10000, st.loss_duration + (1 << lm));
    return 0;
}

}  // namespace

extern "C" {

int celt_fe_decode_batch_packed(void** handles, const uint8_t* data, const int32_t* lens,
                                int n_packets, int frame_size48, const int32_t* stream_channels,
                                int mant_bits,
                                int32_t* x_out, int64_t x_stride,
                                float* ble_out, int32_t* meta_out, float* gains_out) {
    std::vector<int64_t> offs(n_packets + 1, 0);
    for (int i = 0; i < n_packets; i++) offs[i + 1] = offs[i] + lens[i];
    int bad = 0;
#pragma omp parallel
    {
        std::vector<float> scratch(2 * 960);
        double g[3];
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n_packets; i++) {
            FrontEnd* st = (FrontEnd*)handles[i];
            float* ble = ble_out + i * 2 * NB_E_BANDS;
            FrontEnd save = *st;
            int rc = lens[i] > 0
                         ? decode_frame(*st, data + offs[i], lens[i], frame_size48,
                                        stream_channels[i], scratch.data(),
                                        ble, meta_out + i * 16, g)
                         : decode_lost_noise(*st, frame_size48, scratch.data(),
                                             ble, meta_out + i * 16, g);
            if (rc != 0 && lens[i] > 0) {
                // Corrupt packet on ONE stream: restore + conceal instead
                // of killing the serving batch.
                *st = save;
                rc = decode_lost_noise(*st, frame_size48, scratch.data(),
                                       ble, meta_out + i * 16, g);
            }
            if (rc != 0) {
#pragma omp critical
                bad = i + 1;
            } else {
                int lm = meta_out[i * 16 + 2];
                int c_ = meta_out[i * 16 + 3];
                int n = 120 << lm;
                int32_t* dst = x_out + (int64_t)i * x_stride;
                for (int c = 0; c < c_; c++)
                    pack_pw_channel(scratch.data() + c * n, n, lm, mant_bits,
                                    dst + c * (x_stride / 2), ble + c * NB_E_BANDS);
                for (int j = 0; j < 3; j++) gains_out[i * 3 + j] = (float)g[j];
            }
        }
    }
    if (bad) return -bad;
    return n_packets;
}

}  // extern "C"

extern "C" {

// Plan-mode batch decode: emits the plan-executor slot regions instead of
// a packed spectrum.  header [B,4] = {arena_word_off,
// n_pvq | n_fill<<9 | n_acents<<18, n_acents, iy_word_off_rel};
// per-stream arena layout [pvq 1w][fill 3w][acents 2w][iy].
// Returns n_packets, -(i+1) on a stream error, or -(n_packets+1) when the
// arena capacity is exceeded (caller falls back to a spectral mode).
// xdbg (optional, may be null): f32 debug spectra like the f32 batch path,
// used by the executor conformance tests.
static std::vector<PlanSink>& plan_sinks(int n) {
    static std::vector<PlanSink> sinks;
    if ((int)sinks.size() < n) sinks.resize(n);
    return sinks;
}

int celt_fe_decode_batch_plan(void** handles, const uint8_t* data, const int32_t* lens,
                              int n_packets, int frame_size48, const int32_t* stream_channels,
                              int32_t* header, float* ble_out, int32_t* meta_out,
                              float* gains_out, int32_t* bands_out,
                              int32_t* arena, int64_t arena_words, int64_t* used_words_out,
                              float* xdbg, int64_t xdbg_stride) {
    std::vector<int64_t> offs(n_packets + 1, 0);
    for (int i = 0; i < n_packets; i++) offs[i + 1] = offs[i] + lens[i];
    auto& sinks = plan_sinks(n_packets);
    // Transactional: a failed plan attempt (decode error OR capacity
    // overflow) must leave decoder state untouched — the serve loop
    // falls back to a spectral decode of the SAME packets, and a second
    // state update would corrupt energy prediction for every later
    // frame.  FrontEnd is a small POD; snapshot all streams up front.
    std::vector<FrontEnd> snap(n_packets);
    for (int i = 0; i < n_packets; i++) snap[i] = *(FrontEnd*)handles[i];
    auto restore_all = [&]() {
        for (int i = 0; i < n_packets; i++) *(FrontEnd*)handles[i] = snap[i];
    };
    int bad = 0;
#pragma omp parallel
    {
        std::vector<float> scratch(2 * 960);
        double g[3];
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n_packets; i++) {
            FrontEnd* st = (FrontEnd*)handles[i];
            PlanSink& sink = sinks[i];
            int rc;
            if (lens[i] > 0) {
                if (lens[i] < 2 || lens[i] > 1275) rc = -1;
                else {
                    RangeDec dec;
                    dec.init(data + offs[i], lens[i]);
                    rc = decode_frame_ec(*st, dec, lens[i], frame_size48,
                                         stream_channels[i], scratch.data(),
                                         ble_out + i * 2 * NB_E_BANDS,
                                         meta_out + i * 16, g, &sink,
                                         /*plan_skip=*/xdbg == nullptr);
                }
            } else {
                rc = decode_lost_plan(*st, frame_size48, scratch.data(),
                                      ble_out + i * 2 * NB_E_BANDS,
                                      meta_out + i * 16, g, &sink);
            }
            if (rc != 0 && lens[i] > 0) {
                // Corrupt/invalid packet on ONE stream must not kill the
                // batch (availability): restore that stream's state and
                // conceal the frame as a loss instead.
                *st = snap[i];
                sink.reset(nullptr, nullptr);
                rc = decode_lost_plan(*st, frame_size48, scratch.data(),
                                      ble_out + i * 2 * NB_E_BANDS,
                                      meta_out + i * 16, g, &sink);
            }
            if (rc != 0 || sink.overflow) {
#pragma omp critical
                // Plan-capacity overflow on a VALID frame (e.g. the n<=2
                // bands of 2.5/5 ms frames, or leaf/arena limits) must
                // surface as the fallback signal, not a decode error —
                // the serve loop then ships this step as a p10 spectrum.
                if (rc == 0 && sink.overflow) {
                    if (bad == 0) bad = -(n_packets + 1);
                } else {
                    bad = i + 1;
                }
            } else {
                for (int j = 0; j < 3; j++) gains_out[i * 3 + j] = (float)g[j];
                for (int j = 0; j < NB_E_BANDS; j++) {
                    bands_out[(i * NB_E_BANDS + j) * 2] = (int32_t)sink.bands_w0[j];
                    bands_out[(i * NB_E_BANDS + j) * 2 + 1] = (int32_t)sink.bands_w1[j];
                }
                if (xdbg) {
                    int nvals = (120 << meta_out[i * 16 + 2]) * meta_out[i * 16 + 3];
                    float* dst = xdbg + (int64_t)i * xdbg_stride;
                    std::memcpy(dst, scratch.data(), nvals * sizeof(float));
                }
            }
        }
    }
    if (bad > 0) { restore_all(); return -bad; }  // decode error at stream bad-1
    if (bad < 0) { restore_all(); return bad; }   // plan overflow -> caller falls back
    // Serial prefix over per-stream arena sizes.
    int64_t total = 0;
    for (int i = 0; i < n_packets; i++) {
        PlanSink& sink = sinks[i];
        int np = (int)sink.pvq.size();
        int nf = (int)sink.fills.size();
        int na = (int)sink.acents.size() / 2;
        int aw = sink.arena_words();
        // jit executor capacities (plan_exec.py p_max/f_max/a_max and
        // PLAN_IYW): exceeding any is a fallback, with state restored.
        int64_t iyb = 0;
        for (auto& lf : sink.pvq) iyb += (int64_t)lf.n * lf.w;
        if (np > 224 || nf > 64 || na > 42 || (iyb + 31) / 32 > 191) {
            restore_all();
            return -(n_packets + 1);
        }
        header[i * 4 + 0] = (int32_t)total;
        header[i * 4 + 1] = np | (nf << 9) | (na << 18);  // packed counts
        header[i * 4 + 2] = na;
        header[i * 4 + 3] = sink.iy_rel_words();  // iy offset rel to arena_off
        total += aw;
    }
    if (total > arena_words) { restore_all(); return -(n_packets + 1); }
    *used_words_out = total;
#pragma omp parallel for schedule(dynamic, 8)
    for (int i = 0; i < n_packets; i++)
        sinks[i].pack(arena + header[i * 4 + 0]);
    return n_packets;
}

// --- plan-sink pool helpers for the mixed-mode plan path -------------------
// opus_frontend.cpp drives per-stream plan emission behind the shared
// range decoder (SILK first, then the CELT plan), reusing this TU's
// static sink pool: prepare -> per-stream decode/clear -> headers -> pack.

void celt_fe_plan_prepare(int n) { plan_sinks(n); }

// Zero-leaf plan (SILK-only streams): identity band configs, no records.
void celt_fe_plan_clear(int sink_idx) {
    plan_sinks(sink_idx + 1)[sink_idx].reset(nullptr, nullptr);
}

int celt_fe_decode_ec_plan(void* h, void* ec, int frame_bytes, int frame_size48,
                           int stream_channels, int sink_idx, float* ble_out,
                           int32_t* meta, double* pf_gains) {
    PlanSink& sink = plan_sinks(sink_idx + 1)[sink_idx];
    static thread_local std::vector<float> scratch(2 * 960);
    int rc = decode_frame_ec(*(FrontEnd*)h, *(opusfe::RangeDec*)ec, frame_bytes,
                             frame_size48, stream_channels, scratch.data(),
                             ble_out, meta, pf_gains, &sink, /*plan_skip=*/true);
    if (rc == 0 && sink.overflow) rc = -30;  // caller falls back to p10
    return rc;
}

// Noise-regime loss concealment as a plan (the mixed path's conceal
// semantics — see opus_fe_decode; hybrid is always noise-based).
int celt_fe_plan_lost(void* h, int frame_size48, int sink_idx, float* ble_out,
                      int32_t* meta, double* pf_gains) {
    PlanSink& sink = plan_sinks(sink_idx + 1)[sink_idx];
    static thread_local std::vector<float> scratch(2 * 960);
    int rc = decode_lost_noise(*(FrontEnd*)h, frame_size48, scratch.data(),
                               ble_out, meta, pf_gains, &sink);
    if (rc == 0 && sink.overflow) rc = -30;
    return rc;
}

// Regime-dispatching variant (decode_lost_plan): noise regime as plan
// noise leaves, pitch-LPC regime as an EMPTY plan + meta[14]/[15] flags
// for the device conceal step (opus_tpu/dsp/plc_exec.py).  Used by the
// mixed pipeline for CELT-only members of a mixed batch.
int celt_fe_plan_lost_dispatch(void* h, int frame_size48, int sink_idx,
                               float* ble_out, int32_t* meta, double* pf_gains) {
    PlanSink& sink = plan_sinks(sink_idx + 1)[sink_idx];
    static thread_local std::vector<float> scratch(2 * 960);
    int rc = decode_lost_plan(*(FrontEnd*)h, frame_size48, scratch.data(),
                              ble_out, meta, pf_gains, &sink);
    if (rc == 0 && sink.overflow) rc = -30;
    return rc;
}

// Regime-dispatching loss concealment for the PACKED (spectral) serving
// path: noise regime emits decayed spectra as usual (decode_lost_noise);
// pitch-LPC regime emits zero spectra + the meta[14]/[15] device-conceal
// flags — the same contract as decode_lost_plan minus the plan sink.
// Used by the mixed packed fallback so plan-overflow steps under loss
// do not silently degrade to noise-only concealment.
int celt_fe_decode_lost_dispatch(void* h, int frame_size48, float* x_out,
                                 float* band_log_e_out, int32_t* meta,
                                 double* pf_gains) {
    FrontEnd& st = *(FrontEnd*)h;
    bool noise = st.loss_duration >= 40 || st.start_band != 0 || st.skip_plc;
    if (noise)
        return decode_lost_noise(st, frame_size48, x_out, band_log_e_out, meta,
                                 pf_gains, nullptr);
    int lm = -1;
    for (int l = 0; l <= MAX_LM; l++)
        if (SHORT_MDCT_SIZE << l == frame_size48) { lm = l; break; }
    if (lm < 0) return -1;
    int cc = st.channels;
    int n = (1 << lm) * SHORT_MDCT_SIZE;
    std::memset(x_out, 0, (size_t)cc * n * sizeof(float));
    for (int c = 0; c < cc; c++)
        for (int j = 0; j < NB_E_BANDS; j++)
            band_log_e_out[c * NB_E_BANDS + j] = st.old_band_e[c][j];
    meta[0] = 1;  // silence: the coded-path synthesis is discarded anyway
    meta[1] = 0;
    meta[2] = lm;
    meta[3] = cc;
    meta[4] = st.start_band;
    meta[5] = st.start_band;
    meta[6] = meta[7] = meta[8] = MIN_PERIOD;
    meta[9] = meta[10] = meta[11] = 0;
    meta[12] = 0;
    meta[13] = 0;
    meta[14] = 1 | (st.loss_duration == 0 ? 2 : 0);
    int period = std::max(st.postfilter_period, MIN_PERIOD) & 0x7FF;
    meta[15] = period | ((st.postfilter_tapset & 3) << 11) |
               (int32_t)(f32_to_f16_bits((float)st.postfilter_gain) << 16);
    pf_gains[0] = pf_gains[1] = pf_gains[2] = 0.0;
    st.loss_duration = std::min(10000, st.loss_duration + (1 << lm));
    return 0;
}

// Serial prefix over per-stream arena sizes -> 4-word headers; returns
// the total arena words (or -1 if it exceeds capacity).
int64_t celt_fe_plan_headers(int n, int32_t* header, int64_t arena_words) {
    auto& sinks = plan_sinks(n);
    int64_t total = 0;
    for (int i = 0; i < n; i++) {
        PlanSink& sink = sinks[i];
        int np = (int)sink.pvq.size();
        int nf = (int)sink.fills.size();
        int na = (int)sink.acents.size() / 2;
        // The jit executor's table capacities (plan_exec.py
        // make_plan_executor p_max/f_max/a_max and PLAN_IYW): exceeding
        // any of them is a fallback signal, checked HERE so the caller
        // can restore decoder state before re-decoding spectrally.
        int64_t iyb = 0;
        for (auto& lf : sink.pvq) iyb += (int64_t)lf.n * lf.w;
        if (np > 224 || nf > 64 || na > 42 || (iyb + 31) / 32 > 191) return -1;
        header[i * 4 + 0] = (int32_t)total;
        header[i * 4 + 1] = np | (nf << 9) | (na << 18);
        header[i * 4 + 2] = na;
        header[i * 4 + 3] = sink.iy_rel_words();
        total += sink.arena_words();
    }
    return total > arena_words ? -1 : total;
}

void celt_fe_plan_pack(int n, int32_t* arena, const int32_t* header) {
    auto& sinks = plan_sinks(n);
#pragma omp parallel for schedule(dynamic, 8)
    for (int i = 0; i < n; i++) sinks[i].pack(arena + header[i * 4 + 0]);
}

// Per-stream band words (w0 + staging w1) after a plan decode.
void celt_fe_plan_bands(int sink_idx, int32_t* bands_out) {
    PlanSink& sink = plan_sinks(sink_idx + 1)[sink_idx];
    for (int j = 0; j < NB_E_BANDS; j++) {
        bands_out[j * 2] = (int32_t)sink.bands_w0[j];
        bands_out[j * 2 + 1] = (int32_t)sink.bands_w1[j];
    }
}

// Q14 int16 output variant: halves the host->device transfer for the
// serving pipeline.  Band-shape values are unit-norm (|x| <= ~1.4 after
// stereo merge), so Q14 keeps 1 LSB = 6.1e-5 in the shape domain --
// the precision class of libopus's FIXED build (Q15 celt_norm), and
// comfortably inside the RFC 8251 conformance gate.
int celt_fe_decode_batch_q15(void** handles, const uint8_t* data, const int32_t* lens,
                             int n_packets, int frame_size48, const int32_t* stream_channels,
                             int16_t* x_out, int64_t x_stride,
                             float* ble_out, int32_t* meta_out, float* gains_out) {
    std::vector<int64_t> offs(n_packets + 1, 0);
    for (int i = 0; i < n_packets; i++) offs[i + 1] = offs[i] + lens[i];
    int bad = 0;
#pragma omp parallel
    {
        std::vector<float> scratch(2 * 960);
        double g[3];
#pragma omp for schedule(dynamic, 8)
        for (int i = 0; i < n_packets; i++) {
            FrontEnd* st = (FrontEnd*)handles[i];
            FrontEnd save = *st;
            int rc = lens[i] > 0
                         ? decode_frame(*st, data + offs[i], lens[i], frame_size48,
                                        stream_channels[i], scratch.data(),
                                        ble_out + i * 2 * NB_E_BANDS, meta_out + i * 16, g)
                         : decode_lost_noise(*st, frame_size48, scratch.data(),
                                             ble_out + i * 2 * NB_E_BANDS,
                                             meta_out + i * 16, g);
            if (rc != 0 && lens[i] > 0) {
                // Corrupt packet on ONE stream: restore + conceal instead
                // of killing the serving batch.
                *st = save;
                rc = decode_lost_noise(*st, frame_size48, scratch.data(),
                                       ble_out + i * 2 * NB_E_BANDS,
                                       meta_out + i * 16, g);
            }
            if (rc != 0) {
#pragma omp critical
                bad = i + 1;
            } else {
                int16_t* dst = x_out + (int64_t)i * x_stride;
                int nvals = (120 << meta_out[i * 16 + 2]) * meta_out[i * 16 + 3];
                for (int j = 0; j < nvals; j++) {
                    float v = scratch[j] * 16384.0f;
                    dst[j] = (int16_t)std::max(-32768.0f, std::min(32767.0f, std::floor(v + 0.5f)));
                }
                for (int j = 0; j < 3; j++) gains_out[i * 3 + j] = (float)g[j];
            }
        }
    }
    if (bad) return -bad;
    return n_packets;
}

}  // extern "C"

#include "celt_encoder.inc"
