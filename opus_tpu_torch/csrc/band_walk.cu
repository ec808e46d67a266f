// The plan executor's band walk, stereo merge and anti-collapse for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces no TPU kernel: the reference runs this region of its plan
// executor (opus_tpu/dsp/plan_exec.py, make_plan_executor after the second
// rotation pass) as XLA operations.  The semantics are the port's plain
// version, opus_tpu_torch/dsp/band_walk.py::_band_walk_ref.  Per stream,
// from the rotated leaf plane x [2, N]:
//
//   for band i = 0..20, in order:
//     (band 18 of a hybrid stream: copy band 17's folding data in norm)
//     intensity switch: norm plane 0 below the band = the planes' mean
//     ld2  = T_fwd[sel_i] . norm[eff_i .. eff_i + nb)            (both planes)
//     fill = ld2[srcw] + dither at fold positions, else 0
//     xb   = fill * fgain / sqrt(eps + leaf run's sum of fill^2) at fold
//            positions (the sum a difference of a float64 prefix sum), else x
//     X    = T_und[sel_i] . xb;  norm[band] = sqrt(nb) X  (plane 1 if dual)
//   stereo merge and inversion of every band, from its sums of y x and y y;
//   anti-collapse: LCG signs at the records' cleared blocks, each band with
//   a record renormalised; zero above the last band.
//
// What bounds it on this card: neither bytes nor operations.  A serving
// step reads about 40 B a bin (the plane, six fold planes, the selected
// transform slots) and writes 4: some 12 MB at B=160 lm=3, 4 us at
// 3.35 TB/s.  The walk is a chain of 21 dependent bands, each of a few
// dependent phases (the norm window, the forward product, the fill, the
// prefix sum, the scale, the undo product, the norm write) over at most
// 2 x 176 bins.  As torch operations that chain was some 840 launches a
// step, 3.9 ms of launch gaps.
//
// The design's answer: one block of 256 threads a stream, which walks the
// bands with the stream's spectrum (2 x 960 floats) and norm (2 x 624) in
// shared memory, and the band's window, products, fill and prefix sums on
// chip; __syncthreads between phases.  Streams are independent: the grid
// is one block a stream, one launch a step.
// * A band's config (the 24- and 11-bit fields of `bands`) is decoded
//   once.  Its transform slot is a per-thread dot product over the band's
//   nonzeros: a row of a slot (haar butterflies and interleaving) has at
//   most 8, packed at table build in ascending order (the order a dense
//   product adds them in; the zeros it adds between them change nothing
//   but the sign of a zero), read coalesced across threads, where a
//   dense product of the 176-bin band reads 176 terms a row, an L2 load
//   each.  A stream at the identity slot skips the product: the plain
//   version's identity product returns its input bit for bit.
// * The fold run sums are differences of a float64 prefix sum, as in the
//   plain version: a warp shuffle scan over two bins a thread and the
//   warps' totals in order.  Band sums (stereo merge, anti-collapse) are
//   one warp a band: lane sums in float64, then a fixed butterfly.
// * No atomics and fixed orders, so a captured replay equals its eager run
//   bit for bit; the float32 formulas round each operation as torch does
//   (__fmul_rn and friends, so nvcc fuses nothing there).  The dot
//   products and band sums add in another order than torch's matmuls.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNB = 21;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 960;     // bins a channel at lm 3
constexpr int kMaxNorm = 624;  // the norm's length at lm 3, e[20]
constexpr int kMaxW = 176;     // the widest band at lm 3
constexpr int kAc = 2 * kNB;   // anti-collapse records a stream (PLAN_A_MAX)
constexpr int kLcgMax = 1600;  // the LCG jump table's length (_LCG_MAX)
constexpr int kTerms = 8;      // nonzeros a transform row has at most (TERMS)
constexpr float kEps = 1e-15f;  // EPSILON
static_assert(2 * kMaxW <= 2 * kThreads, "a band's bins: at most two a thread");

__constant__ int kEBands[kNB + 1] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12,
                                     14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100};

struct Args {
  const float* x;                  // [rows, 2n] the rotated plane
  const int* bands;                // [rows, 24] 16 words of 24-bit, 8 of 11-bit fields
  const int* meta;                 // [rows, 16]
  const int* header;               // [rows, 2]
  const long long* ac;             // [rows, ac_stride] anti-collapse words (u32)
  long long ac_stride;
  const unsigned char* fold;       // [rows, 2n] bool
  const long long* srcw;           // [rows, 2n]
  const long long* run_lo;         // [rows, 2n]
  const long long* run_hi;         // [rows, 2n]
  const float* fgain;              // [rows, 2n]
  const float* dither;             // [rows, 2n]
  const int* term_w;               // every band's transform slots as their rows'
  const float* term_c;             // nonzeros: (w, coefficient), kTerms x nb a slot
  const int* term_off;             // [NB, 2] forward / undo offsets into the terms
  const int* slots;                // [NB, 32] config code -> slot
  const unsigned* lcg;             // [2, kLcgMax] the LCG jump table (A_t, C_t)
  float* out;                      // [rows, 2n]
  int lm;
};

__device__ __forceinline__ int edge(int i, int lm) { return kEBands[i] << lm; }

// The band of bin q (band 20 above the last band, as the plain version's
// _plan_band_of_bin maps them).
__device__ __forceinline__ int band_of(int q, int lm) {
  int i = 0;
  while (i < kNB - 1 && edge(i + 1, lm) <= q) ++i;
  return i;
}

// `bits` bits from bit `bit` of a little-endian u32 word stream of nwords.
__device__ __forceinline__ int bitfield(const unsigned* w, int bit, int nwords, int bits) {
  const int k = bit >> 5, sh = bit & 31;
  const unsigned long long lo = static_cast<unsigned long long>(w[k]) >> sh;
  const unsigned long long hi = static_cast<unsigned long long>(w[min(k + 1, nwords - 1)])
                                << (32 - sh);
  return static_cast<int>((lo | hi) & ((1ull << bits) - 1));
}

// IEEE half bits -> float; exponent 31 decodes to the finite
// +-(1 + m/1024) * 2^16, as the plain version's _f16_to_f32.
__device__ __forceinline__ float f16_to_f32(unsigned h) {
  h &= 0xFFFFu;
  if (((h >> 10) & 0x1F) == 31) {
    const float big = (1.0f + static_cast<float>(h & 0x3FF) / 1024.0f) * 65536.0f;
    return (h >> 15) ? -big : big;
  }
  return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

// out[c nb + j] = sum_w in[c nb + w] T[j, w] for both planes, over the
// slot's nonzeros: term k of row j at k nb + j of (w, c).
__device__ void transform(const int* __restrict__ w, const float* __restrict__ coef,
                          const float* in, float* out, int nb) {
  for (int t = threadIdx.x; t < 2 * nb; t += kThreads) {
    const int c = t >= nb, j = t - c * nb;
    const float* v = in + c * nb;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kTerms; ++k)
      acc = fmaf(v[__ldg(w + k * nb + j)], __ldg(coef + k * nb + j), acc);
    out[t] = acc;
  }
}

// A thread's two bins (tid and tid + kThreads of the band's [plane 0 |
// plane 1]) of the fold planes of band i, indices clamped into the band.
struct Planes {
  bool fold[2];
  int srcw[2], run_lo[2], run_hi[2];
  float gain[2], dither[2];
};

__device__ __forceinline__ void load_planes(const Args& a, size_t row, int n, int i, Planes& p) {
  const int lo = edge(i, a.lm), nb = edge(i + 1, a.lm) - lo, n2b = 2 * nb;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < n2b) {
      const int c = t >= nb;
      const size_t q = row + c * n + lo + (t - c * nb);
      p.fold[u] = a.fold[q] != 0;
      p.srcw[u] = min(max(static_cast<int>(a.srcw[q]), 0), n2b - 1);
      p.run_lo[u] = min(max(static_cast<int>(a.run_lo[q]), 0), n2b);
      p.run_hi[u] = min(max(static_cast<int>(a.run_hi[q]), 0), n2b);
      p.gain[u] = a.fgain[q];
      p.dither[u] = a.dither[q];
    }
  }
}

// Sum over lanes of a warp in a fixed order; lane 0 holds the total.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads) band_walk_kernel(Args a) {
  __shared__ float sX[2 * kMaxN];      // the spectrum, both planes
  __shared__ float sNorm[2 * kMaxNorm];
  __shared__ float sIn[2 * kMaxW];     // the norm window, then xb
  __shared__ float sMid[2 * kMaxW];    // a transform's output
  __shared__ float sFill[2 * kMaxW];
  __shared__ double sCsum[2 * kMaxW + 1];
  __shared__ double sWarp[kWarps];
  __shared__ int sBw0[kNB], sEff[kNB], sSel[kNB];
  __shared__ float sAcR[kAc], sScale[kAc];
  __shared__ unsigned sAcSeed[kAc], sAcMask[kAc];
  __shared__ int sAcN[kAc];
  __shared__ unsigned sAcWords[2 * kAc];
  __shared__ float sGl[kNB], sGr[kNB];
  __shared__ int sDegen[kNB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lm = a.lm, n = 120 << lm;
  const int nl = edge(kNB - 1, lm), e_end = edge(kNB, lm), e17 = edge(17, lm);
  const size_t row = static_cast<size_t>(blockIdx.x) * 2 * n;
  const int* meta = a.meta + static_cast<size_t>(blockIdx.x) * 16;
  const bool c2 = meta[3] == 2, hyb = meta[4] == 17;

  for (int p = tid; p < 2 * n; p += kThreads) sX[p] = a.x[row + p];
  for (int p = tid; p < 2 * nl; p += kThreads) sNorm[p] = 0.f;
  const long long* rec = a.ac + static_cast<size_t>(blockIdx.x) * a.ac_stride;
  for (int k = tid; k < 2 * kAc; k += kThreads) sAcWords[k] = static_cast<unsigned>(rec[k]);
  if (tid < kNB) {  // the band's config and fold offset
    const int i = tid;
    const unsigned* w = reinterpret_cast<const unsigned*>(a.bands) + blockIdx.x * 24;
    const int bw0 = bitfield(w, 24 * i, 16, 24);
    const int eff = bitfield(w + 16, 11 * i, 8, 11) + (hyb ? e17 : 0);
    sBw0[i] = bw0;
    sEff[i] = min(max(eff, 0), max(nl - (edge(i + 1, lm) - edge(i, lm)), 0));
    sSel[i] = a.slots[i * 32 + (bw0 & 31)];
  }
  __syncthreads();
  bool has_ac = false;
  if (tid < kAc) {  // record slot (band, channel), summed in record order
    const int s = tid;
    const int n_ac = a.header[2 * blockIdx.x + 1] >> 18;
    float r = 0.f;
    unsigned seed = 0, mask = 0;
    int count = 0;
    for (int k = 0; k < min(n_ac, kAc); ++k) {
      const unsigned a0 = sAcWords[2 * k];
      const int band = a0 & 0x1F;
      if (band < kNB && 2 * band + static_cast<int>((a0 >> 5) & 1) == s) {
        r += f16_to_f32(a0 >> 16);
        seed += sAcWords[2 * k + 1];
        mask += (a0 >> 8) & 0xFF;
        ++count;
      }
    }
    sAcR[s] = r;
    sAcSeed[s] = seed;
    sAcMask[s] = mask;
    sAcN[s] = count;
    has_ac = count > 0;
  }
  has_ac = __syncthreads_or(has_ac);

  // The fold planes of the band being walked; the next band's are loaded
  // as soon as this band's are used, so their latency hides behind its
  // last phases.
  Planes p = {};
  load_planes(a, row, n, 0, p);
  for (int i = 0; i < kNB; ++i) {
    const int lo = edge(i, lm), hi = edge(i + 1, lm), nb = hi - lo, n2b = 2 * nb;
    const int bw0 = sBw0[i], sel = sSel[i];
    if (i == 18 && hyb) {
      // special_hybrid_folding: band 17's folding data doubled so that band
      // 18 can fold; plane 1 only while dual stereo was on at band 17.  The
      // source [a0, b0) ends where the destination starts.
      const int n1 = edge(18, lm) - edge(17, lm), n2 = edge(19, lm) - edge(18, lm);
      const int a0 = e17 + 2 * n1 - n2, b0 = e17 + n1, len = n2 - n1;
      const bool dual17 = (sBw0[17] >> 5) & 1;
      for (int t = tid; t < 2 * len; t += kThreads) {
        const int c = t >= len, j = t - c * len;
        if (c == 0 || dual17) sNorm[c * nl + b0 + j] = sNorm[c * nl + a0 + j];
      }
      __syncthreads();
    }
    if (((bw0 >> 6) & 1) && lo > 0) {  // intensity switch
      for (int j = tid; j < lo; j += kThreads)
        sNorm[j] = __fmul_rn(0.5f, __fadd_rn(sNorm[j], sNorm[nl + j]));
      __syncthreads();
    }
    // Fold sources: the norm window at eff, through the forward transform.
    const int eff = sEff[i];
    for (int t = tid; t < n2b; t += kThreads) {
      const int c = t >= nb;
      sIn[t] = sNorm[c * nl + eff + t - c * nb];
    }
    __syncthreads();
    const float* ld2 = sIn;
    if (sel != 0) {
      const int at = a.term_off[2 * i] + sel * kTerms * nb;
      transform(a.term_w + at, a.term_c + at, sIn, sMid, nb);
      __syncthreads();
      ld2 = sMid;
    }
    float fill[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tid + u * kThreads;
      if (t < n2b) {
        fill[u] = p.fold[u] ? __fadd_rn(ld2[p.srcw[u]], p.dither[u]) : 0.f;
        sFill[t] = fill[u];
      }
    }
    __syncthreads();
    {  // sCsum[k] = sum of fill^2 over [0, k), in float64: two bins a thread
      const int t0 = 2 * tid;
      const double q0 = t0 < n2b ? static_cast<double>(__fmul_rn(sFill[t0], sFill[t0])) : 0.0;
      const double q1 =
          t0 + 1 < n2b ? static_cast<double>(__fmul_rn(sFill[t0 + 1], sFill[t0 + 1])) : 0.0;
      double incl = q0 + q1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      double excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.0;
      if (lane == 31) sWarp[warp] = incl;
      __syncthreads();
      double base = 0.0;
      for (int w = 0; w < warp; ++w) base += sWarp[w];
      const double p0 = base + excl;
      if (t0 < n2b) sCsum[t0 + 1] = p0 + q0;
      if (t0 + 1 < n2b) sCsum[t0 + 2] = p0 + q0 + q1;
      if (tid == 0) sCsum[0] = 0.0;
      __syncthreads();
    }
    // Each fold leaf renormalised over its run in the band; other bins keep x.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tid + u * kThreads;
      if (t < n2b) {
        const int c = t >= nb;
        float v = sX[c * n + lo + t - c * nb];
        if (p.fold[u]) {
          const float leaf = static_cast<float>(sCsum[p.run_hi[u]] - sCsum[p.run_lo[u]]);
          v = __fmul_rn(fill[u], __fdiv_rn(p.gain[u], __fsqrt_rn(__fadd_rn(kEps, leaf))));
        }
        sIn[t] = v;
      }
    }
    if (i + 1 < kNB) load_planes(a, row, n, i + 1, p);
    __syncthreads();
    const float* xn = sIn;
    if (sel != 0) {
      const int at = a.term_off[2 * i + 1] + sel * kTerms * nb;
      transform(a.term_w + at, a.term_c + at, sIn, sMid, nb);
      __syncthreads();
      xn = sMid;
    }
    // The band's spectrum and its norm (before the merge, which waits until
    // after the walk: only the pre-merge values feed later bands).
    const float sc = static_cast<float>(sqrt(static_cast<double>(nb)));
    const bool dual = (bw0 >> 5) & 1;
    for (int t = tid; t < n2b; t += kThreads) {
      const int c = t >= nb, j = t - c * nb;
      const float v = xn[t];
      sX[c * n + lo + j] = v;
      if (i < kNB - 1 && hi <= nl && (c == 0 || dual)) sNorm[c * nl + lo + j] = __fmul_rn(sc, v);
    }
    __syncthreads();
  }

  if (c2) {  // stereo merge and inversion (a mono stream takes neither)
    for (int i = warp; i < kNB; i += kWarps) {
      double sxy = 0.0, syy = 0.0;
      for (int q = edge(i, lm) + lane; q < edge(i + 1, lm); q += 32) {
        const float x0 = sX[q], y0 = sX[n + q];
        sxy += static_cast<double>(__fmul_rn(y0, x0));
        syy += static_cast<double>(__fmul_rn(y0, y0));
      }
      sxy = warp_sum(sxy);
      syy = warp_sum(syy);
      if (lane == 0) {
        const float imid = static_cast<float>((sBw0[i] >> 8) & 0x7FFF) / 32768.0f;
        const float xp2 = __fmul_rn(2.f, __fmul_rn(imid, static_cast<float>(sxy)));
        const float base = __fadd_rn(__fmul_rn(imid, imid), static_cast<float>(syy));
        const float el = __fsub_rn(base, xp2), er = __fadd_rn(base, xp2);
        sDegen[i] = er < 6e-4f || el < 6e-4f;
        sGl[i] = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(el, 1e-30f)));
        sGr[i] = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(er, 1e-30f)));
      }
    }
    __syncthreads();
    for (int q = tid; q < e_end; q += kThreads) {
      const int i = band_of(q, lm), bw0 = sBw0[i];
      const float x0 = sX[q], y0 = sX[n + q];
      float mx = x0, my = y0;
      if ((bw0 >> 23) & 1) {
        if (sDegen[i]) {
          my = x0;
        } else {
          const float imid = static_cast<float>((bw0 >> 8) & 0x7FFF) / 32768.0f;
          const float l = __fmul_rn(imid, x0);
          mx = __fmul_rn(sGl[i], __fsub_rn(l, y0));
          my = __fmul_rn(sGr[i], __fadd_rn(l, y0));
        }
      }
      sX[q] = mx;
      sX[n + q] = ((bw0 >> 7) & 1) ? -my : my;
    }
    __syncthreads();
  }

  if (has_ac) {  // anti-collapse: the records' cleared blocks get LCG signs
    const int m = 1 << lm;
    for (int p = tid; p < 2 * e_end; p += kThreads) {
      const int c = p >= e_end, q = p - c * e_end;
      const int i = band_of(q, lm), s = 2 * i + c;
      if (sAcN[s] == 0) continue;
      const int off = q - edge(i, lm), k = off & (m - 1);
      const unsigned mask = sAcMask[s];
      if ((mask >> k) & 1) continue;
      // rank of cleared block k = the cleared blocks below it
      const int rank = k - __popc(mask & ((1u << k) - 1));
      const int t = min(max(rank * (kEBands[i + 1] - kEBands[i]) + (off >> lm) + 1, 0),
                        kLcgMax - 1);
      const unsigned sv = a.lcg[t] * sAcSeed[s] + a.lcg[kLcgMax + t];
      sX[c * n + q] = (sv & 0x8000) ? sAcR[s] : -sAcR[s];
    }
    __syncthreads();
  }
  for (int s = warp; s < kAc; s += kWarps) {  // each band with a record renormalised
    if (sAcN[s] == 0) {
      if (lane == 0) sScale[s] = 1.f;
      continue;
    }
    const int i = s >> 1, c = s & 1;
    double acc = 0.0;
    for (int q = edge(i, lm) + lane; q < edge(i + 1, lm); q += 32) {
      const float v = sX[c * n + q];
      acc += static_cast<double>(__fmul_rn(v, v));
    }
    acc = warp_sum(acc);
    if (lane == 0) sScale[s] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(kEps, static_cast<float>(acc))));
  }
  __syncthreads();

  float* out = a.out + row;
  for (int p = tid; p < 2 * n; p += kThreads) {
    const int c = p >= n, q = p - c * n;
    out[p] = __fmul_rn(sX[p], q < e_end ? sScale[2 * band_of(q, lm) + c] : 0.f);
  }
}

}  // namespace

// See Args for the planes; out [rows, 2n] f32 (not aliasing the inputs),
// n = 120 << lm.  Returns the cudaError_t of the launch.
extern "C" int opus_band_walk(const float* x, const int* bands, const int* meta, const int* header,
                              const long long* ac, long long ac_stride, const unsigned char* fold,
                              const long long* srcw, const long long* run_lo,
                              const long long* run_hi, const float* fgain, const float* dither,
                              const int* term_w, const float* term_c, const int* term_off,
                              const int* slots, const unsigned* lcg, float* out, int rows,
                              int lm, void* stream) {
  if (rows <= 0 || lm < 0 || lm > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,      bands,  meta,   header, ac,       ac_stride, fold,  srcw, run_lo, run_hi,
               fgain,  dither, term_w, term_c, term_off, slots,     lcg,   out,  lm};
  band_walk_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
