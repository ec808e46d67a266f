// The two sequential scans of the pitch-regime loss concealment, for
// Hopper (sm_90a), bound to Python with ctypes (opus_tpu_torch/dsp/plc_scan.py).
//
// Neither replaces a TPU kernel.  They replace two `lax.scan`s of
// opus_tpu/dsp/plc_exec.py, which XLA runs as one device loop each (in
// eager torch each would be a loop of launches, about 14,000 per
// concealing step):
//
// * opus_pitch_track: `_find_best_pitch` (the scan at plc_exec.py:85), the
//   two-best tracking over the lags of the pitch search: 155 coarse lags
//   (length 332, y at stride 2) and 310 fine lags (length 664), twice per
//   concealment, on 128 rows (the compact variant) or 1,024.
// * opus_lpc_synth: the order-24 LPC synthesis (the scan at :298),
//   out[t] = ext[t] - sum_j lpc[j] out[t-1-j], over n + 120 = 1,080
//   samples at 20 ms frames, on 256 rows (compact) or 2,048.
//
// What bounds them on this card.  Bytes are few (the inputs are 0.5-8.8
// MB, 0.2-2.6 us at 3.35 TB/s) and so is the arithmetic of the sequential
// definitions (48 flops a synthesis sample: 0.7-5.4 us at 67 TFLOP/s).
// A thread that walks a row is bound instead by the row's dependent chain
// (1,080 samples, or 974 energy samples and 310 lags), and with one thread
// per row the lanes of a warp wait on 32 strided loads of 32 rows at every
// step: the first design ran at 3-5% of either bound.
//
// lpc_synth: one warp per row, a chunked recurrence.  The filter is
// linear, so the row is cut into one chunk a lane (L = ceil(el / 32)
// samples, 34 at el = 1,080; no chunk but the last shorter than 24, and
// one chunk below 48 samples).  Each lane filters its chunk from a zero
// history (z; lane 0 filters chunk 0 from the true history, so it is
// exact).  H (L x 24, the same for every chunk of the row) is the response
// to a unit history in each tap; it follows the row recursion H[0][j] =
// -a[j], H[t][j] = H[t-1][j+1] - a[j] H[t-1][0], one multiply-add a row in
// each of lanes 0-23 with two shuffles, in double (the carry and the
// fix-up sum columns of H that nearly cancel when poles sit near the unit
// circle).  The history entering chunk c + 1 is then tail24(z_c) + M s_c,
// M the last 24 rows of H: at most 31 sequential 24 x 24 matrix-vector
// steps, lane j holding s[j] and row j of M, s read back as six 16-byte
// shared-memory broadcasts a step in place of 24 shuffles.  Each lane then
// fixes its chunk in parallel, out = z + H s_c.  ext, z, H and the
// histories live in shared memory (ext copied in by cp.async, coalesced,
// while the H pass runs, and out written back with coalesced stores;
// chunks at an odd stride so the 32 walks hit 32 banks); a lane's
// 24-sample history lives in registers as a ring, the
// time loop unrolled by 24 so that every index is static and no sample
// shifts it.  Loops run the same count in every lane and index steps are
// selects, so no lane diverges.  The chunked form rounds differently from
// the sequential walk of the plain version; it is held to a float64 run
// at 1e-3 of each row's peak, pole pairs at radius 0.995 and 0.999
// included.
//
// pitch_track: one warp per row.  The lanes stage what is off the chain
// into shared memory with coalesced loads: y[0 : length + n_lags]^2 (y
// read at its element stride: the coarse search passes a stride-2 view),
// num[i] = (xcorr * 1e-12)^2 (NaN where xcorr <= 0, so that the
// comparisons below fail as the reference's `xc > 0 &&` does) and
// delta[i] = y[length + i]^2 - y[i]^2.  The initial energy 1 + sum
// y[0:length]^2 is 32 lane partial sums, each in order, added by a fixed
// butterfly of shuffles; the plain version sums in exactly that order.
// Then one lane walks the lags, eight at a time from two 16-byte loads of
// each array: the clamp chain syy = max(1, syy + delta) and the two-best
// selects stay sequential, because the kernel must equal its plain
// version index for index and near-ties (the point of the tie rows) break
// on the exact running energy.  Every product is rounded before it is
// compared or added (__fmul_rn / __fadd_rn are never contracted into a
// fused multiply-add), and the comparisons are the reference's:
// num * bd > bn * syy.  A row's arrays must fit in a quarter of the
// shared memory a block may have (length + 3 n_lags up to about 14,500
// floats; the fine search needs 1,594).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kOrder = 24;

// ---- pitch_track ----------------------------------------------------------

constexpr int kPitchWarps = 4;   // rows per block, one warp each
constexpr int kLagRegs = 16;  // xcorr loads a lane keeps in flight (512 lags)
constexpr int kYRegs = 32;    // y loads a lane keeps in flight (1,024 samples)

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Per-warp shared floats: y^2 [length + n_lags], num and delta [n_lags].
__host__ __device__ inline int pitch_floats(int length, int n_lags) {
  return round4(length + n_lags) + 2 * round4(n_lags);
}

// (xcorr * 1e-12)^2, or NaN where xcorr <= 0.
__device__ __forceinline__ float lag_num(float xc) {
  const float x16 = __fmul_rn(xc, 1e-12f);
  return xc > 0.0f ? __fmul_rn(x16, x16) : __int_as_float(0x7fffffff);
}

// One lag of the two-best tracking, as the reference's scan step: the
// second comparison matters only when the first passed, and a NaN num
// (xcorr <= 0) fails both.
__device__ __forceinline__ void track(float nm, float dl, int i, float& syy, float& bn0,
                                      float& bd0, int& bp0, float& bn1, float& bd1, int& bp1) {
  const bool b1 = __fmul_rn(nm, bd1) > __fmul_rn(bn1, syy);
  const bool b0 = b1 & (__fmul_rn(nm, bd0) > __fmul_rn(bn0, syy));  // no branch
  const float n1 = b1 ? nm : bn1, d1 = b1 ? syy : bd1;
  const int p1 = b1 ? i : bp1;
  bn1 = b0 ? bn0 : n1;
  bd1 = b0 ? bd0 : d1;
  bp1 = b0 ? bp0 : p1;
  bn0 = b0 ? nm : bn0;
  bd0 = b0 ? syy : bd0;
  bp0 = b0 ? i : bp0;
  syy = fmaxf(1.0f, __fadd_rn(syy, dl));
}

__global__ void __launch_bounds__(kPitchWarps * kWarp)
pitch_track_kernel(const float* __restrict__ xcorr, long long xc_rs,
                   const float* __restrict__ y, long long y_rs, long long y_cs, int rows,
                   int length, int n_lags, int* __restrict__ bp0_out,
                   int* __restrict__ bp1_out) {
  extern __shared__ float4 pitch_smem[];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int r = blockIdx.x * kPitchWarps + w;
  if (r >= rows) return;  // the whole warp: warps share no memory
  const float* yr = y + r * y_rs;
  const float* xr = xcorr + r * xc_rs;
  float* y2 = reinterpret_cast<float*>(pitch_smem) + w * pitch_floats(length, n_lags);
  float* num = y2 + round4(length + n_lags);
  float* dl = num + round4(n_lags);

  // Staging, with the loads of a pass in flight together: xcorr (num
  // computed after the y loads are issued), then y in passes of kYRegs
  // loads a lane.  y^2 is kept; syy0 = 1 + sum y[0:length]^2 as lane l's
  // sum of t = l, l + 32, ... in order, then the butterfly (lane l adds
  // lane l ^ k, k = 16 .. 1: every lane ends with lane 0's sum).
  float xc[kLagRegs];
#pragma unroll
  for (int k = 0; k < kLagRegs; ++k) {
    const int i = lane + k * kWarp;
    xc[k] = i < n_lags ? __ldg(xr + i) : 0.0f;
  }
  const int width = length + n_lags;
  const long long ystep = kWarp * y_cs;
  float part = 0.0f;
  for (int t0 = lane; t0 < width; t0 += kYRegs * kWarp) {
    const float* yp = yr + t0 * y_cs;
    float v[kYRegs];
#pragma unroll
    for (int k = 0; k < kYRegs; ++k) v[k] = t0 + k * kWarp < width ? __ldg(yp + k * ystep) : 0.0f;
#pragma unroll
    for (int k = 0; k < kYRegs; ++k) {
      const int t = t0 + k * kWarp;
      const float v2 = __fmul_rn(v[k], v[k]);
      if (t < width) y2[t] = v2;
      if (t < length) part = __fadd_rn(part, v2);
    }
  }
#pragma unroll
  for (int k = 0; k < kLagRegs; ++k) {
    const int i = lane + k * kWarp;
    if (i < n_lags) num[i] = lag_num(xc[k]);
  }
  for (int i = lane + kLagRegs * kWarp; i < n_lags; i += kWarp) num[i] = lag_num(__ldg(xr + i));
#pragma unroll
  for (int k = kWarp / 2; k > 0; k /= 2) part = __fadd_rn(part, __shfl_xor_sync(kFull, part, k));
  __syncwarp();
  for (int i = lane; i < n_lags; i += kWarp) dl[i] = __fsub_rn(y2[length + i], y2[i]);
  __syncwarp();
  if (lane != 0) return;

  // The walk: only the running energy and the two best are carried.
  float syy = __fadd_rn(1.0f, part);
  float bn0 = -1.0f, bd0 = 0.0f, bn1 = -1.0f, bd1 = 0.0f;
  int bp0 = 0, bp1 = 1;
  const int n8 = n_lags & ~7;
#pragma unroll 2
  for (int i = 0; i < n8; i += 8) {
    const float4 na = *reinterpret_cast<const float4*>(num + i);
    const float4 nb = *reinterpret_cast<const float4*>(num + i + 4);
    const float4 da = *reinterpret_cast<const float4*>(dl + i);
    const float4 db = *reinterpret_cast<const float4*>(dl + i + 4);
    track(na.x, da.x, i, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(na.y, da.y, i + 1, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(na.z, da.z, i + 2, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(na.w, da.w, i + 3, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(nb.x, db.x, i + 4, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(nb.y, db.y, i + 5, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(nb.z, db.z, i + 6, syy, bn0, bd0, bp0, bn1, bd1, bp1);
    track(nb.w, db.w, i + 7, syy, bn0, bd0, bp0, bn1, bd1, bp1);
  }
  for (int i = n8; i < n_lags; ++i) track(num[i], dl[i], i, syy, bn0, bd0, bp0, bn1, bd1, bp1);
  bp0_out[r] = bp0;
  bp1_out[r] = bp1;
}

// ---- lpc_synth ------------------------------------------------------------

constexpr int kSynthWarps = 2;  // rows per block, one warp each
constexpr int kWriteBack = 36;   // samples a lane reads before it stores them (1,080: all)
constexpr int kFixBlock = 8;     // fix-up samples computed before their stores

struct Chunks {
  int len;     // L: samples of every chunk but the last
  int count;   // chunks (lanes with work), 1..32
  int stride;  // floats between chunks in shared memory: L rounded up to odd
  int h_floats, s_floats, z_floats;  // per-warp shared regions, 16-byte multiples
};

__host__ __device__ inline Chunks chunks_for(int el) {
  Chunks c;
  const int fit = el / kOrder;  // chunks of at least 24 samples
  const int want = fit < 1 ? 1 : fit > kWarp ? kWarp : fit;
  c.len = (el + want - 1) / want;  // >= 24 when want > 1
  c.count = (el + c.len - 1) / c.len;
  c.stride = c.len | 1;
  c.h_floats = c.count > 1 ? c.len * kOrder : 0;
  c.s_floats = kWarp * kOrder;
  c.z_floats = round4(c.count * c.stride);
  return c;
}

// z, the chunk at zc filtered in place from the history in ring (ring[23 -
// j] the output j + 1 samples back): out[t] = x[t] - sum_j a[j] out[t-1-j]
// for n samples, rounded up to whole rounds of 24 (n the same for the whole
// warp, so that no lane diverges and no branch splits a round); inputs at
// and beyond n_store read as 0 and only outputs t < n_store are stored.
// Sample t sits in ring[t % 24]: with the loop unrolled by 24 every ring
// index is a constant and nothing shifts.  A round's 24 inputs are loaded
// before its first output is stored.  Oldest terms first in four sums; the
// newest output joins last, so a sample waits on the one before through
// two operations.
__device__ __forceinline__ void filter_chunk(const float (&a)[kOrder], float (&ring)[kOrder],
                                             float* zc, int n, int n_store) {
  for (int t0 = 0; t0 < n; t0 += kOrder) {
    float xv[kOrder];
#pragma unroll
    for (int u = 0; u < kOrder; ++u) xv[u] = t0 + u < n_store ? zc[t0 + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < kOrder; ++u) {
      // the output j + 1 samples back sits in ring[(u + 23 - j) % 24]
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
      for (int j = kOrder - 1; j >= 4; j -= 4) {
        s0 = fmaf(a[j], ring[(u + 23 - j) % kOrder], s0);
        s1 = fmaf(a[j - 1], ring[(u + 24 - j) % kOrder], s1);
        s2 = fmaf(a[j - 2], ring[(u + 25 - j) % kOrder], s2);
        s3 = fmaf(a[j - 3], ring[(u + 26 - j) % kOrder], s3);
      }
      const float older = (s0 + s1) + (s2 + a[3] * ring[(u + 20) % kOrder]);
      const float acc =
          xv[u] - (fmaf(a[0], ring[(u + 23) % kOrder],
                        fmaf(a[1], ring[(u + 22) % kOrder], a[2] * ring[(u + 21) % kOrder] + s3)) +
                   older);
      ring[u] = acc;  // replaces the output 24 back, read above
      if (t0 + u < n_store) zc[t0 + u] = acc;
    }
  }
}

// 4 bytes from device memory to shared memory without registers
// (cp.async): the copy lands while the warp computes; copy_wait() waits
// for the thread's copies.
__device__ __forceinline__ void copy_async(float* dst_shared, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// (q, p) = (t / L, t % L) moved on by 32 samples: with two chunks or
// more L >= 24, so p wraps at most twice; with one chunk only t < L
// matters.  Selects, not a loop, so that no lane diverges.
__device__ __forceinline__ void step32(int& q, int& p, int L) {
  p += kWarp;
  if (p >= L) p -= L, ++q;
  if (p >= L) p -= L, ++q;
}

__global__ void __launch_bounds__(kSynthWarps * kWarp)
lpc_synth_kernel(const float* __restrict__ ext, const float* __restrict__ lpc,
                 const float* __restrict__ hist0, float* __restrict__ out, int rows, int el,
                 Chunks ch) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int r = blockIdx.x * kSynthWarps + w;
  if (r >= rows) return;  // the whole warp: warps share no memory
  float* hs = reinterpret_cast<float*>(smem4) + w * (ch.h_floats + ch.s_floats + ch.z_floats);
  float* ss = hs + ch.h_floats;  // ss[c * 24 + j]: the output j + 1 before chunk c
  float* zs = ss + ch.s_floats;  // chunk c at zs + c * stride: ext, then z, then out
  const float* er = ext + static_cast<size_t>(r) * el;
  float* orow = out + static_cast<size_t>(r) * el;
  const int L = ch.len;
  const int my_len = lane < ch.count ? min(L, el - lane * L) : 0;
  const int lane_q = lane >= L ? 1 : 0, lane_p = lane - lane_q * L;  // sample `lane`'s place

  // Stage: lpc and hist0 (the same for every lane) into registers; ext by
  // asynchronous copies that land while the H pass runs (sample t to
  // chunk t / L, place t % L).
  float a[kOrder], ring[kOrder];
#pragma unroll
  for (int j = 0; j < kOrder; ++j) {
    a[j] = __ldg(lpc + r * kOrder + j);
    ring[kOrder - 1 - j] = lane == 0 ? __ldg(hist0 + r * kOrder + j) : 0.0f;
  }
#pragma unroll 4
  for (int t = lane, q = lane_q, p = lane_p; t < el; t += kWarp) {
    copy_async(zs + q * ch.stride + p, er + t);
    step32(q, p, L);
  }
  if (ch.count > 1) {
    // H[t][j], the response to a unit history in tap j: H[0][j] = -a[j],
    // and from one sample on it is -a[j] times the response to tap 0 plus
    // the response to tap j + 1, so H[t][j] = H[t-1][j+1] - a[j] H[t-1][0]:
    // a multiply-add a row in lane j (lanes 24-31 hold the taps past 23,
    // zero).  In double: the carry and the fix-up sum columns of H that
    // nearly cancel when poles sit near the unit circle.
    const double aj = lane < kOrder ? __ldg(lpc + r * kOrder + lane) : 0.0;
    double h = -aj;
    for (int t = 0; t < L; ++t) {
      if (lane < kOrder) hs[t * kOrder + lane] = static_cast<float>(h);
      const double h0 = __shfl_sync(kFull, h, 0);
      const double next_tap = __shfl_down_sync(kFull, h, 1);  // lane 31: its own, zero
      h = fma(-aj, h0, next_tap);
    }
  }
  copy_wait();
  __syncwarp();

  // z: each lane its chunk from a zero history, lane 0 from hist0; every
  // lane runs L samples and stores its own chunk's.
  filter_chunk(a, ring, zs + lane * ch.stride, L, my_len);
  __syncwarp();
  if (ch.count > 1) {
    // The carry: s_{c+1}[j] = z_c[L-1-j] + sum_k H[L-1-j][k] s_c[k], from
    // s_1 = the tail of chunk 0 (exact); lane j < 24 holds s[j] and row j
    // of M in registers.
    const int j = min(lane, kOrder - 1);
    float m[kOrder];
    const float4* mrow = reinterpret_cast<const float4*>(hs + (L - 1 - j) * kOrder);
#pragma unroll
    for (int k = 0; k < kOrder / 4; ++k) {
      const float4 v = mrow[k];
      m[4 * k] = v.x, m[4 * k + 1] = v.y, m[4 * k + 2] = v.z, m[4 * k + 3] = v.w;
    }
    float s = zs[L - 1 - j];
    for (int c = 1; c < ch.count; ++c) {
      if (lane < kOrder) ss[c * kOrder + lane] = s;
      if (c + 1 == ch.count) break;
      __syncwarp();
      // s_c back from shared memory: six 16-byte broadcasts, where
      // __shfl_sync would take 24 shuffles a step
      const float4* sv = reinterpret_cast<const float4*>(ss + c * kOrder);
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
      for (int k = 0; k < kOrder / 4; ++k) {
        const float4 v = sv[k];
        p0 = fmaf(m[4 * k], v.x, p0);
        p1 = fmaf(m[4 * k + 1], v.y, p1);
        p2 = fmaf(m[4 * k + 2], v.z, p2);
        p3 = fmaf(m[4 * k + 3], v.w, p3);
      }
      s = zs[c * ch.stride + L - 1 - j] + ((p0 + p1) + (p2 + p3));
    }
    __syncwarp();

    // The fix-up, every chunk but chunk 0 at once: out = z + H s_c.  Every
    // lane runs L samples (lane 0 and lanes past the last chunk store
    // nothing), so that no lane diverges.
    const bool fix = lane > 0 && lane < ch.count;
    float sc[kOrder];
    const float4* srow = reinterpret_cast<const float4*>(ss + (fix ? lane : 1) * kOrder);
#pragma unroll
    for (int k = 0; k < kOrder / 4; ++k) {
      const float4 v = srow[k];
      sc[4 * k] = v.x, sc[4 * k + 1] = v.y, sc[4 * k + 2] = v.z, sc[4 * k + 3] = v.w;
    }
    float* zc = zs + lane * ch.stride;
    for (int t0 = 0; t0 < L; t0 += kFixBlock) {
      // the block's corrections before any store, so that the H loads are
      // not held behind the stores (rows past L read the region after H)
      float corr[kFixBlock];
#pragma unroll
      for (int u = 0; u < kFixBlock; ++u) {
        const float4* hrow = reinterpret_cast<const float4*>(hs + (t0 + u) * kOrder);
        float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
#pragma unroll
        for (int k = 0; k < kOrder / 4; ++k) {
          const float4 v = hrow[k];
          f0 = fmaf(v.x, sc[4 * k], f0);
          f1 = fmaf(v.y, sc[4 * k + 1], f1);
          f2 = fmaf(v.z, sc[4 * k + 2], f2);
          f3 = fmaf(v.w, sc[4 * k + 3], f3);
        }
        corr[u] = (f0 + f1) + (f2 + f3);
      }
#pragma unroll
      for (int u = 0; u < kFixBlock; ++u) {
        if (fix && t0 + u < my_len) zc[t0 + u] += corr[u];
      }
    }
  }
  __syncwarp();
  for (int t0 = lane, q = lane_q, p = lane_p; t0 < el; t0 += kWriteBack * kWarp) {
    float v[kWriteBack];
#pragma unroll
    for (int k = 0; k < kWriteBack; ++k) {
      v[k] = t0 + k * kWarp < el ? zs[q * ch.stride + p] : 0.0f;
      step32(q, p, L);
    }
#pragma unroll
    for (int k = 0; k < kWriteBack; ++k) {
      const int t = t0 + k * kWarp;
      if (t < el) orow[t] = v[k];
    }
  }
}

}  // namespace

// xcorr [rows, >= n_lags] f32 at row stride xc_rs; y f32 at row stride y_rs
// and element stride y_cs, >= length + n_lags per row; bp0/bp1 [rows] i32.
// Returns the cudaError_t of the launch.
extern "C" int opus_pitch_track(const float* xcorr, long long xc_rs, const float* y,
                                long long y_rs, long long y_cs, int rows, int length,
                                int n_lags, int* bp0, int* bp1, void* stream) {
  if (rows <= 0 || length <= 0 || n_lags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(kPitchWarps) * pitch_floats(length, n_lags) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pitch_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kPitchWarps - 1) / kPitchWarps;
  pitch_track_kernel<<<blocks, kPitchWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      xcorr, xc_rs, y, y_rs, y_cs, rows, length, n_lags, bp0, bp1);
  return static_cast<int>(cudaGetLastError());
}

// ext [rows, el], lpc [rows, 24], hist0 [rows, 24], out [rows, el]: f32,
// contiguous, out not aliasing the inputs.  Returns the cudaError_t.
extern "C" int opus_lpc_synth(const float* ext, const float* lpc, const float* hist0,
                              float* out, int rows, int el, void* stream) {
  if (rows <= 0 || el <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Chunks ch = chunks_for(el);
  const size_t smem =
      static_cast<size_t>(kSynthWarps) * (ch.h_floats + ch.s_floats + ch.z_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lpc_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kSynthWarps - 1) / kSynthWarps;
  lpc_synth_kernel<<<blocks, kSynthWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      ext, lpc, hist0, out, rows, el, ch);
  return static_cast<int>(cudaGetLastError());
}
