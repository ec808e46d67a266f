// CELT pitch post-filter for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces opus_tpu/dsp/pallas_pf.py::_pf_kernel (via pallas_postfilter),
// the TPU kernel of the same recurrence.  What it computes, per row r of
// y [R, W] (history followed by the frame region [hist, hist+n)), row r
// belonging to stream r / C:
//
//   y[i] += sum_f wf[f, i] * ( g[f,0] *  y[i-T_f]
//                            + g[f,1] * (y[i-T_f-1] + y[i-T_f+1])
//                            + g[f,2] * (y[i-T_f-2] + y[i-T_f+2]) )
//
// for i in [hist, hist+n) in order.  nf = 2 filters at lm=0, 3 otherwise,
// cross-faded by WINDOW^2: filter 0 -> 1 over the frame's first 120
// samples, 1 -> 2 over the next 120, then filter 2 alone (a pair of equal
// filters takes the second alone, as the plain version does).  Lags are
// clipped to [15, 1024] and tap gains are GAINS[tapset] * gain.
//
// What bounds it: bytes at best (one frame at B=1024 stereo is about
// 16 MB in and 8 MB out, a few microseconds of HBM traffic), and the
// chain of dependent chunks on the row with the shortest lag: a chunk of
// samples is independent only while it is no longer than the lag - 2.
// One chunk for the whole batch would make every row walk the shortest
// lag's chain (80 steps at chunk 12, 20 of 32 lanes idle).
//
// The design's answer: one warp per row.
// * The kernel reads periods, gains and tapsets [B, 3] in place, at the
//   strides it is given (views of the serving step's `meta`), clips the
//   lags and forms the tap gains from GAINS in constant memory: one
//   launch, no prep.
// * Per-row chunk: the row's shortest active lag - 2, up to 256 (8
//   samples a lane).  Every sample still reads only samples finished
//   before its chunk began, so each sum is the same whatever the chunk.
//   A filter with zero gain is skipped (it adds exactly 0), and a row
//   whose filters all have zero gain returns at once: no load, no store.
// * The chunk loop is compiled for 1, 2, 4 and 8 samples a lane, and a
//   row takes the smallest that covers its chunk: a row with lag 15 walks
//   74 dependent chunks, and each of its steps is then a handful of
//   instructions, not eight guarded slots.  A sample's old value is read
//   with its taps, so a step is one round of shared-memory reads, one
//   __syncwarp(), one round of writes and one more __syncwarp() before
//   the next chunk reads them.
// * The row is staged in shared memory with 16-byte loads, eight in
//   flight a lane, and only from its longest active lag + 2 before the
//   frame; the frame goes back with 16-byte stores.  WINDOW^2 (120
//   floats) sits in shared memory, off the dependent chain's
//   device-memory round trips.
// * Four rows (warps) a block, 7.9 KB of shared memory a row at lm=3: the
//   2,048 rows of a stereo serving step fit on the card in one wave.
//   What is left: the rows with the shortest lags walk their chains after
//   the wave's loads, and the stores follow them.
// ptxas (sm_90a): 64 registers, no spills (the build log that
// chip_smoke.py prints).

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr int kMaxChunk = 256;
constexpr int kLoads = 8;  // 16-byte row loads in flight a lane
constexpr int kMinPeriod = 15;
constexpr int kMaxPeriod = 1024;
constexpr int kFade = 120;  // OVERLAP = SHORT_MDCT_SIZE: one cross-fade

// opus_tpu_torch/celt/modes.py GAINS: tap gains per tapset.
__constant__ float kGains[3][3] = {
    {0.3066406250f, 0.2170410156f, 0.1296386719f},
    {0.4638671875f, 0.2680664062f, 0.0f},
    {0.7998046875f, 0.1000976562f, 0.0f},
};

struct Params {
  const int* periods;
  long long p_row, p_col;
  const float* gains;
  long long g_row, g_col;
  const int* tapsets;
  long long t_row, t_col;
};

// Row capacity in shared memory, floats: the frame and 1026 samples of
// history, from a 16-byte boundary.
__host__ __device__ constexpr int row_floats(int n) { return (n + kMaxPeriod + 2 + 3 + 3) & ~3; }

struct Filter {
  int lag;      // clipped to [15, 1024]
  float g[3];   // tap gains
  bool active;  // nonzero gain
};

// The 5-tap comb of filter f at sample i; s[k] holds y[base + k].
__device__ __forceinline__ float comb(const float* s, int base, int i, const Filter& f) {
  if (!f.active) return 0.f;
  const float* p = s + (i - f.lag - base);
  return f.g[0] * p[0] + f.g[1] * (p[-1] + p[1]) + f.g[2] * (p[-2] + p[2]);
}

// The row's chunk chain over [hist, end) with K samples a lane; s[k]
// holds y[base + k].
template <int K>
__device__ __forceinline__ void chain(float* s, int base, int hist, int end, int chunk,
                                      const float* w2, const Filter* F, bool same01,
                                      bool same12) {
  const int lane = threadIdx.x & 31;
  for (int i0 = hist; i0 < end; i0 += chunk) {
    const int stop = min(i0 + chunk, end);
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + lane + 32 * k;
      if (i < stop) {
        const int j = i - hist;
        float a;
        if (j < kFade) {
          const float wh = same01 ? 1.f : w2[j];
          a = (1.f - wh) * comb(s, base, i, F[0]) + wh * comb(s, base, i, F[1]);
        } else if (j < 2 * kFade) {
          const float wh = same12 ? 1.f : w2[j - kFade];
          a = (1.f - wh) * comb(s, base, i, F[1]) + wh * comb(s, base, i, F[2]);
        } else {
          a = comb(s, base, i, F[2]);
        }
        acc[k] = s[i - base] + a;
      }
    }
    __syncwarp();  // every read of this chunk precedes its writes
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + lane + 32 * k;
      if (i < stop) s[i - base] = acc[k];
    }
    __syncwarp();  // the next chunk reads what this one wrote
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
postfilter_kernel(float* __restrict__ y, Params P, const float* __restrict__ window_sq,
                  int rows, int channels, int w, int hist, int n, int lm, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* w2 = smem;  // [kFade]
  for (int i = threadIdx.x; i < kFade; i += blockDim.x) w2[i] = window_sq[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warps only; no block barrier follows

  const int stream = row / channels;
  const int nf = lm == 0 ? 2 : 3;
  int period[3], tapset[3];
  float gain[3];
  Filter F[3];
  int longest = 0, shortest = kMaxPeriod;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    period[f] = P.periods[stream * P.p_row + f * P.p_col];
    gain[f] = P.gains[stream * P.g_row + f * P.g_col];
    tapset[f] = P.tapsets[stream * P.t_row + f * P.t_col];
    F[f].lag = min(max(period[f], kMinPeriod), kMaxPeriod);
    F[f].active = f < nf && gain[f] != 0.f;
    const int ts = min(max(tapset[f], 0), 2);
#pragma unroll
    for (int k = 0; k < 3; ++k) F[f].g[k] = kGains[ts][k] * gain[f];
    if (F[f].active) {
      longest = max(longest, F[f].lag);
      shortest = min(shortest, F[f].lag);
    }
  }
  if (longest == 0) return;  // every filter has zero gain: y is unchanged

  // A pair of equal filters cross-fades to the second alone.
  const bool same01 = gain[0] == gain[1] && period[0] == period[1] && tapset[0] == tapset[1];
  const bool same12 = gain[1] == gain[2] && period[1] == period[2] && tapset[1] == tapset[2];
  const int chunk = min(shortest - 2, kMaxChunk);
  const int end = hist + n;
  const int base = (hist - longest - 2) & ~3;  // first staged sample
  float* s = smem + kFade + warp * row_floats(n);  // s[k] holds y[base + k]
  float* yr = y + static_cast<size_t>(row) * w;

  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(yr + base);
    float4* dst = reinterpret_cast<float4*>(s);
    const int groups = (end - base) >> 2;
    for (int g0 = lane; g0 < groups; g0 += 32 * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (g0 + 32 * u < groups) v[u] = __ldg(src + g0 + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (g0 + 32 * u < groups) dst[g0 + 32 * u] = v[u];
      }
    }
    for (int i = (end & ~3) + lane; i < end; i += 32) s[i - base] = yr[i];
  } else {
    for (int i = base + lane; i < end; i += 32) s[i - base] = yr[i];
  }
  __syncwarp();

  if (chunk <= 32) {
    chain<1>(s, base, hist, end, chunk, w2, F, same01, same12);
  } else if (chunk <= 64) {
    chain<2>(s, base, hist, end, chunk, w2, F, same01, same12);
  } else if (chunk <= 128) {
    chain<4>(s, base, hist, end, chunk, w2, F, same01, same12);
  } else {
    chain<8>(s, base, hist, end, chunk, w2, F, same01, same12);
  }

  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(s + (hist - base));
    float4* dst = reinterpret_cast<float4*>(yr + hist);
    for (int g = lane; g < (n >> 2); g += 32) dst[g] = src[g];
  } else {
    for (int i = hist + lane; i < end; i += 32) yr[i] = s[i - base];
  }
}

}  // namespace

// y [rows, w] f32, updated in place; row r belongs to stream r / channels.
// periods, tapsets [streams, 3] i32 and gains [streams, 3] f32 at the
// given strides (elements); window_sq [120] f32 (WINDOW^2).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int opus_postfilter(float* y, const int* periods, long long p_row, long long p_col,
                               const float* gains, long long g_row, long long g_col,
                               const int* tapsets, long long t_row, long long t_col,
                               const float* window_sq, int rows, int channels, int w,
                               int hist, int n, int lm, void* stream) {
  // Every lagged read must stay inside the row: i - T - 2 >= hist - 1026.
  if (rows <= 0 || channels <= 0 || lm < 0 || lm > 3 || n != (kFade << lm) ||
      hist < kMaxPeriod + 2 || hist + n > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params P{periods, p_row, p_col, gains, g_row, g_col, tapsets, t_row, t_col};
  const size_t smem = (kFade + static_cast<size_t>(kRowsPerBlock) * row_floats(n)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        postfilter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte row access: rows start on 16-byte boundaries and the frame
  // starts on a 4-sample boundary.
  const bool vec = (reinterpret_cast<size_t>(y) & 15) == 0 && w % 4 == 0 && hist % 4 == 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  postfilter_kernel<<<blocks, kRowsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      y, P, window_sq, rows, channels, w, hist, n, lm, vec);
  return static_cast<int>(cudaGetLastError());
}
