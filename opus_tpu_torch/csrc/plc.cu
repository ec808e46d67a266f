// The two sequential scans of the pitch-regime loss concealment, for
// Hopper (sm_90a), bound to Python with ctypes (opus_tpu_torch/dsp/plc_scan.py).
//
// Neither replaces a TPU kernel.  They replace two `lax.scan`s of
// opus_tpu/dsp/plc_exec.py, which XLA runs as one device loop each:
//
// * opus_pitch_track: `_find_best_pitch` (plc_exec.py:53-88, the scan at
//   :85), the two-best tracking over the lags of the pitch search.  It
//   runs twice per concealment: 155 coarse lags (length 332) and 310 fine
//   lags (length 664).
// * opus_lpc_synth: the order-24 LPC synthesis (the scan at :298) over
//   n + 120 = 1,080 samples at 20 ms frames.
//
// In eager torch each would be a loop of launches (about 14,000 per
// concealing step).  Each is a recurrence along a row, with rows
// independent: one thread per row walks the row in order.
//
// What bounds them on this card: the dependent chain, not bytes.  At
// B=1024 stereo the inputs are 1.3 MB (pitch) and 8.8 MB (synthesis),
// a few microseconds at 3.35 TB/s; the walk is 487 or 974 dependent steps
// (pitch) and 1,080 (synthesis) of a few arithmetic latencies each, on
// at most 2,048 threads, so most SMs hold one warp and nothing hides the
// latency.  The design keeps each step short: the pitch walk's running
// energy is the only value carried through an add; the synthesis keeps
// its 24-sample history in registers and splits the 24-term sum over
// four accumulators, with the newest sample added last, so a sample
// waits on the one before through two operations, not 24.
//
// pitch_track must equal its plain version index for index, so every
// product is rounded before it is compared or added (__fmul_rn and
// __fadd_rn are never contracted into a fused multiply-add), the initial
// energy is summed in order from 1, and the comparisons are those of the
// reference: num * bd > bn * syy.

#include <cuda_runtime.h>

namespace {

constexpr int kOrder = 24;
constexpr int kThreads = 32;  // one warp per block: rows spread over the SMs

__global__ void __launch_bounds__(kThreads)
pitch_track_kernel(const float* __restrict__ xcorr, long long xc_rs,
                   const float* __restrict__ y, long long y_rs, long long y_cs, int rows,
                   int length, int n_lags, int* __restrict__ bp0_out,
                   int* __restrict__ bp1_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* yr = y + r * y_rs;
  const float* xr = xcorr + r * xc_rs;
  float syy = 1.0f;
  for (int t = 0; t < length; ++t) {
    const float v = __ldg(yr + t * y_cs);
    syy = __fadd_rn(syy, __fmul_rn(v, v));
  }
  float bn0 = -1.0f, bd0 = 0.0f, bn1 = -1.0f, bd1 = 0.0f;
  int bp0 = 0, bp1 = 1;
  for (int i = 0; i < n_lags; ++i) {
    const float xc = __ldg(xr + i);
    const float x16 = __fmul_rn(xc, 1e-12f);
    const float num = __fmul_rn(x16, x16);
    if (xc > 0.0f && __fmul_rn(num, bd1) > __fmul_rn(bn1, syy)) {
      if (__fmul_rn(num, bd0) > __fmul_rn(bn0, syy)) {
        bn1 = bn0;
        bd1 = bd0;
        bp1 = bp0;
        bn0 = num;
        bd0 = syy;
        bp0 = i;
      } else {
        bn1 = num;
        bd1 = syy;
        bp1 = i;
      }
    }
    const float a = __ldg(yr + (length + i) * y_cs);
    const float b = __ldg(yr + i * y_cs);
    const float dl = __fsub_rn(__fmul_rn(a, a), __fmul_rn(b, b));
    syy = fmaxf(1.0f, __fadd_rn(syy, dl));
  }
  bp0_out[r] = bp0;
  bp1_out[r] = bp1;
}

__global__ void __launch_bounds__(kThreads)
lpc_synth_kernel(const float* __restrict__ ext, const float* __restrict__ lpc,
                 const float* __restrict__ hist0, float* __restrict__ out, int rows, int el) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float a[kOrder], h[kOrder];  // h[j]: the output 1 + j samples back
#pragma unroll
  for (int j = 0; j < kOrder; ++j) {
    a[j] = __ldg(lpc + r * kOrder + j);
    h[j] = __ldg(hist0 + r * kOrder + j);
  }
  const float* er = ext + static_cast<size_t>(r) * el;
  float* orow = out + static_cast<size_t>(r) * el;
  for (int t = 0; t < el; ++t) {
    // Oldest terms first, in four independent sums; the newest sample,
    // h[0], joins last.
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int j = kOrder - 1; j >= 4; j -= 4) {
      s0 = fmaf(a[j], h[j], s0);
      s1 = fmaf(a[j - 1], h[j - 1], s1);
      s2 = fmaf(a[j - 2], h[j - 2], s2);
      s3 = fmaf(a[j - 3], h[j - 3], s3);
    }
    const float older = (s0 + s1) + (s2 + a[3] * h[3]);
    const float acc = __ldg(er + t) - (fmaf(a[0], h[0], fmaf(a[1], h[1], a[2] * h[2] + s3)) + older);
#pragma unroll
    for (int j = kOrder - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = acc;
    orow[t] = acc;
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
  const int blocks = (rows + kThreads - 1) / kThreads;
  pitch_track_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xcorr, xc_rs, y, y_rs, y_cs, rows, length, n_lags, bp0, bp1);
  return static_cast<int>(cudaGetLastError());
}

// ext [rows, el], lpc [rows, 24], hist0 [rows, 24], out [rows, el]: f32,
// contiguous, out not aliasing the inputs.  Returns the cudaError_t.
extern "C" int opus_lpc_synth(const float* ext, const float* lpc, const float* hist0,
                              float* out, int rows, int el, void* stream) {
  if (rows <= 0 || el <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kThreads - 1) / kThreads;
  lpc_synth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ext, lpc, hist0, out, rows, el);
  return static_cast<int>(cudaGetLastError());
}
