// The SILK synthesis of the SILK-only batch decoder, for Hopper (sm_90a),
// bound to Python with ctypes (opus_tpu_torch/dsp/silk_synthesis.py).
//
// It replaces no TPU kernel.  It replaces the two `lax.scan`s of
// opus_tpu/dsp/silk_synthesis.py, which XLA runs as device loops (in
// eager torch they would be hundreds of launches a frame):
//
// * `_ltp_chunked` (:33, the scan at :59): the voiced long-term predictor
//   P[t] = g exc[t] + sum_j b_j P[t - lag + 2 - j], 5 taps, in chunks of
//   `chunk` samples (10 at 8 kHz, 20 at 12 and 16 kHz), every tap reading
//   the buffer as it stood before the chunk;
// * `_lpc_scan` (:64, the scan at :73): the all-pole filter
//   x[t] = P[t] + sum_j a_j x[t-1-j], order 10 or 16, a1 for the first
//   half of the subframes and a2 for the rest, its history carried in
//   lpc_hist across frames.
//
// Both run for every subframe of a frame in one launch: one warp per row
// (a stream), four rows a block.  The warp stages the row's LTP history
// (head, 18 fs_khz + 2 samples) and excitation in shared memory; then for
// each subframe and chunk the lanes compute one chunk's samples in
// parallel (chunk <= 32) and append them to the buffer, which grows
// across the subframes as the reference's does (subframe k reads P of the
// earlier ones; every row's buffer takes the LTP output, only the LPC's
// input is the excitation for an unvoiced row).  Then lane 0 walks the
// LPC a sample at a time with the history in registers, and the warp
// writes the frame back with coalesced stores.
//
// Rounding.  Every product and sum is one float32 operation, none fused:
// the LTP taps summed from j = 0 up, the LPC prediction from a[0] x[t-1]
// up and added to P[t] last.  That is the plain version's order
// (`_silk_synth_ref`) and XLA:CPU's order for the reference, so the
// kernel equals the plain version bit for bit, and a card run equals the
// port's CPU run.
//
// What bounds it on this card.  At B = 1,024 wideband rows the bytes are
// about 4 MB (excitation and history read, output written: 1.2 us at
// 3.35 TB/s); the LPC's dependent chain is one multiply-add a sample at
// best (320 samples x 4 cycles at 1.98 GHz: 0.65 us).  This kernel keeps
// the reference's summation order, in which x[t-1] enters the prediction
// first, so a sample's chain is a multiply and ORDER + 1 dependent adds
// (about 70 cycles): the LPC walk, not the bytes, sets its time.
// Reassociating the prediction (or the chunked carry of csrc/plc.cu
// lpc_synth) would shorten the chain at the price of bit equality.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr int kLtpOrder = 5;

template <int ORDER>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
    silk_synth_kernel(const float* __restrict__ gexc, const float* __restrict__ a1,
                      const float* __restrict__ a2, const unsigned char* __restrict__ voiced,
                      const int* __restrict__ lags, const float* __restrict__ b_taps,
                      const float* __restrict__ head, const float* __restrict__ hist_in,
                      float* __restrict__ xq, float* __restrict__ hist_out, int rows, int H,
                      int S, int nb, int chunk) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const int L = S * nb;
  float* P = smem + static_cast<size_t>(warp) * (H + 2 * L);  // LTP buffer: head, then the frame
  float* ex = P + H + L;  // the excitation; the LPC overwrites it with the output
  const float* g = gexc + static_cast<size_t>(row) * L;
  const float* hd = head + static_cast<size_t>(row) * H;
  for (int i = lane; i < H; i += kWarp) P[i] = hd[i];
  for (int i = lane; i < L; i += kWarp) ex[i] = g[i];
  __syncwarp();

  // LTP: one chunk a step, a sample a lane.
  for (int k = 0; k < nb; ++k) {
    const int lag = lags[static_cast<size_t>(row) * nb + k];
    const float* bk = b_taps + (static_cast<size_t>(row) * nb + k) * kLtpOrder;
    float b[kLtpOrder];
#pragma unroll
    for (int j = 0; j < kLtpOrder; ++j) b[j] = bk[j];
    const int sub0 = H + k * S;  // buffer index of the subframe's first sample
    for (int t0 = 0; t0 < S; t0 += chunk) {
      const int t = t0 + lane;
      if (lane < chunk && t < S) {
        const int pos = sub0 + t;
        const int done = sub0 + t0;  // the samples before the chunk are final
        float pred = 0.f;
#pragma unroll
        for (int j = 0; j < kLtpOrder; ++j) {
          const int idx = max(pos - lag + 2 - j, 0);
          const float v = idx < done ? P[idx] : 0.f;  // the chunk and beyond read 0
          pred = __fadd_rn(pred, __fmul_rn(b[j], v));
        }
        P[pos] = __fadd_rn(ex[k * S + t], pred);
      }
      __syncwarp();
    }
  }

  // LPC: lane 0 walks the frame; h[j] = x[t-1-j].
  if (lane == 0) {
    const bool is_voiced = voiced[row] != 0;
    const float* hin = hist_in + static_cast<size_t>(row) * ORDER;
    float h[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) h[j] = hin[ORDER - 1 - j];
    const int half = (nb + 1) / 2;
    for (int k = 0; k < nb; ++k) {
      const float* ap = (k < half ? a1 : a2) + static_cast<size_t>(row) * ORDER;
      float a[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j) a[j] = ap[j];
      for (int t = k * S; t < (k + 1) * S; ++t) {
        float pred = 0.f;
#pragma unroll
        for (int j = 0; j < ORDER; ++j) pred = __fadd_rn(pred, __fmul_rn(a[j], h[j]));
        const float x = __fadd_rn(is_voiced ? P[H + t] : ex[t], pred);
#pragma unroll
        for (int j = ORDER - 1; j > 0; --j) h[j] = h[j - 1];
        h[0] = x;
        ex[t] = x;
      }
    }
    float* hout = hist_out + static_cast<size_t>(row) * ORDER;
#pragma unroll
    for (int j = 0; j < ORDER; ++j) hout[ORDER - 1 - j] = h[j];
  }
  __syncwarp();
  float* out = xq + static_cast<size_t>(row) * L;
  for (int i = lane; i < L; i += kWarp) out[i] = ex[i];
}

template <int ORDER>
int launch(const float* gexc, const float* a1, const float* a2, const unsigned char* voiced,
           const int* lags, const float* b_taps, const float* head, const float* hist_in,
           float* xq, float* hist_out, int rows, int H, int S, int nb, int chunk,
           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kRowsPerBlock) * (static_cast<size_t>(H) + 2 * S * nb) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        silk_synth_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  silk_synth_kernel<ORDER><<<blocks, kRowsPerBlock * kWarp, smem, stream>>>(
      gexc, a1, a2, voiced, lags, b_taps, head, hist_in, xq, hist_out, rows, H, S, nb, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gexc [rows, S * nb], a1 / a2 / hist_in / hist_out [rows, order], voiced
// [rows] (bytes, 0 = unvoiced), lags [rows, nb] int32, b_taps [rows, nb, 5],
// head [rows, H], xq [rows, S * nb]: f32 unless stated, contiguous, the
// outputs not aliasing the inputs; order 10 or 16, 1 <= chunk <= 32.
// Returns the cudaError_t.
extern "C" int opus_silk_synth(const float* gexc, const float* a1, const float* a2,
                               const unsigned char* voiced, const int* lags,
                               const float* b_taps, const float* head, const float* hist_in,
                               float* xq, float* hist_out, int rows, int order, int H, int S,
                               int nb, int chunk, void* stream) {
  if (rows <= 0 || H < 0 || S <= 0 || nb <= 0 || chunk < 1 || chunk > kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 10)
    return launch<10>(gexc, a1, a2, voiced, lags, b_taps, head, hist_in, xq, hist_out, rows, H,
                      S, nb, chunk, s);
  if (order == 16)
    return launch<16>(gexc, a1, a2, voiced, lags, b_taps, head, hist_in, xq, hist_out, rows, H,
                      S, nb, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
