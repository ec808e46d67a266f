// The encode plane's greedy PVQ search, for Hopper (sm_90a), bound to
// Python with ctypes (opus_tpu_torch/dsp/pvq_search.py).
//
// It replaces no TPU kernel.  It replaces the `lax.while_loop` of
// opus_tpu/dsp/encode_exec.py (`make_encode_search`, :165; the loop at
// :265), which runs up to t_max = 128 trips over the whole padded
// [B, P, NMAX] leaf area and leaves the batch when no leaf has a pulse
// left: in eager torch each trip's exit test would be a device-to-host
// read.
//
// What it computes, per leaf row (plane, off, n, K) of the host's leaf
// table: the stereo op of the band that holds each position (op 2:
// mid/side (x0 + x1) sqrt(1/2) and (x1 - x0) sqrt(1/2); op 3: the
// intensity mix a1 x0 + a2 x1; else x0 / x1; positions past the last
// band are op 0), the leaf's span gathered from plane `plane` at
// clamped positions, the sign from that source, then libopus's greedy
// projection search on |x|: the prefill iy = floor((K + 0.8) / sum|x|
// |x|) when K > n / 2 (a sum that is not in (1e-15, 64) collapses |x|
// to e1 for the whole search), and one pulse a trip at the first maximum
// of (xy + |x_j|)^2 / (yy + 1 + 2 iy_j), min(left, t_max) trips.
//
// Design: one warp a leaf, four leaves a block.  Lane l holds positions
// l, l + 32, ..., l + 160 (six slots, NMAX <= 192) in registers: |x|, iy
// and the sign.  xy and yy are warp-uniform scalars.  A trip scores the
// lane's six slots, takes the lane's first maximum, and a shuffle
// butterfly (16 ... 1 apart) on (score, index) gives every lane the
// leaf's first maximum; the owning lane's |x| and iy are broadcast with
// one shuffle each.  Each leaf runs its own trip count (the batch's
// lockstep count was the while_loop's), so rows with no pulses left exit
// at once, and an unused row (n == 0) only writes its zeros.  No shared
// memory, no host round trip.
//
// Rounding, so that the plain version (`_pvq_search_ref`) agrees pulse
// for pulse: every operation is one IEEE float32 operation, __fadd_rn /
// __fmul_rn / __fdiv_rn (nvcc would fuse a * b + c into one FMA, and a
// fast division is not correctly rounded); the only order-dependent sums
// (sum |x| and xy of the prefill) run in lane order then the butterfly,
// which `_lane_sum` repeats; yy, the pulse counts and the one-hot
// updates are exact.
//
// What bounds it on this card.  The padded output dominates the bytes:
// iy is B x P x NMAX int32, 115 MB at B = 1,024, P = 160, NMAX = 176, a
// write of 34 us at 3.35 TB/s; the inputs (x, band_ops, leaves) add about
// 15 MB.  The dependent chain is a leaf's trips (at most 128; about 40 on
// 96 kbps music), each an add, a square, a division and the argmax's
// compare levels: about 1 us at 48 cycles a trip.  So it is bound by
// bytes; narrowing the iy layout (and its download) is the lever, not
// the search.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlots = 6;    // positions a lane: NMAX <= 192
constexpr int kWarps = 4;    // leaves a block
constexpr int kBands = 21;   // NB_E_BANDS
constexpr unsigned kFull = 0xffffffffu;

// modes.E_BANDS, in units of 1 << lm positions.
__constant__ int kEBands[kBands + 1] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12,
                                        14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100};

__device__ __forceinline__ float lane_sum(const float (&v)[kSlots]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kSlots; ++i) s = __fadd_rn(s, v[i]);
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, m));
  return s;
}

__global__ void __launch_bounds__(kWarp * kWarps)
pvq_search_kernel(const float* __restrict__ x, const float* __restrict__ band_ops,
                  const int4* __restrict__ leaves, int* __restrict__ iy_out,
                  int* __restrict__ left_out, int rows, int P, int C, int n2, int m, int n_max,
                  int t_max) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int4 leaf = leaves[row];  // plane, flat offset, n, K
  int* out = iy_out + static_cast<size_t>(row) * n_max;
  const int ln = leaf.z, kk = leaf.w;
  if (ln <= 0) {
    for (int j = lane; j < n_max; j += kWarp) out[j] = 0;
    if (lane == 0) left_out[row] = 0;
    return;
  }
  const int b = row / P;
  const float* x0p = x + static_cast<size_t>(b) * C * n2;
  const float* x1p = x0p + static_cast<size_t>(C - 1) * n2;
  const float* ops = band_ops + static_cast<size_t>(b) * kBands * 4;
  const bool side_plane = leaf.x >= 1;  // plane clamped to 0..1
  const float rt2 = __int_as_float(0x3f3504f3);  // float32(sqrt(0.5))
  const float eps = 1e-15f;
  const float neg_inf = -__int_as_float(0x7f800000);
  const int last = kEBands[kBands] * m;

  float ax[kSlots];
  int iy[kSlots];
  unsigned neg = 0, in = 0;  // bit i: slot i's source < 0; slot i inside the leaf
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = lane + kWarp * i;
    const int pos = min(max(leaf.y + j, 0), n2 - 1);
    float op = 0.f, a1 = 0.f, a2 = 0.f;
    if (pos < last) {
      int band = 0;
#pragma unroll
      for (int e = 1; e < kBands; ++e) band += pos >= kEBands[e] * m;
      op = __ldg(ops + 4 * band);
      a1 = __ldg(ops + 4 * band + 1);
      a2 = __ldg(ops + 4 * band + 2);
    }
    const float v0 = __ldg(x0p + pos), v1 = __ldg(x1p + pos);
    float src;
    if (side_plane)
      src = op == 2.f ? __fmul_rn(__fsub_rn(v1, v0), rt2) : v1;
    else if (op == 2.f)
      src = __fmul_rn(__fadd_rn(v0, v1), rt2);
    else if (op == 3.f)
      src = __fadd_rn(__fmul_rn(a1, v0), __fmul_rn(a2, v1));
    else
      src = v0;
    const bool inside = j < ln && j < n_max;
    ax[i] = inside ? fabsf(src) : 0.f;
    iy[i] = 0;
    neg |= static_cast<unsigned>(src < 0.f) << i;
    in |= static_cast<unsigned>(inside) << i;
  }

  // Projection prefill (K > n / 2).
  float sum_ax = lane_sum(ax);
  if (kk > (ln >> 1)) {
    if (!(sum_ax > eps && sum_ax < 64.f)) {  // degenerate: |x| becomes e1
#pragma unroll
      for (int i = 0; i < kSlots; ++i) ax[i] = (i == 0 && lane == 0) ? 1.f : 0.f;
      sum_ax = 1.f;
    }
    const float rcp = __fdiv_rn(__fadd_rn(static_cast<float>(kk), 0.8f), fmaxf(sum_ax, eps));
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      iy[i] = (in >> i & 1) ? static_cast<int>(floorf(__fmul_rn(rcp, ax[i]))) : 0;
  }
  float prod[kSlots];
  int placed = 0, yy_i = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    prod[i] = __fmul_rn(ax[i], static_cast<float>(iy[i]));
    placed += iy[i];
    yy_i += iy[i] * iy[i];
  }
  float xy = lane_sum(prod);
#pragma unroll
  for (int mask = kWarp / 2; mask > 0; mask >>= 1) {
    placed += __shfl_xor_sync(kFull, placed, mask);
    yy_i += __shfl_xor_sync(kFull, yy_i, mask);
  }
  float yy = static_cast<float>(yy_i);
  const int left0 = kk - placed;

  // Greedy trips: one pulse a trip at the first maximum of the score.
  const int trips = left0 > 0 ? min(left0, t_max) : 0;
  for (int t = 0; t < trips; ++t) {
    const float yy1 = __fadd_rn(yy, 1.f);
    float best = neg_inf;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = lane + kWarp * i;
      const float s = __fadd_rn(xy, ax[i]);
      const float den = __fadd_rn(yy1, static_cast<float>(2 * iy[i]));
      const float sc = (in >> i & 1) ? __fdiv_rn(__fmul_rn(s, s), fmaxf(den, eps))
                                     : (j < n_max ? -1.f : neg_inf);
      if (sc > best) {  // strict: the lane's first maximum
        best = sc;
        best_j = j;
      }
    }
#pragma unroll
    for (int mask = kWarp / 2; mask > 0; mask >>= 1) {
      const float o = __shfl_xor_sync(kFull, best, mask);
      const int oj = __shfl_xor_sync(kFull, best_j, mask);
      if (o > best || (o == best && oj < best_j)) {
        best = o;
        best_j = oj;
      }
    }
    const int owner = best_j & (kWarp - 1), slot = best_j >> 5;
    float a_own = 0.f;
    int i_own = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (i == slot) {
        a_own = ax[i];
        i_own = iy[i];
      }
    const float a_best = __shfl_sync(kFull, a_own, owner);
    const int i_best = __shfl_sync(kFull, i_own, owner);
    xy = __fadd_rn(xy, a_best);
    yy = __fadd_rn(yy1, static_cast<float>(2 * i_best));
    if (lane == owner) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        if (i == slot && (in >> i & 1)) ++iy[i];
    }
  }

#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = lane + kWarp * i;
    if (j < n_max) out[j] = (in >> i & 1) ? ((neg >> i & 1) ? -iy[i] : iy[i]) : 0;
  }
  if (lane == 0) left_out[row] = left0 > 0 ? max(left0 - t_max, 0) : 0;
}

}  // namespace

extern "C" int opus_pvq_search(const float* x, const float* band_ops, const int* leaves,
                               int* iy, int* left, int batch, int P, int C, int n2, int m,
                               int n_max, int t_max, void* stream) {
  if (batch < 0 || P < 0 || (C != 1 && C != 2) || n2 <= 0 || m <= 0 || n_max <= 0 ||
      n_max > kWarp * kSlots || t_max < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * P;
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  pvq_search_kernel<<<grid, kWarp * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      x, band_ops, reinterpret_cast<const int4*>(leaves), iy, left, rows, P, C, n2, m, n_max,
      t_max);
  return static_cast<int>(cudaGetLastError());
}
