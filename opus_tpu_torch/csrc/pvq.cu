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
// What it computes, per used leaf row (plane, off, n, K) of the host's
// leaf table: the stereo op of the band that holds each position (op 2:
// mid/side (x0 + x1) sqrt(1/2) and (x1 - x0) sqrt(1/2); op 3: the
// intensity mix a1 x0 + a2 x1; else x0 / x1; positions past the last
// band are op 0), the leaf's span gathered from plane `plane` at
// clamped positions, the sign from that source, then libopus's greedy
// projection search on |x|: the prefill iy = floor((K + 0.8) / sum|x|
// |x|) when K > n / 2 (a sum that is not in (1e-15, 64) collapses |x|
// to e1 for the whole search), and one pulse a trip at the first maximum
// of (xy + |x_j|)^2 / (yy + 1 + 2 iy_j), min(left, t_max) trips.
//
// Layout.  The pulses are packed: iy is one flat int16 buffer holding
// each used leaf's min(n, NMAX) signed pulses, streams in order and each
// stream's leaves in plan order, so leaf (b, p) starts at the exclusive
// cumulative sum of the used widths before it.  The host writes that
// start beside the leaf's flat row b * P + p in a row list (int2), which
// it groups into four width classes: wider than 32, 17-32, 9-16, 1-8.
// Unused rows (n == 0) are in no list and launch nothing; `left` is
// zeroed by a memset in the same call and written for the used rows.
//
// Design: one launch, four warps a block, each block of one class (the
// widest class's blocks first, as they run longest).  A leaf of width
// <= w (w = 8, 16, 32) takes a w-lane tile of a warp, so a warp searches
// 32 / w leaves; lane l of the tile holds position l.  A wider leaf
// takes a whole warp, lane l holding positions l, l + 32, ... in
// ceil(n / 32) slots of at most six (NMAX <= 192).  |x|, iy and the sign
// stay in registers; xy and yy are tile-uniform scalars.  A trip scores
// the lane's slots, takes the lane's first maximum, and two reductions
// over the tile's mask (redux.sync: the largest score's bits, then the
// least position that holds it) give every lane the leaf's first maximum;
// the owner's |x| and iy are broadcast with one shuffle each.  Each tile
// runs its leaf's own trip count.  The band of a position is a byte table, kUnitBand, over
// the 120 units of 1 << lm positions (every band edge is a multiple of
// 1 << lm), built at compile time from kEBands and read through the
// read-only cache: one load, not a 20-compare loop.
//
// Rounding, so that the plain version (`_pvq_search_ref`) agrees pulse
// for pulse: every operation is one IEEE float32 operation, __fadd_rn /
// __fmul_rn / __fdiv_rn (nvcc would fuse a * b + c into one FMA, and a
// fast division is not correctly rounded); the only order-dependent sums
// (sum |x| and xy of the prefill) run in slot order then the butterfly,
// which `_lane_sum` repeats over 32 lanes.  In a tile of w lanes, every
// position >= n is an exact 0, so the levels 16 ... w apart that the tile
// skips add only zeros there: the same float32 sums.  yy, the pulse
// counts and the one-hot updates are exact.
//
// What bounds it on this card.  The bytes the work needs are about 10 MB
// at B = 1,024 (x at the covered positions, the used leaf rows, the row
// list, the packed iy and left): 3 us at 3.35 TB/s.  A leaf's trips (at
// most 128; 10 at most on 96 kbps music) are a chain of an add, a square,
// a division and two reductions: well under 1 us alone.  What bounds it is
// each warp's serial time, about 12,000 cycles under load, over five waves
// of 64 warps an SM (about 41,000 warps at B = 1,024): the dependent loads
// (row list, leaf row, then x and the band ops), the prefill and the trips,
// on an SM whose issue slots 64 warps share.  tools/pvq_phases.py measures
// it on encode step 0: no trip at all (t_max = 0) takes about half the
// time; a fast division, or no band lookup, would save 6% and 3%; reading
// the next leaves ahead (four a tile) and a lower occupancy were slower.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWideSlots = 6;  // positions a lane of the widest class: NMAX <= 192
constexpr int kWarps = 4;      // warps a block
constexpr int kBands = 21;     // NB_E_BANDS
constexpr int kUnits = 120;    // SHORT_MDCT_SIZE: n2 >> lm
constexpr int kClasses = 4;    // width classes: > 32, 17-32, 9-16, 1-8
constexpr unsigned kFull = 0xffffffffu;
// Lanes a leaf of each class takes, in the row list's order
// (dsp/pvq_search.py's CLASS_TILES): a warp, ceil(n / 32) slots a lane, for
// the widest; then tiles of one position a lane for n up to their width.
constexpr int kTiles[kClasses] = {kWarp, 32, 16, 8};

// modes.E_BANDS, in units of 1 << lm positions.
constexpr int kEBands[kBands + 1] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12,
                                     14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100};

struct UnitBands {
  unsigned char band[kUnits];
};

// The band that holds each unit of 1 << lm positions; kBands (op 0) past
// the last band.
constexpr UnitBands unit_bands() {
  UnitBands t{};
  for (int u = 0; u < kUnits; ++u) t.band[u] = kBands;
  for (int e = 0; e < kBands; ++e)
    for (int u = kEBands[e]; u < kEBands[e + 1]; ++u) t.band[u] = static_cast<unsigned char>(e);
  return t;
}

__device__ __align__(128) const UnitBands kUnitBand = unit_bands();

struct Args {
  const float* x;         // [B, C, n2]
  const float4* ops;      // [B, NB]: op, a1, a2, _
  const int4* leaves;     // [B * P]: plane, flat offset, n, K
  const int2* order;      // [R]: flat row, start in iy; grouped by class
  short* iy;              // [total]
  int* left;              // [B * P]
  int rows, P, C, n2, lm, n_max, t_max, total;
  int first_block[kClasses + 1];  // the class's first block; the grid's size last
  int base[kClasses];             // the class's first entry of `order`
  int count[kClasses];            // its leaves
};

// Float sum over the leaf: each lane's S slots in order, then the tile's
// butterfly (W / 2 ... 1 apart).
template <int W, int S>
__device__ __forceinline__ float tile_sum(const float (&v)[S], unsigned mask) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < S; ++i) s = __fadd_rn(s, v[i]);
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(mask, s, m, W));
  return s;
}

// One leaf on a tile of W lanes (tl: the lane's place in it), S slots a
// lane at most.  Every branch before the trips is uniform over the tile.
template <int W, int S>
__device__ __forceinline__ void search_leaf(const Args& a, int2 item, int tl, unsigned mask) {
  const int row = item.x, start = item.y;
  if (row < 0 || row >= a.rows) return;
  const int4 leaf = __ldg(a.leaves + row);
  const int ln = leaf.z, kk = leaf.w;
  const int w = min(ln, a.n_max);  // positions searched and written
  if (ln <= 0 || w > W * S || start < 0 || start > a.total - w) return;
  const int b = row / a.P;
  const float* x0p = a.x + static_cast<size_t>(b) * a.C * a.n2;
  const float* x1p = x0p + static_cast<size_t>(a.C - 1) * a.n2;
  const float4* ops = a.ops + static_cast<size_t>(b) * kBands;
  const bool side_plane = leaf.x >= 1;  // plane clamped to 0..1
  const float rt2 = __int_as_float(0x3f3504f3);  // float32(sqrt(0.5))
  const float eps = 1e-15f;

  float ax[S];
  int iy[S];
  unsigned neg = 0, in = 0;  // bit i: slot i's source < 0; slot i inside the leaf
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = tl + W * i;
    const bool inside = j < w;
    float src = 0.f;
    if (inside) {
      const int pos = min(max(leaf.y + j, 0), a.n2 - 1);
      const int band = __ldg(&kUnitBand.band[pos >> a.lm]);
      float4 op = make_float4(0.f, 0.f, 0.f, 0.f);
      if (band < kBands) op = __ldg(ops + band);
      const float v0 = __ldg(x0p + pos), v1 = __ldg(x1p + pos);
      if (side_plane)
        src = op.x == 2.f ? __fmul_rn(__fsub_rn(v1, v0), rt2) : v1;
      else if (op.x == 2.f)
        src = __fmul_rn(__fadd_rn(v0, v1), rt2);
      else if (op.x == 3.f)
        src = __fadd_rn(__fmul_rn(op.y, v0), __fmul_rn(op.z, v1));
      else
        src = v0;
    }
    ax[i] = inside ? fabsf(src) : 0.f;
    iy[i] = 0;
    neg |= static_cast<unsigned>(src < 0.f) << i;
    in |= static_cast<unsigned>(inside) << i;
  }

  // Projection prefill (K > n / 2).
  float sum_ax = tile_sum<W, S>(ax, mask);
  if (kk > (ln >> 1)) {
    if (!(sum_ax > eps && sum_ax < 64.f)) {  // degenerate: |x| becomes e1
#pragma unroll
      for (int i = 0; i < S; ++i) ax[i] = (i == 0 && tl == 0) ? 1.f : 0.f;
      sum_ax = 1.f;
    }
    const float rcp = __fdiv_rn(__fadd_rn(static_cast<float>(kk), 0.8f), fmaxf(sum_ax, eps));
#pragma unroll
    for (int i = 0; i < S; ++i)
      iy[i] = (in >> i & 1) ? static_cast<int>(floorf(__fmul_rn(rcp, ax[i]))) : 0;
  }
  float prod[S];
  int cnt = 0, sq = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    prod[i] = __fmul_rn(ax[i], static_cast<float>(iy[i]));
    cnt += iy[i];
    sq += iy[i] * iy[i];
  }
  float xy = tile_sum<W, S>(prod, mask);
  const int left0 = kk - __reduce_add_sync(mask, cnt);  // integer sums: exact in any order
  float yy = static_cast<float>(__reduce_add_sync(mask, sq));

  // Greedy trips: one pulse a trip at the first maximum of the score.
  // Every score inside the leaf is >= +0, so its bits order as unsigned
  // integers do: the tile's maximum is one redux, and its first position
  // the least index among the lanes that hold it (each lane offers its own
  // first maximum; a lane with no position offers 0 and no index).
  const int trips = left0 > 0 ? min(left0, a.t_max) : 0;
  for (int t = 0; t < trips; ++t) {
    const float yy1 = __fadd_rn(yy, 1.f);
    float best = -1.f;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (in >> i & 1) {
        const float s = __fadd_rn(xy, ax[i]);
        const float den = __fadd_rn(yy1, static_cast<float>(2 * iy[i]));
        const float sc = __fdiv_rn(__fmul_rn(s, s), fmaxf(den, eps));
        if (sc > best) {  // strict: the lane's first maximum
          best = sc;
          best_j = tl + W * i;
        }
      }
    }
    const unsigned key = __float_as_uint(fmaxf(best, 0.f));
    const unsigned top = __reduce_max_sync(mask, key);
    best_j = __reduce_min_sync(mask, key == top ? best_j : 0x7fffffff);
    const int owner = best_j % W, slot = best_j / W;
    float a_own = 0.f;
    int i_own = 0;
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (i == slot) {
        a_own = ax[i];
        i_own = iy[i];
      }
    const float a_best = __shfl_sync(mask, a_own, owner, W);
    const int i_best = __shfl_sync(mask, i_own, owner, W);
    xy = __fadd_rn(xy, a_best);
    yy = __fadd_rn(yy1, static_cast<float>(2 * i_best));
    if (tl == owner) {
#pragma unroll
      for (int i = 0; i < S; ++i)
        if (i == slot) ++iy[i];
    }
  }

  short* out = a.iy + start;
#pragma unroll
  for (int i = 0; i < S; ++i)
    if (in >> i & 1) out[tl + W * i] = static_cast<short>((neg >> i & 1) ? -iy[i] : iy[i]);
  if (tl == 0) a.left[row] = left0 > 0 ? max(left0 - a.t_max, 0) : 0;
}

// The leaves of class `cls` that this warp searches: 32 / W a warp.
template <int W, int S>
__device__ __forceinline__ void search_class(const Args& a, int cls) {
  constexpr int per_warp = kWarp / W;
  const int lane = threadIdx.x & (kWarp - 1);
  const int tile = lane / W;
  const int i = ((blockIdx.x - a.first_block[cls]) * kWarps + (threadIdx.x >> 5)) * per_warp +
                tile;
  if (i >= a.count[cls]) return;
  const unsigned mask = (kFull >> (kWarp - W)) << (tile * W);
  search_leaf<W, S>(a, __ldg(a.order + a.base[cls] + i), lane % W, mask);
}

// 16 blocks an SM (at most 32 registers a thread): the whole SM's 64 warps in
// flight to cover the prologue's dependent loads.
__global__ void __launch_bounds__(kWarp * kWarps, 16) pvq_search_kernel(const Args a) {
  int cls = 0;
  while (cls < kClasses - 1 && static_cast<int>(blockIdx.x) >= a.first_block[cls + 1]) ++cls;
  switch (cls) {
    case 0: search_class<kTiles[0], kWideSlots>(a, 0); break;
    case 1: search_class<kTiles[1], 1>(a, 1); break;
    case 2: search_class<kTiles[2], 1>(a, 2); break;
    default: search_class<kTiles[3], 1>(a, 3); break;
  }
}

}  // namespace

extern "C" int opus_pvq_search(const float* x, const float* band_ops, const int* leaves,
                               const int* order, short* iy, int* left, int batch, int P, int C,
                               int n2, int lm, int n_max, int t_max, int n_wide, int n32,
                               int n16, int n8, int total, void* stream) {
  if (batch < 0 || P < 0 || (C != 1 && C != 2) || lm < 0 || lm > 3 || n2 != kUnits << lm ||
      n_max <= 0 || n_max > kWarp * kWideSlots || t_max < 0 || n_wide < 0 || n32 < 0 ||
      n16 < 0 || n8 < 0 || total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(batch) * P;
  if (rows == 0) return 0;
  cudaError_t err = cudaMemsetAsync(left, 0, rows * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, reinterpret_cast<const float4*>(band_ops), reinterpret_cast<const int4*>(leaves),
         reinterpret_cast<const int2*>(order), iy, left, static_cast<int>(rows), P, C, n2, lm,
         n_max, t_max, total, {}, {}, {}};
  const int counts[kClasses] = {n_wide, n32, n16, n8};
  int blocks = 0, base = 0;
  for (int c = 0; c < kClasses; ++c) {
    const int per_block = kWarps * (kWarp / kTiles[c]);
    a.first_block[c] = blocks;
    a.base[c] = base;
    a.count[c] = counts[c];
    blocks += (counts[c] + per_block - 1) / per_block;
    base += counts[c];
  }
  a.first_block[kClasses] = blocks;
  if (blocks == 0) return 0;
  pvq_search_kernel<<<blocks, kWarp * kWarps, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
