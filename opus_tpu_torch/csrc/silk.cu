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
// (a stream), four rows a block.
//
// What bounds it on this card.  At B = 1,024 wideband rows the bytes the
// inputs need are about 3.09 MB (excitation, coefficients and history
// read, output written, and of a voiced row's LTP history only what its
// taps reach): 0.92 us at 3.35 TB/s.  The arithmetic is small.  What a
// warp cannot escape is its dependent chain, and the sequential LPC walk
// (320 samples, each waiting on the one before through a multiply and up
// to ORDER + 1 adds in the reference's order: about 11.6 us at 1.98 GHz)
// is what held the first design to 3.5% of the byte bound, with 31 of 32
// lanes idle.  This design cuts that chain:
//
// * LTP (voiced rows only: an unvoiced row's output does not read it):
//   one chunk a step, a sample a lane, into a shared-memory buffer of
//   history then frame that grows across the subframes as the
//   reference's does; each lane loads its five taps at once and sums them
//   from j = 0 with __fmul_rn / __fadd_rn, no fused multiply-add, so P is
//   bit-equal to the plain version's.  A step is up to lag - 2 samples
//   (at most 32), which reads only finished samples: 12 steps at 16 kHz
//   for a voiced row (lag >= 32), 16 at the shortest lag the plain
//   version's chunk allows.  The LTP buffer takes P, never the LPC output,
//   so the whole frame's LTP is done before the LPC starts.
// * LPC, a chunked recurrence, one chunk a lane (as csrc/plc.cu
//   lpc_synth).  The frame is cut into chunks of n samples, n the
//   shortest divisor of the subframe at least ORDER long that gives at
//   most 32 chunks (`layout_for`; Python's `lpc_chunks`): 16 chunks of 10
//   at 8 kHz, 24 of 10 at 12 kHz, 20 of 16 at 16 kHz, meeting the a1/a2
//   boundary.  Each lane filters its chunk from a zero history, in float32
//   with fused multiply-adds, and keeps the last ORDER outputs, z (lane 0
//   from lpc_hist, so its tail is final).  M1 and M2 (ORDER x ORDER, for
//   a1 and a2) are the last ORDER rows of H, the responses to a unit
//   history in each tap: H[0][j] = a[j], H[t][j] = H[t-1][j+1] + a[j]
//   H[t-1][0] (SILK's sign: + sum a_j x), one double multiply-add a row in
//   each lane, lanes 0-15 for a1 and 16-31 for a2, while the staging
//   copies land.  The history entering chunk c + 1 is then s_{c+1} =
//   tail(z_c) + M s_c, M chunk c's own (M1 across the half boundary):
//   count - 1 sequential ORDER x ORDER matrix-vector steps in double (19
//   at 16 kHz), lane j holding s[j] and row j of M, s read back as 16-byte
//   shared-memory broadcasts.  Then every lane filters its chunk again, in
//   float32 from the history carried to it: the output (cheaper than a
//   fix-up x = z + H s in double, an ORDER-term double sum a sample).
//   The chain is now the LTP's chunk steps, two chunks' filters and the
//   carry's steps, not 320 samples; each step of the two sequential
//   chains costs a few hundred cycles of shared-memory and arithmetic
//   latency, and those chains set the kernel's time, far above the byte
//   bound (tools/silk_phases.py prints the cycles of each phase).
//
// Rounding.  The LTP rounds as the plain version (`_silk_synth_ref`) and
// XLA:CPU's order for the reference.  The chunked LPC does not: it gives
// up bit equality with the plain version and is held instead to a
// float64 run of it (1e-5 of each row's peak, pole pairs at radius 0.995
// and 0.999 included, where the sequential float32 walk is itself further
// off), and the decoder's rounded feedback to a stated drift
// (tests/test_torch_silk.py, chip_smoke.py).
//
// Shared memory, per warp: M1 and M2 and the carried histories (double),
// the LTP buffer, the frame cut into chunks at an odd stride so that the
// 32 lanes' walks hit 32 banks, and the chunks' tails.  The excitation is
// copied straight into the chunks by cp.async (coalesced), and the head
// into the LTP buffer; the LTP reads its input there and a voiced row's P
// replaces it; the second filter overwrites it with the output, which the
// warp writes back with coalesced stores.  Loops run the same count in
// every lane, so no lane diverges.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr int kLtpOrder = 5;
constexpr int kMaxOrder = 16;  // H1 and H2 are built side by side in the 32 lanes

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

struct Layout {
  int len;       // n: samples a chunk, a divisor of S, >= ORDER
  int count;     // chunks a frame, <= 32: one a lane
  int first;     // chunks of the a1 half
  int stride;    // floats between chunks in shared memory: n rounded up to odd
  int s_stride;  // doubles between carried histories: ORDER + 2 (16-byte rows, 4 banks apart)
  int h_doubles;  // per warp, 16-byte multiples: M1 then M2, ORDER x ORDER each
  int s_doubles;  // the history entering each chunk, count rows
  int p_floats;   // the LTP buffer: head, then the frame
  int z_floats;   // the frame in chunks
  int t_floats;   // the last ORDER outputs of each chunk from a zero history, a spare word
  __host__ __device__ size_t warp_bytes() const {
    return 8 * static_cast<size_t>(h_doubles + s_doubles) +
           4 * static_cast<size_t>(p_floats + z_floats + t_floats);
  }
};

// The chunk layout of a frame of nb subframes of S samples; false where
// there is none (S < order, or more than 32 subframes).
bool layout_for(int order, int H, int S, int nb, Layout& ly) {
  for (int n = order; n <= S; ++n) {
    if (S % n != 0 || nb * (S / n) > kWarp) continue;
    ly.len = n;
    ly.count = nb * (S / n);
    ly.first = (nb + 1) / 2 * (S / n);
    ly.stride = n | 1;
    ly.s_stride = order + 2;
    ly.h_doubles = 2 * order * order;
    ly.s_doubles = round_up(ly.count * ly.s_stride, 2);
    ly.p_floats = round_up(H + nb * S, 4);
    ly.z_floats = round_up(ly.count * ly.stride, 4);
    ly.t_floats = round_up(ly.count * order + 1, 4);
    return true;
  }
  return false;
}

// 4 bytes from device memory to shared memory without registers
// (cp.async): the copy lands while the warp computes; copy_wait() waits
// for the thread's copies.
__device__ __forceinline__ void copy_async(float* dst_shared, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Frame sample t's place in the chunks, chunk q = t / n at r = t % n,
// moved on by a fixed step (dq, dr) = (step / n, step % n) with one select:
// no division in the loops.
struct Place {
  int q, r;
  __device__ Place(int t, int n) : q(t / n), r(t - t / n * n) {}
  __device__ void advance(int dq, int dr, int n) {
    q += dq, r += dr;
    if (r >= n) r -= n, ++q;
  }
  __device__ int at(int stride) const { return q * stride + r; }
};

// ORDER doubles from 16-byte aligned shared memory into registers.
template <int ORDER>
__device__ __forceinline__ void load_row(double (&dst)[ORDER], const double* src) {
  const double2* v = reinterpret_cast<const double2*>(src);
#pragma unroll
  for (int k = 0; k < ORDER / 2; ++k) {
    const double2 w = v[k];
    dst[2 * k] = w.x, dst[2 * k + 1] = w.y;
  }
}

// sum_k m[k] v[k] in double, v read from 16-byte aligned shared memory
// (a broadcast when every lane reads the same row), in four sums.
template <int ORDER>
__device__ __forceinline__ double dot_row(const double (&m)[ORDER], const double* v_shared) {
  const double2* v = reinterpret_cast<const double2*>(v_shared);
  double p[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < ORDER / 2; ++k) {
    const double2 w = v[k];
    p[(2 * k) % 4] = fma(m[2 * k], w.x, p[(2 * k) % 4]);
    p[(2 * k + 1) % 4] = fma(m[2 * k + 1], w.y, p[(2 * k + 1) % 4]);
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// One chunk of x[t] = in[t] + sum_j a[j] x[t-1-j] from the history in ring
// (ring[i] the output ORDER - i samples back), for n samples in whole
// rounds of ORDER (n the same for the whole warp, so that no lane
// diverges): inputs at and beyond n_in read as 0, and the outputs
// out_from <= t < n_in are stored at out[t - out_from] (out may be in: a
// round's inputs are loaded before its first output is stored).  Sample t
// sits in ring[t % ORDER]: with the round unrolled every ring index is a
// constant and nothing shifts.  The older taps go into four sums; the
// three newest outputs join last by fused multiply-adds, so a sample waits
// on the one before through one multiply-add.
template <int ORDER>
__device__ __forceinline__ void filter_chunk(const float (&a)[ORDER], float (&ring)[ORDER],
                                             const float* in, float* out, int n, int n_in,
                                             int out_from) {
  for (int t0 = 0; t0 < n; t0 += ORDER) {
    float xv[ORDER];
#pragma unroll
    for (int u = 0; u < ORDER; ++u) xv[u] = t0 + u < n_in ? in[t0 + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < ORDER; ++u) {
      // the output j + 1 samples back sits in ring[(u + ORDER - 1 - j) % ORDER]
      float older[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = ORDER - 1; j >= 3; --j)
        older[j % 4] = fmaf(a[j], ring[(u + ORDER - 1 - j) % ORDER], older[j % 4]);
      const float rest = xv[u] + ((older[0] + older[1]) + (older[2] + older[3]));
      const float acc = fmaf(a[0], ring[(u + ORDER - 1) % ORDER],
                             fmaf(a[1], ring[(u + ORDER - 2) % ORDER],
                                  fmaf(a[2], ring[(u + ORDER - 3) % ORDER], rest)));
      ring[u] = acc;  // replaces the output ORDER back, read above
      const int t = t0 + u;
      if (t >= out_from && t < n_in) out[t - out_from] = acc;
    }
  }
}

template <int ORDER>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
    silk_synth_kernel(const float* __restrict__ gexc, const float* __restrict__ a1,
                      const float* __restrict__ a2, const unsigned char* __restrict__ voiced,
                      const int* __restrict__ lags, const float* __restrict__ b_taps,
                      const float* __restrict__ head, const float* __restrict__ hist_in,
                      float* __restrict__ xq, float* __restrict__ hist_out, int rows, int H,
                      int S, int nb, int chunk, Layout ly) {
  static_assert(ORDER % 2 == 0 && ORDER <= kMaxOrder, "H1 and H2 take 16 lanes each");
  extern __shared__ double smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const int L = S * nb, n = ly.len;
  double* ms = reinterpret_cast<double*>(reinterpret_cast<unsigned char*>(smem) +
                                         warp * ly.warp_bytes());  // ms[j * ORDER + k]: M1, M2
  double* ss = ms + ly.h_doubles;  // ss[c * s_stride + j]: the output j + 1 before chunk c
  float* P = reinterpret_cast<float*>(ss + ly.s_doubles);  // LTP buffer: head, then the frame
  float* zs = P + ly.p_floats;  // chunk c at zs + c * stride: gexc, P (voiced), the output
  float* tails = zs + ly.z_floats;  // tails[c * ORDER + i]: z_c[n - ORDER + i]
  float* spare = tails + ly.count * ORDER;  // where the LTP's idle lanes store
  const int wq = kWarp / n, wr = kWarp - wq * n;  // 32 samples on, in chunks

  // Stage the excitation into the chunks and the head into the LTP buffer,
  // by copies that land while the H pass runs (every row's head: waiting
  // for the voiced flag first would hold the copies back).
  const float* g = gexc + static_cast<size_t>(row) * L;
  Place at(lane, n);
  for (int t = lane; t < L; t += kWarp) {
    copy_async(zs + at.at(ly.stride), g + t);
    at.advance(wq, wr, n);
  }
  const float* hd = head + static_cast<size_t>(row) * H;
  for (int i = lane; i < H; i += kWarp) copy_async(P + i, hd + i);
  const bool is_voiced = voiced[row] != 0;
  // The LTP's lags and taps, one a lane, shuffled out subframe by subframe.
  const int my_lag = lane < nb ? lags[static_cast<size_t>(row) * nb + lane] : 0;
  const float my_b =
      lane < nb * kLtpOrder ? b_taps[static_cast<size_t>(row) * nb * kLtpOrder + lane] : 0.0f;
  // The lane's coefficients and lane 0's history; the history also enters
  // chunk 0 as ss row 0, stored after the H pass so that its load's
  // latency hides behind it.
  const bool own = lane < ly.count;
  const float* hin = hist_in + static_cast<size_t>(row) * ORDER;
  const float hist_lane = lane < ORDER ? __ldg(hin + ORDER - 1 - lane) : 0.0f;
  float a[ORDER], ring[ORDER];
  {
    const float* ap = (lane < ly.first ? a1 : a2) + static_cast<size_t>(row) * ORDER;
#pragma unroll
    for (int j = 0; j < ORDER; ++j) {
      a[j] = __ldg(ap + j);
      ring[j] = lane == 0 ? __ldg(hin + j) : 0.0f;
    }
  }
  if (ly.count > 1) {
    // H: lane j of each half-warp holds column j, lanes 0-15 for a1 and
    // 16-31 for a2 (columns past ORDER are zero); only the last ORDER rows
    // are kept, as M (row j of M is row n - 1 - j of H).  In double: the
    // carry sums columns of M that nearly cancel when poles sit near the
    // unit circle.
    const int j = lane % 16;
    const double aj =
        j < ORDER ? static_cast<double>(
                        __ldg((lane < 16 ? a1 : a2) + static_cast<size_t>(row) * ORDER + j))
                  : 0.0;
    double* col = ms + (lane < 16 ? 0 : ORDER * ORDER) + j;
    double h = aj;
    for (int t = 0; t < n; ++t) {
      const int back = n - 1 - t;
      if (j < ORDER && back < ORDER) col[back * ORDER] = h;
      const double h0 = __shfl_sync(kFull, h, lane & 16);
      const double next_tap = __shfl_down_sync(kFull, h, 1, 16);
      h = fma(aj, h0, j + 1 < ORDER ? next_tap : 0.0);
    }
  }
  if (lane < ORDER) ss[lane] = hist_lane;
  copy_wait();
  __syncwarp();

  // LTP: one chunk a step, a sample a lane; P goes to the buffer and
  // replaces the excitation as the LPC's input.  Every lane loads its five
  // taps at once (clamped to the buffer; a tap at or past the chunk reads
  // 0 by a select), and lanes past the chunk store to a spare word: no
  // branch, which cut the LTP's cycles by a quarter.
  if (is_voiced) {
    for (int k = 0; k < nb; ++k) {
      const int lag = __shfl_sync(kFull, my_lag, k);
      float b[kLtpOrder];
#pragma unroll
      for (int j = 0; j < kLtpOrder; ++j) b[j] = __shfl_sync(kFull, my_b, k * kLtpOrder + j);
      // Any step up to lag - 2 samples reads only finished samples, so it
      // gives the plain version's P (with chunk <= lag - 2 that is the
      // sequential recurrence); `chunk` itself is kept where the lag is
      // shorter, since its grid then decides which taps read 0.
      const int step = lag - 2 >= chunk ? min(kWarp, lag - 2) : chunk;
      const int cq = step / n, cr = step - cq * n;
      const int sub0 = H + k * S;  // buffer index of the subframe's first sample
      Place in(k * S + lane, n);
      for (int t0 = 0; t0 < S; t0 += step) {
        const int pos = sub0 + t0 + lane;
        const int done = sub0 + t0;  // the samples before the chunk are final
        int idx[kLtpOrder];
        float v[kLtpOrder];
#pragma unroll
        for (int j = 0; j < kLtpOrder; ++j) {
          idx[j] = max(pos - lag + 2 - j, 0);
          v[j] = P[min(idx[j], done)];
        }
        float pred = 0.f;
#pragma unroll
        for (int j = 0; j < kLtpOrder; ++j)
          pred = __fadd_rn(pred, __fmul_rn(b[j], idx[j] < done ? v[j] : 0.f));
        const bool act = lane < step && t0 + lane < S;
        float* zp = act ? zs + in.at(ly.stride) : spare;
        float* pp = act ? P + pos : spare;
        const float p = __fadd_rn(*zp, pred);
        *pp = p;
        *zp = p;
        in.advance(cq, cr, n);
        __syncwarp();
      }
    }
  }

  // z: each lane its chunk from a zero history (lane 0 from lpc_hist), for
  // the chunk's last ORDER outputs.
  const int c_own = own ? lane : 0;
  filter_chunk<ORDER>(a, ring, zs + c_own * ly.stride, tails + c_own * ORDER, n, own ? n : 0,
                      n - ORDER);
  __syncwarp();

  if (ly.count > 1) {
    // The carry: s_{c+1}[j] = z_c[n-1-j] + sum_k M_c[j][k] s_c[k], from s_1
    // = the tail of chunk 0 (final); lane j < ORDER holds s[j] and row j
    // of M (M1, then M2 from the first chunk of the a2 half).
    const int j = min(lane, ORDER - 1);
    double m[ORDER];
    load_row<ORDER>(m, ms + j * ORDER);
    double s = tails[ORDER - 1 - j];
    for (int c = 1; c < ly.count; ++c) {
      if (lane < ORDER) ss[c * ly.s_stride + lane] = s;
      if (c + 1 == ly.count) break;
      if (c == ly.first) load_row<ORDER>(m, ms + (ORDER + j) * ORDER);
      const double tail = tails[c * ORDER + ORDER - 1 - j];
      __syncwarp();
      s = tail + dot_row<ORDER>(m, ss + c * ly.s_stride);
    }
    __syncwarp();
  }

  // Every chunk filtered again, in place, from the history carried to it:
  // the output.
  {
    double hist[ORDER];
    load_row<ORDER>(hist, ss + c_own * ly.s_stride);
#pragma unroll
    for (int i = 0; i < ORDER; ++i) ring[i] = static_cast<float>(hist[ORDER - 1 - i]);
    float* zc = zs + c_own * ly.stride;
    filter_chunk<ORDER>(a, ring, zc, zc, n, own ? n : 0, 0);
  }
  __syncwarp();

  float* out = xq + static_cast<size_t>(row) * L;
  Place wb(lane, n);
  for (int t = lane; t < L; t += kWarp) {
    out[t] = zs[wb.at(ly.stride)];
    wb.advance(wq, wr, n);
  }
  if (lane < ORDER)
    hist_out[static_cast<size_t>(row) * ORDER + ORDER - 1 - lane] =
        zs[(ly.count - 1) * ly.stride + n - 1 - lane];
}

template <int ORDER>
int launch(const float* gexc, const float* a1, const float* a2, const unsigned char* voiced,
           const int* lags, const float* b_taps, const float* head, const float* hist_in,
           float* xq, float* hist_out, int rows, int H, int S, int nb, int chunk,
           cudaStream_t stream) {
  Layout ly;
  if (!layout_for(ORDER, H, S, nb, ly)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kRowsPerBlock * ly.warp_bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        silk_synth_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  silk_synth_kernel<ORDER><<<blocks, kRowsPerBlock * kWarp, smem, stream>>>(
      gexc, a1, a2, voiced, lags, b_taps, head, hist_in, xq, hist_out, rows, H, S, nb, chunk,
      ly);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gexc [rows, S * nb], a1 / a2 / hist_in / hist_out [rows, order], voiced
// [rows] (bytes, 0 = unvoiced), lags [rows, nb] int32, b_taps [rows, nb, 5],
// head [rows, H], xq [rows, S * nb]: f32 unless stated, contiguous, the
// outputs not aliasing the inputs; order 10 or 16, 1 <= chunk <= 32,
// nb <= 6 (a lane per LTP tap of the frame), and a chunk layout for the LPC
// (`layout_for`: S >= order).  Returns the cudaError_t.
extern "C" int opus_silk_synth(const float* gexc, const float* a1, const float* a2,
                               const unsigned char* voiced, const int* lags,
                               const float* b_taps, const float* head, const float* hist_in,
                               float* xq, float* hist_out, int rows, int order, int H, int S,
                               int nb, int chunk, void* stream) {
  if (rows <= 0 || H < 0 || S <= 0 || nb <= 0 || nb * kLtpOrder > kWarp || chunk < 1 ||
      chunk > kWarp)
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
