// CELT spreading-rotation pass for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces opus_tpu/dsp/pallas_rot.py::_rot_kernel (via pallas_rot_pass),
// the TPU kernel of one exp_rotation1 pass over the contiguous chains of
// the flat band plane x [rows, n] (semantics: the XLA ladder
// opus_tpu/dsp/plan_exec.py::_rot_pass).  A chain is a run of positions
// with k = 0, 1, ..., m-1 and m_pos = m; per chain, with the per-position
// coefficients c = cc[t], s = ss[t]:
//
//   forward:  v[0] = x[0],  v[t] = s v[t-1] + c x[t]
//             y[t] = v[t] at the tail, c v[t] - s x[t+1] elsewhere
//   backward (chains of length >= 3 only):
//             z[t] = y[t] at the last two positions, -s z[t+1] + c y[t] below
//             out  = z at the head, y at the tail, c z[t] + s y[t-1] between
//
// Chains of length 1 and 2 output y.  As in the ladder, x[t+1] and
// y[t-1] wrap around the row (only inconsistent chains ever read them).
//
// What bounds it on this card: bytes.  Five [rows, n] planes in and one
// out (at B=1024, n=1920: 47 MB, about 14 us at 3.35 TB/s); the arithmetic
// is a few operations per element.  Walking each chain from its head in
// device memory cannot reach that: the lanes of a warp sit in different
// chains, so their loads do not coalesce, and a warp waits on its longest
// chain (up to 176 steps).
//
// The design's answer: a block of two warps per row, whatever the chain
// geometry.
// * The row's planes are staged in shared memory with 16-byte coalesced
//   loads (three groups in flight per plane and thread); k_pos and m_pos
//   become one byte of flags per position (head, tail, last two, short
//   chain) on the way in.  The output leaves with 16-byte stores from the
//   same plane, which holds x, then y, then out.
// * Each of the 64 threads owns a contiguous segment of ceil(n/64)
//   positions (30 at n=1920).  A segment is stored at a stride of the
//   smallest odd number >= its length, so a warp's 32 walks hit 32
//   different banks.
// * Three passes over a segment.  (1) Compose the segment's affine map
//   v -> A v + B of v[t] = a[t] v[t-1] + b[t] (a = 0 at a head); a
//   5-level __shfl_up_sync scan, then the other warp's total through
//   shared memory, give each thread its carry-in.  (2) Walk forward
//   writing y, and compose on the way the segment's map of the backward
//   recurrence z[t] = a'[t] z[t+1] + b'[t] (a' = 0 at a chain's last
//   two), left to right.  The same scan, mirrored (__shfl_down_sync),
//   gives each thread its carry from the right.  (3) Walk backward
//   writing out.
// * The recurrences run in double, so the kernel is the exact recurrence
//   rounded once per output and its distance from the float32 ladder is
//   the ladder's rounding.  Float-to-double conversions issue at a
//   quarter of the double rate on this card, so each value is converted
//   once per pass and carried in a register where the walk reuses it.
// * Shared memory per row: 3 float planes and a byte plane at the padded
//   length, 25.8 KB at n=1920, so 8 rows (16 warps) fit on an SM and the
//   1,024 rows of a serving step run in one wave.  What is left: the
//   wave loads, computes and stores in turn, so the arithmetic does not
//   overlap the memory traffic; a scratch probe that only staged and
//   stored took most of the kernel's time.
// ptxas (sm_90a): 122 registers, no spills (the build log that
// chip_smoke.py prints).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;  // per row
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 3;  // float4 groups a thread loads before it stores them
enum : unsigned char { kHead = 1, kTail = 2, kLastTwo = 4, kShort = 8 };

struct Layout {
  int n;       // row length
  int seg;     // positions per thread's segment, ceil(n / kThreads)
  int stride;  // shared-memory stride of a segment: seg rounded up to odd
  int padded;  // kThreads * stride
};

__device__ __forceinline__ int slot_of(int t, const Layout& L) {
  const int q = t / L.seg;
  return q * L.stride + (t - q * L.seg);
}

__device__ __forceinline__ unsigned char flags_of(int k, int m) {
  return static_cast<unsigned char>((k == 0 ? kHead : 0) | (k == m - 1 ? kTail : 0) |
                                    (k == m - 1 || k == m - 2 ? kLastTwo : 0) |
                                    (m < 3 ? kShort : 0));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int comp(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Row planes -> shared memory (x, cc, ss at their slots, flags).
__device__ void stage_row(const float* __restrict__ x, const float* __restrict__ cc,
                          const float* __restrict__ ss, const int* __restrict__ k_pos,
                          const int* __restrict__ m_pos, float* sx, float* sc, float* ss_s,
                          unsigned char* sf, const Layout& L, bool vec, int tid) {
  if (vec) {
    const int groups = L.n >> 2;
    for (int g0 = tid; g0 < groups; g0 += kThreads * kBatch) {
      float4 vx[kBatch], vc[kBatch], vs[kBatch];
      int4 vk[kBatch], vm[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + kThreads * u;
        if (g < groups) {
          vx[u] = __ldg(reinterpret_cast<const float4*>(x) + g);
          vc[u] = __ldg(reinterpret_cast<const float4*>(cc) + g);
          vs[u] = __ldg(reinterpret_cast<const float4*>(ss) + g);
          vk[u] = __ldg(reinterpret_cast<const int4*>(k_pos) + g);
          vm[u] = __ldg(reinterpret_cast<const int4*>(m_pos) + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + kThreads * u;
        if (g < groups) {
          int q = (4 * g) / L.seg;
          int r = 4 * g - q * L.seg;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = q * L.stride + r;
            sx[s] = comp(vx[u], c);
            sc[s] = comp(vc[u], c);
            ss_s[s] = comp(vs[u], c);
            sf[s] = flags_of(comp(vk[u], c), comp(vm[u], c));
            if (++r == L.seg) {
              r = 0;
              ++q;
            }
          }
        }
      }
    }
  } else {
    for (int t = tid; t < L.n; t += kThreads) {
      const int s = slot_of(t, L);
      sx[s] = x[t];
      sc[s] = cc[t];
      ss_s[s] = ss[t];
      sf[s] = flags_of(k_pos[t], m_pos[t]);
    }
  }
}

// The affine maps of a block's threads, scanned in recurrence order:
// `forward` runs from thread 0 up, otherwise from the last thread down.
// Returns the map of every thread before this one, applied to 0: the
// thread's carry-in.  `tot` holds one map per warp.
__device__ __forceinline__ double carry_in(double A, double B, bool forward, double2* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double Ap = forward ? __shfl_up_sync(kFull, A, d) : __shfl_down_sync(kFull, A, d);
    const double Bp = forward ? __shfl_up_sync(kFull, B, d) : __shfl_down_sync(kFull, B, d);
    if (forward ? lane >= d : lane + d < 32) {
      B = A * Bp + B;
      A *= Ap;
    }
  }
  // This warp's map before this lane, and the whole warp's.
  double Aex = forward ? __shfl_up_sync(kFull, A, 1) : __shfl_down_sync(kFull, A, 1);
  double Bex = forward ? __shfl_up_sync(kFull, B, 1) : __shfl_down_sync(kFull, B, 1);
  if (lane == (forward ? 0 : 31)) {
    Aex = 1.0;
    Bex = 0.0;
  }
  __syncthreads();  // tot's previous readers are done
  if (lane == (forward ? 31 : 0)) tot[warp] = make_double2(A, B);
  __syncthreads();
  double carry = 0.0;  // the earlier warps' maps, applied to 0
  if (forward) {
    for (int u = 0; u < warp; ++u) carry = tot[u].x * carry + tot[u].y;
  } else {
    for (int u = kWarps - 1; u > warp; --u) carry = tot[u].x * carry + tot[u].y;
  }
  return Aex * carry + Bex;
}

__global__ void __launch_bounds__(kThreads)
rot_pass_kernel(const float* __restrict__ x, const float* __restrict__ cc,
                const float* __restrict__ ss, const int* __restrict__ k_pos,
                const int* __restrict__ m_pos, float* __restrict__ out, Layout L, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double2 tot[kWarps];
  float* sx = smem;  // x, then y, then out
  float* sc = sx + L.padded;
  float* ss_s = sc + L.padded;
  unsigned char* sf = reinterpret_cast<unsigned char*>(ss_s + L.padded);
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * L.n;

  stage_row(x + row, cc + row, ss + row, k_pos + row, m_pos + row, sx, sc, ss_s, sf, L, vec,
            tid);
  __syncthreads();

  const int t0 = tid * L.seg;
  const int len = max(0, min(L.seg, L.n - t0));
  const int b0 = tid * L.stride;

  // (1) This segment's forward map.
  double A = 1.0, B = 0.0;
  for (int j = 0; j < len; ++j) {
    const int p = b0 + j;
    const double xv = sx[p];
    const bool head = sf[p] & kHead;
    const double a = head ? 0.0 : static_cast<double>(ss_s[p]);
    const double b = head ? xv : static_cast<double>(sc[p]) * xv;
    B = a * B + b;
    A *= a;
  }
  double v = carry_in(A, B, true, tot);

  // (2) Forward walk.  x[t+1] of the segment's last position lies in the
  // next thread's segment (or wraps to the row's start): read it before
  // any thread overwrites x with y.
  float x_next_bound = 0.f;
  double xv = 0.0;
  if (len > 0) {
    x_next_bound = sx[t0 + len >= L.n ? 0 : (tid + 1) * L.stride];
    xv = sx[b0];
  }
  __syncthreads();
  A = 1.0;  // the backward map, composed left to right: M = M o m[t]
  B = 0.0;
  for (int j = 0; j < len; ++j) {
    const int p = b0 + j;
    const unsigned char f = sf[p];
    const double xn = j + 1 < len ? sx[p + 1] : x_next_bound;
    const double c = sc[p], s = ss_s[p];
    v = (f & kHead) ? xv : s * v + c * xv;
    // y is carried on as the float it is stored as, as the ladder's second
    // scan reads its first scan's float output.
    const float yf = static_cast<float>((f & kTail) ? v : c * v - s * xn);
    sx[p] = yf;
    const double y = yf;
    const bool reset = f & kLastTwo;
    B = A * (reset ? y : c * y) + B;
    A *= reset ? 0.0 : -s;
    xv = xn;
  }
  double z = carry_in(A, B, false, tot);

  // (3) Backward walk.  y[t-1] of the segment's first position lies in the
  // previous thread's segment (or wraps to the row's end): read it before
  // it becomes out.
  float y_prev_bound = 0.f;
  double yv = 0.0;
  if (len > 0) {
    y_prev_bound = sx[t0 == 0 ? slot_of(L.n - 1, L) : (tid - 1) * L.stride + L.seg - 1];
    yv = sx[b0 + len - 1];
  }
  __syncthreads();
  for (int j = len - 1; j >= 0; --j) {
    const int p = b0 + j;
    const unsigned char f = sf[p];
    const double yp = j > 0 ? sx[p - 1] : y_prev_bound;
    const double c = sc[p], s = ss_s[p];
    z = (f & kLastTwo) ? yv : -s * z + c * yv;
    double o = yv;  // short chains and tails
    if (!(f & kShort) && (f & kHead)) {
      o = z;
    } else if (!(f & (kShort | kTail))) {
      o = c * z + s * yp;
    }
    sx[p] = static_cast<float>(o);
    yv = yp;
  }
  __syncthreads();

  float* orow = out + row;
  if (vec) {
    for (int g = tid; g < (L.n >> 2); g += kThreads) {
      int q = (4 * g) / L.seg;
      int r = 4 * g - q * L.seg;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[c] = sx[q * L.stride + r];
        if (++r == L.seg) {
          r = 0;
          ++q;
        }
      }
      reinterpret_cast<float4*>(orow)[g] = make_float4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int t = tid; t < L.n; t += kThreads) orow[t] = sx[slot_of(t, L)];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

// x, cc, ss [rows, n] f32; k_pos, m_pos [rows, n] i32; out [rows, n] f32
// (not aliasing the inputs).  Returns the cudaError_t of the launch.
extern "C" int opus_rot_pass(const float* x, const float* cc, const float* ss,
                             const int* k_pos, const int* m_pos, float* out,
                             int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  L.n = n;
  L.seg = (n + kThreads - 1) / kThreads;
  L.stride = L.seg | 1;
  L.padded = kThreads * L.stride;
  const size_t smem = static_cast<size_t>(L.padded) * (3 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rot_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(cc) && aligned16(ss) &&
                   aligned16(k_pos) && aligned16(m_pos) && aligned16(out);
  rot_pass_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, cc, ss, k_pos, m_pos, out, L, vec);
  return static_cast<int>(cudaGetLastError());
}
