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
// Chains of length 1 and 2 output y.  A chain never exceeds the widest
// band, 176 bins.
//
// What bounds it on this card: bytes.  Five [rows, n] planes in and one
// out (at B=1024, n=1920: 47 MB, about 14 us at 3.35 TB/s); the arithmetic
// is a few operations per element.  The TPU kernel spent two Hillis-Steele
// ladders of eight pltpu.roll levels per pass because its vector unit has
// no cheap sequential scan; on Hopper a chain of at most 176 steps is a
// short loop for one thread.
//
// The design's answer, simple first: one thread per position; the thread
// at a chain head (k == 0) walks its chain forward, writing y to the
// output, then backward over the output, out of place.  The recurrences
// run in double, so the kernel gives the exact recurrence rounded once per
// output, and its distance from the float32 ladder is the ladder's own
// rounding.  Chain lengths are clipped to the row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rot_pass_kernel(const float* __restrict__ x, const float* __restrict__ cc,
                const float* __restrict__ ss, const int* __restrict__ k_pos,
                const int* __restrict__ m_pos, float* __restrict__ out,
                long long total, int n) {
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t0 >= total || k_pos[t0] != 0) return;
  const int col = static_cast<int>(t0 % n);
  const int len = max(1, min(m_pos[t0], n - col));

  // Forward: y into out.
  double v = x[t0];
  for (int j = 0; j < len; ++j) {
    const long long t = t0 + j;
    const double c = cc[t], s = ss[t];
    if (j > 0) v = s * v + c * static_cast<double>(x[t]);
    out[t] = (j == len - 1) ? static_cast<float>(v)
                            : static_cast<float>(c * v - s * static_cast<double>(x[t + 1]));
  }
  if (len < 3) return;

  // Backward, from the tail down, in place over out: position t reads
  // y[t] and y[t-1] before it is overwritten, and y[t-1] is still y.
  // y is re-read as float, the value the forward pass stored, as the
  // ladder's second scan reads its first scan's float output.
  double z = 0.0;
  for (int j = len - 1; j >= 0; --j) {
    const long long t = t0 + j;
    const double c = cc[t], s = ss[t];
    const double y = out[t];
    z = (j >= len - 2) ? y : -s * z + c * y;
    double f;
    if (j == 0) {
      f = z;
    } else if (j == len - 1) {
      f = y;
    } else {
      f = c * z + s * static_cast<double>(out[t - 1]);
    }
    out[t] = static_cast<float>(f);
  }
}

}  // namespace

// x, cc, ss [rows, n] f32; k_pos, m_pos [rows, n] i32; out [rows, n] f32
// (not aliasing the inputs).  Every position must lie in a chain (its k
// counts from a head with k == 0).  Returns the cudaError_t of the launch.
extern "C" int opus_rot_pass(const float* x, const float* cc, const float* ss,
                             const int* k_pos, const int* m_pos, float* out,
                             int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(rows) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  rot_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, cc, ss, k_pos, m_pos, out,
                                                        total, n);
  return static_cast<int>(cudaGetLastError());
}
