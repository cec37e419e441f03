// Batched tridiagonal (Thomas) solve with the JAX package's guards, one
// launch for B independent systems of length n.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/ops/tridiag.py:thomas_solve is
// two lax.scan passes inside one compiled XLA program.  Eager PyTorch would
// run it as a row loop of ~1,000 small launches a solve (the plain version,
// ops/tridiag.py:thomas_solve_batched_plain); this kernel is one launch.
//
// Arithmetic, row by row, exactly as the plain version:
//   forward:  m = clamp(b_i - a_i cp_{i-1}),  cp_i = safe(c_i / m),
//             dp_i = safe(safe(d_i - a_i dp_{i-1}) / m)
//   backward: x_{n-1} = dp_{n-1},  x_i = safe(dp_i - cp_i x_{i+1})
// where clamp sets a non-finite pivot or one below 1e-30 in magnitude to
// 1e-30 and safe sets a non-finite value to 0.  Every product and
// difference is rounded on its own (__fmul_rn / __fsub_rn, __dmul_rn /
// __dsub_rn): the default build would fuse them into FMAs, which PyTorch's
// separate elementwise ops do not, and the kernel must equal the plain
// version bit for bit.  Divisions are IEEE (__fdiv_rn / __ddiv_rn).
//
// What bounds it on an H100: the systems of the transport paths are tiny
// ((1..50) x (11..100)): a few kilobytes in and out, so the bound from
// bytes is nanoseconds and a launch (a few microseconds) is all of the
// cost.  Each system is a dependent chain of 2 n rows, so one thread a
// system is the simple design: the forward sweep writes cp to a scratch row
// and dp to the output, the backward sweep overwrites the output in place.
// Systems are rows of contiguous (B, n) arrays (a and c (B, n - 1)).

#include <cuda_runtime.h>

namespace {

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
};

template <typename T>
__device__ __forceinline__ T safe(T x) {
  return isfinite(x) ? x : T(0);
}

template <typename T>
__device__ __forceinline__ T clamp_pivot(T m) {
  const T floor = T(1e-30);
  return (!isfinite(m) || Arith<T>::mag(m) < floor) ? floor : m;
}

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              const T* __restrict__ c, const T* __restrict__ d,
                              T* __restrict__ x, T* __restrict__ cp, int n_sys, int n) {
  using A = Arith<T>;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_sys) return;
  const long long off = static_cast<long long>(s) * n;
  const long long off_sub = static_cast<long long>(s) * (n - 1);
  a += off_sub;
  c += off_sub;
  b += off;
  d += off;
  x += off;
  cp += off;

  T m = clamp_pivot(b[0]);
  T cp_prev = safe(A::div(c[0], m));
  T dp_prev = safe(A::div(d[0], m));
  cp[0] = cp_prev;
  x[0] = dp_prev;
  for (int i = 1; i < n; ++i) {
    const T ai = a[i - 1];
    const T ci = i < n - 1 ? c[i] : T(0);
    m = clamp_pivot(A::sub(b[i], A::mul(ai, cp_prev)));
    cp_prev = safe(A::div(ci, m));
    dp_prev = safe(A::div(safe(A::sub(d[i], A::mul(ai, dp_prev))), m));
    cp[i] = cp_prev;
    x[i] = dp_prev;
  }
  T x_next = x[n - 1];
  for (int i = n - 2; i >= 0; --i) {
    x_next = safe(A::sub(x[i], A::mul(cp[i], x_next)));
    x[i] = x_next;
  }
}

template <typename T>
int launch_thomas(const void* a, const void* b, const void* c, const void* d, void* x, void* cp,
                  int n_sys, int n, void* stream) {
  const int threads = 128;
  const int blocks = (n_sys + threads - 1) / threads;
  thomas_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(d), static_cast<T*>(x), static_cast<T*>(cp), n_sys, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_thomas_f32(const void* a, const void* b, const void* c, const void* d,
                               void* x, void* cp, int n_sys, int n, void* stream) {
  return launch_thomas<float>(a, b, c, d, x, cp, n_sys, n, stream);
}

extern "C" int scpn_thomas_f64(const void* a, const void* b, const void* c, const void* d,
                               void* x, void* cp, int n_sys, int n, void* stream) {
  return launch_thomas<double>(a, b, c, d, x, cp, n_sys, n, stream);
}
