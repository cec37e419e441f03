// Newcomb field-line integration of the ideal ballooning equation (row B):
// every (s, alpha) line of a stability map or a bootstrap path in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/ballooning.py:
// _integrate_newcomb (:39-61) is an RK4 lax.scan of 4000 steps (2000 on the
// shaped EPED path), vmapped over the lines, inside one compiled XLA
// program.  Eager PyTorch runs one circular step as ~70 launches and one
// shaped step as ~190 (the plain version: the loop of the port's
// models/physics/ballooning.rk4_step over the lines as a batch), so a map of
// a few hundred lines would take seconds of launches; this kernel is the
// one program again.
//
// Design: one thread a line; the RK4 loop runs inside the thread with
// (u1, u2) and the running min of u1 in registers, and each thread writes
// its line's min once.  The operator is a template parameter (circular
// s-alpha, or Miller-shaped), not a run-time branch.  Theta enters only
// through coefficients that every line shares: the step's three theta values
// t = (T)((double) i * h), t + h/2 and t + h; sin and cos of theta (the
// libdevice sin/cos that torch's elementwise kernels call); for the Miller
// operator theta folded into [-pi, pi] (rint, half to even, as jnp.round)
// and the six shaped coefficients linearly interpolated there, jnp.interp's
// expression with its dx0 guard, one binary search (searchsorted, side
// right, clipped to [1, n-1]) serving the six columns.  The theta table and
// the (n, 6) coefficient table are staged once a CTA in shared memory
// (7 x 513 values: 28.7 KB in float64, 14.4 KB in float32).
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fdiv_rn and the double forms) in the order
// of the plain PyTorch ops, so the kernel equals its plain version bit for
// bit; the running minimum propagates a NaN as torch.minimum (and
// jnp.minimum) do -- fmin would drop it -- so a diverging line gives a NaN
// min, and so "unstable", on every path.
//
// What bounds it on an H100: the bytes are two values in and one out a line
// (plus the tables once a CTA); the operations are ~70 (circular) to ~200
// (Miller) a step and a line.  Neither: a line is a chain of n_steps
// dependent RK4 steps, four right-hand sides each with an IEEE division
// (Miller: seven, and a table search), so the chain, not the card's width,
// sets the time.

#include <cuda_runtime.h>

namespace {

struct NewcombArgs {
  const void* s;          // (n_lines,)
  const void* alpha;      // (n_lines,)
  const void* theta_tab;  // Miller: (n_tab,) increasing, spanning [-pi, pi]
  const void* coef_tab;   // Miller: (n_tab, 6) bdgt_n, grr_n, binv2, weight, cos, sin of theta_hat
  void* out;              // (n_lines,) min u1 of each line
  int n_lines, n_steps, n_tab;
  double h, h_half, h_sixth;  // theta_max / n_steps, 0.5 h and h / 6 as the host's doubles
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
  // np.spacing(np.finfo(float32).eps): jnp.interp's dx0 threshold
  static constexpr float kSpacingEps = 1.4210854715202004e-14f;
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
  static constexpr double kSpacingEps = 4.930380657631324e-32;
};

constexpr double kTwoPi = 6.283185307179586;   // 2.0 * math.pi
constexpr double kFloor = 1e-12;               // the Miller bending coefficient's floor

// The coefficients of one theta value: theta, sin theta, and either cos
// theta (circular) or the six interpolated shaped coefficients (Miller).
template <typename T> struct Coef {
  T theta, sin_t, c[6];
};

template <typename T, bool kMiller>
__device__ __forceinline__ Coef<T> coefficients(T theta, const T* tab, const T* coef, int n) {
  using A = Arith<T>;
  Coef<T> k;
  k.theta = theta;
  k.sin_t = sin(theta);
  if (!kMiller) {
    k.c[0] = cos(theta);
    return k;
  }
  const T two_pi = static_cast<T>(kTwoPi);
  const T x = A::sub(theta, A::mul(two_pi, rint(A::div(theta, two_pi))));
  int lo = 0, hi = n;                      // searchsorted(tab, x, side="right")
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] <= x) lo = mid + 1; else hi = mid;
  }
  const int i = lo < 1 ? 1 : (lo > n - 1 ? n - 1 : lo);
  const T x0 = tab[i - 1];
  const T dx = A::sub(tab[i], x0);
  const T delta = A::sub(x, x0);
  const bool dx0 = A::mag(dx) <= A::kSpacingEps;
  const T q = A::div(delta, dx0 ? T(1) : dx);
  const bool left = x < tab[0], right = x > tab[n - 1];
  for (int j = 0; j < 6; ++j) {
    const T f0 = coef[(i - 1) * 6 + j];
    T f = dx0 ? f0 : A::add(f0, A::mul(q, A::sub(coef[i * 6 + j], f0)));
    f = left ? coef[j] : f;
    k.c[j] = right ? coef[(n - 1) * 6 + j] : f;
  }
  return k;
}

// (du1, du2) of the operator at coefficients k
template <typename T, bool kMiller>
__device__ __forceinline__ void rhs(const Coef<T>& k, T s, T alpha, T u1, T u2, T& d1, T& d2) {
  using A = Arith<T>;
  const T w = A::sub(A::mul(s, k.theta), A::mul(alpha, k.sin_t));
  T f, g;
  if (!kMiller) {
    f = A::add(T(1), A::mul(w, w));
    g = A::mul(alpha, A::add(k.c[0], A::mul(w, k.sin_t)));
  } else {
    f = A::mul(A::mul(k.c[0], A::add(T(1), A::mul(A::mul(w, w), k.c[1]))), k.c[2]);
    const T floor = static_cast<T>(kFloor);
    f = f < floor ? floor : f;             // torch.clamp(min=): a NaN passes
    g = A::mul(A::mul(alpha, k.c[3]), A::add(k.c[4], A::mul(w, k.c[5])));
  }
  d1 = A::div(u2, f);
  d2 = A::mul(-g, u1);
}

template <typename T, bool kMiller>
__global__ void newcomb_kernel(const NewcombArgs args) {
  using A = Arith<T>;
  extern __shared__ unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* coef = tab + args.n_tab;
  if (kMiller) {
    const T* g_tab = static_cast<const T*>(args.theta_tab);
    const T* g_coef = static_cast<const T*>(args.coef_tab);
    for (int p = threadIdx.x; p < args.n_tab; p += blockDim.x) tab[p] = g_tab[p];
    for (int p = threadIdx.x; p < 6 * args.n_tab; p += blockDim.x) coef[p] = g_coef[p];
    __syncthreads();
  }
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= args.n_lines) return;
  const T s = static_cast<const T*>(args.s)[line];
  const T alpha = static_cast<const T*>(args.alpha)[line];
  const T h = static_cast<T>(args.h), half = static_cast<T>(args.h_half);
  const T sixth = static_cast<T>(args.h_sixth);
  const int n = args.n_tab;
  T u1 = T(1), u2 = T(0), m = T(1);
  for (int i = 0; i < args.n_steps; ++i) {
    const T t0 = static_cast<T>(__dmul_rn(static_cast<double>(i), args.h));
    const Coef<T> c0 = coefficients<T, kMiller>(t0, tab, coef, n);
    const Coef<T> c1 = coefficients<T, kMiller>(A::add(t0, half), tab, coef, n);
    const Coef<T> c2 = coefficients<T, kMiller>(A::add(t0, h), tab, coef, n);
    T a1, b1, a2, b2, a3, b3, a4, b4;
    rhs<T, kMiller>(c0, s, alpha, u1, u2, a1, b1);
    rhs<T, kMiller>(c1, s, alpha, A::add(u1, A::mul(half, a1)), A::add(u2, A::mul(half, b1)),
                    a2, b2);
    rhs<T, kMiller>(c1, s, alpha, A::add(u1, A::mul(half, a2)), A::add(u2, A::mul(half, b2)),
                    a3, b3);
    rhs<T, kMiller>(c2, s, alpha, A::add(u1, A::mul(h, a3)), A::add(u2, A::mul(h, b3)), a4, b4);
    // y + (h / 6) (((k1 + 2 k2) + 2 k3) + k4)
    u1 = A::add(u1, A::mul(sixth, A::add(A::add(A::add(a1, A::mul(T(2), a2)),
                                                A::mul(T(2), a3)), a4)));
    u2 = A::add(u2, A::mul(sixth, A::add(A::add(A::add(b1, A::mul(T(2), b2)),
                                                A::mul(T(2), b3)), b4)));
    if (u1 < m || u1 != u1) m = u1;        // torch.minimum: a NaN stays
  }
  static_cast<T*>(args.out)[line] = m;
}

template <typename T, bool kMiller>
int launch_newcomb(const NewcombArgs* args, void* stream) {
  constexpr int kThreads = 32;
  const size_t smem = kMiller ? 7 * sizeof(T) * static_cast<size_t>(args->n_tab) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(newcomb_kernel<T, kMiller>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (args->n_lines + kThreads - 1) / kThreads;
  newcomb_kernel<T, kMiller><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_newcomb_f32(const void* args, int miller, void* stream) {
  const NewcombArgs* a = static_cast<const NewcombArgs*>(args);
  return miller ? launch_newcomb<float, true>(a, stream) : launch_newcomb<float, false>(a, stream);
}

extern "C" int scpn_newcomb_f64(const void* args, int miller, void* stream) {
  const NewcombArgs* a = static_cast<const NewcombArgs*>(args);
  return miller ? launch_newcomb<double, true>(a, stream)
                : launch_newcomb<double, false>(a, stream);
}
