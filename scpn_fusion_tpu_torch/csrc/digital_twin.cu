// The digital twin's whole shot -- MRE island widths, the q-profile under a
// current-drive action, the island danger map and the 2D diffusion-reaction
// temperature field -- in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/control/digital_twin.py:
// run_digital_twin is one lax.scan of twin_step inside one compiled XLA
// program.  Eager PyTorch runs a step as ~30 small launches (the plain
// version: the loop of the port's control/digital_twin.twin_step); this
// kernel is the one program again.
//
// Design: one CTA, the step loop inside the kernel.  The n x n field is
// double-buffered in shared memory (2 x 9.2 KB at 48^2 in float32, 2 x 18.4
// KB in float64); a thread owns the points tid, tid + blockDim, ...  Every
// thread computes the four MRE widths of a step in registers (the same
// arithmetic in each).  Per step, for each of its points a thread forms
// q = q0' + (qa' - q0') r^2, the danger flag (|q - m/n| < w at any rational
// surface, inside the mask), the core heat added at (n/2, n/2) before the
// Laplacian, the five-point Laplacian with the edges WRAPPING as jnp.roll
// does (the mask holds row 0 at the middle column, whose upward neighbour is
// row n-1), the diffusivity d_turb / d_base, the edge sink and the masked
// clamp, writing the other buffer; the danger count is an integer block sum
// (atomicAdd in shared memory), so count / n^2 equals the mean of the 0/1
// map exactly.  Two barriers a step: after the field and the count, after
// thread 0 has written the step's traces and cleared the count.
//
// The geometry (r_map, mask) comes from the host's _geometry, so no sqrt is
// computed twice.  Arithmetic: every product, sum, difference and quotient is
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn and the double
// forms) in the order of the plain PyTorch ops; the Laplacian adds the four
// rolled fields in jnp.roll's order, (((N + S) + W) + E) - 4 t.
//
// What bounds it on an H100: the bytes are the geometry, the actions, the
// field in and out and the traces (~0.1 MB at 48^2 x 200 steps); the step
// is a dependent chain (a barrier pair, a shared-memory stencil over ~3
// points a thread), so the chain of steps, not the bytes, sets its time.

#include <cuda_runtime.h>

namespace {

struct TwinArgs {
  const void* r_map;                 // (n, n)
  const unsigned char* mask;         // (n, n) bool
  const void* actions;               // (n_steps,)
  void* t_field;                     // (n, n) in: the start field; out: the final one
  void* widths;                      // (4,) in/out: the island widths
  void* trace_core;                  // (n_steps,) t at (n/2, n/2) after each step
  void* trace_widths;                // (n_steps, 4)
  void* trace_frac;                  // (n_steps,) the danger fraction
  int n, n_steps;
  double q0, qa;                     // the q-profile's axis and edge values
  double mre_dt_eta;                 // dt_island * eta, as the Python product
  double beta_p, w_crit_sq;          // the bootstrap drive, w_crit^2
  double d_base, d_turb, core_heat, edge_sink;
  double res[4];                     // the rational surfaces m/n
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
};

template <typename T>
__global__ void twin_kernel(const TwinArgs args) {
  using A = Arith<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_count;
  const int n = args.n, nn = n * n, center = (n / 2) * n + n / 2;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + nn;

  T* g_t = static_cast<T*>(args.t_field);
  for (int p = tid; p < nn; p += nthreads) cur[p] = g_t[p];
  if (tid == 0) s_count = 0;
  T* g_w = static_cast<T*>(args.widths);
  T w[4], res[4];
  for (int k = 0; k < 4; ++k) {
    w[k] = g_w[k];
    res[k] = static_cast<T>(args.res[k]);
  }
  const T* r_map = static_cast<const T*>(args.r_map);
  const unsigned char* mask = args.mask;
  const T* actions = static_cast<const T*>(args.actions);
  const T q0 = static_cast<T>(args.q0), qa = static_cast<T>(args.qa);
  const T mre_dt = static_cast<T>(args.mre_dt_eta), beta_p = static_cast<T>(args.beta_p);
  const T wc2 = static_cast<T>(args.w_crit_sq);
  const T d_base = static_cast<T>(args.d_base), d_turb = static_cast<T>(args.d_turb);
  const T heat = static_cast<T>(args.core_heat), sink = static_cast<T>(args.edge_sink);
  T* tr_core = static_cast<T*>(args.trace_core);
  T* tr_w = static_cast<T*>(args.trace_widths);
  T* tr_frac = static_cast<T*>(args.trace_frac);
  __syncthreads();

  for (int step = 0; step < args.n_steps; ++step) {
    const T a = actions[step];
    // mre_step: w + (dt eta) (Delta'(w) + beta_p w / (w^2 + w_crit^2)), floored at 1e-3
    for (int k = 0; k < 4; ++k) {
      const T delta_prime = A::sub(T(-0.2), A::mul(T(5.0), w[k]));
      const T f_bs = A::div(A::mul(beta_p, w[k]), A::add(A::mul(w[k], w[k]), wc2));
      const T wn = A::add(w[k], A::mul(mre_dt, A::add(delta_prime, f_bs)));
      w[k] = wn < T(1e-3) ? T(1e-3) : wn;
    }
    // q_map: q0' + (qa' - q0') r^2 with q0' = q0 - 0.2 a, qa' = qa + 0.5 a
    const T q0s = A::sub(q0, A::mul(T(0.2), a));
    const T dq = A::sub(A::add(qa, A::mul(T(0.5), a)), q0s);
    int hits = 0;
    for (int p = tid; p < nn; p += nthreads) {
      const int i = p / n, j = p - i * n;
      const bool inside = mask[p] != 0;
      const T r = r_map[p];
      const T q = A::add(q0s, A::mul(dq, A::mul(r, r)));
      bool danger = false;
      for (int k = 0; k < 4; ++k) danger = danger || A::mag(A::sub(q, res[k])) < w[k];
      danger = danger && inside;
      hits += danger ? 1 : 0;
      // the field with the core heat added, at point idx
      auto at = [&](int idx) { return idx == center ? A::add(cur[idx], heat) : cur[idx]; };
      const T tc = at(p);
      const T up = at((i == 0 ? n - 1 : i - 1) * n + j);
      const T down = at((i == n - 1 ? 0 : i + 1) * n + j);
      const T left = at(i * n + (j == 0 ? n - 1 : j - 1));
      const T right = at(i * n + (j == n - 1 ? 0 : j + 1));
      const T lap = A::sub(A::add(A::add(A::add(up, down), left), right), A::mul(T(4.0), tc));
      const T t_new = A::sub(A::add(tc, A::mul(danger ? d_turb : d_base, lap)),
                             A::mul(A::mul(sink, tc), inside ? T(0) : T(1)));
      nxt[p] = inside ? (t_new < T(0) ? T(0) : t_new) : T(0);
    }
    if (hits) atomicAdd(&s_count, hits);
    __syncthreads();
    if (tid == 0) {
      tr_core[step] = nxt[center];
      for (int k = 0; k < 4; ++k) tr_w[4 * step + k] = w[k];
      tr_frac[step] = A::div(static_cast<T>(s_count), static_cast<T>(nn));
      s_count = 0;
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int p = tid; p < nn; p += nthreads) g_t[p] = cur[p];
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) g_w[k] = w[k];
  }
}

template <typename T>
int launch_twin(const TwinArgs* args, int threads, void* stream) {
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(args->n) * args->n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(twin_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  twin_kernel<T><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_twin_shot_f32(const void* args, int threads, void* stream) {
  return launch_twin<float>(static_cast<const TwinArgs*>(args), threads, stream);
}

extern "C" int scpn_twin_shot_f64(const void* args, int threads, void* stream) {
  return launch_twin<double>(static_cast<const TwinArgs*>(args), threads, stream);
}
