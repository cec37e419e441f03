// The 0-D burn relaxation (row E): every iteration of every design point of
// a call in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/scaling_burn.py:
// burn_equilibrium_0d (:68-133) relaxes the temperature of a design point
// toward its power balance in a 200-iteration lax.fori_loop (:114) of
// Bosch-Hale reactivity, IPB98(y,2) confinement and a damped update, one
// compiled XLA program; design_scan.scan_designs vmaps it over designs.
// Eager PyTorch runs an iteration as ~50 launches of elementwise ops (the
// plain version: the loop of the port's scaling_burn.balance), ~10,000
// launches a burn point whatever the number of designs.
//
// Design: one thread a design point, 64 threads a CTA (the 4096 designs of
// compact_reactor_search on 64 SMs); the iteration loop runs inside the
// thread with the temperature in a register.  What hangs on the point alone
// (the fuel density squared, the volume, the IPB98 factors but the loss
// power's, the W/T coefficient) is formed once by the plain preamble that
// both paths share (scaling_burn.burn_constants) and read once; the thread
// writes the final temperature.  The module's epilogue (one balance on plain
// ops) runs after the launch.
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and the double forms)
// in the order of the plain PyTorch ops, so the kernel equals its plain
// version bit for bit in float32 and float64.  torch's pow takes special
// paths for some exponents: t**3 is t * t * t; the exponents of the cube
// root and of the loss power reach the kernel as arguments (a literal could
// let nvcc rewrite pow), so pow, sqrt and exp are the libdevice calls that
// torch's elementwise kernels make.  bg2 / (4 theta) is a Python number over
// a tensor, which PyTorch computes as reciprocal(4 theta) * bg2.  The clamps
// let a NaN through, as torch.clamp does.
//
// What bounds it on an H100: the bytes are eight values read and one written
// a point; the operations ~60 an iteration.  Neither: a point is a chain of
// n_iter dependent iterations on one thread (four IEEE divisions, a pow of a
// point-dependent base, the cube-root pow, sqrt and exp each).

#include <cuda_runtime.h>

namespace {

struct BurnArgs {
  const void* p_aux;       // (n,) auxiliary heating [MW]
  const void* nd2;         // (n,) (0.5 dilution ne19)^2
  const void* volume;      // (n,) plasma volume [m^3]
  const void* tau_pre;     // (n,) C ip^0.93 bt^0.15 ne19^0.41
  const void* r_f;         // (n,) r^1.97
  const void* k_f;         // (n,) kappa^0.78
  const void* e_f;         // (n,) epsilon^0.58
  const void* w_coeff;     // (n,) W / T [MW s / keV]
  void* t_final;           // (n,) the relaxed temperature [keV]
  int n, n_iter;
  double t_init, f_profile, fus_const, m_f, e_ploss, third;
  double bg2, mrc2, c1, c2, c3, c4, c5, c6, c7, sv_scale, five, relax;
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
};

// torch.clamp(x, lo, hi): a NaN passes
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

// torch.clamp(x, min=lo): a NaN passes
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : fmax(x, lo);
}

template <typename T>
__global__ void burn_kernel(const BurnArgs a) {
  using A = Arith<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const T f_profile = static_cast<T>(a.f_profile), fus = static_cast<T>(a.fus_const);
  const T m_f = static_cast<T>(a.m_f), e_ploss = static_cast<T>(a.e_ploss);
  const T third = static_cast<T>(a.third), bg2 = static_cast<T>(a.bg2);
  const T mrc2 = static_cast<T>(a.mrc2), c1 = static_cast<T>(a.c1), c2 = static_cast<T>(a.c2);
  const T c3 = static_cast<T>(a.c3), c4 = static_cast<T>(a.c4), c5 = static_cast<T>(a.c5);
  const T c6 = static_cast<T>(a.c6), c7 = static_cast<T>(a.c7);
  const T sv_scale = static_cast<T>(a.sv_scale), five = static_cast<T>(a.five);
  const T relax = static_cast<T>(a.relax);
  const T p_aux = static_cast<const T*>(a.p_aux)[i];
  const T nd2 = static_cast<const T*>(a.nd2)[i];
  const T volume = static_cast<const T*>(a.volume)[i];
  const T tau_pre = static_cast<const T*>(a.tau_pre)[i];
  const T r_f = static_cast<const T*>(a.r_f)[i];
  const T k_f = static_cast<const T*>(a.k_f)[i];
  const T e_f = static_cast<const T*>(a.e_f)[i];
  const T w_coeff = static_cast<const T*>(a.w_coeff)[i];

  T t = static_cast<T>(a.t_init);
  for (int it = 0; it < a.n_iter; ++it) {
    // Bosch-Hale <sigma v> at f_profile * clamp(t, 0.5, 100)
    const T tb = clamp(A::mul(clamp(t, T(0.5), T(100)), f_profile), T(0.2), T(100));
    const T num = A::mul(tb, A::add(A::mul(tb, A::add(A::mul(tb, c6), c4)), c2));
    const T den = A::add(A::mul(tb, A::add(A::mul(tb, A::add(A::mul(tb, c7), c5)), c3)), T(1));
    const T theta = A::div(tb, A::sub(T(1), A::div(num, den)));
    const T xi = pow(A::mul(A::div(T(1), A::mul(theta, T(4))), bg2), third);
    const T t3 = A::mul(A::mul(tb, tb), tb);
    const T root = sqrt(A::div(xi, A::mul(t3, mrc2)));
    const T sv = clamp_min(
        A::mul(A::mul(A::mul(A::mul(theta, c1), root), exp(A::mul(xi, T(-3)))), sv_scale), T(0));
    // power balance
    const T p_fus = A::mul(A::mul(nd2, A::mul(A::div(sv, f_profile), fus)), volume);
    const T p_heat = A::add(p_aux, A::div(p_fus, five));
    const T tau = A::mul(A::mul(A::mul(A::mul(A::mul(tau_pre, pow(clamp_min(p_heat, T(1)), e_ploss)),
                                               r_f), k_f), e_f), m_f);
    const T t_balance = A::div(A::mul(p_heat, tau), w_coeff);
    t = A::add(t, A::mul(A::sub(t_balance, t), relax));
  }
  static_cast<T*>(a.t_final)[i] = t;
}

template <typename T>
int launch_burn(const BurnArgs* args, void* stream) {
  constexpr int kThreads = 64;
  const int blocks = (args->n + kThreads - 1) / kThreads;
  burn_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_burn_relax_f32(const void* args, void* stream) {
  return launch_burn<float>(static_cast<const BurnArgs*>(args), stream);
}

extern "C" int scpn_burn_relax_f64(const void* args, void* stream) {
  return launch_burn<double>(static_cast<const BurnArgs*>(args), stream);
}
