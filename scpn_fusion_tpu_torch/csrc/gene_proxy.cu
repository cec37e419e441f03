// The GENE-like proxy (row W): every relaxation step of every sample of a
// call in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/surrogates/gyro_swin.py:
// gene_proxy_predict (:112-132) relaxes a saturation fixed point a sample,
//   chi <- chi + 0.05 (target(x (1 + 0.005 tanh chi)) - chi),  chi0 = 0,
// in a lax.scan of `iterations` steps (20,000 in run_speed_benchmark), one
// compiled XLA program; target is synthetic_core_turbulence_target (:29-40).
// Eager PyTorch runs a step as ~28 launches of elementwise ops (the plain
// version: ops/cuda_proxy.gene_proxy_plain), ~560,000 launches a call.
//
// Design: one thread a sample, 64 threads a CTA (the benchmark's 1024
// samples on 16 SMs); the six features stay in registers, the whole
// iteration loop runs inside the thread and chi is written once at the end.
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and the double forms)
// in the order of the plain PyTorch ops, so nvcc contracts nothing into an
// FMA and the kernel equals its plain version bit for bit in float32 and
// float64.  tanh is libdevice's, as in torch's elementwise kernel.  chi / 8
// is the product with 0.125 (PyTorch divides a CUDA tensor by a Python number
// as a product with its reciprocal; here both are exact).  The clamps let a
// NaN through, as torch.clamp does.
//
// What bounds it on an H100: the bytes are six values read and one written a
// sample; the operations ~30 a step.  Neither: a sample is a chain of
// `iterations` dependent steps on one thread (two tanh and an IEEE division
// each).

#include <cuda_runtime.h>

namespace {

struct ProxyArgs {
  const void* features;    // (n, 6) [R/L_Ti, R/L_Te, R/L_ne, q, s_hat, nu_star]
  void* chi;               // (n,) the relaxed chi
  int n, iterations;
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

// torch.clamp(x, min=lo): a NaN passes
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : fmax(x, lo);
}

template <typename T>
__global__ void gene_proxy_kernel(const ProxyArgs a) {
  using A = Arith<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const T* x = static_cast<const T*>(a.features) + 6LL * i;
  const T rlti = x[0], rlte = x[1], rlne = x[2], q = x[3], s_hat = x[4], nu = x[5];

  T chi = T(0);
  for (int it = 0; it < a.iterations; ++it) {
    // eff = x (1 + 0.005 tanh chi)
    const T fac = A::add(A::mul(tanh(chi), T(0.005)), T(1));
    const T e_rlti = A::mul(rlti, fac), e_rlte = A::mul(rlte, fac), e_rlne = A::mul(rlne, fac);
    const T e_q = A::mul(q, fac), e_s = A::mul(s_hat, fac), e_nu = A::mul(nu, fac);
    // synthetic_core_turbulence_target(eff)
    const T crit = A::add(A::mul(clamp_min(e_s, T(0)), T(0.8)), T(4));
    const T drive = clamp_min(A::sub(e_rlti, crit), T(0));
    const T itg = A::div(A::mul(A::mul(e_q, T(1.1)), drive), A::add(A::mul(e_nu, T(0.4)), T(1)));
    const T c = A::add(A::add(A::add(itg, T(0.1)),
                              A::mul(clamp_min(A::sub(e_rlte, T(4)), T(0)), T(0.15))),
                       A::mul(e_rlne, T(0.05)));
    const T target = A::mul(tanh(A::mul(c, T(0.125))), T(8));
    chi = A::add(chi, A::mul(A::sub(target, chi), T(0.05)));
  }
  static_cast<T*>(a.chi)[i] = chi;
}

template <typename T>
int launch_gene_proxy(const ProxyArgs* args, void* stream) {
  constexpr int kThreads = 64;
  const int blocks = (args->n + kThreads - 1) / kThreads;
  gene_proxy_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_gene_proxy_f32(const void* args, void* stream) {
  return launch_gene_proxy<float>(static_cast<const ProxyArgs*>(args), stream);
}

extern "C" int scpn_gene_proxy_f64(const void* args, void* stream) {
  return launch_gene_proxy<double>(static_cast<const ProxyArgs*>(args), stream);
}
