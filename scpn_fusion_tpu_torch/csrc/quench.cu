// The HTS quench transient (row H): every step of a REBCO quench in ONE
// launch of one thread.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/engineering/
// hts_quench.py: simulate_quench_transient (:125-169) is a 2000-step
// lax.scan of ~22 scalar ops a step (the normal zone, the resistivity, the
// dump, Joule heating, cooling and the clip), one compiled XLA program.
// Eager PyTorch runs a step as ~25 launches of 0-d ops (the plain version:
// the loop of the port's models/engineering/hts_quench.quench_step), ~50,000
// launches a transient.
//
// Design: one thread; the carry (current, hotspot temperature) lives in
// registers, and each step writes the five traces (t, current, hotspot,
// normal zone, terminal voltage).  The scenario's and the conductor's
// numbers come from hts_quench.quench_values, the same doubles the plain
// step's 0-d tensors are rounded from.
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and the double forms) in
// the order of the plain PyTorch ops, which divide by 0-d tensors (IEEE
// quotients here too); the step time is k * dt in the working dtype.
// torch.clamp and jnp.clip's minimum(maximum(.)) let a NaN through, and so do
// the clamps here; so the kernel equals its plain version bit for bit in
// float32 and float64.
//
// What bounds it on an H100: the bytes are the five traces (5 n_steps values)
// and nothing read; the operations ~25 a step.  Neither: the transient is a
// chain of n_steps dependent steps on one thread (two IEEE divisions a step).

#include <cuda_runtime.h>

namespace {

struct QuenchArgs {
  void* t;                 // (n_steps,) the five traces
  void* current_a;
  void* hotspot_k;
  void* normal_zone_m;
  void* terminal_voltage_v;
  int n_steps;
  double dt, t_detect, z0, v_nz, rho, slope, t_op, area, r_dump, inductance, h_pw, t_cool;
  double cap, cap_floor, t_max, i0, temp0;
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

// torch.maximum / torch.minimum: a NaN of either side wins
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmax(a, b);
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmin(a, b);
}

template <typename T>
__global__ void quench_kernel(const QuenchArgs a) {
  using A = Arith<T>;
  if (blockIdx.x * blockDim.x + threadIdx.x != 0) return;
  const T dt = static_cast<T>(a.dt), t_detect = static_cast<T>(a.t_detect);
  const T z0 = static_cast<T>(a.z0), v_nz = static_cast<T>(a.v_nz);
  const T rho = static_cast<T>(a.rho), slope = static_cast<T>(a.slope);
  const T t_op = static_cast<T>(a.t_op), area = static_cast<T>(a.area);
  const T r_dump = static_cast<T>(a.r_dump), inductance = static_cast<T>(a.inductance);
  const T h_pw = static_cast<T>(a.h_pw), t_cool = static_cast<T>(a.t_cool);
  const T cap = static_cast<T>(a.cap), cap_floor = static_cast<T>(a.cap_floor);
  const T t_max = static_cast<T>(a.t_max);
  T* out_t = static_cast<T*>(a.t);
  T* out_i = static_cast<T*>(a.current_a);
  T* out_temp = static_cast<T*>(a.hotspot_k);
  T* out_zone = static_cast<T*>(a.normal_zone_m);
  T* out_v = static_cast<T*>(a.terminal_voltage_v);

  T i = static_cast<T>(a.i0), temp = static_cast<T>(a.temp0);
  for (int k = 0; k < a.n_steps; ++k) {
    const T t = A::mul(static_cast<T>(k), dt);
    const T zone = A::add(z0, A::mul(v_nz, t));
    const T rho_t = A::add(rho, A::mul(slope, clamp_min(A::sub(temp, t_op), T(0))));
    const T r_nz = A::div(A::mul(rho_t, zone), area);
    const bool dumping = t >= t_detect;
    const T di = dumping ? A::mul(A::div(-A::add(r_dump, r_nz), inductance), i) : T(0);
    const T q_joule = A::mul(A::mul(i, i), r_nz);
    const T q_cool = A::mul(A::mul(h_pw, zone), clamp_min(A::sub(temp, t_cool), T(0)));
    const T dtemp = A::div(A::sub(q_joule, q_cool), clamp_min(A::mul(cap, zone), cap_floor));
    const T i1 = clamp_min(A::add(i, A::mul(dt, di)), T(0));
    const T temp1 = minimum(maximum(A::add(temp, A::mul(dt, dtemp)), t_cool), t_max);
    out_t[k] = t;
    out_i[k] = i1;
    out_temp[k] = temp1;
    out_zone[k] = zone;
    out_v[k] = dumping ? A::mul(i1, r_dump) : A::mul(i1, r_nz);
    i = i1;
    temp = temp1;
  }
}

template <typename T>
int launch_quench(const QuenchArgs* args, void* stream) {
  quench_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_quench_run_f32(const void* args, void* stream) {
  return launch_quench<float>(static_cast<const QuenchArgs*>(args), stream);
}

extern "C" int scpn_quench_run_f64(const void* args, void* stream) {
  return launch_quench<double>(static_cast<const QuenchArgs*>(args), stream);
}
