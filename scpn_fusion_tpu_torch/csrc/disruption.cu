// The staged disruption sequence (row Q): every tick of every sequence of a
// call in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/
// disruption_sequence.py: run_disruption_sequence (:93-158) is a 4000-tick
// lax.scan of ~40 scalar ops (thermal quench, Spitzer current quench,
// Rosenbluth-Putvinski avalanche, halo), and spi_mitigation_scan (:161-170)
// vmaps it over SPI inventories, each one compiled XLA program.  Eager
// PyTorch runs a tick as ~50 launches of 0-d ops (the plain version: the
// loop of the port's models/physics/disruption_sequence.disruption_step over
// the ticks, the sequences one batch), ~200,000 launches a sequence.
//
// Design: one thread a sequence; the tick loop runs inside the thread with
// (Ip, I_RE) in registers, and each tick writes the six traces (t, Te, Ip,
// I_RE, E_par, halo) of its sequence, row-major (n_seq, n_steps).  Te, the
// tick time and the Spitzer resistivity hang on the tick alone; the carry's
// dependent chain is the current balance (three divisions a tick).
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fdiv_rn and the double forms) in the order of
// the plain PyTorch ops, which divide by tensors (on a CUDA tensor a Python
// divisor becomes a multiplication by its reciprocal; here every quotient is
// a division).  exp and pow are the libdevice calls that torch's elementwise
// kernels make, the exponent of pow a run-time argument as in torch's pow
// (a literal 1.5 could let nvcc rewrite it).  The clamps let a NaN through,
// as torch.clamp and torch.minimum do; so the kernel equals its plain version
// bit for bit in float32 and float64.
//
// What bounds it on an H100: the bytes are the six traces (6 n_steps values
// a sequence) and one value in; the operations ~45 a tick.  Neither: a
// sequence is a chain of n_steps dependent ticks on one thread.

#include <cuda_runtime.h>

namespace {

struct DisruptionArgs {
  const void* spi_ne20;    // (n_seq,) injected density of each sequence
  void* t_ms;              // (n_seq, n_steps) the six traces
  void* te_ev;
  void* ip_ma;
  void* i_re_ma;
  void* e_par;
  void* halo_ma;
  int n_seq, n_steps;
  double dt_ms, dt;        // the tick [ms] and [s]
  double te_post, te_span, tau_tq;   // te_post + te_span exp(-t / tau_tq)
  double ne0, spi_time_ms;
  double c_eta, pow_exp;   // 5.2e-5 Z_eff lnL / max(Te, 1)^pow_exp
  double pi, r0, area, two_pi_r0, l_p;
  double mec_lnl, e_charge;          // m_e c lnL and e of the avalanche time
  double seed, te_hot;     // the seed current, flowing while Te < te_hot
  double halo_max, ip0_a, mega;
  double te_init, ip_init;
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

// torch.minimum: a NaN of either side wins
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmin(a, b);
}

constexpr double kLnLambda = 15.0;
constexpr double kEcPerNe20LnL = 5.0990991e-3;
constexpr double kNeFloor = 1e-6;
constexpr double kEcFloor = 1e-12;

template <typename T>
__global__ void disruption_kernel(const DisruptionArgs a) {
  using A = Arith<T>;
  const int seq = blockIdx.x * blockDim.x + threadIdx.x;
  if (seq >= a.n_seq) return;
  const T dt_ms = static_cast<T>(a.dt_ms), dt = static_cast<T>(a.dt);
  const T te_post = static_cast<T>(a.te_post), te_span = static_cast<T>(a.te_span);
  const T tau_tq = static_cast<T>(a.tau_tq), ne0 = static_cast<T>(a.ne0);
  const T spi_time = static_cast<T>(a.spi_time_ms);
  const T c_eta = static_cast<T>(a.c_eta), pow_exp = static_cast<T>(a.pow_exp);
  const T pi = static_cast<T>(a.pi), r0 = static_cast<T>(a.r0), area = static_cast<T>(a.area);
  const T two_pi_r0 = static_cast<T>(a.two_pi_r0), l_p = static_cast<T>(a.l_p);
  const T mec_lnl = static_cast<T>(a.mec_lnl), e_charge = static_cast<T>(a.e_charge);
  const T seed = static_cast<T>(a.seed), te_hot = static_cast<T>(a.te_hot);
  const T halo_max = static_cast<T>(a.halo_max), ip0_a = static_cast<T>(a.ip0_a);
  const T mega = static_cast<T>(a.mega);
  const T lnl = static_cast<T>(kLnLambda), ec_per = static_cast<T>(kEcPerNe20LnL);
  const T ne_floor = static_cast<T>(kNeFloor), ec_floor = static_cast<T>(kEcFloor);
  const T q = static_cast<const T*>(a.spi_ne20)[seq];
  const size_t row = static_cast<size_t>(seq) * a.n_steps;
  T* out_t = static_cast<T*>(a.t_ms) + row;
  T* out_te = static_cast<T*>(a.te_ev) + row;
  T* out_ip = static_cast<T*>(a.ip_ma) + row;
  T* out_re = static_cast<T*>(a.i_re_ma) + row;
  T* out_e = static_cast<T*>(a.e_par) + row;
  T* out_halo = static_cast<T*>(a.halo_ma) + row;

  T ip = static_cast<T>(a.ip_init), i_re = T(0);
  for (int k = 0; k < a.n_steps; ++k) {
    const T t = A::mul(static_cast<T>(k), dt_ms);
    // thermal quench
    const T te1 = A::add(te_post, A::mul(te_span, exp(A::div(-t, tau_tq))));
    const T ne20 = A::add(ne0, t >= spi_time ? q : T(0));
    // current quench: Spitzer eta, loop resistance, loop field
    const T eta = A::div(c_eta, pow(clamp_min(te1, T(1)), pow_exp));
    const T r_plasma = A::div(A::mul(A::mul(A::mul(eta, T(2)), pi), r0), area);
    const T ohmic = A::sub(ip, i_re);
    const T e_par = A::div(A::mul(r_plasma, ohmic), two_pi_r0);
    const T dip = A::div(A::mul(-r_plasma, ohmic), l_p);
    // avalanche against the critical field of this tick's density
    const T e_c = clamp_min(A::mul(A::mul(clamp_min(ne20, ne_floor), lnl), ec_per), ec_floor);
    const T tau_av = A::div(A::div(A::div(mec_lnl, e_c), e_charge), T(2));
    const T gamma = A::div(clamp_min(A::sub(A::div(e_par, e_c), T(1)), T(0)), tau_av);
    const T di_re = A::add(A::mul(gamma, i_re), te1 < te_hot ? seed : T(0));
    const T ip1 = clamp_min(A::add(ip, A::mul(dip, dt)), T(0));
    const T i_re1 = minimum(A::add(i_re, A::mul(di_re, dt)), ip1);
    // halo
    const T lost = A::sub(T(1), A::div(ip1, ip0_a));
    const T halo = A::mul(A::mul(lost, halo_max), ip1);
    out_t[k] = t;
    out_te[k] = te1;
    out_ip[k] = A::div(ip1, mega);
    out_re[k] = A::div(i_re1, mega);
    out_e[k] = e_par;
    out_halo[k] = A::div(halo, mega);
    ip = ip1;
    i_re = i_re1;
  }
}

template <typename T>
int launch_disruption(const DisruptionArgs* args, void* stream) {
  constexpr int kThreads = 32;
  const int blocks = (args->n_seq + kThreads - 1) / kThreads;
  disruption_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_disruption_f32(const void* args, void* stream) {
  return launch_disruption<float>(static_cast<const DisruptionArgs*>(args), stream);
}

extern "C" int scpn_disruption_f64(const void* args, void* stream) {
  return launch_disruption<double>(static_cast<const DisruptionArgs*>(args), stream);
}
