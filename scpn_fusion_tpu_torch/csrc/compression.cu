// The voltage-driven FRC compression (row P): a whole trajectory in ONE
// launch, and its gradient, the adjoint sweep, in one more.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/
// pulsed_compression.py: run_voltage_driven_compression (:154-216) is one
// lax.scan of ~80 scalar ops a step (coil circuit, magnetic piston, adiabatic
// compression, energy ledgers) in one compiled XLA program, and jax.grad
// differentiates it end to end by the bank voltage.  Eager PyTorch runs a step
// as ~80 launches of 0-d ops (the plain version: the loop of the port's
// models/physics/pulsed_compression.compression_step over the drive table,
// differentiated by autograd: ~200 more launches a step backward).
//
// Design: one thread.  The forward keeps the twelve state fields in registers
// and writes, each step, the fifteen trace rows (the state, B_ext, beta, the
// balance residual), row-major (15, n_steps).  The drive is a table of
// V(t_k): a kernel cannot call the Python waveform, so the wrapper tabulates
// it.  The adjoint runs from the last step to the first: it recomputes step
// k's intermediates from the stored state k-1 (state0 for k = 0) and V_k, adds
// the carried adjoint of state k to the cotangent of step k's trace column,
// and applies the step's vector-Jacobian product; it writes dL/dV_k, and
// dL/dstate0 at the end (0 for the start time, which takes no gradient).
// Ties follow JAX and PyTorch: maximum and minimum send half the gradient to
// each side of a tie (jnp.clip is minimum(maximum(x, lo), hi)), |x| none at 0.
//
// Arithmetic of the forward: every product, sum, difference and quotient is
// rounded on its own (the Arith helpers) in the order of the plain PyTorch
// ops, which divide by 0-d tensors (on a CUDA tensor a Python divisor becomes
// a multiplication by its reciprocal; here every quotient is a division).  The
// step's constants -- exp(-dt / tau), the loss factor, the Python-double folds
// -- are the tensors the plain step reads, handed over as one array, so the
// kernel calls no exp; pow is the libdevice call of torch's elementwise pow,
// its exponent a run-time value as in torch's pow of two tensors.  maximum and
// minimum pass a NaN as torch.maximum and torch.minimum do.  So the forward
// equals its plain version bit for bit in float32 and float64.  The adjoint's
// products are left to the compiler: it is held to autograd through the plain
// loop by a tolerance.
//
// What bounds it on an H100: the bytes are the drive table in and the fifteen
// trace rows out (16 n_steps values; the adjoint reads the drive, twelve state
// rows and the cotangents and writes n_steps + 12); the operations ~78 a step
// forward and ~260 backward, all on one dependent chain of n_steps steps, each
// step's chain ~18 operations deep, a pow and two divisions among them.
// Neither bound: the chain.

#include <cuda_runtime.h>

namespace {

struct CompressionArgs {
  const void* consts;       // (kNConst,) the step constants, in Const's order
  const void* state0;       // (kNState,) the state before the first step
  const void* drive;        // (n_steps,) V(t_k)
  void* trace;              // (kNRows, n_steps): written by the forward, read by the adjoint
  const void* grad_trace;   // (kNRows, n_steps) the adjoint's cotangents
  void* grad_drive;         // (n_steps,)
  void* grad_state0;        // (kNState,)
  int n_steps;
};

// pulsed_compression.CONSTANTS, in order
enum Const {
  kVLo, kVHi, kResistance, kDecay, kHalfResistance, kDt, kMu0Turns, kLCoil, kTwoMu0, kPi,
  kLength, kECharge, kTwoPi, kMass, kMinRadius, kGm1, kLoss, kTiny, kNConst
};

// CompressionState's fields, then the trace's extra rows
enum Row {
  kT, kR, kU, kTi, kTe, kN, kI, kEth, kW, kQ, kOhm, kSrc, kNState, kB = kNState, kBeta, kRes,
  kNRows
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

// torch.maximum / torch.minimum: a NaN of either side wins
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// d maximum(a, b) / da: 1 above, one half at a tie, 0 below (and d minimum(a, b)
// / da is above(b, a))
template <typename T>
__device__ __forceinline__ T above(T a, T b) {
  return a > b ? T(1) : (a == b ? T(0.5) : T(0));
}

// d|x| / dx
template <typename T>
__device__ __forceinline__ T sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// The intermediates of one step (compression_step, in its order).
template <typename T>
struct Step {
  T vc1, vc, i_inf, i1, ohm, src, b, p_ext, vol0, p_int, area, acc, u1, rr, r1, vol1, n1,
      ratio, pw, ti_a, te_a, k1, e_ad, ti1, te1, e_th, w1, q1, res, m1, m2, scale, resn,
      p_now, pm, beta;
};

template <typename T>
__device__ __forceinline__ void step_forward(const T* c, const T* s, T v, Step<T>& x) {
  using A = Arith<T>;
  // 1) coil circuit over [t, t + dt]: the clip, the exact R-L interval, the ledgers
  x.vc1 = maximum(c[kVLo], v);
  x.vc = minimum(c[kVHi], x.vc1);
  x.i_inf = A::div(x.vc, c[kResistance]);
  x.i1 = A::add(x.i_inf, A::mul(A::sub(s[kI], x.i_inf), c[kDecay]));
  x.ohm = A::mul(A::mul(c[kHalfResistance], A::add(A::mul(s[kI], s[kI]), A::mul(x.i1, x.i1))),
                 c[kDt]);
  x.src = A::mul(A::mul(A::mul(T(0.5), x.vc), A::add(s[kI], x.i1)), c[kDt]);
  x.b = A::div(A::mul(c[kMu0Turns], x.i1), c[kLCoil]);
  x.p_ext = A::div(A::mul(x.b, x.b), c[kTwoMu0]);
  // 2) radial Newton piston
  x.vol0 = A::mul(A::mul(c[kPi], A::mul(s[kR], s[kR])), c[kLength]);
  x.p_int = A::mul(A::mul(s[kN], A::add(s[kTi], s[kTe])), c[kECharge]);
  x.area = A::mul(A::mul(c[kTwoPi], s[kR]), c[kLength]);
  x.acc = A::div(A::mul(A::sub(x.p_int, x.p_ext), x.area), c[kMass]);
  x.u1 = A::add(s[kU], A::mul(x.acc, c[kDt]));
  x.rr = A::add(s[kR], A::mul(x.u1, c[kDt]));
  x.r1 = maximum(c[kMinRadius], x.rr);
  // 3) adiabatic compression, the loss channel, the energy ledgers
  x.vol1 = A::mul(A::mul(c[kPi], A::mul(x.r1, x.r1)), c[kLength]);
  x.n1 = A::div(A::mul(s[kN], x.vol0), x.vol1);
  x.ratio = A::div(x.vol0, x.vol1);
  x.pw = pow(x.ratio, c[kGm1]);
  x.ti_a = A::mul(s[kTi], x.pw);
  x.te_a = A::mul(s[kTe], x.pw);
  x.k1 = A::mul(A::mul(T(1.5), x.n1), x.vol1);
  x.e_ad = A::mul(A::mul(x.k1, A::add(x.ti_a, x.te_a)), c[kECharge]);
  x.ti1 = A::mul(x.ti_a, c[kLoss]);
  x.te1 = A::mul(x.te_a, c[kLoss]);
  x.e_th = A::mul(A::mul(x.k1, A::add(x.ti1, x.te1)), c[kECharge]);
  x.w1 = A::add(s[kW], A::sub(x.e_ad, s[kEth]));
  x.q1 = A::add(s[kQ], A::sub(x.e_ad, x.e_th));
  x.res = A::add(A::sub(A::sub(x.e_th, s[kEth]), A::sub(x.w1, s[kW])), A::sub(x.q1, s[kQ]));
  x.m1 = maximum(fabs(x.e_th), fabs(s[kEth]));
  x.m2 = maximum(fabs(x.w1), c[kTiny]);
  x.scale = maximum(x.m1, x.m2);
  x.resn = A::div(x.res, x.scale);
  x.p_now = A::mul(A::mul(x.n1, A::add(x.ti1, x.te1)), c[kECharge]);
  x.pm = maximum(x.p_ext, c[kTiny]);
  x.beta = A::div(x.p_now, x.pm);
}

// The state after the step, in Row's order.
template <typename T>
__device__ __forceinline__ void step_state(const T* c, const T* s, const Step<T>& x, T* out) {
  using A = Arith<T>;
  out[kT] = A::add(s[kT], c[kDt]);
  out[kR] = x.r1;
  out[kU] = x.u1;
  out[kTi] = x.ti1;
  out[kTe] = x.te1;
  out[kN] = x.n1;
  out[kI] = x.i1;
  out[kEth] = x.e_th;
  out[kW] = x.w1;
  out[kQ] = x.q1;
  out[kOhm] = A::add(s[kOhm], x.ohm);
  out[kSrc] = A::add(s[kSrc], x.src);
}

// The vector-Jacobian product of one step: g holds the cotangents of the
// step's kNRows outputs; writes the adjoint of the state before the step to
// bs and returns dL/dV.
template <typename T>
__device__ __forceinline__ T step_adjoint(const T* c, const T* s, T v, const Step<T>& x,
                                          const T* g, T* bs) {
  for (int i = 0; i < kNState; ++i) bs[i] = T(0);
  T b_r1 = g[kR], b_u1 = g[kU], b_ti1 = g[kTi], b_te1 = g[kTe], b_n1 = g[kN], b_i1 = g[kI];
  T b_eth = g[kEth], b_w1 = g[kW], b_q1 = g[kQ], b_b = g[kB];
  // beta = p_now / max(p_ext, tiny)
  const T b_pnow = g[kBeta] / x.pm;
  T b_pext = -g[kBeta] * x.beta / x.pm * above(x.p_ext, c[kTiny]);
  // p_now = (n1 (ti1 + te1)) e
  T b = b_pnow * c[kECharge];
  b_n1 += b * (x.ti1 + x.te1);
  b_ti1 += b * x.n1;
  b_te1 += b * x.n1;
  // the ohmic and source ledgers: O1 = O + ohm, S1 = S + src
  bs[kOhm] += g[kOhm];
  bs[kSrc] += g[kSrc];
  const T b_ohm = g[kOhm], b_src = g[kSrc];
  // resn = res / scale, scale = max(max(|e_th|, |Eth|), max(|w1|, tiny))
  const T b_res = g[kRes] / x.scale;
  const T b_scale = -g[kRes] * x.resn / x.scale;
  const T b_m1 = b_scale * above(x.m1, x.m2), b_m2 = b_scale * above(x.m2, x.m1);
  b_w1 += b_m2 * above(fabs(x.w1), c[kTiny]) * sign(x.w1);
  b_eth += b_m1 * above(fabs(x.e_th), fabs(s[kEth])) * sign(x.e_th);
  bs[kEth] += b_m1 * above(fabs(s[kEth]), fabs(x.e_th)) * sign(s[kEth]);
  // res = ((e_th - Eth) - (w1 - W)) + (q1 - Q)
  b_eth += b_res;
  bs[kEth] -= b_res;
  b_w1 -= b_res;
  bs[kW] += b_res;
  b_q1 += b_res;
  bs[kQ] -= b_res;
  // q1 = Q + (e_ad - e_th), w1 = W + (e_ad - Eth)
  bs[kQ] += b_q1;
  T b_ead = b_q1;
  b_eth -= b_q1;
  bs[kW] += b_w1;
  b_ead += b_w1;
  bs[kEth] -= b_w1;
  // e_th = (k1 (ti1 + te1)) e, ti1 = ti_a loss, te1 = te_a loss
  b = b_eth * c[kECharge];
  T b_k1 = b * (x.ti1 + x.te1);
  b_ti1 += b * x.k1;
  b_te1 += b * x.k1;
  T b_tia = b_ti1 * c[kLoss], b_tea = b_te1 * c[kLoss];
  // e_ad = (k1 (ti_a + te_a)) e, k1 = (1.5 n1) vol1
  b = b_ead * c[kECharge];
  b_k1 += b * (x.ti_a + x.te_a);
  b_tia += b * x.k1;
  b_tea += b * x.k1;
  b_n1 += b_k1 * x.vol1 * T(1.5);
  T b_vol1 = b_k1 * (T(1.5) * x.n1);
  // ti_a = ti pw, te_a = te pw, pw = ratio^gm1, ratio = vol0 / vol1
  bs[kTi] += b_tia * x.pw;
  bs[kTe] += b_tea * x.pw;
  const T b_pw = b_tia * s[kTi] + b_tea * s[kTe];
  const T b_ratio = b_pw * (c[kGm1] * pow(x.ratio, c[kGm1] - T(1)));
  T b_vol0 = b_ratio / x.vol1;
  b_vol1 -= b_ratio * x.ratio / x.vol1;
  // n1 = (n vol0) / vol1
  bs[kN] += b_n1 / x.vol1 * x.vol0;
  b_vol0 += b_n1 / x.vol1 * s[kN];
  b_vol1 -= b_n1 * x.n1 / x.vol1;
  // vol1 = (pi (r1 r1)) length, r1 = max(min_radius, rr), rr = r + u1 dt
  b_r1 += b_vol1 * c[kLength] * c[kPi] * T(2) * x.r1;
  const T b_rr = b_r1 * above(x.rr, c[kMinRadius]);
  bs[kR] += b_rr;
  b_u1 += b_rr * c[kDt];
  // u1 = u + acc dt, acc = ((p_int - p_ext) area) / mass
  bs[kU] += b_u1;
  b = b_u1 * c[kDt] / c[kMass];
  const T b_pint = b * x.area;
  b_pext -= b * x.area;
  const T b_area = b * (x.p_int - x.p_ext);
  // area = (2 pi r) length, p_int = (n (ti + te)) e, vol0 = (pi (r r)) length
  bs[kR] += b_area * c[kLength] * c[kTwoPi];
  b = b_pint * c[kECharge];
  bs[kN] += b * (s[kTi] + s[kTe]);
  bs[kTi] += b * s[kN];
  bs[kTe] += b * s[kN];
  bs[kR] += b_vol0 * c[kLength] * c[kPi] * T(2) * s[kR];
  // p_ext = (B B) / 2 mu0, B = (mu0 N i1) / l_coil
  b_b += b_pext / c[kTwoMu0] * T(2) * x.b;
  b_i1 += b_b / c[kLCoil] * c[kMu0Turns];
  // src = ((0.5 vc) (I + i1)) dt, ohm = (R / 2 (I I + i1 i1)) dt
  b = b_src * c[kDt];
  T b_vc = b * (s[kI] + x.i1) * T(0.5);
  bs[kI] += b * (T(0.5) * x.vc);
  b_i1 += b * (T(0.5) * x.vc);
  b = b_ohm * c[kDt] * c[kHalfResistance];
  bs[kI] += b * T(2) * s[kI];
  b_i1 += b * T(2) * x.i1;
  // i1 = i_inf + (I - i_inf) decay, i_inf = vc / R
  bs[kI] += b_i1 * c[kDecay];
  b_vc += (b_i1 - b_i1 * c[kDecay]) / c[kResistance];
  // vc = min(v_hi, max(v_lo, V))
  return b_vc * above(c[kVHi], x.vc1) * above(v, c[kVLo]);
}

template <typename T>
__global__ void compression_kernel(const CompressionArgs a) {
  const T* c = static_cast<const T*>(a.consts);
  const T* drive = static_cast<const T*>(a.drive);
  T* trace = static_cast<T*>(a.trace);
  const size_t n = static_cast<size_t>(a.n_steps);
  T s[kNState];
  for (int i = 0; i < kNState; ++i) s[i] = static_cast<const T*>(a.state0)[i];
  Step<T> x;
  for (size_t k = 0; k < n; ++k) {
    step_forward(c, s, drive[k], x);
    step_state(c, s, x, s);
    for (int i = 0; i < kNState; ++i) trace[i * n + k] = s[i];
    trace[kB * n + k] = x.b;
    trace[kBeta * n + k] = x.beta;
    trace[kRes * n + k] = x.resn;
  }
}

template <typename T>
__global__ void compression_adjoint_kernel(const CompressionArgs a) {
  const T* c = static_cast<const T*>(a.consts);
  const T* drive = static_cast<const T*>(a.drive);
  const T* trace = static_cast<const T*>(a.trace);
  const T* grad_trace = static_cast<const T*>(a.grad_trace);
  T* grad_drive = static_cast<T*>(a.grad_drive);
  const size_t n = static_cast<size_t>(a.n_steps);
  T lam[kNState], s[kNState], g[kNRows];
  for (int i = 0; i < kNState; ++i) lam[i] = T(0);
  Step<T> x;
  for (size_t k = n; k-- > 0;) {
    for (int i = 0; i < kNState; ++i)
      s[i] = k == 0 ? static_cast<const T*>(a.state0)[i] : trace[i * n + k - 1];
    step_forward(c, s, drive[k], x);
    for (int i = 0; i < kNRows; ++i) g[i] = grad_trace[i * n + k] + (i < kNState ? lam[i] : T(0));
    grad_drive[k] = step_adjoint(c, s, drive[k], x, g, lam);
  }
  lam[kT] = T(0);
  for (int i = 0; i < kNState; ++i) static_cast<T*>(a.grad_state0)[i] = lam[i];
}

template <typename T>
int launch_compression(const CompressionArgs* args, void* stream) {
  compression_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_compression_adjoint(const CompressionArgs* args, void* stream) {
  compression_adjoint_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_compression_f32(const void* args, void* stream) {
  return launch_compression<float>(static_cast<const CompressionArgs*>(args), stream);
}

extern "C" int scpn_compression_f64(const void* args, void* stream) {
  return launch_compression<double>(static_cast<const CompressionArgs*>(args), stream);
}

extern "C" int scpn_compression_adjoint_f32(const void* args, void* stream) {
  return launch_compression_adjoint<float>(static_cast<const CompressionArgs*>(args), stream);
}

extern "C" int scpn_compression_adjoint_f64(const void* args, void* stream) {
  return launch_compression_adjoint<double>(static_cast<const CompressionArgs*>(args), stream);
}
