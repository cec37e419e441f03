// The guiding-centre orbit (row F): a whole fast-ion population, or one
// orbit, in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/fast_ions.py:
// follow_ensemble (:146-227) is a vmap over the particles of a lax.scan of
// guiding-centre RK4 steps (orbits._gc_eom, orbits.py:63-87: the field, its
// jax.grad of |B| and ~25 products and quotients, four times a step), with
// the wall and bounce flags updated each step, in one compiled XLA program;
// orbits.run_guiding_center (:90-123) is the same scan for one particle with
// the (R, Z) trace.  Eager PyTorch runs a step as ~500 launches of small ops
// (the plain versions: the loops of the port's fast_ions.ensemble_step and
// orbits.gc_rk4_step over the particles as one batch).
//
// Design: one thread a particle, the step loop inside, the state (R, Z, phi,
// v_par), mu, sign(v_par0), the birth energy and the two flags in
// registers; 64 threads a CTA, so the JAX tests' 2048 particles spread over
// 32 of the 132 SMs.  The ensemble entry writes the final state (n, 4), the
// lost and bounced flags and the relative energy drift (n,); the orbit entry
// (one thread, no walls) writes the (n_steps,) traces of R and Z as it goes.
// The field is fast_ions.tokamak_field's analytic circular-surface field,
// its five parameters among the constants: field() computes B and |B| with
// d|B|/dR and d|B|/dZ carried forward as (value, d/dR, d/dZ) through the
// expression sequence of TokamakField.with_gradient, written out once.
// Freeze, loss and bounce follow fast_ions.py:191-196 to the letter: the new
// state is taken only while the particle was not yet lost, and the bounce
// test reads the state so taken.
//
// Arithmetic: every product, sum, difference, quotient and square root is
// rounded on its own (the Arith helpers), in the order of the plain PyTorch
// ops, which divide by 0-d tensors (on a CUDA tensor a Python divisor
// becomes a multiplication by its reciprocal; here every quotient is a
// division).  The constants -- m, q, dt, dt/2, dt/6, m/2, the field's and the
// walls' -- are the tensors the plain step reads, handed over as one array.
// maximum passes a NaN as torch.maximum does, and d maximum(rm, floor)/d rm
// is JAX's: 1 above, one half at a tie, 0 below.  So the kernel equals its
// plain version bit for bit in float32 and float64.
//
// What bounds it on an H100: the bytes are the state in (5 n values) and the
// outputs (6 n values; the orbit: 2 n_steps + 4); the operations ~480 a
// particle-step (four right-hand sides of ~115, the update), each
// particle's chain n_steps x ~4 x ~45 dependent operations deep, four square
// roots and ~14 IEEE divisions a right-hand side among them.  Neither bound:
// the chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct OrbitArgs {
  const void* consts;   // (kNConst,) in Const's order (the orbit entry reads the first kNField)
  const void* state;    // (5, n): R, Z, phi, v_par, mu
  void* final;          // (n, 4): R, Z, phi, v_par after the last step
  void* lost;           // (n,) uint8 (the ensemble entry)
  void* bounced;        // (n,) uint8 (the ensemble entry)
  void* drift;          // (n,) |E_f - E_0| / E_0 (the ensemble entry)
  void* trace_r;        // (n_steps,) R after each step (the orbit entry)
  void* trace_z;        // (n_steps,) Z after each step (the orbit entry)
  int n;
  int n_steps;
};

// cuda_orbits.CONSTANTS, in order
enum Const {
  kM, kQ, kDt, kHalfDt, kDt6, kHalfM,             // orbits.step_constants
  kB0R0, kR0, kB0, kA, kQ0, kDq, kFloor, kNField,  // TokamakField.constants
  kRIn = kNField, kROut, kZWall, kNConst           // the walls
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float root(float x) { return __fsqrt_rn(x); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double root(double x) { return __dsqrt_rn(x); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
};

// torch.maximum: a NaN of either side wins
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// torch.sign
template <typename T>
__device__ __forceinline__ T sign(T x) {
  if (x != x) return x;
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// B, |B| and grad |B| at one point
template <typename T>
struct Field {
  T br, bz, bphi, b, b_r, b_z;
};

// TokamakField.with_gradient, op for op
template <typename T>
__device__ __forceinline__ void field(const T* c, T r, T z, Field<T>& f) {
  using A = Arith<T>;
  f.bphi = A::div(c[kB0R0], r);
  const T bphi_r = -A::div(f.bphi, r);
  const T dr = A::sub(r, c[kR0]);
  const T rm = A::root(A::add(A::mul(dr, dr), A::mul(z, z)));
  const T rm_r = A::div(dr, rm), rm_z = A::div(z, rm);
  const T rs = maximum(rm, c[kFloor]);
  const T g = rm > c[kFloor] ? T(1) : (rm == c[kFloor] ? T(0.5) : T(0));
  const T rs_r = A::mul(rm_r, g), rs_z = A::mul(rm_z, g);
  const T x = A::div(rm, c[kA]);
  const T x_r = A::div(rm_r, c[kA]), x_z = A::div(rm_z, c[kA]);
  const T qf = A::add(c[kQ0], A::mul(c[kDq], A::mul(x, x)));
  const T tx = A::mul(T(2), x);
  const T qf_r = A::mul(c[kDq], A::mul(tx, x_r)), qf_z = A::mul(c[kDq], A::mul(tx, x_z));
  const T num = A::mul(rm, c[kB0]);
  const T num_r = A::mul(rm_r, c[kB0]), num_z = A::mul(rm_z, c[kB0]);
  const T den = A::mul(qf, r);
  const T den_r = A::add(A::mul(qf_r, r), qf), den_z = A::mul(qf_z, r);
  const T bp = A::div(num, den);
  const T bp_r = A::div(A::sub(num_r, A::mul(bp, den_r)), den);
  const T bp_z = A::div(A::sub(num_z, A::mul(bp, den_z)), den);
  const T nb = -bp, nb_r = -bp_r, nb_z = -bp_z;
  const T u = A::mul(nb, z), u_r = A::mul(nb_r, z), u_z = A::add(A::mul(nb_z, z), nb);
  f.br = A::div(u, rs);
  const T br_r = A::div(A::sub(u_r, A::mul(f.br, rs_r)), rs);
  const T br_z = A::div(A::sub(u_z, A::mul(f.br, rs_z)), rs);
  const T w = A::mul(bp, dr), w_r = A::add(A::mul(bp_r, dr), bp), w_z = A::mul(bp_z, dr);
  f.bz = A::div(w, rs);
  const T bz_r = A::div(A::sub(w_r, A::mul(f.bz, rs_r)), rs);
  const T bz_z = A::div(A::sub(w_z, A::mul(f.bz, rs_z)), rs);
  f.b = A::root(A::add(A::add(A::mul(f.br, f.br), A::mul(f.bz, f.bz)), A::mul(f.bphi, f.bphi)));
  f.b_r = A::div(A::add(A::add(A::mul(f.br, br_r), A::mul(f.bz, bz_r)), A::mul(f.bphi, bphi_r)),
                 f.b);
  f.b_z = A::div(A::add(A::mul(f.br, br_z), A::mul(f.bz, bz_z)), f.b);
}

// orbits._gc_eom: (dR, dZ, dphi, dv_par)/dt
template <typename T>
__device__ __forceinline__ void eom(const T* c, const T* y, T mu, T* k) {
  using A = Arith<T>;
  Field<T> f;
  field(c, y[0], y[1], f);
  const T v = y[3];
  const T omega_c = A::div(A::mul(c[kQ], f.b), c[kM]);
  const T bxg_r = A::mul(f.bphi, f.b_z);
  const T bxg_phi = A::sub(A::mul(f.bz, f.b_r), A::mul(f.br, f.b_z));
  const T bxg_z = A::mul(-f.bphi, f.b_r);
  const T drift = A::div(A::add(A::mul(v, v), A::div(A::mul(mu, f.b), c[kM])),
                         A::mul(omega_c, A::mul(f.b, f.b)));
  k[0] = A::add(A::div(A::mul(v, f.br), f.b), A::mul(drift, bxg_r));
  k[1] = A::add(A::div(A::mul(v, f.bz), f.b), A::mul(drift, bxg_z));
  k[2] = A::add(A::div(A::mul(v, f.bphi), A::mul(y[0], f.b)), A::div(A::mul(drift, bxg_phi), y[0]));
  const T bdg = A::add(A::mul(f.br, f.b_r), A::mul(f.bz, f.b_z));
  k[3] = A::div(A::mul(-A::div(mu, c[kM]), bdg), f.b);
}

// orbits.gc_rk4_step, in place
template <typename T>
__device__ __forceinline__ void rk4(const T* c, T* y, T mu) {
  using A = Arith<T>;
  T k1[4], k2[4], k3[4], k4[4], t[4];
  eom(c, y, mu, k1);
  for (int i = 0; i < 4; ++i) t[i] = A::add(y[i], A::mul(c[kHalfDt], k1[i]));
  eom(c, t, mu, k2);
  for (int i = 0; i < 4; ++i) t[i] = A::add(y[i], A::mul(c[kHalfDt], k2[i]));
  eom(c, t, mu, k3);
  for (int i = 0; i < 4; ++i) t[i] = A::add(y[i], A::mul(c[kDt], k3[i]));
  eom(c, t, mu, k4);
  for (int i = 0; i < 4; ++i)
    y[i] = A::add(y[i], A::mul(c[kDt6], A::add(A::add(A::add(k1[i], A::mul(T(2), k2[i])),
                                                      A::mul(T(2), k3[i])), k4[i])));
}

// fast_ions.ensemble_energy: m v_par^2 / 2 + mu |B|
template <typename T>
__device__ __forceinline__ T energy(const T* c, const T* y, T mu) {
  using A = Arith<T>;
  Field<T> f;
  field(c, y[0], y[1], f);
  return A::add(A::mul(c[kHalfM], A::mul(y[3], y[3])), A::mul(mu, f.b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gc_ensemble_kernel(const OrbitArgs a) {
  using A = Arith<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const T* __restrict__ c = static_cast<const T*>(a.consts);
  const T* s = static_cast<const T*>(a.state);
  const size_t n = static_cast<size_t>(a.n);
  T y[4] = {s[i], s[n + i], s[2 * n + i], s[3 * n + i]};
  const T mu = s[4 * n + i];
  const T sign0 = sign(y[3]);
  const T e0 = energy(c, y, mu);
  bool lost = false, bounced = false;
  for (int k = 0; k < a.n_steps; ++k) {
    T yn[4] = {y[0], y[1], y[2], y[3]};
    rk4(c, yn, mu);
    const bool out = (yn[0] > c[kROut]) | (yn[0] < c[kRIn]) | (A::mag(yn[1]) > c[kZWall]);
    if (!lost) {
      for (int j = 0; j < 4; ++j) y[j] = yn[j];
    }
    lost = lost | out;
    bounced = bounced | (!lost & (A::mul(y[3], sign0) < T(0)));
  }
  T* fin = static_cast<T*>(a.final);
  for (int j = 0; j < 4; ++j) fin[4 * i + j] = y[j];
  static_cast<unsigned char*>(a.lost)[i] = lost;
  static_cast<unsigned char*>(a.bounced)[i] = bounced;
  static_cast<T*>(a.drift)[i] = A::div(A::mag(A::sub(energy(c, y, mu), e0)), e0);
}

template <typename T>
__global__ void gc_orbit_kernel(const OrbitArgs a) {
  const T* c = static_cast<const T*>(a.consts);
  const T* s = static_cast<const T*>(a.state);
  T y[4] = {s[0], s[1], s[2], s[3]};
  const T mu = s[4];
  T* tr = static_cast<T*>(a.trace_r);
  T* tz = static_cast<T*>(a.trace_z);
  for (int k = 0; k < a.n_steps; ++k) {
    rk4(c, y, mu);
    tr[k] = y[0];
    tz[k] = y[1];
  }
  T* fin = static_cast<T*>(a.final);
  for (int j = 0; j < 4; ++j) fin[j] = y[j];
}

template <typename T>
int launch_ensemble(const OrbitArgs* args, void* stream) {
  const int blocks = (args->n + kThreads - 1) / kThreads;
  gc_ensemble_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_orbit(const OrbitArgs* args, void* stream) {
  gc_orbit_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_gc_ensemble_f32(const void* args, void* stream) {
  return launch_ensemble<float>(static_cast<const OrbitArgs*>(args), stream);
}

extern "C" int scpn_gc_ensemble_f64(const void* args, void* stream) {
  return launch_ensemble<double>(static_cast<const OrbitArgs*>(args), stream);
}

extern "C" int scpn_gc_orbit_f32(const void* args, void* stream) {
  return launch_orbit<float>(static_cast<const OrbitArgs*>(args), stream);
}

extern "C" int scpn_gc_orbit_f64(const void* args, void* stream) {
  return launch_orbit<double>(static_cast<const OrbitArgs*>(args), stream);
}
