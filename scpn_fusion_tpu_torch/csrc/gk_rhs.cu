// One RK4 stage of the nonlinear gyrokinetic right-hand side, every species
// at once, in ONE launch (row G).
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/gyrokinetics/nonlinear.py
// computes gk_rhs (:395-433) and the RK4 bookkeeping of rk4_step (:451-461)
// as one jitted XLA program.  Eager PyTorch runs the pointwise body of a
// stage as ~150 launches that each stream the whole 5D array (the plain
// version: ops/cuda_gk.py:gk_stage_plain); this kernel is that body in one
// pass.
//
// f has shape (S, n_kx, n_ky, n_theta, n_vpar, n_mu), complex, row-major;
// one thread a point, grid-stride.  For species s, with fin the stage's input:
//
//   k = active_s * ( -v_s vpar bgrad d_theta(fin)          parallel streaming
//                    - q_s i omega_D fin                    magnetic drift
//                    - bracket                              ExB (input)
//                    - nu kperp^2 fin  |  + coll            Krook | conservative (input)
//                    - hyper kperp^(2p) fin )               hyperdiffusion
//       - i omega_*s phi_eff F_M                            gradient drive
//       - zonal [ky = 0] fin                                zonal damping
//
// d_theta is the 4th-order centred stencil; a neighbour that wraps the theta
// boundary comes from `tw`, the ballooning-twisted planes (S_active, n_kx,
// n_ky, 4, n_vpar, n_mu): e^{-i s ky x} of planes 0 and 1 (read past the top)
// and e^{+i s ky x} of planes n_theta-2 and n_theta-1 (read below the
// bottom), made by torch.fft on those planes alone.  An inactive (adiabatic)
// electron species skips its terms: its k is the zonal term alone (JAX
// multiplies the terms by 0, which is the same for finite f), and its fin is
// read only where that term is nonzero (ky = 0).
//
// The stage then writes, in JAX's order (acc = k1 + 2 k2 + 2 k3 + k4):
//   stage 0: acc = k,          next = f0 + (0.5 dt) k
//   stage 1: acc = acc + 2 k,  next = f0 + (0.5 dt) k
//   stage 2: acc = acc + 2 k,  next = f0 + dt k
//   stage 3:                   next = f0 + (dt / 6) (acc + k)
// The accumulator holds the first n_acc species, those whose k can be
// nonzero: all of them, or the ions alone when the electrons are adiabatic
// and undamped.  A species past n_acc has k = 0 at every stage, so its point
// reads f0 and writes next = f0 + c * 0, and touches neither fin nor acc.
// dt is read from the device (the adaptive CFL step never visits the host).
//
// Arithmetic: the plain version's operation order, in T (float for
// complex64, double for complex128); the compiler may contract a product
// and a sum into an FMA, so the kernel agrees with the plain version to
// rounding, not bit for bit.  Complex tensors arrive as float2 / double2
// (torch.view_as_real's layout).
//
// What bounds it on an H100: the bytes.  A stage reads f0 and writes next for
// every species, and reads fin, the bracket and (stages 1-3) acc and writes
// (stages 0-2) acc for the species that have a k: at the default 2 x 16 x 16
// x 32 x 16 x 8 complex64 (adiabatic electrons) ~68 MB a middle stage, ~20 us
// at 3.35 TB/s; at 2 x 32 x 32 x 16 x 16 x 8 complex128 ~270 MB, ~80 us.  The
// ~70 flops a point are far below the f32 and f64 peaks.

#include <cuda_runtime.h>

namespace {

struct GKStageArgs {
  const void* f0;          // (S, ...) the step's base f
  const void* fin;         // (S, ...) the stage's input
  const void* acc_in;      // (n_acc, ...) the RK accumulator (stages 1-3)
  void* next;              // (S, ...) the next stage's input (stage 3: the new f)
  void* acc_out;           // (n_acc, ...) the accumulator out (stages 0-2; may be acc_in)
  const void* bracket;     // (S_active, ...) masked ExB bracket, or null
  const void* coll;        // (S_active, ...) conservative collision term, or null
  const void* tw;          // (S_active, n_kx, n_ky, 4, n_vpar, n_mu) twisted planes
  const void* phi;         // (n_kx, n_ky, n_theta)
  const void* a_par;       // (n_kx, n_ky, n_theta), or null
  const void* b_par;       // (n_kx, n_ky, n_theta), or null
  const void* dt;          // 0-d real
  const void* vpar;        // (n_vpar,)
  const void* mu;          // (n_mu,)
  const void* b_ratio;     // (n_theta,)
  const void* kappa_n;     // (n_theta,)
  const void* kappa_g;     // (n_theta,)
  const void* b_dot_grad;  // (n_theta,)
  const void* ky;          // (n_ky,)
  const void* kperp2;      // (n_kx, n_ky)
  const void* maxwellian;  // (n_vpar, n_mu)
  const void* energy;      // (n_vpar, n_mu)
  long long n_total;       // S * n_kx * n_ky * n_theta * n_vpar * n_mu
  int n_species, n_kx, n_ky, n_theta, n_vpar, n_mu;
  int n_acc;               // leading species whose k can be nonzero (1 or n_species)
  int stage;               // 0..3
  int electrons_active;    // kinetic electrons
  int nonlinear;           // subtract the bracket
  int krook;               // Krook collisions
  int coll_input;          // add `coll`
  int electromagnetic;     // phi_eff with A_par and B_par
  int hyper_p;             // hyper_order / 2
  int zonal;               // zonal_rate > 0
  double d_theta, v_scale_e, nu, hyper_coeff, zonal_rate, r_l_ne, eta_i, eta_e;
};

template <typename T> struct C2;
template <> struct C2<float> { using type = float2; };
template <> struct C2<double> { using type = double2; };

template <typename T>
__global__ void __launch_bounds__(256) gk_stage_kernel(GKStageArgs a) {
  using C = typename C2<T>::type;
  const C* __restrict__ f0 = static_cast<const C*>(a.f0);
  const C* __restrict__ fin = static_cast<const C*>(a.fin);
  const C* acc_in = static_cast<const C*>(a.acc_in);
  C* __restrict__ next = static_cast<C*>(a.next);
  C* acc_out = static_cast<C*>(a.acc_out);
  const C* __restrict__ bracket = static_cast<const C*>(a.bracket);
  const C* __restrict__ coll = static_cast<const C*>(a.coll);
  const C* __restrict__ tw = static_cast<const C*>(a.tw);
  const C* __restrict__ phi = static_cast<const C*>(a.phi);
  const C* __restrict__ a_par = static_cast<const C*>(a.a_par);
  const C* __restrict__ b_par = static_cast<const C*>(a.b_par);
  const T* __restrict__ vpar = static_cast<const T*>(a.vpar);
  const T* __restrict__ mu = static_cast<const T*>(a.mu);
  const T* __restrict__ b_ratio = static_cast<const T*>(a.b_ratio);
  const T* __restrict__ kappa_n = static_cast<const T*>(a.kappa_n);
  const T* __restrict__ kappa_g = static_cast<const T*>(a.kappa_g);
  const T* __restrict__ b_dot_grad = static_cast<const T*>(a.b_dot_grad);
  const T* __restrict__ ky_t = static_cast<const T*>(a.ky);
  const T* __restrict__ kperp2 = static_cast<const T*>(a.kperp2);
  const T* __restrict__ maxw = static_cast<const T*>(a.maxwellian);
  const T* __restrict__ energy_t = static_cast<const T*>(a.energy);

  const T dt = *static_cast<const T*>(a.dt);
  const long long nm = a.n_mu, nv = a.n_vpar, nth = a.n_theta, nky = a.n_ky, nkx = a.n_kx;
  const long long plane = nv * nm;                 // one theta plane of (vpar, mu)
  const T twelve_dth = T(12) * static_cast<T>(a.d_theta);
  const T hyper = -static_cast<T>(a.hyper_coeff);
  const T nu = -static_cast<T>(a.nu);
  const T zonal_rate = static_cast<T>(a.zonal_rate);
  const T r_l_ne = static_cast<T>(a.r_l_ne);
  const T c_next = a.stage == 2 ? dt : (a.stage == 3 ? dt / T(6) : T(0.5) * dt);

  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.n_total;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i;
    const int m = static_cast<int>(r % nm); r /= nm;
    const int v = static_cast<int>(r % nv); r /= nv;
    const int th = static_cast<int>(r % nth); r /= nth;
    const int iy = static_cast<int>(r % nky); r /= nky;
    const int ix = static_cast<int>(r % nkx); r /= nkx;
    const int s = static_cast<int>(r);

    const C b0 = f0[i];
    if (s >= a.n_acc) {
      // k = 0 (JAX's inactive species times 0): next = f0 + c * 0
      next[i] = C{b0.x + c_next * T(0), b0.y + c_next * T(0)};
      continue;
    }
    const T ky = ky_t[iy];
    const bool active = s == 0 || a.electrons_active;
    const bool zonal_here = a.zonal && fabs(ky) < T(1e-10);
    const C fv = (active || zonal_here) ? fin[i] : C{T(0), T(0)};
    C k = {T(0), T(0)};
    if (active) {
      const T kp2 = kperp2[ix * nky + iy];
      const T vp = vpar[v];
      // parallel streaming: (-F(+2) + 8 F(+1) - 8 F(-1) + F(-2)) / (12 d_theta)
      const long long col = ((static_cast<long long>(s) * nkx + ix) * nky + iy);
      const long long row0 = col * nth * plane + v * nm + m;   // theta plane 0 of this point
      const long long tw0 = col * 4 * plane + v * nm + m;
      C fn[4];
      const int offs[4] = {2, 1, -1, -2};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = th + offs[j];
        if (t >= 0 && t < nth) {
          fn[j] = fin[row0 + t * plane];
        } else {
          const int p = t >= nth ? t - static_cast<int>(nth) : t + 4;
          fn[j] = tw[tw0 + p * plane];
        }
      }
      C d;
      d.x = (((-fn[0].x + T(8) * fn[1].x) - T(8) * fn[2].x) + fn[3].x) / twelve_dth;
      d.y = (((-fn[0].y + T(8) * fn[1].y) - T(8) * fn[2].y) + fn[3].y) / twelve_dth;
      const T vb = vp * b_dot_grad[th];
      const T mvs = s == 0 ? T(-1) : -static_cast<T>(a.v_scale_e);
      C terms = {mvs * (vb * d.x), mvs * (vb * d.y)};
      // magnetic drift: i omega_D fin, charge sign +1 (ions) / -1 (electrons)
      const T vp2 = vp * vp;
      const T mub = mu[m] * b_ratio[th];
      const T en = T(0.5) * vp2 + mub;
      T xi2 = vp2 / fmax(vp2 + T(2) * mub, T(1e-30));
      xi2 = fmax(xi2, T(0));
      const T od = ((ky * T(2)) * en) * (kappa_n[th] * xi2 + kappa_g[th] * sqrt(xi2));
      if (s == 0) {
        terms.x = terms.x - (-od * fv.y);
        terms.y = terms.y - od * fv.x;
      } else {
        terms.x = terms.x + (-od * fv.y);
        terms.y = terms.y + od * fv.x;
      }
      if (a.nonlinear) {
        const C b = bracket[i];
        terms.x -= b.x;
        terms.y -= b.y;
      }
      if (a.krook) {
        const T c = nu * kp2;
        terms.x += c * fv.x;
        terms.y += c * fv.y;
      } else if (a.coll_input) {
        const C c = coll[i];
        terms.x += c.x;
        terms.y += c.y;
      }
      T kp = T(1);
      for (int p = 0; p < a.hyper_p; ++p) kp *= kp2;
      const T h = hyper * kp;
      k.x = terms.x + h * fv.x;
      k.y = terms.y + h * fv.y;
      // gradient drive: -i omega_* phi_eff F_M
      const long long fidx = (static_cast<long long>(ix) * nky + iy) * nth + th;
      C pe = phi[fidx];
      if (a.electromagnetic) {
        const C ap = a_par[fidx], bp = b_par[fidx];
        const T mv = mu[m];
        pe.x = (pe.x - vp * ap.x) + mv * bp.x;
        pe.y = (pe.y - vp * ap.y) + mv * bp.y;
      }
      const T e = energy_t[v * nm + m];
      const T os = s == 0 ? (ky * r_l_ne) * (T(1) + static_cast<T>(a.eta_i) * (e - T(1.5)))
                          : (-ky * r_l_ne) * (T(1) + static_cast<T>(a.eta_e) * (e - T(1.5)));
      const T fm = maxw[v * nm + m];
      k.x = k.x + (os * pe.y) * fm;
      k.y = k.y + (-(os * pe.x)) * fm;
    }
    if (zonal_here) {
      k.x = k.x - zonal_rate * fv.x;
      k.y = k.y - zonal_rate * fv.y;
    }
    // the RK4 bookkeeping
    if (a.stage == 3) {
      const C ac = acc_in[i];
      const T sx = ac.x + k.x, sy = ac.y + k.y;
      next[i] = C{b0.x + c_next * sx, b0.y + c_next * sy};
    } else {
      C ac = k;
      if (a.stage > 0) {
        const C ai = acc_in[i];
        ac = C{ai.x + T(2) * k.x, ai.y + T(2) * k.y};
      }
      acc_out[i] = ac;
      next[i] = C{b0.x + c_next * k.x, b0.y + c_next * k.y};
    }
  }
}

template <typename T>
int launch_gk_stage(const GKStageArgs* args, void* stream) {
  if (args->n_total < 1 || args->n_theta < 4 || args->stage < 0 || args->stage > 3 ||
      args->n_acc < 1 || args->n_acc > args->n_species)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (args->n_total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  gk_stage_kernel<T><<<static_cast<int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_gk_stage_c64(const void* args, void* stream) {
  return launch_gk_stage<float>(static_cast<const GKStageArgs*>(args), stream);
}

extern "C" int scpn_gk_stage_c128(const void* args, void* stream) {
  return launch_gk_stage<double>(static_cast<const GKStageArgs*>(args), stream);
}
