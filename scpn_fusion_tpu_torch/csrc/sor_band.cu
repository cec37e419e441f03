// Red-black SOR sweeps of one level in one launch.
//
// Replaces: scpn_fusion_tpu/ops/pallas_stencil.py:_sor_kernel (entry
// sor_sweeps_pallas): n red-black sweeps of the toroidal GS* stencil on a
// whole (nz, nr) grid, no 1e12 clip, the Dirichlet ring untouched.  Callers:
// the `sor` / `anderson` solver methods and the smoothing and coarsest solve
// of every multigrid level that is not a square 2^k+1 grid.
//
// What bounds it on an H100: the chain of dependent half-sweeps, not bytes
// or operations.  A 129^2 level is 200 KB in and 66 KB out (0.08 us at
// 3.35 TB/s) and 50 sweeps are 18 Mflop (0.27 us at the f32 rate); the 100
// half-sweeps each need the one before finished everywhere.  The staged route
// (rb_sweep.cu) paid a launch for each of them and a copy before.
//
// What this design does about it: the band code of tiled_band.cuh (a thread
// keeps a band of one slab column in registers with its a_E, a_W; the skew
// makes register k of every thread colour k & 1, so a half-sweep is a
// branch-free unrolled loop over one colour with only east, west and the
// source read from shared memory), in one of two plans made by
// ops/leg_plan.sor_launch_plan:
//
// * route A, one CTA holds the level (one tile with a halo of 2, any number
//   of sweeps): the Pallas kernel's whole-grid residency with a
//   __syncthreads() in place of each launch.  Levels up to 133 columns whose
//   bands fit 1024 threads: 129^2, 129 x 65, every coarse level of a
//   rectangular V-cycle.
// * route B, tiles over many CTAs (halo 2 * n, the ring shrinking by one
//   point a half-sweep): any level, a few sweeps (the multigrid smoothing of a
//   large rectangular level, the default `sor` method's one sweep).
//
// The arithmetic is common.cuh's rb_value with the staged kernel's operands
// and coefficients, so both routes equal the staged route bit for bit.

#define SCPN_SWEEP_KERNEL sor_band_kernel

// The instantiations, in the order of ops/leg_plan.SOR_VARIANTS: (band length
// L, slab pitch P, most threads a CTA, CTAs an SM the registers allow).
// Variants 0 and 1 are route B's (the fine legs' tiles); 2 to 4 are route A's,
// by the width of the level (slab columns up to 40, 72, 136).
#define SCPN_LEG_VARIANTS(RUN, ...)                              \
  switch (variant) {                                             \
    case 0: return RUN<4, 80, 512, 1>(__VA_ARGS__);              \
    case 1: return RUN<8, 80, 512, 1>(__VA_ARGS__);              \
    case 2: return RUN<8, 40, 1024, 1>(__VA_ARGS__);             \
    case 3: return RUN<16, 72, 1024, 1>(__VA_ARGS__);            \
    case 4: return RUN<20, 136, 1024, 1>(__VA_ARGS__);           \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

#include "tiled_band.cuh"

extern "C" int scpn_sor_band(const void* psi, const void* src, const void* r, int r_stride,
                             const void* plan, float inv_dr2, float dr, float a_ns, float inv_ac,
                             float omega, void* out, void* stream) {
  return entry_sweep(psi, src, r, r_stride, plan, inv_dr2, dr, a_ns, inv_ac, omega, out, stream);
}

// CTAs of the plan's kernel that one SM holds at once (leg 2), written to
// *ctas_per_sm; returns the CUDA error (a refused plan: invalid value).
extern "C" int scpn_sor_ctas_per_sm(int leg, const void* plan, int* ctas_per_sm) {
  return entry_ctas_per_sm(leg, plan, ctas_per_sm);
}
