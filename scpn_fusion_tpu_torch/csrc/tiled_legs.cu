// Tiled fine-level V-cycle legs: one launch per leg, every stage of the leg
// in shared memory and registers.
//
// Replaces: scpn_fusion_tpu/ops/pallas_mg_tiled.py:_tiled_pre_kernel
// (tiled_presmooth_restrict: pre red-black SOR sweeps, the defect s - L[psi]
// and its 9-point full weighting) and :_tiled_post_kernel
// (tiled_prolong_smooth: bilinear prolongation of the coarse error, the
// correction on the interior, post sweeps), the legs of every square 2^k+1
// level from 1025^2 to 4097^2.
//
// What bounds them on an H100: device-memory bytes.  Each leg has to read
// psi and src (8 bytes a fine point) and write psi (4 bytes) plus a
// quarter-size coarse array (1 byte a fine point): ~13 bytes a fine point,
// 55 MB at 2049^2, ~16 us at 3.35 TB/s.  The arithmetic (about 11 flops a
// point a sweep) is far below the f32 rate, so what a design can lose is
// instruction slots, shared-memory words and idle SMs.  The first design
// (tiled_legs_slab.cu) lost all three.
//
// What this design does about it is the band code of tiled_band.cuh (a thread
// keeps a band of one slab column in registers, branch-free half-sweeps over
// a ring that shrinks, four shared-memory words a point update where the
// first design took nine), instantiated here for grids of many waves: 64 x 64
// tiles (2049^2 is 1024 CTAs of 320 threads), bands of 20 rows, three CTAs an
// SM.  The plan comes from ops/cuda_mg_tiled.launch_plan.  Nothing is
// double-buffered: the three resident CTAs of an SM overlap one's loads with
// another's sweeps, and that is what still holds the legs at about twice
// their bound, with the halo's share of the reads ((64 + 16)^2 / 64^2 = 1.56
// on the down leg).

#define SCPN_PRE_KERNEL tiled_pre_kernel
#define SCPN_POST_KERNEL tiled_post_kernel

// The instantiations, in the order of ops/cuda_mg_tiled.VARIANTS: (band
// length L, slab pitch P, most threads a CTA, CTAs an SM the registers allow).
#define SCPN_LEG_VARIANTS(RUN, ...)                              \
  switch (variant) {                                             \
    case 0: return RUN<20, 80, 320, 3>(__VA_ARGS__);             \
    case 1: return RUN<36, 176, 1024, 1>(__VA_ARGS__);           \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

#include "tiled_band.cuh"

extern "C" int scpn_tiled_pre(const void* psi, const void* src, const void* r, int r_stride,
                              const void* plan, float inv_dr2, float dr, float a_ns, float a_c,
                              float inv_ac, float omega, void* psi_out, void* d_c,
                              void* stream) {
  return entry_pre(psi, src, r, r_stride, plan, inv_dr2, dr, a_ns, a_c, inv_ac, omega, psi_out,
                   d_c, stream);
}

extern "C" int scpn_tiled_post(const void* psi_s, const void* src, const void* e, const void* r,
                               int r_stride, const void* plan, float inv_dr2, float dr,
                               float a_ns, float inv_ac, float omega, void* out, void* stream) {
  return entry_post(psi_s, src, e, r, r_stride, plan, inv_dr2, dr, a_ns, inv_ac, omega, out,
                    stream);
}

// CTAs of the plan's kernel that one SM holds at once (leg 0 down, 1 up),
// written to *ctas_per_sm; returns the CUDA error (a refused plan: invalid value).
extern "C" int scpn_tiled_ctas_per_sm(int leg, const void* plan, int* ctas_per_sm) {
  return entry_ctas_per_sm(leg, plan, ctas_per_sm);
}
