// Fine-level V-cycle legs up to 513^2: one launch per leg.
//
// Replaces: scpn_fusion_tpu/ops/pallas_mg.py:_fine_pre_kernel
// (fine_presmooth_restrict: pre red-black SOR sweeps, the defect s - L[psi]
// and its 9-point full weighting, compact with a zero ring) and
// :_fine_post_kernel (fine_prolong_smooth: bilinear prolongation of the
// coarse error, the correction on the interior, post sweeps), the legs of the
// square 2^k+1 levels above 257^2 up to 513^2.  The wrappers take any level
// with an interior.
//
// What bounds them on an H100: the launch and the chain of dependent stages,
// not bytes.  A 513^2 leg moves 3.4 MB (1 us at 3.35 TB/s, and psi and src
// stay in the 50 MB L2 between the legs), the arithmetic is ~25 Mflop, and an
// empty launch of the grid already costs ~1.0 us.  The staged route (rb_sweep.cu +
// transfer.cu) paid that launch three times on the down leg and five times
// on the up leg, with psi making a round trip through L2 between any two
// stages.
//
// What this design does about it:
//
// * One launch, no grid-wide barrier.  Every CTA recomputes the halo its
//   half-sweeps need (2 * pre + 2 points down, 2 * post up), so the stages of
//   a leg are separated by __syncthreads() alone.  A barrier across the grid
//   or a cluster costs about what a launch boundary does; a leg has three to
//   six stages.
// * A grid that fills the card once.  513^2 is 263,169 points for 132 SMs: a
//   tile a CTA as the 1025^2+ legs cut it (64 x 64, bands of 20 rows) leaves
//   half the SMs empty and the others with five to ten warps, each walking
//   through twenty rows one after another.  Here the tile is small enough that
//   every SM gets a CTA, and the bands are short (a thread owns a few rows of
//   one column), so that an SM holds many warps and each has a short chain:
//   the leg's time is the latency of one CTA's stages, and more warps hide
//   more of it.  The halo's share of recomputed points is the price: every
//   stage runs over the whole slab, 24 * 72 / (16 * 64) = 1.69 times the
//   core at halo 4 (32 x 64 tiles: 1.41 with half the CTAs; measured equal
//   within 5%).  The loads come from L2.
// * The band code of tiled_band.cuh (register bands with a one-row skew,
//   branch-free half-sweeps over a ring that shrinks, the defect once a point,
//   prolongation with selects), with common.cuh's arithmetic in the staged
//   kernels' operand order: the results are bit for bit theirs.
//
// The plan (tile, halo, bands, variant, threads, shared memory) comes from
// ops/cuda_mg.fine_launch_plan.

#define SCPN_PRE_KERNEL fine_pre_kernel
#define SCPN_POST_KERNEL fine_post_kernel

// The instantiations, in the order of ops/cuda_mg.FINE_VARIANTS: (band length
// L, slab pitch P, most threads a CTA, CTAs an SM the registers allow).  The
// plan takes the first that holds the slab: bands of 4 rows while the CTA
// stays within 512 threads ((1, 2) smoothing at 513^2: 256 CTAs of 14 warps),
// bands of 8 beyond ((3, 3): 10 warps a CTA), the wide pitch for large halos.
#define SCPN_LEG_VARIANTS(RUN, ...)                              \
  switch (variant) {                                             \
    case 0: return RUN<4, 80, 512, 1>(__VA_ARGS__);              \
    case 1: return RUN<8, 80, 512, 1>(__VA_ARGS__);              \
    case 2: return RUN<8, 176, 1024, 1>(__VA_ARGS__);            \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

#include "tiled_band.cuh"

extern "C" int scpn_fine_pre(const void* psi, const void* src, const void* r, int r_stride,
                             const void* plan, float inv_dr2, float dr, float a_ns, float a_c,
                             float inv_ac, float omega, void* psi_out, void* d_c, void* stream) {
  return entry_pre(psi, src, r, r_stride, plan, inv_dr2, dr, a_ns, a_c, inv_ac, omega, psi_out,
                   d_c, stream);
}

extern "C" int scpn_fine_post(const void* psi_s, const void* src, const void* e, const void* r,
                              int r_stride, const void* plan, float inv_dr2, float dr,
                              float a_ns, float inv_ac, float omega, void* out, void* stream) {
  return entry_post(psi_s, src, e, r, r_stride, plan, inv_dr2, dr, a_ns, inv_ac, omega, out,
                    stream);
}

// CTAs of the plan's kernel that one SM holds at once (leg 0 down, 1 up),
// written to *ctas_per_sm; returns the CUDA error (a refused plan: invalid value).
extern "C" int scpn_fine_ctas_per_sm(int leg, const void* plan, int* ctas_per_sm) {
  return entry_ctas_per_sm(leg, plan, ctas_per_sm);
}
