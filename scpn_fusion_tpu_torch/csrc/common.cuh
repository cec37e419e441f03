// Shared device helpers for the GS* kernels.
//
// Fields are row-major (NZ, NR) float32 arrays, axis 0 = Z, axis 1 = R, as in
// the JAX package.  Every kernel works on one compacted multigrid level (an
// x[::2, ::2] grid of the level above), so red/black parity is (i + j) % 2 on
// the level's own indices.
#pragma once

#include <cuda_runtime.h>

namespace scpn {

// East/west coefficients of the toroidal five-point stencil at column j:
//   a_E = 1/dR^2 - 1/(2 R dR),  a_W = 1/dR^2 + 1/(2 R dR),  R floored at 1e-10.
// Computed from the level's R row on the fly (the row may be a strided view
// of the finest level's R), in the order the plain PyTorch ops use.
__device__ __forceinline__ void stencil_ew(const float* __restrict__ r, int r_stride, int j,
                                           float inv_dr2, float dr, float& a_e, float& a_w) {
  const float rs = fmaxf(r[(long long)j * r_stride], 1e-10f);
  const float t = 1.0f / __fmul_rn(2.0f * rs, dr);
  a_e = inv_dr2 - t;
  a_w = inv_dr2 + t;
}

// One red-black SOR update of point idx (an interior point):
//   gs = (a_E p_E + a_W p_W + a_NS (p_N + p_S) - s) / a_C,  p + omega (gs - p).
// No 1e12 clip, like the Pallas kernels this replaces.
__device__ __forceinline__ float rb_update(const float* p, const float* __restrict__ s, int idx,
                                           int nr, float a_e, float a_w, float a_ns,
                                           float inv_ac, float omega) {
  const float q = p[idx];
  const float gs = (a_e * p[idx + 1] + a_w * p[idx - 1] + a_ns * (p[idx + nr] + p[idx - nr])
                    - s[idx]) * inv_ac;
  return q + omega * (gs - q);
}

}  // namespace scpn
