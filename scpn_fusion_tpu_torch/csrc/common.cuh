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

// One red-black SOR update from the point's value q, its four neighbours and
// its right-hand side s:
//   gs = (a_E p_E + a_W p_W + a_NS (p_N + p_S) - s) / a_C,  q + omega (gs - q).
// No 1e12 clip, like the Pallas kernels this replaces.  Every kernel's update
// goes through this one expression, wherever its operands were loaded from.
__device__ __forceinline__ float rb_value(float q, float p_e, float p_w, float p_n, float p_s,
                                          float s, float a_e, float a_w, float a_ns,
                                          float inv_ac, float omega) {
  const float gs = (a_e * p_e + a_w * p_w + a_ns * (p_n + p_s) - s) * inv_ac;
  return q + omega * (gs - q);
}

// rb_value at point idx (an interior point) of a row-major level of width nr.
__device__ __forceinline__ float rb_update(const float* p, const float* __restrict__ s, int idx,
                                           int nr, float a_e, float a_w, float a_ns,
                                           float inv_ac, float omega) {
  return rb_value(p[idx], p[idx + 1], p[idx - 1], p[idx + nr], p[idx - nr], s[idx], a_e, a_w,
                  a_ns, inv_ac, omega);
}

// The defect s - L[p] from the point's value q, its neighbours and s, in the
// plain version's operation order:
//   lap = a_E p_E + a_W p_W + a_NS (p_N + p_S) - a_C q.
__device__ __forceinline__ float defect_value(float q, float p_e, float p_w, float p_n,
                                              float p_s, float s, float a_e, float a_w,
                                              float a_ns, float a_c) {
  const float lap = a_e * p_e + a_w * p_w + a_ns * (p_n + p_s) - a_c * q;
  return s - lap;
}

// defect_value at point idx (an interior point) of a row-major level.
__device__ __forceinline__ float gs_defect(const float* p, const float* s, int idx, int nr,
                                          float a_e, float a_w, float a_ns, float a_c) {
  return defect_value(p[idx], p[idx + 1], p[idx - 1], p[idx + nr], p[idx - nr], s[idx], a_e,
                      a_w, a_ns, a_c);
}

// Full weighting of the defect around a coarse point: d(di, dj) is the defect
// at fine offset (di, dj) from it (zero on the fine ring).  Centre 1/4, edges
// 1/8, corners 1/16, summed in the plain version's order.
template <typename Defect>
__device__ __forceinline__ float full_weight(Defect d) {
  const float c = d(0, 0);
  const float edge = d(0, 1) + d(0, -1) + d(1, 0) + d(-1, 0);
  const float diag = d(1, 1) + d(1, -1) + d(-1, 1) + d(-1, -1);
  return 0.25f * c + 0.125f * edge + 0.0625f * diag;
}

// Bilinear prolongation of the coarse error at fine point (i, j) from coarse
// rows i/2 (row0) and i/2 + 1 (row1, read only for odd i), by phase:
// coincident copy, edge mid-points average 2, centres average 4 (the plain
// version's summation order).
__device__ __forceinline__ float prolong_rows(const float* row0, const float* row1, int i,
                                              int j) {
  const int jc = j >> 1;
  if (!(i & 1) && !(j & 1)) return row0[jc];
  if (!(i & 1)) return 0.5f * (row0[jc + 1] + row0[jc]);
  if (!(j & 1)) return 0.5f * (row1[jc] + row0[jc]);
  return 0.25f * (((row1[jc + 1] + row1[jc]) + row0[jc + 1]) + row0[jc]);
}

// prolong_rows on a compact row-major coarse error e of row length nrc.
__device__ __forceinline__ float prolong_at(const float* __restrict__ e, int nrc, int i, int j) {
  const float* row = e + (i >> 1) * nrc;
  return prolong_rows(row, row + nrc, i, j);
}

}  // namespace scpn
