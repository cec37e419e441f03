// One V-cycle leg of a fine level in one launch: every stage of the leg in
// shared memory and registers, one CTA an output tile.  The code of the leg
// kernels, shared by the sources that instantiate it for their levels:
// tiled_legs.cu (1025^2 .. 4097^2, grids of many waves), fine_legs.cu (up to
// 513^2, a grid that fills the card about once) and sor_band.cu (red-black
// sweeps alone, on any level).  Before including this header a source defines
//
//   SCPN_PRE_KERNEL, SCPN_POST_KERNEL   the names of its two leg kernels, or
//   SCPN_SWEEP_KERNEL                   the name of its sweeps-only kernel
//   SCPN_LEG_VARIANTS(RUN, ...)         its instantiations: a switch over
//       `variant` whose cases return RUN<L, P, MAXT, MINB>(__VA_ARGS__): band
//       length, slab pitch, most threads a CTA, CTAs an SM the registers allow
//
// and gets entry_pre / entry_post (or entry_sweep) and entry_ctas_per_sm to
// forward its C entries to.  The launch plan (tile, halo, bands, variant,
// threads, shared memory) is made in Python, where the CPU tests reach it.
//
// The down leg is `pre` red-black SOR sweeps, the defect s - L[psi] and its
// 9-point full weighting (compact, zero ring); the up leg the bilinear
// prolongation of the compact coarse error, the correction on the interior
// and `post` sweeps; the sweeps-only kernel the up leg without the
// prolongation.
//
// * Tiles.  One CTA per TH x TW output tile, tile origin k * TH (even).  The
//   last tile of each direction also takes the grid's last row or column
//   (2049 = 32 * 64 + 1: a last tile of 65, no 33rd tile of one point).
// * Threads own columns.  The slab of (TH + 2H) x (TW + 2H) points is cut
//   into n_seg bands of L rows; a thread owns L consecutive points of one
//   column: rows seg * L + (w & 1) + k, k = 0..L-1, of slab column w.  It
//   keeps them in registers for the whole leg with its column's a_E, a_W.
//   North and south neighbours are registers (shared memory at the two ends
//   of the band); only east, west and the source come from shared memory,
//   and each new value is stored there for the neighbours.  The slab's pitch
//   P is a template parameter, so every shared-memory address of the unrolled
//   loops is a register plus a constant.
// * Loads.  The slab is loaded band by band without the skew, so that a warp
//   reads whole rows: L independent loads in flight a thread, a few
//   instructions a word.  It goes through shared memory once and comes back
//   into the registers with the skew.
// * The skew (w & 1).  With L, H and the tile origin even, register k has
//   colour k & 1 in EVERY thread: a half-sweep is the unrolled loop over the
//   registers of one parity, no index arithmetic, no division, no branch (a
//   point outside the half-sweep's region is computed and not kept; one
//   guard row above and below the slab keeps its reads inside).  And the 32
//   lanes of a warp touch rows r (even w) and r + 1 (odd w) of a slab whose
//   pitch is even, so their east, west and own words fall in 32 different
//   banks: the stride-2 bank conflict of a row-major colour sweep is gone
//   without splitting the colours into two arrays.
// * Only the needed ring.  Half-sweep t of T = 2 * sweeps updates the core
//   grown by g_t = T - 1 - t (+ 2 on the down leg) points, clipped to the
//   grid's interior.  Proof that the core comes out as the untiled sweep's
//   (the halo contract of pallas_mg_tiled.py:27-33 restated for the shrinking
//   region): an update at half-sweep t reads its four neighbours, which have
//   the other colour and were last written at half-sweep t - 1, and its own
//   old value, last written at t - 2.  If every point of the core grown by
//   g_t + 1 holds the untiled value after half-sweep t - 1, every point of
//   the core grown by g_t does after half-sweep t; before the first
//   half-sweep the loaded slab holds the untiled values on the core grown by
//   H >= T (+ 2).  After the last half-sweep the core is right (g = 0), and
//   on the down leg the core grown by 2: the defect of the points within 1
//   of a coarse point of the core (full-weighting radius) reads psi within
//   1 of those (defect radius).  So the down leg needs H >= 2 * pre + 2 and
//   the up leg H >= 2 * post.  Parity and the interior mask come from GLOBAL
//   indices; Dirichlet rows and columns are never updated; points outside
//   the grid load as zero and are never read by an update that counts.
// * One tile for the whole level.  A tile that covers the level (one CTA)
//   needs no halo for its sweeps: every region above is clipped to the
//   level's interior, so every half-sweep updates the whole interior and the
//   CTA may run any number of sweeps, __syncthreads() apart.  Its halo is 2,
//   so that the slab holds the level's last row and column.
// * The defect once a point.  Each thread turns its registers into defects,
//   written over the source in shared memory (zero off the interior); the
//   full weighting of a coarse point then reads nine words, not seventy.
// * Prolongation without a branch.  While its band of psi is in flight a
//   thread reads the L / 2 + 1 coarse rows of its column (two words a row)
//   and forms the phase of each register from them with selects: the row
//   parity of a register is a constant of the unrolled loop.
//
// Updates, defects, weighting and prolongation go through common.cuh's
// helpers in the operand order of the staged kernels (rb_sweep.cu,
// transfer.cu), so the results are bit for bit theirs.  The core is stored
// one warp a row (a contiguous run; rows of 2^k+1 floats have no 16-byte
// pitch, so 4-byte accesses).
#pragma once

#include "common.cuh"

namespace {

struct LegArgs {
  int nz, nr;          // level shape
  int th, tw;          // tile: core rows and columns
  int halo;            // H, even
  int n_sweeps;
  int n_seg;           // row bands a slab; n_seg * L >= th + 2 * halo - 1
  int r_stride;
  int stages;          // stop after this many stages (timing only; 5 or more runs the leg):
                       // down: load, sweep, defect, store the core, full weighting;
                       // up: load and correct, sweep, store the core
  float inv_dr2, dr, a_ns, a_c, inv_ac, omega;
};

struct Tile {
  int z0, z1, c0, c1;  // core rows [z0, z1) and columns [c0, c1), global
  int row0, col0;      // global index of slab point (0, 0)
  int sh, sw;          // slab rows and columns
};

__device__ __forceinline__ int core_end(int start, int tile, int n) {
  const int end = min(start + tile, n - 1);
  return end == n - 1 ? n : end;   // the last tile takes the grid's last line too
}

__device__ __forceinline__ Tile make_tile(const LegArgs& a) {
  Tile t;
  t.z0 = static_cast<int>(blockIdx.y) * a.th;
  t.c0 = static_cast<int>(blockIdx.x) * a.tw;
  t.z1 = core_end(t.z0, a.th, a.nz);
  t.c1 = core_end(t.c0, a.tw, a.nr);
  t.row0 = t.z0 - a.halo;
  t.col0 = t.c0 - a.halo;
  t.sh = a.th + 2 * a.halo;
  t.sw = a.tw + 2 * a.halo;
  return t;
}

// Rows of one field in shared memory: slab rows -1 .. n_seg * L + 1 (the
// guard rows are read by updates that are not kept, never written).
template <int L>
__device__ __forceinline__ int field_rows(const LegArgs& a) {
  return a.n_seg * L + 3;
}

// The thread's band of one slab column.
struct Column {
  bool owns;      // false for the threads beyond n_seg * sw: they store the core and wait
  int w;          // slab column
  int hb;         // first slab row of the band as it is loaded: seg * L
  int h0;         // slab row of register 0: hb + (w & 1)
  int i0, j;      // global row of register 0, global column
  int base;       // slab index of register 0 (pitch P)
  float a_e, a_w;
};

template <int L, int P>
__device__ __forceinline__ Column make_column(const LegArgs& a, const Tile& t) {
  Column c;
  const int seg = static_cast<int>(threadIdx.x) / t.sw;
  c.w = static_cast<int>(threadIdx.x) - seg * t.sw;
  c.owns = seg < a.n_seg;
  c.hb = seg * L;
  c.h0 = c.hb + (c.w & 1);
  c.i0 = t.row0 + c.h0;
  c.j = t.col0 + c.w;
  c.base = c.h0 * P + c.w;
  c.a_e = 0.0f;
  c.a_w = 0.0f;
  return c;
}

// The column's a_E, a_W.  Called once the band's loads are in flight, so that
// the division that follows the load of R does not hold them back.
__device__ __forceinline__ void set_coefficients(const LegArgs& a, Column& c,
                                                 const float* __restrict__ r) {
  if (c.owns && c.j >= 0 && c.j < a.nr) {
    scpn::stencil_ew(r, a.r_stride, c.j, a.inv_dr2, a.dr, c.a_e, c.a_w);
  }
}

// Rows hb .. hb + L - 1 of the thread's column of f into v: L independent
// loads, each a contiguous run across a warp; zero outside the grid.  (The
// bands are loaded without the skew, so that a warp reads whole rows, stored
// to shared memory, and read back with it.)
template <int L>
__device__ __forceinline__ void load_band(const LegArgs& a, const Tile& t, const Column& c,
                                          const float* __restrict__ f, float (&v)[L]) {
  const bool col_in = c.owns && c.j >= 0 && c.j < a.nr;
  const int ib = t.row0 + c.hb;
  const int k_lo = col_in ? -ib : L;
  const int k_hi = a.nz - 1 - ib;
  const float* at = f + c.j;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    v[k] = (k >= k_lo && k <= k_hi) ? at[(ib + k) * a.nr] : 0.0f;
  }
}

template <int L, int P>
__device__ __forceinline__ void store_band(const Column& c, float* dst, const float (&v)[L]) {
  if (!c.owns) return;
#pragma unroll
  for (int k = 0; k < L; ++k) dst[(c.hb + k) * P + c.w] = v[k];
}

// The thread's registers from the slab: rows h0 .. h0 + L - 1 of its column.
template <int L, int P>
__device__ __forceinline__ void fill_registers(const Column& c, const float* p, float (&q)[L]) {
  if (!c.owns) return;
#pragma unroll
  for (int k = 0; k < L; ++k) q[k] = p[c.base + k * P];
}

// The registers of parity C; kept where k_lo <= k <= k_hi.
template <int L, int P, int C>
__device__ __forceinline__ void half_sweep(const LegArgs& a, const Column& c, float* p,
                                           const float* s, float (&q)[L], int k_lo, int k_hi) {
  float* at = p + c.base;
  const float* src = s + c.base;
#pragma unroll
  for (int k = C; k < L; k += 2) {
    const float below = (k == L - 1) ? at[(k + 1) * P] : q[k < L - 1 ? k + 1 : k];
    const float above = (k == 0) ? at[-P] : q[k > 0 ? k - 1 : k];
    const float v = scpn::rb_value(q[k], at[k * P + 1], at[k * P - 1], below, above, src[k * P],
                                   c.a_e, c.a_w, a.a_ns, a.inv_ac, a.omega);
    q[k] = (k >= k_lo && k <= k_hi) ? v : q[k];
    at[k * P] = q[k];
  }
}

// The first stage of the down leg and of the sweeps-only kernel: the
// thread's bands of psi and src into shared memory, the column's
// coefficients, and psi back into its registers with the skew.
template <int L, int P>
__device__ __forceinline__ void load_slab(const LegArgs& a, const Tile& t, Column& c,
                                          const float* __restrict__ psi,
                                          const float* __restrict__ src,
                                          const float* __restrict__ r, float* p, float* s,
                                          float (&q)[L]) {
  {
    float v[L];
    load_band<L>(a, t, c, psi, q);
    load_band<L>(a, t, c, src, v);
    set_coefficients(a, c, r);
    store_band<L, P>(c, p, q);
    store_band<L, P>(c, s, v);
  }
  __syncthreads();
  fill_registers<L, P>(c, p, q);
}

// n_sweeps red-black sweeps, each half-sweep over the core grown by what the
// half-sweeps after it (and `extra` more rings) still need.
template <int L, int P>
__device__ __forceinline__ void sweep_columns(const LegArgs& a, const Tile& t, const Column& c,
                                              float* p, const float* s, float (&q)[L],
                                              int extra) {
  const int n_half = 2 * a.n_sweeps;
  for (int half = 0; half < n_half; ++half) {
    const int g = n_half - 1 - half + extra;
    const int i_lo = max(1, t.z0 - g), i_hi = min(a.nz - 2, t.z1 - 1 + g);
    const int j_lo = max(1, t.c0 - g), j_hi = min(a.nr - 2, t.c1 - 1 + g);
    const int k_lo = (c.j >= j_lo && c.j <= j_hi) ? i_lo - c.i0 : L;
    const int k_hi = i_hi - c.i0;
    if (c.owns) {
      if (half & 1) {
        half_sweep<L, P, 1>(a, c, p, s, q, k_lo, k_hi);
      } else {
        half_sweep<L, P, 0>(a, c, p, s, q, k_lo, k_hi);
      }
    }
    __syncthreads();
  }
}

// One warp a core row.
template <int P>
__device__ __forceinline__ void store_core(const LegArgs& a, const Tile& t, const float* p,
                                           float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int i = t.z0 + warp; i < t.z1; i += n_warps) {
    const int at = (i - t.row0) * P - t.col0;
    for (int j = t.c0 + lane; j < t.c1; j += 32) out[i * a.nr + j] = p[at + j];
  }
}

#ifdef SCPN_PRE_KERNEL
template <int L, int P, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) SCPN_PRE_KERNEL(
    const LegArgs a, const float* __restrict__ psi, const float* __restrict__ src,
    const float* __restrict__ r, float* __restrict__ psi_out, float* __restrict__ d_c) {
  extern __shared__ float sm[];
  if (a.stages < 1) return;
  const Tile t = make_tile(a);
  float* p = sm + P;
  float* s = p + field_rows<L>(a) * P;
  Column c = make_column<L, P>(a, t);
  float q[L];
  load_slab<L, P>(a, t, c, psi, src, r, p, s, q);
  if (a.stages < 2) return;

  sweep_columns<L, P>(a, t, c, p, s, q, 2);
  if (a.stages < 3) return;

  // The defect of the columns of the core grown by 1, written over the
  // source: every register's, without a branch; zero off the global interior.
  if (c.owns && c.j >= t.c0 - 1 && c.j <= min(t.c1, a.nr - 1)) {
    const int k_lo = (c.j >= 1 && c.j <= a.nr - 2) ? 1 - c.i0 : L;
    const int k_hi = a.nz - 2 - c.i0;
    float* at = p + c.base;
    float* dst = s + c.base;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float below = (k == L - 1) ? at[(k + 1) * P] : q[k < L - 1 ? k + 1 : k];
      const float above = (k == 0) ? at[-P] : q[k > 0 ? k - 1 : k];
      const float d = scpn::defect_value(q[k], at[k * P + 1], at[k * P - 1], below, above,
                                         dst[k * P], c.a_e, c.a_w, a.a_ns, a.a_c);
      dst[k * P] = (k >= k_lo && k <= k_hi) ? d : 0.0f;
    }
  }
  if (a.stages < 4) return;
  // The core's stores drain while the coarse defect is formed.
  store_core<P>(a, t, p, psi_out);
  __syncthreads();
  if (a.stages < 5) return;

  // Coarse points of the core: fine rows and columns 2 * ic in [z0, z1).
  const int nzc = (a.nz + 1) / 2, nrc = (a.nr + 1) / 2;
  const int ic0 = t.z0 / 2, jc0 = t.c0 / 2;
  const int ic1 = (t.z1 + 1) / 2, jc1 = (t.c1 + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int ic = ic0 + warp; ic < ic1; ic += n_warps) {
    const bool row_in = ic >= 1 && ic <= nzc - 2;
    for (int jc = jc0 + lane; jc < jc1; jc += 32) {
      float out = 0.0f;
      if (row_in && jc >= 1 && jc <= nrc - 2) {
        const float* d = s + (2 * ic - t.row0) * P + 2 * jc - t.col0;
        out = scpn::full_weight([&](int di, int dj) { return d[di * P + dj]; });
      }
      d_c[ic * nrc + jc] = out;
    }
  }
}

template <int L, int P, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) SCPN_POST_KERNEL(
    const LegArgs a, const float* __restrict__ psi_s, const float* __restrict__ src,
    const float* __restrict__ e, const float* __restrict__ r, float* __restrict__ out) {
  extern __shared__ float sm[];
  if (a.stages < 1) return;
  const Tile t = make_tile(a);
  float* p = sm + P;
  float* s = p + field_rows<L>(a) * P;
  Column c = make_column<L, P>(a, t);
  float q[L];
  {
    float v[L];
    load_band<L>(a, t, c, src, v);
    store_band<L, P>(c, s, v);
  }
  load_band<L>(a, t, c, psi_s, q);

  // psi plus the prolonged error on the global interior.  The band starts on
  // an even global row ib (tile origin, halo and L are even), so row ib + k
  // lies between coarse rows ib / 2 + k / 2 and the next, and the parities of
  // slab indices are the global ones.  Coarse rows and columns are read from
  // global memory: two words a coarse row, L / 2 + 1 rows a thread.
  {
    const int nzc = (a.nz + 1) / 2, nrc = (a.nr + 1) / 2;
    const int ib = t.row0 + c.hb;
    const bool col_in = c.owns && c.j >= 1 && c.j <= a.nr - 2;
    const bool odd_j = c.j & 1;
    const float* at = e + (c.j >> 1);
    float e0[L / 2 + 1], e1[L / 2 + 1];
#pragma unroll
    for (int m = 0; m <= L / 2; ++m) {
      const int ic = ib / 2 + m;
      const bool in = col_in && ic >= 0 && ic < nzc;
      e0[m] = in ? at[ic * nrc] : 0.0f;
      e1[m] = (in && odd_j) ? at[ic * nrc + 1] : 0.0f;
    }
    const int k_lo = col_in ? 1 - ib : L;
    const int k_hi = a.nz - 2 - ib;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int m = k / 2;
      const float up = scpn::prolong_values(e0[m], e1[m], e0[m + (k & 1)], e1[m + (k & 1)],
                                            k & 1, odd_j);
      q[k] = (k >= k_lo && k <= k_hi) ? q[k] + up : q[k];
    }
  }
  set_coefficients(a, c, r);
  store_band<L, P>(c, p, q);
  __syncthreads();
  fill_registers<L, P>(c, p, q);
  if (a.stages < 2) return;

  sweep_columns<L, P>(a, t, c, p, s, q, 0);
  if (a.stages < 3) return;
  store_core<P>(a, t, p, out);
}
#endif  // SCPN_PRE_KERNEL

#ifdef SCPN_SWEEP_KERNEL
// n_sweeps red-black sweeps of psi into out: load, sweep, store the core.
template <int L, int P, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) SCPN_SWEEP_KERNEL(
    const LegArgs a, const float* __restrict__ psi, const float* __restrict__ src,
    const float* __restrict__ r, float* __restrict__ out) {
  extern __shared__ float sm[];
  if (a.stages < 1) return;
  const Tile t = make_tile(a);
  float* p = sm + P;
  float* s = p + field_rows<L>(a) * P;
  Column c = make_column<L, P>(a, t);
  float q[L];
  load_slab<L, P>(a, t, c, psi, src, r, p, s, q);
  if (a.stages < 2) return;

  sweep_columns<L, P>(a, t, c, p, s, q, 0);
  if (a.stages < 3) return;
  store_core<P>(a, t, p, out);
}
#endif  // SCPN_SWEEP_KERNEL

// Opt in to more than 48 KB of dynamic shared memory once per kernel and size.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = bytes;
  return 0;
}

struct Launch {
  LegArgs a;
  int threads;
  size_t smem;
  cudaStream_t stream;
  int* ctas_per_sm;   // not null: write the resident CTAs an SM there instead of launching
};

bool plan_ok(const Launch& l, int seg_len, int pitch, int max_threads, bool up) {
  const LegArgs& a = l.a;
  const int sh = a.th + 2 * a.halo, sw = a.tw + 2 * a.halo;
  const size_t words = 2 * static_cast<size_t>(a.n_seg * seg_len + 3) * pitch;
  const bool whole = a.th >= a.nz - 1 && a.tw >= a.nr - 1;   // one tile: any sweeps
  return a.nz >= 3 && a.nr >= 3 && a.th >= 2 && a.tw >= 2 && !(a.th & 1) && !(a.tw & 1) &&
         !(a.halo & 1) && a.n_sweeps >= 0 &&
         (whole || a.halo >= 2 * a.n_sweeps + (up ? 0 : 2)) && a.halo >= 2 && sw <= pitch &&
         a.n_seg * seg_len >= sh - 1 &&
         l.threads >= a.n_seg * sw && l.threads <= max_threads && l.threads % 32 == 0 &&
         l.smem >= words * sizeof(float);
}

template <typename Kernel, typename... Args>
int run(const Launch& l, Kernel kernel, size_t& allowed, Args... args) {
  const int err = allow_smem(kernel, l.smem, allowed);
  if (err != 0) return err;
  if (l.ctas_per_sm != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        l.ctas_per_sm, kernel, l.threads, l.smem));
  }
  const dim3 grid((l.a.nr - 1 + l.a.tw - 1) / l.a.tw, (l.a.nz - 1 + l.a.th - 1) / l.a.th);
  kernel<<<grid, l.threads, l.smem, l.stream>>>(l.a, args...);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SCPN_PRE_KERNEL
template <int L, int P, int MAXT, int MINB>
int run_pre(const Launch& l, const float* psi, const float* src, const float* r, float* psi_out,
            float* d_c) {
  static size_t allowed = 48 * 1024;
  if (!plan_ok(l, L, P, MAXT, false)) return static_cast<int>(cudaErrorInvalidValue);
  return run(l, SCPN_PRE_KERNEL<L, P, MAXT, MINB>, allowed, psi, src, r, psi_out, d_c);
}

template <int L, int P, int MAXT, int MINB>
int run_post(const Launch& l, const float* psi_s, const float* src, const float* e,
             const float* r, float* out) {
  static size_t allowed = 48 * 1024;
  if (!plan_ok(l, L, P, MAXT, true)) return static_cast<int>(cudaErrorInvalidValue);
  return run(l, SCPN_POST_KERNEL<L, P, MAXT, MINB>, allowed, psi_s, src, e, r, out);
}

int dispatch_pre(int variant, const Launch& l, const float* psi, const float* src,
                 const float* r, float* psi_out, float* d_c) {
  SCPN_LEG_VARIANTS(run_pre, l, psi, src, r, psi_out, d_c)
}

int dispatch_post(int variant, const Launch& l, const float* psi_s, const float* src,
                  const float* e, const float* r, float* out) {
  SCPN_LEG_VARIANTS(run_post, l, psi_s, src, e, r, out)
}
#endif  // SCPN_PRE_KERNEL

#ifdef SCPN_SWEEP_KERNEL
template <int L, int P, int MAXT, int MINB>
int run_sweep(const Launch& l, const float* psi, const float* src, const float* r, float* out) {
  static size_t allowed = 48 * 1024;
  if (!plan_ok(l, L, P, MAXT, true)) return static_cast<int>(cudaErrorInvalidValue);
  return run(l, SCPN_SWEEP_KERNEL<L, P, MAXT, MINB>, allowed, psi, src, r, out);
}

int dispatch_sweep(int variant, const Launch& l, const float* psi, const float* src,
                   const float* r, float* out) {
  SCPN_LEG_VARIANTS(run_sweep, l, psi, src, r, out)
}
#endif  // SCPN_SWEEP_KERNEL

// `plan` points at eleven ints: nz, nr, tile rows, tile columns, halo, sweeps,
// bands, variant, threads, shared-memory bytes, stages (the launch plan of
// ops/cuda_mg_tiled.TiledLaunchPlan.as_ints).
Launch make_launch(const int* plan, int r_stride, float inv_dr2, float dr, float a_ns, float a_c,
                   float inv_ac, float omega, void* stream, int* ctas_per_sm) {
  Launch l;
  l.a = LegArgs{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], r_stride, plan[10],
                inv_dr2, dr, a_ns, a_c, inv_ac, omega};
  l.threads = plan[8];
  l.smem = static_cast<size_t>(plan[9]);
  l.stream = static_cast<cudaStream_t>(stream);
  l.ctas_per_sm = ctas_per_sm;
  return l;
}

// What a source's C entries forward to: one launch of the down leg, of the up
// leg or of the sweeps-only kernel, and (leg 0 down, 1 up, 2 sweeps) the CTAs
// of the plan's kernel that one SM holds at once, written to *ctas_per_sm.
// Each returns the CUDA error (a refused plan: invalid value).
#ifdef SCPN_PRE_KERNEL
int entry_pre(const void* psi, const void* src, const void* r, int r_stride, const void* plan,
              float inv_dr2, float dr, float a_ns, float a_c, float inv_ac, float omega,
              void* psi_out, void* d_c, void* stream) {
  const int* pl = static_cast<const int*>(plan);
  const Launch l = make_launch(pl, r_stride, inv_dr2, dr, a_ns, a_c, inv_ac, omega, stream, nullptr);
  return dispatch_pre(pl[7], l, static_cast<const float*>(psi), static_cast<const float*>(src),
                      static_cast<const float*>(r), static_cast<float*>(psi_out),
                      static_cast<float*>(d_c));
}

int entry_post(const void* psi_s, const void* src, const void* e, const void* r, int r_stride,
               const void* plan, float inv_dr2, float dr, float a_ns, float inv_ac, float omega,
               void* out, void* stream) {
  const int* pl = static_cast<const int*>(plan);
  const Launch l = make_launch(pl, r_stride, inv_dr2, dr, a_ns, 0.0f, inv_ac, omega, stream, nullptr);
  return dispatch_post(pl[7], l, static_cast<const float*>(psi_s),
                       static_cast<const float*>(src), static_cast<const float*>(e),
                       static_cast<const float*>(r), static_cast<float*>(out));
}

#endif  // SCPN_PRE_KERNEL

#ifdef SCPN_SWEEP_KERNEL
int entry_sweep(const void* psi, const void* src, const void* r, int r_stride, const void* plan,
                float inv_dr2, float dr, float a_ns, float inv_ac, float omega, void* out,
                void* stream) {
  const int* pl = static_cast<const int*>(plan);
  const Launch l = make_launch(pl, r_stride, inv_dr2, dr, a_ns, 0.0f, inv_ac, omega, stream, nullptr);
  return dispatch_sweep(pl[7], l, static_cast<const float*>(psi), static_cast<const float*>(src),
                        static_cast<const float*>(r), static_cast<float*>(out));
}
#endif  // SCPN_SWEEP_KERNEL

int entry_ctas_per_sm(int leg, const void* plan, int* ctas_per_sm) {
  const int* pl = static_cast<const int*>(plan);
  const Launch l =
      make_launch(pl, 1, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, nullptr, ctas_per_sm);
  switch (leg) {
#ifdef SCPN_PRE_KERNEL
    case 0: return dispatch_pre(pl[7], l, nullptr, nullptr, nullptr, nullptr, nullptr);
    case 1: return dispatch_post(pl[7], l, nullptr, nullptr, nullptr, nullptr, nullptr);
#endif
#ifdef SCPN_SWEEP_KERNEL
    case 2: return dispatch_sweep(pl[7], l, nullptr, nullptr, nullptr, nullptr);
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
