// The interior of the blocked sharded 2D year of the py_driver_2d iage
// family -- every shard of one card, all blocks of k steps, in one
// persistent cooperative launch -- on NVIDIA Hopper (sm_90a): kernel B3.
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::_block_callable
// (imex_pallas.py:687), the per-shard compute of the sharded 2D year
// (parallel/sharded_year.py::build_sharded_year_blocked).  It computes the
// same function: the interior steps [Heun(dt); CN(dt)] of the Strang-split
// year, whose half steps merge, on C channels of nz levels, with step g at
// t = t_block[g / k] + (g % k) dt in float32 (k: the year's block length,
// two roundings, no fused multiply-add: an ulp in t moves kv by ~1e3 ulps),
// each explicit increment and each CN increment Kahan-added to a float32
// state.  The TPU kernel steps one shard's window, closed at its edges, k
// steps between host halo exchanges of 2k columns a side; the columns a
// shard owns see the same operations on the same values as they would on
// an unbounded grid, since the closed edge's error travels two columns a
// step.  This kernel computes those owned values directly, so its year is
// bit-identical whatever the mesh and however it is laid out here.
//
// What bounds it on this card.  Per step a cell takes two lateral
// tendencies, a Heun add and a float64 CN column solve, some 70 operations:
// the bench's 256 x 2000 year moves 8 MB and does about 1.2e12 operations,
// a bound of 17.5 ms.  The work is a chain of dependent phases a step -- the
// tendency twice, kv, a 256-deep float64 tridiagonal solve -- so the kernel
// is bound by latency: by how many independent chains each SM holds and by
// the synchronisation between phases.  The design before this one (a launch
// of one block per tile for every 1-8 steps, every constant re-staged into
// shared memory at each launch, one thread a column running a 256-deep
// float64 Thomas chain while the block waited, two waves at 256 levels, a
// host torch.cat of halos and a ctypes call per shard and block) took
// 158 us a step at 256 x 2000 and left the device idle 87.5% of a 4-shard
// spin-up year.
//
// Design.
//   * One launch for every shard of a card and the year's whole interior.
//     The slabs (a shard's owned columns; see below for the others) and
//     their tiles are tables in device memory, uploaded once a built
//     year.  Each CUDA block owns one tile -- one channel, `tile` owned
//     columns, all nz levels -- for the whole launch, its state and Kahan
//     carry resident in shared memory.  Every j_int steps (an interval) the
//     blocks publish the 2 j_int columns at each edge of their tile to the
//     slab's state buffer in device memory (stores and loads through L2
//     only, __stcg / __ldcg: other blocks wrote it), a grid-wide barrier
//     (cooperative_groups::this_grid().sync()) follows, and each block
//     reads 2 j_int halo columns a side from its neighbours -- its own
//     slab's, or the neighbouring shard's.  Within an interval the halo
//     erodes two columns a step, and the phases compute only the columns
//     still exact.  The grid is every tile at once (the wrapper sizes tiles
//     so: ops/imex_block_cuda.py::block_plan), so a year that cannot be
//     laid out so is refused there, never run another way.
//   * Shards on different devices: each device's shards are one launch of
//     one block of k steps, with a ghost slab of 2k columns beside each
//     shard whose neighbour lies on another device.  The host copies the
//     neighbour's edge columns into it before the launch; the kernel steps
//     it like any slab, closed at its outer edge, whose error reaches the
//     shard's halo only after k steps.
//   * The CN column solve in float64 on a warp a column: each lane takes
//     M = nz / 32 (rounded up to a power of two) consecutive levels,
//     eliminates its first M - 1 in registers as affine functions of the
//     two interface values around them (a partitioned Thomas), and the 32
//     interface equations are solved by parallel cyclic reduction across
//     the warp's lanes (shuffles).  Right-hand side, elimination and
//     substitution are float64; the increment is rounded once to float32
//     for the Kahan add.  At 256 levels the mixed layer's CN system has
//     h |M| ~ 6e3, and a float32 solve loses that many ulps of a rough
//     state's slow modes a step (ROADMAP C).  kv is formed on the fly for
//     each lane's levels.
//   * Shared memory holds y, the carry, f1 and the stage state of the
//     tile and its halo (16 bytes a cell, rows of an odd pitch) and the
//     by-level and by-column constants; f1 and the stage state double as
//     the warps' column buffers in the CN solve, which read each column
//     down its levels without bank conflicts.  The face coefficients, wv
//     and the implicit diagonal are read through the cache (they are
//     read-only).  At 256 levels a block holds 55 columns, so the bench's
//     two channels of 2000 columns take 130 tiles of 31 owned columns, one
//     wave on 132 SMs, exchanging halos every 6 steps.
//
// Where its time goes (cli/profile_phases.py on an H100, 700 W): about
// 50 us a step at 256 x 2000, 60% of it the CN solve (a warp's 256-level
// column is some 19k cycles, 8 levels a lane with 128 registers and
// spills), 27% the two explicit stages, 12% the grid barrier and the wait
// for the slowest tile; at 24 levels (the sharded spin-up) 5.5 us a step,
// again 60% the CN solve.
//
// The constants arrive lane-packed as pack_block_consts lays them out for
// the TPU: per shard window of nx columns, (rows, C nx) with channel ch's
// window column x at lane ch nx + x; the state as (C, nz, w) a slab.

#include <cooperative_groups.h>

#include "imex_common.cuh"

namespace {

using namespace imex;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// one slab of a launch: a shard's owned columns, or a ghost slab
struct Slab {
  float* y[2];  // (C, nz, w) state, two buffers
  float* c[2];  // its Kahan carry
  // the lane-packed constants of the shard's window (pack_block_consts)
  const float *ca, *cb, *wv, *diag, *src, *bld_max, *dy_r;
  int w;         // columns
  int xoff;      // window column of the slab's column 0
  int nx;        // window columns (lanes a channel)
  int left;      // slab index of the left neighbour, -1: closed
  int right;     // of the right neighbour
  int src_rows;  // 1 (uniform rates) or nz (depth profiles)
};

struct Launch {
  const Slab* slabs;
  const int4* tiles;  // (slab, channel, x0, x1): one a block
  const float *dz_r, *dz_mid, *dz_mid_r, *depth_mid, *header, *t_block;
  int c_dim, nz, width_max, k_block, j_int, g0, n_steps, in_buf;
  float dt;
};

// levels a lane takes: the least power of two M with 32 M >= nz
__host__ __device__ inline int lane_levels(int nz) {
  int m = 1;
  while (32 * m < nz) m *= 2;
  return m;
}

// the row pitch of a region `width` columns wide: odd, so that a warp
// reading one column down the levels touches every bank once
__host__ __device__ inline int pitch_of(int width) { return width | 1; }

// a warp's column buffer in the CN solve: level i at i + i / M, so that the
// lanes' blocks of M levels are an odd stride (M + 1) apart
__host__ __device__ inline int col_floats(int nz) {
  const int m = lane_levels(nz);
  return 32 * (m > 1 ? m + 1 : 1);
}

__host__ __device__ inline long area_floats(int nz, int width) {
  return (long)nz * pitch_of(width);
}

__host__ __device__ inline long smem_floats(int nz, int width) {
  // y, comp (nz, pitch); f1, ys (nz, pitch), which the CN solve reuses
  // as the warps' column buffers; dy_r, bld_max (width); dz_r, depth_mid,
  // src (nz); dz_mid, dz_mid_r (nz - 1)
  const long area = area_floats(nz, width);
  const long cols = (long)kWarps * col_floats(nz);
  return 2L * area + (2L * area > cols ? 2L * area : cols) + 2L * width +
         3L * nz + 2L * (nz - 1);
}

// the explicit tendency at region cell (k, j) of y (nz, L; row pitch P): fused lateral
// flux (csrc/imex_common.cuh::transport_tend's arithmetic, the face
// coefficients read from the packed window at lane lane_j), vertical
// advection, source; closed at the region's edges
__device__ inline float tend_at(const float* y, int idx, int k, int j, int nz,
                                int L, int P, float src, float dy_r, float dz_r,
                                const float* __restrict__ ca,
                                const float* __restrict__ cb,
                                const float* __restrict__ wv, long w_dim,
                                long lane_j) {
  const float yc = y[idx];
  const long f = k * (w_dim - 1) + lane_j;  // the (j | j+1) face
  float gl = 0.0f, gr = 0.0f;
  if (j > 0) gl = __ldg(ca + f - 1) * y[idx - 1] + __ldg(cb + f - 1) * yc;
  if (j < L - 1) gr = __ldg(ca + f) * yc + __ldg(cb + f) * y[idx + 1];
  float res = dy_r * (gl - gr);
  float wa = 0.0f, wb = 0.0f;
  if (k > 0) wa = 0.5f * (yc + y[idx - P]) * __ldg(wv + (k - 1) * w_dim + lane_j);
  if (k < nz - 1) wb = 0.5f * (y[idx + P] + yc) * __ldg(wv + k * w_dim + lane_j);
  res = res + dz_r * (wb - wa);
  return res + src;
}

// The CN increment over h of region column j, Kahan-added into y and comp,
// on one warp: solve (I - h/2 M) dv = h M y, M = Lz(kv) + diag, in float64.
// Lane p holds levels p M .. p M + M - 1 (identity rows past nz); its first
// M - 1 levels are eliminated as x = G + U E_{p-1} + V E_p in the interface
// values E (each lane's last level), whose 32 equations PCR solves.
template <int M>
__device__ inline void cn_column_warp(float* y, float* comp, float* col,
                                      int j, int P, int nz, float h,
                                      float frac,
                                      const Header& hd, const float* dz_r,
                                      const float* depth_mid,
                                      const float* dz_mid,
                                      const float* dz_mid_r, float bld_max,
                                      const float* __restrict__ wv,
                                      const float* __restrict__ diag,
                                      long w_dim, long lane_j) {
  const int lane = threadIdx.x & 31;
  const int i0 = lane * M;
  const double hh = h, half = 0.5 * hh;
  // the column into the warp's buffer, read down the levels (an odd pitch:
  // no bank conflicts), where each lane's levels are an odd stride apart
  auto cix = [](int i) { return M > 1 ? i + i / M : i; };
  for (int i = lane; i < nz; i += 32) col[cix(i)] = y[i * P + j];
  __syncwarp();
  // kv of the edge below each of the lane's levels (0 at and past the
  // bottom), and of the edge above its first
  float kv[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int i = i0 + r;
    kv[r] = i < nz - 1
                ? kv_value(i, bld_max, __ldg(wv + i * w_dim + lane_j), frac,
                           hd, depth_mid, dz_mid, dz_mid_r)
                : 0.0f;
  }
  float kv_top = __shfl_up_sync(kFull, kv[M - 1], 1);
  if (lane == 0) kv_top = 0.0f;

  // row r's (a, b, c, d): cn_column's flux-form right-hand side
  auto row = [&](int r, double& a, double& b, double& c, double& d) {
    const int i = i0 + r;
    if (i >= nz) {
      a = 0.0, b = 1.0, c = 0.0, d = 0.0;
      return;
    }
    const double kv_up = kv[r];
    const double kv_lo = r > 0 ? kv[r - 1] : kv_top;
    const double dzr = dz_r[i];
    const double yk = col[cix(i)];
    const double flux_dn = i < nz - 1 ? kv_up * ((double)col[cix(i + 1)] - yk) : 0.0;
    const double flux_up = i > 0 ? kv_lo * (yk - (double)col[cix(i - 1)]) : 0.0;
    const double du = kv_up * dzr, dl = kv_lo * dzr;
    const double dg = __ldg(diag + i * w_dim + lane_j);
    const double dmain = -(du + dl) + dg;
    d = hh * (dzr * (flux_dn - flux_up) + dg * yk);
    a = -half * dl;
    b = 1.0 - half * dmain;
    c = -half * du;
  };

  // eliminate levels 0 .. M-2 of the lane: G, U, V hold, per level, the
  // constant and the weights of E_{p-1} and E_p
  double G[M], U[M], V[M];
  double a, b, c, d;
  if constexpr (M > 1) {
    double cp = 0.0, g = 0.0, u = 1.0;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      row(r, a, b, c, d);
      const double inv = 1.0 / (b - a * cp);
      cp = c * inv;
      g = (d - a * g) * inv;
      u = -a * u * inv;
      G[r] = g;
      U[r] = u;
      V[r] = cp;  // the sweep factor until the back substitution
    }
    V[M - 2] = -V[M - 2];
#pragma unroll
    for (int r = M - 3; r >= 0; --r) {
      const double f = V[r];
      G[r] = G[r] - f * G[r + 1];
      U[r] = U[r] - f * U[r + 1];
      V[r] = -f * V[r + 1];
    }
  }
  // the lane's interface equation A E_{p-1} + B E_p + C E_{p+1} = D
  row(M - 1, a, b, c, d);
  double A, B, C, D;
  if constexpr (M > 1) {
    const double g1 = __shfl_down_sync(kFull, G[0], 1);
    const double u1 = __shfl_down_sync(kFull, U[0], 1);
    const double v1 = __shfl_down_sync(kFull, V[0], 1);
    const bool next = lane < 31;
    A = a * U[M - 2];
    B = b + a * V[M - 2] + (next ? c * u1 : 0.0);
    C = next ? c * v1 : 0.0;
    D = d - a * G[M - 2] - (next ? c * g1 : 0.0);
  } else {
    A = a, B = b, C = c, D = d;
  }
  // PCR across the warp, one reciprocal a round (lanes out of range act
  // as identity rows)
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const double rb = 1.0 / B;
    const double am = __shfl_up_sync(kFull, A, s);
    const double cm = __shfl_up_sync(kFull, C, s);
    const double dm = __shfl_up_sync(kFull, D, s);
    const double rbm = __shfl_up_sync(kFull, rb, s);
    const double ap = __shfl_down_sync(kFull, A, s);
    const double cq = __shfl_down_sync(kFull, C, s);
    const double dq = __shfl_down_sync(kFull, D, s);
    const double rbp = __shfl_down_sync(kFull, rb, s);
    const bool lo = lane >= s, hi = lane + s < 32;
    const double alpha = lo ? -A * rbm : 0.0;
    const double gamma = hi ? -C * rbp : 0.0;
    B = B + (lo ? alpha * cm : 0.0) + (hi ? gamma * ap : 0.0);
    D = D + (lo ? alpha * dm : 0.0) + (hi ? gamma * dq : 0.0);
    A = lo ? alpha * am : 0.0;
    C = hi ? gamma * cq : 0.0;
  }
  const double e = D / B;
  double e_prev = __shfl_up_sync(kFull, e, 1);
  if (lane == 0) e_prev = 0.0;
  __syncwarp();  // every lane has read the column for its right-hand sides
  // the increments, rounded once, into the buffer; then Kahan-added down
  // the levels
#pragma unroll
  for (int r = 0; r < M - 1; ++r) {
    const int i = i0 + r;
    if (i < nz) col[cix(i)] = (float)(G[r] + U[r] * e_prev + V[r] * e);
  }
  if (i0 + M - 1 < nz) col[cix(i0 + M - 1)] = (float)e;
  __syncwarp();
  for (int i = lane; i < nz; i += 32) kahan_add(y, comp, i * P + j, col[cix(i)]);
  __syncwarp();  // the buffer is free for the warp's next column
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1) iage_block_kernel(Launch p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int4 tl = p.tiles[blockIdx.x];
  const Slab& sl = p.slabs[tl.x];
  const int ch = tl.y, x0 = tl.z, x1 = tl.w;
  const int nz = p.nz, J = p.j_int;
  // the slab's fields in registers: they are read in every phase
  const int w = sl.w;
  const float *ca = sl.ca, *cb = sl.cb, *wv = sl.wv, *diag = sl.diag;
  const Slab* left = sl.left >= 0 ? p.slabs + sl.left : nullptr;
  const Slab* right = sl.right >= 0 ? p.slabs + sl.right : nullptr;
  // the tile's region [lo, hi) in slab columns: 2 J halo columns a side,
  // cut at a closed slab edge; an edge of the region that is not closed
  // erodes (its error travels two columns a step)
  const int lo = left != nullptr ? x0 - 2 * J : max(0, x0 - 2 * J);
  const int hi = right != nullptr ? x1 + 2 * J : min(w, x1 + 2 * J);
  const bool l_open = lo != 0 || left != nullptr;
  const bool r_open = hi != w || right != nullptr;
  const int L = hi - lo, P = pitch_of(L);
  const int own0 = x0 - lo, own1 = x1 - lo;  // owned, region columns
  const long w_dim = (long)p.c_dim * sl.nx;
  const long lane0 = (long)ch * sl.nx + sl.xoff + lo;  // region column 0
  const Header hd = load_header(p.header);

  const long area = area_floats(nz, p.width_max);
  const long cols = (long)kWarps * col_floats(nz);
  float* y = smem;
  float* comp = y + area;
  float* f1 = comp + area;
  float* ys = f1 + area;
  float* col = f1 + (threadIdx.x >> 5) * col_floats(nz);  // CN only
  float* dy_r = f1 + (2 * area > cols ? 2 * area : cols);
  float* bld = dy_r + p.width_max;
  float* dz_r = bld + p.width_max;
  float* depth_mid = dz_r + nz;
  float* src = depth_mid + nz;
  float* dz_mid = src + nz;
  float* dz_mid_r = dz_mid + (nz - 1);

  for (int j = threadIdx.x; j < L; j += kThreads) {
    dy_r[j] = __ldg(sl.dy_r + lane0 + j);
    bld[j] = __ldg(sl.bld_max + lane0 + j);
  }
  for (int k = threadIdx.x; k < nz; k += kThreads) {
    dz_r[k] = __ldg(p.dz_r + k);
    depth_mid[k] = __ldg(p.depth_mid + k);
    // the source is uniform over a channel's lanes: take its first
    src[k] = __ldg(sl.src + (sl.src_rows > 1 ? k : 0) * w_dim + (long)ch * sl.nx);
    if (k < nz - 1) {
      dz_mid[k] = __ldg(p.dz_mid + k);
      dz_mid_r[k] = __ldg(p.dz_mid_r + k);
    }
  }

  // region columns [ja, jb) of y and comp from buffer `buf` of the slab
  // that holds each (written by other blocks: through L2)
  auto load = [&](int ja, int jb, int buf) {
    const int width = jb - ja;
    const float *ys0 = sl.y[buf], *cs0 = sl.c[buf];
    const float *yl = nullptr, *cl = nullptr, *yr = nullptr, *cr = nullptr;
    int wl = 0, wr = 0;
    if (left != nullptr) yl = left->y[buf], cl = left->c[buf], wl = left->w;
    if (right != nullptr) yr = right->y[buf], cr = right->c[buf], wr = right->w;
#pragma unroll 4
    for (int i = threadIdx.x; i < nz * width; i += kThreads) {
      const int k = i / width;
      const int j = ja + (i - k * width);
      const int x = lo + j;
      const float *ysrc = ys0, *csrc = cs0;
      long gi = ((long)ch * nz + k) * w + x;
      if (x < 0) {
        ysrc = yl, csrc = cl;
        gi = ((long)ch * nz + k) * wl + x + wl;
      } else if (x >= w) {
        ysrc = yr, csrc = cr;
        gi = ((long)ch * nz + k) * wr + x - w;
      }
      y[k * P + j] = __ldcg(ysrc + gi);
      comp[k * P + j] = __ldcg(csrc + gi);
    }
  };

  const float dt = p.dt, half_dt = 0.5f * dt;
  const int el = l_open ? 2 : 0, er = r_open ? 2 : 0;
  const int warp = threadIdx.x >> 5;
  const int n_int = (p.n_steps + J - 1) / J;
  load(own0, own1, p.in_buf);
  int g = p.g0;
  for (int it = 0; it < n_int; ++it) {
    const int buf = (p.in_buf + it) & 1;
    load(0, own0, buf);
    load(own1, L, buf);
    __syncthreads();
    const int steps = min(J, p.g0 + p.n_steps - g);
    for (int s = 0; s < steps; ++s, ++g) {
      const float t = __fadd_rn(p.t_block[g / p.k_block],
                                __fmul_rn((float)(g % p.k_block), dt));
      // the columns still exact: stage 1 one in from them, stage 2, the
      // Heun add and CN two in, on each side that erodes
      const int a1 = el * s + el / 2, b1 = L - er * s - er / 2;
      const int a2 = el * (s + 1), b2 = L - er * (s + 1);
      int width = b1 - a1;
      for (int i = threadIdx.x; i < nz * width; i += kThreads) {
        const int k = i / width;
        const int j = a1 + (i - k * width);
        const int idx = k * P + j;
        const float f = tend_at(y, idx, k, j, nz, L, P, src[k], dy_r[j], dz_r[k],
                                ca, cb, wv, w_dim, lane0 + j);
        f1[idx] = f;
        ys[idx] = y[idx] + dt * f;
      }
      __syncthreads();
      width = b2 - a2;
      for (int i = threadIdx.x; i < nz * width; i += kThreads) {
        const int k = i / width;
        const int j = a2 + (i - k * width);
        const int idx = k * P + j;
        const float f2 = tend_at(ys, idx, k, j, nz, L, P, src[k], dy_r[j],
                                 dz_r[k], ca, cb, wv, w_dim, lane0 + j);
        kahan_add(y, comp, idx, half_dt * (f1[idx] + f2));
      }
      __syncthreads();
      const float frac = piecewise_frac(__fadd_rn(t, dt), hd);
      for (int j = a2 + warp; j < b2; j += kWarps)
        cn_column_warp<M>(y, comp, col, j, P, nz, dt, frac, hd, dz_r, depth_mid,
                          dz_mid, dz_mid_r, bld[j], wv, diag, w_dim,
                          lane0 + j);
      __syncthreads();
    }
    // publish the tile's edge columns for the neighbours' next halo, all
    // of its columns after the last interval
    const int out = (buf + 1) & 1;
    const bool last = it == n_int - 1;
    const int owned = x1 - x0;
    float *y_out = sl.y[out], *c_out = sl.c[out];
    for (int i = threadIdx.x; i < nz * owned; i += kThreads) {
      const int k = i / owned;
      const int xo = i - k * owned;
      if (!last && xo >= 2 * J && xo < owned - 2 * J) continue;
      const long gi = ((long)ch * nz + k) * w + x0 + xo;
      const int li = k * P + own0 + xo;
      __stcg(y_out + gi, y[li]);
      __stcg(c_out + gi, comp[li]);
    }
    if (!last) grid.sync();
  }
}

template <int M>
const void* kernel_for() {
  return (const void*)iage_block_kernel<M>;
}

const void* kernel_of(int nz) {
  switch (lane_levels(nz)) {
    case 1: return kernel_for<1>();
    case 2: return kernel_for<2>();
    case 4: return kernel_for<4>();
    case 8: return kernel_for<8>();
    case 16: return kernel_for<16>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// the most levels a column may have (16 a lane)
int iage_block_max_levels() { return 32 * 16; }

// shared memory of one block whose region is `width` columns of nz levels
long iage_block_smem_bytes(int nz, int width) {
  return smem_floats(nz, width) * (long)sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int iage_block_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* iage_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// blocks of the kernel for nz levels that fit on one SM at once with
// `smem` bytes of dynamic shared memory, into *out
int iage_block_occupancy(int nz, long smem, int* out) {
  const void* fn = kernel_of(nz);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                            (size_t)smem);
}

// bytes of one slab descriptor
int iage_block_slab_bytes() { return (int)sizeof(Slab); }

// n slab descriptors into `out` (host, n iage_block_slab_bytes()): per slab
// ptrs[11 q ...] y0, y1, c0, c1, ca, cb, wv, diag, src, bld_max, dy_r and
// ints[6 q ...] w, xoff, nx, left, right, src_rows
void iage_block_pack_slabs(void* const* ptrs, const int* ints, int n,
                           void* out) {
  Slab* slabs = static_cast<Slab*>(out);
  for (int q = 0; q < n; ++q) {
    void* const* pp = ptrs + 11 * q;
    const int* ii = ints + 6 * q;
    Slab& s = slabs[q];
    s.y[0] = static_cast<float*>(pp[0]);
    s.y[1] = static_cast<float*>(pp[1]);
    s.c[0] = static_cast<float*>(pp[2]);
    s.c[1] = static_cast<float*>(pp[3]);
    s.ca = static_cast<const float*>(pp[4]);
    s.cb = static_cast<const float*>(pp[5]);
    s.wv = static_cast<const float*>(pp[6]);
    s.diag = static_cast<const float*>(pp[7]);
    s.src = static_cast<const float*>(pp[8]);
    s.bld_max = static_cast<const float*>(pp[9]);
    s.dy_r = static_cast<const float*>(pp[10]);
    s.w = ii[0];
    s.xoff = ii[1];
    s.nx = ii[2];
    s.left = ii[3];
    s.right = ii[4];
    s.src_rows = ii[5];
  }
}

// One cooperative launch of n_tiles blocks on `stream` (a cudaStream_t) of
// the current device: steps g0 .. g0 + n_steps - 1 of every slab (device
// descriptors `slabs`, tiles (slab, channel, x0, x1) int4 `tiles`),
// exchanging halos every j_int steps; each slab's state is read from its
// buffer in_buf and ends in buffer (in_buf + ceil(n_steps / j_int)) % 2.
// width_max: the widest tile region (smem sizing).  t_block: the float32
// start time of each block of k_block steps.  Returns the launch's CUDA
// error or 0; grids over the card's co-resident blocks are refused by
// CUDA (cudaErrorCooperativeLaunchTooLarge).
int iage_block_launch(const void* slabs, const void* tiles, int n_tiles,
                      const float* dz_r, const float* dz_mid,
                      const float* dz_mid_r, const float* depth_mid,
                      const float* header, const float* t_block, int c_dim,
                      int nz, int width_max, int k_block, int j_int, int g0,
                      int n_steps, int in_buf, float dt, void* stream) {
  const void* fn = kernel_of(nz);
  if (fn == nullptr || n_tiles < 1 || j_int < 1 || n_steps < 1)
    return (int)cudaErrorInvalidValue;
  Launch p;
  p.slabs = static_cast<const Slab*>(slabs);
  p.tiles = static_cast<const int4*>(tiles);
  p.dz_r = dz_r;
  p.dz_mid = dz_mid;
  p.dz_mid_r = dz_mid_r;
  p.depth_mid = depth_mid;
  p.header = header;
  p.t_block = t_block;
  p.c_dim = c_dim;
  p.nz = nz;
  p.width_max = width_max;
  p.k_block = k_block;
  p.j_int = j_int;
  p.g0 = g0;
  p.n_steps = n_steps;
  p.in_buf = in_buf;
  p.dt = dt;
  const long smem = iage_block_smem_bytes(nz, width_max);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(n_tiles), dim3(kThreads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
