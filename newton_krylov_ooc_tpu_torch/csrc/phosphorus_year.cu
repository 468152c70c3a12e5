// One model year of the py_driver_2d phosphorus module (po4, dop, pop: a
// coupled, nonlinear 3-tracer 2D year), the whole year in one kernel launch,
// on NVIDIA Hopper (sm_90a).
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::
// build_phosphorus_year_pallas.  The scheme is ops/imex.py's, step for step:
// CNh [Heun CNf] x (n-1) Heun CNh (Strang splitting with the interior
// half-steps merged).  Crank-Nicolson vertical mixing in increment form with
// a flux-form right-hand side on each tracer (no implicit diagonal); lateral
// advection + diffusion as the fused face flux ca*y_l + cb*y_r and vertical
// advection (a five-point stencil a cell, shared by the three tracers); and,
// explicit in the Heun half, Michaelis-Menten uptake mu L po4 / (po4 + K)
// into dop and pop, DOP and POP remineralisation back to po4, and POP
// sinking with a zero-flux bottom.  Every increment is Kahan-accumulated in
// float32.
//
// What bounds it on this card: latency per step, not bytes or flops: 8760
// dependent steps of 6,000 cells.  The first design (one block, the year in
// shared memory, three barriers a step) spent each step recomputing kv(t),
// which depends on t alone, running each column's Thomas chain serially on
// one thread with two IEEE divisions a level, and loading every operand from
// shared memory (cli/profile_phases.py).  This design is B1's
// (csrc/iage_year.cu):
//
//   * The table: B2's CN matrix is B1's with a zero implicit diagonal and
//     one channel, so ops/imex_cuda.py::build_iage_table(grid, zeros (1, nz,
//     ny), ...) is B2's table -- kv and the Thomas factors m, w, cp of each
//     of the year's n_steps + 1 solves.  One set of factors serves the three
//     tracers.  A producer warp streams each solve's slice a step ahead into
//     one of two shared-memory slots with cp.async.bulk, an mbarrier a slot
//     (csrc/imex_table.cuh).
//   * Lanes own cells: a group of G lanes owns column j, lane l its M levels
//     l M .. l M + M - 1 of all three tracers, in registers: the state, its
//     Kahan compensation, the stage-1 tendency and stage state, the
//     five-point stencil, mu L and 1 / dz.  Vertical neighbours come by
//     shuffles -- pop at k - 1 for sinking too: what leaves row k - 1 is the
//     float sink_vel * pop(k - 1) that enters row k, so phosphorus stays
//     conserved.  The lateral ones come through shared memory, where y and
//     the stage state are published.
//   * The columns are split over a cluster of kCtas thread blocks on
//     neighbouring SMs, each owning a contiguous run of columns.  With 3
//     tracers a lane holds twice B1's registers: four blocks of at most 256
//     threads give each thread up to 255, and at M <= 4 levels a lane
//     nothing spills (two blocks of 448 threads, 128 registers, and one of
//     864, 72, spilled and took 1.7x the time).  A block pushes its first
//     and last columns into its neighbours' copies of the published fields
//     (distributed shared memory) as it publishes them, so that every
//     lateral read is local.
//   * Two cluster barriers a step, each split: after Heun stage 1 (stage 2
//     reads the stage state at j +- 1) and after the CN solve (the next
//     stage 1 reads y at j +- 1).  Between arriving and waiting a lane
//     computes the next stage's terms that need its column alone (the
//     stencil's centre and vertical neighbours, the local terms); the
//     lateral terms follow the wait.  Stage 2's Kahan add and column j's CN
//     solve stay in column j's lanes.
//   * The CN chain: r' = h (flux-form rhs) w for each tracer, then the
//     forward and back recurrences as affine-map scans (B1's): each lane
//     composes its M levels, log2 G shuffle rounds give its carry.  The
//     multipliers (-m_k, -cp_k) are the tracers' own, so a lane composes
//     them once and scans three offsets.  No division on the chain.
//   * The uptake divides po4 by po4 + K and then multiplies by mu L, not mu
//     L po4 by po4 + K as the plain year does: mu L is zero or subnormal in
//     the deep levels (light underflows), and those quotients took the
//     division's slow path, 1.6x the year's time.
//
// Shared memory, counted by smem_floats alone (the wrapper checks it against
// the card's opt-in limit): two slots, and y and the stage state of the
// three tracers (3, nz, ny), each block writing its own columns and its
// neighbours' edge columns.

#include <cooperative_groups.h>

#include "imex_common.cuh"
#include "imex_table.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace imex;

constexpr int kCtas = 4;       // thread blocks of the cluster
constexpr int kThreads = 256;  // a block's threads at most: 13 columns of
                               // 16 lanes and the producer warp at 40 x 50
constexpr int kMaxLevels = 4;  // levels a lane owns at most (M): past 4
                               // the three tracers' registers spill
constexpr int kTracers = 3;    // po4, dop, pop
constexpr int kParams = 8;     // scalars between the header and the grid

// params: po4_halfsat, max_uptake_rate, sigma, 1 - sigma, dop_remin_rate,
// pop_remin_rate, pop_sink_vel, padding
struct Params {
  float halfsat, max_uptake, sigma, one_minus_sigma, dop_remin, pop_remin,
      sink_vel;
};

__device__ inline Params load_params(const float* base) {
  Params p;
  p.halfsat = base[0];
  p.max_uptake = base[1];
  p.sigma = base[2];
  p.one_minus_sigma = base[3];
  p.dop_remin = base[4];
  p.pop_remin = base[5];
  p.sink_vel = base[6];
  return p;
}

__host__ __device__ inline long smem_floats(int nz, int ny) {
  // two slots; y and the stage state of the three tracers, published for
  // the lateral stencil
  return 2 * slot_floats<false>(nz, ny) + 2L * kTracers * nz * ny;
}

// columns a block owns
__host__ __device__ inline int block_columns(int ny) {
  return (ny + kCtas - 1) / kCtas;
}

// the cluster's barrier in two halves: a thread arrives once its writes to
// shared memory (its block's and those pushed to its neighbours') are done,
// and waits before it reads what the others wrote; what it does between the
// two touches registers only
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (kCtas > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  if constexpr (kCtas == 1)
    __syncthreads();
  else
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the explicit tendency f of the lane's cells of all three tracers at the
// state v, in two parts.  column_terms needs the lane's column alone: the
// stencil's centre and vertical neighbours, then the local terms in the
// plain year's order (models/py_driver_2d/phosphorus.py::_add_local).
// lateral_terms adds the stencil's columns j -+ 1 from the published field
// v_sh (3, nz, ny).
template <int M>
__device__ __forceinline__ void column_terms(const float (&v)[kTracers][M],
                                             const Stencil (&st)[M],
                                             const float (&uc)[M],
                                             const float (&dzr)[M],
                                             const Params& p,
                                             float (&f)[kTracers][M], int k0,
                                             int nz, int lanes) {
  float pop_above[M];
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
    float above[M], below[M];
    column_neighbours(v[tr], above, below, lanes);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      f[tr][m] =
          st[m].c * v[tr][m] + st[m].n * above[m] + st[m].s * below[m];
      if (tr == kTracers - 1) pop_above[m] = above[m];
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    const float po4 = v[0][m], dop = v[1][m], pop = v[2][m];
    // mu L (po4 / (po4 + K)), see the note at the top; levels past nz
    // divide 1 by 1 + K, their mu L being 0
    const float num = k < nz ? po4 : 1.0f;
    const float uptake = uc[m] * (num / (num + p.halfsat));
    const float dop_remin = p.dop_remin * dop;
    const float pop_remin = p.pop_remin * pop;
    f[0][m] = f[0][m] - uptake + dop_remin + pop_remin;
    f[1][m] = f[1][m] + p.sigma * uptake - dop_remin;
    const float d_pop = f[2][m] + p.one_minus_sigma * uptake - pop_remin;
    // sinking: in from the level above, none out of the bottom level
    const float sink_in =
        (k > 0 && k < nz) ? p.sink_vel * pop_above[m] : 0.0f;
    const float sink_out = k < nz - 1 ? p.sink_vel * pop : 0.0f;
    f[2][m] = d_pop + dzr[m] * (sink_in - sink_out);
  }
}

template <int M>
__device__ __forceinline__ void lateral_terms(const float* v_sh,
                                              const Stencil (&st)[M],
                                              float (&f)[kTracers][M],
                                              int k0, int jw, int je, int nz,
                                              int ny) {
  const int n = nz * ny;
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int kc = min(k0 + m, nz - 1);
      f[tr][m] += st[m].w * v_sh[tr * n + kc * ny + jw] +
                  st[m].e * v_sh[tr * n + kc * ny + je];
    }
  }
}

// the lane's cells of v into the published field dst (3, nz, ny), and into
// the same place of the neighbouring blocks' copies where this lane's column
// is their lateral neighbour (push_w, push_e: their fields, or null)
template <int M>
__device__ __forceinline__ void publish(const float (&v)[kTracers][M],
                                        float* dst, float* push_w,
                                        float* push_e, int k0, int j,
                                        bool active, int nz, int ny) {
  const int n = nz * ny;
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = k0 + m;
      if (active && k < nz) {
        const int i = tr * n + k * ny + j;
        dst[i] = v[tr][m];
        if (push_w) push_w[i] = v[tr][m];
        if (push_e) push_e[i] = v[tr][m];
      }
    }
  }
}

// the chain over the group's lanes, in place on the three tracers' v:
// forward gp_k = v_k - m_k gp_{k-1}, then back x_k = gp_k - cp_k x_{k+1},
// each as csrc/iage_year.cu's thomas_scan computes it for one tracer, the
// maps' multipliers composed once for the three
template <int M>
__device__ __forceinline__ void thomas_scan3(float (&v)[kTracers][M],
                                             const float* fm,
                                             const float* fcp, int lane,
                                             int lanes, int k0, int jc,
                                             int nz, int ny) {
  float a[M];
  float A = 1.0f, B[kTracers], x[kTracers];
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) B[tr] = 0.0f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    a[m] = k < nz ? -fm[k * ny + jc] : 0.0f;
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) B[tr] = fmaf(a[m], B[tr], v[tr][m]);
    A = a[m] * A;
  }
  for (int d = 1; d < lanes; d *= 2) {
    const float Ap = __shfl_up_sync(~0u, A, d, lanes);
    float Bp[kTracers];
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr)
      Bp[tr] = __shfl_up_sync(~0u, B[tr], d, lanes);
    if (lane >= d) {
#pragma unroll
      for (int tr = 0; tr < kTracers; ++tr) B[tr] = fmaf(A, Bp[tr], B[tr]);
      A = A * Ap;
    }
  }
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
    x[tr] = __shfl_up_sync(~0u, B[tr], 1, lanes);
    if (lane == 0) x[tr] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) {
      x[tr] = fmaf(a[m], x[tr], v[tr][m]);
      v[tr][m] = x[tr];
    }
  }
  A = 1.0f;
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) B[tr] = 0.0f;
#pragma unroll
  for (int m = M - 1; m >= 0; --m) {
    const int k = k0 + m;
    a[m] = k < nz ? -fcp[k * ny + jc] : 0.0f;
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) B[tr] = fmaf(a[m], B[tr], v[tr][m]);
    A = a[m] * A;
  }
  for (int d = 1; d < lanes; d *= 2) {
    const float An = __shfl_down_sync(~0u, A, d, lanes);
    float Bn[kTracers];
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr)
      Bn[tr] = __shfl_down_sync(~0u, B[tr], d, lanes);
    if (lane + d < lanes) {
#pragma unroll
      for (int tr = 0; tr < kTracers; ++tr) B[tr] = fmaf(A, Bn[tr], B[tr]);
      A = A * An;
    }
  }
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
    x[tr] = __shfl_down_sync(~0u, B[tr], 1, lanes);
    if (lane == lanes - 1) x[tr] = 0.0f;
  }
#pragma unroll
  for (int m = M - 1; m >= 0; --m) {
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) {
      x[tr] = fmaf(a[m], x[tr], v[tr][m]);
      v[tr][m] = x[tr];
    }
  }
}

// the right-hand side of the CN increment over h of the lane's cells of the
// three tracers from a landed slot: r' = h (Lz y) w in flux form, kv on the
// edges below (up) and above (lo) each level
template <int M>
__device__ __forceinline__ void cn_rhs(const float* slot, float h,
                                       const float (&y)[kTracers][M],
                                       const float (&dzr)[M],
                                       float (&v)[kTracers][M], int lane,
                                       int lanes, int k0, int jc, int nz,
                                       int ny) {
  const float* kv = slot;
  const float* fw = slot + kv_floats(nz, ny) + nz * ny;
  float kv_up[M], kv_lo[M], unused[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    kv_up[m] = k < nz - 1 ? kv[k * ny + jc] : 0.0f;
  }
  column_neighbours(kv_up, kv_lo, unused, lanes);
  if (lane == 0) kv_lo[0] = 0.0f;
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
    float above[M], below[M];
    column_neighbours(y[tr], above, below, lanes);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = k0 + m;
      const float flux_dn = kv_up[m] * (below[m] - y[tr][m]);
      const float flux_up = kv_lo[m] * (y[tr][m] - above[m]);
      v[tr][m] =
          k < nz ? h * (dzr[m] * (flux_dn - flux_up)) * fw[k * ny + jc] : 0.0f;
    }
  }
}

// the chain of a landed slot's factors m and cp (csrc/imex_table.cuh's
// layout) on the right-hand sides v
template <int M>
__device__ __forceinline__ void cn_chain(const float* slot,
                                         float (&v)[kTracers][M], int lane,
                                         int lanes, int k0, int jc, int nz,
                                         int ny) {
  const float* fm = slot + kv_floats(nz, ny);
  thomas_scan3(v, fm, fm + 2 * nz * ny, lane, lanes, k0, jc, nz, ny);
}

// v Kahan-added into the lane's cells
template <int M>
__device__ __forceinline__ void cn_add(const float (&v)[kTracers][M],
                                       float (&y)[kTracers][M],
                                       float (&comp)[kTracers][M], int k0,
                                       int nz) {
#pragma unroll
  for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (k0 + m < nz) kahan_reg(y[tr][m], comp[tr][m], v[tr][m]);
  }
}

template <int M>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
    phosphorus_year_kernel(const float* __restrict__ y0,
                           float* __restrict__ out,
                           const float* __restrict__ fields,
                           const float* __restrict__ table, int nz, int ny,
                           int n_steps, float dt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long slot_bar[2];
  const int n = nz * ny;
  // this block's columns j_lo .. j_hi - 1, G lanes each
  const int rank = kCtas > 1 ? (int)blockIdx.x : 0;
  const int j_lo = rank * block_columns(ny);
  const int j_hi = min(j_lo + block_columns(ny), ny);
  const int lanes = column_lanes(block_columns(ny), kThreads);
  // the warp after the columns' issues the slots' copies
  const int producer = (lanes * block_columns(ny) + 31) / 32 * 32;
  const bool columns = threadIdx.x < producer;
  const int lane = threadIdx.x & (lanes - 1);
  const int j = j_lo + (int)threadIdx.x / lanes;  // this lane's column
  const bool active = j < j_hi;
  const int jc = active ? j : j_hi - 1;  // idle groups read column j_hi - 1
  const int jw = max(jc - 1, 0), je = min(jc + 1, ny - 1);
  const int k0 = lane * M;  // the lane's first level

  const long slot_len = slot_floats<false>(nz, ny);
  float* const y_sh = smem + 2 * slot_len;  // y (3, nz, ny), for j +- 1
  float* const ys_sh = y_sh + kTracers * n;  // the stage state, likewise
  // the neighbouring blocks' y where this lane's column is the first or the
  // last of its block; their stage states follow at the same offset
  float* push_w = nullptr;
  float* push_e = nullptr;
  if constexpr (kCtas > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (active && j == j_lo && rank > 0)
      push_w = cluster.map_shared_rank(y_sh, rank - 1);
    if (active && j == j_hi - 1 && rank < kCtas - 1)
      push_e = cluster.map_shared_rank(y_sh, rank + 1);
  }
  const long ys_off = ys_sh - y_sh;
  float* const ys_w = push_w ? push_w + ys_off : nullptr;
  float* const ys_e = push_e ? push_e + ys_off : nullptr;

  const Params p = load_params(fields + kHeader);
  const float* grid_g = fields + kHeader + kParams;
  const Fields g = grid_fields(grid_g, nz, ny);
  const float* light_g = grid_g + grid_floats(nz, ny);

  // the lane's cells: state, Kahan compensation, the stage-1 tendency and
  // stage state of the three tracers; the transport stencil, mu L and 1 / dz
  float y[kTracers][M], comp[kTracers][M], f1[kTracers][M], ys[kTracers][M];
  float uc[M], dzr[M];
  Stencil st[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    const int kc = min(k, nz - 1);
    const bool cell = k < nz;
    const int f = kc * (ny - 1) + jc;  // face (kc, jc) | (kc, jc + 1)
    const float dy_r = g.dy_r[jc];
    const float dz_r = g.dz_r[kc];
    const float wv_n = kc > 0 ? g.wv[(kc - 1) * ny + jc] : 0.0f;
    const float wv_s = kc < nz - 1 ? g.wv[kc * ny + jc] : 0.0f;
    const float ca_w = jc > 0 ? g.ca[f - 1] : 0.0f;
    const float cb_w = jc > 0 ? g.cb[f - 1] : 0.0f;
    const float ca_e = jc < ny - 1 ? g.ca[f] : 0.0f;
    const float cb_e = jc < ny - 1 ? g.cb[f] : 0.0f;
    st[m].w = cell ? dy_r * ca_w : 0.0f;
    st[m].e = cell ? -dy_r * cb_e : 0.0f;
    st[m].n = cell ? -0.5f * dz_r * wv_n : 0.0f;
    st[m].s = cell ? 0.5f * dz_r * wv_s : 0.0f;
    st[m].c = cell ? dy_r * (cb_w - ca_e) + 0.5f * dz_r * (wv_s - wv_n)
                   : 0.0f;
    uc[m] = cell ? p.max_uptake * light_g[kc * ny + jc] : 0.0f;
    dzr[m] = dz_r;
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) {
      y[tr][m] = cell ? y0[tr * n + kc * ny + jc] : 0.0f;
      comp[tr][m] = 0.0f;
    }
  }

  if (threadIdx.x == producer) {
    slot_bar_init(&slot_bar[0]);
    slot_bar_init(&slot_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block of the cluster running before any pushes to another
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == producer) {
    fetch<false>(smem, slot_len, slot_bar, table, 0, 0, 1, nz, ny);
    fetch<false>(smem, slot_len, slot_bar, table, 1, 0, 1, nz, ny);
  }

  const float half_dt = 0.5f * dt;
  slot_wait(&slot_bar[0], 0);
  if (columns) {
    float v[kTracers][M];
    cn_rhs(smem, half_dt, y, dzr, v, lane, lanes, k0, jc, nz, ny);
    cn_chain(smem, v, lane, lanes, k0, jc, nz, ny);
    cn_add(v, y, comp, k0, nz);
    publish(y, y_sh, push_w, push_e, k0, j, active, nz, ny);
  }
  cluster_arrive();
  if (columns) column_terms(y, st, uc, dzr, p, f1, k0, nz, lanes);
  cluster_wait();
  for (int step = 0; step < n_steps; ++step) {
    // solve step + 2 into the slot that solve step left (read before every
    // thread arrived at the barrier that ended the last step)
    if (threadIdx.x == producer && step + 2 <= n_steps)
      fetch<false>(smem, slot_len, slot_bar, table, step + 2, 0, 1, nz, ny);
    // Heun stage 1: f1 = tend(y) (its column terms before the barrier), the
    // stage state ys = y + dt f1, published
    if (columns) {
      lateral_terms(y_sh, st, f1, k0, jw, je, nz, ny);
#pragma unroll
      for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
        for (int m = 0; m < M; ++m) ys[tr][m] = y[tr][m] + dt * f1[tr][m];
      }
      publish(ys, ys_sh, ys_w, ys_e, k0, j, active, nz, ny);
    }
    cluster_arrive();
    // Heun stage 2: f2 = tend(ys), its column terms while the cluster
    // arrives, then the compensated explicit update
    float f2[kTracers][M];
    if (columns) column_terms(ys, st, uc, dzr, p, f2, k0, nz, lanes);
    cluster_wait();
    if (columns) {
      lateral_terms(ys_sh, st, f2, k0, jw, je, nz, ny);
#pragma unroll
      for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (k0 + m < nz)
            kahan_reg(y[tr][m], comp[tr][m],
                      half_dt * (f1[tr][m] + f2[tr][m]));
      }
    }
    // CN solve s = step + 1 over dt (merged interior halves), dt/2 after
    // the last Heun
    const int s = step + 1;
    const float* slot = smem + (s & 1) * slot_len;
    slot_wait(&slot_bar[s & 1], (s >> 1) & 1);
    float v[kTracers][M];
    if (columns)
      cn_rhs(slot, s == n_steps ? half_dt : dt, y, dzr, v, lane, lanes, k0,
             jc, nz, ny);
    if (columns) cn_chain(slot, v, lane, lanes, k0, jc, nz, ny);
    if (columns) {
      cn_add(v, y, comp, k0, nz);
      publish(y, y_sh, push_w, push_e, k0, j, active, nz, ny);
    }
    cluster_arrive();
    // the next stage 1's column terms while the cluster arrives
    if (columns && s < n_steps)
      column_terms(y, st, uc, dzr, p, f1, k0, nz, lanes);
    cluster_wait();
  }

  if (columns && active) {
#pragma unroll
    for (int tr = 0; tr < kTracers; ++tr) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int k = k0 + m;
        if (k < nz) out[tr * n + k * ny + j] = y[tr][m];
      }
    }
  }
}

template <int M>
int launch_levels(const float* y0, float* out, const float* fields,
                  const float* table, int nz, int ny, int n_steps, float dt,
                  void* stream) {
  const long smem = smem_floats(nz, ny) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      phosphorus_year_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  phosphorus_year_kernel<M>
      <<<kCtas, block_threads(block_columns(ny), kThreads), smem,
         (cudaStream_t)stream>>>(y0, out, fields, table, nz, ny, n_steps,
                                 dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// length of the packed constant buffer the wrapper builds
long phosphorus_year_fields_len(int nz, int ny) {
  return kHeader + kParams + grid_floats(nz, ny) + (long)nz * ny;
}

long phosphorus_year_smem_bytes(int nz, int ny) {
  return smem_floats(nz, ny) * (long)sizeof(float);
}

// levels a lane owns at nz x ny, if a launch can take the grid; 0 if not
int phosphorus_year_levels(int nz, int ny) {
  if (ny < kCtas || nz < 2) return 0;
  const int lanes = column_lanes(block_columns(ny), kThreads);
  const int levels = (nz + lanes - 1) / lanes;
  return (block_threads(block_columns(ny), kThreads) <= kThreads &&
          levels <= kMaxLevels)
             ? levels
             : 0;
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int phosphorus_year_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* phosphorus_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// launch on `stream` (a cudaStream_t) of the current device, from `table`
// (csrc/iage_year.cu's table of the year's CN solves, one channel, zero
// implicit diagonal); returns the launch's error (0 on success)
int phosphorus_year_launch(const float* y0, float* out, const float* fields,
                           const float* table, int nz, int ny, int n_steps,
                           float dt, void* stream) {
  switch (phosphorus_year_levels(nz, ny)) {
#define PHOS_LEVELS(M)                                                    \
  case M:                                                                 \
    return launch_levels<M>(y0, out, fields, table, nz, ny, n_steps, dt, \
                            stream);
    PHOS_LEVELS(1)
    PHOS_LEVELS(2)
    PHOS_LEVELS(3)
    PHOS_LEVELS(4)
#undef PHOS_LEVELS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
