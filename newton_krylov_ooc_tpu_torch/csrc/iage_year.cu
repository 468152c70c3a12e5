// One model year of the py_driver_2d iage family (a linear 2D tracer year),
// the whole year in one kernel launch, on NVIDIA Hopper (sm_90a).
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::build_iage_year_pallas_v2
// (B1) and, as its PCR variant B1v1 (iage_year_v1_launch),
// imex_pallas.py:96 build_iage_year_pallas, the first layout of the same
// year, whose CN solve is divide-form PCR (_pcr_axis1).
// The scheme is ops/imex.py's, step for step: CNh [Heun CNf] x (n-1) Heun CNh
// (Strang splitting with the interior half-steps merged), Crank-Nicolson
// vertical mixing and the implicit local diagonal in increment form with the
// right-hand side in flux form, the seasonal mixing coefficient kv(t) in
// closed form, advection + lateral diffusion as the fused face flux
// G = ca*y_l + cb*y_r (folded with vertical advection into a five-point
// stencil a cell), a per-channel source, and Kahan-compensated float32
// accumulation of every increment.  The device code it shares with the
// phosphorus year (csrc/phosphorus_year.cu) lives in csrc/imex_common.cuh
// and csrc/imex_table.cuh.
//
// What bounds it on this card: latency per step, not bytes or flops.  At
// T = 2 the launch occupies 2 of 132 SMs for 8760 dependent steps.  The
// first design spent 15-22k of a step's 25-31k SM cycles in the CN solve,
// a Thomas chain on 50 of 512 threads with two IEEE divisions a level (whose
// slow path zero numerators take: the F route from the solver's initial
// iterate was 30% slower than the JVP route), 3.3k in kv(t), which depends
// on t alone, and 3k in each Heun stage, mostly shared-memory loads
// (cli/profile_phases.py).  This design:
//
//   * The table (iage_table_kernel, launched once per year function and
//     shared by IageKernel's F and JVP years; at one channel and a zero
//     diagonal it is the phosphorus year's table): for each of the year's
//     n_steps + 1 CN solves (the leading dt/2, the merged dt solves, the
//     trailing dt/2), kv on the (nz-1, ny) interior edges and, for each
//     channel, the Thomas factors of every cell, m = a / denom,
//     w = 1 / denom and cp = c / denom.  None depends on the state.  One
//     thread a (solve, column), spread over every SM.
//   * The year kernel streams each solve's slice (kv, and B1's factors of
//     its channel) into one of two shared-memory slots with cp.async.bulk a
//     step ahead of its use, issued by a producer warp; an mbarrier a slot
//     says when it has landed.
//   * The channel map: the table holds one factor slot per distinct
//     implicit diagonal, and the packed constants map each channel to its
//     slot.  Block ch (a channel) reads its state, diagonal and source at
//     ch and streams the factors of slot map[ch].  IageKernel's F and JVP
//     years map their two channels to two slots; the year-operator probe
//     runs T x chunk channels (250 at 40 x 50 with chunks of 125) on the
//     same two slots, so its table stays the T = 2 table (489 MB at 8760
//     steps) where one slot a channel would take 52.6 GB.  Blocks of one
//     tracer then read the same table slice, mostly from L2.  B1v1 streams
//     kv alone, so the map only sets its table's stride.
//   * Lanes own cells: a group of G lanes (a power of two, G <= 32, so a
//     group never straddles a warp) owns column j, lane l its M levels
//     l M .. l M + M - 1, in registers: the state, its Kahan compensation,
//     the stage-1 tendency, the implicit diagonal and the tendency as a
//     five-point stencil.  Vertical neighbours come by shuffles; only the
//     lateral ones through shared memory, where y and the stage state are
//     published.
//   * Two block barriers a step: after Heun stage 1 (stage 2 reads the
//     stage state at j +- 1), and after the CN solve (the next stage 1 reads
//     y at j +- 1).  Stage 2's Kahan add and the CN solve of column j stay
//     in column j's lanes.
//   * B1's CN solve: r' = rhs w, then the chain gp_k = r'_k - m_k gp_{k-1}
//     and x_k = gp_k - cp_k x_{k+1} as two scans of affine maps: each lane
//     composes its M levels, log2 G shuffle rounds give its carry, and it
//     applies its maps (no division on the state's path; multiplying by
//     the stored reciprocal moves a level by at most an ulp from dividing
//     by denom).  The serial chain on one lane a column was 2.1x slower.
//   * B1v1's CN solve (kPcr): divide-form PCR in registers, ceil(log2 nz)
//     rounds whose partners at +-s are the lane's own registers or a
//     neighbouring lane's (shuffles), no barrier inside the solve; then
//     x = r / b and the Kahan add.  Its alpha and gamma depend only on the
//     matrix and stay inside the step: that is PCR's cost, which B1v1
//     exists to measure.
//
// The time index is an integer; t = t0 + i dt is recomputed, never summed.
// Shared memory, counted by smem_floats alone (the wrapper checks it
// against the card's opt-in limit): two slots, and y and the stage state
// (nz, ny).  The packed constants: the header, the grid fields, then per
// channel the source (T), the implicit diagonal (T, nz, ny) and the factor
// slot (T, integers held as floats).

#include "imex_common.cuh"
#include "imex_table.cuh"

namespace {

using namespace imex;

// a block's threads at most: 40 x 50 takes 800 and the producer warp, and
// __launch_bounds__ then allows 72 registers a thread
constexpr int kThreads = 864;
constexpr int kMaxLevels = 8;   // levels a lane owns at most (M)
constexpr int kTableThreads = 128;

template <bool kPcr>
__host__ __device__ inline long smem_floats(int nz, int ny) {
  // two slots; y and the stage state ys, published for the lateral stencil
  return 2 * slot_floats<kPcr>(nz, ny) + 2L * nz * ny;
}

// the time and the step h of CN solve s of a year of n_steps steps: the
// leading dt/2 at t0, then t_i + dt after step i (t_i = t0 + i dt), dt/2
// after the last
__device__ inline float solve_time(int s, float t0, float dt) {
  if (s == 0) return t0;
  const float t = t0 + (float)(s - 1) * dt;
  return t + dt;
}

__device__ inline float solve_h(int s, int n_steps, float dt) {
  return (s == 0 || s == n_steps) ? 0.5f * dt : dt;
}

// one thread a (solve, column): kv of the column's interior edges, then the
// Thomas factors of each channel (the CN matrix (I - h/2 M) with
// M = Lz + diag, as csrc/imex_common.cuh's cn_column builds it)
__global__ void __launch_bounds__(kTableThreads)
    iage_table_kernel(const float* __restrict__ fields,
                      float* __restrict__ table, int t_dim, int nz, int ny,
                      int n_steps, float t0, float dt) {
  const long col = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (long)(n_steps + 1) * ny) return;
  const int s = (int)(col / ny);
  const int j = (int)(col - (long)s * ny);
  const Header hd = load_header(fields);
  const float* grid_g = fields + kHeader;
  const Fields g = grid_fields(grid_g, nz, ny);
  const float* diag = grid_g + grid_floats(nz, ny) + t_dim;
  const float half = 0.5f * solve_h(s, n_steps, dt);
  const float frac = piecewise_frac(solve_time(s, t0, dt), hd);

  float* kv = table + (long)s * solve_floats(t_dim, nz, ny);
  for (int k = 0; k < nz - 1; ++k)
    kv[k * ny + j] = kv_edge(k, j, ny, frac, hd, g);
  const int n = nz * ny;
  for (int c = 0; c < t_dim; ++c) {
    float* m = kv + kv_floats(nz, ny) + (long)c * factor_floats(nz, ny);
    const float* d = diag + (long)c * n;
    float cp_prev = 0.0f, kv_lo = 0.0f;
    for (int k = 0; k < nz; ++k) {
      const int i = k * ny + j;
      const float dzr = g.dz_r[k];
      const float kv_up = k < nz - 1 ? kv[i] : 0.0f;
      const float du = kv_up * dzr;
      const float dl = kv_lo * dzr;
      const float dmain = -(du + dl) + d[i];
      const float a = -half * dl;
      const float b = 1.0f - half * dmain;
      const float cc = -half * du;
      const float denom = b - a * cp_prev;
      cp_prev = cc / denom;
      m[i] = a / denom;
      m[n + i] = 1.0f / denom;
      m[2 * n + i] = cp_prev;
      kv_lo = kv_up;
    }
  }
}

// the table slot of channel ch's factors: the channel map, the last T of
// the packed constants.  Read by the producer thread where it fetches, so
// that no column thread keeps it live across the year.
__device__ __forceinline__ int channel_slot(const float* fields, int ch,
                                            int t_dim, int nz, int ny) {
  return (int)fields[kHeader + grid_floats(nz, ny) + t_dim +
                     (long)t_dim * nz * ny + ch];
}

// -- a column's lanes ---------------------------------------------------
//
// Lane l of a group owns levels l M .. l M + M - 1 of its column, their
// values in registers; levels past nz hold 0.

// the fused transport tendency of csrc/imex_common.cuh's transport_tend as a
// five-point stencil: f = cw v(j-1) + cc v + ce v(j+1) + cn v(k-1) +
// cs v(k+1) + src, the lateral neighbours from the published field v_sh
template <int M>
__device__ __forceinline__ void tendency(const float (&v)[M],
                                         const float* v_sh,
                                         const Stencil (&st)[M], float src,
                                         float (&f)[M], int k0, int jc,
                                         int nz, int ny, int lanes) {
  float above[M], below[M];
  column_neighbours(v, above, below, lanes);
  const int jw = max(jc - 1, 0), je = min(jc + 1, ny - 1);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int kc = min(k0 + m, nz - 1);
    const float west = v_sh[kc * ny + jw];
    const float east = v_sh[kc * ny + je];
    f[m] = st[m].w * west + st[m].c * v[m] + st[m].e * east +
           st[m].n * above[m] + st[m].s * below[m] + src;
  }
}

// B1's chain over the group's lanes, in place on v: forward
// gp_k = v_k - m_k gp_{k-1}, then back x_k = gp_k - cp_k x_{k+1}.  Each
// lane composes its M levels' affine maps, a scan over the lanes by
// shuffles (log2 G rounds) gives each lane its carry, and the lane applies
// its maps from it.
template <int M>
__device__ __forceinline__ void thomas_scan(float (&v)[M], const float* fm,
                                            const float* fcp, int lane,
                                            int lanes, int k0, int jc,
                                            int nz, int ny) {
  float a[M];
  float A = 1.0f, B = 0.0f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    a[m] = k < nz ? -fm[k * ny + jc] : 0.0f;
    B = fmaf(a[m], B, v[m]);
    A = a[m] * A;
  }
  for (int d = 1; d < lanes; d *= 2) {
    const float Ap = __shfl_up_sync(~0u, A, d, lanes);
    const float Bp = __shfl_up_sync(~0u, B, d, lanes);
    if (lane >= d) {
      B = fmaf(A, Bp, B);
      A = A * Ap;
    }
  }
  float x = __shfl_up_sync(~0u, B, 1, lanes);
  if (lane == 0) x = 0.0f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    x = fmaf(a[m], x, v[m]);
    v[m] = x;
  }
  A = 1.0f;
  B = 0.0f;
#pragma unroll
  for (int m = M - 1; m >= 0; --m) {
    const int k = k0 + m;
    a[m] = k < nz ? -fcp[k * ny + jc] : 0.0f;
    B = fmaf(a[m], B, v[m]);
    A = a[m] * A;
  }
  for (int d = 1; d < lanes; d *= 2) {
    const float An = __shfl_down_sync(~0u, A, d, lanes);
    const float Bn = __shfl_down_sync(~0u, B, d, lanes);
    if (lane + d < lanes) {
      B = fmaf(A, Bn, B);
      A = A * An;
    }
  }
  x = __shfl_down_sync(~0u, B, 1, lanes);
  if (lane == lanes - 1) x = 0.0f;
#pragma unroll
  for (int m = M - 1; m >= 0; --m) {
    x = fmaf(a[m], x, v[m]);
    v[m] = x;
  }
}

// -(num / den), 0 when num is 0: the same value up to the sign of a zero,
// which no later sum sees
__device__ __forceinline__ float neg_ratio(float num, float den) {
  return num == 0.0f ? 0.0f : -num / den;
}

// a value of the row s levels away from level k0 + m: the lane's own
// register or, s / M lanes (rounded) up or down, that lane's
template <int M>
__device__ __forceinline__ float row_at(const float (&v)[M], int m, int s,
                                        int lanes) {
  const int t = m + s;  // the partner's offset from the lane's first level
  if (t >= 0 && t < M) return v[t];
  if (t >= M) {
    const int d = t / M;
    return __shfl_down_sync(~0u, v[t - d * M], d, lanes);
  }
  const int d = (-t + M - 1) / M;
  return __shfl_up_sync(~0u, v[t + d * M], d, lanes);
}

// B1v1's column solve: divide-form PCR over the group's rows (a, b, c, r
// in registers), rows past either end acting as identity rows, then
// x = r / b -- the arithmetic of ops/tridiag.py::pcr_solve
constexpr int kMaxRounds = 8;  // ceil(log2 nz) <= 8: nz <= 256

template <int M>
__device__ __forceinline__ void pcr_rounds(float (&a)[M], float (&b)[M],
                                           float (&c)[M], float (&r)[M],
                                           int lanes, int k0, int nz) {
#pragma unroll
  for (int e = 0; e < kMaxRounds; ++e) {
    const int s = 1 << e;
    if (s >= nz) break;
    float na[M], nb[M], nc[M], nr[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float am = row_at(a, m, -s, lanes), bm = row_at(b, m, -s, lanes);
      float cm = row_at(c, m, -s, lanes), rm = row_at(r, m, -s, lanes);
      float ap = row_at(a, m, s, lanes), bp = row_at(b, m, s, lanes);
      float cq = row_at(c, m, s, lanes), rp = row_at(r, m, s, lanes);
      if (k0 + m - s < 0) {
        am = 0.0f;
        bm = 1.0f;
        cm = 0.0f;
        rm = 0.0f;
      }
      if (k0 + m + s >= nz) {
        ap = 0.0f;
        bp = 1.0f;
        cq = 0.0f;
        rp = 0.0f;
      }
      const float alpha = neg_ratio(a[m], bm);
      const float gamma = neg_ratio(c[m], bp);
      na[m] = alpha * am;
      nc[m] = gamma * cq;
      nb[m] = b[m] + alpha * cm + gamma * ap;
      nr[m] = r[m] + alpha * rm + gamma * rp;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a[m] = na[m];
      b[m] = nb[m];
      c[m] = nc[m];
      r[m] = nr[m];
    }
  }
}

// -- the year -----------------------------------------------------------------

// the lane's right-hand side terms of a CN solve over h from the slot's kv:
// kv on the edges below (up) and above (lo) each level, and
// rhs = h (Lz + diag) y in flux form
template <int M>
__device__ __forceinline__ void cn_rhs(const float (&y)[M], const float* kv,
                                       const float (&dg)[M],
                                       const float (&dzr)[M], float h,
                                       float (&kv_up)[M], float (&kv_lo)[M],
                                       float (&rhs)[M], int lane, int lanes,
                                       int k0, int jc, int nz, int ny) {
  float above[M], below[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    kv_up[m] = k < nz - 1 ? kv[k * ny + jc] : 0.0f;
  }
  column_neighbours(kv_up, kv_lo, below, lanes);
  if (lane == 0) kv_lo[0] = 0.0f;
  column_neighbours(y, above, below, lanes);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float flux_dn = kv_up[m] * (below[m] - y[m]);
    const float flux_up = kv_lo[m] * (y[m] - above[m]);
    rhs[m] = h * (dzr[m] * (flux_dn - flux_up) + dg[m] * y[m]);
  }
}

// the CN increment over h of the lane's cells from a landed slot, in three
// parts: the right-hand side (B1: r' = rhs w; B1v1: the PCR rows a, b, c,
// r), the solve (B1: the scan chain; B1v1: PCR and x = r / b), and the
// Kahan add into y, published to y_sh
template <int M, bool kPcr>
__device__ __forceinline__ void cn_setup(const float* slot, float h,
                                         const float (&y)[M],
                                         const float (&dg)[M],
                                         const float (&dzr)[M], float (&v)[M],
                                         float (&a)[M], float (&b)[M],
                                         float (&c)[M], int lane, int lanes,
                                         int k0, int jc, int nz, int ny) {
  float kv_up[M], kv_lo[M];
  cn_rhs(y, slot, dg, dzr, h, kv_up, kv_lo, v, lane, lanes, k0, jc, nz, ny);
  const float half = 0.5f * h;
  const float* fw = slot + kv_floats(nz, ny) + nz * ny;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    const bool cell = k < nz;
    if constexpr (kPcr) {
      const float du = kv_up[m] * dzr[m];
      const float dl = kv_lo[m] * dzr[m];
      const float dmain = -(du + dl) + dg[m];
      a[m] = cell ? -half * dl : 0.0f;
      b[m] = cell ? 1.0f - half * dmain : 1.0f;
      c[m] = cell ? -half * du : 0.0f;
      v[m] = cell ? v[m] : 0.0f;
    } else {
      v[m] = cell ? v[m] * fw[k * ny + jc] : 0.0f;
    }
  }
}

template <int M, bool kPcr>
__device__ __forceinline__ void cn_solve(const float* slot, float (&v)[M],
                                         float (&a)[M], float (&b)[M],
                                         float (&c)[M], int lane, int lanes,
                                         int k0, int jc, int nz, int ny) {
  if constexpr (kPcr) {
    pcr_rounds(a, b, c, v, lanes, k0, nz);
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = v[m] == 0.0f ? 0.0f : v[m] / b[m];
  } else {
    const float* fm = slot + kv_floats(nz, ny);
    thomas_scan(v, fm, fm + 2 * nz * ny, lane, lanes, k0, jc, nz, ny);
  }
}

template <int M>
__device__ __forceinline__ void cn_add(const float (&v)[M], float (&y)[M],
                                       float (&comp)[M], float* y_sh, int k0,
                                       int j, bool active, int nz, int ny) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k = k0 + m;
    if (k < nz) kahan_reg(y[m], comp[m], v[m]);
    if (active && k < nz) y_sh[k * ny + j] = y[m];
  }
}

template <int M, bool kPcr>
__global__ void __launch_bounds__(kThreads, 1)
    iage_year_kernel(const float* __restrict__ y0, float* __restrict__ out,
                     const float* __restrict__ fields,
                     const float* __restrict__ table, int t_dim,
                     int n_slots, int nz, int ny, int n_steps, float t0,
                     float dt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long slot_bar[2];
  const int n = nz * ny;
  const int ch = blockIdx.x;
  const int lanes = column_lanes(ny, kThreads);
  // the warp after the columns' issues the slots' copies
  const int producer = (lanes * ny + 31) / 32 * 32;
  const bool columns = threadIdx.x < producer;
  const int lane = threadIdx.x & (lanes - 1);
  const int j = threadIdx.x / lanes;  // this lane's column
  const bool active = j < ny;
  const int jc = active ? j : ny - 1;  // idle groups read column ny - 1
  const int k0 = lane * M;             // the lane's first level

  const long slot_len = slot_floats<kPcr>(nz, ny);
  float* const y_sh = smem + 2 * slot_len;  // y, published for j +- 1
  float* const ys_sh = y_sh + n;            // the stage state, likewise

  const float* grid_g = fields + kHeader;
  const Fields g = grid_fields(grid_g, nz, ny);
  const long n_grid = grid_floats(nz, ny);
  const float src = grid_g[n_grid + ch];
  const float* diag_g = grid_g + n_grid + t_dim + (long)ch * n;

  // the lane's cells: state, Kahan compensation, stage-1 tendency,
  // implicit diagonal, 1 / dz and the tendency's stencil
  float y[M], comp[M], f1[M], dg[M], dzr[M];
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
    y[m] = cell ? y0[(long)ch * n + kc * ny + jc] : 0.0f;
    comp[m] = 0.0f;
    f1[m] = 0.0f;
    dg[m] = cell ? diag_g[kc * ny + jc] : 0.0f;
    dzr[m] = dz_r;
    if (columns && active && cell) y_sh[k * ny + j] = y[m];
  }

  if (threadIdx.x == producer) {
    slot_bar_init(&slot_bar[0]);
    slot_bar_init(&slot_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == producer) {
    const int slot = channel_slot(fields, ch, t_dim, nz, ny);
    fetch<kPcr>(smem, slot_len, slot_bar, table, 0, slot, n_slots, nz, ny);
    fetch<kPcr>(smem, slot_len, slot_bar, table, 1, slot, n_slots, nz, ny);
  }

  const float half_dt = 0.5f * dt;
  slot_wait(&slot_bar[0], 0);
  if (columns) {
    float v[M], a[M], b[M], c[M];
    cn_setup<M, kPcr>(smem, half_dt, y, dg, dzr, v, a, b, c, lane, lanes, k0,
                      jc, nz, ny);
    cn_solve<M, kPcr>(smem, v, a, b, c, lane, lanes, k0, jc, nz, ny);
    cn_add(v, y, comp, y_sh, k0, j, active, nz, ny);
  }
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    // solve step + 2 into the slot that solve step left (read before the
    // barrier that ended the last step)
    if (threadIdx.x == producer && step + 2 <= n_steps)
      fetch<kPcr>(smem, slot_len, slot_bar, table, step + 2,
                  channel_slot(fields, ch, t_dim, nz, ny), n_slots, nz, ny);
    // Heun stage 1: f1 = tend(y), the stage state ys = y + dt f1
    if (columns) {
      tendency(y, y_sh, st, src, f1, k0, jc, nz, ny, lanes);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int k = k0 + m;
        if (active && k < nz) ys_sh[k * ny + j] = y[m] + dt * f1[m];
      }
    }
    __syncthreads();
    // Heun stage 2 and the compensated explicit update
    if (columns) {
      float ys[M], f2[M];
#pragma unroll
      for (int m = 0; m < M; ++m) ys[m] = y[m] + dt * f1[m];
      tendency(ys, ys_sh, st, src, f2, k0, jc, nz, ny, lanes);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (k0 + m < nz) kahan_reg(y[m], comp[m], half_dt * (f1[m] + f2[m]));
    }
    // CN solve s = step + 1 over dt (merged interior halves), dt/2 after
    // the last Heun
    const int s = step + 1;
    const float* slot = smem + (s & 1) * slot_len;
    float v[M], a[M], b[M], c[M];
    slot_wait(&slot_bar[s & 1], (s >> 1) & 1);
    if (columns)
      cn_setup<M, kPcr>(slot, s == n_steps ? half_dt : dt, y, dg, dzr, v, a,
                        b, c, lane, lanes, k0, jc, nz, ny);
    if (columns)
      cn_solve<M, kPcr>(slot, v, a, b, c, lane, lanes, k0, jc, nz, ny);
    if (columns) cn_add(v, y, comp, y_sh, k0, j, active, nz, ny);
    __syncthreads();
  }

  if (columns && active) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = k0 + m;
      if (k < nz) out[(long)ch * n + k * ny + j] = y[m];
    }
  }
}

}  // namespace

extern "C" {

// length of the packed constant buffer the wrapper builds: the header, the
// grid, and per channel the source, the diagonal and the factor slot
long iage_year_fields_len(int t_dim, int nz, int ny) {
  return kHeader + grid_floats(nz, ny) + 2L * t_dim + (long)t_dim * nz * ny;
}

// the table's layout: floats of one solve's kv part, of one slot's
// factors, of one solve, and of the whole table (n_steps + 1 solves) of
// n_slots slots
long iage_year_kv_floats(int nz, int ny) { return kv_floats(nz, ny); }

long iage_year_factor_floats(int nz, int ny) { return factor_floats(nz, ny); }

long iage_year_table_floats(int n_slots, int nz, int ny, int n_steps) {
  return (n_steps + 1L) * solve_floats(n_slots, nz, ny);
}

long iage_year_smem_bytes(int nz, int ny) {
  return smem_floats<false>(nz, ny) * (long)sizeof(float);
}

// B1v1's shared memory: slots of kv alone, no chain scratch
long iage_year_v1_smem_bytes(int nz, int ny) {
  return smem_floats<true>(nz, ny) * (long)sizeof(float);
}

// levels a lane owns at nz x ny, if a launch can take the grid; 0 if not
int iage_year_levels(int nz, int ny) {
  const int levels = (nz + column_lanes(ny, kThreads) - 1) / column_lanes(ny, kThreads);
  return (ny >= 1 && ny <= kThreads - 32 && nz >= 2 && nz <= 1 << kMaxRounds &&
          levels <= kMaxLevels)
             ? levels
             : 0;
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int iage_year_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* iage_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// the table of a year's n_steps + 1 CN solves, from the packed constants
// of its t_dim slots (one channel a slot)
int iage_year_table_launch(const float* fields, float* table, int t_dim,
                           int nz, int ny, int n_steps, float t0, float dt,
                           void* stream) {
  const long cols = (n_steps + 1L) * ny;
  const long blocks = (cols + kTableThreads - 1) / kTableThreads;
  iage_table_kernel<<<(unsigned)blocks, kTableThreads, 0,
                      (cudaStream_t)stream>>>(fields, table, t_dim, nz, ny,
                                              n_steps, t0, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

template <int M, bool kPcr>
int launch_levels(const float* y0, float* out, const float* fields,
                  const float* table, int t_dim, int n_slots, int nz, int ny,
                  int n_steps, float t0, float dt, void* stream) {
  const long smem = smem_floats<kPcr>(nz, ny) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      iage_year_kernel<M, kPcr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  iage_year_kernel<M, kPcr><<<t_dim, block_threads(ny, kThreads), smem,
                              (cudaStream_t)stream>>>(
      y0, out, fields, table, t_dim, n_slots, nz, ny, n_steps, t0, dt);
  return (int)cudaGetLastError();
}

template <bool kPcr>
int launch(const float* y0, float* out, const float* fields,
           const float* table, int t_dim, int n_slots, int nz, int ny,
           int n_steps, float t0, float dt, void* stream) {
  switch (iage_year_levels(nz, ny)) {
#define IAGE_LEVELS(M)                                                       \
  case M:                                                                    \
    return launch_levels<M, kPcr>(y0, out, fields, table, t_dim, n_slots,  \
                                  nz, ny, n_steps, t0, dt, stream);
    IAGE_LEVELS(1)
    IAGE_LEVELS(2)
    IAGE_LEVELS(3)
    IAGE_LEVELS(4)
    IAGE_LEVELS(5)
    IAGE_LEVELS(6)
    IAGE_LEVELS(7)
    IAGE_LEVELS(8)
#undef IAGE_LEVELS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// launch on `stream` (a cudaStream_t) of the current device: t_dim
// channels on a table of n_slots slots; returns the cudaGetLastError() after
// the launch (0 on success)
int iage_year_launch(const float* y0, float* out, const float* fields,
                     const float* table, int t_dim, int n_slots, int nz,
                     int ny, int n_steps, float t0, float dt, void* stream) {
  return launch<false>(y0, out, fields, table, t_dim, n_slots, nz, ny,
                       n_steps, t0, dt, stream);
}

// B1v1: the same year, its CN solves by PCR
int iage_year_v1_launch(const float* y0, float* out, const float* fields,
                        const float* table, int t_dim, int n_slots, int nz,
                        int ny, int n_steps, float t0, float dt,
                        void* stream) {
  return launch<true>(y0, out, fields, table, t_dim, n_slots, nz, ny, n_steps,
                      t0, dt, stream);
}

}  // extern "C"
