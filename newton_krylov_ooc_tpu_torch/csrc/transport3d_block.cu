// k steps of the 3D transport year on one shard's halo-extended latitude
// block, tiled and temporally blocked in shared memory, on NVIDIA Hopper
// (sm_90a): kernel B7.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_block_pallas.py:71
// (build_block3d_steps), the per-shard compute of
// parallel/sharded_transport3d.py::build_sharded_transport3d_year_pallas.
// It computes the same function: given the state y and its Kahan carry c on
// a window of `rows` latitude rows (a shard's rows plus 4 k a side, which the
// caller fills from the neighbouring shards), all nz levels and all nlon
// longitudes, it returns both after k x [Heun(dt); CN(dt)] -- the interior
// steps of the Strang-split year -- in float32.  Reads past the window in
// latitude and depth see zeros, and longitude is periodic over nlon.  The
// rows next to the window's edges go wrong, 4 rows a step (2 stencil radii
// a Heun step), and reach the caller's interior rows exactly after k steps.
//
// What bounds it on this card.  The TPU kernel keeps the whole slab in one
// core's VMEM for k steps; on Hopper one block has 227 KB of shared memory,
// far less than a shard's slab.  Per cell, tracer and step the work is two
// upwind3 tendencies, a Heun Kahan add and a CN column solve -- about 200
// float32 operations against the 8 bytes of state that must move once a
// block, so the kernel is bound by operations, and by the share of them
// that the tiles spend recomputing their halos.
//
// Design: B3's idea (csrc/iage_block.cu) one dimension up.  A CUDA block
// owns a tile of tile_y rows x tile_x columns over all nz levels, of one
// tracer (or of all T when the surface coupling mixes them), and loads its
// tile plus a halo of 4 j' rows and 4 j' columns a side -- clipped to the
// window in latitude, wrapped over nlon in longitude, the whole nlon when
// the halo would meet itself -- into shared memory: y, c, the Heun stage f1
// and one scratch field g, 16 bytes a cell and tracer
// (transport3d_block_smem_bytes is the one place that counts it).  It runs
// j' steps there and writes back its owned cells.  Where the loaded region
// is cut inside the window, the cut reads zeros like the window's edge, and
// its error travels 4 cells a step, so it never reaches an owned cell: any
// tile and any split of k into launches of j' steps gives, cell for cell,
// what one block over the whole window would give.  The wrapper
// (ops/transport3d_block_cuda.py::block_plan) picks the tile and j' from
// the card's opt-in shared-memory limit and SM count, and ping-pongs the
// state between launches.
//
// A step: (A) f1 = tend(y) on every loaded cell; (B) g = tend(y + dt f1),
// the stage state formed on the fly from y and f1; (C) one thread a column:
// the Heun Kahan add of dt/2 (f1 + g), then the CN(dt) solve by Thomas on
// the precomputed bands dlb/dub (cp and gp in f1 and g), its Kahan add fused
// into the back substitution; __syncthreads() between the phases.  The
// tendency is csrc/transport3d_common.cuh's flux divergence, its upwind3
// selectors derived from `wet`; coefficients, bands and rate fields come
// through __ldg from device memory (a gx1 shard's fields fit the 50 MB L2).
// The CN right-hand side is in flux form, solved in increment form, as the
// TPU kernel's; the TPU kernel solves by reciprocal-form PCR, Thomas stays
// within the same tolerance.  A factored rate field a wet + b wet_surf is
// rebuilt from its two scalars.  Not here: cp.async or TMA staging, wet in
// shared memory, one launch for all shards of a card.

#include "transport3d_common.cuh"

namespace {

using namespace t3d;

constexpr int kThreads = 256;

// operand slots, in ops/transport3d_block_cuda.py's order
enum Slot {
  kWet, kRecipVol, kTE, kTN, kTT, kCondE, kCondN, kDlb, kDub, kDiag, kSrc,
  kRates, kCouple, kSlots
};

// how a rate field arrives: absent, dense (T, nz, rows, nlon), or factored
// into a wet + b wet_surf with (a, b) per tracer in the rates slot
enum RateMode { kAbsent = 0, kDense = 1, kFactored = 2 };

struct Args {
  const float* f[kSlots];
  int t_dim, nz, rows, nlon;
  int upwind3, diag_mode, src_mode;
};

// one CUDA block's loaded region: rows lo_y + [0, ly), columns lo_x + [0, lx)
// wrapped over nlon (lo_x may be negative); wrap: the region is the whole
// nlon, periodic within itself
struct Tile {
  int lo_y, ly, lo_x, lx;
  bool wrap;
};

__device__ inline int wrap_col(int x, int nlon) {
  return x < 0 ? x + nlon : (x >= nlon ? x - nlon : x);
}

// a rate field (diag or src) of tracer t at level k and column `cell`
__device__ inline float rate_at(const Args& a, int mode, int slot, int offset,
                                int t, int k, long cell, long nh) {
  if (mode == kAbsent) return 0.0f;
  if (mode == kDense) return __ldg(a.f[slot] + ((long)t * a.nz + k) * nh + cell);
  const float wet = __ldg(a.f[kWet] + k * nh + cell);
  const float* ab = a.f[kRates] + offset;
  const float val = __ldg(ab + t) * wet;
  return k == 0 ? val + __ldg(ab + a.t_dim + t) * wet : val;
}

// the explicit tendency of tracer t at local cell (k, r, x): the flux
// divergence of the loaded state y (with kStage, of y + dt f1) times
// recip_vol, plus src; zeros outside the loaded region, outside the window
// in latitude and depth
template <bool kStage>
__device__ inline float tendency(const float* y, const float* f1, float dt,
                                 const Args& a, const Tile& tl, int t, int k,
                                 int r, int x) {
  const int nz = a.nz, rows = a.rows, nlon = a.nlon;
  const long nh = (long)rows * nlon;
  const long plane = (long)tl.ly * tl.lx;
  const int gy = tl.lo_y + r;
  const int gx = wrap_col(tl.lo_x + x, nlon);
  auto wet_at = [&](int kk, int yy, int xx) -> float {
    if (kk < 0 || kk >= nz || yy < 0 || yy >= rows) return 0.0f;
    return __ldg(a.f[kWet] + kk * nh + (long)yy * nlon + xx);
  };
  auto w = [&](int dk, int dj, int di) -> float {
    return wet_at(k + dk, gy + dj, wrap_col(gx + di, nlon));
  };
  auto yw = [&](int dk, int dj, int di) -> float {
    const int kk = k + dk, rr = r + dj;
    int xx = x + di;
    if (kk < 0 || kk >= nz || rr < 0 || rr >= tl.ly) return 0.0f;
    if (tl.wrap) {
      xx = wrap_col(xx, nlon);
    } else if (xx < 0 || xx >= tl.lx) {
      return 0.0f;
    }
    const long i = kk * plane + (long)rr * tl.lx + xx;
    const float v = kStage ? y[i] + dt * f1[i] : y[i];
    return v * w(dk, dj, di);
  };
  auto face = [&](int f, int dk, int dj, int di) -> float {
    const int slot = f == kFaceE       ? kTE
                     : f == kFaceN     ? kTN
                     : f == kFaceT     ? kTT
                     : f == kFaceCondE ? kCondE
                                       : kCondN;
    const float* p = a.f[slot];
    if (p == nullptr) return 0.0f;
    return __ldg(p + (k + dk) * nh + (long)(gy + dj) * nlon +
                 wrap_col(gx + di, nlon));
  };
  const bool has_e = a.f[kTE] != nullptr || a.f[kCondE] != nullptr;
  const bool has_n = a.f[kTN] != nullptr || a.f[kCondN] != nullptr;
  const bool has_t = a.f[kTT] != nullptr;
  const float div = flux_divergence(yw, w, face, has_e, has_n, has_t, gy > 0,
                                    k + 1 < nz, a.upwind3);
  const long cell = (long)gy * nlon + gx;
  return div * __ldg(a.f[kRecipVol] + k * nh + cell) +
         rate_at(a, a.src_mode, kSrc, 2 * a.t_dim, t, k, cell, nh);
}

// the surface coupling of tracer t at local surface cell `i`:
// wet_surf * sum_u couple[t, u] s_u, s_u the (stage) state of tracer u; m is
// one tracer's loaded cells
template <bool kStage>
__device__ inline float coupling(const float* y, const float* f1, float dt,
                                 const Args& a, int t, long i, long m,
                                 float wet_surf) {
  float acc = 0.0f;
  for (int u = 0; u < a.t_dim; ++u) {
    const float cv = __ldg(a.f[kCouple] + t * a.t_dim + u);
    if (cv != 0.0f) {
      const long j = u * m + i;
      acc = acc + cv * (kStage ? y[j] + dt * f1[j] : y[j]);
    }
  }
  return wet_surf * acc;
}

__global__ void __launch_bounds__(kThreads)
    block3d_kernel(const float* __restrict__ y_in,
                   const float* __restrict__ c_in, float* __restrict__ y_out,
                   float* __restrict__ c_out, Args a, int tracers,
                   int tile_y, int tile_x, int halo, int j_steps, float dt) {
  extern __shared__ float smem[];
  const int nz = a.nz, rows = a.rows, nlon = a.nlon;
  const long nh = (long)rows * nlon;
  const int t0 = blockIdx.z * tracers;  // the block's first tracer

  const int y0 = blockIdx.y * tile_y;
  const int y1 = min(rows, y0 + tile_y);
  Tile tl;
  tl.lo_y = max(0, y0 - halo);
  tl.ly = min(rows, y1 + halo) - tl.lo_y;
  int x0, x1;
  tl.wrap = tile_x >= nlon;
  if (tl.wrap) {
    x0 = 0;
    x1 = nlon;
    tl.lo_x = 0;
    tl.lx = nlon;
  } else {
    x0 = blockIdx.x * tile_x;
    x1 = min(nlon, x0 + tile_x);
    tl.lo_x = x0 - halo;
    tl.lx = x1 - x0 + 2 * halo;
  }
  const long plane = (long)tl.ly * tl.lx;
  const long m = nz * plane;  // one tracer's loaded cells
  const long cells = tracers * m;

  float* y = smem;
  float* comp = y + cells;
  float* f1 = comp + cells;
  float* g = f1 + cells;

  for (long i = threadIdx.x; i < cells; i += blockDim.x) {
    const long t = i / m;
    const long rem = i - t * m;
    const long k = rem / plane;
    const long rc = rem - k * plane;
    const int r = (int)(rc / tl.lx);
    const int x = (int)(rc - (long)r * tl.lx);
    const long gi = ((t0 + t) * nz + k) * nh + (long)(tl.lo_y + r) * nlon +
                    wrap_col(tl.lo_x + x, nlon);
    y[i] = y_in[gi];
    comp[i] = c_in[gi];
  }
  __syncthreads();

  const float half_dt = 0.5f * dt;
  const bool coupled = a.f[kCouple] != nullptr;
  for (int s = 0; s < j_steps; ++s) {
    // A: Heun stage 1
    for (long i = threadIdx.x; i < cells; i += blockDim.x) {
      const int t = (int)(i / m);
      const long rem = i - t * m;
      const int k = (int)(rem / plane);
      const long rc = rem - k * plane;
      const int r = (int)(rc / tl.lx);
      const int x = (int)(rc - (long)r * tl.lx);
      float f = tendency<false>(y + t * m, nullptr, dt, a, tl, t0 + t, k, r, x);
      if (coupled && k == 0) {
        const float ws = __ldg(a.f[kWet] + (long)(tl.lo_y + r) * nlon +
                               wrap_col(tl.lo_x + x, nlon));
        f = f + coupling<false>(y, nullptr, dt, a, t0 + t, rc, m, ws);
      }
      f1[i] = f;
    }
    __syncthreads();
    // B: Heun stage 2 at y + dt f1
    for (long i = threadIdx.x; i < cells; i += blockDim.x) {
      const int t = (int)(i / m);
      const long rem = i - t * m;
      const int k = (int)(rem / plane);
      const long rc = rem - k * plane;
      const int r = (int)(rc / tl.lx);
      const int x = (int)(rc - (long)r * tl.lx);
      float f = tendency<true>(y + t * m, f1 + t * m, dt, a, tl, t0 + t, k, r,
                               x);
      if (coupled && k == 0) {
        const float ws = __ldg(a.f[kWet] + (long)(tl.lo_y + r) * nlon +
                               wrap_col(tl.lo_x + x, nlon));
        f = f + coupling<true>(y, f1, dt, a, t0 + t, rc, m, ws);
      }
      g[i] = f;
    }
    __syncthreads();
    // C: one thread a column: the Heun Kahan add, then CN(dt) by Thomas
    for (long col = threadIdx.x; col < tracers * plane; col += blockDim.x) {
      const int t = (int)(col / plane);
      const long base = t * m + (col - t * plane);
      const long rc = col - t * plane;
      const int r = (int)(rc / tl.lx);
      const int x = (int)(rc - (long)r * tl.lx);
      const long cell = (long)(tl.lo_y + r) * nlon + wrap_col(tl.lo_x + x, nlon);
      for (int k = 0; k < nz; ++k) {
        const long i = base + k * plane;
        const float adj = half_dt * (f1[i] + g[i]) + comp[i];
        const float y_new = y[i] + adj;
        comp[i] = adj - (y_new - y[i]);
        y[i] = y_new;
      }
      float cp_prev = 0.0f, gp_prev = 0.0f, y_up = 0.0f;
      float yk = y[base];
      for (int k = 0; k < nz; ++k) {
        const long i = base + k * plane;
        const long gi = k * nh + cell;
        const float dl = __ldg(a.f[kDlb] + gi);
        const float du = __ldg(a.f[kDub] + gi);
        const float y_dn = k + 1 < nz ? y[i + plane] : 0.0f;
        float mv = du * (y_dn - yk) + dl * (y_up - yk);
        float b = 1.0f + half_dt * (du + dl);
        if (a.diag_mode != kAbsent) {
          const float d = rate_at(a, a.diag_mode, kDiag, 0, t0 + t, k, cell, nh);
          mv = mv + d * yk;
          b = b - half_dt * d;
        }
        const float lo = -half_dt * dl;
        const float up = -half_dt * du;
        const float denom = b - lo * cp_prev;
        cp_prev = up / denom;
        gp_prev = (dt * mv - lo * gp_prev) / denom;
        f1[i] = cp_prev;
        g[i] = gp_prev;
        y_up = yk;
        yk = y_dn;
      }
      float x_next = 0.0f;
      for (int k = nz - 1; k >= 0; --k) {
        const long i = base + k * plane;
        const float dv = g[i] - f1[i] * x_next;
        const float adj = dv + comp[i];
        const float y_new = y[i] + adj;
        comp[i] = adj - (y_new - y[i]);
        y[i] = y_new;
        x_next = dv;
      }
    }
    __syncthreads();
  }

  // the owned cells back to device memory
  const int oy = y1 - y0, ox = x1 - x0;
  const long owned = (long)oy * ox;
  for (long i = threadIdx.x; i < tracers * nz * owned; i += blockDim.x) {
    const long tk = i / owned;  // t * nz + k
    const long rc = i - tk * owned;
    const int r = (int)(rc / ox);
    const int x = (int)(rc - (long)r * ox);
    const int gy = y0 + r, gx = x0 + x;
    const long li = tk * plane + (long)(gy - tl.lo_y) * tl.lx + (gx - tl.lo_x);
    const long gi = ((long)t0 * nz + tk) * nh + (long)gy * nlon + gx;
    y_out[gi] = y[li];
    c_out[gi] = comp[li];
  }
}

}  // namespace

extern "C" {

const char* transport3d_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dynamic shared memory of one block that loads ly x lx columns of nz
// levels for `tracers` tracers: y, c, f1 and g
long transport3d_block_smem_bytes(int nz, int tracers, int ly, int lx) {
  return 4L * sizeof(float) * tracers * nz * ly * lx;
}

int transport3d_block_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Enqueue one launch on `stream` (a cudaStream_t) of the current device:
// j_steps steps of every tracer on the (t_dim, nz, rows, nlon) window, from
// (y_in, c_in) into (y_out, c_out), which must not alias them.  fields: the
// kSlots operand pointers (null where absent; rates: diag a, diag b, src a,
// src b, t_dim floats each; couple: (t_dim, t_dim)); opts: upwind3,
// diag_mode, src_mode.  A block takes `tracers` tracers (1, or t_dim when
// coupled), tile_y x tile_x owned cells (tile_x >= nlon: the whole nlon)
// and a halo of `halo` >= 4 j_steps cells a side.  Returns
// cudaGetLastError() after the launch.
int transport3d_block_launch(const float* y_in, const float* c_in,
                             float* y_out, float* c_out,
                             const void* const* fields, const int* opts,
                             int t_dim, int nz, int rows, int nlon,
                             int tracers, int tile_y, int tile_x, int halo,
                             int j_steps, float dt, void* stream) {
  Args a;
  for (int slot = 0; slot < kSlots; ++slot)
    a.f[slot] = static_cast<const float*>(fields[slot]);
  a.t_dim = t_dim;
  a.nz = nz;
  a.rows = rows;
  a.nlon = nlon;
  a.upwind3 = opts[0];
  a.diag_mode = opts[1];
  a.src_mode = opts[2];
  const bool full_x = tile_x >= nlon;
  const int ly = rows < tile_y + 2 * halo ? rows : tile_y + 2 * halo;
  const int lx = full_x ? nlon : tile_x + 2 * halo;
  const long smem = transport3d_block_smem_bytes(nz, tracers, ly, lx);
  cudaError_t err = cudaFuncSetAttribute(
      block3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(full_x ? 1 : (nlon + tile_x - 1) / tile_x,
                  (rows + tile_y - 1) / tile_y, t_dim / tracers);
  block3d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      y_in, c_in, y_out, c_out, a, tracers, tile_y, tile_x, halo, j_steps, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
