// One model year of the 3D offline IRF-transport family -- T linear tracers
// on an (nz, nlat, nlon) ocean grid -- on NVIDIA Hopper (sm_90a), in one
// persistent cooperative launch: kernel B4.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_pallas.py:176
// (build_transport3d_year_pallas).  The scheme is ops/imex.py's, step for
// step: CNh [Heun CNf] x (n-1) Heun CNh (Strang splitting with the interior
// half-steps merged).  The explicit tendency is ops/transport3d.py's
// transport_tend: upwind3 (or centred) advection by the face transports
// t_e/t_n/t_t and lateral diffusion by the conductances cond_e/cond_n,
// periodic in longitude, zero-filled past the grid in latitude and depth;
// plus the explicit source and the optional (T, T) gas-exchange coupling at
// the surface.  Crank-Nicolson vertical mixing with the implicit local rates
// `diag` as their own operand (recovering them from the bands cancels
// catastrophically), in increment form with the right-hand side in flux
// form; both increments are Kahan-compensated float32 adds.  A seasonal
// circulation keeps every month of each seasonal face field and of kv in
// device memory, and each stage interpolates months (m0, m1) with weight w
// from a per-sample table in device memory that the wrapper computes with
// the plain year's own arithmetic, so kernel and plain year see the same
// times.
//
// What bounds it on this card.  The work is about 200 float32 operations a
// cell, tracer and step (two upwind3 tendencies, the Heun add, the CN solve
// and two Kahan adds): at gx3 (60 x 116 x 100, T = 2) x 2000 steps about
// 5.5e11, 8.2 ms at 67 TFLOP/s -- the bound, since each input read once and
// the output written once move under 50 MB.  The design before this one ran
// each step as three grid-wide launches (two tendency passes of one thread
// a cell with ~30 scattered loads and 64-bit index divisions each, f1 and f2
// through device memory, then a column pass of one thread a column with a
// 120-deep chain of device-memory loads and stores): 207 us a gx3 step.
//
// Design.  One cooperative launch runs the year.  The grid is the card's
// co-resident blocks; each block owns tiles of TY x TX whole columns -- all
// nz levels and all T tracers, since the surface coupling needs every
// tracer of a cell.  A step is two stages, each ended by a grid-wide barrier
// (cooperative_groups::this_grid().sync(), 2 n a year):
//   (1) stage the tile's state and a halo of two columns on each side
//       (latitude zero-filled, longitude periodic) from the state mirror in
//       device memory into shared memory, times the wet mask, reading
//       through L2 only (__ldcg: other blocks wrote it); f1 = tend(y) for the
//       tile's cells from shared memory, f1 kept; the stage state
//       y + dt f1 published to the stage mirror;
//   (2) stage the stage state and its halo the same way; f2; the Heun add
//       y += dt/2 (f1 + f2) (Kahan); the CN increment of each (tracer,
//       column) by Thomas with the column and its sweep factors in shared
//       memory (Kahan); y published to the state mirror.
// The upwind3 selectors and the wet mask come packed, a byte a cell
// (ops/transport3d_stream_cuda.py::pack_selectors), once a built year;
// the face fields, recip_vol, kv, diag and src are read-only, read through
// the cache.  Where every tile fits the grid at once (gx3: 130 tiles of 9 x
// 10 columns, 212 KB), each block keeps its tile's y, Kahan carry and f1 in
// shared memory for the whole year (kResident); otherwise (gx1) the same
// kernel keeps them in device memory and each block walks several tiles a
// stage.  The staging loads are unconditional and unrolled, the cell loops
// step their indices without integer divisions (Radix), and the CN sweep
// loads kv and diag four levels ahead, so that loads overlap.  The
// face values and the Kahan add live in csrc/transport3d_common.cuh, shared
// with B5, B6 and B7.
//
// Where its time goes (cli/profile_phases.py on an H100, 700 W): about
// 150 us a gx3 step, 57% of it the two tendencies (one thread a cell, ~30
// operand loads and six face fluxes; 1024 threads a block at 64 registers
// hide their latency better than 512 at 128, which measured 4% slower),
// 20% the CN sweep (180 columns' chains on 1024 threads), 15% staging the
// regions, 5% the grid barriers.  Walked at gx1, 0.85 ms a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "transport3d_common.cuh"

namespace {

namespace cg = cooperative_groups;
using t3d::Sample;
using t3d::face_flux;

constexpr int kThreads = 1024;

// operand slots, in the order the wrapper packs their pointers
// (ops/transport3d_cuda.py::_SLOTS); an absent face field is nullptr
enum Slot {
  kWet,       // (nz, nlat, nlon) 0/1 (the wrapper's check; sel is read)
  kRecipVol,  // (nz, nlat, nlon) wet / volume
  kTE,        // ([n_time,] nz, nlat, nlon) east-face transport
  kTN,        // north-face transport
  kTT,        // top-face transport
  kCondE,     // east-face conductance
  kCondN,     // north-face conductance
  kKv,        // ([n_time,] nz-1, nlat*nlon) vertical mixing kappa/dz_mid
  kDzR,       // (nz,) 1/dz
  kDiag,      // (T, nz, nlat*nlon) implicit local rates
  kSrc,       // (T, nz, nlat*nlon) explicit sources
  kCouple,    // (T, T) surface coupling, or nullptr
  kSlots
};

// the bits of a selector byte (pack_selectors): the cell's wet value, then
// the far-cell selectors of its east, north and top faces
enum SelBit { kBitWet, kBitPE, kBitNE, kBitPN, kBitNN, kBitPT, kBitNT };

struct Args {
  const float* f[kSlots];
  int seasonal[kSlots];  // 1 where the operand carries a month axis
  const uint8_t* sel;    // (nz, nlat, nlon) packed selectors
  const int *m0, *m1;    // the month table: 2 n_steps + 1 samples
  const float* w;
  float* y;      // (T, nz, nlat, nlon): y0 in, the year's end out; the
                 // state mirror
  float* ys;     // the stage mirror
  float* comp;   // the Kahan carry, f1: device scratch when not resident
  float* f1;
  int t_dim, nz, nlat, nlon, upwind3;
  int ty, tx, tiles_y, tiles_x;  // the tile and the tiles of the grid
  int n_steps;
  float dt;
};

__device__ inline float bit(uint8_t sel, int b) {
  return (float)((sel >> b) & 1);
}

// shared memory: the staged region (T nz (TY+4)(TX+4)), and, resident, y,
// the carry and f1 of the tile (T nz TY TX each), else the sweep factor cp
__host__ __device__ inline long smem_floats(int t_dim, int nz, int ty, int tx,
                                            int resident) {
  const long tile = (long)t_dim * nz * ty * tx;
  return (long)t_dim * nz * (ty + 4) * (tx + 4) + (resident ? 3 : 1) * tile;
}

// A counter in mixed radix (n0, n1, n2, unbounded), least significant
// digit first, that a block's threads step by kThreads: the cell loops
// visit index r = threadIdx.x, threadIdx.x + kThreads, ... without an
// integer division a step.
struct Radix {
  int n0, n1, n2;  // the radices of the three low digits
  int s0, s1, s2, s3;  // the digits of the step kThreads

  __device__ Radix(int r0, int r1, int r2) : n0(r0), n1(r1), n2(r2) {
    split(kThreads, s0, s1, s2, s3);
  }
  __device__ void split(int r, int& d0, int& d1, int& d2, int& d3) const {
    d0 = r % n0;
    r /= n0;
    d1 = r % n1;
    r /= n1;
    d2 = r % n2;
    d3 = r / n2;
  }
  __device__ void step(int& d0, int& d1, int& d2, int& d3) const {
    d0 += s0;
    int c = d0 >= n0;
    d0 -= c ? n0 : 0;
    d1 += s1 + c;
    c = d1 >= n1;
    d1 -= c ? n1 : 0;
    d2 += s2 + c;
    c = d2 >= n2;
    d2 -= c ? n2 : 0;
    d3 += s3 + c;
  }
};

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1) year_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = a.t_dim, nz = a.nz, nlat = a.nlat, nlon = a.nlon;
  const int TY = a.ty, TX = a.tx, TC = TY * TX;
  const int RY = TY + 4, RX = TX + 4;
  const long nh = (long)nlat * nlon, n = nz * nh;
  const int n_tiles = a.tiles_y * a.tiles_x;
  float* region = smem;
  float* tile_s = region + (long)T * nz * RY * RX;
  // resident: y, comp, f1 of the tile; the sweep factor cp goes to f1's
  // place once the Heun add has read it, gp to the region's
  float* y_s = tile_s;
  float* comp_s = y_s + (long)T * nz * TC;
  float* f1_s = comp_s + (long)T * nz * TC;
  float* cp_s = kResident ? f1_s : tile_s;
  float* gp_s = region;
  const float half_dt = 0.5f * a.dt;
  const uint8_t* sel = a.sel;
  auto sample = [&](int q) { return Sample{a.m0[q], a.m1[q], a.w[q]}; };

  // the tile's (t, k, tc) cell: index into the resident arrays or device
  // memory, and its grid column
  auto tile_geom = [&](int tile, int& j0, int& i0, int& th, int& tw) {
    const int ty = tile / a.tiles_x;
    j0 = ty * TY;
    i0 = (tile - ty * a.tiles_x) * TX;
    th = min(TY, nlat - j0);
    tw = min(TX, nlon - i0);
  };
  auto tidx = [&](int t, int k, int tc, long col) -> long {
    return kResident ? ((long)t * nz + k) * TC + tc : t * n + k * nh + col;
  };
  float* yb = kResident ? y_s : a.y;
  float* cb = kResident ? comp_s : a.comp;
  float* fb = kResident ? f1_s : a.f1;

  // stage `src` times wet on the tile's region (two columns a side); the
  // loads are unconditional (latitude clamped, then zeroed off the grid)
  // so that several are in flight at once
  auto stage_region = [&](const float* src, int j0, int i0) {
    const Radix rad(RX, RY, nz);
    int ri, rj, k, t;
    rad.split(threadIdx.x, ri, rj, k, t);
#pragma unroll 4
    for (int r = threadIdx.x; r < T * nz * RY * RX; r += kThreads) {
      const int j = j0 - 2 + rj;
      int i = i0 - 2 + ri;
      i = i < 0 ? i + nlon : (i >= nlon ? i - nlon : i);
      const long c = k * nh + (long)min(max(j, 0), nlat - 1) * nlon + i;
      const float v = __ldcg(src + t * n + c) * bit(__ldg(sel + c), kBitWet);
      region[r] = (j >= 0 && j < nlat) ? v : 0.0f;
      rad.step(ri, rj, k, t);
    }
  };

  // the explicit tendency of tracer t at the tile's cell (k, j, i) from the
  // staged region, at the time sample s (the former tend_kernel's
  // arithmetic, each operand as it had it)
  auto tend = [&](int t, int k, int j, int i, int rj, int ri,
                  const Sample& s) -> float {
    const float* rt = region + (long)t * nz * RY * RX;
    auto yw = [&](int kk, int dj, int di) -> float {
      if (kk < 0 || kk >= nz) return 0.0f;
      return rt[((long)kk * RY + rj + dj) * RX + ri + di];
    };
    auto face = [&](int slot, long idx) -> float {
      return t3d::coef_at(a.f[slot], a.seasonal[slot], idx, n, s);
    };
    // the cell and its west (wrapped), south and lower neighbours
    const long cell = k * nh + (long)j * nlon + i;
    const long west = i == 0 ? cell + nlon - 1 : cell - 1;
    const long south = cell - nlon, below = cell + nh;
    const uint8_t sc = __ldg(sel + cell);
    const float y0 = yw(k, 0, 0);
    float div = 0.0f;
    if (a.f[kTE] != nullptr || a.f[kCondE] != nullptr) {
      const uint8_t sw = __ldg(sel + west);
      const float ym2 = yw(k, 0, -2), ym1 = yw(k, 0, -1), yp1 = yw(k, 0, 1),
                  yp2 = yw(k, 0, 2);
      // west face = east face of i-1: up = i-1, dn = i
      const float flux_w =
          face_flux(face(kTE, west), face(kCondE, west), ym1, y0, ym2, yp1,
                    bit(sw, kBitPE), bit(sw, kBitNE), a.upwind3);
      const float flux_e =
          face_flux(face(kTE, cell), face(kCondE, cell), y0, yp1, ym1, yp2,
                    bit(sc, kBitPE), bit(sc, kBitNE), a.upwind3);
      div = div + flux_w - flux_e;
    }
    if (a.f[kTN] != nullptr || a.f[kCondN] != nullptr) {
      const float ym2 = yw(k, -2, 0), ym1 = yw(k, -1, 0), yp1 = yw(k, 1, 0),
                  yp2 = yw(k, 2, 0);
      // south face = north face of j-1 (none below the first row)
      float flux_s = 0.0f;
      if (j > 0) {
        const uint8_t ss = __ldg(sel + south);
        flux_s = face_flux(face(kTN, south), face(kCondN, south), ym1, y0, ym2,
                           yp1, bit(ss, kBitPN), bit(ss, kBitNN), a.upwind3);
      }
      const float flux_n =
          face_flux(face(kTN, cell), face(kCondN, cell), y0, yp1, ym1, yp2,
                    bit(sc, kBitPN), bit(sc, kBitNN), a.upwind3);
      div = div + flux_s - flux_n;
    }
    if (a.f[kTT] != nullptr) {
      // the top face of level k couples up = k, dn = k-1, uu = k+1, dd = k-2
      const float ym2 = yw(k - 2, 0, 0), ym1 = yw(k - 1, 0, 0),
                  yp1 = yw(k + 1, 0, 0), yp2 = yw(k + 2, 0, 0);
      const float flux_top =
          face_flux(face(kTT, cell), 0.0f, y0, ym1, yp1, ym2, bit(sc, kBitPT),
                    bit(sc, kBitNT), a.upwind3);
      // the top face of level k+1 (none below the bottom level)
      float flux_bot = 0.0f;
      if (k + 1 < nz) {
        const uint8_t sb = __ldg(sel + below);
        flux_bot = face_flux(face(kTT, below), 0.0f, yp1, y0, yp2, ym1,
                             bit(sb, kBitPT), bit(sb, kBitNT), a.upwind3);
      }
      div = div + flux_bot - flux_top;
    }
    float f = div * __ldg(a.f[kRecipVol] + cell) + __ldg(a.f[kSrc] + t * n + cell);
    const float* couple = a.f[kCouple];
    if (couple != nullptr && k == 0) {
      float acc = 0.0f;
      for (int q = 0; q < T; ++q)
        acc = acc + __ldg(couple + t * T + q) *
                        region[((long)q * nz * RY + rj) * RX + ri];
      f = f + bit(sc, kBitWet) * acc;
    }
    return f;
  };

  // the CN increment over h at sample s of every (tracer, column) of the
  // tile, Kahan-added (csrc/transport3d_common.cuh::cn_column's arithmetic
  // with one reciprocal a level; its sweep factors in shared memory, kv and
  // diag loaded four levels at a time, ahead of the sweep)
  auto cn_tile = [&](int j0, int i0, int th, int tw, float h, const Sample& s) {
    const float* kv = a.f[kKv];
    const float* dz_r = a.f[kDzR];
    const float* diag = a.f[kDiag];
    const long kv_stride = (long)(nz - 1) * nh;
    const float half = 0.5f * h;
    for (int r = threadIdx.x; r < T * th * tw; r += kThreads) {
      const int t = r / (th * tw);
      const int rem = r - t * th * tw;
      const int tj = rem / tw, ti = rem - tj * tw;
      const int tc = tj * TX + ti;
      const long col = (long)(j0 + tj) * nlon + i0 + ti;
      const long base = tidx(t, 0, tc, col);
      const long stride = kResident ? TC : nh;
      const long sbase = (long)t * nz * TC + tc;  // sweep factors
      float yk = yb[base];
      float cp_prev = 0.0f, gp_prev = 0.0f, kv_lo = 0.0f, flux_up = 0.0f;
      for (int k0 = 0; k0 < nz; k0 += 4) {
        float kvq[4], dq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = min(k0 + q, nz - 1);
          const float kvv =
              t3d::coef_at(kv, a.seasonal[kKv], min(k, nz - 2) * nh + col,
                           kv_stride, s);
          kvq[q] = k < nz - 1 ? kvv : 0.0f;
          dq[q] = __ldg(diag + t * n + k * nh + col);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q;
          if (k >= nz) break;
          const long idx = base + k * stride;
          const float dzr = __ldg(dz_r + k);
          const float kv_up = kvq[q];
          float y_dn = 0.0f, flux_dn = 0.0f;
          if (k < nz - 1) {
            y_dn = yb[idx + stride];
            flux_dn = kv_up * (y_dn - yk);
          }
          const float du = kv_up * dzr;
          const float dl = kv_lo * dzr;
          const float d = dq[q];
          const float dmain = -(du + dl) + d;
          const float rhs = h * (dzr * (flux_dn - flux_up) + d * yk);
          const float lo = -half * dl;
          const float b = 1.0f - half * dmain;
          const float up = -half * du;
          const float inv = 1.0f / (b - lo * cp_prev);
          cp_prev = up * inv;
          gp_prev = (rhs - lo * gp_prev) * inv;
          cp_s[sbase + k * TC] = cp_prev;
          gp_s[sbase + k * TC] = gp_prev;
          kv_lo = kv_up;
          flux_up = flux_dn;
          yk = y_dn;
        }
      }
      float x_next = 0.0f;
#pragma unroll 4
      for (int k = nz - 1; k >= 0; --k) {
        const float x = gp_s[sbase + k * TC] - cp_s[sbase + k * TC] * x_next;
        t3d::kahan_add(yb, cb, base + k * stride, x);
        x_next = x;
      }
    }
  };

  // each (t, k, tj, ti) cell of a th x tw tile, one a thread in turn
  auto cells = [&](int th, int tw, auto&& fn) {
    const Radix rad(tw, th, nz);
    int ti, tj, k, t;
    rad.split(threadIdx.x, ti, tj, k, t);
    for (int r = threadIdx.x; r < T * nz * th * tw; r += kThreads) {
      fn(t, k, tj, ti);
      rad.step(ti, tj, k, t);
    }
  };
  // publish the resident tile's y to the state mirror
  auto publish = [&](int j0, int i0, int th, int tw) {
    cells(th, tw, [&](int t, int k, int tj, int ti) {
      const long col = (long)(j0 + tj) * nlon + i0 + ti;
      __stcg(a.y + t * n + k * nh + col, y_s[tidx(t, k, tj * TX + ti, col)]);
    });
  };

  // the first CN half step (sample 0); resident tiles load y, zero carry
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int j0, i0, th, tw;
    tile_geom(tile, j0, i0, th, tw);
    if (kResident) {
      cells(th, tw, [&](int t, int k, int tj, int ti) {
        const long col = (long)(j0 + tj) * nlon + i0 + ti;
        const long idx = tidx(t, k, tj * TX + ti, col);
        y_s[idx] = a.y[t * n + k * nh + col];
        comp_s[idx] = 0.0f;
      });
      __syncthreads();
    }
    cn_tile(j0, i0, th, tw, half_dt, sample(0));
    __syncthreads();
    if (kResident) publish(j0, i0, th, tw);
  }
  grid.sync();

  for (int step = 0; step < a.n_steps; ++step) {
    const Sample s_a = sample(1 + 2 * step), s_b = sample(2 + 2 * step);
    // (1) f1 = tend(y); the stage state y + dt f1 to the stage mirror
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int j0, i0, th, tw;
      tile_geom(tile, j0, i0, th, tw);
      stage_region(a.y, j0, i0);
      __syncthreads();
      cells(th, tw, [&](int t, int k, int tj, int ti) {
        const int j = j0 + tj, i = i0 + ti;
        const long col = (long)j * nlon + i;
        const long idx = tidx(t, k, tj * TX + ti, col);
        const float f = tend(t, k, j, i, tj + 2, ti + 2, s_a);
        fb[idx] = f;
        __stcg(a.ys + t * n + k * nh + col, yb[idx] + a.dt * f);
      });
      __syncthreads();
    }
    grid.sync();
    // (2) f2 = tend(y + dt f1); the Heun add; CN over dt (dt/2 after the
    // last Heun); y to the state mirror
    const float h = step == a.n_steps - 1 ? half_dt : a.dt;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int j0, i0, th, tw;
      tile_geom(tile, j0, i0, th, tw);
      stage_region(a.ys, j0, i0);
      __syncthreads();
      cells(th, tw, [&](int t, int k, int tj, int ti) {
        const int j = j0 + tj, i = i0 + ti;
        const long idx = tidx(t, k, tj * TX + ti, (long)j * nlon + i);
        const float f2 = tend(t, k, j, i, tj + 2, ti + 2, s_b);
        t3d::kahan_add(yb, cb, idx, half_dt * (fb[idx] + f2));
      });
      __syncthreads();
      cn_tile(j0, i0, th, tw, h, s_b);
      __syncthreads();
      if (kResident) publish(j0, i0, th, tw);
    }
    if (step + 1 < a.n_steps) grid.sync();
  }
}

const void* kernel_for(int resident) {
  return resident ? (const void*)year_kernel<true>
                  : (const void*)year_kernel<false>;
}

}  // namespace

extern "C" {

const char* transport3d_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dynamic shared memory of one block for tiles of ty x tx columns
long transport3d_year_smem_bytes(int t_dim, int nz, int ty, int tx,
                                 int resident) {
  return smem_floats(t_dim, nz, ty, tx, resident) * (long)sizeof(float);
}

int transport3d_year_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// blocks of the (resident or walking) kernel that fit on one SM at once
// with `smem` bytes of dynamic shared memory, into *out
int transport3d_year_occupancy(int resident, long smem, int* out) {
  const void* fn = kernel_for(resident);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                            (size_t)smem);
}

// One cooperative launch of `grid` blocks on `stream` (a cudaStream_t) of
// the current device: the whole year.  y holds y0 on entry and the year's
// end on return; ys is scratch of y's size; comp (zeroed) and f1 are
// scratch of y's size when not resident, else unused.  fields: kSlots
// operand pointers; seasonal: kSlots flags (host); sel: the packed
// selectors; m0, m1, w: the 2 n_steps + 1 time samples in device memory
// (sample 0: t0; step i: 1 + 2i at t_i, 2 + 2i at t_i + dt).  tile (ty,
// tx) columns; a resident launch needs a block for every tile.  Returns
// the launch's CUDA error or 0.
int transport3d_year_launch(float* y, float* ys, float* comp, float* f1,
                            const void* const* fields, const int* seasonal,
                            const void* sel, const int* m0, const int* m1,
                            const float* w, int t_dim, int nz, int nlat,
                            int nlon, int upwind3, int ty, int tx,
                            int resident, int grid, int n_steps, float dt,
                            void* stream) {
  Args a;
  for (int slot = 0; slot < kSlots; ++slot) {
    a.f[slot] = static_cast<const float*>(fields[slot]);
    a.seasonal[slot] = seasonal[slot];
  }
  a.sel = static_cast<const uint8_t*>(sel);
  a.m0 = m0;
  a.m1 = m1;
  a.w = w;
  a.y = y;
  a.ys = ys;
  a.comp = comp;
  a.f1 = f1;
  a.t_dim = t_dim;
  a.nz = nz;
  a.nlat = nlat;
  a.nlon = nlon;
  a.upwind3 = upwind3;
  a.ty = ty;
  a.tx = tx;
  a.tiles_y = (nlat + ty - 1) / ty;
  a.tiles_x = (nlon + tx - 1) / tx;
  a.n_steps = n_steps;
  a.dt = dt;
  if (n_steps < 1 || (resident && grid < a.tiles_y * a.tiles_x))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(resident);
  const long smem = transport3d_year_smem_bytes(t_dim, nz, ty, tx, resident);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
