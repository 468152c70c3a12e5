// Device code of the streaming 3D transport year's two passes, shared by
// csrc/transport3d_stream.cu (B5: the whole grid, one launch loop a year)
// and csrc/transport3d_sweep.cu (B6: one latitude slab of a shard, one
// launch loop a sweep).  The design of both passes is in the note at the
// top of csrc/transport3d_stream.cu: (a) heun_tile_kernel, the fused Heun
// step with stage 1 recomputed on a halo, (b) column_kernel, the CN
// increment by Thomas with the Kahan add.  Rows off the grid read as zeros
// and longitude wraps modulo nlon, so a halo-extended slab is just a grid
// of nl_loc + 2 halo rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "transport3d_common.cuh"

namespace {

using t3d::Sample;

constexpr int kTY = 16;                    // tile rows (latitude)
constexpr int kTX = 32;                    // tile columns (longitude)
constexpr int kThreads = kTY * kTX;        // one thread per tile column
constexpr int kRadius = 2;                 // ops/transport3d.py STENCIL_RADIUS
constexpr int kHalo = 2 * kRadius;         // halo of the y tile
constexpr int kWX4 = kTX + 2 * kHalo;      // y tile: 24 x 40
constexpr int kW4 = (kTY + 2 * kHalo) * kWX4;
constexpr int kWX2 = kTX + 2 * kRadius;    // stage-state tile: 20 x 36
constexpr int kW2 = (kTY + 2 * kRadius) * kWX2;
constexpr int kRing = 8;                   // levels per ring, a power of 2
constexpr int kColThreads = 256;

// operand slots, in the order the wrapper packs their pointers
// (ops/transport3d_stream_cuda.py::_SLOTS); an absent operand is nullptr
enum Slot {
  kWet,        // (nz, nlat, nlon) 0/1
  kRecipVol,   // (nz, nlat, nlon) wet / volume, or nullptr when factored
  kRecipArea,  // (nlat, nlon) 1 / TAREA when recip_vol is factored
  kRecipDz,    // (nz,) 1 / dz when recip_vol is factored
  kTE,         // ([n_time,] nz, nlat, nlon) east-face transport
  kTN,         // north-face transport
  kTT,         // top-face transport
  kCondE,      // east-face conductance
  kCondN,      // north-face conductance
  kSt,         // (13, nz, nlat, nlon) stencil coefficients, f32 or bf16
  kKv,         // ([n_time,] nz-1, nlat*nlon) vertical mixing kappa/dz_mid
  kDzR,        // (nz,) 1/dz_m
  kDiag,       // (T, nz, nlat*nlon) dense implicit rates
  kSrc,        // (T, nz, nlat*nlon) dense explicit sources
  kRates,      // (4, T) factored a_diag, b_diag, a_src, b_src
  kCouple,     // (T, T) surface coupling
  kSlots
};

enum Mode { kFlux, kStencilF32, kStencilBF16 };
enum Rate { kNone, kDense, kFactored };

struct Args {
  const void* f[kSlots];
  int seasonal[kSlots];  // 1 where the operand carries a month axis
  int t_dim, nz, nlat, nlon;
  int upwind3, diag_mode, src_mode;
};

__device__ inline const float* fp(const Args& a, int slot) {
  return static_cast<const float*>(a.f[slot]);
}

__device__ inline int face_slot(int f) {
  switch (f) {
    case t3d::kFaceE: return kTE;
    case t3d::kFaceN: return kTN;
    case t3d::kFaceT: return kTT;
    case t3d::kFaceCondE: return kCondE;
    default: return kCondN;
  }
}

__device__ inline float st_at(const float* p, long idx) { return __ldg(p + idx); }
__device__ inline float st_at(const __nv_bfloat16* p, long idx) {
  return __bfloat162float(p[idx]);
}

// stencil_tend at one cell: sum over STENCIL_OFFSETS (dz, dlat, dlon) of
// st[o][cell] * y[cell + o], centre first, in that order
template <typename StT, class YW>
__device__ inline float stencil_sum(const StT* st, long n, long cell,
                                    const YW& yw) {
  float acc = st_at(st, cell) * yw(0, 0, 0);
  acc = acc + st_at(st, 1 * n + cell) * yw(0, 0, 1);
  acc = acc + st_at(st, 2 * n + cell) * yw(0, 0, -1);
  acc = acc + st_at(st, 3 * n + cell) * yw(0, 0, 2);
  acc = acc + st_at(st, 4 * n + cell) * yw(0, 0, -2);
  acc = acc + st_at(st, 5 * n + cell) * yw(0, 1, 0);
  acc = acc + st_at(st, 6 * n + cell) * yw(0, -1, 0);
  acc = acc + st_at(st, 7 * n + cell) * yw(0, 2, 0);
  acc = acc + st_at(st, 8 * n + cell) * yw(0, -2, 0);
  acc = acc + st_at(st, 9 * n + cell) * yw(1, 0, 0);
  acc = acc + st_at(st, 10 * n + cell) * yw(-1, 0, 0);
  acc = acc + st_at(st, 11 * n + cell) * yw(2, 0, 0);
  acc = acc + st_at(st, 12 * n + cell) * yw(-2, 0, 0);
  return acc;
}

// the implicit rate (row 0 of kRates) or explicit source (row 2) of tracer
// t at level k: dense at flat index gidx, or a_t w + b_t w [k == 0] with w
// the cell's wet value
__device__ inline float rate_at(const Args& a, int mode, int dense_slot,
                                int row, int t, int k, long gidx, float w) {
  if (mode == kDense) return __ldg(fp(a, dense_slot) + gidx);
  if (mode == kNone) return 0.0f;
  const float* rates = fp(a, kRates);
  float v = __ldg(rates + row * a.t_dim + t) * w;
  if (k == 0) v = v + __ldg(rates + (row + 1) * a.t_dim + t) * w;
  return v;
}

// tend(y) + src of tracer t at the on-grid cell (k, j, i), i in [0, nlon),
// at the time sample s; yw and w are accessors as t3d::flux_divergence's,
// wc the cell's wet value
template <int kMode, class YW, class W>
__device__ inline float stage_tend(const Args& a, int t, int k, int j, int i,
                                   const YW& yw, const W& w, float wc,
                                   const Sample& s) {
  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon;
  const long nh = (long)nlat * nlon, n = nz * nh;
  const long col = (long)j * nlon + i, cell = k * nh + col;
  float f;
  if constexpr (kMode == kFlux) {
    auto face = [&](int fc, int dk, int dj, int di) -> float {
      const int slot = face_slot(fc);
      const int ii = i + di < 0 ? i + di + nlon : i + di;
      const long idx = ((long)(k + dk) * nlat + (j + dj)) * nlon + ii;
      return t3d::coef_at(fp(a, slot), a.seasonal[slot], idx, n, s);
    };
    const float div = t3d::flux_divergence(
        yw, w, face, a.f[kTE] != nullptr || a.f[kCondE] != nullptr,
        a.f[kTN] != nullptr || a.f[kCondN] != nullptr, a.f[kTT] != nullptr,
        j > 0, k + 1 < nz, a.upwind3);
    const float rv =
        a.f[kRecipVol] != nullptr
            ? __ldg(fp(a, kRecipVol) + cell)
            : wc * (__ldg(fp(a, kRecipDz) + k) * __ldg(fp(a, kRecipArea) + col));
    f = div * rv;
  } else if constexpr (kMode == kStencilF32) {
    f = stencil_sum(fp(a, kSt), n, cell, yw);
  } else {
    f = stencil_sum(static_cast<const __nv_bfloat16*>(a.f[kSt]), n, cell, yw);
  }
  if (a.src_mode != kNone)
    f = f + rate_at(a, a.src_mode, kSrc, 2, t, k, t * n + cell, wc);
  return f;
}

// Heun stage 1 at the on-grid cell (k, j, i) of tracer t: (f1, s * wet)
// with f1 = tend(y) + src + couple(y) and s = y + dt f1
template <int kMode, class YW, class W>
__device__ inline float2 stage1(const Args& a, const float* y_in, int t,
                                int k, int j, int i, const YW& yw, const W& w,
                                float dt, const Sample& s1) {
  const float wc = w(0, 0, 0);
  float f = stage_tend<kMode>(a, t, k, j, i, yw, w, wc, s1);
  const float* couple = fp(a, kCouple);
  if (couple != nullptr && k == 0) {
    const long n = (long)a.nz * a.nlat * a.nlon;
    const long cell = (long)j * a.nlon + i;
    float acc = 0.0f;
    for (int q = 0; q < a.t_dim; ++q)
      acc = acc + __ldg(couple + t * a.t_dim + q) * __ldg(y_in + q * n + cell);
    f = f + wc * acc;
  }
  return make_float2(f, (yw(0, 0, 0) + dt * f) * wc);
}

// pass (a): one Heun step of every tracer on one tile, from y_in into
// y_out, the Kahan carry updated in place (see the note at the top)
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    heun_tile_kernel(const float* __restrict__ y_in, float* __restrict__ y_out,
                     float* __restrict__ comp, Args a, float dt, Sample s1,
                     Sample s2) {
  extern __shared__ float smem[];
  float* yw_ring = smem;                      // kRing x kW4: y * wet
  float* w_ring = yw_ring + kRing * kW4;      // kRing x kW4: wet
  float* s_ring = w_ring + kRing * kW4;       // kRing x kW2: (y + dt f1) wet
  float* f1_ring = s_ring + kRing * kW2;      // kRing x kThreads: f1
  float* surf_s = f1_ring + kRing * kThreads; // T x kThreads (coupled only)

  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon, t_dim = a.t_dim;
  const long n = (long)nz * nlat * nlon;
  const float* wet = fp(a, kWet);
  const float* couple = fp(a, kCouple);
  const float half_dt = 0.5f * dt;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * kTY, i0 = blockIdx.x * kTX;
  auto wrap = [&](int ii) { return ((ii % nlon) + nlon) % nlon; };
  // the grid column of each column of the y tile, wrapped once per block
  __shared__ int col4[kWX4];
  if (tid < kWX4) col4[tid] = wrap(i0 + tid - kHalo);
  __syncthreads();
  // this thread's tile column; columns past nlon (a ragged last tile) hold
  // wrapped copies and are not written
  const int r = tid / kTX, c = tid - r * kTX;
  const int j = j0 + r, i_raw = i0 + c, i = col4[c + kHalo];

  if (couple != nullptr) {
    // the surface stage state of every tracer at this thread's column,
    // read from device memory: stage 2's coupling needs all T of them
    for (int q = 0; q < t_dim; ++q) {
      float sv = 0.0f;
      if (j < nlat) {
        auto at = [&](int dk, int dj, int di) -> long {
          const int kk = dk, jj = j + dj;
          if (kk < 0 || kk >= nz || jj < 0 || jj >= nlat) return -1;
          return ((long)kk * nlat + jj) * nlon + wrap(i + di);
        };
        auto yw = [&](int dk, int dj, int di) -> float {
          const long cc = at(dk, dj, di);
          return cc < 0 ? 0.0f : __ldg(y_in + q * n + cc) * __ldg(wet + cc);
        };
        auto w = [&](int dk, int dj, int di) -> float {
          const long cc = at(dk, dj, di);
          return cc < 0 ? 0.0f : __ldg(wet + cc);
        };
        sv = stage1<kMode>(a, y_in, q, 0, j, i, yw, w, dt, s1).y;
      }
      surf_s[q * kThreads + tid] = sv;
    }
  }

  for (int t = 0; t < t_dim; ++t) {
    const float* y_t = y_in + t * n;
    // levels -2 and -1 lie off the grid: zero in every ring
    for (int idx = tid; idx < 2 * kW4; idx += kThreads) {
      yw_ring[(kRing - 2) * kW4 + idx] = 0.0f;
      w_ring[(kRing - 2) * kW4 + idx] = 0.0f;
    }
    for (int idx = tid; idx < 2 * kW2; idx += kThreads)
      s_ring[(kRing - 2) * kW2 + idx] = 0.0f;

    for (int it = 0; it < nz + 2 * kRadius; ++it) {
      // (1) level `it` of y * wet and wet on the halo-4 tile; zero off the
      // grid in latitude and depth, longitude wrapped
      {
        float* yr = yw_ring + (it & (kRing - 1)) * kW4;
        float* wr = w_ring + (it & (kRing - 1)) * kW4;
        for (int idx = tid; idx < kW4; idx += kThreads) {
          const int rr = idx / kWX4, cc = idx - rr * kWX4;
          const int jj = j0 + rr - kHalo;
          float wv = 0.0f, yv = 0.0f;
          if (it < nz && jj >= 0 && jj < nlat) {
            const long cell = ((long)it * nlat + jj) * nlon + col4[cc];
            wv = __ldg(wet + cell);
            yv = __ldg(y_t + cell) * wv;
          }
          yr[idx] = yv;
          wr[idx] = wv;
        }
      }
      __syncthreads();

      // (2) stage 1 at level m = it - 2 on the halo-2 tile (zero off the
      // grid); f1 kept for the tile's own cells
      const int m = it - kRadius;
      if (m >= 0) {
        float* sr = s_ring + (m & (kRing - 1)) * kW2;
        float* fr = f1_ring + (m & (kRing - 1)) * kThreads;
        for (int idx = tid; idx < kW2; idx += kThreads) {
          const int r2 = idx / kWX2, c2 = idx - r2 * kWX2;
          const int jj = j0 + r2 - kRadius;
          float f1 = 0.0f, sv = 0.0f;
          if (m < nz && jj >= 0 && jj < nlat) {
            const int r4 = r2 + kRadius, c4 = c2 + kRadius;
            auto yw = [&](int dk, int dj, int di) -> float {
              return yw_ring[((m + dk) & (kRing - 1)) * kW4 +
                             (r4 + dj) * kWX4 + c4 + di];
            };
            auto w = [&](int dk, int dj, int di) -> float {
              return w_ring[((m + dk) & (kRing - 1)) * kW4 +
                            (r4 + dj) * kWX4 + c4 + di];
            };
            const float2 st = stage1<kMode>(a, y_in, t, m, jj, col4[c4], yw,
                                            w, dt, s1);
            f1 = st.x;
            sv = st.y;
          }
          sr[idx] = sv;
          const int ri = r2 - kRadius, ci = c2 - kRadius;
          if (ri >= 0 && ri < kTY && ci >= 0 && ci < kTX)
            fr[ri * kTX + ci] = f1;
        }
      }
      __syncthreads();

      // (3) stage 2 and the Heun Kahan add at level k = it - 4 of this
      // thread's column.  The rings' slots of the next iteration's writes
      // (level it + 1, stage level it - 1) are not read here, so no
      // barrier follows.
      const int k = it - 2 * kRadius;
      if (k >= 0 && j < nlat && i_raw < nlon) {
        auto sw = [&](int dk, int dj, int di) -> float {
          return s_ring[((k + dk) & (kRing - 1)) * kW2 +
                        (r + kRadius + dj) * kWX2 + c + kRadius + di];
        };
        auto w = [&](int dk, int dj, int di) -> float {
          return w_ring[((k + dk) & (kRing - 1)) * kW4 +
                        (r + kHalo + dj) * kWX4 + c + kHalo + di];
        };
        const float wc = w(0, 0, 0);
        float f2 = stage_tend<kMode>(a, t, k, j, i, sw, w, wc, s2);
        if (couple != nullptr && k == 0) {
          float acc = 0.0f;
          for (int q = 0; q < t_dim; ++q)
            acc = acc + __ldg(couple + t * t_dim + q) * surf_s[q * kThreads + tid];
          f2 = f2 + wc * acc;
        }
        const float f1 = f1_ring[(k & (kRing - 1)) * kThreads + tid];
        const long idx = t * n + ((long)k * nlat + j) * nlon + i;
        const float adj = half_dt * (f1 + f2) + comp[idx];
        const float y_old = __ldg(y_in + idx);
        const float y_new = y_old + adj;
        comp[idx] = adj - (y_new - y_old);
        y_out[idx] = y_new;
      }
    }
    __syncthreads();  // the next tracer refills the rings
  }
}

// pass (b): per (tracer, column), the CN increment over h at the time
// sample s, Kahan-added in place (t3d::cn_column); the sweep factors go to
// the scratch buffers cp and gp
__global__ void __launch_bounds__(kColThreads)
    column_kernel(float* y, float* comp, float* cp, float* gp, Args a, float h,
                  Sample s) {
  const int nz = a.nz;
  const long nh = (long)a.nlat * a.nlon;
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.t_dim * nh) return;
  const int t = (int)(gid / nh);
  const long col = gid - t * nh;
  const long base = t * nz * nh + col;  // level k of this column: base + k nh
  const long kv_stride = (long)(nz - 1) * nh;
  const float* wet = fp(a, kWet);

  auto level = [&](long idx) -> float { return y[idx]; };
  auto kv_up = [&](int k) -> float {
    return t3d::coef_at(fp(a, kKv), a.seasonal[kKv], k * nh + col, kv_stride, s);
  };
  auto diag_at = [&](int k, long idx) -> float {
    const float w = a.diag_mode == kFactored ? __ldg(wet + k * nh + col) : 0.0f;
    return rate_at(a, a.diag_mode, kDiag, 0, t, k, idx, w);
  };
  t3d::cn_column(y, comp, cp, gp, base, nh, nz, fp(a, kDzR), h, level, kv_up,
                 diag_at);
}

// dynamic shared memory of one pass-(a) block
inline long heun_smem_bytes(int t_dim, int coupled) {
  return (long)sizeof(float) *
         (2L * kRing * kW4 + kRing * kW2 + kRing * kThreads +
          (coupled ? (long)t_dim * kThreads : 0L));
}

typedef void (*HeunKernel)(const float*, float*, float*, Args, float, Sample,
                           Sample);

}  // namespace
