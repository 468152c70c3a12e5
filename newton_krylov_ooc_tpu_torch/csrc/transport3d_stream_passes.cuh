// Device code of the fused 3D transport step, shared by
// csrc/transport3d_stream.cu (B5: the whole grid, one launch a step),
// csrc/transport3d_sweep.cu (B6: one latitude slab of a shard, one launch a
// step) and csrc/transport3d_block.cu (B7: k steps of every shard of a card
// in one cooperative launch).  One step of one tile -- Heun(dt) then
// CN(h) -- is tile_step(); the design is in the note at the top of
// csrc/transport3d_stream.cu.  Rows off the grid read as zeros and
// longitude wraps modulo nlon, so a halo-extended slab is just a grid of
// nl_loc + 2 halo rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "transport3d_common.cuh"

namespace {

using t3d::Sample;

// tiles of 16 x 32 columns, one thread a column, two blocks an SM (64
// registers a thread)
constexpr int kTY = 16;                    // tile rows (latitude)
constexpr int kTX = 32;                    // tile columns (longitude)
constexpr int kThreads = kTY * kTX;        // one thread per tile column
constexpr int kMinBlocks = 2;              // blocks an SM, for the launch bounds
constexpr int kRadius = 2;                 // ops/transport3d.py STENCIL_RADIUS
constexpr int kHalo = 2 * kRadius;         // halo of the y tile
constexpr int kRY = kTY + 2 * kHalo;       // y tile: 24 x 40
constexpr int kWX4 = kTX + 2 * kHalo;
constexpr int kW4 = kRY * kWX4;
constexpr int kRY2 = kTY + 2 * kRadius;    // stage-state tile: 20 x 36
constexpr int kWX2 = kTX + 2 * kRadius;
constexpr int kW2 = kRY2 * kWX2;
constexpr int kRing = 8;                   // levels per ring, a power of 2
constexpr int kF1Ring = 4;                 // f1 lives two levels
// the face tiles: stage 1's east faces of columns -1 .. kWX2-1 of the
// stage-state tile and its north faces of rows -1 .. kRY2-1; stage 2's of
// the tile
constexpr int kFE1 = kRY2 * (kWX2 + 1);
constexpr int kFN1 = (kRY2 + 1) * kWX2;
constexpr int kFE2 = kTY * (kTX + 1);
constexpr int kFN2 = (kTY + 1) * kTX;
// stage 1 takes at most two cells of the stage-state tile a thread
static_assert(kW2 <= 2 * kThreads, "the stage-state tile outgrows the block");

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
  kSel,        // (nz, nlat, nlon) uint8: wet and the six upwind3 selectors
  kDlb,        // (nz, nlat, nlon) CN band to the level above (B7), or null
  kDub,        // (nz, nlat, nlon) CN band to the level below (B7), or null
  kSlots
};

// the bits of a kSel byte (ops/transport3d_stream_cuda.py::pack_selectors):
// the cell's wet value, then the far-cell selectors of its east, north and
// top faces (sel3p_e, sel3n_e, sel3p_n, sel3n_n, sel3p_t, sel3n_t)
enum SelBit { kBitWet, kBitPE, kBitNE, kBitPN, kBitNN, kBitPT, kBitNT };

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

__device__ inline float bit(uint8_t sel, int b) {
  return (float)((sel >> b) & 1);
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

// recip_vol at cell (k, col), read or rebuilt from its factors
__device__ inline float recip_vol(const Args& a, int k, long col, long cell,
                                  float wc) {
  return a.f[kRecipVol] != nullptr
             ? __ldg(fp(a, kRecipVol) + cell)
             : wc * (__ldg(fp(a, kRecipDz) + k) * __ldg(fp(a, kRecipArea) + col));
}

// face field `slot` at flat (level, row, column) index idx: interpolated
// between months when seasonal, 0 when absent
__device__ inline float face_coef(const Args& a, int slot, long idx,
                                  const Sample& s) {
  const long n = (long)a.nz * a.nlat * a.nlon;
  return t3d::coef_at(fp(a, slot), a.seasonal[slot], idx, n, s);
}

// the flux across the east (kDir 0) or north (kDir 1) face of the cell at
// level k, grid row j, grid column i (wrapped), from the state values of
// the four cells along the face's direction (uu, up, dn, dd) and the
// cell's selector byte
template <int kDir>
__device__ inline float lateral_flux(const Args& a, int k, int j, int i,
                                     float uu, float up, float dn, float dd,
                                     uint8_t sel, const Sample& s) {
  const long idx = ((long)k * a.nlat + j) * a.nlon + i;
  constexpr int ts = kDir == 0 ? kTE : kTN, cs = kDir == 0 ? kCondE : kCondN;
  constexpr int bp = kDir == 0 ? kBitPE : kBitPN;
  constexpr int bn = kDir == 0 ? kBitNE : kBitNN;
  return t3d::face_flux(face_coef(a, ts, idx, s), face_coef(a, cs, idx, s),
                        up, dn, uu, dd, bit(sel, bp), bit(sel, bn), a.upwind3);
}

// the flux across the top face of level k (k < nz) at grid row j, column
// i: up = level k, dn = k - 1, uu = k + 1, dd = k - 2
__device__ inline float top_flux(const Args& a, int k, int j, int i, float dd,
                                 float dn, float up, float uu, uint8_t sel,
                                 const Sample& s) {
  const long idx = ((long)k * a.nlat + j) * a.nlon + i;
  return t3d::face_flux(face_coef(a, kTT, idx, s), 0.0f, up, dn, uu, dd,
                        bit(sel, kBitPT), bit(sel, kBitNT), a.upwind3);
}

// -- asynchronous staging of the depth rings -------------------------------

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage level `lev` of tracer field y_t and of the selector bytes on the
// halo-4 tile into ring slots yr and sr; zero off the grid in latitude and
// depth, longitude through col4.  With nlon a multiple of 4 the state
// moves in 16-byte cp.async.cg chunks (through L2: in a persistent launch
// other blocks rewrite it between steps) and the bytes in 4-byte chunks,
// asynchronously; otherwise by plain loads.
__device__ inline void stage_level(const Args& a, const float* y_t,
                                   const uint8_t* sel, int lev, int j0,
                                   const int* col4, float* yr, uint8_t* sr) {
  const int nlat = a.nlat, nlon = a.nlon;
  const bool in_z = lev >= 0 && lev < a.nz;
  if ((nlon & 3) == 0) {
    for (int q = threadIdx.x; q < kRY * (kWX4 / 4); q += kThreads) {
      const int rr = q / (kWX4 / 4), cc = 4 * (q - rr * (kWX4 / 4));
      const int jj = j0 + rr - kHalo;
      const bool ok = in_z && jj >= 0 && jj < nlat;
      const long cell = ok ? ((long)lev * nlat + jj) * nlon + col4[cc] : 0;
      cp_async16(yr + rr * kWX4 + cc, y_t + cell, ok);
      cp_async4(sr + rr * kWX4 + cc, sel + cell, ok);
    }
    cp_async_commit();
  } else {
    for (int idx = threadIdx.x; idx < kW4; idx += kThreads) {
      const int rr = idx / kWX4, cc = idx - rr * kWX4;
      const int jj = j0 + rr - kHalo;
      float yv = 0.0f;
      uint8_t sv = 0;
      if (in_z && jj >= 0 && jj < nlat) {
        const long cell = ((long)lev * nlat + jj) * nlon + col4[cc];
        yv = __ldcg(y_t + cell);
        sv = __ldg(sel + cell);
      }
      yr[idx] = yv;
      sr[idx] = sv;
    }
  }
}

// -- the CN column solve, fused into the march ------------------------------

// One column's forward elimination of the CN(h) solve, fed one level at a
// time as the Heun step finishes it: push(k + 1) eliminates level k, whose
// Heun state and carry it holds, and writes them to y_out and comp and the
// sweep factors gp and cp to device memory; finish() eliminates the bottom
// level.  kBand: B7's arithmetic on the bands dlb, dub (right-hand side
// du (y_dn - y) + dl (y_up - y)); otherwise t3d::cn_column's flux form on
// kv and dz_r.
template <bool kBand>
struct ColumnSweep {
  float cp_prev, gp_prev, kv_lo, flux_up, y_up;
  float yk, ck;  // the held level's Heun state and Kahan carry
  int k;         // the held level, -1 before the first

  __device__ void start() {
    cp_prev = gp_prev = kv_lo = flux_up = y_up = 0.0f;
    k = -1;
  }

  // between levels the march keeps the sweep in shared memory (kSweepState
  // floats for each thread), so that it holds no registers while the
  // stages compute
  static constexpr int kSweepState = 8;
  __device__ void load(const float* st) {
    const float* p = st + threadIdx.x;
    cp_prev = p[0];
    gp_prev = p[kThreads];
    kv_lo = p[2 * kThreads];
    flux_up = p[3 * kThreads];
    y_up = p[4 * kThreads];
    yk = p[5 * kThreads];
    ck = p[6 * kThreads];
    k = (int)p[7 * kThreads];
  }
  __device__ void store(float* st) const {
    float* p = st + threadIdx.x;
    p[0] = cp_prev;
    p[kThreads] = gp_prev;
    p[2 * kThreads] = kv_lo;
    p[3 * kThreads] = flux_up;
    p[4 * kThreads] = y_up;
    p[5 * kThreads] = yk;
    p[6 * kThreads] = ck;
    p[7 * kThreads] = (float)k;
  }

  __device__ void eliminate(const Args& a, int t, long col, float y_dn,
                            float h, const Sample& s, float* cp_s, float* gp,
                            float* y_out, float* comp) {
    const int nz = a.nz;
    const long nh = (long)a.nlat * a.nlon, n = nz * nh;
    const long cell = k * nh + col, idx = t * n + cell;
    const float half = 0.5f * h;
    const float wk = a.diag_mode == kFactored ? __ldg(fp(a, kWet) + cell) : 0.0f;
    float rhs, lo, b, up;
    if constexpr (kBand) {
      const float dl = __ldg(fp(a, kDlb) + cell);
      const float du = __ldg(fp(a, kDub) + cell);
      float mv = du * (y_dn - yk) + dl * (y_up - yk);
      b = 1.0f + half * (du + dl);
      if (a.diag_mode != kNone) {
        const float d = rate_at(a, a.diag_mode, kDiag, 0, t, k, idx, wk);
        mv = mv + d * yk;
        b = b - half * d;
      }
      rhs = h * mv;
      lo = -half * dl;
      up = -half * du;
    } else {
      const float dzr = __ldg(fp(a, kDzR) + k);
      float kv_up = 0.0f, flux_dn = 0.0f;
      if (k < nz - 1) {
        kv_up = t3d::coef_at(fp(a, kKv), a.seasonal[kKv], k * nh + col,
                             (long)(nz - 1) * nh, s);
        flux_dn = kv_up * (y_dn - yk);
      }
      const float du = kv_up * dzr;
      const float dl = kv_lo * dzr;
      const float d = rate_at(a, a.diag_mode, kDiag, 0, t, k, idx, wk);
      const float dmain = -(du + dl) + d;
      rhs = h * (dzr * (flux_dn - flux_up) + d * yk);
      lo = -half * dl;
      b = 1.0f - half * dmain;
      up = -half * du;
      kv_lo = kv_up;
      flux_up = flux_dn;
    }
    const float denom = b - lo * cp_prev;
    cp_prev = up / denom;
    gp_prev = (rhs - lo * gp_prev) / denom;
    cp_s[idx] = cp_prev;
    gp[idx] = gp_prev;
    y_out[idx] = yk;
    comp[idx] = ck;
    y_up = yk;
  }

  // level k + 1 is done with Heun state y1 and carry c1
  __device__ void push(const Args& a, int t, long col, float y1, float c1,
                       float h, const Sample& s, float* cp_s, float* gp,
                       float* y_out, float* comp) {
    if (k >= 0) eliminate(a, t, col, y1, h, s, cp_s, gp, y_out, comp);
    yk = y1;
    ck = c1;
    ++k;
  }

  __device__ void finish(const Args& a, int t, long col, float h,
                         const Sample& s, float* cp_s, float* gp,
                         float* y_out, float* comp) {
    eliminate(a, t, col, 0.0f, h, s, cp_s, gp, y_out, comp);
  }
};

// the back substitution up one column, each increment Kahan-added to the
// Heun state and carry the elimination left in y_out and comp
__device__ inline void back_substitute(const Args& a, int t, long col,
                                       float* cp_s, const float* gp,
                                       float* y_out, float* comp) {
  const long nh = (long)a.nlat * a.nlon, n = a.nz * nh;
  float x_next = 0.0f;
  for (int k = a.nz - 1; k >= 0; --k) {
    const long idx = t * n + k * nh + col;
    const float x = gp[idx] - cp_s[idx] * x_next;
    t3d::kahan_add(y_out, comp, idx, x);
    x_next = x;
  }
}

// the floats each thread of a tile_step block keeps in shared memory
// between levels: the column sweep's state and the carried top faces (two
// of stage 1's, one of stage 2's)
constexpr int kCarries = ColumnSweep<false>::kSweepState + 3;

// the shared memory of one tile_step block, in floats: the rings, the face
// tiles, the carries and, when coupled, the surface stage states of every
// tracer
__host__ __device__ inline long step_smem_floats(int t_dim, int coupled) {
  return kRing * kW4 + kRing * kW4 / 4 + kRing * kW2 + kF1Ring * kThreads +
         kFE1 + kFN1 + kFE2 + kFN2 + kCarries * kThreads +
         (coupled ? (long)t_dim * kThreads : 0L);
}

// Heun stage 1 at the on-grid cell (k, j, i) of tracer t from accessors:
// (f1, s * wet) with f1 = tend(y) + src + couple(y) and s = y + dt f1.
// The flux form gets its divergence from `div`, the stencil forms sum
// their 13 offsets of yw.
template <int kMode, class YW>
__device__ inline float2 stage1_cell(const Args& a, const float* y_in, int t,
                                     int k, int j, int i, const YW& yw,
                                     float wc, float div, float dt,
                                     const Sample& s1) {
  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon;
  const long nh = (long)nlat * nlon, n = nz * nh;
  const long col = (long)j * nlon + i, cell = k * nh + col;
  float f;
  if constexpr (kMode == kFlux) {
    f = div * recip_vol(a, k, col, cell, wc);
  } else if constexpr (kMode == kStencilF32) {
    f = stencil_sum(fp(a, kSt), n, cell, yw);
  } else {
    f = stencil_sum(static_cast<const __nv_bfloat16*>(a.f[kSt]), n, cell, yw);
  }
  if (a.src_mode != kNone)
    f = f + rate_at(a, a.src_mode, kSrc, 2, t, k, t * n + cell, wc);
  const float* couple = fp(a, kCouple);
  if (couple != nullptr && k == 0) {
    float acc = 0.0f;
    for (int q = 0; q < a.t_dim; ++q)
      acc = acc + __ldg(couple + t * a.t_dim + q) * __ldcg(y_in + q * n + col);
    f = f + wc * acc;
  }
  return make_float2(f, (yw(0, 0, 0) + dt * f) * wc);
}

// the flux divergence at cell (k, j, i), each of its six faces computed
// here (iw: the column west of i, wrapped); yw(dk, dj, di) and
// sb(dk, dj, di) read the state times wet and the selector byte at offsets
// from the cell, zero off the grid
template <class YW, class SB>
__device__ inline float cell_divergence(const Args& a, int k, int j, int i,
                                        int iw, const YW& yw, const SB& sb,
                                        const Sample& s) {
  float div = 0.0f;
  if (a.f[kTE] != nullptr || a.f[kCondE] != nullptr) {
    const float fw = lateral_flux<0>(a, k, j, iw, yw(0, 0, -2), yw(0, 0, -1),
                                     yw(0, 0, 0), yw(0, 0, 1), sb(0, 0, -1),
                                     s);
    const float fe = lateral_flux<0>(a, k, j, i, yw(0, 0, -1), yw(0, 0, 0),
                                     yw(0, 0, 1), yw(0, 0, 2), sb(0, 0, 0),
                                     s);
    div = div + fw - fe;
  }
  if (a.f[kTN] != nullptr || a.f[kCondN] != nullptr) {
    const float fs = j > 0 ? lateral_flux<1>(a, k, j - 1, i, yw(0, -2, 0),
                                             yw(0, -1, 0), yw(0, 0, 0),
                                             yw(0, 1, 0), sb(0, -1, 0), s)
                           : 0.0f;
    const float fn = lateral_flux<1>(a, k, j, i, yw(0, -1, 0), yw(0, 0, 0),
                                     yw(0, 1, 0), yw(0, 2, 0), sb(0, 0, 0),
                                     s);
    div = div + fs - fn;
  }
  if (a.f[kTT] != nullptr) {
    const float ft = top_flux(a, k, j, i, yw(-2, 0, 0), yw(-1, 0, 0),
                              yw(0, 0, 0), yw(1, 0, 0), sb(0, 0, 0), s);
    const float fb = k + 1 < a.nz
                         ? top_flux(a, k + 1, j, i, yw(-1, 0, 0), yw(0, 0, 0),
                                    yw(1, 0, 0), yw(2, 0, 0), sb(1, 0, 0), s)
                         : 0.0f;
    div = div + fb - ft;
  }
  return div;
}

// the surface stage state of tracer q at grid column (j, i), every operand
// from device memory (a coupled step's stage 2 needs all T of them)
template <int kMode>
__device__ inline float surface_stage(const Args& a, const float* y_in, int q,
                                      int j, int i, float dt,
                                      const Sample& s1) {
  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon;
  const long n = (long)nz * nlat * nlon;
  const uint8_t* sel = static_cast<const uint8_t*>(a.f[kSel]);
  auto wrap = [&](int ii) { return ((ii % nlon) + nlon) % nlon; };
  auto at = [&](int kk, int jj, int ii) -> long {
    if (kk < 0 || kk >= nz || jj < 0 || jj >= nlat) return -1;
    return ((long)kk * nlat + jj) * nlon + wrap(ii);
  };
  auto yw = [&](int dk, int dj, int di) -> float {
    const long cc = at(dk, j + dj, i + di);
    return cc < 0 ? 0.0f : __ldcg(y_in + q * n + cc) * bit(__ldg(sel + cc), kBitWet);
  };
  auto sb = [&](int dk, int dj, int di) -> uint8_t {
    const long cc = at(dk, j + dj, i + di);
    return cc < 0 ? (uint8_t)0 : __ldg(sel + cc);
  };
  const float wc = bit(sb(0, 0, 0), kBitWet);
  float div = 0.0f;
  if constexpr (kMode == kFlux)
    div = cell_divergence(a, 0, j, wrap(i), wrap(i - 1), yw, sb, s1);
  return stage1_cell<kMode>(a, y_in, q, 0, j, wrap(i), yw, wc, div, dt, s1).y;
}

// One step of every tracer on the tile whose first grid row and column are
// (j0, i0): Heun(dt) from y_in (stage 1 at s1, stage 2 and the CN at s2),
// then CN(h); the state lands in y_out and the Kahan carry is updated in
// place.  kHeun false: CN(h) alone, in place on y_out (y_in unused).  gp:
// device scratch of two states (the sweep factors gp, then cp); smem: at
// least step_smem_floats(...) floats.  Every thread of the block calls it.
template <int kMode, bool kBand, bool kHeun>
__device__ void tile_step(const Args& a, const float* y_in, float* y_out,
                          float* comp, float* gp, int j0, int i0, float dt,
                          float h, Sample s1, Sample s2, float* smem,
                          int* col4) {
  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon, t_dim = a.t_dim;
  const long nh = (long)nlat * nlon, n = nz * nh;
  const int tid = threadIdx.x;
  const int r = tid / kTX, c = tid - r * kTX;
  const int j = j0 + r, i_raw = i0 + c;
  const bool own = j < nlat && i_raw < nlon;
  const int i = i_raw < nlon ? i_raw : i_raw % nlon;
  const long col = (long)j * nlon + i;

  // the sweep factor cp: the second state of the gp scratch
  float* cp_s = gp + (long)t_dim * n;

  if constexpr (!kHeun) {
    for (int t = 0; t < t_dim; ++t) {
      if (own) {
        ColumnSweep<kBand> cs;
        cs.start();
        for (int k = 0; k < nz; ++k) {
          const long idx = t * n + k * nh + col;
          cs.push(a, t, col, y_out[idx], comp[idx], h, s2, cp_s, gp, y_out,
                  comp);
        }
        cs.finish(a, t, col, h, s2, cp_s, gp, y_out, comp);
        back_substitute(a, t, col, cp_s, gp, y_out, comp);
      }
    }
    return;
  }

  float* y_ring = smem;                            // y
  float* s_ring = y_ring + kRing * kW4;            // kRing x kW2
  float* f1_ring = s_ring + kRing * kW2;           // kF1Ring x kThreads
  float* fe1 = f1_ring + kF1Ring * kThreads;       // stage 1 east faces
  float* fn1 = fe1 + kFE1;                         // stage 1 north faces
  float* fe2 = fn1 + kFN1;                         // stage 2 east faces
  float* fn2 = fe2 + kFE2;                         // stage 2 north faces
  float* sweep_s = fn2 + kFN2;                     // the column sweeps
  float* top_s = sweep_s + (kCarries - 3) * kThreads;  // carried top faces
  float* surf_s = top_s + 3 * kThreads;            // T x kThreads (coupled)
  uint8_t* sel_ring = reinterpret_cast<uint8_t*>(surf_s + (fp(a, kCouple) ? t_dim * kThreads : 0));

  const uint8_t* sel = static_cast<const uint8_t*>(a.f[kSel]);
  const float* couple = fp(a, kCouple);
  const float half_dt = 0.5f * dt;
  const bool has_e = a.f[kTE] != nullptr || a.f[kCondE] != nullptr;
  const bool has_n = a.f[kTN] != nullptr || a.f[kCondN] != nullptr;
  const bool has_t = a.f[kTT] != nullptr;

  __syncthreads();  // the previous tile's readers of col4 and the rings
  if (tid < kWX4) col4[tid] = ((i0 + tid - kHalo) % nlon + nlon) % nlon;
  __syncthreads();

  if (couple != nullptr) {
    for (int q = 0; q < t_dim; ++q)
      surf_s[q * kThreads + tid] =
          j < nlat ? surface_stage<kMode>(a, y_in, q, j, i, dt, s1) : 0.0f;
  }

  // the state and selectors of the y tile at level k (zero off the grid)
  auto yw_at = [&](int lev, int rr, int cc) -> float {
    const int slot = (lev & (kRing - 1)) * kW4 + rr * kWX4 + cc;
    return y_ring[slot] * bit(sel_ring[slot], kBitWet);
  };
  auto sel_at = [&](int lev, int rr, int cc) -> uint8_t {
    return sel_ring[(lev & (kRing - 1)) * kW4 + rr * kWX4 + cc];
  };
  auto s_at = [&](int lev, int rr, int cc) -> float {
    return s_ring[(lev & (kRing - 1)) * kW2 + rr * kWX2 + cc];
  };

  for (int t = 0; t < t_dim; ++t) {
    const float* y_t = y_in + t * n;
    __syncthreads();  // the previous tracer's last readers of the rings
    // levels -2 and -1 lie off the grid: zero in every ring
    for (int idx = tid; idx < 2 * kW4; idx += kThreads) {
      y_ring[(kRing - 2) * kW4 + idx] = 0.0f;
      sel_ring[(kRing - 2) * kW4 + idx] = 0;
    }
    for (int idx = tid; idx < 2 * kW2; idx += kThreads)
      s_ring[(kRing - 2) * kW2 + idx] = 0.0f;
    stage_level(a, y_t, sel, 0, j0, col4, y_ring, sel_ring);

    {
      ColumnSweep<kBand> cs;
      cs.start();
      cs.store(sweep_s);
    }

    for (int it = 0; it < nz + 2 * kRadius; ++it) {
      cp_async_wait_all();
      __syncthreads();
      // level it + 1 streams in while this iteration computes
      {
        const int nx = it + 1;
        stage_level(a, y_t, sel, nx, j0, col4,
                    y_ring + (nx & (kRing - 1)) * kW4,
                    sel_ring + (nx & (kRing - 1)) * kW4);
      }
      const int m = it - kRadius;      // stage 1's level
      const int k = it - 2 * kRadius;  // stage 2's level

      // (A) the lateral faces, each once: stage 1's at level m on the
      // stage-state tile, stage 2's at level k on the tile
      if constexpr (kMode == kFlux) {
        if (m >= 0 && m < nz) {
          if (has_e) {
            for (int q = tid; q < kFE1; q += kThreads) {
              const int r2 = q / (kWX2 + 1), c2 = q - r2 * (kWX2 + 1) - 1;
              const int jj = j0 + r2 - kRadius;
              const int r4 = r2 + kRadius, c4 = c2 + kRadius;  // owner cell
              float fl = 0.0f;
              if (jj >= 0 && jj < nlat)
                fl = lateral_flux<0>(a, m, jj, col4[c4], yw_at(m, r4, c4 - 1),
                                  yw_at(m, r4, c4), yw_at(m, r4, c4 + 1),
                                  yw_at(m, r4, c4 + 2), sel_at(m, r4, c4), s1);
              fe1[q] = fl;
            }
          }
          if (has_n) {
            for (int q = tid; q < kFN1; q += kThreads) {
              const int r2 = q / kWX2 - 1, c2 = q - (r2 + 1) * kWX2;
              const int jj = j0 + r2 - kRadius;
              const int r4 = r2 + kRadius, c4 = c2 + kRadius;
              float fl = 0.0f;
              if (jj >= 0 && jj < nlat)
                fl = lateral_flux<1>(a, m, jj, col4[c4], yw_at(m, r4 - 1, c4),
                                  yw_at(m, r4, c4), yw_at(m, r4 + 1, c4),
                                  yw_at(m, r4 + 2, c4), sel_at(m, r4, c4), s1);
              fn1[q] = fl;
            }
          }
        }
        if (k >= 0 && k < nz) {
          if (has_e) {
            for (int q = tid; q < kFE2; q += kThreads) {
              const int rt = q / (kTX + 1), ct = q - rt * (kTX + 1) - 1;
              const int jj = j0 + rt;
              const int r2 = rt + kRadius, c2 = ct + kRadius;
              float fl = 0.0f;
              if (jj < nlat)
                fl = lateral_flux<0>(a, k, jj, col4[c2 + kRadius],
                                  s_at(k, r2, c2 - 1), s_at(k, r2, c2),
                                  s_at(k, r2, c2 + 1), s_at(k, r2, c2 + 2),
                                  sel_at(k, r2 + kRadius, c2 + kRadius), s2);
              fe2[q] = fl;
            }
          }
          if (has_n) {
            for (int q = tid; q < kFN2; q += kThreads) {
              const int rt = q / kTX - 1, ct = q - (rt + 1) * kTX;
              const int jj = j0 + rt;
              const int r2 = rt + kRadius, c2 = ct + kRadius;
              float fl = 0.0f;
              if (jj >= 0 && jj < nlat)
                fl = lateral_flux<1>(a, k, jj, col4[c2 + kRadius],
                                  s_at(k, r2 - 1, c2), s_at(k, r2, c2),
                                  s_at(k, r2 + 1, c2), s_at(k, r2 + 2, c2),
                                  sel_at(k, r2 + kRadius, c2 + kRadius), s2);
              fn2[q] = fl;
            }
          }
        }
        __syncthreads();
      }

      // (B) stage 1 at level m on the stage-state tile (zero off the
      // grid); f1 kept for the tile's own cells
      if (m >= 0) {
        float* sr = s_ring + (m & (kRing - 1)) * kW2;
        float* fr = f1_ring + (m & (kF1Ring - 1)) * kThreads;
        for (int u = 0; u < 2; ++u) {
          const int idx = tid + u * kThreads;
          if (idx >= kW2) break;
          const int r2 = idx / kWX2, c2 = idx - r2 * kWX2;
          const int jj = j0 + r2 - kRadius;
          const int r4 = r2 + kRadius, c4 = c2 + kRadius;
          float f1 = 0.0f, sv = 0.0f;
          if (m < nz && jj >= 0 && jj < nlat) {
            auto yw = [&](int dk, int dj, int di) -> float {
              return yw_at(m + dk, r4 + dj, c4 + di);
            };
            float div = 0.0f;
            if constexpr (kMode == kFlux) {
              const int fe = r2 * (kWX2 + 1) + c2 + 1;  // east face slot
              if (has_e) div = div + fe1[fe - 1] - fe1[fe];
              if (has_n) {
                const int fn = (r2 + 1) * kWX2 + c2;  // north face slot
                div = div + (jj > 0 ? fn1[fn - kWX2] : 0.0f) - fn1[fn];
              }
              if (has_t) {
                // the top face of level m carried, the one below computed
                const float ft = m == 0 ? top_flux(a, 0, jj, col4[c4], 0.0f,
                                                   0.0f, yw(0, 0, 0),
                                                   yw(1, 0, 0),
                                                   sel_at(0, r4, c4), s1)
                                        : top_s[u * kThreads + tid];
                const float fb = m + 1 < nz
                                     ? top_flux(a, m + 1, jj, col4[c4],
                                                yw(-1, 0, 0), yw(0, 0, 0),
                                                yw(1, 0, 0), yw(2, 0, 0),
                                                sel_at(m + 1, r4, c4), s1)
                                     : 0.0f;
                div = div + fb - ft;
                top_s[u * kThreads + tid] = fb;
              }
            }
            const float2 st =
                stage1_cell<kMode>(a, y_in, t, m, jj, col4[c4], yw,
                                   bit(sel_at(m, r4, c4), kBitWet), div, dt,
                                   s1);
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

      // (C) stage 2 and the Heun Kahan add at level k of this thread's
      // column, then the column's CN elimination one level behind
      if (k >= 0 && own) {
        const int r2 = r + kRadius, c2 = c + kRadius;
        auto sw = [&](int dk, int dj, int di) -> float {
          return s_at(k + dk, r2 + dj, c2 + di);
        };
        const uint8_t sc = sel_at(k, r2 + kRadius, c2 + kRadius);
        const float wc = bit(sc, kBitWet);
        const long cell = k * nh + col;
        float f2;
        if constexpr (kMode == kFlux) {
          float div = 0.0f;
          const int fe = r * (kTX + 1) + c + 1;
          if (has_e) div = div + fe2[fe - 1] - fe2[fe];
          if (has_n) {
            const int fn = (r + 1) * kTX + c;
            div = div + (j > 0 ? fn2[fn - kTX] : 0.0f) - fn2[fn];
          }
          if (has_t) {
            const float ft = k == 0 ? top_flux(a, 0, j, i, 0.0f, 0.0f,
                                               sw(0, 0, 0), sw(1, 0, 0), sc,
                                               s2)
                                    : top_s[2 * kThreads + tid];
            const float fb =
                k + 1 < nz ? top_flux(a, k + 1, j, i, sw(-1, 0, 0),
                                      sw(0, 0, 0), sw(1, 0, 0), sw(2, 0, 0),
                                      sel_at(k + 1, r2 + kRadius, c2 + kRadius),
                                      s2)
                           : 0.0f;
            div = div + fb - ft;
            top_s[2 * kThreads + tid] = fb;
          }
          f2 = div * recip_vol(a, k, col, cell, wc);
        } else if constexpr (kMode == kStencilF32) {
          f2 = stencil_sum(fp(a, kSt), n, cell, sw);
        } else {
          f2 = stencil_sum(static_cast<const __nv_bfloat16*>(a.f[kSt]), n,
                           cell, sw);
        }
        if (a.src_mode != kNone)
          f2 = f2 + rate_at(a, a.src_mode, kSrc, 2, t, k, t * n + cell, wc);
        if (couple != nullptr && k == 0) {
          float acc = 0.0f;
          for (int q = 0; q < t_dim; ++q)
            acc = acc + __ldg(couple + t * t_dim + q) * surf_s[q * kThreads + tid];
          f2 = f2 + wc * acc;
        }
        const float f1 = f1_ring[(k & (kF1Ring - 1)) * kThreads + tid];
        const long idx = t * n + cell;
        const float adj = half_dt * (f1 + f2) + comp[idx];
        const float y_old = y_ring[(k & (kRing - 1)) * kW4 +
                                   (r + kHalo) * kWX4 + c + kHalo];
        const float y_new = y_old + adj;
        ColumnSweep<kBand> cs;
        cs.load(sweep_s);
        cs.push(a, t, col, y_new, adj - (y_new - y_old), h, s2, cp_s, gp,
                y_out, comp);
        if (k == nz - 1) {
          cs.finish(a, t, col, h, s2, cp_s, gp, y_out, comp);
          back_substitute(a, t, col, cp_s, gp, y_out, comp);
        } else {
          cs.store(sweep_s);
        }
      }
    }
    cp_async_wait_all();
  }
}

// the dynamic shared memory of one fused-step block (step_kernel's or
// B7's) in bytes; the CN-only launch takes none
__host__ __device__ inline long step_smem_bytes(int t_dim, int coupled) {
  return (long)sizeof(float) * step_smem_floats(t_dim, coupled);
}

// one step (kHeun) or the CN alone on every tile of the grid, one block a
// tile: B5's and B6's launch
template <int kMode, bool kHeun>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    step_kernel(const float* y_in, float* y_out, float* comp,
                float* gp, Args a, float dt, float h, Sample s1, Sample s2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int col4[kWX4];
  tile_step<kMode, false, kHeun>(a, y_in, y_out, comp, gp, blockIdx.y * kTY,
                                 blockIdx.x * kTX, dt, h, s1, s2, smem, col4);
}

typedef void (*StepKernel)(const float*, float*, float*, float*, Args, float,
                           float, Sample, Sample);

// the step kernel of a mode (opts[0]) and its shared memory, set as its
// opt-in limit, and the CN-only kernel; returns a CUDA error or 0
inline int step_kernels(int mode, int t_dim, int coupled, StepKernel* heun,
                        StepKernel* cn, int* smem_heun) {
  *heun = mode == kStencilBF16  ? step_kernel<kStencilBF16, true>
          : mode == kStencilF32 ? step_kernel<kStencilF32, true>
                                : step_kernel<kFlux, true>;
  *cn = step_kernel<kFlux, false>;
  *smem_heun = (int)step_smem_bytes(t_dim, coupled);
  return (int)cudaFuncSetAttribute(
      *heun, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_heun);
}

inline Args make_args(const void* const* fields, const int* seasonal,
                      const int* opts, int t_dim, int nz, int nlat,
                      int nlon) {
  Args a;
  for (int slot = 0; slot < kSlots; ++slot) {
    a.f[slot] = fields[slot];
    a.seasonal[slot] = seasonal[slot];
  }
  a.t_dim = t_dim;
  a.nz = nz;
  a.nlat = nlat;
  a.nlon = nlon;
  a.upwind3 = opts[1];
  a.diag_mode = opts[2];
  a.src_mode = opts[3];
  return a;
}

}  // namespace
