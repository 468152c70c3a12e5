// One model year of the 3D offline IRF-transport family -- T linear tracers
// on an (nz, nlat, nlon) ocean grid -- on NVIDIA Hopper (sm_90a): kernel B4.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_pallas.py:176
// (build_transport3d_year_pallas).  The scheme is ops/imex.py's, step for
// step: CNh [Heun CNf] x (n-1) Heun CNh (Strang splitting with the interior
// half-steps merged).  The explicit tendency is ops/transport3d.py's
// transport_tend: upwind3 (or centred) advection by the face transports
// t_e/t_n/t_t and lateral diffusion by the conductances cond_e/cond_n,
// periodic in longitude, zero-filled past the grid in latitude and depth,
// with the six upwind3 selectors derived per cell from `wet`; plus the
// explicit source and the optional (T, T) gas-exchange coupling at the
// surface.  Crank-Nicolson vertical mixing with the implicit local rates
// `diag` as their own operand (recovering them from the bands cancels
// catastrophically), in increment form with the right-hand side in flux
// form; both increments are Kahan-compensated float32 adds.  A seasonal
// circulation keeps every month of each seasonal face field and of kv in
// device memory, and each stage interpolates months (m0, m1) with weight w
// from a per-sample table that the wrapper computes with the plain year's
// own arithmetic, so kernel and plain year see the same times.
//
// Design.  The TPU kernel keeps the whole year in one core's VMEM.  At gx3
// (60 x 116 x 100, T = 2) the year's working set is about 58 MB: more than
// the H100's 50 MB L2 and about twice the shared memory of all 132 SMs.  So
// the state, the Kahan carry and the Heun stages stay in device memory, and
// each step is three grid-wide passes, one launch each:
//   (a) tend_kernel<false>: f1 = tend(y), one thread per (tracer, k, j, i),
//       i innermost so loads coalesce;
//   (b) tend_kernel<true>:  f2 = tend(y + dt f1), forming the stage state of
//       every stencil neighbour on the fly (y itself is not written, since
//       neighbouring threads still read it);
//   (c) column_kernel<true>: one thread per (tracer, j, i) column: the Heun
//       update y += dt/2 (f1 + f2) as a Kahan add, then the CN increment
//       solved by Thomas along depth and Kahan-added, in that order, as two
//       separate compensated adds.  The Heun add of level k+1 is done just
//       before the downward sweep needs it; the sweep factors go into the
//       column's f1/f2 entries, already consumed.  Column-local work needs
//       no grid-wide barrier, so the Heun add and the CN solve share a pass.
// The first and last CN half steps are column_kernel<false> (no Heun add)
// with h = dt/2.  The face values, the Kahan add and the CN column solve
// live in csrc/transport3d_common.cuh, shared with the streaming kernel
// B5.  The year's loop over steps is a plain C loop on the host
// that enqueues every launch on PyTorch's current stream: one call from
// Python enqueues 3 n + 1 launches, and their host cost overlaps the device
// work.  Each launch's cudaGetLastError() is checked.
//
// What bounds it on this card.  The work is about 180 float32 operations
// per cell, tracer and step (two tendencies of about 75 each, the Heun add,
// the CN/Thomas solve and two Kahan adds): at gx3 x 2000 steps about
// 5e11, some 8 ms at the H100's 67 TFLOP/s -- the compute bound, since each
// input read once and the output written once move under 50 MB.  This
// simple design is bound instead by memory traffic: each step reads and
// writes the state, its Kahan carry, f1, f2 and the coefficient fields
// several times, on the order of 100+ MB a step, partly from L2.  Cutting
// that traffic -- tiles of the stencil in shared memory, the two tendency
// passes fused over a halo, a persistent kernel with grid-wide syncs or a
// CUDA graph of the step -- is later work.

#include <cuda_runtime.h>

#include "transport3d_common.cuh"

namespace {

using t3d::Sample;
using t3d::face_flux;

constexpr int kThreads = 256;

// operand slots, in the order the wrapper packs their pointers
// (ops/transport3d_cuda.py::_SLOTS); an absent face field is nullptr
enum Slot {
  kWet,       // (nz, nlat, nlon) 0/1
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

struct Args {
  const float* f[kSlots];
  int seasonal[kSlots];  // 1 where the operand carries a month axis
  int t_dim, nz, nlat, nlon;
  int upwind3;
};

// operand `slot` at flat index idx, interpolated between months for a
// seasonal operand (stride: the size of one month); 0 where absent
__device__ inline float coef_at(const Args& a, int slot, long idx, long stride,
                                const Sample& s) {
  return t3d::coef_at(a.f[slot], a.seasonal[slot], idx, stride, s);
}

// f = tend(y) (stage 1) or tend(y + dt f1) (stage 2) + src + couple, at the
// time sample s; one thread per (tracer, k, j, i).  The flux divergence is
// written out here with the neighbours' periodic columns wrapped once per
// cell: a form of it through neighbour accessors measured 2.6% slower a
// step in this pass.
template <bool kStage2>
__global__ void __launch_bounds__(kThreads)
    tend_kernel(const float* __restrict__ y, const float* __restrict__ f1,
                float* __restrict__ out, Args a, float dt, Sample s) {
  const int nz = a.nz, nlat = a.nlat, nlon = a.nlon;
  const long n = (long)nz * nlat * nlon;
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.t_dim * n) return;
  const int t = (int)(gid / n);
  const long cell = gid - t * n;
  const int i = (int)(cell % nlon);
  const int j = (int)((cell / nlon) % nlat);
  const int k = (int)(cell / ((long)nlat * nlon));
  const long base = t * n;
  const float* wet = a.f[kWet];

  // the stage state of tracer q at an on-grid cell
  auto stage = [&](long q_base, long c) -> float {
    float v = __ldg(y + q_base + c);
    if (kStage2) v = v + dt * __ldg(f1 + q_base + c);
    return v;
  };
  auto index = [&](int kk, int jj, int ii) -> long {
    return ((long)kk * nlat + jj) * nlon + ii;
  };
  auto on_grid = [&](int kk, int jj) {
    return kk >= 0 && kk < nz && jj >= 0 && jj < nlat;
  };
  // the stage state times wet, and wet, zero off-grid in depth and
  // latitude; ii is already wrapped
  auto yw = [&](int kk, int jj, int ii) -> float {
    if (!on_grid(kk, jj)) return 0.0f;
    long c = index(kk, jj, ii);
    return stage(base, c) * __ldg(wet + c);
  };
  auto w_at = [&](int kk, int jj, int ii) -> float {
    return on_grid(kk, jj) ? __ldg(wet + index(kk, jj, ii)) : 0.0f;
  };
  auto face = [&](int slot, int kk, int jj, int ii) -> float {
    return coef_at(a, slot, index(kk, jj, ii), n, s);
  };
  auto wrap = [&](int ii) { return ((ii % nlon) + nlon) % nlon; };

  const float y0 = yw(k, j, i);
  float div = 0.0f;

  if (a.f[kTE] != nullptr || a.f[kCondE] != nullptr) {
    const int im2 = wrap(i - 2), im1 = wrap(i - 1), ip1 = wrap(i + 1),
              ip2 = wrap(i + 2);
    const float ym2 = yw(k, j, im2), ym1 = yw(k, j, im1), yp1 = yw(k, j, ip1),
                yp2 = yw(k, j, ip2);
    const float wm2 = w_at(k, j, im2), wm1 = w_at(k, j, im1),
                wp1 = w_at(k, j, ip1), wp2 = w_at(k, j, ip2);
    // west face = east face of i-1: up = i-1, dn = i
    const float flux_w = face_flux(face(kTE, k, j, im1), face(kCondE, k, j, im1),
                                   ym1, y0, ym2, yp1, wm2, wp1, a.upwind3);
    const float flux_e = face_flux(face(kTE, k, j, i), face(kCondE, k, j, i),
                                   y0, yp1, ym1, yp2, wm1, wp2, a.upwind3);
    div = div + flux_w - flux_e;
  }

  if (a.f[kTN] != nullptr || a.f[kCondN] != nullptr) {
    const float ym2 = yw(k, j - 2, i), ym1 = yw(k, j - 1, i),
                yp1 = yw(k, j + 1, i), yp2 = yw(k, j + 2, i);
    const float wm2 = w_at(k, j - 2, i), wm1 = w_at(k, j - 1, i),
                wp1 = w_at(k, j + 1, i), wp2 = w_at(k, j + 2, i);
    // south face = north face of j-1 (none below the first row)
    const float flux_s =
        j > 0 ? face_flux(face(kTN, k, j - 1, i), face(kCondN, k, j - 1, i),
                          ym1, y0, ym2, yp1, wm2, wp1, a.upwind3)
              : 0.0f;
    const float flux_n = face_flux(face(kTN, k, j, i), face(kCondN, k, j, i),
                                   y0, yp1, ym1, yp2, wm1, wp2, a.upwind3);
    div = div + flux_s - flux_n;
  }

  if (a.f[kTT] != nullptr) {
    // the top face of level k couples up = k, dn = k-1, uu = k+1, dd = k-2
    const float ym2 = yw(k - 2, j, i), ym1 = yw(k - 1, j, i),
                yp1 = yw(k + 1, j, i), yp2 = yw(k + 2, j, i);
    const float wm2 = w_at(k - 2, j, i), wm1 = w_at(k - 1, j, i),
                wp1 = w_at(k + 1, j, i), wp2 = w_at(k + 2, j, i);
    const float flux_top = face_flux(face(kTT, k, j, i), 0.0f, y0, ym1, yp1,
                                     ym2, wp1, wm2, a.upwind3);
    // the top face of level k+1 (none below the bottom level)
    const float flux_bot =
        k + 1 < nz ? face_flux(face(kTT, k + 1, j, i), 0.0f, yp1, y0, yp2, ym1,
                               wp2, wm1, a.upwind3)
                   : 0.0f;
    div = div + flux_bot - flux_top;
  }

  float f = div * __ldg(a.f[kRecipVol] + cell) + __ldg(a.f[kSrc] + gid);
  const float* couple = a.f[kCouple];
  if (couple != nullptr && k == 0) {
    float acc = 0.0f;
    for (int q = 0; q < a.t_dim; ++q)
      acc = acc + __ldg(couple + t * a.t_dim + q) * stage(q * n, cell);
    f = f + __ldg(wet + cell) * acc;
  }
  out[gid] = f;
}

// per (tracer, column): kHeun -- the Heun add y += half_dt (f1 + f2) --
// then the CN increment over h at the time sample s, Kahan-added (the
// shared t3d::cn_column).  f1 and f2 take the sweep factors once each
// level's Heun add is done.
template <bool kHeun>
__global__ void __launch_bounds__(kThreads)
    column_kernel(float* y, float* comp, float* f1, float* f2, Args a, float h,
                  float half_dt, Sample s) {
  const int nz = a.nz;
  const long nh = (long)a.nlat * a.nlon;
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.t_dim * nh) return;
  const int t = (int)(gid / nh);
  const long col = gid - t * nh;
  const long base = t * nz * nh + col;  // level k of this column: base + k nh
  const long kv_stride = (long)(nz - 1) * nh;
  const float* diag = a.f[kDiag];

  auto level = [&](long idx) -> float {
    if (kHeun)
      return t3d::kahan_add(y, comp, idx, half_dt * (f1[idx] + f2[idx]));
    return y[idx];
  };
  auto kv_up = [&](int k) -> float {
    return coef_at(a, kKv, k * nh + col, kv_stride, s);
  };
  auto diag_at = [&](int, long idx) -> float { return __ldg(diag + idx); };
  t3d::cn_column(y, comp, f1, f2, base, nh, nz, a.f[kDzR], h, level, kv_up,
                 diag_at);
}

}  // namespace

extern "C" {

const char* transport3d_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueue one year on `stream` (a cudaStream_t) of the current device.
// y holds y0 on entry and the year's end on return; comp must be zero; f1
// and f2 are scratch of y's size.  fields: kSlots operand pointers;
// seasonal: kSlots flags; m0, m1, w: host arrays of the 2 n_steps + 1 time
// samples (sample 0: t0; step i: 1 + 2i at t_i, 2 + 2i at t_i + dt).
// Returns the first launch's cudaGetLastError() that is not 0, else 0.
int transport3d_year_launch(float* y, float* comp, float* f1, float* f2,
                            const void* const* fields, const int* seasonal,
                            const int* m0, const int* m1, const float* w,
                            int t_dim, int nz, int nlat, int nlon, int upwind3,
                            int n_steps, float dt, void* stream) {
  Args a;
  for (int slot = 0; slot < kSlots; ++slot) {
    a.f[slot] = static_cast<const float*>(fields[slot]);
    a.seasonal[slot] = seasonal[slot];
  }
  a.t_dim = t_dim;
  a.nz = nz;
  a.nlat = nlat;
  a.nlon = nlon;
  a.upwind3 = upwind3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long cells = (long)t_dim * nz * nlat * nlon;
  const long cols = (long)t_dim * nlat * nlon;
  const int cell_blocks = (int)((cells + kThreads - 1) / kThreads);
  const int col_blocks = (int)((cols + kThreads - 1) / kThreads);
  const float half_dt = 0.5f * dt;
  auto sample = [&](int q) { return Sample{m0[q], m1[q], w[q]}; };

  column_kernel<false><<<col_blocks, kThreads, 0, st>>>(y, comp, f1, f2, a,
                                                        half_dt, half_dt,
                                                        sample(0));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int step = 0; step < n_steps; ++step) {
    const Sample s_a = sample(1 + 2 * step), s_b = sample(2 + 2 * step);
    tend_kernel<false><<<cell_blocks, kThreads, 0, st>>>(y, nullptr, f1, a,
                                                        dt, s_a);
    tend_kernel<true><<<cell_blocks, kThreads, 0, st>>>(y, f1, f2, a, dt, s_b);
    // CN over dt (merged interior halves), dt/2 after the last Heun
    column_kernel<true><<<col_blocks, kThreads, 0, st>>>(
        y, comp, f1, f2, a, step == n_steps - 1 ? half_dt : dt, half_dt, s_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
