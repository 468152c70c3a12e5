// Device code shared by the two 3D transport-year kernels:
// csrc/transport3d_year.cu (B4) and csrc/transport3d_stream.cu (B5).
//
// The explicit tendency is ops/transport3d.py's transport_tend in flux
// form: upwind3 (or centred) advection by the face transports t_e/t_n/t_t
// and lateral diffusion by the conductances cond_e/cond_n, with the six
// upwind3 selectors derived from `wet` (each is a pure shift of it).  B5's
// flux divergence takes its neighbours through accessors that read tiles in
// shared memory or device memory; B4 writes the same divergence out with
// its periodic neighbours wrapped once per cell, which measured faster in
// its instruction-bound tendency passes.  The vertical step, shared by
// both, is the Crank-Nicolson increment of ops/imex.py (flux-form
// right-hand side, Thomas along depth), added with Kahan compensation.

#pragma once

#include <cuda_runtime.h>

namespace t3d {

constexpr float kSixth = 1.0f / 6.0f;

// the months (m0, m1) around one time sample and the weight w of m1
struct Sample {
  int m0, m1;
  float w;
};

// the face fields a flux-form tendency reads; an accessor returns 0 for an
// absent one
enum Face { kFaceE, kFaceN, kFaceT, kFaceCondE, kFaceCondN, kFaces };

// operand p at flat index idx, interpolated between months for a seasonal
// operand (stride: the size of one month); 0 where absent
__device__ inline float coef_at(const float* p, int seasonal, long idx,
                                long stride, const Sample& s) {
  if (p == nullptr) return 0.0f;
  if (!seasonal) return __ldg(p + idx);
  return (1.0f - s.w) * __ldg(p + s.m0 * stride + idx) +
         s.w * __ldg(p + s.m1 * stride + idx);
}

// advective face value for transport `trans` from cell `up` toward `dn`;
// uu and dd are the far cells, selp and seln their wet selectors
__device__ inline float face_value(float trans, float up, float dn, float uu,
                                   float dd, float selp, float seln,
                                   int upwind3) {
  if (!upwind3) return 0.5f * (up + dn);
  float v_pos = selp * kSixth * (-uu + 5.0f * up + 2.0f * dn) + (1.0f - selp) * up;
  float v_neg = seln * kSixth * (2.0f * up + 5.0f * dn - dd) + (1.0f - seln) * dn;
  return trans > 0.0f ? v_pos : v_neg;
}

// advective plus diffusive flux across one face
__device__ inline float face_flux(float trans, float cond, float up, float dn,
                                  float uu, float dd, float selp, float seln,
                                  int upwind3) {
  return trans * face_value(trans, up, dn, uu, dd, selp, seln, upwind3) +
         cond * (up - dn);
}

// The flux divergence at one cell, before recip_vol.  Accessors take
// offsets (dk, dj, di) from the cell: yw(...) the stage state times wet and
// w(...) wet, both 0 off the grid in depth and latitude and periodic in
// longitude; face(f, dk, dj, di) face field f (dk in {0, 1}, dj in {0, -1},
// di in {0, -1}).  The selectors of each face are the wet values of its
// far cells.  south: the cell has a row below it (j > 0); bottom: a level
// below it (k + 1 < nz).
template <class YW, class W, class F>
__device__ inline float flux_divergence(const YW& yw, const W& w, const F& face,
                                        bool has_e, bool has_n, bool has_t,
                                        bool south, bool bottom, int upwind3) {
  const float y0 = yw(0, 0, 0);
  float div = 0.0f;

  if (has_e) {
    const float ym2 = yw(0, 0, -2), ym1 = yw(0, 0, -1), yp1 = yw(0, 0, 1),
                yp2 = yw(0, 0, 2);
    const float wm2 = w(0, 0, -2), wm1 = w(0, 0, -1), wp1 = w(0, 0, 1),
                wp2 = w(0, 0, 2);
    // west face = east face of i-1: up = i-1, dn = i
    const float flux_w = face_flux(face(kFaceE, 0, 0, -1),
                                   face(kFaceCondE, 0, 0, -1), ym1, y0, ym2,
                                   yp1, wm2, wp1, upwind3);
    const float flux_e = face_flux(face(kFaceE, 0, 0, 0),
                                   face(kFaceCondE, 0, 0, 0), y0, yp1, ym1,
                                   yp2, wm1, wp2, upwind3);
    div = div + flux_w - flux_e;
  }

  if (has_n) {
    const float ym2 = yw(0, -2, 0), ym1 = yw(0, -1, 0), yp1 = yw(0, 1, 0),
                yp2 = yw(0, 2, 0);
    const float wm2 = w(0, -2, 0), wm1 = w(0, -1, 0), wp1 = w(0, 1, 0),
                wp2 = w(0, 2, 0);
    // south face = north face of j-1 (none below the first row)
    const float flux_s =
        south ? face_flux(face(kFaceN, 0, -1, 0), face(kFaceCondN, 0, -1, 0),
                          ym1, y0, ym2, yp1, wm2, wp1, upwind3)
              : 0.0f;
    const float flux_n = face_flux(face(kFaceN, 0, 0, 0),
                                   face(kFaceCondN, 0, 0, 0), y0, yp1, ym1,
                                   yp2, wm1, wp2, upwind3);
    div = div + flux_s - flux_n;
  }

  if (has_t) {
    // the top face of level k couples up = k, dn = k-1, uu = k+1, dd = k-2
    const float ym2 = yw(-2, 0, 0), ym1 = yw(-1, 0, 0), yp1 = yw(1, 0, 0),
                yp2 = yw(2, 0, 0);
    const float wm2 = w(-2, 0, 0), wm1 = w(-1, 0, 0), wp1 = w(1, 0, 0),
                wp2 = w(2, 0, 0);
    const float flux_top = face_flux(face(kFaceT, 0, 0, 0), 0.0f, y0, ym1, yp1,
                                     ym2, wp1, wm2, upwind3);
    // the top face of level k+1 (none below the bottom level)
    const float flux_bot =
        bottom ? face_flux(face(kFaceT, 1, 0, 0), 0.0f, yp1, y0, yp2, ym1, wp2,
                           wm1, upwind3)
               : 0.0f;
    div = div + flux_bot - flux_top;
  }
  return div;
}

// one Kahan-compensated add of delta into y[idx]; returns the new y
__device__ inline float kahan_add(float* y, float* comp, long idx, float delta) {
  float adj = delta + comp[idx];
  float y_old = y[idx];
  float y_new = y_old + adj;
  comp[idx] = adj - (y_new - y_old);
  y[idx] = y_new;
  return y_new;
}

// The CN increment over h of one column, Kahan-added: solve
// (I - h/2 M) dv = h M y along depth with M = Lz(kv) + diag (Thomas),
// flux-form right-hand side.  The column's level k sits at base + k nh.
// level(idx) returns the state of a level as the solve first reaches it
// (B4 does its Heun add there); kv_up(k) is the coupling across the
// interface below level k (k < nz - 1); diag_at(k, idx) the implicit local
// rate.  The sweep factors go to cp and gp at the levels' indices.
template <class Level, class Kv, class Diag>
__device__ inline void cn_column(float* y, float* comp, float* cp, float* gp,
                                 long base, long nh, int nz,
                                 const float* dz_r, float h,
                                 const Level& level, const Kv& kv_up_at,
                                 const Diag& diag_at) {
  const float half = 0.5f * h;
  float yk = level(base);
  float cp_prev = 0.0f, gp_prev = 0.0f, kv_lo = 0.0f, flux_up = 0.0f;
  for (int k = 0; k < nz; ++k) {
    const long idx = base + k * nh;
    const float dzr = __ldg(dz_r + k);
    float kv_up = 0.0f, y_dn = 0.0f, flux_dn = 0.0f;
    if (k < nz - 1) {
      kv_up = kv_up_at(k);
      y_dn = level(idx + nh);
      flux_dn = kv_up * (y_dn - yk);
    }
    const float du = kv_up * dzr;  // coupling to the level below
    const float dl = kv_lo * dzr;  // coupling to the level above
    const float d = diag_at(k, idx);
    const float dmain = -(du + dl) + d;
    const float rhs = h * (dzr * (flux_dn - flux_up) + d * yk);
    const float lo = -half * dl;
    const float b = 1.0f - half * dmain;
    const float up = -half * du;
    const float denom = b - lo * cp_prev;
    cp_prev = up / denom;
    gp_prev = (rhs - lo * gp_prev) / denom;
    cp[idx] = cp_prev;
    gp[idx] = gp_prev;
    kv_lo = kv_up;
    flux_up = flux_dn;
    yk = y_dn;
  }
  float x_next = 0.0f;
  for (int k = nz - 1; k >= 0; --k) {
    const long idx = base + k * nh;
    const float x = gp[idx] - cp[idx] * x_next;
    kahan_add(y, comp, idx, x);
    x_next = x;
  }
}

}  // namespace t3d
