// Device code shared by the 3D transport kernels: csrc/transport3d_year.cu
// (B4) and the fused step of csrc/transport3d_stream_passes.cuh (B5, B6,
// B7).
//
// The explicit tendency is ops/transport3d.py's transport_tend in flux
// form: upwind3 (or centred) advection by the face transports t_e/t_n/t_t
// and lateral diffusion by the conductances cond_e/cond_n, with the six
// upwind3 selectors of `wet` (each is a pure shift of it).  Both kernels
// build their divergence from face_flux: B4 per cell with its periodic
// neighbours wrapped once, the fused step once per face from tiles in
// shared memory.  B4's vertical step is cn_column below, the
// Crank-Nicolson increment of ops/imex.py (flux-form right-hand side,
// Thomas along depth) added with Kahan compensation; the fused step runs
// the same arithmetic as it marches down the depth.

#pragma once

#include <cuda_runtime.h>

namespace t3d {

constexpr float kSixth = 1.0f / 6.0f;

// the months (m0, m1) around one time sample and the weight w of m1
struct Sample {
  int m0, m1;
  float w;
};

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
