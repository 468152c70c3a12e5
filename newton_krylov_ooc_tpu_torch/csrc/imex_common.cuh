// Device code shared by the py_driver_2d kernels, csrc/iage_year.cu (iage,
// B1), csrc/phosphorus_year.cu (phosphorus, B2) and csrc/iage_block.cu (the
// blocked sharded year, B3): the packed scalar header, the constant grid
// fields, the seasonal vertical mixing coefficient kv(t) in closed form,
// the fused transport tendency, the Kahan add, and the float32 Thomas
// column solve of the Crank-Nicolson increment with the Kahan add fused
// into its back substitution (B1, B2).  See the note at the top of each
// kernel.

#pragma once

#include <cuda_runtime.h>

namespace imex {

constexpr int kHeader = 16;  // scalars ahead of the constant fields
constexpr int kFrac = 4;     // breakpoints of the seasonal mixed-layer ramp

// header: bld_min, log_shallow, log_deep, tfrac[kFrac], ffrac[kFrac]
struct Header {
  float bld_min, log_shallow, log_deep;
  float tfrac[kFrac], ffrac[kFrac];
};

__device__ inline Header load_header(const float* fields) {
  Header h;
  h.bld_min = fields[0];
  h.log_shallow = fields[1];
  h.log_deep = fields[2];
  for (int k = 0; k < kFrac; ++k) {
    h.tfrac[k] = fields[3 + k];
    h.ffrac[k] = fields[3 + kFrac + k];
  }
  return h;
}

__host__ __device__ inline long grid_floats(int nz, int ny) {
  // ca, cb (nz, ny-1); wv (nz-1, ny); dy_r (ny); dz_r (nz); dz_mid,
  // dz_mid_r (nz-1); depth_mid (nz); bld_max (ny)
  return 2L * nz * (ny - 1) + (long)(nz - 1) * ny + 2L * ny + 2L * nz +
         2L * (nz - 1);
}

struct Fields {
  const float *ca, *cb, *wv, *dy_r, *dz_r, *dz_mid, *dz_mid_r, *depth_mid,
      *bld_max;
};

__device__ inline Fields grid_fields(const float* base, int nz, int ny) {
  Fields f;
  f.ca = base;
  f.cb = f.ca + nz * (ny - 1);
  f.wv = f.cb + nz * (ny - 1);
  f.dy_r = f.wv + (nz - 1) * ny;
  f.dz_r = f.dy_r + ny;
  f.dz_mid = f.dz_r + nz;
  f.dz_mid_r = f.dz_mid + (nz - 1);
  f.depth_mid = f.dz_mid_r + (nz - 1);
  f.bld_max = f.depth_mid + nz;
  return f;
}

// closed-form piecewise-linear table lookup, flat beyond both ends
__device__ inline float piecewise_frac(float t, const Header& h) {
  float val = h.ffrac[0];
  for (int k = 0; k < kFrac - 1; ++k) {
    float r = (t - h.tfrac[k]) / (h.tfrac[k + 1] - h.tfrac[k]);
    r = fminf(fmaxf(r, 0.0f), 1.0f);
    val = val + (h.ffrac[k + 1] - h.ffrac[k]) * r;
  }
  return val;
}

// integral of (clip(x, x0, x1) - x0): quadratic ramp then linear tail
__device__ inline float antider(float x, float x0, float x1) {
  float c = fminf(fmaxf(x, x0), x1) - x0;
  return 0.5f * c * c + (x1 - x0) * fmaxf(x - x1, 0.0f);
}

// vertical mixing coefficient / delta_mid on interior edge k of a column
// whose mixed-layer maximum is bld_max and vertical velocity at the edge
// wv, at frac; depth_mid, dz_mid, dz_mid_r by level
__device__ inline float kv_value(int k, float bld_max, float wv, float frac,
                                 const Header& h, const float* depth_mid,
                                 const float* dz_mid, const float* dz_mid_r) {
  float bld = h.bld_min + (bld_max - h.bld_min) * frac;
  float x0 = bld - 20.0f;
  float x1 = bld + 20.0f;
  float slope = (h.log_deep - h.log_shallow) / (x1 - x0);
  float e_lo = depth_mid[k];
  float e_hi = depth_mid[k + 1];
  float e_delta = e_hi - e_lo;
  float num = h.log_shallow * e_delta +
              slope * (antider(e_hi, x0, x1) - antider(e_lo, x0, x1));
  float coeff = expf(num / e_delta);
  float peclet = 0.5f * dz_mid[k] * fabsf(wv) / coeff;
  coeff = coeff * fmaxf(peclet, 1.0f);
  return coeff * dz_mid_r[k];
}

// kv_value on interior edge (k, j) of the grid fields g
__device__ inline float kv_edge(int k, int j, int ny, float frac,
                                const Header& h, const Fields& g) {
  return kv_value(k, g.bld_max[j], g.wv[k * ny + j], frac, h, g.depth_mid,
                  g.dz_mid, g.dz_mid_r);
}

// kv at time t on every interior edge, spread over the block's threads
__device__ inline void kv_phase(float* kv, float t, int nz, int ny,
                                const Header& h, const Fields& g) {
  float frac = piecewise_frac(t, h);
  for (int e = threadIdx.x; e < (nz - 1) * ny; e += blockDim.x) {
    int k = e / ny;
    kv[e] = kv_edge(k, e - k * ny, ny, frac, h, g);
  }
}

// explicit transport tendency of one tracer field y at cell (k, j): fused
// lateral flux, vertical advection, plus a constant source
__device__ inline float transport_tend(const float* y, int idx, int k, int j,
                                       int nz, int ny, float src,
                                       const Fields& g) {
  float yc = y[idx];
  int f = k * (ny - 1) + j;  // face index of the (k, j) | (k, j+1) face
  float gl = 0.0f, gr = 0.0f;
  if (j > 0) gl = g.ca[f - 1] * y[idx - 1] + g.cb[f - 1] * yc;
  if (j < ny - 1) gr = g.ca[f] * yc + g.cb[f] * y[idx + 1];
  float res = g.dy_r[j] * (gl - gr);
  float wa = 0.0f, wb = 0.0f;
  if (k > 0) wa = 0.5f * (yc + y[idx - ny]) * g.wv[idx - ny];
  if (k < nz - 1) wb = 0.5f * (y[idx + ny] + yc) * g.wv[idx];
  res = res + g.dz_r[k] * (wb - wa);
  return res + src;
}

__device__ inline void kahan_add(float* y, float* comp, int idx, float delta) {
  float adj = delta + comp[idx];
  float y_old = y[idx];
  float y_new = y_old + adj;
  comp[idx] = adj - (y_new - y_old);
  y[idx] = y_new;
}

// Crank-Nicolson increment over h for column j of one tracer field,
// Kahan-added into y: solve (I - h/2 M) dv = h M y with M = Lz + D along
// depth (Thomas).  kDiag: D is the field `diag`; otherwise D = 0.  cp and
// gp take the sweep factors and must not alias y, comp or kv.
template <bool kDiag>
__device__ inline void cn_column(float* y, float* comp, float* cp, float* gp,
                                 const float* kv, const float* diag, float h,
                                 int j, int nz, int ny, const Fields& g) {
  float half = 0.5f * h;
  float cp_prev = 0.0f, gp_prev = 0.0f;
  float kv_lo = 0.0f, flux_up = 0.0f;
  float yk = y[j];
  for (int k = 0; k < nz; ++k) {
    int idx = k * ny + j;
    float dzr = g.dz_r[k];
    float kv_up = 0.0f, y_dn = 0.0f, flux_dn = 0.0f;
    if (k < nz - 1) {
      kv_up = kv[idx];
      y_dn = y[idx + ny];
      flux_dn = kv_up * (y_dn - yk);
    }
    float du = kv_up * dzr;  // coupling to the layer below
    float dl = kv_lo * dzr;  // coupling to the layer above
    float dmain, rhs;
    if constexpr (kDiag) {
      float d = diag[idx];
      dmain = -(du + dl) + d;
      rhs = h * (dzr * (flux_dn - flux_up) + d * yk);
    } else {
      dmain = -(du + dl);
      rhs = h * (dzr * (flux_dn - flux_up));
    }
    float a = -half * dl;
    float b = 1.0f - half * dmain;
    float c = -half * du;
    float denom = b - a * cp_prev;
    cp_prev = c / denom;
    gp_prev = (rhs - a * gp_prev) / denom;
    cp[idx] = cp_prev;
    gp[idx] = gp_prev;
    kv_lo = kv_up;
    flux_up = flux_dn;
    yk = y_dn;
  }
  float x_next = 0.0f;
  for (int k = nz - 1; k >= 0; --k) {
    int idx = k * ny + j;
    float x = gp[idx] - cp[idx] * x_next;
    kahan_add(y, comp, idx, x);
    x_next = x;
  }
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
inline int smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // namespace imex
