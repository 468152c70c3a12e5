// One model year of the py_driver_2d iage family (a linear 2D tracer year),
// the whole year in one kernel launch, on NVIDIA Hopper (sm_90a).
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::build_iage_year_pallas_v2.
// The scheme is ops/imex.py's, step for step: CNh [Heun CNf] x (n-1) Heun CNh
// (Strang splitting with the interior half-steps merged), Crank-Nicolson
// vertical mixing and the implicit local diagonal in increment form with the
// right-hand side in flux form, the seasonal mixing coefficient kv(t) in
// closed form, advection + lateral diffusion as one fused face flux
// G = ca*y_l + cb*y_r, a per-channel source, and Kahan-compensated float32
// accumulation of every increment.
//
// Design.  Tracer channels never couple (the TPU kernel's lane-packed seams
// carry exact zeros), so one thread block owns one channel: gridDim = T.
// The block keeps the whole year in shared memory -- state y, Kahan buffer,
// Heun stage f1, one scratch field, kv, and every constant field -- and
// touches device memory only to load y0 and the constants and to store the
// result, as the TPU kernel did with VMEM.  Each step is three phases
// separated by __syncthreads():
//   A  (one thread per cell / edge) f1 = tend(y), ys = y + dt f1, and
//      kv(t + dt) on the (nz-1, ny) interior edges;
//   B  (one thread per cell) f2 = tend(ys), Kahan add of dt/2 (f1 + f2);
//   C  (one thread per ypos column) the CN solve.
// The time index is an integer; t = t0 + i dt is recomputed, never summed.
//
// Tridiagonal solve: Thomas, one thread per ypos column.  The column thread
// builds the CN coefficients and the flux-form right-hand side inline while
// it sweeps down, stores the sweep factors in the two scratch fields (free
// during phase C), and fuses the Kahan add into the back substitution, so
// the whole CN phase needs no barrier inside it.  PCR over (nz, ny) threads
// would shorten the 2 nz dependent steps to log2(nz) rounds, but each round
// is a block-wide barrier and needs four more double-buffered fields.
//
// What bounds it on this card: latency and synchronisation per step, not
// bytes or flops.  At T = 2 the launch occupies 2 of 132 SMs, and each of
// the 8760 steps is three barriers plus the 2 nz-long dependent Thomas chain
// on ny threads.  Making it fast -- thread block clusters splitting the
// columns, several channels per block, CUDA graphs around the solver's
// launches -- is later work.
//
// Shared memory holds 5 nz ny + 2 (nz-1) ny + 2 nz (ny-1) + 2 ny + 4 nz - 2
// floats (72,312 bytes at 40 x 50); iage_year_smem_bytes is the one place
// that counts it, and the wrapper checks it against the card's opt-in limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kHeader = 16;  // scalars ahead of the constant fields
constexpr int kFrac = 4;     // breakpoints of the seasonal mixed-layer ramp

// header: bld_min, log_shallow, log_deep, tfrac[kFrac], ffrac[kFrac]
struct Header {
  float bld_min, log_shallow, log_deep;
  float tfrac[kFrac], ffrac[kFrac];
};

__host__ __device__ inline long grid_floats(int nz, int ny) {
  // ca, cb (nz, ny-1); wv (nz-1, ny); dy_r (ny); dz_r (nz); dz_mid,
  // dz_mid_r (nz-1); depth_mid (nz); bld_max (ny)
  return 2L * nz * (ny - 1) + (long)(nz - 1) * ny + 2L * ny + 2L * nz +
         2L * (nz - 1);
}

__host__ __device__ inline long smem_floats(int nz, int ny) {
  // y, comp, f1, ys, diag (nz, ny); kv (nz-1, ny); the constant fields
  return 5L * nz * ny + (long)(nz - 1) * ny + grid_floats(nz, ny);
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

// vertical mixing coefficient / delta_mid on interior edge (k, j) at frac
__device__ inline float kv_edge(int k, int j, int ny, float frac,
                                const Header& h, const Fields& g) {
  float bld = h.bld_min + (g.bld_max[j] - h.bld_min) * frac;
  float x0 = bld - 20.0f;
  float x1 = bld + 20.0f;
  float slope = (h.log_deep - h.log_shallow) / (x1 - x0);
  float e_lo = g.depth_mid[k];
  float e_hi = g.depth_mid[k + 1];
  float e_delta = e_hi - e_lo;
  float num = h.log_shallow * e_delta +
              slope * (antider(e_hi, x0, x1) - antider(e_lo, x0, x1));
  float coeff = expf(num / e_delta);
  float peclet = 0.5f * g.dz_mid[k] * fabsf(g.wv[k * ny + j]) / coeff;
  coeff = coeff * fmaxf(peclet, 1.0f);
  return coeff * g.dz_mid_r[k];
}

__device__ inline void kv_phase(float* kv, float t, int nz, int ny,
                                const Header& h, const Fields& g) {
  float frac = piecewise_frac(t, h);
  for (int e = threadIdx.x; e < (nz - 1) * ny; e += blockDim.x) {
    int k = e / ny;
    kv[e] = kv_edge(k, e - k * ny, ny, frac, h, g);
  }
}

// explicit tendency at cell (k, j): fused lateral flux, vertical advection,
// source
__device__ inline float tend(const float* y, int idx, int k, int j, int nz,
                             int ny, float src, const Fields& g) {
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

// Crank-Nicolson increment over h for every column, Kahan-added into y:
// solve (I - h/2 M) dv = h M y with M = Lz + D, Thomas along depth
__device__ inline void cn_phase(float* y, float* comp, float* cp, float* gp,
                                const float* kv, const float* diag, float h,
                                int nz, int ny, const Fields& g) {
  float half = 0.5f * h;
  for (int j = threadIdx.x; j < ny; j += blockDim.x) {
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
      float d = diag[idx];
      float dmain = -(du + dl) + d;
      float rhs = h * (dzr * (flux_dn - flux_up) + d * yk);
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
}

__global__ void __launch_bounds__(kThreads)
    iage_year_kernel(const float* __restrict__ y0, float* __restrict__ out,
                     const float* __restrict__ fields, int t_dim, int nz,
                     int ny, int n_steps, float t0, float dt) {
  extern __shared__ float smem[];
  const int n = nz * ny;
  const int ch = blockIdx.x;

  Header h;
  h.bld_min = fields[0];
  h.log_shallow = fields[1];
  h.log_deep = fields[2];
  for (int k = 0; k < kFrac; ++k) {
    h.tfrac[k] = fields[3 + k];
    h.ffrac[k] = fields[3 + kFrac + k];
  }
  const float* grid_g = fields + kHeader;
  const long n_grid = grid_floats(nz, ny);
  const float src = grid_g[n_grid + ch];
  const float* diag_g = grid_g + n_grid + t_dim + (long)ch * n;

  float* y = smem;
  float* comp = y + n;
  float* f1 = comp + n;
  float* ys = f1 + n;
  float* diag = ys + n;
  float* kv = diag + n;
  float* grid_s = kv + (nz - 1) * ny;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    y[i] = y0[(long)ch * n + i];
    comp[i] = 0.0f;
    diag[i] = diag_g[i];
  }
  for (long i = threadIdx.x; i < n_grid; i += blockDim.x) grid_s[i] = grid_g[i];
  __syncthreads();
  const Fields g = grid_fields(grid_s, nz, ny);

  kv_phase(kv, t0, nz, ny, h, g);
  __syncthreads();
  cn_phase(y, comp, f1, ys, kv, diag, 0.5f * dt, nz, ny, g);
  __syncthreads();

  const float half_dt = 0.5f * dt;
  for (int step = 0; step < n_steps; ++step) {
    const float t = t0 + (float)step * dt;
    // A: Heun stage 1 and kv for the CN solve at t + dt
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      float f = tend(y, idx, k, idx - k * ny, nz, ny, src, g);
      f1[idx] = f;
      ys[idx] = y[idx] + dt * f;
    }
    kv_phase(kv, t + dt, nz, ny, h, g);
    __syncthreads();
    // B: Heun stage 2 and the compensated explicit update
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      float f2 = tend(ys, idx, k, idx - k * ny, nz, ny, src, g);
      kahan_add(y, comp, idx, half_dt * (f1[idx] + f2));
    }
    __syncthreads();
    // C: CN over dt (merged interior halves), dt/2 after the last Heun
    cn_phase(y, comp, f1, ys, kv, diag, step == n_steps - 1 ? half_dt : dt,
             nz, ny, g);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) out[(long)ch * n + i] = y[i];
}

}  // namespace

extern "C" {

// length of the packed constant buffer the wrapper builds
long iage_year_fields_len(int t_dim, int nz, int ny) {
  return kHeader + grid_floats(nz, ny) + t_dim + (long)t_dim * nz * ny;
}

long iage_year_smem_bytes(int nz, int ny) {
  return smem_floats(nz, ny) * (long)sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int iage_year_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* iage_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// launch on `stream` (a cudaStream_t) of the current device; returns the
// cudaGetLastError() after the launch (0 on success)
int iage_year_launch(const float* y0, float* out, const float* fields,
                     int t_dim, int nz, int ny, int n_steps, float t0,
                     float dt, void* stream) {
  const long smem = iage_year_smem_bytes(nz, ny);
  cudaError_t err = cudaFuncSetAttribute(
      iage_year_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  iage_year_kernel<<<t_dim, kThreads, smem, (cudaStream_t)stream>>>(
      y0, out, fields, t_dim, nz, ny, n_steps, t0, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
