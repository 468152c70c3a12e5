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
// closed form, advection + lateral diffusion as one fused face flux
// G = ca*y_l + cb*y_r, a per-channel source, and Kahan-compensated float32
// accumulation of every increment.  The device code it shares with the
// phosphorus year (csrc/phosphorus_year.cu) lives in csrc/imex_common.cuh.
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
// shortens the 2 nz dependent steps to log2(nz) rounds, but each round is a
// block-wide barrier and needs four more double-buffered fields: that is
// B1v1, below.
//
// What bounds it on this card: latency and synchronisation per step, not
// bytes or flops.  At T = 2 the launch occupies 2 of 132 SMs, and each of
// the 8760 steps is three barriers plus the 2 nz-long dependent Thomas chain
// on ny threads.  Making it fast -- thread block clusters splitting the
// columns, several channels per block, CUDA graphs around the solver's
// launches -- is later work.
//
// B1v1 (kPcr) replaces phase C's Thomas chain by divide-form parallel
// cyclic reduction over all nz x ny cells, one thread a cell: the CN
// coefficients and right-hand side of every cell, then ceil(log2 nz) rounds
// of one barrier each, the a, b, c and r fields double-buffered, then
// x = r / b and the Kahan add.  It asks the card whether log2(nz) barrier
// rounds on nz ny threads beat the 2 nz dependent Thomas steps on ny.
//
// Shared memory holds 5 nz ny + 2 (nz-1) ny + 2 nz (ny-1) + 2 ny + 4 nz - 2
// floats (72,312 bytes at 40 x 50), and B1v1 8 nz ny more (136,312 bytes);
// smem_floats is the one place that counts it, and the wrapper checks it
// against the card's opt-in limit.

#include "imex_common.cuh"

namespace {

using namespace imex;

constexpr int kThreads = 512;

template <bool kPcr>
__host__ __device__ inline long smem_floats(int nz, int ny) {
  // y, comp, f1, ys, diag (nz, ny); kv (nz-1, ny); the constant fields;
  // with kPcr the PCR fields a, b, c, r twice (nz, ny)
  return 5L * nz * ny + (long)(nz - 1) * ny + grid_floats(nz, ny) +
         (kPcr ? 8L * nz * ny : 0L);
}

// the CN increment of every column, Kahan-added into y; f1 and ys serve as
// the Thomas sweep factors (free during phase C)
__device__ inline void cn_phase(float* y, float* comp, float* cp, float* gp,
                                const float* kv, const float* diag, float h,
                                int nz, int ny, const Fields& g) {
  for (int j = threadIdx.x; j < ny; j += blockDim.x)
    cn_column<true>(y, comp, cp, gp, kv, diag, h, j, nz, ny, g);
}

// the CN increment of every cell by divide-form PCR along depth, one thread
// a cell, Kahan-added into y: pcr holds the a, b, c, r fields twice.  The
// arithmetic is ops/imex.py::cn_vertical_increment's with ops/tridiag.py::
// pcr_solve (rows past either end act as identity rows).
__device__ inline void cn_phase_pcr(float* y, float* comp, float* pcr,
                                    const float* kv, const float* diag,
                                    float h, int nz, int ny, const Fields& g) {
  const int n = nz * ny;
  const float half = 0.5f * h;
  // buffer p holds a, b, c, r at pcr + 4 n p + {0, n, 2 n, 3 n}
  float* const a0 = pcr;
  float* const b0 = a0 + n;
  float* const c0 = b0 + n;
  float* const r0 = c0 + n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int k = idx / ny;
    const float dzr = g.dz_r[k];
    const float yk = y[idx];
    float kv_up = 0.0f, kv_lo = 0.0f, flux_dn = 0.0f, flux_up = 0.0f;
    if (k < nz - 1) {
      kv_up = kv[idx];
      flux_dn = kv_up * (y[idx + ny] - yk);
    }
    if (k > 0) {
      kv_lo = kv[idx - ny];
      flux_up = kv_lo * (yk - y[idx - ny]);
    }
    const float du = kv_up * dzr;
    const float dl = kv_lo * dzr;
    const float d = diag[idx];
    const float dmain = -(du + dl) + d;
    a0[idx] = -half * dl;
    b0[idx] = 1.0f - half * dmain;
    c0[idx] = -half * du;
    r0[idx] = h * (dzr * (flux_dn - flux_up) + d * yk);
  }
  __syncthreads();
  int p = 0;
  for (int s = 1; s < nz; s *= 2) {
    const float* in = pcr + 4L * n * p;
    float* out = pcr + 4L * n * (p ^ 1);
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int k = idx / ny;
      float a_m = 0.0f, b_m = 1.0f, c_m = 0.0f, r_m = 0.0f;
      float a_p = 0.0f, b_p = 1.0f, c_p = 0.0f, r_p = 0.0f;
      if (k >= s) {
        const int im = idx - s * ny;
        a_m = in[im];
        b_m = in[n + im];
        c_m = in[2 * n + im];
        r_m = in[3 * n + im];
      }
      if (k + s < nz) {
        const int ip = idx + s * ny;
        a_p = in[ip];
        b_p = in[n + ip];
        c_p = in[2 * n + ip];
        r_p = in[3 * n + ip];
      }
      const float alpha = -in[idx] / b_m;
      const float gamma = -in[2 * n + idx] / b_p;
      out[idx] = alpha * a_m;
      out[2 * n + idx] = gamma * c_p;
      out[n + idx] = in[n + idx] + alpha * c_m + gamma * a_p;
      out[3 * n + idx] = in[3 * n + idx] + alpha * r_m + gamma * r_p;
    }
    __syncthreads();
    p ^= 1;
  }
  const float* fin = pcr + 4L * n * p;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    kahan_add(y, comp, idx, fin[3 * n + idx] / fin[n + idx]);
}

template <bool kPcr>
__global__ void __launch_bounds__(kThreads)
    iage_year_kernel(const float* __restrict__ y0, float* __restrict__ out,
                     const float* __restrict__ fields, int t_dim, int nz,
                     int ny, int n_steps, float t0, float dt) {
  extern __shared__ float smem[];
  const int n = nz * ny;
  const int ch = blockIdx.x;

  const Header h = load_header(fields);
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
  float* pcr = grid_s + grid_floats(nz, ny);  // kPcr only
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    y[i] = y0[(long)ch * n + i];
    comp[i] = 0.0f;
    diag[i] = diag_g[i];
  }
  for (long i = threadIdx.x; i < n_grid; i += blockDim.x) grid_s[i] = grid_g[i];
  __syncthreads();
  const Fields g = grid_fields(grid_s, nz, ny);

  // CN over h: Thomas (B1) or PCR (B1v1)
  auto cn = [&](float h_cn) {
    if constexpr (kPcr) {
      cn_phase_pcr(y, comp, pcr, kv, diag, h_cn, nz, ny, g);
    } else {
      cn_phase(y, comp, f1, ys, kv, diag, h_cn, nz, ny, g);
    }
  };
  kv_phase(kv, t0, nz, ny, h, g);
  __syncthreads();
  cn(0.5f * dt);
  __syncthreads();

  const float half_dt = 0.5f * dt;
  for (int step = 0; step < n_steps; ++step) {
    const float t = t0 + (float)step * dt;
    // A: Heun stage 1 and kv for the CN solve at t + dt
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      float f = transport_tend(y, idx, k, idx - k * ny, nz, ny, src, g);
      f1[idx] = f;
      ys[idx] = y[idx] + dt * f;
    }
    kv_phase(kv, t + dt, nz, ny, h, g);
    __syncthreads();
    // B: Heun stage 2 and the compensated explicit update
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      float f2 = transport_tend(ys, idx, k, idx - k * ny, nz, ny, src, g);
      kahan_add(y, comp, idx, half_dt * (f1[idx] + f2));
    }
    __syncthreads();
    // C: CN over dt (merged interior halves), dt/2 after the last Heun
    cn(step == n_steps - 1 ? half_dt : dt);
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
  return smem_floats<false>(nz, ny) * (long)sizeof(float);
}

// B1v1's shared memory: B1's and the PCR fields
long iage_year_v1_smem_bytes(int nz, int ny) {
  return smem_floats<true>(nz, ny) * (long)sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int iage_year_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* iage_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

namespace {

template <bool kPcr>
int launch(const float* y0, float* out, const float* fields, int t_dim,
           int nz, int ny, int n_steps, float t0, float dt, void* stream) {
  const long smem = smem_floats<kPcr>(nz, ny) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      iage_year_kernel<kPcr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  iage_year_kernel<kPcr><<<t_dim, kThreads, smem, (cudaStream_t)stream>>>(
      y0, out, fields, t_dim, nz, ny, n_steps, t0, dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// launch on `stream` (a cudaStream_t) of the current device; returns the
// cudaGetLastError() after the launch (0 on success)
int iage_year_launch(const float* y0, float* out, const float* fields,
                     int t_dim, int nz, int ny, int n_steps, float t0,
                     float dt, void* stream) {
  return launch<false>(y0, out, fields, t_dim, nz, ny, n_steps, t0, dt,
                       stream);
}

// B1v1: the same year, its CN solves by PCR
int iage_year_v1_launch(const float* y0, float* out, const float* fields,
                        int t_dim, int nz, int ny, int n_steps, float t0,
                        float dt, void* stream) {
  return launch<true>(y0, out, fields, t_dim, nz, ny, n_steps, t0, dt,
                      stream);
}

}  // extern "C"
