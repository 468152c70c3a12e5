// One model year of the py_driver_2d phosphorus module (po4, dop, pop: a
// coupled, nonlinear 3-tracer 2D year), the whole year in one kernel launch,
// on NVIDIA Hopper (sm_90a).
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::
// build_phosphorus_year_pallas.  The scheme is ops/imex.py's, step for step:
// CNh [Heun CNf] x (n-1) Heun CNh (Strang splitting with the interior
// half-steps merged).  Crank-Nicolson vertical mixing in increment form with
// a flux-form right-hand side on each tracer (no implicit diagonal); the
// seasonal kv(t) in closed form; lateral advection + diffusion as the fused
// face flux ca*y_l + cb*y_r and vertical advection; and, explicit in the
// Heun half, Michaelis-Menten uptake mu L po4 / (po4 + K) into dop and pop,
// DOP and POP remineralisation back to po4, and POP sinking with a
// zero-flux bottom.  Every increment is Kahan-accumulated in float32.  The
// device code shared with the iage year (B1) is in csrc/imex_common.cuh.
//
// Design.  Unlike B1's channels, the three tracers couple through the
// per-cell biogeochemistry, so ONE thread block owns the whole 3-tracer
// state and keeps the year in shared memory: y, the Kahan buffer, Heun
// stage f1 and state ys for all three tracers, the light limitation, kv and
// every constant field.  Device memory is touched only to load y0 and the
// constants and to store the result.  Each step is three phases separated
// by __syncthreads():
//   A  (one thread per cell) f1 and ys = y + dt f1 of all three tracers, and
//      kv(t + dt) on the (nz-1, ny) interior edges;
//   B  (one thread per cell) f2 = tend(ys), Kahan add of dt/2 (f1 + f2);
//   C  (one thread per (tracer, ypos column), 3 ny threads) the CN solve,
//      Thomas with the Kahan add fused into the back substitution; the f1
//      and ys buffers hold the sweep factors.
// Sinking stays conservative because each cell thread computes both the
// flux entering from the layer above and the flux it loses to the layer
// below from the same stage's pop, so what leaves row k enters row k+1.
// The time index is an integer; t = t0 + i dt is recomputed, never summed.
//
// What bounds it on this card: latency and synchronisation per step, as
// for B1.  The launch occupies 1 of 132 SMs; each step is three barriers and
// a 2 nz-long dependent Thomas chain on 3 ny threads.  Splitting the tracers
// or the columns over a thread block cluster (distributed shared memory) is
// later work.
//
// Shared memory holds 13 nz ny + 2 (nz-1) ny + 2 nz (ny-1) + 2 ny + 4 nz - 2
// floats (136,312 bytes at 40 x 50); phosphorus_year_smem_bytes is the one
// place that counts it, and the wrapper checks it against the card's
// opt-in limit.

#include "imex_common.cuh"

namespace {

using namespace imex;

constexpr int kThreads = 512;
constexpr int kTracers = 3;  // po4, dop, pop
constexpr int kParams = 8;   // scalars between the header and the grid fields

// params: po4_halfsat, max_uptake_rate, sigma, 1 - sigma, dop_remin_rate,
// pop_remin_rate, pop_sink_vel, padding
struct Params {
  float halfsat, max_uptake, sigma, one_minus_sigma, dop_remin, pop_remin,
      sink_vel;
};

__device__ inline Params load_params(const float* base) {
  Params p;
  p.halfsat = base[0];
  p.max_uptake = base[1];
  p.sigma = base[2];
  p.one_minus_sigma = base[3];
  p.dop_remin = base[4];
  p.pop_remin = base[5];
  p.sink_vel = base[6];
  return p;
}

__host__ __device__ inline long smem_floats(int nz, int ny) {
  // y, comp, f1, ys (3, nz, ny); light (nz, ny); kv (nz-1, ny); the
  // constant fields
  return (4L * kTracers + 1) * nz * ny + (long)(nz - 1) * ny +
         grid_floats(nz, ny);
}

struct Tend3 {
  float po4, dop, pop;
};

// explicit tendency of all three tracers at cell (k, j) of the state y
// (3, nz, ny): transport plus the local terms, in the plain year's order
__device__ inline Tend3 tend3(const float* y, int idx, int k, int j, int nz,
                              int ny, const float* light, const Params& p,
                              const Fields& g) {
  const int n = nz * ny;
  float po4 = y[idx], dop = y[n + idx], pop = y[2 * n + idx];
  float d_po4 = transport_tend(y, idx, k, j, nz, ny, 0.0f, g);
  float d_dop = transport_tend(y + n, idx, k, j, nz, ny, 0.0f, g);
  float d_pop = transport_tend(y + 2 * n, idx, k, j, nz, ny, 0.0f, g);

  float uptake = p.max_uptake * light[idx] * po4 / (po4 + p.halfsat);
  float dop_remin = p.dop_remin * dop;
  float pop_remin = p.pop_remin * pop;
  Tend3 out;
  out.po4 = d_po4 - uptake + dop_remin + pop_remin;
  out.dop = d_dop + p.sigma * uptake - dop_remin;
  d_pop = d_pop + p.one_minus_sigma * uptake - pop_remin;

  // sinking: in from the layer above, out to the layer below, none out of
  // the bottom layer
  float sink_in = 0.0f, sink_out = 0.0f;
  if (k > 0) sink_in = p.sink_vel * y[2 * n + idx - ny];
  if (k < nz - 1) sink_out = p.sink_vel * pop;
  out.pop = d_pop + g.dz_r[k] * (sink_in - sink_out);
  return out;
}

// the CN increment of every (tracer, column), Kahan-added into y
__device__ inline void cn_phase(float* y, float* comp, float* cp, float* gp,
                                const float* kv, float h, int nz, int ny,
                                const Fields& g) {
  const int n = nz * ny;
  for (int item = threadIdx.x; item < kTracers * ny; item += blockDim.x) {
    int tr = item / ny;
    int off = tr * n;
    cn_column<false>(y + off, comp + off, cp + off, gp + off, kv, nullptr, h,
                     item - tr * ny, nz, ny, g);
  }
}

// one block a launch (and 136 KB of shared memory an SM): ptxas may use
// every register 512 threads can have
__global__ void __launch_bounds__(kThreads, 1)
    phosphorus_year_kernel(const float* __restrict__ y0,
                           float* __restrict__ out,
                           const float* __restrict__ fields, int nz, int ny,
                           int n_steps, float t0, float dt) {
  extern __shared__ float smem[];
  const int n = nz * ny;
  const int n3 = kTracers * n;

  const Header h = load_header(fields);
  const Params p = load_params(fields + kHeader);
  const float* grid_g = fields + kHeader + kParams;
  const long n_grid = grid_floats(nz, ny);
  const float* light_g = grid_g + n_grid;

  float* y = smem;
  float* comp = y + n3;
  float* f1 = comp + n3;
  float* ys = f1 + n3;
  float* light = ys + n3;
  float* kv = light + n;
  float* grid_s = kv + (nz - 1) * ny;
  for (int i = threadIdx.x; i < n3; i += blockDim.x) {
    y[i] = y0[i];
    comp[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) light[i] = light_g[i];
  for (long i = threadIdx.x; i < n_grid; i += blockDim.x) grid_s[i] = grid_g[i];
  __syncthreads();
  const Fields g = grid_fields(grid_s, nz, ny);

  kv_phase(kv, t0, nz, ny, h, g);
  __syncthreads();
  cn_phase(y, comp, f1, ys, kv, 0.5f * dt, nz, ny, g);
  __syncthreads();

  const float half_dt = 0.5f * dt;
  for (int step = 0; step < n_steps; ++step) {
    const float t = t0 + (float)step * dt;
    // A: Heun stage 1 of all three tracers and kv for the CN solve at t + dt
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      Tend3 f = tend3(y, idx, k, idx - k * ny, nz, ny, light, p, g);
      f1[idx] = f.po4;
      f1[n + idx] = f.dop;
      f1[2 * n + idx] = f.pop;
      ys[idx] = y[idx] + dt * f.po4;
      ys[n + idx] = y[n + idx] + dt * f.dop;
      ys[2 * n + idx] = y[2 * n + idx] + dt * f.pop;
    }
    kv_phase(kv, t + dt, nz, ny, h, g);
    __syncthreads();
    // B: Heun stage 2 and the compensated explicit update
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k = idx / ny;
      Tend3 f2 = tend3(ys, idx, k, idx - k * ny, nz, ny, light, p, g);
      kahan_add(y, comp, idx, half_dt * (f1[idx] + f2.po4));
      kahan_add(y, comp, n + idx, half_dt * (f1[n + idx] + f2.dop));
      kahan_add(y, comp, 2 * n + idx, half_dt * (f1[2 * n + idx] + f2.pop));
    }
    __syncthreads();
    // C: CN over dt (merged interior halves), dt/2 after the last Heun
    cn_phase(y, comp, f1, ys, kv, step == n_steps - 1 ? half_dt : dt, nz, ny,
             g);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n3; i += blockDim.x) out[i] = y[i];
}

}  // namespace

extern "C" {

// length of the packed constant buffer the wrapper builds
long phosphorus_year_fields_len(int nz, int ny) {
  return kHeader + kParams + grid_floats(nz, ny) + (long)nz * ny;
}

long phosphorus_year_smem_bytes(int nz, int ny) {
  return smem_floats(nz, ny) * (long)sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int phosphorus_year_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* phosphorus_year_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// launch on `stream` (a cudaStream_t) of the current device; returns the
// cudaGetLastError() after the launch (0 on success)
int phosphorus_year_launch(const float* y0, float* out, const float* fields,
                           int nz, int ny, int n_steps, float t0, float dt,
                           void* stream) {
  const long smem = phosphorus_year_smem_bytes(nz, ny);
  cudaError_t err = cudaFuncSetAttribute(
      phosphorus_year_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  phosphorus_year_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      y0, out, fields, nz, ny, n_steps, t0, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
