// A block of j IMEX steps of the py_driver_2d iage family on a closed,
// halo-extended ypos window (kernel B3), on NVIDIA Hopper (sm_90a).
//
// Replaces newton_krylov_ooc_tpu/ops/imex_pallas.py::_block_callable
// (imex_pallas.py:687), the per-shard compute of the sharded 2D year
// (parallel/sharded_year.py::build_sharded_year_blocked).  It computes the
// same function: given y and its Kahan carry on a window of nx columns, C
// channels and nz levels, it returns both after j steps of [Heun(dt);
// CN(dt)] -- the interior steps of the Strang-split year, whose half steps
// merge -- with step i at t = t_start + i dt in float32 and the window's
// edges closed (zero lateral flux outside it), on all nx columns.  The
// caller keeps the columns it owns; the halo of 2 j columns a side that it
// exchanged is eroded by two columns per step.
//
// What bounds it on this card.  The TPU kernel holds the whole (nz, C nx)
// window in VMEM; at the bench's 256 x 2000 on one shard one field of it is
// 2 MB, about nine times the 227 KB of shared memory a block may use.  Every
// step is a chain of dependent phases -- the explicit tendency twice, the
// seasonal mixing coefficient, a Thomas solve nz levels deep per column --
// so the kernel is bound by latency and synchronisation per step, not by
// bytes or operations, and by how many SMs it keeps busy.
//
// Design.  B3's own idea, one level down: a thread block owns one channel
// and a tile of `tile` ypos columns over all nz levels, and loads its tile
// plus a halo of 2 j' columns a side (clipped to the window) into shared
// memory -- state, carry, both Heun stages, kv, the implicit diagonal and
// every constant field of those columns.  It runs j' steps there and writes
// its owned columns back.  Where the tile's halo is cut inside the window
// the cut is treated as closed, and the error it makes travels two columns
// a step, so it never reaches the owned columns; where the tile meets the
// window's edge, the closed edge is the real one.  Because the window is
// closed, j steps equal j' steps repeated: the wrapper
// (ops/imex_block_cuda.py) splits j into launches of j' steps so that a
// tile and its halo fit the card's shared memory, and ping-pongs the state
// between launches.  When the whole window fits, one block per channel runs
// all j steps in one launch, as the TPU kernel did.
//
// Each step is B1's three phases (csrc/iage_year.cu), through the device
// code it shares in csrc/imex_common.cuh: the fused face flux
// G = ca y_l + cb y_r, the kv closed form, and the Thomas column solve with
// the Kahan add fused in (cn_column64), in float64: at 256 levels the
// mixed layer's CN system has h |M| ~ 6e3, and a float32 solve (the TPU
// kernel's reciprocal-form PCR, or Thomas) loses that many ulps of the
// slow modes of a rough state each step -- 6.25e-2 (PCR) and 7.21e-4
// (Thomas) of max|y| over a tenth of the year from seeded noise, against
// the float64 year.  The increment is rounded once to float32 for the
// Kahan add; ops/imex_block_cuda.py's plain version solves in float64 too.  The constants arrive lane-packed as
// pack_block_consts lays them out for the TPU, (rows, C nx) with channel
// ch's column x at lane ch nx + x, and the state as (C, nz, nx).
//
// Shared memory: 11 nz L + 3 nz - 2 floats for a tile of L loaded columns,
// the float64 sweep factors included (iage_block_smem_bytes is the one
// place that counts it).  At nz = 256 a block holds 20 columns; the wrapper
// then takes one step a launch and tiles of 16 owned columns.  Clusters, cp.async and a persistent kernel
// are later work.

#include "imex_common.cuh"

namespace {

using namespace imex;

constexpr int kThreads = 256;

__host__ __device__ inline long smem_floats(int nz, int width) {
  // the float64 sweep factor cp (nz, width); y, comp, f1, ys, diag (nz,
  // width), f1 and ys also the float64 gp; kv (nz-1, width); the tile's
  // constant fields; the channel's source by level (nz)
  return 7L * nz * width + (long)(nz - 1) * width + grid_floats(nz, width) +
         nz;
}

// the lane-packed constant operands, in pack_block_consts' layout
struct Consts {
  const float *ca, *cb;  // (nz, C nx - 1), zero at channel seams
  const float *wv;       // (nz-1, C nx)
  const float *diag;     // (nz, C nx)
  const float *src;      // (src_rows, C nx), src_rows 1 or nz
  const float *bld_max, *dy_r;  // (1, C nx)
  const float *dz_r, *dz_mid, *dz_mid_r, *depth_mid;  // by level
};

__global__ void __launch_bounds__(kThreads)
    iage_block_kernel(const float* __restrict__ y_in,
                      const float* __restrict__ c_in,
                      float* __restrict__ y_out, float* __restrict__ c_out,
                      Consts cs, const float* __restrict__ header,
                      int src_rows, int nz, int nx, int tile, int halo,
                      int i0, int j_steps, float t_start, float dt) {
  extern __shared__ __align__(16) float smem[];
  const int ch = blockIdx.y;
  const long w_dim = (long)gridDim.y * nx;
  const int x0 = blockIdx.x * tile;
  const int x1 = min(nx, x0 + tile);
  const int lo = max(0, x0 - halo);
  const int hi = min(nx, x1 + halo);
  const int L = hi - lo;  // loaded columns, local index j = x - lo
  const int n = nz * L;
  const long lane0 = (long)ch * nx + lo;  // lane of local column 0
  const Header h = load_header(header);

  double* cpd = reinterpret_cast<double*>(smem);
  float* y = reinterpret_cast<float*>(cpd + n);
  float* comp = y + n;
  float* f1 = comp + n;
  float* ys = f1 + n;
  float* diag = ys + n;
  float* kv = diag + n;
  float* grid_s = kv + (nz - 1) * L;
  float* src = grid_s + grid_floats(nz, L);
  const Fields g = grid_fields(grid_s, nz, L);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / L;
    const int j = i - k * L;
    const long gi = ((long)ch * nz + k) * nx + lo + j;
    y[i] = y_in[gi];
    comp[i] = c_in[gi];
    diag[i] = cs.diag[k * w_dim + lane0 + j];
  }
  for (int i = threadIdx.x; i < nz * (L - 1); i += blockDim.x) {
    const int k = i / (L - 1);
    const long lane = k * (w_dim - 1) + lane0 + (i - k * (L - 1));
    const_cast<float*>(g.ca)[i] = cs.ca[lane];
    const_cast<float*>(g.cb)[i] = cs.cb[lane];
  }
  for (int i = threadIdx.x; i < (nz - 1) * L; i += blockDim.x) {
    const int k = i / L;
    const_cast<float*>(g.wv)[i] = cs.wv[k * w_dim + lane0 + (i - k * L)];
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const_cast<float*>(g.dy_r)[j] = cs.dy_r[lane0 + j];
    const_cast<float*>(g.bld_max)[j] = cs.bld_max[lane0 + j];
  }
  for (int k = threadIdx.x; k < nz; k += blockDim.x) {
    const_cast<float*>(g.dz_r)[k] = cs.dz_r[k];
    const_cast<float*>(g.depth_mid)[k] = cs.depth_mid[k];
    // the source is uniform over a channel's lanes: take its first
    src[k] = cs.src[(src_rows > 1 ? k : 0) * w_dim + (long)ch * nx];
    if (k < nz - 1) {
      const_cast<float*>(g.dz_mid)[k] = cs.dz_mid[k];
      const_cast<float*>(g.dz_mid_r)[k] = cs.dz_mid_r[k];
    }
  }
  __syncthreads();

  const float half_dt = 0.5f * dt;
  for (int s = 0; s < j_steps; ++s) {
    // t = t_start + i dt in float32, two roundings as the TPU kernel has
    // them (no fused multiply-add): an ulp in t moves kv by ~1e3 ulps
    const float t = __fadd_rn(t_start, __fmul_rn((float)(i0 + s), dt));
    // A: Heun stage 1 and kv for the CN solve at t + dt
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int k = idx / L;
      const float f = transport_tend(y, idx, k, idx - k * L, nz, L, src[k], g);
      f1[idx] = f;
      ys[idx] = y[idx] + dt * f;
    }
    kv_phase(kv, __fadd_rn(t, dt), nz, L, h, g);
    __syncthreads();
    // B: Heun stage 2 and the compensated explicit update
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int k = idx / L;
      const float f2 =
          transport_tend(ys, idx, k, idx - k * L, nz, L, src[k], g);
      kahan_add(y, comp, idx, half_dt * (f1[idx] + f2));
    }
    __syncthreads();
    // C: CN over dt in float64, one thread per column; cpd and f1..ys
    // hold the sweep
    for (int j = threadIdx.x; j < L; j += blockDim.x)
      cn_column64<true>(y, comp, cpd, reinterpret_cast<double*>(f1), kv,
                        diag, dt, j, nz, L, g);
    __syncthreads();
  }

  const int owned = x1 - x0;
  for (int i = threadIdx.x; i < nz * owned; i += blockDim.x) {
    const int k = i / owned;
    const int x = x0 + (i - k * owned);
    const long gi = ((long)ch * nz + k) * nx + x;
    const int li = k * L + (x - lo);
    y_out[gi] = y[li];
    c_out[gi] = comp[li];
  }
}

}  // namespace

extern "C" {

// shared memory of one block that loads `width` columns of nz levels
long iage_block_smem_bytes(int nz, int width) {
  return smem_floats(nz, width) * (long)sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, into *out
int iage_block_smem_optin(int device, int* out) {
  return imex::smem_optin(device, out);
}

const char* iage_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// one launch: j_steps steps (global indices i0 .. i0 + j_steps - 1) of every
// channel on the (c_dim, nz, nx) window, tiles of `tile` owned columns with
// `halo` >= 2 j_steps loaded columns a side, from (y_in, c_in) into
// (y_out, c_out), which must not alias them; on `stream` (a cudaStream_t)
// of the current device.  Returns cudaGetLastError() after the launch.
int iage_block_launch(const float* y_in, const float* c_in, float* y_out,
                      float* c_out, const float* ca, const float* cb,
                      const float* wv, const float* diag, const float* src,
                      int src_rows, const float* bld_max, const float* dy_r,
                      const float* dz_r, const float* dz_mid,
                      const float* dz_mid_r, const float* depth_mid,
                      const float* header, int c_dim, int nz, int nx,
                      int tile, int halo, int i0, int j_steps, float t_start,
                      float dt, void* stream) {
  const int width = nx < tile + 2 * halo ? nx : tile + 2 * halo;
  const long smem = iage_block_smem_bytes(nz, width);
  cudaError_t err = cudaFuncSetAttribute(
      iage_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Consts cs = {ca, cb, wv, diag, src, bld_max, dy_r,
                     dz_r, dz_mid, dz_mid_r, depth_mid};
  const dim3 grid((nx + tile - 1) / tile, c_dim);
  iage_block_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      y_in, c_in, y_out, c_out, cs, header, src_rows, nz, nx, tile, halo,
      i0, j_steps, t_start, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
