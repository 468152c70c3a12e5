// k steps of the 3D transport year on every shard's halo-extended latitude
// slab of one card, in one cooperative launch, on NVIDIA Hopper (sm_90a):
// kernel B7.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_block_pallas.py:71
// (build_block3d_steps), the per-shard compute of
// parallel/sharded_transport3d.py::build_sharded_transport3d_year_pallas.
// It computes the same function: given the state y and its Kahan carry c on
// a window of `rows` latitude rows (a shard's rows plus 4 k a side, which the
// caller fills from the neighbouring shards), all nz levels and all nlon
// longitudes, it returns both after k x [Heun(dt); CN(dt)] -- the interior
// steps of the Strang-split year -- in float32.  Reads past the window in
// latitude and depth see zeros, and longitude is periodic over nlon.  The
// rows next to the window's edges go wrong, 4 rows a step (2 stencil radii
// a Heun step), and reach the caller's interior rows exactly after k steps.
//
// What bounds it on this card.  Per cell, tracer and step the work is two
// upwind3 tendencies, a Heun Kahan add and a CN column solve -- about 200
// float32 operations, each face once, against the 8 bytes of state that
// must move once a block: the kernel is bound by operations.
//
// Design.  The TPU kernel keeps the slab in one core's VMEM for k steps.
// On Hopper a block has 227 KB of shared memory, and temporal blocking in
// it does not pay (a tile that holds whole columns loads 4.5x the cells at
// 60 levels, and every step more a launch adds 4 halo cells a side).
// B7 instead runs B5's fused step (csrc/transport3d_stream_passes.cuh::
// tile_step: the Heun tile march over depth rings staged with cp.async,
// each face once, the CN column solve fused in) k times in ONE persistent,
// cooperative launch over the slabs of every shard on the card: as many
// blocks as fit at once take the tiles of all shards in turn, and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates the
// steps.  The state ping-pongs between two buffers a shard in device memory
// (L2-resident for the coupled 3-level slabs), the carry is updated in
// place, and the state is read through L2 (cp.async.cg, __ldcg), never the
// incoherent read-only path, since other blocks rewrote it a step before.
// The selectors come packed from the slab's wet mask (a byte a cell); the
// CN solve keeps B7's own arithmetic on the bands dlb, dub (kBand).  The
// wrapper (ops/transport3d_block_cuda.py::block_schedule) sizes the grid
// from the card's occupancy and puts up to kMaxShards shards in one launch.

#include <cooperative_groups.h>

#include "transport3d_stream_passes.cuh"

namespace {

constexpr int kMaxShards = 16;

// one shard's slab: its operands (the fused step's Args), the input state
// y0, the two ping-pong states, the carry (updated in place) and the
// sweep factors' scratch; in constant memory, which every thread of a tile
// reads alike
struct Slab {
  Args a;
  const float* y0;
  float* y[2];
  float* comp;
  float* gp;
};

__constant__ Slab c_slabs[kMaxShards];

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    block3d_kernel(int n_shards, int k_steps, float dt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int col4[kWX4];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int rows = c_slabs[0].a.nlat, nlon = c_slabs[0].a.nlon;
  const int tiles_x = (nlon + kTX - 1) / kTX;
  const int per_shard = tiles_x * ((rows + kTY - 1) / kTY);
  const int total = per_shard * n_shards;
  const Sample s0 = {0, 0, 0.0f};
  for (int step = 0; step < k_steps; ++step) {
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int q = tile / per_shard;
      const int rem = tile - q * per_shard;
      const int ty = rem / tiles_x;
      const Slab& sl = c_slabs[q];
      const float* y_in = step == 0 ? sl.y0 : sl.y[(step - 1) & 1];
      tile_step<kFlux, true, true>(sl.a, y_in, sl.y[step & 1], sl.comp,
                                   sl.gp, ty * kTY, (rem - ty * tiles_x) * kTX,
                                   dt, dt, s0, s0, smem, col4);
    }
    if (step + 1 < k_steps) grid.sync();
  }
}

}  // namespace

extern "C" {

const char* transport3d_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int transport3d_block_max_shards() { return kMaxShards; }

// the step tile: rows (latitude) and columns (longitude)
void transport3d_block_tile(int* rows, int* cols) {
  *rows = kTY;
  *cols = kTX;
}

// dynamic shared memory of one block
long transport3d_block_smem_bytes(int t_dim, int coupled) {
  return step_smem_bytes(t_dim, coupled);
}

int transport3d_block_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// blocks of the kernel that fit on one SM at once with `smem` bytes of
// dynamic shared memory, into *out (the opt-in limit set first)
int transport3d_block_occupancy(long smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      block3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, block3d_kernel, kThreads, (size_t)smem);
}

// Enqueue one cooperative launch of `grid` blocks on `stream` (a
// cudaStream_t) of the current device: k_steps steps of every tracer on
// each of n_shards (<= kMaxShards) (t_dim, nz, rows, nlon) slabs.  Per
// shard q: fields[q * kSlots ...] its operand pointers (null where
// absent), bufs[5 q ...] its input state, the two ping-pong states (the
// end lands in the first after an odd k_steps, else in the second), its
// carry (updated in place) and its scratch of two states for the sweep
// factors.  opts: upwind3, diag_mode,
// src_mode.  grid must not exceed the blocks that fit at once
// (transport3d_block_occupancy times the SM count).  Returns the launch's
// CUDA error or 0.
int transport3d_block_launch(const void* const* fields, void* const* bufs,
                             const int* opts, int n_shards, int t_dim,
                             int nz, int rows, int nlon, int k_steps,
                             float dt, int grid, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards) return (int)cudaErrorInvalidValue;
  const int seasonal[kSlots] = {0};
  // make_args' opts: mode (flux), upwind3, diag_mode, src_mode
  const int step_opts[4] = {kFlux, opts[0], opts[1], opts[2]};
  Slab slabs[kMaxShards];
  for (int q = 0; q < n_shards; ++q) {
    Slab& sl = slabs[q];
    sl.a = make_args(fields + q * kSlots, seasonal, step_opts, t_dim, nz, rows,
                     nlon);
    sl.y0 = static_cast<const float*>(bufs[5 * q]);
    sl.y[0] = static_cast<float*>(bufs[5 * q + 1]);
    sl.y[1] = static_cast<float*>(bufs[5 * q + 2]);
    sl.comp = static_cast<float*>(bufs[5 * q + 3]);
    sl.gp = static_cast<float*>(bufs[5 * q + 4]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // stream-ordered: the launches before this one have read their slabs
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_slabs, slabs, n_shards * sizeof(Slab), 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const long smem = step_smem_bytes(t_dim, fields[kCouple] != nullptr);
  err = cudaFuncSetAttribute(
      block3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n_shards, &k_steps, &dt};
  err = cudaLaunchCooperativeKernel((const void*)block3d_kernel, dim3(grid),
                                    dim3(kThreads), args, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
