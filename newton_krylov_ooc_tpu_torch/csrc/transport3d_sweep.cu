// One sweep of the latitude-sharded streaming 3D transport year on one
// shard -- k IMEX steps on a halo-extended latitude slab -- on NVIDIA Hopper
// (sm_90a): kernel B6.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py:393
// (build_stream_sweep), the per-shard compute of
// parallel/sharded_transport3d.py::build_sharded_transport3d_year_stream.
// A shard's slab is its nl_loc latitude rows plus `halo` rows a side, which
// the caller fills from the neighbouring shards (state and Kahan carry)
// before every sweep; its coefficient fields are the shard's zero-padded
// latitude extension.  Every step updates the whole slab.  Reads past the
// slab edge see zeros, so the rows next to an edge go wrong: 2 radii a step
// (stage 1 feeds stage 2), 4 rows, and the halo covers k times that.  Only
// the interior rows must be exact, and they are: each interior cell does
// the arithmetic of the unsharded year.
//
// Design.  B6 is B5 (csrc/transport3d_stream.cu) run over the slab as its
// grid: the same fused step (csrc/transport3d_stream_passes.cuh, one launch
// a step: the Heun tile march with the CN column solve fused in, the
// flux-form CN right-hand side).  A sweep of k steps is k launches; sweep
// 0 is one launch, the CN alone with h = dt/2, after the carry is zeroed.
// The last sweep's last CN is over dt/2.  Time samples come from the
// year's table (season_samples), indexed by the global step, so one shard
// repeats B5's arithmetic exactly.  One ctypes call enqueues a sweep on
// PyTorch's current stream, each launch's cudaGetLastError() checked.  Not
// here: one launch for all shards of a card (B7 has it), temporal blocking.
//
// What bounds it on this card: as B5, operations (about 200 float32
// operations per cell, tracer and step in flux form), counted once per
// cell of the grid.  The slab adds 2 halo / nl_loc of recomputed rows
// (4% for one gx1 shard at k = 1, 17% for each of four), and on four
// shards of gx1 each launch has 14 x 10 = 140 tiles for 132 SMs.

#include "transport3d_stream_passes.cuh"

extern "C" {

const char* transport3d_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// the step tile: rows (latitude) and columns (longitude)
void transport3d_sweep_tile(int* rows, int* cols) {
  *rows = kTY;
  *cols = kTX;
}

// dynamic shared memory of one step block
long transport3d_sweep_smem_bytes(int t_dim, int coupled) {
  return step_smem_bytes(t_dim, coupled);
}

int transport3d_sweep_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Enqueue one sweep on `stream` (a cudaStream_t) of the current device.
// y_a holds the slab state on entry (t_dim * nz * rows * nlon floats); y_b
// is a second state buffer the steps ping-pong into.  The sweep's end is in
// y_a after the first sweep or an even k_steps, else in y_b.  comp is the
// Kahan carry, updated in place (zeroed first on the first sweep); gp is
// scratch of two states (the sweep factors gp, then cp).  fields, seasonal
// and opts as transport3d_stream_launch's; m0, m1, w: host arrays of the
// year's 2 n_steps + 1 time samples (sample 0: t0; global step i: 1 + 2i
// at t_i, 2 + 2i at t_i + dt).  first: run only the opening CN(dt/2); otherwise k
// steps from global step step0, the last of them ending in CN(dt/2) when
// `last`.  Returns the first CUDA error that is not 0, else 0.
int transport3d_sweep_launch(float* y_a, float* y_b, float* comp, float* gp,
                             const void* const* fields, const int* seasonal,
                             const int* opts, const int* m0, const int* m1,
                             const float* w, int t_dim, int nz, int rows,
                             int nlon, int step0, int k_steps, int first,
                             int last, float dt, void* stream) {
  const Args a = make_args(fields, seasonal, opts, t_dim, nz, rows, nlon);
  StepKernel heun, cn;
  int smem;
  int err = step_kernels(opts[0], t_dim, fields[kCouple] != nullptr, &heun,
                         &cn, &smem);
  if (err) return err;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long state = (long)t_dim * nz * rows * nlon;
  const dim3 tiles((nlon + kTX - 1) / kTX, (rows + kTY - 1) / kTY);
  const float half_dt = 0.5f * dt;
  auto sample = [&](int q) { return Sample{m0[q], m1[q], w[q]}; };

  if (first) {
    err = (int)cudaMemsetAsync(comp, 0, sizeof(float) * state, st);
    if (err) return err;
    cn<<<tiles, kThreads, 0, st>>>(y_a, y_a, comp, gp, a, dt, half_dt,
                                   sample(0), sample(0));
    return (int)cudaGetLastError();
  }
  for (int j = 0; j < k_steps; ++j) {
    const int step = step0 + j;
    const float* y_in = (j & 1) ? y_b : y_a;
    float* y_out = (j & 1) ? y_a : y_b;
    // CN over dt (merged interior halves), dt/2 after the year's last Heun
    heun<<<tiles, kThreads, smem, st>>>(
        y_in, y_out, comp, gp, a, dt, last && j == k_steps - 1 ? half_dt : dt,
        sample(1 + 2 * step), sample(2 + 2 * step));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
