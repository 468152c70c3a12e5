// One model year of the 3D offline IRF-transport family -- T linear tracers
// on an (nz, nlat, nlon) ocean grid too large for on-chip memory (POP gx1,
// 60 x 384 x 320) -- on NVIDIA Hopper (sm_90a): kernel B5.
//
// Replaces newton_krylov_ooc_tpu/ops/transport3d_stream_pallas.py:805
// (build_transport3d_year_stream).  The scheme is ops/imex.py's, step for
// step: CNh [Heun CNf] x (n-1) Heun CNh, in float32 with Kahan-compensated
// increments and the flux-form CN right-hand side.  The explicit tendency
// is one of
//   * the flux form of ops/transport3d.py::transport_tend (upwind3 or
//     centred; the selectors of `wet` packed into a byte a cell), with recip_vol read, or
//     rebuilt as wet * (recip_dz[k] * recip_area[j, i]);
//   * the collapsed 13-offset stencil of transport_stencil_coef /
//     stencil_tend (steady circulations), its coefficients in float32 or
//     in bfloat16, upcast on load (state and Kahan carry stay float32);
// plus the explicit source and the optional (T, T) surface coupling.  The
// implicit rates and the sources are read dense, or rebuilt from two
// scalars per tracer as a_t wet + b_t wet [k == 0] where they factor so
// (ops/transport3d_stream_cuda.py::_factor_rate_field).  A seasonal
// circulation keeps every month of its face fields and kv in device memory
// and interpolates them at each stage's time from the wrapper's table, as
// B4 does.
//
// Design.  Every field of a gx1 year is 29.5 MB, so the year streams the
// grid from device memory every step, as it does on the TPU.  B5's central
// idea carries over: Heun's stage 1 is recomputed on a halo, so the stages
// f1 and f2 never reach device memory.  A step is ONE launch of
// step_kernel (csrc/transport3d_stream_passes.cuh::tile_step): a block of
// 512 threads owns a tile of 16 x 32 (lat x lon) columns and marches down
// the depth, one level an iteration.
//   * Rings of 8 levels in shared memory hold the state y and a byte per
//     cell of wet and the six upwind3 selectors (pack_selectors in the
//     wrapper, built once a year) on the tile plus a halo of 4 (24 x 40),
//     the stage state s = (y + dt f1) wet on the tile plus a halo of 2
//     (20 x 36), and f1 on the tile.  Level it + 1 of y and the bytes is
//     staged with cp.async (16-byte chunks through L2, 4-byte ones for the
//     bytes) while level it computes.
//   * Each lateral face is computed once a level and stage: the east and
//     north face fluxes of the stage-state tile (stage 1) and of the tile
//     (stage 2) go to shared memory, and a cell's divergence is a
//     difference of stored faces.  The top face is carried down from the
//     level above in shared memory.  Iteration `it` computes the faces, then
//     stage 1 at level it - 2 on the halo-2 tile, then stage 2 with the
//     Heun Kahan add at level it - 4 of the tile: 3 barriers an iteration.
//   * The CN(h) solve is fused in.  As each level's Heun state is done, the
//     thread of its column eliminates the level above it (Thomas; the
//     sweep's state waits in shared memory between levels) and writes that level's Heun state and carry to the output
//     state and the carry and its sweep factors cp and gp to device scratch
//     (two states).  After the bottom level the thread substitutes back up
//     its own column, whose levels it has just written, Kahan-adding each
//     increment.  The Heun pair and both factors make four words a cell
//     until then.  Keeping cp in shared memory instead (nz x 256 floats
//     with tiles of 8 x 32) left two blocks of 256 threads an SM and was
//     slower, as were tiles of 8 x 32 at four blocks an SM and faces
//     computed per cell (PERF.md section 6 has the times).
// The step reads one ping-pong state buffer and writes the other, since
// neighbouring blocks still read the old state; each cell's carry is its
// own thread's, updated in place.  A coupled year first computes the
// surface stage state of every tracer on the tile.  The first CN half step
// is step_kernel<_, false>, the CN alone, in place.  A year is 1 + n
// launches, enqueued on PyTorch's current stream by a C loop here: one
// ctypes call a year, each launch's cudaGetLastError() checked.
//
// What bounds it on this card.  Counted once per cell and face, a gx1 step
// of the flux form is about 200 float32 operations per cell and tracer
// (two tendencies of about 80, the Heun add, the CN solve and two Kahan
// adds), the stencil form about 90: 2000 steps at T = 1 take at least
// 44 ms (flux) or 20 ms (stencil) at the H100's 67 TFLOP/s, while the
// year's inputs and output, read and written once, move well under a GB.
// The bound is operations.  The design still spends more: stage 1 on the
// halo (1.41x the tile's cells at 16 x 32), each face field read once a
// stage through the read-only cache, the stencil form's 13 coefficient
// fields at both stages, the state, carry and sweep factors through device
// memory once more for the back substitution, and spills at 64 registers
// a thread.
//
// The device code is in csrc/transport3d_stream_passes.cuh, which B6
// (csrc/transport3d_sweep.cu) runs over one shard's slab and B7
// (csrc/transport3d_block.cu) k steps at a time over every shard's slab.

#include "transport3d_stream_passes.cuh"

extern "C" {

const char* transport3d_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dynamic shared memory of one step block
long transport3d_stream_smem_bytes(int t_dim, int coupled) {
  return step_smem_bytes(t_dim, coupled);
}

int transport3d_stream_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Enqueue one year on `stream` (a cudaStream_t) of the current device.
// y_pp: two state buffers of t_dim * nz * nlat * nlon floats, the first
// holding y0 on entry; the year's end is in buffer n_steps % 2.  comp must
// be zero; gp is scratch of two states (the sweep factors gp, then cp).
// fields: kSlots operand pointers;
// seasonal: kSlots flags; opts: mode (0 flux, 1 stencil f32, 2 stencil
// bf16), upwind3, diag_mode, src_mode (0 none, 1 dense, 2 factored); m0,
// m1, w: host arrays of the 2 n_steps + 1 time samples (sample 0: t0; step
// i: 1 + 2i at t_i, 2 + 2i at t_i + dt).  Returns the first
// cudaGetLastError() that is not 0, else 0.
int transport3d_stream_launch(float* y_pp, float* comp, float* gp,
                              const void* const* fields, const int* seasonal,
                              const int* opts, const int* m0, const int* m1,
                              const float* w, int t_dim, int nz, int nlat,
                              int nlon, int n_steps, float dt, void* stream) {
  const Args a = make_args(fields, seasonal, opts, t_dim, nz, nlat, nlon);
  StepKernel heun, cn;
  int smem;
  int err = step_kernels(opts[0], t_dim, fields[kCouple] != nullptr, &heun,
                         &cn, &smem);
  if (err) return err;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long state = (long)t_dim * nz * nlat * nlon;
  const dim3 tiles((nlon + kTX - 1) / kTX, (nlat + kTY - 1) / kTY);
  const float half_dt = 0.5f * dt;
  auto sample = [&](int q) { return Sample{m0[q], m1[q], w[q]}; };

  cn<<<tiles, kThreads, 0, st>>>(y_pp, y_pp, comp, gp, a, dt, half_dt,
                                 sample(0), sample(0));
  err = (int)cudaGetLastError();
  if (err) return err;
  for (int step = 0; step < n_steps; ++step) {
    const float* y_in = y_pp + (step & 1) * state;
    float* y_out = y_pp + ((step + 1) & 1) * state;
    // CN over dt (merged interior halves), dt/2 after the last Heun
    heun<<<tiles, kThreads, smem, st>>>(
        y_in, y_out, comp, gp, a, dt, step == n_steps - 1 ? half_dt : dt,
        sample(1 + 2 * step), sample(2 + 2 * step));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
