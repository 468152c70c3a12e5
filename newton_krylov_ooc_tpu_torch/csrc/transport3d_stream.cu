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
//     centred; selectors derived from `wet`), with recip_vol read, or
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
// f1 and f2 never reach device memory.  A step is two launches, against
// B4's three:
//   (a) heun_tile_kernel: one block of 512 threads owns a tile of 16 x 32
//       (lat x lon) columns and marches down the depth.  Shared memory
//       keeps rings of 8 levels: y * wet and wet on the tile plus a halo of
//       4 (24 x 40), the stage state s = (y + dt f1) * wet on the tile plus
//       a halo of 2 (20 x 36), and f1 on the tile.  Iteration `it` loads
//       level it, computes stage 1 at level it - 2 on the halo-2 tile, and
//       stage 2 with the Heun Kahan add at level it - 4 of the tile: 2
//       barriers an iteration, nz + 4 iterations per tracer.  Stage 1 is
//       recomputed on 720 / 512 = 1.41x the tile's cells.  Off the grid in
//       latitude and depth the rings hold zeros, as ops/transport3d.py's
//       _shift zero-fills; the grid column of each tile column is taken
//       modulo nlon once per block, so a grid narrower than the tile wraps
//       as often as it must.  The pass
//       reads one ping-pong state buffer and writes the other, since
//       neighbouring blocks still read the old state; each cell's Kahan
//       carry is its own thread's, updated in place.  A coupled year first
//       computes the surface stage state of every tracer on the tile
//       (stage 2's coupling needs all T of them at each surface cell).
//   (b) column_kernel: one thread per (tracer, column) solves the CN
//       increment by Thomas along depth and Kahan-adds it in place
//       (t3d::cn_column, shared with B4); the sweep factors go to scratch
//       buffers the wrapper allocates.
// The first and last CN half steps are pass (b) with h = dt/2.  A year is
// 1 + 2 n launches, enqueued on PyTorch's current stream by a C loop here:
// one ctypes call a year, each launch's cudaGetLastError() checked.  Not
// here: cp.async or TMA pipelining of the rings, temporal blocking over k
// steps, one launch per step, a CUDA graph.
//
// What bounds it on this card.  Counted once per cell, a gx1 step of the
// flux form is about 200 float32 operations per cell and tracer (two
// tendencies of about 80, the Heun add, the CN solve and two Kahan adds),
// the stencil form about 90: 2000 steps at T = 1 take at least 44 ms
// (flux) or 20 ms (stencil) at the H100's 67 TFLOP/s, while the year's
// inputs and output, read and written once, move well under a GB.  The
// bound is operations.  This simple design spends far more: pass (a)
// recomputes stage 1 on the halo, reads each coefficient field at both
// stages (the stencil form's 13 of them, in L1 or L2 if at all), and pass
// (b) streams the state, the carry and the sweep factors through device
// memory.
//
// The device code of both passes is in csrc/transport3d_stream_passes.cuh,
// which B6 (csrc/transport3d_sweep.cu) runs over one shard's slab.

#include "transport3d_stream_passes.cuh"

extern "C" {

const char* transport3d_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dynamic shared memory of one pass-(a) block
long transport3d_stream_smem_bytes(int t_dim, int coupled) {
  return heun_smem_bytes(t_dim, coupled);
}

int transport3d_stream_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Enqueue one year on `stream` (a cudaStream_t) of the current device.
// y_pp: two state buffers of t_dim * nz * nlat * nlon floats, the first
// holding y0 on entry; the year's end is in buffer n_steps % 2.  comp must
// be zero; cp and gp are scratch of one state each.  fields: kSlots operand
// pointers; seasonal: kSlots flags; opts: mode (0 flux, 1 stencil f32,
// 2 stencil bf16), upwind3, diag_mode, src_mode (0 none, 1 dense,
// 2 factored); m0, m1, w: host arrays of the 2 n_steps + 1 time samples
// (sample 0: t0; step i: 1 + 2i at t_i, 2 + 2i at t_i + dt).  Returns the
// first cudaGetLastError() that is not 0, else 0.
int transport3d_stream_launch(float* y_pp, float* comp, float* cp, float* gp,
                              const void* const* fields, const int* seasonal,
                              const int* opts, const int* m0, const int* m1,
                              const float* w, int t_dim, int nz, int nlat,
                              int nlon, int n_steps, float dt, void* stream) {
  Args a;
  for (int slot = 0; slot < kSlots; ++slot) {
    a.f[slot] = fields[slot];
    a.seasonal[slot] = seasonal[slot];
  }
  a.t_dim = t_dim;
  a.nz = nz;
  a.nlat = nlat;
  a.nlon = nlon;
  a.upwind3 = opts[1];
  a.diag_mode = opts[2];
  a.src_mode = opts[3];
  const HeunKernel heun = opts[0] == kStencilBF16  ? heun_tile_kernel<kStencilBF16>
                          : opts[0] == kStencilF32 ? heun_tile_kernel<kStencilF32>
                                                   : heun_tile_kernel<kFlux>;
  const int smem =
      (int)transport3d_stream_smem_bytes(t_dim, fields[kCouple] != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      heun, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long state = (long)t_dim * nz * nlat * nlon;
  const long cols = (long)t_dim * nlat * nlon;
  const dim3 tiles((nlon + kTX - 1) / kTX, (nlat + kTY - 1) / kTY);
  const int col_blocks = (int)((cols + kColThreads - 1) / kColThreads);
  const float half_dt = 0.5f * dt;
  auto sample = [&](int q) { return Sample{m0[q], m1[q], w[q]}; };

  column_kernel<<<col_blocks, kColThreads, 0, st>>>(y_pp, comp, cp, gp, a,
                                                    half_dt, sample(0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int step = 0; step < n_steps; ++step) {
    const float* y_in = y_pp + (step & 1) * state;
    float* y_out = y_pp + ((step + 1) & 1) * state;
    const Sample s_a = sample(1 + 2 * step), s_b = sample(2 + 2 * step);
    heun<<<tiles, kThreads, smem, st>>>(y_in, y_out, comp, a, dt, s_a, s_b);
    // CN over dt (merged interior halves), dt/2 after the last Heun
    column_kernel<<<col_blocks, kColThreads, 0, st>>>(
        y_out, comp, cp, gp, a, step == n_steps - 1 ? half_dt : dt, s_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
