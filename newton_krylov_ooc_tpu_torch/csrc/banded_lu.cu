// The pivot-free LU of row-band matrices and its solves on NVIDIA Hopper
// (sm_90a), for float32, float64, complex64 and complex128.
//
// Replaces no Pallas kernel.  It stands for the lax.scan of
// newton_krylov_ooc_tpu/ops/banded.py::banded_lu_factor (banded.py:42) and
// ::banded_lu_solve (banded.py:80), vmapped over blocks: the stage solves
// of the banded Radau year (ops/radau.py, jac_bands mode), the phosphorus
// preconditioner's eigen iterations and shifted solves (ops/eigen.py), and
// the vertical-product preconditioner of the sharded 2D year
// (parallel/sharded_year.py).  The plain PyTorch version of each
// (ops/banded.py::banded_lu_factor_plain, ::banded_lu_solve_plain) runs
// the rows as a Python loop of about six launches a row: thousands of
// launches a factorisation.
//
// Storage, as in the JAX package: bands[i, d] = A[i, i + d - bw] for d in
// [0, 2 bw]; entries outside the matrix are zero.  The factor overwrites
// the lower band with L's multipliers (L has a unit diagonal) and the
// diagonal and upper band with U; no pivoting (the shifted stage matrices
// are diagonally dominant).
//
// What bounds it on this card.  Both are chains: the factor a chain of m
// pivots, each a rank-1 update of a bw x bw block that needs the pivot
// before it; the solves a chain of m rows each way.  A factorisation moves
// m (2 bw + 1) elements and does about m bw^2 multiply-adds, so at the
// Radau shapes (m <= 6000, bw <= 120) the bytes take microseconds and the
// arithmetic of one matrix fits one SM; the time is the m steps of the
// chain, each a barrier or a shuffle and an L2 or shared-memory round trip.
//
// Design.
//   * Factor: one block per matrix.  The bw x bw block a pivot updates and
//     its pivot row and column lie in the (bw + 2) x (bw + 2) window of
//     rows and columns p-1 .. p+bw, kept in shared memory, cyclic in both
//     (row r and column c at slot (r mod (bw+2), c mod (bw+2))): a pivot
//     moves the window by one row and one column without moving data.
//     Each thread owns fixed slots.  A pivot takes two barriers: (A) bw
//     threads divide the pivot column by the pivot (the multipliers, as
//     the plain version divides), store them to shared memory and to the
//     output; (B) every thread updates its slots, and the slots of row
//     p-1 and column p-1, which left the window, are written out (U) and
//     refilled with row and column p+bw+1, which loader threads fetched
//     from device memory a pivot earlier (off the chain).  Where the
//     window does not fit in the shared memory a block may use (complex128
//     at bw = 120 needs 238 KB), the same thread layout updates the band
//     in place in device memory, where it stays L2-resident.
//   * Solves: one warp per (matrix, right-hand side), right-looking: lane
//     q + 32 s holds the running value of row j + q (forward; j - q
//     backward), so a row's substitution is one shuffle broadcast of its
//     value, one multiply-add in each lane and one shuffle that moves the
//     rows down the lanes.  L's and U's coefficients are loaded 3 to 16
//     steps ahead (fewer the more rows a lane holds), off the chain.
//   * The caller's stream, outputs allocated by the caller: the launches
//     are captured in CUDA graphs (ops/radau.py).  The factor and the
//     solves take an optional device flag and return at once when it is
//     false, so that a graph replays the factorisations and solves a step
//     attempt needs, and no others, without a host branch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
};

template <typename T>
struct Zero {
  __device__ static T get() { return T(0); }
};
template <typename R>
struct Zero<Complex<R>> {
  __device__ static Complex<R> get() { return {R(0), R(0)}; }
};

template <typename R>
__device__ __forceinline__ Complex<R> operator*(Complex<R> a, Complex<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

template <typename R>
__device__ __forceinline__ Complex<R> operator-(Complex<R> a, Complex<R> b) {
  return {a.re - b.re, a.im - b.im};
}

// numpy's (and c10::complex's) scaled division
template <typename R>
__device__ __forceinline__ Complex<R> operator/(Complex<R> a, Complex<R> b) {
  const R c = b.re, d = b.im;
  if (fabs(c) >= fabs(d)) {
    const R rat = d / c;
    const R scl = R(1) / (c + d * rat);
    return {(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl};
  }
  const R rat = c / d;
  const R scl = R(1) / (d + c * rat);
  return {(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl};
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl(Complex<R> v, int src) {
  return {__shfl_sync(0xffffffffu, v.re, src),
          __shfl_sync(0xffffffffu, v.im, src)};
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl_down(Complex<R> v) {
  return {__shfl_down_sync(0xffffffffu, v.re, 1),
          __shfl_down_sync(0xffffffffu, v.im, 1)};
}

constexpr int kMaxThreads = 1024;
// the widest band: a window of (bw + 2)^2 slots, 32 a thread at most
constexpr int kMaxBandwidth = 179;
constexpr int kSolveWarps = 4;

// ---------------------------------------------------------------------------
// factor

template <typename T, bool kShared, int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
    factor_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const bool* __restrict__ due, int m, int bw) {
  if (due != nullptr && !*due) return;
  const int width = 2 * bw + 1;
  const int n = bw + 2;  // window rows and columns, cyclic
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t base = (size_t)blockIdx.x * m * width;
  const T* src = in + base;
  T* band = out + base;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lbuf = reinterpret_cast<T*>(smem_raw);  // the bw multipliers of a pivot
  T* stage = lbuf + bw;  // row and column p+bw+1, entering (kShared)
  T* win = stage + 2 * bw + 1;  // the window (kShared)
  const T zero = Zero<T>::get();
  auto at = [=](int r, int c) -> size_t {
    return (size_t)r * width + (c - r + bw);
  };

  // the factors are built in the output: copy the matrix there first
  for (int i = tid; i < m * width; i += nthreads) band[i] = src[i];

  int slot_rc[kSlots];  // (row slot << 16) | column slot, -1 past the window
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = tid + j * nthreads;
    slot_rc[j] = s < n * n ? ((s / n) << 16) | (s % n) : -1;
  }
  __syncthreads();
  if (kShared) {
    // the window at pivot 0: rows and columns 0 .. bw
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (slot_rc[j] < 0) continue;
      const int r = slot_rc[j] >> 16, c = slot_rc[j] & 0xffff;
      win[r * n + c] =
          (r <= bw && c <= bw && r < m && c < m) ? band[at(r, c)] : zero;
    }
    __syncthreads();
  }

  // the entries entering the window at pivot p are loaded at pivot p-1 by
  // the loader threads bw .. 3 bw, one each, staged in shared memory at
  // pivot p's (A): the load's latency stays off the chain.  Loader t = tid -
  // bw takes row p+bw+1 at column p+1+t (t <= bw), or column p+bw+1 at row
  // p+1+(t-bw-1)
  const int t_load = tid - bw;
  const bool loader = kShared && t_load >= 0 && t_load < 2 * bw + 1;
  auto entering = [=](int p) -> T {
    const int r = t_load <= bw ? p + bw + 1 : p + 1 + (t_load - bw - 1);
    const int c = t_load <= bw ? p + 1 + t_load : p + bw + 1;
    return (r < m && c < m) ? band[at(r, c)] : zero;
  };
  T next_in = zero;
  if (loader) next_in = entering(0);

  int pm = 0;  // p mod n
  for (int p = 0; p + 1 < m; ++p) {
    if (loader) {
      stage[t_load] = next_in;
      next_in = entering(p + 1);
    }
    // (A) the multipliers of pivot p, as the plain version divides
    if (tid < bw && p + 1 + tid < m) {
      const int r = p + 1 + tid;
      T a, piv;
      if (kShared) {
        int rs = pm + 1 + tid;
        if (rs >= n) rs -= n;
        a = win[rs * n + pm];
        piv = win[pm * n + pm];
      } else {
        a = band[at(r, p)];
        piv = band[at(p, p)];
      }
      const T l = a / piv;
      lbuf[tid] = l;
      band[at(r, p)] = l;
    }
    __syncthreads();
    // (B) the rank-1 update; row p-1 and column p-1 leave the window
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (slot_rc[j] < 0) continue;
      const int ri = slot_rc[j] >> 16, ci = slot_rc[j] & 0xffff;
      int offr = ri - pm;
      if (offr < 0) offr += n;
      int offc = ci - pm;
      if (offc < 0) offc += n;
      const int r = p + offr, c = p + offc;
      if (offr == n - 1) {
        if (kShared) {
          // old row p-1 (U) out, new row p + bw + 1 in
          T& w = win[ri * n + ci];
          const int co = offc == n - 1 ? p - 1 : c;
          if (p >= 1 && co <= p - 1 + bw && co < m) band[at(p - 1, co)] = w;
          w = c >= p + 1 ? stage[c - p - 1] : zero;
        }
      } else if (offc == n - 1) {
        // old column p-1 holds multipliers, written in (A); new column
        // p + bw + 1 in
        if (kShared) win[ri * n + ci] = r >= p + 1 ? stage[r + bw - p] : zero;
      } else if (offr > 0 && offc > 0 && r < m && c < m) {
        const T l = lbuf[offr - 1];
        if (kShared) {
          T& w = win[ri * n + ci];
          w = w - l * win[pm * n + ci];
        } else {
          band[at(r, c)] = band[at(r, c)] - l * band[at(p, c)];
        }
      }
    }
    __syncthreads();
    pm = pm + 1 == n ? 0 : pm + 1;
  }

  if (kShared) {
    // rows m-2 and m-1 are still in the window
    const int p = m - 1;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (slot_rc[j] < 0) continue;
      const int ri = slot_rc[j] >> 16, ci = slot_rc[j] & 0xffff;
      int offr = ri - pm;
      if (offr < 0) offr += n;
      int offc = ci - pm;
      if (offc < 0) offc += n;
      const T w = win[ri * n + ci];
      if (offr == n - 1) {
        const int co = offc == n - 1 ? p - 1 : p + offc;
        if (p >= 1 && co <= p - 1 + bw && co < m) band[at(p - 1, co)] = w;
      } else if (offr == 0 && offc == 0) {
        band[at(p, p)] = w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// solve

template <typename T>
__device__ __forceinline__ T lower_coef(const T* band, int m, int bw,
                                        int width, int j, int q) {
  // L[j + q, j] at band position bw - q of row j + q
  return (q >= 1 && q <= bw && j + q < m)
             ? band[(size_t)(j + q) * width + bw - q]
             : Zero<T>::get();
}

template <typename T>
__device__ __forceinline__ T upper_coef(const T* band, int bw, int width,
                                        int j, int q) {
  // U[j - q, j] at band position bw + q of row j - q
  return (q >= 1 && q <= bw && j - q >= 0)
             ? band[(size_t)(j - q) * width + bw + q]
             : Zero<T>::get();
}

template <typename T, int kS, int kD>
__global__ void __launch_bounds__(kSolveWarps * 32)
    solve_kernel(const T* __restrict__ lu, T* __restrict__ x,
                 const bool* __restrict__ active, int n_rhs, int n_blocks,
                 int m, int bw) {
  if (active != nullptr && !*active) return;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kSolveWarps + (threadIdx.x >> 5);
  if (g >= n_rhs) return;
  const int width = 2 * bw + 1;
  const T* band = lu + (size_t)(g % n_blocks) * m * width;
  T* v = x + (size_t)g * m;
  const T zero = Zero<T>::get();
  T pend[kS];
  T coef[kD][kS];
  T enter[kD];

  // forward substitution with the unit lower factor: pend[s] holds the
  // running value of row j + lane + 32 s
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int q = lane + 32 * s;
    pend[s] = q < m ? v[q] : zero;
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      coef[d][s] = lower_coef(band, m, bw, width, d, lane + 32 * s);
    enter[d] = (lane == 31 && d + 32 * kS < m) ? v[d + 32 * kS] : zero;
  }
  for (int j0 = 0; j0 < m; j0 += kD) {
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int j = j0 + d;
      if (j >= m) break;
      const T y = shfl(pend[0], 0);
      if (lane == 0) v[j] = y;
#pragma unroll
      for (int s = 0; s < kS; ++s) pend[s] = pend[s] - coef[d][s] * y;
      T next[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const T down = shfl_down(pend[s]);
        const T wrap = s + 1 < kS ? shfl(pend[(s + 1) % kS], 0) : enter[d];
        next[s] = lane == 31 ? wrap : down;
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) pend[s] = next[s];
      const int jn = j + kD;
#pragma unroll
      for (int s = 0; s < kS; ++s)
        coef[d][s] = lower_coef(band, m, bw, width, jn, lane + 32 * s);
      enter[d] = (lane == 31 && jn + 32 * kS < m) ? v[jn + 32 * kS] : zero;
    }
  }
  __syncwarp();

  // back substitution: pend[s] holds the running value of row j - lane -
  // 32 s, divided by U's diagonal when it reaches lane 0
  T diag[kD];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int q = lane + 32 * s;
    pend[s] = m - 1 - q >= 0 ? v[m - 1 - q] : zero;
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const int j = m - 1 - d;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      coef[d][s] = upper_coef(band, bw, width, j, lane + 32 * s);
    diag[d] = j >= 0 ? band[(size_t)j * width + bw] : zero;
    enter[d] = (lane == 31 && j - 32 * kS >= 0) ? v[j - 32 * kS] : zero;
  }
  for (int t0 = 0; t0 < m; t0 += kD) {
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int j = m - 1 - (t0 + d);
      if (j < 0) break;
      const T xj = shfl(pend[0], 0) / diag[d];
      if (lane == 0) v[j] = xj;
#pragma unroll
      for (int s = 0; s < kS; ++s) pend[s] = pend[s] - coef[d][s] * xj;
      T next[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const T down = shfl_down(pend[s]);
        const T wrap = s + 1 < kS ? shfl(pend[(s + 1) % kS], 0) : enter[d];
        next[s] = lane == 31 ? wrap : down;
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) pend[s] = next[s];
      const int jn = j - kD;
#pragma unroll
      for (int s = 0; s < kS; ++s)
        coef[d][s] = upper_coef(band, bw, width, jn, lane + 32 * s);
      diag[d] = jn >= 0 ? band[(size_t)jn * width + bw] : zero;
      enter[d] = (lane == 31 && jn - 32 * kS >= 0) ? v[jn - 32 * kS] : zero;
    }
  }
}

// ---------------------------------------------------------------------------
// host side

int factor_threads(int bw) {
  const int n = bw + 2;
  const int slots = n * n;
  const int threads = ((slots + 31) / 32) * 32;
  return threads < kMaxThreads ? threads : kMaxThreads;
}

int factor_slots(int bw) {
  const int n = bw + 2;
  const int per = (n * n + factor_threads(bw) - 1) / factor_threads(bw);
  int slots = 1;
  while (slots < per) slots *= 2;
  return slots;
}

long factor_smem(long elem, int bw, bool shared) {
  const long n = bw + 2;
  return elem * (bw + (shared ? 2 * bw + 1 + n * n : 0));
}

int device_optin(int* out) {
  static int cached[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 64 && cached[device] > 0) {
    *out = cached[device];
    return 0;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (device < 64) cached[device] = *out;
  return 0;
}

// the dynamic shared-memory limit of fn raised to the device's opt-in
// limit, once a device
template <typename Fn>
int allow_smem(Fn fn, long bytes, unsigned long long* done_mask) {
  if (bytes <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (*done_mask & bit) return 0;
  int limit = 0;
  const int lerr = device_optin(&limit);
  if (lerr) return lerr;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return (int)err;
  *done_mask |= bit;
  return 0;
}

template <typename T, bool kShared, int kSlots>
int launch_factor_as(const void* in, void* out, const void* due, int n_blocks,
                     int m, int bw, cudaStream_t stream) {
  static unsigned long long done_mask = 0;
  const long smem = factor_smem(sizeof(T), bw, kShared);
  int err = allow_smem(factor_kernel<T, kShared, kSlots>, smem, &done_mask);
  if (err) return err;
  factor_kernel<T, kShared, kSlots>
      <<<n_blocks, factor_threads(bw), (size_t)smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const bool*>(due), m, bw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor(const void* in, void* out, const void* due, int n_blocks,
                  int m, int bw, cudaStream_t stream) {
  int limit = 0;
  const int err = device_optin(&limit);
  if (err) return err;
  const int slots = factor_slots(bw);
  if (factor_smem(sizeof(T), bw, true) > limit) {
    // a window past the shared memory has 16 slots a thread or more
    if (slots <= 16)
      return launch_factor_as<T, false, 16>(in, out, due, n_blocks, m, bw, stream);
    return launch_factor_as<T, false, 32>(in, out, due, n_blocks, m, bw, stream);
  }
  if (slots <= 1)
    return launch_factor_as<T, true, 1>(in, out, due, n_blocks, m, bw, stream);
  if (slots <= 4)
    return launch_factor_as<T, true, 4>(in, out, due, n_blocks, m, bw, stream);
  if (slots <= 16)
    return launch_factor_as<T, true, 16>(in, out, due, n_blocks, m, bw, stream);
  return launch_factor_as<T, true, 32>(in, out, due, n_blocks, m, bw, stream);
}

template <typename T, int kS, int kD>
int launch_solve_as(const void* lu, void* x, const void* active, int n_rhs,
                    int n_blocks, int m, int bw, cudaStream_t stream) {
  const int grid = (n_rhs + kSolveWarps - 1) / kSolveWarps;
  solve_kernel<T, kS, kD><<<grid, kSolveWarps * 32, 0, stream>>>(
      static_cast<const T*>(lu), static_cast<T*>(x),
      static_cast<const bool*>(active), n_rhs, n_blocks, m, bw);
  return (int)cudaGetLastError();
}

// rows a lane holds: every offset 1 .. bw at once
int solve_slots(int bw) {
  int s = 1;
  while (32 * s < bw + 1) s *= 2;
  return s;
}

template <typename T>
int launch_solve(const void* lu, void* x, const void* active, int n_rhs,
                 int n_blocks, int m, int bw, cudaStream_t stream) {
  switch (solve_slots(bw)) {
    case 1: return launch_solve_as<T, 1, 16>(lu, x, active, n_rhs, n_blocks, m, bw, stream);
    case 2: return launch_solve_as<T, 2, 8>(lu, x, active, n_rhs, n_blocks, m, bw, stream);
    case 4: return launch_solve_as<T, 4, 6>(lu, x, active, n_rhs, n_blocks, m, bw, stream);
    case 8: return launch_solve_as<T, 8, 3>(lu, x, active, n_rhs, n_blocks, m, bw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype codes: 0 float32, 1 float64, 2 complex64, 3 complex128
long element_bytes(int dtype) {
  switch (dtype) {
    case 0: return 4;
    case 1: return 8;
    case 2: return 8;
    case 3: return 16;
    default: return 0;
  }
}

}  // namespace

extern "C" {

const char* banded_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// where a factorisation of `dtype` at half-width bw runs on the current
// device: *threads a block, *shared 1 when its window fits in shared
// memory (else it updates the band in device memory), *smem bytes
int banded_lu_factor_plan(int dtype, int bw, int* threads, int* shared,
                          long* smem) {
  const long elem = element_bytes(dtype);
  if (elem == 0 || bw < 0 || bw > kMaxBandwidth)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int err = device_optin(&limit);
  if (err) return err;
  *threads = factor_threads(bw);
  *shared = factor_smem(elem, bw, true) <= limit ? 1 : 0;
  *smem = factor_smem(elem, bw, *shared != 0);
  return 0;
}

// factor n_blocks row-band matrices (m, 2 bw + 1) of `in` into `out`
// (distinct, contiguous); when `due` is not null, a device bool read by
// the kernel, nothing happens where it is false
int banded_lu_factor_launch(int dtype, const void* in, void* out,
                            const void* due, int n_blocks, int m, int bw,
                            void* stream) {
  if (n_blocks <= 0 || m <= 0 || bw < 0 || bw > kMaxBandwidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_factor<float>(in, out, due, n_blocks, m, bw, st);
    case 1: return launch_factor<double>(in, out, due, n_blocks, m, bw, st);
    case 2: return launch_factor<Complex<float>>(in, out, due, n_blocks, m, bw, st);
    case 3: return launch_factor<Complex<double>>(in, out, due, n_blocks, m, bw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// solve in place: x holds n_rhs right-hand sides of m rows, the g-th
// against matrix g mod n_blocks of lu; when `active` is not null, a device
// bool read by the kernel, x is left as it is where it is false
int banded_lu_solve_launch(int dtype, const void* lu, void* x,
                           const void* active, int n_rhs, int n_blocks, int m,
                           int bw, void* stream) {
  if (n_rhs <= 0 || n_blocks <= 0 || m <= 0 || bw < 0 || bw > kMaxBandwidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_solve<float>(lu, x, active, n_rhs, n_blocks, m, bw, st);
    case 1: return launch_solve<double>(lu, x, active, n_rhs, n_blocks, m, bw, st);
    case 2: return launch_solve<Complex<float>>(lu, x, active, n_rhs, n_blocks, m, bw, st);
    case 3: return launch_solve<Complex<double>>(lu, x, active, n_rhs, n_blocks, m, bw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
