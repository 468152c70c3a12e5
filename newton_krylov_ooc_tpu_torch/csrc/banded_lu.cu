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
// are diagonally dominant).  Entries outside the matrix keep the input's
// values, as the plain version leaves them.
//
// What bounds it on this card.  Both are chains: the factor a chain of m
// pivots, each a rank-1 update of a bw x bw block that needs the pivot
// before it; the solves a chain of m rows each way.  A factorisation moves
// m (2 bw + 1) elements and does about m bw^2 multiply-adds, so at the
// Radau shapes (m <= 6000, bw <= 120) the bytes take microseconds and the
// arithmetic of one matrix fits one SM; the time is the m steps of the
// chain.  Measured (cli/profile_banded.py): a pivot takes ~1,000 SM cycles
// in float64 at bw = 30 (~1,400 complex128), where each warp issues ~200
// dependent instructions (the exchanges, the shift, the entering row, the
// update) between two barriers; a solve's row step ~170-350.
//
// Design.
//   * Factor: one block a matrix, sized to the band: warp 0 holds three
//     columns (the pivot's, the next pivot's, the one after), each other
//     warp C consecutive columns (10; 6 at S = 2): 1 + ceil((bw - 2) / C)
//     warps.  Rows are lanes: row r in lane r mod 32, slot (r / 32) mod S,
//     NR = 32 S >= bw + 2 rows held, cyclic.  Every role is fixed in the
//     code: the columns are held relative to the pivot, and after each
//     pivot every warp moves its columns down a register slot and passes
//     its lowest one to the warp below through shared memory; the top one
//     enters from device memory, loaded two pivots ahead.  The window lives
//     in registers, except for complex128 at S = 3 and every S >= 4, whose
//     warps 1.. keep it in thread-private slots of shared memory (device
//     memory where it does not fit), a ring over the column slots.
//   * One barrier a pivot, the next pivot's multipliers formed ahead: at
//     pivot p warp 0 applies p's update to column p + 1 first, takes the
//     new pivot by a shuffle and divides (the IEEE division the plain
//     version does), leaves the multipliers in a double-buffered exchange
//     in shared memory, then updates its third column; meanwhile the other
//     warps take pivot p's multipliers from the exchange and the pivot
//     row's entries from the lane that holds row p (through shared memory)
//     and update theirs.
//   * Row p (U) leaves as each warp's lane j writes its j-th column's entry;
//     row p + NR enters as lane j loads its j-th entry two pivots ahead (a
//     coalesced load) and hands it to lane p mod 32 through shared memory.
//     Every held slot is updated every pivot; entries outside the band are
//     zero and stay zero.
//   * Both Radau stage systems in one launch: blocks [0, n_r) factor the
//     real matrices and blocks [n_r, n_r + n_c) the complex ones (the
//     same bw and rows), under the same flag.
//   * Solves: one warp per (matrix, right-hand side), right-looking, row r
//     in lane r mod 32 (slot (r / 32) mod S), so a row's substitution is
//     one shuffle broadcast and one multiply-add in each lane, and no value
//     moves between lanes.  L's and U's coefficients and the entering
//     right-hand sides are loaded 4 to 8 rows ahead; U's diagonals are
//     prepared as divisors (a reciprocal, or the complex scaled division's
//     ratio and scale) 32 rows at a time, a row a lane, a batch ahead: the
//     back substitution has no division on its chain.  A pair launch
//     solves a real and a complex system, a warp each.
//   * Rounding: a pivot's update and a row's substitution are the textbook
//     operations in the textbook order, the complex product's contraction
//     fixed (it would otherwise change with the block's shape) and the back
//     substitution's divisor rounding as its division: the factors and
//     solutions do not depend on the launch's shape.
//   * The caller's stream, outputs allocated by the caller: the launches
//     are captured in CUDA graphs (ops/radau.py).  The factor and the
//     solves take an optional device flag and return at once when it is
//     false, so that a graph replays the factorisations and solves a step
//     attempt needs, and no others, without a host branch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// clock marks for cli/profile_banded.py, which defines them in an
// instrumented copy of this file; empty here
#ifndef PROBE_DECL
#define PROBE_DECL
#define PROBE_START
#define PROBE_MARK(k)
#define PROBE_FLUSH
#define SPROBE_DECL
#define SPROBE_START
#define SPROBE_MARK(k)
#endif

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
};

template <typename T>
struct Num {
  __device__ static T zero() { return T(0); }
};
template <typename R>
struct Num<Complex<R>> {
  __device__ static Complex<R> zero() { return {R(0), R(0)}; }
};

// the complex product with its contraction fixed: the first product of
// each part fused into a multiply-add, the second rounded alone (the
// compiler would pick either, instantiation by instantiation)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename R>
__device__ __forceinline__ Complex<R> operator*(Complex<R> a, Complex<R> b) {
  return {fma_rn(a.re, b.re, -mul_rn(a.im, b.im)),
          fma_rn(a.re, b.im, mul_rn(a.im, b.re))};
}

// the solves' p - c y: real, one multiply-add; complex, the product's
// contraction fixed as operator*'s
template <typename T>
__device__ __forceinline__ T sub_mul(T p, T c, T y) { return p - c * y; }
template <typename R>
__device__ __forceinline__ Complex<R> sub_mul(Complex<R> p, Complex<R> c,
                                              Complex<R> y) {
  return {p.re - fma_rn(c.re, y.re, -mul_rn(c.im, y.im)),
          p.im - fma_rn(c.re, y.im, mul_rn(c.im, y.re))};
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

// a divisor prepared off a chain: apply(a) is a / b with no division in
// it, rounded as dividing (real: the reciprocal's quotient corrected by one
// exact multiply-add, Markstein's, which rounds as the IEEE division;
// complex: the scaled division above with its ratio and scale formed
// ahead, its products rounded before the adds)
template <typename T>
struct Divisor {
  T b, inv;
  __device__ __forceinline__ void prepare(T d) {
    b = d;
    inv = T(1) / d;
  }
  __device__ __forceinline__ T apply(T a) const {
    const T q = a * inv;
    return fma(inv, fma(-q, b, a), q);
  }
};
template <typename R>
struct Divisor<Complex<R>> {
  R rat, scl;
  bool wide;
  __device__ __forceinline__ void prepare(Complex<R> b) {
    const R c = b.re, d = b.im;
    wide = fabs(c) >= fabs(d);
    rat = wide ? d / c : c / d;
    scl = R(1) / (wide ? fma_rn(d, rat, c) : fma_rn(c, rat, d));
  }
  __device__ __forceinline__ Complex<R> apply(Complex<R> a) const {
    if (wide)
      return {mul_rn(a.re + mul_rn(a.im, rat), scl),
              mul_rn(a.im - mul_rn(a.re, rat), scl)};
    return {mul_rn(mul_rn(a.re, rat) + a.im, scl),
            mul_rn(mul_rn(a.im, rat) - a.re, scl)};
  }
};

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
__device__ __forceinline__ Divisor<T> shfl(const Divisor<T>& v, int src) {
  return {shfl(v.b, src), shfl(v.inv, src)};
}
template <typename R>
__device__ __forceinline__ Divisor<Complex<R>> shfl(
    const Divisor<Complex<R>>& v, int src) {
  Divisor<Complex<R>> out;
  out.rat = shfl(v.rat, src);
  out.scl = shfl(v.scl, src);
  out.wide = __shfl_sync(0xffffffffu, (int)v.wide, src) != 0;
  return out;
}

// out = *p where pred, else zero, as one predicated load into the register
// itself: no instruction waits for the data before out's next use (a load
// then a select, or a copy, would stall right away)
__device__ __forceinline__ void load_if(float& out, const float* p, bool pred) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @!q mov.f32 %0, 0f00000000;\n @q ld.global.nc.f32 %0, [%1];\n}"
      : "=f"(out) : "l"(p), "r"((int)pred));
}
__device__ __forceinline__ void load_if(double& out, const double* p,
                                        bool pred) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @!q mov.f64 %0, 0d0000000000000000;\n"
      " @q ld.global.nc.f64 %0, [%1];\n}"
      : "=d"(out) : "l"(p), "r"((int)pred));
}
template <typename R>
__device__ __forceinline__ void load_if(Complex<R>& out, const Complex<R>* p,
                                        bool pred) {
  load_if(out.re, &p->re, pred);
  load_if(out.im, &p->im, pred);
}
// the same from memory this kernel writes (the solves' right-hand sides),
// ordered with the kernel's other memory accesses
__device__ __forceinline__ void load_rw_if(float& out, const float* p,
                                           bool pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @!q mov.f32 %0, 0f00000000;\n @q ld.global.f32 %0, [%1];\n}"
               : "=f"(out) : "l"(p), "r"((int)pred) : "memory");
}
__device__ __forceinline__ void load_rw_if(double& out, const double* p,
                                           bool pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @!q mov.f64 %0, 0d0000000000000000;\n"
               " @q ld.global.f64 %0, [%1];\n}"
               : "=d"(out) : "l"(p), "r"((int)pred) : "memory");
}
template <typename R>
__device__ __forceinline__ void load_rw_if(Complex<R>& out,
                                           const Complex<R>* p, bool pred) {
  load_rw_if(out.re, &p->re, pred);
  load_rw_if(out.im, &p->im, pred);
}

__host__ __device__ constexpr int pos_mod(int a, int n) {
  return a % n < 0 ? a % n + n : a % n;
}

constexpr int kMaxBandwidth = 179;
// a matrix's elements, addressed with 32-bit offsets
constexpr long kMaxElements = 0x7fffffffL;

// the factor's shape: S row slots a lane (32 S >= bw + 2; the bands past
// 126 all at S = 6, which keeps the build short), C column slots a thread
// beyond warp 0's 3, 3 + (W - 1) C >= bw + 1 columns held
__host__ __device__ constexpr int factor_row_slots(int bw) {
  return (bw + 2 + 31) / 32 > 4 ? 6 : (bw + 2 + 31) / 32;
}
// (measured on the card at the path's shapes: 10 columns a warp at S = 1,
// 6 at S = 2, cli/profile_banded.py's shapes)
__host__ __device__ constexpr int factor_col_slots(int s) {
  return s == 2 ? 6 : 10;
}
// warp 0 holds 3 columns, the others C each
__host__ __device__ constexpr int factor_warps(int bw, int c) {
  return 1 + (bw > 2 ? (bw - 2 + c - 1) / c : 0);
}
__host__ __device__ constexpr int factor_max_warps(int s) {
  return factor_warps(32 * s - 2, factor_col_slots(s));
}
// the window in registers: complex128 at S = 3 and every S >= 4 keep it in
// thread-private slots of memory instead
__host__ __device__ constexpr bool factor_in_registers(int s, long elem) {
  return s <= 2 || (s == 3 && elem <= 8);
}

// out = A[r, c] of the input bands, zero outside the band and the matrix
template <typename T>
__device__ __forceinline__ void band_at(T& out, const T* __restrict__ src,
                                        int m, int bw, int r, int c) {
  const int d = c - r;
  load_if(out, src + r * (2 * bw + 1) + d + bw,
          r < m && c < m && d <= bw && d >= -bw);
}

// a thread's C x S share of the window in warps 1 .. W-1, column slot j
// at relative column base + j: registers (kReg), or its slots in memory, a
// ring over the column slots (element (j, s) at base[(((j + off) mod C) S
// + s) stride]).  shift() moves every column down one slot
template <typename T, int S, int C, bool kReg>
struct Window;

template <typename T, int S, int C>
struct Window<T, S, C, true> {
  T v[C][S];
  __device__ __forceinline__ T& at(int j, int s) { return v[j][s]; }
  // slot s_dyn of column slot j, s_dyn not known at compile time
  __device__ __forceinline__ T get(int j, int s_dyn) {
    T out = v[j][0];
#pragma unroll
    for (int s = 1; s < S; ++s)
      if (s == s_dyn) out = v[j][s];
    return out;
  }
  __device__ __forceinline__ void set(int j, int s_dyn, T val) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s == s_dyn) v[j][s] = val;
  }
  __device__ __forceinline__ void shift() {
#pragma unroll
    for (int j = 0; j + 1 < C; ++j)
#pragma unroll
      for (int s = 0; s < S; ++s) v[j][s] = v[j + 1][s];
  }
};

template <typename T, int S, int C>
struct Window<T, S, C, false> {
  T* base;
  int stride;
  int off = 0;
  __device__ __forceinline__ T& at(int j, int s) {
    int slot = j + off;
    if (slot >= C) slot -= C;
    return base[(slot * S + s) * stride];
  }
  __device__ __forceinline__ T get(int j, int s_dyn) { return at(j, s_dyn); }
  __device__ __forceinline__ void set(int j, int s_dyn, T val) {
    at(j, s_dyn) = val;
  }
  __device__ __forceinline__ void shift() { off = off + 1 == C ? 0 : off + 1; }
};

template <typename T, int S>
__device__ __forceinline__ T pick(const T (&v)[S], int s_dyn) {
  T out = v[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (s == s_dyn) out = v[s];
  return out;
}

template <typename T, int S>
__device__ __forceinline__ void put(T (&v)[S], int s_dyn, T val) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s == s_dyn) v[s] = val;
}

// ---------------------------------------------------------------------------
// factor

// one matrix, by the whole block: src (m, 2 bw + 1) into dst.  shared:
// the multipliers' exchange (2 NR elements), the columns passed down
// between warps (2 W NR), each warp's pivot row and entering row (2 W C);
// slots: the memory windows (C S blockDim.x elements)
template <typename T, int S, int C, bool kReg>
__device__ void factor_matrix(const T* __restrict__ src, T* __restrict__ dst,
                              T* slots, T* shared, int m, int bw) {
  constexpr int NR = 32 * S;
  const int width = 2 * bw + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5;
  const int NC = 3 + (W - 1) * C;  // columns held
  // warp 0 holds the relative columns 0, 1, 2 (pivot, look-ahead, next),
  // warp w > 0 the relative columns base .. base + C - 1
  const int base = warp == 0 ? 0 : 3 + (warp - 1) * C;
  const int nslots = warp == 0 ? 3 : C;
  const bool top_in = warp == W - 1;  // its top column enters from src
  T* lbuf = shared;                    // 2 NR: the multipliers, by parity
  T* xbuf = lbuf + 2 * NR;             // 2 W NR: columns passed down
  T* ubuf = xbuf + 2 * W * NR + warp * 2 * C;  // the pivot row's entries
  T* rowbuf = ubuf + C;                // the entering row's entries
  const T zero = Num<T>::zero();
  PROBE_DECL

  // entries outside the matrix: the input's
  for (int i = tid; i < bw * bw; i += blockDim.x) {
    const int r = i / bw, d = i % bw;
    if (d >= bw - r) continue;
    if (r < m) dst[r * width + d] = src[r * width + d];
    const int rb = m - 1 - r;
    if (rb >= 0)
      dst[rb * width + 2 * bw - d] = src[rb * width + 2 * bw - d];
  }

  // rows [p, p + NR) at pivot p, row r in lane r mod 32, slot (r / 32) mod
  // S; r_s: the row slot s holds
  int r_s[S];
#pragma unroll
  for (int s = 0; s < S; ++s) r_s[s] = 32 * s + lane;
  T a0[S], a1[S], a2[S];  // warp 0's columns
  Window<T, S, C, kReg> win;  // the other warps'
  if constexpr (!kReg) {
    win.base = slots + tid;
    win.stride = blockDim.x;
  }
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      band_at(a0[s], src, m, bw, r_s[s], 0);
      band_at(a1[s], src, m, bw, r_s[s], 1);
      band_at(a2[s], src, m, bw, r_s[s], 2);
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        T v;
        band_at(v, src, m, bw, r_s[s], base + j);
        win.at(j, s) = v;
      }
  }

  // row p + NR enters at pivot p (into lane p mod 32) at the columns the
  // warp holds then, p + base + j: lane j loads the j-th two pivots ahead
  // (a coalesced load), by pivot parity
  T rin[2];
  auto row_entries = [&](int p, T& out) {
    const int c = p + base + lane;
    band_at(out, src, m, bw, lane < nslots ? p + NR : m, c);
  };
  // column p - 1 + NC enters the top slot of warp W - 1 at pivot p, at the
  // rows held then, [p, p + NR); staged 2 pivots ahead, by pivot parity
  T cin[2][S];
  auto col_entries = [&](int p, T* out) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      band_at(out[s], src, m, bw, p + pos_mod(32 * s + lane - p, NR),
              p - 1 + NC);
  };
  row_entries(0, rin[0]);
  row_entries(1, rin[1]);
  if (top_in) col_entries(1, cin[1]);

  // pivot 0's multipliers
  T lw[S];  // warp 0's: the current pivot's multipliers
  if (warp == 0) {
    const T piv = shfl(a0[0], 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = r_s[s];
      T l = zero;
      if (r > 0 && r <= bw && r < m) {
        l = a0[s] / piv;
        a0[s] = l;
      }
      lw[s] = l;
      lbuf[32 * s + lane] = l;
    }
  }
  __syncthreads();
  PROBE_START

  // pivot p, P = p mod 2
  auto pivot = [&](int p, auto parity) {
    constexpr int P = decltype(parity)::value;
    const int lp = p & 31, sp = (p >> 5) % S;
    const bool ahead = p + 1 < m;
    // the top column in: from the warp above, or from src
    if (p > 0) {
      if (top_in) {
        if (warp == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) a2[s] = cin[P][s];
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) win.at(C - 1, s) = cin[P][s];
        }
      } else {
        const T* from = xbuf + ((1 - P) * W + warp + 1) * NR;
        if (warp == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) a2[s] = from[32 * s + lane];
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) win.at(C - 1, s) = from[32 * s + lane];
        }
      }
    }
    if (top_in) col_entries(p + 2, cin[P]);

    if (warp == 0) {
      // pivot p + 1's multipliers first: its column's update, the new
      // pivot, the division (as the plain version divides)
      const T u1 = shfl(pick(a1, sp), lp);
      T ln[S];
#pragma unroll
      for (int s = 0; s < S; ++s) ln[s] = zero;
      if (ahead) {
        const int lq = (p + 1) & 31, sq = ((p + 1) >> 5) % S;
#pragma unroll
        for (int s = 0; s < S; ++s) a1[s] = a1[s] - lw[s] * u1;
        const T piv = shfl(pick(a1, sq), lq);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int r = r_s[s];
          if (r > p + 1 && r <= p + 1 + bw && r < m) {
            ln[s] = a1[s] / piv;
            a1[s] = ln[s];
          }
          lbuf[(1 - P) * NR + 32 * s + lane] = ln[s];
        }
      }
      PROBE_MARK(0)
      const T u2 = shfl(pick(a2, sp), lp);
      if (ahead) {
#pragma unroll
        for (int s = 0; s < S; ++s) a2[s] = a2[s] - lw[s] * u2;
      }
      // column p leaves: U's diagonal and L's multipliers out
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = r_s[s];
        if (r == p)
          dst[p * width + bw] = a0[s];
        else if (r > p && r <= p + bw && r < m)
          dst[r * width + p - r + bw] = a0[s];
      }
      // row p leaves: U's row out at columns p + 1, p + 2 (lanes 1, 2);
      // row p + NR in
      {
        const int c = p + lane;
        if ((lane == 1 || lane == 2) && c <= p + bw && c < m)
          dst[p * width + c - p + bw] = lane == 1 ? u1 : u2;
        const T x1 = shfl(rin[P], 1), x2 = shfl(rin[P], 2);
        if (lane == lp) {
          put(a1, sp, x1);
          put(a2, sp, x2);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        a0[s] = a1[s];
        a1[s] = a2[s];
        lw[s] = ln[s];
      }
    } else {
      T l[S];
#pragma unroll
      for (int s = 0; s < S; ++s) l[s] = lbuf[P * NR + 32 * s + lane];
      // the pivot row's entries, from lane p mod 32 through shared memory
      if (lane == lp) {
#pragma unroll
        for (int j = 0; j < C; ++j) ubuf[j] = win.get(j, sp);
      }
      __syncwarp();
      T u[C];
#pragma unroll
      for (int j = 0; j < C; ++j) u[j] = ubuf[j];
      PROBE_MARK(1)
      if (ahead) {
#pragma unroll
        for (int j = 0; j < C; ++j)
#pragma unroll
          for (int s = 0; s < S; ++s) win.at(j, s) = win.at(j, s) - l[s] * u[j];
      }
      // row p leaves: U's row out (lane j its j-th column); row p + NR in
      {
        T mine = u[0];
#pragma unroll
        for (int j = 1; j < C; ++j)
          if (j == lane) mine = u[j];
        const int c = p + base + lane;
        if (lane < C && c <= p + bw && c < m)
          dst[p * width + c - p + bw] = mine;
        // lane j's entry into lane p mod 32, through shared memory
        if (lane < C) rowbuf[lane] = rin[P];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const T x = rowbuf[j];
          if (lane == lp) win.set(j, sp, x);
        }
      }
      // the lowest column down to the warp below
      T* to = xbuf + (P * W + warp) * NR;
#pragma unroll
      for (int s = 0; s < S; ++s) to[32 * s + lane] = win.at(0, s);
      win.shift();
    }
    row_entries(p + 2, rin[P]);
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s == sp && lane == lp) r_s[s] += NR;
    PROBE_MARK(1)
    __syncthreads();
    PROBE_MARK(2)
  };
  for (int p = 0; p < m; p += 2) {
    pivot(p, std::integral_constant<int, 0>());
    if (p + 1 < m) pivot(p + 1, std::integral_constant<int, 1>());
  }
  PROBE_FLUSH
}

// blocks [0, n_r) factor real matrices R, blocks [n_r, n_r + n_c) complex
// ones; slots_r / slots_c: the memory windows in device memory (a matrix's
// C S blockDim.x elements each), or null where they live in shared memory
// after the exchange (memory windows) or in registers
template <typename R, int S, bool kRegR, bool kRegC>
__global__ void __launch_bounds__(32 * factor_max_warps(S))
    factor_kernel(const R* __restrict__ in_r, R* __restrict__ out_r, int n_r,
                  const Complex<R>* __restrict__ in_c,
                  Complex<R>* __restrict__ out_c, R* slots_r,
                  Complex<R>* slots_c, const bool* __restrict__ due, int m,
                  int bw) {
  if (due != nullptr && !*due) return;
  constexpr int C = factor_col_slots(S);
  constexpr int NR = 32 * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t mat = (size_t)m * (2 * bw + 1);
  const size_t slot_elems = (size_t)C * S * blockDim.x;
  // the exchanges, then the memory windows where they live in shared memory
  const int exchange = (2 + 2 * (int)(blockDim.x >> 5)) * NR +
                       2 * (int)(blockDim.x >> 5) * C;
  if ((int)blockIdx.x < n_r) {
    R* shared = reinterpret_cast<R*>(smem_raw);
    R* slots = slots_r ? slots_r + blockIdx.x * slot_elems : shared + exchange;
    factor_matrix<R, S, C, kRegR>(in_r + blockIdx.x * mat,
                                  out_r + blockIdx.x * mat, slots, shared, m,
                                  bw);
  } else {
    const int b = blockIdx.x - n_r;
    Complex<R>* shared = reinterpret_cast<Complex<R>*>(smem_raw);
    Complex<R>* slots = slots_c ? slots_c + b * slot_elems : shared + exchange;
    factor_matrix<Complex<R>, S, C, kRegC>(in_c + b * mat, out_c + b * mat,
                                           slots, shared, m, bw);
  }
}

// ---------------------------------------------------------------------------
// solve

// rows prefetched ahead, by rows a lane holds
__host__ __device__ constexpr int solve_depth(int s) { return s <= 2 ? 8 : 4; }

// one sweep over the rows of one right-hand side v, by one warp: forward
// with L (unit diagonal), or back with U.  Step t takes row t (forward) or
// m - 1 - t (back); at step t the warp holds rows t .. t + NR - 1 in step
// order, step t + k in lane (t + k) mod 32, slot ((t + k) / 32) mod S.
// The coefficients and the entering right-hand sides are loaded D steps
// ahead (D divides 32); back, U's diagonals are prepared as divisors
// (Divisor: the division's rounding, no division on the chain) 32 rows at a
// time, a row a lane, a batch ahead, and each broadcast D steps ahead
template <typename T, int S, bool kBack>
__device__ __forceinline__ void sweep(const T* __restrict__ band, T* v, int m,
                                      int bw, int lane) {
  constexpr int NR = 32 * S;
  constexpr int D = solve_depth(S);
  const int width = 2 * bw + 1;
  // step t takes row row0 + dir t; offsets move by dir a step
  constexpr int dir = kBack ? -1 : 1;
  const int row0 = kBack ? m - 1 : 0;
  // the coefficients' cursor, at the step tc they are loaded for: slot s
  // holds step q[s] = tc + k[s] (k[s] = (32 s + lane - tc) mod NR), whose
  // row starts at element roff[s]; what step tc's value is multiplied by
  // for it: L[row(q), row(tc)] at roff + bw - k forward, U[row(q),
  // row(tc)] at roff + bw + k back
  int k[S], q[S], roff[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    k[s] = 32 * s + lane;
    q[s] = k[s];
    roff[s] = (row0 + dir * q[s]) * width;
  }
  auto coefs = [&](T* out) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      load_if(out[s], band + roff[s] + bw - dir * k[s],
              k[s] >= 1 && k[s] <= bw && q[s] < m);
  };
  auto advance = [&]() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (--k[s] < 0) {
        k[s] += NR;
        q[s] += NR;
        roff[s] += dir * NR * width;
      }
    }
  };

  T pend[S];  // the running value of the row slot s holds
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int st = 32 * s + lane;
    load_rw_if(pend[s], v + row0 + dir * st, st < m);
  }
  // by step mod D: the coefficients, the entering right-hand side (step
  // t + NR's, which lane t mod 32 installs at step t; loaded by every lane,
  // one address), back U's diagonal and its reciprocal
  T cf[D][S], ent[D];
  int vout = row0;                      // row(t)
  int vin = row0 + dir * (D + NR);      // row(t + D + NR)
  // back: lane q's divisors of steps 32 b + q (cur) and 32 (b + 1) + q
  // (nxt) in batch b, the diagonal of step 32 (b + 2) + q, and by step mod
  // D the divisor of step t + D, broadcast
  Divisor<T> cur, nxt, dv[kBack ? D : 1];
  T dgl;
  // (past the last row: zero, a divisor that is never applied)
  auto diag = [&](int t, T& out) {
    load_if(out, band + (row0 + dir * t) * width + bw, t < m);
  };
  if constexpr (kBack) {
    T d0;
    diag(lane, d0);
    cur.prepare(d0);
    diag(32 + lane, d0);
    nxt.prepare(d0);
    diag(64 + lane, dgl);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    coefs(cf[d]);
    advance();
    load_rw_if(ent[d], v + row0 + dir * (d + NR), d + NR < m);
    if constexpr (kBack) dv[d] = shfl(cur, d);
  }
  for (int t0 = 0; t0 < m; t0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 + d;
      if (t >= m) break;
      if constexpr (kBack) {
        if (d == 0 && (t & 31) == 0 && t > 0) {  // a new batch
          cur = nxt;
          nxt.prepare(dgl);
          diag(t + 64 + lane, dgl);
        }
      }
      const int lt = t & 31, st = (t >> 5) % S;
      T y = pend[0];
#pragma unroll
      for (int s = 1; s < S; ++s)
        if (s == st) y = pend[s];
      y = shfl(y, lt);
      if constexpr (kBack) y = dv[d].apply(y);
      if (lane == lt) v[vout] = y;
      vout += dir;
#pragma unroll
      for (int s = 0; s < S; ++s) pend[s] = sub_mul(pend[s], cf[d][s], y);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s == st && lane == lt) pend[s] = ent[d];
      load_rw_if(ent[d], v + vin, t + D + NR < m);
      vin += dir;
      coefs(cf[d]);
      advance();
      if constexpr (kBack)
        dv[d] = shfl((t & 31) + D < 32 ? cur : nxt, (t + D) & 31);
    }
  }
}

template <typename T, int S>
__device__ void solve_rhs(const T* __restrict__ band, T* v, int m, int bw,
                          int lane) {
  SPROBE_DECL
  SPROBE_START
  sweep<T, S, false>(band, v, m, bw, lane);
  __syncwarp();
  SPROBE_MARK(0)
  sweep<T, S, true>(band, v, m, bw, lane);
  SPROBE_MARK(1)
}

// one warp a block: blocks [0, rhs_r) solve the real right-hand sides (the
// g-th against matrix g mod blocks_r), the rest the complex ones
template <typename R, int S>
__global__ void __launch_bounds__(32)
    solve_kernel(const R* __restrict__ lu_r, R* x_r, int rhs_r, int blocks_r,
                 const Complex<R>* __restrict__ lu_c, Complex<R>* x_c,
                 int blocks_c, const bool* __restrict__ active, int m,
                 int bw) {
  if (active != nullptr && !*active) return;
  const int lane = threadIdx.x & 31;
  const size_t mat = (size_t)m * (2 * bw + 1);
  const int g = blockIdx.x;
  if (g < rhs_r) {
    solve_rhs<R, S>(lu_r + (g % blocks_r) * mat, x_r + (size_t)g * m, m, bw,
                    lane);
  } else {
    const int h = g - rhs_r;
    solve_rhs<Complex<R>, S>(lu_c + (h % blocks_c) * mat, x_c + (size_t)h * m,
                             m, bw, lane);
  }
}

// ---------------------------------------------------------------------------
// host side

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

// where a factorisation of elements of `elem` bytes at half-width bw runs
struct FactorPlan {
  int threads;
  int where;     // the window: 0 registers, 1 shared memory, 2 device memory
  long smem;     // dynamic shared memory a block
  long scratch;  // device-memory window bytes a matrix (where == 2)
};

FactorPlan factor_plan_for(long elem, int bw, int optin) {
  const int s = factor_row_slots(bw);
  const int c = factor_col_slots(s);
  FactorPlan plan;
  const int warps = factor_warps(bw, c);
  plan.threads = 32 * warps;
  const long exchange = ((2L + 2L * warps) * 32 * s + 2L * warps * c) * elem;
  const long slots = (long)c * s * plan.threads * elem;
  plan.where = factor_in_registers(s, elem) ? 0
               : exchange + slots <= optin ? 1 : 2;
  plan.smem = exchange + (plan.where == 1 ? slots : 0);
  plan.scratch = plan.where == 2 ? slots : 0;
  return plan;
}

template <typename R, int S>
int launch_factor_as(const void* in_r, void* out_r, int n_r, const void* in_c,
                     void* out_c, int n_c, void* scratch, const void* due,
                     int m, int bw, cudaStream_t stream) {
  constexpr bool kRegR = factor_in_registers(S, sizeof(R));
  constexpr bool kRegC = factor_in_registers(S, sizeof(Complex<R>));
  static unsigned long long done_mask = 0;
  int optin = 0;
  int err = device_optin(&optin);
  if (err) return err;
  const FactorPlan pr = factor_plan_for(sizeof(R), bw, optin);
  const FactorPlan pc = factor_plan_for(sizeof(Complex<R>), bw, optin);
  if ((pr.where == 0) != kRegR || (pc.where == 0) != kRegC)
    return (int)cudaErrorInvalidValue;
  long smem = 0;
  if (n_r > 0) smem = pr.smem;
  if (n_c > 0 && pc.smem > smem) smem = pc.smem;
  auto kernel = factor_kernel<R, S, kRegR, kRegC>;
  err = allow_smem(kernel, smem, &done_mask);
  if (err) return err;
  const bool dev_r = pr.where == 2 && n_r > 0, dev_c = pc.where == 2 && n_c > 0;
  if ((dev_r || dev_c) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  R* slots_r = dev_r ? reinterpret_cast<R*>(base) : nullptr;
  Complex<R>* slots_c =
      dev_c ? reinterpret_cast<Complex<R>*>(base + (long)n_r * pr.scratch)
            : nullptr;
  kernel<<<n_r + n_c, pr.threads, (size_t)smem, stream>>>(
      static_cast<const R*>(in_r), static_cast<R*>(out_r), n_r,
      static_cast<const Complex<R>*>(in_c), static_cast<Complex<R>*>(out_c),
      slots_r, slots_c, static_cast<const bool*>(due), m, bw);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_factor(const void* in_r, void* out_r, int n_r, const void* in_c,
                  void* out_c, int n_c, void* scratch, const void* due, int m,
                  int bw, cudaStream_t stream) {
  switch (factor_row_slots(bw)) {
    case 1: return launch_factor_as<R, 1>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, stream);
    case 2: return launch_factor_as<R, 2>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, stream);
    case 3: return launch_factor_as<R, 3>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, stream);
    case 4: return launch_factor_as<R, 4>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, stream);
    case 6: return launch_factor_as<R, 6>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows a lane holds in a solve: 32 S >= bw + 1 (past 127, all at S = 6)
int solve_slots(int bw) {
  return (bw + 1 + 31) / 32 > 4 ? 6 : (bw + 1 + 31) / 32;
}

template <typename R, int S>
int launch_solve_as(const void* lu_r, void* x_r, int rhs_r, int blocks_r,
                    const void* lu_c, void* x_c, int rhs_c, int blocks_c,
                    const void* active, int m, int bw, cudaStream_t stream) {
  solve_kernel<R, S><<<rhs_r + rhs_c, 32, 0, stream>>>(
      static_cast<const R*>(lu_r), static_cast<R*>(x_r), rhs_r, blocks_r,
      static_cast<const Complex<R>*>(lu_c), static_cast<Complex<R>*>(x_c),
      blocks_c, static_cast<const bool*>(active), m, bw);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_solve(const void* lu_r, void* x_r, int rhs_r, int blocks_r,
                 const void* lu_c, void* x_c, int rhs_c, int blocks_c,
                 const void* active, int m, int bw, cudaStream_t stream) {
  switch (solve_slots(bw)) {
    case 1: return launch_solve_as<R, 1>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, stream);
    case 2: return launch_solve_as<R, 2>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, stream);
    case 3: return launch_solve_as<R, 3>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, stream);
    case 4: return launch_solve_as<R, 4>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, stream);
    case 6: return launch_solve_as<R, 6>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, stream);
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
// device: *threads a block, *where its window lives (0 registers, 1 shared
// memory, 2 device memory), *smem dynamic shared-memory bytes a block,
// *scratch device-memory window bytes a matrix
int banded_lu_factor_plan(int dtype, int bw, int* threads, int* where,
                          long* smem, long* scratch) {
  const long elem = element_bytes(dtype);
  if (elem == 0 || bw < 0 || bw > kMaxBandwidth)
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  const int err = device_optin(&optin);
  if (err) return err;
  const FactorPlan plan = factor_plan_for(elem, bw, optin);
  *threads = plan.threads;
  *where = plan.where;
  *smem = plan.smem;
  *scratch = plan.scratch;
  return 0;
}

// factor n_r real (`precision` 0 float32, 1 float64) row-band matrices (m,
// 2 bw + 1) of in_r into out_r and n_c complex ones of in_c into out_c, in
// one launch (distinct, contiguous); scratch: the device-memory windows
// banded_lu_factor_plan asks for, real matrices' first; when `due` is not
// null, a device bool read by the kernel, nothing happens where it is
// false
int banded_lu_factor_launch(int precision, const void* in_r, void* out_r,
                            int n_r, const void* in_c, void* out_c, int n_c,
                            void* scratch, const void* due, int m, int bw,
                            void* stream) {
  if (n_r < 0 || n_c < 0 || n_r + n_c <= 0 || m <= 0 || bw < 0 ||
      bw > kMaxBandwidth || (long)m * (2 * bw + 1) > kMaxElements)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case 0: return launch_factor<float>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, st);
    case 1: return launch_factor<double>(in_r, out_r, n_r, in_c, out_c, n_c, scratch, due, m, bw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// solve in place, in one launch: x_r holds rhs_r real right-hand sides of m
// rows, the g-th against matrix g mod blocks_r of lu_r, x_c rhs_c complex
// ones against lu_c; when `active` is not null, a device bool read by the
// kernel, x_r and x_c are left as they are where it is false
int banded_lu_solve_launch(int precision, const void* lu_r, void* x_r,
                           int rhs_r, int blocks_r, const void* lu_c,
                           void* x_c, int rhs_c, int blocks_c,
                           const void* active, int m, int bw, void* stream) {
  if (rhs_r < 0 || rhs_c < 0 || rhs_r + rhs_c <= 0 ||
      (rhs_r > 0 && blocks_r <= 0) || (rhs_c > 0 && blocks_c <= 0) || m <= 0 ||
      bw < 0 || bw > kMaxBandwidth || (long)m * (2 * bw + 1) > kMaxElements)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case 0: return launch_solve<float>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, st);
    case 1: return launch_solve<double>(lu_r, x_r, rhs_r, blocks_r, lu_c, x_c, rhs_c, blocks_c, active, m, bw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
