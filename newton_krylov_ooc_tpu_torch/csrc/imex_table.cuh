// Device code shared by the 2D year kernels that stream a table of their
// year's Crank-Nicolson solves, csrc/iage_year.cu (B1, B1v1, and the table
// kernel) and csrc/phosphorus_year.cu (B2): the table's layout, the two
// shared-memory slots a producer warp fills a step ahead with cp.async.bulk
// (an mbarrier a slot), and a column's lanes -- a group of G lanes owns a
// column, lane l its M levels l M .. l M + M - 1, in registers.  See the
// note at the top of csrc/iage_year.cu.

#pragma once

#include <cuda_runtime.h>

namespace imex {

// the table: bulk copies move multiples of 16 bytes from 16-byte aligned
// addresses, so each part is padded to kAlign floats
constexpr int kAlign = 4;
constexpr int kFactors = 3;  // m, w, cp

__host__ __device__ inline long align_floats(long n) {
  return (n + kAlign - 1) / kAlign * kAlign;
}

__host__ __device__ inline long kv_floats(int nz, int ny) {
  return align_floats((long)(nz - 1) * ny);
}

__host__ __device__ inline long factor_floats(int nz, int ny) {
  return align_floats((long)kFactors * nz * ny);
}

// one solve's part of the table: kv, then each channel's m, w, cp
__host__ __device__ inline long solve_floats(int t_dim, int nz, int ny) {
  return kv_floats(nz, ny) + t_dim * factor_floats(nz, ny);
}

// a shared-memory slot: kv, and B1's factors of one channel
template <bool kPcr>
__host__ __device__ inline long slot_floats(int nz, int ny) {
  return kv_floats(nz, ny) + (kPcr ? 0L : factor_floats(nz, ny));
}

// lanes a column (G): the largest power of two <= 32 with the columns'
// warps and one more (the slots' producer) within `threads`
__host__ __device__ inline int column_lanes(int ny, int threads) {
  int lanes = 32;
  while (lanes > 1 && ((long)lanes * ny + 31) / 32 * 32 + 32 > threads)
    lanes /= 2;
  return lanes;
}

__host__ __device__ inline int block_threads(int ny, int threads) {
  return (column_lanes(ny, threads) * ny + 31) / 32 * 32 + 32;
}

// -- the slots: cp.async.bulk and an mbarrier a slot ------------------------

__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void slot_bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one thread: the copies of `bytes` in all into a slot, completing `bar`
__device__ inline void slot_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ inline void slot_copy(float* dst, const float* src, unsigned bytes,
                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline void slot_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// solve s's slice of the table into slot s & 1 (one thread): kv, and B1's
// factors of channel ch; the slot was last read before a block barrier
template <bool kPcr>
__device__ inline void fetch(float* slots, long slot_len,
                             unsigned long long* bars, const float* table,
                             int s, int ch, int t_dim, int nz, int ny) {
  float* slot = slots + (s & 1) * slot_len;
  const float* part = table + (long)s * solve_floats(t_dim, nz, ny);
  const unsigned kv_bytes = (unsigned)(kv_floats(nz, ny) * sizeof(float));
  const unsigned f_bytes = (unsigned)(factor_floats(nz, ny) * sizeof(float));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  slot_expect(&bars[s & 1], kv_bytes + (kPcr ? 0u : f_bytes));
  slot_copy(slot, part, kv_bytes, &bars[s & 1]);
  if (!kPcr)
    slot_copy(slot + kv_floats(nz, ny),
              part + kv_floats(nz, ny) + (long)ch * factor_floats(nz, ny),
              f_bytes, &bars[s & 1]);
}

// -- a column's lanes ---------------------------------------------------

// v at the levels above (k - 1) and below (k + 1) each of the lane's own:
// its own registers, and one shuffle from each neighbouring lane (lanes at
// the column's ends get their own values, which the callers mask)
template <int M>
__device__ __forceinline__ void column_neighbours(const float (&v)[M],
                                                  float (&above)[M],
                                                  float (&below)[M],
                                                  int lanes) {
  const float up = __shfl_up_sync(~0u, v[M - 1], 1, lanes);
  const float down = __shfl_down_sync(~0u, v[0], 1, lanes);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    above[m] = m > 0 ? v[m - 1] : up;
    below[m] = m < M - 1 ? v[m + 1] : down;
  }
}

struct Stencil {
  float w, c, e, n, s;
};

__device__ __forceinline__ void kahan_reg(float& y, float& comp,
                                          float delta) {
  const float adj = delta + comp;
  const float y_new = y + adj;
  comp = adj - (y_new - y);
  y = y_new;
}

}  // namespace imex
