// Tensor-core building blocks shared by the fusion kernels K2
// (fusion_fwd.cu) and K4 (fusion_bwd.cu), for Hopper (sm_90a).
//
// 3xTF32: an f32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (round to nearest, ties away from zero), and a
// product a.b is taken on the tensor cores (mma.sync m16n8k8, tf32 in, f32
// accumulate) as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small terms
// summed apart from the big one.  The dropped a_lo.b_lo term and the
// rounding of lo leave a relative error of about 2^-21 per product term,
// near f32's own; one TF32 pass (hi.hi only) leaves 2^-11.
//
// Tiles in shared memory are [rows][256] f32 (one head's D = 256 lanes per
// row), stored with the 16-byte chunk index of each row XORed with row & 7.
// That makes every fragment load below free of bank conflicts: ldmatrix of
// the A and "key" B fragments (8 rows of 16 bytes) and the scalar loads of
// the "value" B fragment (4 even or 4 odd rows x 8 consecutive lanes).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tf32x3 {

constexpr int kD = 256;          // lanes per tile row: the fusion head dim
constexpr int kChunks = kD / 4;  // 16-byte chunks per row

// offset of (row, lane) in a swizzled [rows][kD] tile
__device__ __forceinline__ int at(int row, int lane) {
  return row * kD + ((((lane >> 2) ^ row) & 7) | ((lane >> 2) & ~7)) * 4 + (lane & 3);
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero:
// the rounding of cvt.rna.tf32.f32, bit for bit on finite values and
// infinities, taken as an integer add and mask.  ptxas expands cvt.rna into
// a longer sequence with special-value tests, and the split runs for every
// fragment element.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {   // 16 x 8 A operand, hi and lo parts
  uint32_t hi[4], lo[4];
};
struct FragB {   // 8 x 8 B operand, hi and lo parts
  uint32_t hi[2], lo[2];
};

// lo keeps the 13 low bits that the tensor core drops (it reads the top 19
// bits of a tf32 operand): the rounding add alone gives it rna_tf32(x - hi)
// as the tensor core sees it, bit for bit.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a . b, one m16n8k8 tf32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// the same product into two accumulators, small terms and big term apart:
// three independent chains for the tensor pipe in place of one
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const FragA& a,
                                     const FragB& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(big, a.hi, b.hi);
}

// Four 8 x 4 f32 matrices (8 rows of 16 bytes) from shared memory in one
// instruction: lane L gives the address of row L & 7 of matrix L >> 3, and
// register i of lane (g = L >> 2, t = L & 3) receives element (g, t) of
// matrix i.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Fragment loads of one warp; g = lane >> 2, t = lane & 3.  The swizzle makes
// a thread's offset within a tile depend on the reduction step ks (lanes
// 8 ks .. 8 ks + 7) only through ks & 3, and steps four apart lie 32 floats
// apart: each thread keeps four offsets, and a loop over q = ks & 3 unrolled
// inside a loop over it = ks >> 2 addresses with immediates.
struct StepOffsets {
  int off[4];   // floats, for q = 0 .. 3
};

// A operand, rows m0 .. m0+15 of a row tile, reduction lanes kbase + 8 ks ..
// (a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)); m0 a multiple
// of 16, kbase of 32.
__device__ __forceinline__ StepOffsets a_offsets(int m0, int kbase, int lane) {
  StepOffsets o;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o.off[q] = at(m0 + (lane & 7) + 8 * ((lane >> 3) & 1), kbase + 8 * q + 4 * (lane >> 4));
  }
  return o;
}

// B operands of a row-by-key product (S = A . K^T) for the two 8-key tiles of
// a 16-key tile: B[k][n] = K[8j + n][kbase + 8 ks + k], b0 = (k = t, n = g),
// b1 = (k = t+4, n = g), for j = 0, 1.
__device__ __forceinline__ StepOffsets key2_offsets(int kbase, int lane) {
  StepOffsets o;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o.off[q] = at((lane & 7) + 8 * (lane >> 4), kbase + 8 * q + 4 * ((lane >> 3) & 1));
  }
  return o;
}

__device__ __forceinline__ uint32_t step_addr(uint32_t tile, const StepOffsets& o, int q, int it) {
  return tile + 4u * (uint32_t)(o.off[q] + 32 * it);
}

__device__ __forceinline__ FragA load_a(uint32_t tile, const StepOffsets& o, int q, int it) {
  uint32_t r[4];
  ldsm4(r, step_addr(tile, o, q, it));
  return split_a(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                 __uint_as_float(r[3]));
}

// `load_b_key2` splits raw f32; `load_b_key2_split` reads the hi and lo
// parts from two tiles `split_tile` wrote.
__device__ __forceinline__ void load_b_key2(FragB (&f)[2], uint32_t tile, const StepOffsets& o,
                                            int q, int it) {
  uint32_t r[4];
  ldsm4(r, step_addr(tile, o, q, it));
  f[0] = split_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
  f[1] = split_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

__device__ __forceinline__ void load_b_key2_split(FragB (&f)[2], uint32_t hi, uint32_t lo,
                                                  const StepOffsets& o, int q, int it) {
  uint32_t h[4], l[4];
  ldsm4(h, step_addr(hi, o, q, it));
  ldsm4(l, step_addr(lo, o, q, it));
  f[0] = FragB{{h[0], h[1]}, {l[0], l[1]}};
  f[1] = FragB{{h[2], h[3]}, {l[2], l[3]}};
}

// B operand of a probability-by-value product (O += P . V) over the keys
// 8j .. 8j+7 of a 16-key tile and the value lanes of 8-lane tile nb + n, in
// the permuted key order that `a_from_acc` gives P: reduction position t is
// key 8j + 2t, t+4 is key 8j + 2t + 1.  With nb a multiple of 4 the offset
// is off[e][n & 3] + 2048 j + 32 (n >> 2) for key 8j + 2t + e.
struct ValOffsets {
  int off[2][4];
};

__device__ __forceinline__ ValOffsets val_offsets(int nb, int g, int t) {
  ValOffsets o;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int q = 0; q < 4; ++q) o.off[e][q] = at(2 * t + e, 8 * (nb + q) + g);
  }
  return o;
}

__device__ __forceinline__ int val_index(const ValOffsets& o, int e, int j, int n) {
  return o.off[e][n & 3] + 2048 * j + 32 * (n >> 2);
}

// `load_b_val` splits raw f32; `load_b_val_split` reads pre-split hi and lo
// tiles.
__device__ __forceinline__ FragB load_b_val(const float* s, const ValOffsets& o, int j, int n) {
  return split_b(s[val_index(o, 0, j, n)], s[val_index(o, 1, j, n)]);
}

__device__ __forceinline__ FragB load_b_val_split(const float* hi, const float* lo,
                                                  const ValOffsets& o, int j, int n) {
  const int i0 = val_index(o, 0, j, n), i1 = val_index(o, 1, j, n);
  return FragB{{__float_as_uint(hi[i0]), __float_as_uint(hi[i1])},
               {__float_as_uint(lo[i0]), __float_as_uint(lo[i1])}};
}

// Split a staged tile of n floats in place into its hi part, its lo part
// into `lo` (same layout).  Every thread of the block takes part.
template <int THREADS>
__device__ __forceinline__ void split_tile(float* s, float* lo, int n, int tid) {
  for (int i = tid; i < n / 4; i += THREADS) {
    float4 x = reinterpret_cast<float4*>(s)[i];
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    reinterpret_cast<float4*>(s)[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                                  __uint_as_float(h[2]), __uint_as_float(h[3]));
    reinterpret_cast<float4*>(lo)[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// The A operand of P . V from P's accumulator fragment over 8 keys
// (c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t), c3 = (g+8, 2t+1)) with no
// data movement: reduction position t takes key 2t and t+4 takes key 2t+1,
// the order `load_b_val` reads the values in.
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------- async copies
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// 4-byte copy (no alignment beyond a float's), zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of rows r0 .. r0+ROWS-1 of a (rows, ld) matrix's head
// slice `g` (g points at its row 0, lane 0) into the swizzled tile s; rows at
// or past `limit` are zero-filled.  Every thread of the block takes part, each
// with the same 16-byte chunk of every (THREADS / kChunks)-th row.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long ld, int r0,
                                          int limit, int tid) {
  static_assert(THREADS % kChunks == 0 && ROWS % (THREADS / kChunks) == 0, "tile shape");
  constexpr int kStep = THREADS / kChunks;
  const int c = tid % kChunks;
#pragma unroll
  for (int it = 0; it < ROWS / kStep; ++it) {
    const int r = tid / kChunks + it * kStep;
    const bool ok = r0 + r < limit;
    cp_async16(s + at(r, c * 4), ok ? g + (long long)(r0 + r) * ld + c * 4 : g, ok);
  }
}

// Stage the key-padding flags of keys [k_begin, k_begin + n) into sPad (1 =
// padded or past k_end) and mark in sLive each tile of `tile` keys that holds
// a live key.  Every thread takes part; ends with a barrier.
__device__ __forceinline__ void stage_pads(uint8_t* sPad, uint8_t* sLive, const uint8_t* pad,
                                           int k_begin, int k_end, int n, int tile, int tid,
                                           int threads) {
  for (int i = tid; i < n / tile; i += threads) sLive[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += threads) {
    const uint8_t p = k_begin + i < k_end ? pad[k_begin + i] : 1;
    sPad[i] = p;
    if (!p) sLive[i / tile] = 1;
  }
  __syncthreads();
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

}  // namespace tf32x3
