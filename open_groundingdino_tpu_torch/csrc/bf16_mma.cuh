// bf16 tensor-core building blocks of the fusion kernels' bf16 entries, K2
// (fusion_fwd.cu) and K4 (fusion_bwd.cu), for Hopper (sm_90a).
//
// Every product takes bf16 operands and sums in f32 on the tensor cores:
// mma.sync m16n8k16 bf16, one MMA where the f32 entries' 3xTF32 takes three
// (tf32x3.cuh).  That is the TPU kernels' arithmetic on bf16 operands
// (dot_general with preferred_element_type f32).
//
// Tiles in shared memory are [rows][256] bf16 (one head's D = 256 lanes, 512
// bytes a row), stored with the 16-byte chunk index of each row XORed with
// row & 7, so the 8 rows an ldmatrix reads (16 bytes each, the same logical
// chunk) fall in 8 different bank groups.
//
// Fragments (g = lane >> 2, t = lane & 3), m16n8k16:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);
//   B (16 x 8): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8 f32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// Two C fragments of consecutive 8-column tiles are an A fragment over their
// 16 columns, element for element (`a_from_acc`), so P and dL feed the next
// product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"

namespace bf16mma {

constexpr int kD = 256;          // lanes a tile row: the fusion head dim
constexpr int kChunks = kD / 8;  // 16-byte chunks a row

typedef __nv_bfloat16 bf16;

// offset (in bf16) of (row, lane) in a swizzled [rows][kD] tile
__device__ __forceinline__ int at(int row, int lane) {
  return row * kD + ((((lane >> 3) ^ row) & 7) | ((lane >> 3) & ~7)) * 8 + (lane & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// two f32 values as one bf16x2 register, round to nearest even; lo in the
// low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment: rows m0 .. m0+15, columns k0 .. k0+15 of a row tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                       int lane) {
  ldsm4(a, smem_addr(tile + at(m0 + (lane & 7) + 8 * ((lane >> 3) & 1), k0 + 8 * (lane >> 4))));
}

// B fragments of a row-by-key product (S = A . K^T) for the two 8-key tiles
// of a 16-key tile, reduction columns k0 .. k0+15: b[j] for keys 8j .. 8j+7
__device__ __forceinline__ void load_b_key(uint32_t (&b)[2][2], const bf16* tile, int k0,
                                           int lane) {
  uint32_t r[4];
  ldsm4(r, smem_addr(tile + at((lane & 7) + 8 * (lane >> 4), k0 + 8 * ((lane >> 3) & 1))));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// B fragments of a probability-by-value product (O += P . V) over the 16 keys
// of a tile, for the two 8-lane output tiles at lanes n0 and n0 + 8
__device__ __forceinline__ void load_b_val(uint32_t (&b)[2][2], const bf16* tile, int n0,
                                           int lane) {
  uint32_t r[4];
  ldsm4_t(r, smem_addr(tile + at((lane & 7) + 8 * ((lane >> 3) & 1), n0 + 8 * (lane >> 4))));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// the A fragment of P . V (or dL . K) over 16 keys from the C fragments of
// their two 8-key tiles, each value rounded to bf16
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// a_from_acc with each value split in two bf16 parts: hi, the value rounded
// to bf16, and lo, what that rounding left (x - hi) rounded to bf16.  hi + lo
// holds 16 of the value's 24 significant bits, so the two products P_hi . V
// and P_lo . V into one f32 accumulator take P . V at nearly f32 for a V that
// bf16 holds exactly
__device__ __forceinline__ void split_pack(uint32_t& hi, uint32_t& lo, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void a_from_acc_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&c0)[4], const float (&c1)[4]) {
  split_pack(hi[0], lo[0], c0[0], c0[1]);
  split_pack(hi[1], lo[1], c0[2], c0[3]);
  split_pack(hi[2], lo[2], c1[0], c1[1]);
  split_pack(hi[3], lo[3], c1[2], c1[3]);
}

// Issue the copy of rows r0 .. r0+ROWS-1 of a (rows, ld) bf16 matrix's head
// slice `g` (g points at its row 0, lane 0) into the swizzled tile s; rows at
// or past `limit` are zero-filled.  Every thread of the block takes part.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld, int r0, int limit,
                                          int tid) {
  static_assert(THREADS % kChunks == 0 && ROWS % (THREADS / kChunks) == 0, "tile shape");
  constexpr int kStep = THREADS / kChunks;
  const int c = tid % kChunks;
#pragma unroll
  for (int it = 0; it < ROWS / kStep; ++it) {
    const int r = tid / kChunks + it * kStep;
    const bool ok = r0 + r < limit;
    tf32x3::cp_async16(reinterpret_cast<float*>(s + at(r, c * 8)),
                       reinterpret_cast<const float*>(ok ? g + (long long)(r0 + r) * ld + c * 8 : g),
                       ok);
  }
}

}  // namespace bf16mma
