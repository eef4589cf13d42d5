// What the MSDA gather kernels share (K1 msda_fwd.cu, K3 msda_bwd.cu, K5
// msda_banded_fwd.cu, K6 and K7 msda_rowtap_fwd.cu, K8 msda_corner_fwd.cu,
// K9 msda_corner_bwd.cu, K10 msda_rowtap_bwd.cu): the geometry they are
// built for, the per-sample staging, vector row loads, lane-group sums, the
// corner gather of the staged forwards and the grad_value accumulation of
// the backwards.
//
// Geometry, fixed at compile time (ops/msda.py checks it before a launch):
// D = 32 channels a head, P = 4 points a level, at most 4 levels, so at most
// 16 samples a (b, q, h).  A D = 32 value row is 128 B in f32 (64 B in bf16).
//
// Work layout, all of them: a CTA takes one (b, h) and a tile of consecutive
// queries; its warps take the tile's queries in turns (warp w: queries
// q0 + w, q0 + w + n_warps, ...).  For one (b, q, h) a warp
//   1. stages the samples: lane s < 16 loads sample s's location and weight
//      (coalesced) and computes its four corner positions and bilinear
//      weights once, into the warp's slots in shared memory (K5-K10 stage
//      a whole tile or chunk of queries at once, coalesced along q);
//   2. works as 4 lane groups of 8 lanes: group g takes the samples
//      (level i, point g), i = 0..3, and each lane of the group 4 channels
//      (one 16-B float4 of an f32 row, 8 B of a bf16 one), so a warp has 16
//      corner rows in flight.
#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace msda {

constexpr int kD = 32;               // channels a head
constexpr int kP = 4;                // points a level
constexpr int kMaxLevels = 4;
constexpr int kSamples = kMaxLevels * kP;
constexpr int kGroups = 4;           // lane groups a warp, one sample each
constexpr int kGroupLanes = 8;       // lanes a group: kD / 4 channels a lane

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  // the backwards: the first shared-memory accumulator row of each level,
  // or -1 where the level scatters straight to global memory
  int smem_row[kMaxLevels];
};

// One staged sample: the value-map positions of its four corners (x0y0,
// x1y0, x0y1, x1y1; -1 outside the map) and their bilinear weights; aux is
// K3's (attention weight, fx, fy, shared-memory row of position 0 as int
// bits, or INT_MIN where the level is not in shared memory).
struct __align__(16) Slot {
  int4 pos;
  float4 w;
  float4 aux;
};

// Sample s (< nlp) of the (b, q, h) whose locations start at loc and weights
// at wgt: corners and weights (times the attention weight when `fold_attn`).
// Samples s >= nlp get no corners.
template <bool fold_attn>
__device__ __forceinline__ void stage_sample(const float* __restrict__ loc,
                                             const float* __restrict__ wgt, int s, int nlp,
                                             const Levels& lv, Slot* slot) {
  Slot out;
  out.pos = make_int4(-1, -1, -1, -1);
  out.w = make_float4(0.f, 0.f, 0.f, 0.f);
  out.aux = make_float4(0.f, 0.f, 0.f, __int_as_float(INT_MIN));
  if (s < nlp) {
    const int l = s / kP;
    // the level's constants by compile-time index: a run-time index into the
    // kernel's parameters would copy them to the stack
    int Hl = lv.h[0], Wl = lv.w[0], start = lv.start[0], srow = lv.smem_row[0];
#pragma unroll
    for (int k = 1; k < kMaxLevels; ++k) {
      if (l == k) {
        Hl = lv.h[k];
        Wl = lv.w[k];
        start = lv.start[k];
        srow = lv.smem_row[k];
      }
    }
    const float a = __ldg(wgt + s);
    // px rounded twice, as the plain version and the reference compute it:
    // a contracted fma(x, W, -0.5) can land on the other side of an integer,
    // where floor() picks other corners (and the derivative jumps)
    const float x = __fmul_rn(__ldg(loc + 2 * s), (float)Wl) - 0.5f;
    const float y = __fmul_rn(__ldg(loc + 2 * s + 1), (float)Hl) - 0.5f;
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = (int)xf, y0 = (int)yf;
    const float fx = x - xf, fy = y - yf;
    const bool x0in = x0 >= 0 && x0 < Wl, x1in = x0 + 1 >= 0 && x0 + 1 < Wl;
    const bool y0in = y0 >= 0 && y0 < Hl, y1in = y0 + 1 >= 0 && y0 + 1 < Hl;
    const int p00 = start + y0 * Wl + x0;
    out.pos = make_int4(x0in && y0in ? p00 : -1, x1in && y0in ? p00 + 1 : -1,
                        x0in && y1in ? p00 + Wl : -1, x1in && y1in ? p00 + Wl + 1 : -1);
    const float k = fold_attn ? a : 1.f;
    out.w = make_float4(((1.f - fx) * (1.f - fy)) * k, (fx * (1.f - fy)) * k,
                        ((1.f - fx) * fy) * k, (fx * fy) * k);
    out.aux = make_float4(a, fx, fy, __int_as_float(srow >= 0 ? srow - start : INT_MIN));
  }
  *slot = out;
}

// 4 channels (4 * sub .. 4 * sub + 3) of a value row, read through the
// read-only (L1) path
__device__ __forceinline__ float4 load4(const float* row, int sub) {
  return __ldg(reinterpret_cast<const float4*>(row) + sub);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int sub) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + sub);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* row, int sub, float4 v) {
  reinterpret_cast<float4*>(row)[sub] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* row, int sub, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  reinterpret_cast<uint2*>(row)[sub] = u;
}

// 4 channels added to a global row with atomics: one float4 atomic
// (red.global.add.v4.f32) into an f32 row; two bf16x2 atomics
// (red.global.add.noftz.bf16x2) into a bf16 row, each add rounding to bf16
__device__ __forceinline__ void atomic_add4(float* row, int sub, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(row) + sub, v);
}
__device__ __forceinline__ void red_bf16x2(__nv_bfloat16* p, float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  // a reduction, not atomicAdd's fetch-and-add: nothing waits for the old value
  asm volatile("red.global.add.noftz.bf16x2 [%0], %1;\n" ::"l"(p),
               "r"(*reinterpret_cast<const unsigned*>(&v)) : "memory");
}
__device__ __forceinline__ void atomic_add4(__nv_bfloat16* row, int sub, float4 v) {
  red_bf16x2(row + 4 * sub, v.x, v.y);
  red_bf16x2(row + 4 * sub + 2, v.z, v.w);
}

__device__ __forceinline__ float4 fma4(float a, float4 v, float4 acc) {
  return make_float4(fmaf(a, v.x, acc.x), fmaf(a, v.y, acc.y), fmaf(a, v.z, acc.z),
                     fmaf(a, v.w, acc.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// x summed over the lanes that differ from this one only in the lane-index
// bits first..last (powers of two): <1, 4> a group of 8, <8, 16> the groups
template <int first, int last>
__device__ __forceinline__ float xor_sum(float x) {
#pragma unroll
  for (int o = first; o <= last; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// component j (0..3) of v, without indexing a register array at run time
__device__ __forceinline__ float pick(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- staged forwards (K5-K8)
// The gather half of K5, K6, K7 and K8, once a tile's corners are staged:
// cpos / cw hold, for point t = level * kP + point and query qq of the
// tile, the four corners' value positions (-1: no load) and weights at
// [t * stride + qq].
// Each warp takes two queries at a time (qq and qq + kWarps), its 4 lane
// groups on the points (level i, point g), each lane on 4 channels, loops
// unrolled: 32 corner rows in flight a warp; the groups' sums meet in two
// shuffle levels and the tile's nq outputs go to out_tile (nq rows of kD).
// T is the value's and the output's type (f32, or bf16 rows summed in f32
// and rounded once at the store).
template <int kWarps, typename T>
__device__ __forceinline__ void gather_staged_corners(const int4* cpos, const float4* cw,
                                                      int stride, int nq, int NL,
                                                      const T* vbase, long long row_stride,
                                                      T* out_tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes, sub = lane % kGroupLanes;
  for (int qq = warp; qq < nq; qq += 2 * kWarps) {
    float4 acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int qj = qq + j * kWarps;
      if (qj >= nq) continue;   // warp-uniform
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {
        if (i >= NL) break;
        const int s = (i * kP + group) * stride + qj;
        const int4 pos = cpos[s];
        const float4 w = cw[s];
        const int pc[4] = {pos.x, pos.y, pos.z, pos.w};
        const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (pc[c] >= 0) acc[j] = fma4(wc[c], load4(vbase + pc[c] * row_stride, sub), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j].x = xor_sum<kGroupLanes, 16>(acc[j].x);
      acc[j].y = xor_sum<kGroupLanes, 16>(acc[j].y);
      acc[j].z = xor_sum<kGroupLanes, 16>(acc[j].z);
      acc[j].w = xor_sum<kGroupLanes, 16>(acc[j].w);
    }
    if (group == 0) store4(out_tile + (long long)qq * kD, sub, acc[0]);
    if (group == 1 && qq + kWarps < nq) store4(out_tile + (long long)(qq + kWarps) * kD, sub, acc[1]);
  }
}

// ---------------------------------------------------------------- grad_value (K3, K9, K10)
// The backwards accumulate the grad_value rows of the levels their plan
// admits in shared memory (acc: smem_rows rows of kD f32, a touched flag a
// row) and flush them once a tile; the other levels' rows go straight to
// global memory.

// acc and touched zeroed by the CTA's n_threads threads (no barrier)
__device__ __forceinline__ void zero_rows(float* acc, unsigned char* touched, int smem_rows,
                                          int n_threads) {
  for (int i = threadIdx.x; i < smem_rows * (kD / 4); i += n_threads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < smem_rows; i += n_threads) touched[i] = 0;
}

// this lane's 4 channels `add` of a corner row: into shared accumulator row
// r with shared f32 atomics, the 4 groups' channels rotated onto 4
// different banks, or, for r < 0, into the global row grow (atomic_add4)
template <typename GV>
__device__ __forceinline__ void add_row(float* acc, unsigned char* touched, int r, GV* grow,
                                        int group, int sub, float4 add) {
  if (r >= 0) {
    float* row = acc + (long long)r * kD + 4 * sub;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = (j + group) & 3;
      atomicAdd(row + jj, pick(add, jj));
    }
    if (sub == 0) touched[r] = 1;
  } else {
    atomic_add4(grow, sub, add);
  }
}

// the level's position of shared-memory accumulator row r
__device__ __forceinline__ int smem_row_position(int r, int NL, const Levels& lv) {
  int pos = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    const int r0 = lv.smem_row[l];
    if (l < NL && r0 >= 0 && r >= r0 && r < r0 + lv.h[l] * lv.w[l])
      pos = lv.start[l] + (r - r0);
  }
  return pos;
}

// every touched accumulator row added to grad_value (gv_base: the (b, h)
// map's position 0, rows row_stride apart), atomic_add4 a 4 channels (a bf16
// grad_value rounds each f32 row sum once here); after a barrier
template <typename GV>
__device__ __forceinline__ void flush_rows(const float* acc, const unsigned char* touched,
                                           int smem_rows, int NL, const Levels& lv,
                                           GV* gv_base, long long row_stride, int n_threads) {
  for (int i = threadIdx.x; i < smem_rows * (kD / 4); i += n_threads) {
    const int r = i / (kD / 4);
    if (!touched[r]) continue;
    const int pos = smem_row_position(r, NL, lv);
    atomic_add4(gv_base + pos * row_stride, i % (kD / 4), reinterpret_cast<const float4*>(acc)[i]);
  }
}

}  // namespace msda
