// What K1 (msda_fwd.cu) and K3 (msda_bwd.cu) share: the geometry they are
// built for, the per-sample staging, vector row loads and lane-group sums.
//
// Geometry, fixed at compile time (ops/msda.py checks it before a launch):
// D = 32 channels a head, P = 4 points a level, at most 4 levels, so at most
// 16 samples a (b, q, h).  A D = 32 value row is 128 B in f32 (64 B in bf16).
//
// Work layout, both kernels: a CTA takes one (b, h) and a tile of consecutive
// queries; its warps take the tile's queries in turns (warp w: queries
// q0 + w, q0 + w + n_warps, ...).  For one (b, q, h) a warp
//   1. stages the samples: lane s < 16 loads sample s's location and weight
//      (coalesced) and computes its four corner positions and bilinear
//      weights once, into the warp's slots in shared memory;
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
  // K3 only: the first shared-memory accumulator row of each level, or -1
  // where the level scatters straight to global memory
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

}  // namespace msda
