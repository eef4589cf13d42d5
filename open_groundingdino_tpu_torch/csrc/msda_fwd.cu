// K1: multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_mp_kernel
// (the TPU's default MSDA forward), computing the function of
// open_groundingdino_tpu/ops/msda.py::ms_deform_attn_xla on the reference
// operand layout:
//   value (B, L, H, D), locations (B, Q, H, NL, P, 2) in [0, 1],
//   weights (B, Q, H, NL, P)  ->  out (B, Q, H*D)
//   out[b,q,h,:] = sum_{l,p} w[b,q,h,l,p] * bilinear(value_l[b,:,:,h,:], loc)
// with x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5 and every corner outside the
// map contributing zero (grid_sample, align_corners=False, zero padding).
// Built for D = 32, P = 4, NL <= 4 (msda_common.cuh).
//
// What bounds it: gather traffic.  The compulsory bytes (each touched value
// row, the locations and weights once, the output once) take ~0.02 ms at the
// B = 1 encoder of the 800x1216 bucket, but each (b, q, h) reads 64 corner
// rows of 128 B at data-dependent places: 1.3 GB a B = 1 encoder call, almost
// all re-reads (level 3's 247 rows a head are read ~1,300 times each).  The
// 20 MB value map sits in L2, so the kernel is bound by how fast L1 and L2
// serve scattered 128-B rows and by load issue, not by HBM.
//
// What the design does about it (msda_common.cuh):
//   - a CTA takes one (b, h) and a tile of consecutive queries, and its 8
//     warps take neighbouring queries at the same time.  Encoder queries are
//     in raster order within each level, so their samples for the head fall
//     in a few rows of each level and the re-reads hit L1 (the rows are read
//     through the read-only path, __ldg).  The tiles are small (16 queries at
//     B = 1, 64 at B = 4: ops/msda.py msda_fwd_tile); larger ones, meant to
//     keep a head's coarse levels in one SM's L1, were slower (PERF.md, PR 6);
//   - each sample's corners and weights are computed once, by one lane, and
//     staged in shared memory, not by all 32 lanes as a warp per (b, q, h)
//     with lane = channel did before;
//   - a warp takes one (b, q, h) as 4 lane groups, each on its own sample and
//     each lane on 4 channels: one float4 load a corner row a lane, with the
//     sample loop unrolled; the groups' sums meet in two shuffle levels.  It
//     takes two queries at a time (lanes 16..31 stage the second), so 32
//     corner rows are in flight a warp, 4 before;
//   - f32 accumulation for either value type; bf16 rows are 64 B, 8 B a lane.
// ptxas -v (-O3, sm_90a, CUDA 12.8): 44 registers (f32 values), 40 (bf16),
// 12,288 B of static shared memory (the slots), no spills.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                const float* __restrict__ attn, T* __restrict__ out,
                int L, int H, int Q, int NL, int tile_q, int n_tiles, Levels lv) {
  __shared__ Slot slots[kWarps][2 * kSamples];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes, sub = lane % kGroupLanes;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int nlp = NL * kP;
  const long long row_stride = (long long)H * kD;
  const T* vbase = value + ((long long)b * L * H + h) * kD;
  const int q_end = min(Q, (tile + 1) * tile_q);
  Slot* my = slots[warp];

  // two queries a warp at a time, q and q + kWarps: lanes 16..31 stage the
  // second, and the warp has 32 corner rows in flight
  for (int q = tile * tile_q + warp; q < q_end; q += 2 * kWarps) {
    const int half = lane / kSamples;
    const int qs = q + half * kWarps;
    const bool live = qs < q_end;
    const long long bqs = ((long long)b * Q + (live ? qs : q)) * H + h;
    stage_sample<true>(locs + bqs * nlp * 2, attn + bqs * nlp, live ? lane % kSamples : kSamples,
                       nlp, lv, my + lane);
    __syncwarp();
    float4 acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {
        const Slot& s = my[j * kSamples + i * kGroups + group];
        const int4 pos = s.pos;
        const float4 w = s.w;
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
    if (group == 0) store4(out + (((long long)b * Q + q) * H + h) * kD, sub, acc[0]);
    if (group == 1 && q + kWarps < q_end)
      store4(out + (((long long)b * Q + q + kWarps) * H + h) * kD, sub, acc[1]);
    __syncwarp();   // the slots are restaged for the next queries
  }
}

template <typename T>
int launch(const void* value, const void* locs, const void* attn, void* out,
           int B, int L, int H, int D, int Q, int NL, int P,
           const int* shapes_hw, const int* level_start, int tile_q, void* stream) {
  if (D != kD || P != kP || NL <= 0 || NL > kMaxLevels || tile_q <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < NL;
    lv.h[l] = live ? shapes_hw[2 * l] : 0;
    lv.w[l] = live ? shapes_hw[2 * l + 1] : 0;
    lv.start[l] = live ? level_start[l] : 0;
    lv.smem_row[l] = -1;
  }
  const int n_tiles = (Q + tile_q - 1) / tile_q;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks == 0) return (int)cudaSuccess;
  msda_fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)locs, (const float*)attn, (T*)out,
      L, H, Q, NL, tile_q, n_tiles, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// value/out: f32; locs, attn: f32; value and out 16-byte aligned; tile_q
// queries a CTA.  Returns a cudaError_t (0 = launched).
int msda_fwd_f32(const void* value, const void* locs, const void* attn, void* out,
                 int B, int L, int H, int D, int Q, int NL, int P,
                 const int* shapes_hw, const int* level_start, int tile_q, void* stream) {
  return launch<float>(value, locs, attn, out, B, L, H, D, Q, NL, P,
                       shapes_hw, level_start, tile_q, stream);
}

// value/out: bf16; locs, attn: f32; f32 accumulation.
int msda_fwd_bf16(const void* value, const void* locs, const void* attn, void* out,
                  int B, int L, int H, int D, int Q, int NL, int P,
                  const int* shapes_hw, const int* level_start, int tile_q, void* stream) {
  return launch<__nv_bfloat16>(value, locs, attn, out, B, L, H, D, Q, NL, P,
                               shapes_hw, level_start, tile_q, stream);
}

}  // extern "C"
