// K9: multi-scale deformable attention backward on corner taps, for Hopper
// (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_bwd_kernel (the
// corner-tap sweep backward, the default backward of the MSDA_BANDED=0
// path).  On the corner taps ops/msda_sweep.py::corner_indices_and_weights
// makes, a tap t of query q putting weight w[t, q] on value position
// idx[t, q] of its (b, h) map:
//   gw[t, q]       = V[idx[t, q]] . g[q]          (0 where w[t, q] == 0)
//   grad_value[s] += sum_{t, q: idx[t, q] == s} w[t, q] * g[q]
// value (B, L, H, 32) f32 (reference layout), idx int32 and w f32
// (B*H, NL*P*4, Qp), taps grouped by level (P*4 a level) and within it by
// point; g (B*H, Qp, 32) f32; grad_value (B, L, H, 32) f32, zeroed by the
// caller; gw (B*H, NL*P*4, Qp) f32, written whole.  Padded queries have
// w == 0.  Built for D = 32, P = 4, NL <= 4 (msda_common.cuh).
//
// The TPU kernel makes both sums tile products (msda_pallas.py:962-970):
// P = V g^T over a tile of value positions and S^T g with S the taps'
// weights, dense on the MXU.  S has at most 16 non-zeros a query a level, so
// on this card the dense form did tens of times the work of a gather and a
// scatter.  Here each live tap is one gathered row and one scattered row.
//
// What bounds it: the grad_value scatter and the row gather, as for K3 (same
// function; the smoke reports K3's bound): each live tap reads a 128-B value
// row and adds a 128-B row of w * g at data-dependent places, and the
// coarse levels' rows are hit ~10^3 times each.
//
// Design (K3's, msda_common.cuh, on K9's operands):
//   - a CTA of 16 warps takes one b*h and a tile of consecutive queries
//     (ops/msda_sweep.py corner_bwd_plan).  It stages the taps of 32 queries
//     at a time, idx and w read coalesced along q into shared memory, and
//     writes their gw back from shared memory the same way;
//   - a warp takes one query at a time as 4 lane groups of 8 lanes, group g
//     on the 16 taps of the points (level i, point g), each lane on 4
//     channels (float4 rows through L1), the four corners' rows loaded
//     before any is used, each corner's dot product summed over the group
//     in 3 shuffles.  A dead tap loads nothing and gets gw = 0, which the
//     chain rule multiplies by its zero weight;
//   - grad_value: the levels the plan admits (those a tile hits at least
//     once a row on average, within 2 CTAs an SM: level 3 at the 800x1216
//     bucket) accumulate in shared memory with shared f32 atomics, the four
//     groups' channels rotated onto different banks, flushed once a tile
//     with float4 global atomics; the other levels add w * g straight to
//     global memory with one float4 atomic a lane (red.global.add.v4.f32).
// gw is deterministic; grad_value's f32 sums come in a run-dependent order.
//
// The bf16 entry (msda_corner_bwd_bf16; the TPU kernel's bf16 branch,
// msda_pallas.py:998-1001, 1046-1052) takes value and g in bf16, read
// through msda_common.cuh's load4 (64-B rows, 8 B a lane), and computes in
// f32 as above: gw f32, and grad_value on the f32 entry's path unchanged
// (the same plan's shared-memory levels, float4 f32 reductions for the
// rest) into an f32 buffer, which the caller rounds to bf16 once.  The TPU
// kernel writes its grad_value in f32 too (msda_pallas.py:1093) and casts
// it once (:1517); K3's bf16 entry, whose banded TPU kernel accumulates in
// bf16, is the one that adds bf16x2.  The TPU kernel also rounds the tap
// weights and g to bf16 for its MXU products; the weights here stay f32.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2 * kWarps;          // queries staged at a time
constexpr int kTaps = kSamples * 4;         // corner taps a query, at most
constexpr int kStride = kChunk + 1;         // a tap's row of staged queries

// V: the value's and g's type (f32 or bf16); grad_value and gw are f32
template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
corner_bwd_kernel(const V* __restrict__ value, const int* __restrict__ idx,
                  const float* __restrict__ w, const V* __restrict__ g,
                  float* __restrict__ grad_value, float* __restrict__ gw,
                  int L, int H, int Qp, int NL, int tile_q, int n_tiles, int smem_rows,
                  Levels lv) {
  // dynamic shared memory: the staged chunk's idx, w and gw (kTaps rows of
  // kStride), then smem_rows accumulator rows of kD f32, then a touched
  // flag a row
  extern __shared__ float4 smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(s_idx + kTaps * kStride);
  float* s_gw = s_w + kTaps * kStride;
  float* acc = s_gw + kTaps * kStride;
  unsigned char* touched = reinterpret_cast<unsigned char*>(acc + (long long)smem_rows * kD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes, sub = lane % kGroupLanes;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int T = NL * kP * 4;
  const long long row_stride = (long long)H * kD;
  const long long vbase = ((long long)b * L * H + h) * kD;
  const int q_end = min(Qp, (tile + 1) * tile_q);

  zero_rows(acc, touched, smem_rows, kThreads);

  for (int c0 = tile * tile_q; c0 < q_end; c0 += kChunk) {
    const int nq = min(kChunk, q_end - c0);
    __syncthreads();   // the previous chunk's gw is written out
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, qq = i % kChunk;
      const long long o = ((long long)bh * T + t) * Qp + c0 + qq;
      const bool in = qq < nq;
      s_idx[t * kStride + qq] = in ? __ldg(idx + o) : 0;
      s_w[t * kStride + qq] = in ? __ldg(w + o) : 0.f;
    }
    __syncthreads();

    for (int qq = warp; qq < nq; qq += kWarps) {
      const float4 gq = load4(g + ((long long)bh * Qp + c0 + qq) * kD, sub);
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {
        if (i >= NL) break;
        const int t0 = (i * kP + group) * 4;   // the point's four corner taps
        int pc[4];
        float wc[4];
        float4 v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pc[c] = s_idx[(t0 + c) * kStride + qq];
          wc[c] = s_w[(t0 + c) * kStride + qq];
          v[c] = wc[c] != 0.f ? load4(value + vbase + pc[c] * row_stride, sub)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float k = xor_sum<1, kGroupLanes / 2>(dot4(gq, v[c]));   // over the group
          if (sub == 0) s_gw[(t0 + c) * kStride + qq] = k;
        }

        const int start = lv.start[i], n_rows = lv.h[i] * lv.w[i], srow0 = lv.smem_row[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (wc[c] == 0.f) continue;
          const int r = pc[c] - start;
          add_row(acc, touched, srow0 >= 0 && r >= 0 && r < n_rows ? srow0 + r : -1,
                  grad_value + vbase + pc[c] * row_stride, group, sub,
                  make_float4(wc[c] * gq.x, wc[c] * gq.y, wc[c] * gq.z, wc[c] * gq.w));
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, qq = i % kChunk;
      if (qq < nq) gw[((long long)bh * T + t) * Qp + c0 + qq] = s_gw[t * kStride + qq];
    }
  }

  __syncthreads();
  flush_rows(acc, touched, smem_rows, NL, lv, grad_value + vbase, row_stride, kThreads);
}

int smem_bytes_for(int smem_rows) {
  return 3 * kTaps * kStride * 4 + smem_rows * kD * 4 + ((smem_rows + 15) / 16) * 16;
}

template <typename V>
int launch(const void* value, const void* idx, const void* w, const void* g, void* grad_value,
           void* gw, int B, int L, int H, int Qp, int NL, int P, const int* shapes_hw,
           const int* level_start, int tile_q, const int* smem_row, int smem_rows,
           int smem_bytes, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || P != kP || NL <= 0 || NL > kMaxLevels ||
      tile_q <= 0 || smem_rows < 0 || smem_bytes < smem_bytes_for(smem_rows))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < NL;
    lv.h[l] = live ? shapes_hw[2 * l] : 0;
    lv.w[l] = live ? shapes_hw[2 * l + 1] : 0;
    lv.start[l] = live ? level_start[l] : 0;
    lv.smem_row[l] = live ? smem_row[l] : -1;
    if (live && lv.smem_row[l] >= 0 && lv.smem_row[l] + lv.h[l] * lv.w[l] > smem_rows)
      return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (Qp + tile_q - 1) / tile_q;
  cudaError_t err = cudaFuncSetAttribute(corner_bwd_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  corner_bwd_kernel<V><<<(unsigned)((long long)B * H * n_tiles), kThreads, smem_bytes,
                         (cudaStream_t)stream>>>(
      (const V*)value, (const int*)idx, (const float*)w, (const V*)g, (float*)grad_value,
      (float*)gw, L, H, Qp, NL, tile_q, n_tiles, smem_rows, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the K9 entries with smem_rows accumulator rows
// (either value type).
int msda_corner_bwd_smem_bytes(int smem_rows) { return smem_bytes_for(smem_rows); }

// value, g, grad_value 16-byte aligned; idx int32, the rest f32, all
// contiguous.  grad_value must be zeroed by the caller; gw is written whole.
// The plan (ops/msda_sweep.py corner_bwd_plan): tile_q queries a CTA;
// smem_row[l] the first accumulator row of level l in shared memory, or -1
// for a level scattered to global memory; smem_rows rows in all, in
// smem_bytes of dynamic shared memory.  Returns a cudaError_t (0 = launched).
int msda_corner_bwd_f32(const void* value, const void* idx, const void* w, const void* g,
                        void* grad_value, void* gw, int B, int L, int H, int Qp, int NL, int P,
                        const int* shapes_hw, const int* level_start, int tile_q,
                        const int* smem_row, int smem_rows, int smem_bytes, void* stream) {
  return launch<float>(value, idx, w, g, grad_value, gw, B, L, H, Qp, NL, P, shapes_hw,
                       level_start, tile_q, smem_row, smem_rows, smem_bytes, stream);
}

// The bf16 entry: value and g bf16, everything else as msda_corner_bwd_f32
// (grad_value an f32 buffer, rounded to bf16 by the caller).
int msda_corner_bwd_bf16(const void* value, const void* idx, const void* w, const void* g,
                         void* grad_value, void* gw, int B, int L, int H, int Qp, int NL, int P,
                         const int* shapes_hw, const int* level_start, int tile_q,
                         const int* smem_row, int smem_rows, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(value, idx, w, g, grad_value, gw, B, L, H, Qp, NL, P, shapes_hw,
                               level_start, tile_q, smem_row, smem_rows, smem_bytes, stream);
}

}  // extern "C"
