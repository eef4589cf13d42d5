// K10: multi-scale deformable attention backward on row taps, for Hopper
// (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_rowtap_bwd_kernel
// (the row-tap backward, MSDA_BWD_VARIANT=rowtap, launched by
// _msda_rowtap_bwd_call; the corner-tap backward K9 is msda_corner_bwd.cu).
// On the row taps ops/msda_sweep.py::rowtap_positions_and_weights makes (see
// msda_rowtap_fwd.cu: a tap of query q touches i0 = row + floor(px) with
// weight r0 = 1 - (px - floor(px)) and i0 + 1 with r1 = 1 - ((floor(px) + 1)
// - px)), with P_i = V[bh, i, :] . g[bh, q, :]:
//   gw[r, q]      = r0 * P_i0 + r1 * P_i0+1
//   gpx[r, q]     = px > floor(px) ? P_i0+1 - P_i0 : 0   (without the row
//                   weight: the caller multiplies by w, as
//                   msda_pallas.py:1464-1466 does)
//   grad_value[i] += sum over the taps' corners at i of (r * w) * g[q]
// value (B, L, H, 32) f32 (reference layout); row int32, px and w f32
// (B*H, NL*2*P, Qp), level l's taps l*2P + p (row y0 of point p) and
// l*2P + P + p (row y0 + 1); g (B*H, Qp, 32) f32; grad_value (B, L, H, 32)
// f32, zeroed by the caller; gw and gpx (B*H, NL*2*P, Qp) f32, written
// whole.  Padded queries have w == 0 and g == 0.  Built for D = 32, P = 4,
// NL <= 4 (msda_common.cuh).
//
// gw and gpx are given on every tap, dead ones (w == 0) too: a row weight
// that is zero by value (fy == 0 on a lattice row) still has a gradient
// through fy, and the plain version gives it.  A dead tap's position is
// clipped into its level, so i0 is a valid row; i0 + 1 is read only where
// px > floor(px), and then lies in the same row (px <= W_l - 1).
//
// The TPU kernel makes both sums tile products (msda_pallas.py:1241-1271):
// P = V g^T over a tile of value positions and S^T g with S the taps'
// weights, dense on the MXU.  S has at most 16 non-zeros a query a level, so
// on this card the dense form does tens of times the work of a gather and a
// scatter.
//
// What bounds it: the grad_value scatter and the row gather, as for K3 and
// K9 (same function; the smoke reports K3's bound).
//
// Design (K9's, msda_common.cuh, on the row taps):
//   - a CTA of 16 warps takes one b*h and a tile of consecutive queries
//     (ops/msda_sweep.py rowtap_bwd_plan: K3's rule on this kernel's shared
//     memory).  It stages row, px and w of 32 queries at a time, read
//     coalesced along q into shared memory, and writes their gw and gpx
//     back from shared memory the same way;
//   - a warp takes one query at a time as 4 lane groups of 8 lanes, group g
//     on point g of each level: its two taps and their at most four corner
//     rows, all loaded before use, each lane on 4 channels (float4 rows
//     through L1); the four dot products are summed over the group in 3
//     shuffles each;
//   - grad_value: the levels the plan admits (level 3 at the 800x1216
//     bucket) accumulate in shared memory with shared f32 atomics, flushed
//     once a tile with float4 global atomics; the other levels add r * w * g
//     straight to global memory, one float4 atomic a lane
//     (red.global.add.v4.f32).
// gw and gpx are deterministic; grad_value's f32 sums come in a
// run-dependent order.
//
// The bf16 entry (msda_rowtap_bwd_bf16; the TPU kernel's bf16 branch,
// msda_pallas.py:1220-1242) takes value and g in bf16, read through
// msda_common.cuh's load4 (64-B rows, 8 B a lane), and computes in f32 as
// above: gw and gpx f32, and grad_value on the f32 entry's path unchanged
// (the same plan's shared-memory levels, float4 f32 reductions for the
// rest) into an f32 buffer, which the caller rounds to bf16 once, as the
// TPU kernel writes its grad_value in f32 (msda_pallas.py:1315) and casts
// it once (:1463).  The tap weights stay f32.
// ptxas -v (-O3, sm_90a, CUDA 12.8): 56 registers for either value type, no
// spills; dynamic shared memory 52,992 B at the 800x1216 bucket (staging
// 21,120 + level 3's 31,616 + flags 256).  Each instance's SASS holds 19
// vector global reductions (RED F32x4), no scalar or bf16 ones, and 64
// shared-memory compare-and-swap loops (ATOMS.CAST.SPIN).
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2 * kWarps;          // queries staged at a time
constexpr int kTaps = kSamples * 2;         // row taps a query, at most
constexpr int kStride = kChunk + 1;         // a tap's row of staged queries

// V: the value's and g's type (f32 or bf16); grad_value, gw and gpx are f32
template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
rowtap_bwd_kernel(const V* __restrict__ value, const int* __restrict__ row,
                  const float* __restrict__ px, const float* __restrict__ w,
                  const V* __restrict__ g, float* __restrict__ grad_value,
                  float* __restrict__ gw, float* __restrict__ gpx,
                  int L, int H, int Qp, int NL, int tile_q, int n_tiles, int smem_rows,
                  Levels lv) {
  // dynamic shared memory: the staged chunk's row, px, w, gw and gpx (kTaps
  // rows of kStride each), then smem_rows accumulator rows of kD f32, then a
  // touched flag a row
  extern __shared__ float4 smem[];
  int* s_row = reinterpret_cast<int*>(smem);
  float* s_px = reinterpret_cast<float*>(s_row + kTaps * kStride);
  float* s_w = s_px + kTaps * kStride;
  float* s_gw = s_w + kTaps * kStride;
  float* s_gpx = s_gw + kTaps * kStride;
  float* acc = s_gpx + kTaps * kStride;
  unsigned char* touched = reinterpret_cast<unsigned char*>(acc + (long long)smem_rows * kD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes, sub = lane % kGroupLanes;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int T = NL * kP * 2;
  const long long row_stride = (long long)H * kD;
  const long long vbase = ((long long)b * L * H + h) * kD;
  const int q_end = min(Qp, (tile + 1) * tile_q);

  zero_rows(acc, touched, smem_rows, kThreads);

  for (int c0 = tile * tile_q; c0 < q_end; c0 += kChunk) {
    const int nq = min(kChunk, q_end - c0);
    __syncthreads();   // the previous chunk's gw and gpx are written out
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, qq = i % kChunk;
      const long long o = ((long long)bh * T + t) * Qp + c0 + qq;
      const bool in = qq < nq;
      s_row[t * kStride + qq] = in ? __ldg(row + o) : 0;
      s_px[t * kStride + qq] = in ? __ldg(px + o) : 0.f;
      s_w[t * kStride + qq] = in ? __ldg(w + o) : 0.f;
    }
    __syncthreads();

    for (int qq = warp; qq < nq; qq += kWarps) {
      const float4 gq = load4(g + ((long long)bh * Qp + c0 + qq) * kD, sub);
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {
        if (i >= NL) break;
        // the point's y0 and y0 + 1 taps, and their corners i0, i0 + 1
        const int tk[2] = {i * 2 * kP + group, i * 2 * kP + kP + group};
        int pc[4];
        float rc[4], ak[2];
        bool frac[2];
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = tk[k] * kStride + qq;
          const float x = s_px[s];
          const float xf = floorf(x);
          ak[k] = s_w[s];
          frac[k] = x > xf;
          pc[2 * k] = s_row[s] + (int)xf;
          pc[2 * k + 1] = pc[2 * k] + 1;
          rc[2 * k] = 1.f - (x - xf);
          rc[2 * k + 1] = 1.f - ((xf + 1.f) - x);
          v[2 * k] = load4(value + vbase + pc[2 * k] * row_stride, sub);
          v[2 * k + 1] = frac[k] ? load4(value + vbase + pc[2 * k + 1] * row_stride, sub)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float pv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[c] = xor_sum<1, kGroupLanes / 2>(dot4(gq, v[c]));
        if (sub == 0) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = tk[k] * kStride + qq;
            s_gw[s] = rc[2 * k] * pv[2 * k] + rc[2 * k + 1] * pv[2 * k + 1];
            s_gpx[s] = frac[k] ? pv[2 * k + 1] - pv[2 * k] : 0.f;
          }
        }

        const int start = lv.start[i], n_rows = lv.h[i] * lv.w[i], srow0 = lv.smem_row[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float k = rc[c] * ak[c / 2];
          if (k == 0.f) continue;
          const int r = pc[c] - start;
          add_row(acc, touched, srow0 >= 0 && r >= 0 && r < n_rows ? srow0 + r : -1,
                  grad_value + vbase + pc[c] * row_stride, group, sub,
                  make_float4(k * gq.x, k * gq.y, k * gq.z, k * gq.w));
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * kChunk; i += kThreads) {
      const int t = i / kChunk, qq = i % kChunk;
      if (qq < nq) {
        const long long o = ((long long)bh * T + t) * Qp + c0 + qq;
        gw[o] = s_gw[t * kStride + qq];
        gpx[o] = s_gpx[t * kStride + qq];
      }
    }
  }

  __syncthreads();
  flush_rows(acc, touched, smem_rows, NL, lv, grad_value + vbase, row_stride, kThreads);
}

int smem_bytes_for(int smem_rows) {
  return 5 * kTaps * kStride * 4 + smem_rows * kD * 4 + ((smem_rows + 15) / 16) * 16;
}

template <typename V>
int launch(const void* value, const void* row, const void* px, const void* w, const void* g,
           void* grad_value, void* gw, void* gpx, int B, int L, int H, int Qp, int NL, int P,
           const int* shapes_hw, const int* level_start, int tile_q, const int* smem_row,
           int smem_rows, int smem_bytes, void* stream) {
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
  cudaError_t err = cudaFuncSetAttribute(rowtap_bwd_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  rowtap_bwd_kernel<V><<<(unsigned)((long long)B * H * n_tiles), kThreads, smem_bytes,
                         (cudaStream_t)stream>>>(
      (const V*)value, (const int*)row, (const float*)px, (const float*)w, (const V*)g,
      (float*)grad_value, (float*)gw, (float*)gpx, L, H, Qp, NL, tile_q, n_tiles, smem_rows, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the K10 entries with smem_rows accumulator rows
// (either value type).
int msda_rowtap_bwd_smem_bytes(int smem_rows) { return smem_bytes_for(smem_rows); }

// value, g, grad_value 16-byte aligned; row int32, the rest f32, all
// contiguous.  grad_value must be zeroed by the caller; gw and gpx are
// written whole.  The plan (ops/msda_sweep.py rowtap_bwd_plan): tile_q
// queries a CTA; smem_row[l] the first accumulator row of level l in shared
// memory, or -1 for a level scattered to global memory; smem_rows rows in
// all, in smem_bytes of dynamic shared memory.  Returns a cudaError_t (0 =
// launched).
int msda_rowtap_bwd_f32(const void* value, const void* row, const void* px, const void* w,
                        const void* g, void* grad_value, void* gw, void* gpx, int B, int L,
                        int H, int Qp, int NL, int P, const int* shapes_hw,
                        const int* level_start, int tile_q, const int* smem_row, int smem_rows,
                        int smem_bytes, void* stream) {
  return launch<float>(value, row, px, w, g, grad_value, gw, gpx, B, L, H, Qp, NL, P, shapes_hw,
                       level_start, tile_q, smem_row, smem_rows, smem_bytes, stream);
}

// The bf16 entry: value and g bf16, everything else as msda_rowtap_bwd_f32
// (grad_value an f32 buffer, rounded to bf16 by the caller).
int msda_rowtap_bwd_bf16(const void* value, const void* row, const void* px, const void* w,
                         const void* g, void* grad_value, void* gw, void* gpx, int B, int L,
                         int H, int Qp, int NL, int P, const int* shapes_hw,
                         const int* level_start, int tile_q, const int* smem_row, int smem_rows,
                         int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(value, row, px, w, g, grad_value, gw, gpx, B, L, H, Qp, NL, P,
                               shapes_hw, level_start, tile_q, smem_row, smem_rows, smem_bytes,
                               stream);
}

}  // extern "C"
