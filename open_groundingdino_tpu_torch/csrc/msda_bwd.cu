// K3: multi-scale deformable attention backward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_bwd_kernel
// (the TPU's default MSDA backward).  Computes the gradient of K1's function
// (open_groundingdino_tpu/ops/msda.py::ms_deform_attn_xla, i.e. jax.grad of
// it) on the reference operand layout:
//   value (B, L, H, D), locations (B, Q, H, NL, P, 2), weights (B, Q, H, NL, P),
//   upstream gradient g (B, Q, H*D)
//   -> grad_value (B, L, H, D), grad_locs (B, Q, H, NL, P, 2), grad_attn (B, Q, H, NL, P)
// With px = x*W_l - 0.5, fx = px - floor(px) (floor has zero derivative, so
// the derivative is the one-sided one of the bilinear weights), corners
// outside the map contribute nothing (their weight is zero, so is its
// derivative), and for each sample s with weight a and corner values v_c:
//   grad_value[corner c] += a * w_c * g
//   grad_attn[s]          = sum_d g * sum_c w_c v_c
//   d/dpx                 = a * sum_d g * ((1-fy)(v10 - v00) + fy (v11 - v01))
//   d/dpy                 = a * sum_d g * ((1-fx)(v01 - v00) + fx (v11 - v10))
//   grad_locs[s]          = (d/dpx * W_l, d/dpy * H_l)
// Built for D = 32, P = 4, NL <= 4 (msda_common.cuh).
//
// What bounds it: the grad_value scatter.  Each (b, q, h) adds 64 corner rows
// of 32 f32 at data-dependent places; one scalar atomicAdd a channel, as a
// warp per (b, q, h) with lane = channel did, is 1.3 G atomics a B = 4
// encoder call, and they pile onto few addresses: each (b, h) sends 323 k
// row-scatters into every level, so level 3's 247 rows take ~1,300
// read-modify-writes each and level 2's 950 rows ~340, serialised in L2.
// The compulsory work (8 FLOP a channel a corner) takes ~0.15 ms there.
//
// What the design does about it (the rest as K1, msda_common.cuh: a CTA per
// (b, h) and tile of consecutive queries, samples staged once, 4 lane groups
// of 8 lanes a warp, float4 rows):
//   - the levels whose per-head map fits in shared memory accumulate their
//     grad_value there, with shared-memory float atomics (compare-and-swap
//     loops on Hopper: ATOMS.CAST.SPIN), the four groups' channels rotated so
//     they hit different banks.  At the end of the tile each touched row is
//     added to global memory once, one float4 atomic a 16 B.  This is the TPU
//     kernel's resident grad_value block, which it zeroes at the first query
//     block and read-modify-writes across the sequential query axis: CTAs run
//     in no order, so the carry across tiles stays an atomic add, one a row a
//     tile.  The budget keeps 2 CTAs of 16 warps an SM: at the 800x1216
//     bucket only level 3 (247 rows, 31 KB) goes there.  Levels 2 and 3
//     together (153 KB) leave one CTA an SM and were slower (PERF.md, PR 6);
//   - the other levels scatter straight to global memory with Hopper's
//     vector atomic (atomicAdd on float4, red.global.add.v4.f32): one
//     instruction a 16 B, 4x fewer than scalar atomics;
//   - grad_attn and grad_locs are summed within the lane group, 3 shuffle
//     levels a sample;
//   - ops/msda.py plans the tile, the shared-memory levels and the dynamic
//     shared-memory bytes (msda_bwd_plan) and passes them in.
// The order of the f32 sums changes from run to run (atomics).
// The bf16 entry (msda_bwd_bf16: bf16 value, upstream gradient and
// grad_value) is the JAX package's default, MSDA_BWD_GV_BF16=1
// (msda_banded.py:693-709): value rows of 64 B (8 B a lane), the products
// and grad_locs / grad_attn in f32, grad_value accumulated in bf16 with
// bf16x2 reductions (red.global.add.noftz.bf16x2, two a lane a corner row),
// each add rounding, but for the shared-memory levels: their tile sums add in
// f32 to a scratch copy of their rows, rounded into grad_value once at the
// end (round_rows_kernel).  The error grows with the bf16 adds a row takes,
// so its plan (ops/msda.py BWD_SMEM_BUDGET_BF16) gives shared memory levels 2
// and 3 at the 800x1216 bucket (1 CTA an SM): the f32 entry's plan, level 3
// alone, leaves level 2's ~340 bf16 adds a row (chip_smoke.py phase 20
// records that plan's error beside this one's).  The JAX package bounds its
// bf16 accumulation at 3e-2 (tests/test_msda_banded.py:133).
// ptxas -v (-O3, sm_90a, CUDA 12.8): 60 registers, no spills; dynamic shared
// memory 44,160 B at the 800x1216 bucket (slots 12,288 + level 3's 31,616 +
// flags 256).  Its SASS holds 19 vector global reductions (RED F32x4), no
// scalar ones, and 64 shared-memory compare-and-swap loops (ATOMS.CAST.SPIN).
#include <type_traits>

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

// The bf16 entry's flush: each touched shared-memory row added to the
// (b, h)'s f32 scratch rows (one float4 atomic a 16 B), which round_rows
// rounds to bf16 once, after every tile has added its sums
__device__ __forceinline__ void flush_scratch(const float* acc, const unsigned char* touched,
                                              int smem_rows, float* scratch, int n_threads) {
  for (int i = threadIdx.x; i < smem_rows * (kD / 4); i += n_threads) {
    if (!touched[i / (kD / 4)]) continue;
    atomicAdd(reinterpret_cast<float4*>(scratch) + i, reinterpret_cast<const float4*>(acc)[i]);
  }
}

// grad_value's shared-memory-level rows from the f32 scratch (B*H rows of
// smem_rows x kD), rounded to bf16: 4 channels a thread; those rows take
// no other add
__global__ void round_rows_kernel(const float* __restrict__ scratch,
                                  __nv_bfloat16* __restrict__ grad_value, long long n4, int L,
                                  int H, int NL, int smem_rows, Levels lv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int sub = (int)(i % (kD / 4));
  const long long row = i / (kD / 4);
  const int r = (int)(row % smem_rows);
  const long long bh = row / smem_rows;
  const long long b = bh / H, h = bh % H;
  const int pos = smem_row_position(r, NL, lv);
  store4(grad_value + ((b * L + pos) * H + h) * kD, sub,
         reinterpret_cast<const float4*>(scratch)[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                const float* __restrict__ attn, const T* __restrict__ grad_out,
                T* __restrict__ grad_value, float* __restrict__ grad_locs,
                float* __restrict__ grad_attn, float* __restrict__ gv_scratch,
                int L, int H, int Q, int NL, int tile_q, int n_tiles, int smem_rows, Levels lv) {
  // dynamic shared memory: the warps' sample slots, then smem_rows
  // accumulator rows of kD f32, then a touched flag a row
  extern __shared__ float4 smem[];
  Slot* slots = reinterpret_cast<Slot*>(smem);
  float* acc = reinterpret_cast<float*>(slots + kWarps * kSamples);
  unsigned char* touched = reinterpret_cast<unsigned char*>(acc + (long long)smem_rows * kD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / kGroupLanes, sub = lane % kGroupLanes;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int nlp = NL * kP;
  const long long row_stride = (long long)H * kD;
  const long long vbase = ((long long)b * L * H + h) * kD;
  const int q_end = min(Q, (tile + 1) * tile_q);
  Slot* my = slots + warp * kSamples;

  zero_rows(acc, touched, smem_rows, kThreads);
  __syncthreads();

  for (int q = tile * tile_q + warp; q < q_end; q += kWarps) {
    const long long bqh = ((long long)b * Q + q) * H + h;
    if (lane < kSamples)
      stage_sample<false>(locs + bqh * nlp * 2, attn + bqh * nlp, lane, nlp, lv, my + lane);
    __syncwarp();
    const float4 g = load4(grad_out + bqh * kD, sub);
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      const Slot& s = my[i * kGroups + group];
      const int4 pos = s.pos;
      const float4 w = s.w;
      const float4 aux = s.aux;
      const int pc[4] = {pos.x, pos.y, pos.z, pos.w};
      float4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = pc[c] >= 0 ? load4(value + vbase + pc[c] * row_stride, sub)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float a = aux.x, fx = aux.y, fy = aux.z;
      const float gv0 = dot4(g, v[0]), gv1 = dot4(g, v[1]);
      const float gv2 = dot4(g, v[2]), gv3 = dot4(g, v[3]);
      const float pa = xor_sum<1, kGroupLanes / 2>(w.x * gv0 + w.y * gv1 + w.z * gv2 + w.w * gv3);
      const float pdx = xor_sum<1, kGroupLanes / 2>((1.f - fy) * (gv1 - gv0) + fy * (gv3 - gv2));
      const float pdy = xor_sum<1, kGroupLanes / 2>((1.f - fx) * (gv2 - gv0) + fx * (gv3 - gv1));
      const int sidx = i * kP + group;        // (level i, point group)
      if (sub == 0 && i < NL) {
        grad_attn[bqh * nlp + sidx] = pa;
        grad_locs[(bqh * nlp + sidx) * 2] = a * pdx * (float)lv.w[i];
        grad_locs[(bqh * nlp + sidx) * 2 + 1] = a * pdy * (float)lv.h[i];
      }
      const int srow0 = __float_as_int(aux.w);
      const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (pc[c] < 0) continue;
        const float k = a * wc[c];
        add_row(acc, touched, srow0 != INT_MIN ? srow0 + pc[c] : -1,
                grad_value + vbase + pc[c] * row_stride, group, sub,
                make_float4(k * g.x, k * g.y, k * g.z, k * g.w));
      }
    }
    __syncwarp();   // the slots are restaged for the next query
  }

  __syncthreads();
  if constexpr (std::is_same<T, float>::value)
    flush_rows(acc, touched, smem_rows, NL, lv, grad_value + vbase, row_stride, kThreads);
  else
    flush_scratch(acc, touched, smem_rows, gv_scratch + (long long)bh * smem_rows * kD, kThreads);
}

}  // namespace

extern "C" {

// Dynamic shared memory of msda_bwd_f32 and msda_bwd_bf16 with smem_rows
// accumulator rows.
int msda_bwd_smem_bytes(int smem_rows) {
  return (int)(kWarps * kSamples * sizeof(Slot)) + smem_rows * kD * 4 + ((smem_rows + 15) / 16) * 16;
}

}  // extern "C"

namespace {

using namespace msda;

template <typename T>
int launch(const void* value, const void* locs, const void* attn, const void* grad_out,
           void* grad_value, void* grad_locs, void* grad_attn, void* gv_scratch,
           int B, int L, int H, int D, int Q, int NL, int P,
           const int* shapes_hw, const int* level_start, int tile_q,
           const int* smem_row, int smem_rows, int smem_bytes, void* stream) {
  if (D != kD || P != kP || NL <= 0 || NL > kMaxLevels || tile_q <= 0 || smem_rows < 0
      || smem_bytes < msda_bwd_smem_bytes(smem_rows))
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
  const int n_tiles = (Q + tile_q - 1) / tile_q;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(msda_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  msda_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)locs, (const float*)attn, (const T*)grad_out,
      (T*)grad_value, (float*)grad_locs, (float*)grad_attn, (float*)gv_scratch,
      L, H, Q, NL, tile_q, n_tiles, smem_rows, lv);
  err = cudaGetLastError();
  if (std::is_same<T, float>::value || err != cudaSuccess || smem_rows == 0) return (int)err;
  const long long n4 = (long long)B * H * smem_rows * (kD / 4);
  round_rows_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)gv_scratch, (__nv_bfloat16*)grad_value, n4, L, H, NL, smem_rows, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All f32 contiguous; value, grad_out and grad_value 16-byte aligned.
// grad_value must be zeroed by the caller (the kernel accumulates into it);
// grad_locs and grad_attn are written whole.  The plan (ops/msda.py
// msda_bwd_plan): tile_q queries a CTA; smem_row[l] the first accumulator
// row of level l in shared memory, or -1 for a level scattered to global
// memory; smem_rows rows in all, in smem_bytes of dynamic shared memory.
// Returns a cudaError_t (0 = launched).
int msda_bwd_f32(const void* value, const void* locs, const void* attn, const void* grad_out,
                 void* grad_value, void* grad_locs, void* grad_attn,
                 int B, int L, int H, int D, int Q, int NL, int P,
                 const int* shapes_hw, const int* level_start, int tile_q,
                 const int* smem_row, int smem_rows, int smem_bytes, void* stream) {
  return launch<float>(value, locs, attn, grad_out, grad_value, grad_locs, grad_attn, nullptr,
                       B, L, H, D, Q, NL, P, shapes_hw, level_start, tile_q,
                       smem_row, smem_rows, smem_bytes, stream);
}

// value, grad_out and grad_value bf16 (8-byte aligned rows of 64 B), locs,
// attn, grad_locs and grad_attn f32; a plan as msda_bwd_f32's (the slots
// and the f32 accumulator rows do not depend on the value's type).
// grad_value (zeroed by the caller) accumulates in bf16: the other levels'
// corner rows add with bf16x2 reductions; the shared-memory levels' tile
// sums add in f32 to gv_scratch (B*H*smem_rows*32 f32, zeroed by the caller),
// which a second kernel rounds into grad_value once.
int msda_bwd_bf16(const void* value, const void* locs, const void* attn, const void* grad_out,
                  void* grad_value, void* grad_locs, void* grad_attn, void* gv_scratch,
                  int B, int L, int H, int D, int Q, int NL, int P,
                  const int* shapes_hw, const int* level_start, int tile_q,
                  const int* smem_row, int smem_rows, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(value, locs, attn, grad_out, grad_value, grad_locs, grad_attn,
                               gv_scratch, B, L, H, D, Q, NL, P, shapes_hw, level_start, tile_q,
                               smem_row, smem_rows, smem_bytes, stream);
}

}  // extern "C"
