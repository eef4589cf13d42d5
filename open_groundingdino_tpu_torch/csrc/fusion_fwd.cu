// K2: bidirectional image<->text fusion attention forward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/fusion_pallas.py::_fused_bi_attn_kernel.
// Per batch b and head h, with q, val_v (Nv image tokens) and k, val_l (Nl text
// tokens) sliced to the head's D lanes of the raw (B, N, E=H*D) projections:
//   L[v, l] = q[v] . k[l]                     (q arrives pre-scaled)
//   out_v[v] = sum_l rowsoftmax_l(L[v, :] over live text)[l] * val_l[l]
//   out_l[l] = sum_v colsoftmax_v(L[:, l] over live image)[v] * val_v[v]
// Masks: mask_v 1 = padded image token, mask_l 1 = padded text token.  The
// column softmax of a PADDED text token is computed on its raw logits, as the
// literal formulation (models/layers.py BiMultiHeadAttention, xla) does; the
// TPU kernel leaves those rows near-uniform.  The literal formulation's global
// max shift and +-50000 clamps are no-ops unless the logit range exceeds 50000.
//
// What bounds it: operations.  At the flagship bucket (Nv ~ 20k, Nl = 256,
// E = 1024, H = 4, D = 256) the three products are ~32 GFLOP per call against
// ~250 MB of compulsory traffic (q, val_v, out_v in f32), i.e. ~130 FLOP/B:
// above the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B) of the SIMT units.
//
// What the design does about it.  The TPU carries the column softmax state
// across a sequential grid axis; CUDA blocks run in parallel and in no order,
// and one head's text keys and values (Nl x D f32 = 256 KB each) do not fit in
// the 227 KB of shared memory a block may use.  So both directions run as the
// same flash-style kernel (online softmax over key tiles of 32, query blocks
// of 64 rows, one warp per 8 query rows, lane = key column for the logits and
// lane = output channel for the product):
//   1. image rows attend over text keys: grid (Nv/64, H, B), one pass, out_v
//      written directly;
//   2. text rows attend over image keys: grid (Nl/64, H*S, B), the image axis
//      split in S chunks, each writing a partial (max, sum, acc[64, D]);
//   3. a combine kernel merges the S partials into out_l.
// The logits are computed twice (4 products instead of 3), which keeps each
// pass a plain streaming kernel.  A key tile whose keys are all padding is
// skipped (a caption of 41 tokens leaves 6 of pass 1's 8 text tiles dead).
// f32 SIMT math (no tensor cores, no TF32) so
// the result matches the f32 plain version to rounding.  Faster tensor-core
// variants are later work.
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;          // query rows per block
constexpr int kWarps = 8;          // 8 rows per warp
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;          // key tile = one key per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ[kRows][D] + sKt[D][kKeys + 1] + sV[kKeys][D]
  return sizeof(float) * ((size_t)kRows * D + (size_t)D * (kKeys + 1) + (size_t)kKeys * D);
}

// One block: kRows query rows of head h, keys [k_begin, k_end) of split s.
// Qm/Km/Vm rows are E floats apart; the head's slice starts at h*D.
// n_splits == 1: writes the normalized rows to out (B, Nq, E) and each row's
// log-sum-exp over its live keys to lse (B, H, Nq) (+inf for a row with no
// live key, so that exp(s - lse) is 0 in the backward).
// n_splits > 1: writes the partial (acc, max, sum) of split s.
template <int D>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ Qm, const float* __restrict__ Km,
              const float* __restrict__ Vm, const uint8_t* __restrict__ key_pad,
              int Nq, int Nk, int E, int H, int n_splits, int chunk,
              float* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ part_acc, float* __restrict__ part_m,
              float* __restrict__ part_s) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* sQ = smem;                            // [kRows][D]
  float* sKt = sQ + kRows * D;                 // [D][kKeys + 1]
  float* sV = sKt + D * (kKeys + 1);           // [kKeys][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y % H;
  const int split = blockIdx.y / H;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(Nk, k_begin + chunk);

  const float* qb = Qm + (long long)b * Nq * E + h * D;
  const float* kb = Km + (long long)b * Nk * E + h * D;
  const float* vb = Vm + (long long)b * Nk * E + h * D;
  const uint8_t* padb = key_pad + (long long)b * Nk;

  // query block -> shared (zeros past Nq)
  for (int i = tid; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Nq) v = reinterpret_cast<const float4*>(qb + (long long)(r0 + r) * E)[c4];
    reinterpret_cast<float4*>(sQ + r * D)[c4] = v;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][DJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kKeys) {
    // Barrier (previous tile consumed, sQ written) and vote: a tile whose keys
    // are all padding adds nothing, so the block skips it.
    const int kk = c0 + tid;
    if (!__syncthreads_or(tid < kKeys && kk < k_end && key_pad[(long long)b * Nk + kk] == 0)) {
      continue;
    }
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int c = i / D, k = i % D;
      const bool in = c0 + c < k_end;
      sKt[k * (kKeys + 1) + c] = in ? kb[(long long)(c0 + c) * E + k] : 0.f;
    }
    for (int i = tid; i < kKeys * D / 4; i += kThreads) {
      const int c = i / (D / 4), c4 = i % (D / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < k_end) v = reinterpret_cast<const float4*>(vb + (long long)(c0 + c) * E)[c4];
      reinterpret_cast<float4*>(sV + c * D)[c4] = v;
    }
    __syncthreads();

    // logits: this warp's 8 rows x key column `lane`
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* qw = sQ + warp * kRowsPerWarp * D;
    for (int k = 0; k < D; k += 4) {
      const float k0 = sKt[(k + 0) * (kKeys + 1) + lane];
      const float k1 = sKt[(k + 1) * (kKeys + 1) + lane];
      const float k2 = sKt[(k + 2) * (kKeys + 1) + lane];
      const float k3 = sKt[(k + 3) * (kKeys + 1) + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * D + k);
        s[i] = fmaf(qq.x, k0, s[i]);
        s[i] = fmaf(qq.y, k1, s[i]);
        s[i] = fmaf(qq.z, k2, s[i]);
        s[i] = fmaf(qq.w, k3, s[i]);
      }
    }

    // online softmax over this tile's live keys
    const int key = c0 + lane;
    const bool valid = key < k_end && padb[key] == 0;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float m_new = fmaxf(m[i], warp_max(valid ? s[i] : -FLT_MAX));
      p[i] = valid ? expf(s[i] - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }

    // o[i][:] += p[i][:] @ V_tile ; lane owns channels lane + 32*j
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pc = __shfl_sync(0xffffffffu, p[i], c);
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pc, vv[j], o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    if (r >= Nq) continue;
    if (n_splits == 1) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      float* orow = out + ((long long)b * Nq + r) * E + h * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) orow[lane + 32 * j] = o[i][j] * inv;
      if (lane == 0) lse[((long long)b * H + h) * Nq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    } else {
      const long long idx = (((long long)b * H + h) * n_splits + split) * Nq + r;
#pragma unroll
      for (int j = 0; j < DJ; ++j) part_acc[idx * D + lane + 32 * j] = o[i][j];
      if (lane == 0) {
        part_m[idx] = m[i];
        part_s[idx] = l[i];
      }
    }
  }
}

// out[b, r, h*D + d] = sum_s e^(m_s - M) acc_s[d] / sum_s e^(m_s - M) l_s;
// lse[b, h, r] = M + log(sum_s e^(m_s - M) l_s), the column statistics K4 reads
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_s,
                               float* __restrict__ out, float* __restrict__ lse,
                               int Nq, int E, int H, int D, int n_splits) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long base = (((long long)b * H + h) * n_splits) * Nq + r;
  float M = -FLT_MAX;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_m[base + (long long)s * Nq]);
  float tot = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const long long idx = base + (long long)s * Nq;
    tot += expf(part_m[idx] - M) * part_s[idx];
  }
  const float inv = tot > 0.f ? 1.f / tot : 0.f;
  if (threadIdx.x == 0) lse[((long long)b * H + h) * Nq + r] = tot > 0.f ? M + logf(tot) : INFINITY;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const long long idx = base + (long long)s * Nq;
      acc += expf(part_m[idx] - M) * part_acc[idx * D + d];
    }
    out[((long long)b * Nq + r) * E + h * D + d] = acc * inv;
  }
}

template <int D>
cudaError_t attend(const float* Qm, const float* Km, const float* Vm, const uint8_t* key_pad,
                   int B, int Nq, int Nk, int E, int H, int n_splits, float* out, float* lse,
                   float* part_acc, float* part_m, float* part_s, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attend_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // split chunk: whole key tiles, so a split never starts mid-tile
  int chunk = (Nk + n_splits - 1) / n_splits;
  chunk = (chunk + kKeys - 1) / kKeys * kKeys;
  dim3 grid((Nq + kRows - 1) / kRows, H * n_splits, B);
  attend_kernel<D><<<grid, kThreads, smem, stream>>>(Qm, Km, Vm, key_pad, Nq, Nk, E, H,
                                                     n_splits, chunk, out, lse, part_acc,
                                                     part_m, part_s);
  return cudaGetLastError();
}

template <int D>
int fusion_fwd(const float* q, const float* k, const float* val_v, const float* val_l,
               const uint8_t* pad_v, const uint8_t* pad_l, float* out_v, float* out_l,
               float* lse_v, float* lse_l, float* part_acc, float* part_m, float* part_s,
               int B, int Nv, int Nl, int E, int H, int n_splits, cudaStream_t stream) {
  // 1. image rows over text keys -> out_v, lse_v
  cudaError_t err = attend<D>(q, k, val_l, pad_l, B, Nv, Nl, E, H, 1, out_v, lse_v,
                              nullptr, nullptr, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  // 2. text rows over image keys, image axis in n_splits chunks -> partials
  err = attend<D>(k, q, val_v, pad_v, B, Nl, Nv, E, H, n_splits, nullptr, nullptr,
                  part_acc, part_m, part_s, stream);
  if (err != cudaSuccess) return (int)err;
  // 3. merge the partials -> out_l, lse_l
  combine_kernel<<<dim3(Nl, H, B), D < 256 ? D : 256, 0, stream>>>(
      part_acc, part_m, part_s, out_l, lse_l, Nl, E, H, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All float tensors f32 contiguous: q, val_v, out_v (B, Nv, E); k, val_l,
// out_l (B, Nl, E); pad_v (B, Nv), pad_l (B, Nl) uint8 with 1 = padded.
// Softmax statistics for the backward (K4, csrc/fusion_bwd.cu): lse_v (B, H, Nv),
// each image row's log-sum-exp over the live text; lse_l (B, H, Nl), each text
// column's log-sum-exp over the live image tokens (the JAX kernel's ml_max and sl).
// Scratch: part_acc (B, H, n_splits, Nl, D), part_m / part_s (B, H, n_splits, Nl).
// n_splits >= 2.  Head dim E / H must be 256, the only one the model has
// (fusion E = 1024, H = 4).  Returns a cudaError_t (0 = launched).
int fusion_fwd_f32(const void* q, const void* k, const void* val_v, const void* val_l,
                   const void* pad_v, const void* pad_l, void* out_v, void* out_l,
                   void* lse_v, void* lse_l, void* part_acc, void* part_m, void* part_s,
                   int B, int Nv, int Nl, int E, int H, int n_splits, void* stream) {
  if (H * 256 != E || n_splits < 2) return (int)cudaErrorInvalidValue;
  return fusion_fwd<256>((const float*)q, (const float*)k, (const float*)val_v,
                         (const float*)val_l, (const uint8_t*)pad_v, (const uint8_t*)pad_l,
                         (float*)out_v, (float*)out_l, (float*)lse_v, (float*)lse_l,
                         (float*)part_acc, (float*)part_m, (float*)part_s,
                         B, Nv, Nl, E, H, n_splits, (cudaStream_t)stream);
}

}  // extern "C"
