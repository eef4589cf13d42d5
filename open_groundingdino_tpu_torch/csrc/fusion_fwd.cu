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
// E = 1024, H = 4, D = 256) the products are tens of GFLOP per call against
// ~250 MB of compulsory traffic, ~100 FLOP/B: above the ridge of the f32 SIMT
// units (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B) and near that of the tensor
// cores in 3xTF32 (165 TFLOP/s, 49 FLOP/B).  The f32 SIMT design this
// replaced held its logits at one scalar shared-memory load per FMA and
// reached ~10% of the SIMT peak.  On the tensor cores the limit is the
// instruction stream around the MMAs: every fragment element needs its split
// and its swizzled address, and each warp needs independent accumulator
// chains to keep the tensor pipe fed.
//
// What the design does about it.  Every product runs on the tensor cores
// (mma.sync m16n8k8 tf32) in 3xTF32 (tf32x3.cuh), which keeps the error near
// f32's (the smoke holds K2 to 1e-4 absolute; one TF32 pass would miss it).
// Both directions run as one flash-style kernel: 128 query rows a block, one
// warp per 16-row slab holding that slab's whole 256-wide f32 output in
// registers (240 a thread, no spills); key tiles of 16 rows staged by
// cp.async into two shared-memory stages, the next tile loading while this
// one computes.  Each key and value tile is split into hi and lo once, by the
// whole block, for all eight warps; the query tile is split as it is read.  Fragments come in by ldmatrix (query, keys)
// and scalar loads (values) at per-thread offsets computed once, so the inner
// loops carry no address arithmetic.  The online softmax runs on the
// accumulator fragments of S = Q.K^T (row max and sum over the 4 threads of
// a quad), and P feeds P.V straight from those fragments, the value tile
// being read in the matching permuted key order.
//   1. image rows attend over text keys: grid (Nv/128, H, B), out_v written
//      directly;
//   2. text rows attend over image keys: grid (Nl/128, H*S, B), the image axis
//      split in S chunks, each writing a partial (max, sum, acc[128, D]);
//   3. a combine kernel merges the S partials, in order, into out_l.
// The logits are computed once per direction (4 products instead of 3), which
// keeps each pass a plain streaming kernel.  A key tile whose keys are all
// padding is neither loaded nor computed (a caption of 41 tokens leaves 13 of
// pass 1's 16 text tiles dead).  Rows past the ragged end (Nv = 20197) are
// zero-filled on load and never written.
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int D = kD;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;   // query rows per block: one 16-row slab a warp
constexpr int kKeys = 16;            // key tile
constexpr int kNT = D / 8;           // 8-lane output tiles per row slab
// the query tile, two stages of key and value tiles and the lo parts of the
// current pair; then the key-padding flags of the block's key range and a
// live flag per key tile (chunk and chunk / kKeys bytes, see `smem_bytes`)
constexpr size_t kSmemTiles = sizeof(float) * ((size_t)kRows * D + 6 * (size_t)kKeys * D);

size_t smem_bytes(int chunk) { return kSmemTiles + round16(chunk) + round16(chunk / kKeys); }

// keys per split: whole key tiles, so a split never starts mid-tile
int split_chunk(int Nk, int n_splits) {
  const int chunk = (Nk + n_splits - 1) / n_splits;
  return (chunk + kKeys - 1) / kKeys * kKeys;
}

// first key tile at or after c0 (a multiple of kKeys from k_begin) holding a
// live key, or k_end
__device__ __forceinline__ int next_live(const uint8_t* sLive, int c0, int k_begin, int k_end) {
  while (c0 < k_end && !sLive[(c0 - k_begin) / kKeys]) c0 += kKeys;
  return min(c0, k_end);
}

// One block: kRows query rows of head h, keys [k_begin, k_end) of split s.
// Qm/Km/Vm rows are E floats apart; the head's slice starts at h*D.
// n_splits == 1: writes the normalized rows to out (B, Nq, E) and each row's
// log-sum-exp over its live keys to lse (B, H, Nq) (+inf for a row with no
// live key, so that exp(s - lse) is 0 in the backward).
// n_splits > 1: writes the partial (acc, max, sum) of split s.
__global__ void __launch_bounds__(kThreads, 1)
attend_kernel(const float* __restrict__ Qm, const float* __restrict__ Km,
              const float* __restrict__ Vm, const uint8_t* __restrict__ key_pad,
              int Nq, int Nk, int E, int H, int n_splits, int chunk,
              float* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ part_acc, float* __restrict__ part_m,
              float* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kRows][D]
  float* sK = sQ + kRows * D;                    // [2][kKeys][D]
  float* sV = sK + 2 * kKeys * D;                // [2][kKeys][D]
  float* sKlo = sV + 2 * kKeys * D;              // [kKeys][D]
  float* sVlo = sKlo + kKeys * D;                // [kKeys][D]
  uint8_t* sPad = reinterpret_cast<uint8_t*>(sVlo + kKeys * D);     // [chunk]
  uint8_t* sLive = sPad + round16(chunk);                           // [chunk / kKeys]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
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

  load_tile<kRows, kThreads>(sQ, qb, E, r0, Nq, tid);
  stage_pads(sPad, sLive, padb, k_begin, k_end, chunk, kKeys, tid, kThreads);
  int c0 = next_live(sLive, k_begin, k_begin, k_end);
  if (c0 < k_end) {
    load_tile<kKeys, kThreads>(sK, kb, E, c0, k_end, tid);
    load_tile<kKeys, kThreads>(sV, vb, E, c0, k_end, tid);
  }
  cp_async_commit();

  // this thread's rows: m0 + g (fragment elements 0, 1) and m0 + g + 8 (2, 3)
  const int m0 = warp * 16;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  // fragment offsets within the tiles, the same for every key tile
  const StepOffsets qo = a_offsets(m0, 0, lane), ko = key2_offsets(0, lane);
  const ValOffsets vo = val_offsets(0, g, t);
  const uint32_t sQa = smem_addr(sQ), sKloa = smem_addr(sKlo);

  int stage = 0;
  while (c0 < k_end) {
    cp_async_wait<0>();   // this stage (and the query tile) have landed
    // every warp is past the previous tile: its stage and the lo tiles are free
    __syncthreads();
    const int c1 = next_live(sLive, c0 + kKeys, k_begin, k_end);
    if (c1 < k_end) {     // the next tile loads while this one computes
      load_tile<kKeys, kThreads>(sK + (stage ^ 1) * kKeys * D, kb, E, c1, k_end, tid);
      load_tile<kKeys, kThreads>(sV + (stage ^ 1) * kKeys * D, vb, E, c1, k_end, tid);
    }
    cp_async_commit();
    // split the key and value tiles once for all warps: hi in place, lo apart
    float* K = sK + stage * kKeys * D;
    float* V = sV + stage * kKeys * D;
    split_tile<kThreads>(K, sKlo, kKeys * D, tid);
    split_tile<kThreads>(V, sVlo, kKeys * D, tid);
    __syncthreads();

    // S = Q . K^T: this warp's 16 rows x 16 keys, in four independent
    // accumulator chains (each 8-key tile's big and small terms)
    float s[2][4], ss[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ss[j][e] = 0.f;
    }
    const uint32_t Ka = smem_addr(K);
#pragma unroll 2
    for (int it = 0; it < D / 32; ++it) {   // reduction steps 4 it + q
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const FragA a = load_a(sQa, qo, q, it);
        FragB bk[2];
        load_b_key2_split(bk, Ka, sKloa, ko, q, it);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(s[j], ss[j], a, bk[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += ss[j][e];
    }

    // online softmax over this tile's live keys (element e of n-tile j is key
    // c0 + 8j + 2t + (e & 1), row g for e < 2 and g + 8 for e >= 2)
    bool valid[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) valid[j][e] = sPad[c0 - k_begin + 8 * j + 2 * t + e] == 0;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // row half: g (i = 0), g + 8 (i = 1)
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (valid[j][e]) mx = fmaxf(mx, s[j][2 * i + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = valid[j][e] ? __expf(s[j][2 * i + e] - m_new) : 0.f;
          s[j][2 * i + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P . V over the tile's two 8-key halves
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragA p = a_from_acc(s[j]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma3(o[n], p, load_b_val_split(V, sVlo, vo, j, n));
    }
    c0 = c1;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + m0 + g + 8 * i;
    if (r >= Nq) continue;
    if (n_splits == 1) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      float* orow = out + ((long long)b * Nq + r) * E + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
      if (t == 0) lse[((long long)b * H + h) * Nq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    } else {
      const long long idx = (((long long)b * H + h) * n_splits + split) * Nq + r;
      float* prow = part_acc + idx * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      }
      if (t == 0) {
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
                               int Nq, int E, int H, int n_splits) {
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

cudaError_t attend(const float* Qm, const float* Km, const float* Vm, const uint8_t* key_pad,
                   int B, int Nq, int Nk, int E, int H, int n_splits, float* out, float* lse,
                   float* part_acc, float* part_m, float* part_s, cudaStream_t stream) {
  const int chunk = split_chunk(Nk, n_splits);
  const size_t smem = smem_bytes(chunk);   // a chunk too long for shared memory fails here
  cudaError_t err = cudaFuncSetAttribute(attend_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kRows - 1) / kRows, H * n_splits, B);
  attend_kernel<<<grid, kThreads, smem, stream>>>(Qm, Km, Vm, key_pad, Nq, Nk, E, H, n_splits,
                                                   chunk, out, lse, part_acc, part_m, part_s);
  return cudaGetLastError();
}

int fusion_fwd(const float* q, const float* k, const float* val_v, const float* val_l,
               const uint8_t* pad_v, const uint8_t* pad_l, float* out_v, float* out_l,
               float* lse_v, float* lse_l, float* part_acc, float* part_m, float* part_s,
               int B, int Nv, int Nl, int E, int H, int n_splits, cudaStream_t stream) {
  // 1. image rows over text keys -> out_v, lse_v
  cudaError_t err = attend(q, k, val_l, pad_l, B, Nv, Nl, E, H, 1, out_v, lse_v,
                           nullptr, nullptr, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  // 2. text rows over image keys, image axis in n_splits chunks -> partials
  err = attend(k, q, val_v, pad_v, B, Nl, Nv, E, H, n_splits, nullptr, nullptr,
               part_acc, part_m, part_s, stream);
  if (err != cudaSuccess) return (int)err;
  // 3. merge the partials -> out_l, lse_l
  combine_kernel<<<dim3(Nl, H, B), 256, 0, stream>>>(part_acc, part_m, part_s, out_l, lse_l,
                                                    Nl, E, H, n_splits);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------- bf16 entry
// The same two passes and combine on bf16 operands (bf16_mma.cuh): S = Q.K^T
// on bf16 operands with f32 sums, the online softmax in f32, P.V with f32
// sums, outputs rounded to bf16 once.  As in the TPU kernel, the image side
// (image rows over text keys) rounds its P_v to bf16 for P.V
// (fusion_pallas.py:98-102), and the text side sums val_v^T.P_l in f32
// (:116-120): there (kSplitP) P_l is split into a bf16 high and low part and
// P.V is two MMAs into the same f32 accumulator, exact in val_v (bf16) and
// within ~2^-16 of P_l.  A block is 8 warps of 16 query rows, each holding
// its rows' 256-lane f32 output (128 registers a thread); key tiles of 16
// keys in two cp.async stages; S takes 16 MMAs a 16-key tile a warp, P.V 32
// (64 with kSplitP).
namespace bm = bf16mma;

// the query tile and two stages of key and value tiles (bf16); then the
// key-padding flags and live-tile flags, as the f32 entry's
constexpr size_t kSmemTilesBf16 = sizeof(bm::bf16) * ((size_t)kRows * D + 4 * (size_t)kKeys * D);

size_t smem_bytes_bf16(int chunk) {
  return kSmemTilesBf16 + round16(chunk) + round16(chunk / kKeys);
}

template <bool kSplitP>
__global__ void __launch_bounds__(kThreads, 1)
attend_bf16_kernel(const bm::bf16* __restrict__ Qm, const bm::bf16* __restrict__ Km,
                   const bm::bf16* __restrict__ Vm, const uint8_t* __restrict__ key_pad,
                   int Nq, int Nk, int E, int H, int n_splits, int chunk,
                   bm::bf16* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  bm::bf16* sQ = reinterpret_cast<bm::bf16*>(smem4);   // [kRows][D]
  bm::bf16* sK = sQ + kRows * D;                       // [2][kKeys][D]
  bm::bf16* sV = sK + 2 * kKeys * D;                   // [2][kKeys][D]
  uint8_t* sPad = reinterpret_cast<uint8_t*>(sV + 2 * kKeys * D);   // [chunk]
  uint8_t* sLive = sPad + round16(chunk);                           // [chunk / kKeys]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y % H;
  const int split = blockIdx.y / H;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(Nk, k_begin + chunk);

  const bm::bf16* qb = Qm + (long long)b * Nq * E + h * D;
  const bm::bf16* kb = Km + (long long)b * Nk * E + h * D;
  const bm::bf16* vb = Vm + (long long)b * Nk * E + h * D;
  const uint8_t* padb = key_pad + (long long)b * Nk;

  bm::load_tile<kRows, kThreads>(sQ, qb, E, r0, Nq, tid);
  stage_pads(sPad, sLive, padb, k_begin, k_end, chunk, kKeys, tid, kThreads);
  int c0 = next_live(sLive, k_begin, k_begin, k_end);
  if (c0 < k_end) {
    bm::load_tile<kKeys, kThreads>(sK, kb, E, c0, k_end, tid);
    bm::load_tile<kKeys, kThreads>(sV, vb, E, c0, k_end, tid);
  }
  cp_async_commit();

  const int m0 = warp * 16;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};

  int stage = 0;
  while (c0 < k_end) {
    cp_async_wait<0>();   // this stage (and the query tile) have landed
    __syncthreads();      // every warp is past the previous tile: its stage is free
    const int c1 = next_live(sLive, c0 + kKeys, k_begin, k_end);
    if (c1 < k_end) {     // the next tile loads while this one computes
      bm::load_tile<kKeys, kThreads>(sK + (stage ^ 1) * kKeys * D, kb, E, c1, k_end, tid);
      bm::load_tile<kKeys, kThreads>(sV + (stage ^ 1) * kKeys * D, vb, E, c1, k_end, tid);
    }
    cp_async_commit();
    const bm::bf16* K = sK + stage * kKeys * D;
    const bm::bf16* V = sV + stage * kKeys * D;

    // S = Q . K^T: this warp's 16 rows x 16 keys (two 8-key tiles j)
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4], bk[2][2];
      bm::load_a(a, sQ, m0, k0, lane);
      bm::load_b_key(bk, K, k0, lane);
      bm::mma(s[0], a, bk[0]);
      bm::mma(s[1], a, bk[1]);
    }

    // online softmax over this tile's live keys (element e of n-tile j is key
    // c0 + 8j + 2t + (e & 1), row g for e < 2 and g + 8 for e >= 2)
    bool valid[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) valid[j][e] = sPad[c0 - k_begin + 8 * j + 2 * t + e] == 0;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (valid[j][e]) mx = fmaxf(mx, s[j][2 * i + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = valid[j][e] ? __expf(s[j][2 * i + e] - m_new) : 0.f;
          s[j][2 * i + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P . V over the tile's 16 keys: P rounded to bf16, or under
    // kSplitP its high and low bf16 parts, two products
    uint32_t p[4], p_lo[4];
    if constexpr (kSplitP) {
      bm::a_from_acc_split(p, p_lo, s[0], s[1]);
    } else {
      bm::a_from_acc(p, s[0], s[1]);
    }
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t bv[2][2];
      bm::load_b_val(bv, V, 8 * n, lane);
      if constexpr (kSplitP) {
        bm::mma(o[n], p_lo, bv[0]);
        bm::mma(o[n + 1], p_lo, bv[1]);
      }
      bm::mma(o[n], p, bv[0]);
      bm::mma(o[n + 1], p, bv[1]);
    }
    c0 = c1;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + m0 + g + 8 * i;
    if (r >= Nq) continue;
    if (n_splits == 1) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      bm::bf16* orow = out + ((long long)b * Nq + r) * E + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            bm::pack(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
      if (t == 0) lse[((long long)b * H + h) * Nq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    } else {
      const long long idx = (((long long)b * H + h) * n_splits + split) * Nq + r;
      float* prow = part_acc + idx * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      }
      if (t == 0) {
        part_m[idx] = m[i];
        part_s[idx] = l[i];
      }
    }
  }
}

// combine_kernel's merge, the output rounded to bf16
__global__ void combine_bf16_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    bm::bf16* __restrict__ out, float* __restrict__ lse,
                                    int Nq, int E, int H, int n_splits) {
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
    out[((long long)b * Nq + r) * E + h * D + d] = __float2bfloat16_rn(acc * inv);
  }
}

cudaError_t attend_bf16(const bm::bf16* Qm, const bm::bf16* Km, const bm::bf16* Vm,
                        const uint8_t* key_pad, int B, int Nq, int Nk, int E, int H, int n_splits,
                        bm::bf16* out, float* lse, float* part_acc, float* part_m, float* part_s,
                        cudaStream_t stream) {
  // the text-row pass (split partials) keeps P's precision; the image-row
  // pass rounds it to bf16
  const int chunk = split_chunk(Nk, n_splits);
  const size_t smem = smem_bytes_bf16(chunk);
  auto kernel = n_splits > 1 ? attend_bf16_kernel<true> : attend_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kRows - 1) / kRows, H * n_splits, B);
  kernel<<<grid, kThreads, smem, stream>>>(Qm, Km, Vm, key_pad, Nq, Nk, E, H, n_splits, chunk,
                                           out, lse, part_acc, part_m, part_s);
  return cudaGetLastError();
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
  if (H * D != E || n_splits < 2) return (int)cudaErrorInvalidValue;
  return fusion_fwd((const float*)q, (const float*)k, (const float*)val_v,
                    (const float*)val_l, (const uint8_t*)pad_v, (const uint8_t*)pad_l,
                    (float*)out_v, (float*)out_l, (float*)lse_v, (float*)lse_l,
                    (float*)part_acc, (float*)part_m, (float*)part_s,
                    B, Nv, Nl, E, H, n_splits, (cudaStream_t)stream);
}


// Dynamic shared memory (bytes) of attend_kernel for a pass over Nk keys in
// n_splits chunks (the image-row pass has Nk = Nl and one chunk).
int fusion_fwd_smem_bytes(int Nk, int n_splits) {
  return (int)smem_bytes(split_chunk(Nk, n_splits));
}


// The bf16 entry: q, k, val_v, val_l, out_v, out_l bf16; lse_v, lse_l and the
// scratch f32, shapes and n_splits as fusion_fwd_f32's.
int fusion_fwd_bf16(const void* q, const void* k, const void* val_v, const void* val_l,
                    const void* pad_v, const void* pad_l, void* out_v, void* out_l,
                    void* lse_v, void* lse_l, void* part_acc, void* part_m, void* part_s,
                    int B, int Nv, int Nl, int E, int H, int n_splits, void* stream) {
  if (H * D != E || n_splits < 2) return (int)cudaErrorInvalidValue;
  typedef bm::bf16 T;
  cudaStream_t st = (cudaStream_t)stream;
  // 1. image rows over text keys -> out_v, lse_v
  cudaError_t err = attend_bf16((const T*)q, (const T*)k, (const T*)val_l, (const uint8_t*)pad_l,
                                B, Nv, Nl, E, H, 1, (T*)out_v, (float*)lse_v,
                                nullptr, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  // 2. text rows over image keys, image axis in n_splits chunks -> partials
  err = attend_bf16((const T*)k, (const T*)q, (const T*)val_v, (const uint8_t*)pad_v,
                    B, Nl, Nv, E, H, n_splits, nullptr, nullptr,
                    (float*)part_acc, (float*)part_m, (float*)part_s, st);
  if (err != cudaSuccess) return (int)err;
  // 3. merge the partials -> out_l, lse_l
  combine_bf16_kernel<<<dim3(Nl, H, B), 256, 0, st>>>((const float*)part_acc,
                                                      (const float*)part_m, (const float*)part_s,
                                                      (T*)out_l, (float*)lse_l, Nl, E, H, n_splits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of attend_bf16_kernel, as fusion_fwd_smem_bytes.
int fusion_fwd_bf16_smem_bytes(int Nk, int n_splits) {
  return (int)smem_bytes_bf16(split_chunk(Nk, n_splits));
}

}  // extern "C"
