// K4: bidirectional image<->text fusion attention backward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/fusion_pallas.py::_fused_bwd_kernel.
// The gradient of K2's function (csrc/fusion_fwd.cu).  Per batch b and head h,
// with L[v, l] = q[v] . k[l], the row softmax P_v (image row v over the live
// text) and the column softmax P_l (text column l over the live image):
//   G1 = g_ov . val_l^T       G2 = val_v . g_ol^T
//   rv[v] = g_ov[v] . out_v[v]         cl[l] = g_ol[l] . out_l[l]
//   dL = P_v * (G1 - rv) + P_l * (G2 - cl)
//   gq = dL . k     gk = dL^T . q     gvv = P_l . g_ol     gvl = P_v^T . g_ov
// P_v and P_l are recomputed from the logits and the log-sum-exp statistics
// that K2 saves (lse_v per image row, lse_l per text column); rv and cl are
// small reductions the wrapper computes with PyTorch, as the JAX package
// computes them outside its kernel.
//
// What bounds it: operations.  At the flagship bucket (Nv ~ 20k, Nl = 256,
// E = 1024, H = 4, D = 256) the four products that recompute L, G1, G2 and
// the four gradient products are each 2*Nv*Nl*D*H ~ 10.6 GFLOP, against a few
// hundred MB of compulsory traffic: far above the f32 SIMT ridge.
//
// What the design does about it.  The function is symmetric: with image rows
// as queries over text keys one pass yields gq and gvv, and with text rows as
// queries over image keys the same pass yields gk and gvl:
//   rows (a, a_val, a_g), keys (b, b_val, b_g), S = a.b, X = a_g.b_val,
//   Y = a_val.b_g, P_row = exp(S - lse_row) on live keys,
//   P_col = exp(S - lse_key) on live rows,
//   dL = P_row (X - t_row) + P_col (Y - t_key),
//   acc1 += dL . b,   acc2 += P_col . b_g
// (image side: a = q, b = k, acc1 = gq, acc2 = gvv; text side: a = k, b = q,
// acc1 = gk, acc2 = gvl).  One flash-style kernel runs both sides, as K2
// does: 32 query rows per block (4 per warp), key tiles of 32 (lane = key
// for the three logit-like products, lane = channel for the accumulation),
// every key-side operand in shared memory transposed with a padded stride
// so that both access patterns are free of bank conflicts.  On the TPU, gk
// and gvl accumulate across the sequential image-block axis; GPU blocks run
// in no order, so the text side splits the image axis in S chunks, each
// writing a partial, and a third kernel sums the partials in a fixed order:
// the result is deterministic.  A key tile with no live key contributes
// nothing to P_row, so its X product is skipped (the text side's dead tiles;
// P_col still needs every text column that g_ol reaches).  f32 SIMT math, no
// tensor cores: each pass computes 5 products, 10 in all where the TPU
// kernel computes 7.  Faster variants are later work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 32;          // query rows per block
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;          // key tile = one key per lane
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kKeys + 1; // transposed key tile row stride

template <int D>
constexpr size_t smem_bytes() {
  // rows: sA, sAval, sAg [kRows][D]; keys transposed: sB, sBval, sBg [D][kStride]
  return sizeof(float) * (3 * (size_t)kRows * D + 3 * (size_t)D * kStride);
}

struct Operands {
  const float* a;       // (B, Nr, E)
  const float* a_val;
  const float* a_g;
  const float* b;       // (B, Nk, E)
  const float* b_val;
  const float* b_g;
  const float* lse_row; // (B, H, Nr)
  const float* t_row;
  const uint8_t* pad_row;  // (B, Nr), 1 = padded
  const float* lse_key;    // (B, H, Nk)
  const float* t_key;
  const uint8_t* pad_key;  // (B, Nk)
};

// One block: kRows query rows of head h, keys [k_begin, k_end) of split s.
// n_splits == 1: writes acc1 / acc2 to out1 / out2 (B, Nr, E).
// n_splits > 1: writes them to part1 / part2 (B, H, n_splits, Nr, D).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(Operands op, int Nr, int Nk, int E, int H, int n_splits, int chunk,
           float* __restrict__ out1, float* __restrict__ out2,
           float* __restrict__ part1, float* __restrict__ part2) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* sA = smem;                          // [kRows][D]
  float* sAval = sA + kRows * D;
  float* sAg = sAval + kRows * D;
  float* sB = sAg + kRows * D;               // [D][kStride]
  float* sBval = sB + D * kStride;
  float* sBg = sBval + D * kStride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y % H;
  const int split = blockIdx.y / H;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(Nk, k_begin + chunk);

  const long long row_base = (long long)b * Nr * E + h * D;
  const long long key_base = (long long)b * Nk * E + h * D;
  const long long hstat = ((long long)b * H + h);

  // row operands -> shared (zeros past Nr)
  const float* srcs[3] = {op.a, op.a_val, op.a_g};
  float* dsts[3] = {sA, sAval, sAg};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    for (int i = tid; i < kRows * D / 4; i += kThreads) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < Nr) v = reinterpret_cast<const float4*>(srcs[t] + row_base + (long long)(r0 + r) * E)[c4];
      reinterpret_cast<float4*>(dsts[t] + r * D)[c4] = v;
    }
  }

  // this warp's rows: statistics (uniform across lanes)
  float lse_r[kRowsPerWarp], t_r[kRowsPerWarp];
  bool live_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    const bool in = r < Nr;
    lse_r[i] = in ? op.lse_row[hstat * Nr + r] : 0.f;
    t_r[i] = in ? op.t_row[hstat * Nr + r] : 0.f;
    live_r[i] = in && op.pad_row[(long long)b * Nr + r] == 0;
  }

  float acc1[kRowsPerWarp][DJ], acc2[kRowsPerWarp][DJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  }

  const float* key_srcs[3] = {op.b, op.b_val, op.b_g};
  float* key_dsts[3] = {sB, sBval, sBg};
  for (int c0 = k_begin; c0 < k_end; c0 += kKeys) {
    // barrier (previous tile consumed, rows written) and vote: does any key
    // of this tile take part in the row softmax?
    const int kk = c0 + tid;
    const bool any_live = __syncthreads_or(tid < kKeys && kk < k_end &&
                                           op.pad_key[(long long)b * Nk + kk] == 0);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t == 1 && !any_live) continue;   // b_val only feeds X
      for (int i = tid; i < kKeys * D; i += kThreads) {
        const int c = i / D, k = i % D;
        key_dsts[t][k * kStride + c] =
            c0 + c < k_end ? key_srcs[t][key_base + (long long)(c0 + c) * E + k] : 0.f;
      }
    }
    __syncthreads();

    // S, X, Y: this warp's rows x key column `lane`
    float s[kRowsPerWarp], x[kRowsPerWarp], y[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = x[i] = y[i] = 0.f;
    const float* aw = sA + warp * kRowsPerWarp * D;
    const float* avw = sAval + warp * kRowsPerWarp * D;
    const float* agw = sAg + warp * kRowsPerWarp * D;
    for (int k = 0; k < D; k += 4) {
      float kb[4], kg[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kb[u] = sB[(k + u) * kStride + lane];
        kg[u] = sBg[(k + u) * kStride + lane];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(aw + i * D + k);
        const float4 qv = *reinterpret_cast<const float4*>(avw + i * D + k);
        s[i] = fmaf(qa.x, kb[0], fmaf(qa.y, kb[1], fmaf(qa.z, kb[2], fmaf(qa.w, kb[3], s[i]))));
        y[i] = fmaf(qv.x, kg[0], fmaf(qv.y, kg[1], fmaf(qv.z, kg[2], fmaf(qv.w, kg[3], y[i]))));
      }
      if (any_live) {
        float kv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) kv[u] = sBval[(k + u) * kStride + lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 qg = *reinterpret_cast<const float4*>(agw + i * D + k);
          x[i] = fmaf(qg.x, kv[0], fmaf(qg.y, kv[1], fmaf(qg.z, kv[2], fmaf(qg.w, kv[3], x[i]))));
        }
      }
    }

    // dL and P_col for (row i, key lane)
    const int key = c0 + lane;
    const bool key_in = key < k_end;
    const bool key_live = key_in && op.pad_key[(long long)b * Nk + key] == 0;
    const float lse_k = key_in ? op.lse_key[hstat * Nk + key] : 0.f;
    const float t_k = key_in ? op.t_key[hstat * Nk + key] : 0.f;
    float dl[kRowsPerWarp], pc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float p_row = key_live ? expf(s[i] - lse_r[i]) : 0.f;
      // a padded row's logit may exceed the live rows' lse: select, never multiply
      const float p_col = (key_in && live_r[i]) ? expf(s[i] - lse_k) : 0.f;
      dl[i] = p_row * (x[i] - t_r[i]) + p_col * (y[i] - t_k);
      pc[i] = p_col;
    }

    // acc1 += dL . b_tile, acc2 += P_col . b_g_tile; lane owns channels lane + 32*j
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float vb[DJ], vg[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        vb[j] = sB[(lane + 32 * j) * kStride + c];
        vg[j] = sBg[(lane + 32 * j) * kStride + c];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float d_c = __shfl_sync(0xffffffffu, dl[i], c);
        const float p_c = __shfl_sync(0xffffffffu, pc[i], c);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc1[i][j] = fmaf(d_c, vb[j], acc1[i][j]);
          acc2[i][j] = fmaf(p_c, vg[j], acc2[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    if (r >= Nr) continue;
    float* o1;
    float* o2;
    if (n_splits == 1) {
      o1 = out1 + ((long long)b * Nr + r) * E + h * D;
      o2 = out2 + ((long long)b * Nr + r) * E + h * D;
    } else {
      const long long idx = ((hstat * n_splits + split) * Nr + r) * D;
      o1 = part1 + idx;
      o2 = part2 + idx;
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      o1[lane + 32 * j] = acc1[i][j];
      o2[lane + 32 * j] = acc2[i][j];
    }
  }
}

// out[b, r, h*D + d] = sum over s, in order, of part[b, h, s, r, d], for both
// partial buffers
__global__ void sum_splits_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                                  float* __restrict__ out1, float* __restrict__ out2,
                                  int Nr, int E, int H, int D, int n_splits) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long base = (((long long)b * H + h) * n_splits * Nr + r) * D;
  const long long step = (long long)Nr * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      s1 += part1[base + s * step + d];
      s2 += part2[base + s * step + d];
    }
    const long long o = ((long long)b * Nr + r) * E + h * D + d;
    out1[o] = s1;
    out2[o] = s2;
  }
}

template <int D>
cudaError_t run_side(const Operands& op, int B, int Nr, int Nk, int E, int H, int n_splits,
                     float* out1, float* out2, float* part1, float* part2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int chunk = (Nk + n_splits - 1) / n_splits;
  chunk = (chunk + kKeys - 1) / kKeys * kKeys;   // whole key tiles per split
  dim3 grid((Nr + kRows - 1) / kRows, H * n_splits, B);
  bwd_kernel<D><<<grid, kThreads, smem, stream>>>(op, Nr, Nk, E, H, n_splits, chunk,
                                                  out1, out2, part1, part2);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  sum_splits_kernel<<<dim3(Nr, H, B), D < 256 ? D : 256, 0, stream>>>(
      part1, part2, out1, out2, Nr, E, H, D, n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All float tensors f32 contiguous.  Inputs: q, val_v, g_ov (B, Nv, E);
// k, val_l, g_ol (B, Nl, E); pad_v (B, Nv), pad_l (B, Nl) uint8, 1 = padded;
// K2's statistics lse_v (B, H, Nv), lse_l (B, H, Nl); rv (B, H, Nv) and
// cl (B, H, Nl).  Outputs gq, gvv (B, Nv, E); gk, gvl (B, Nl, E).
// Scratch: part_k, part_vl (B, H, n_splits, Nl, D).  n_splits >= 2.  Head dim
// E / H must be 256 (fusion E = 1024, H = 4).  Returns a cudaError_t.
int fusion_bwd_f32(const void* q, const void* k, const void* val_v, const void* val_l,
                   const void* pad_v, const void* pad_l, const void* lse_v, const void* lse_l,
                   const void* rv, const void* cl, const void* g_ov, const void* g_ol,
                   void* gq, void* gk, void* gvv, void* gvl, void* part_k, void* part_vl,
                   int B, int Nv, int Nl, int E, int H, int n_splits, void* stream) {
  if (H * 256 != E || n_splits < 2) return (int)cudaErrorInvalidValue;
  const float* f[12] = {(const float*)q, (const float*)k, (const float*)val_v, (const float*)val_l,
                        nullptr, nullptr, (const float*)lse_v, (const float*)lse_l,
                        (const float*)rv, (const float*)cl, (const float*)g_ov, (const float*)g_ol};
  const uint8_t* pv = (const uint8_t*)pad_v;
  const uint8_t* pl = (const uint8_t*)pad_l;
  // image rows over text keys -> gq, gvv
  const Operands image_side = {f[0], f[2], f[10], f[1], f[3], f[11],
                               f[6], f[8], pv, f[7], f[9], pl};
  cudaError_t err = run_side<256>(image_side, B, Nv, Nl, E, H, 1, (float*)gq, (float*)gvv,
                                  nullptr, nullptr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // text rows over image keys, image axis in n_splits chunks -> gk, gvl
  const Operands text_side = {f[1], f[3], f[11], f[0], f[2], f[10],
                              f[7], f[9], pl, f[6], f[8], pv};
  err = run_side<256>(text_side, B, Nl, Nv, E, H, n_splits, (float*)gk, (float*)gvl,
                      (float*)part_k, (float*)part_vl, (cudaStream_t)stream);
  return (int)err;
}

}  // extern "C"
