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
// The function is symmetric: with image rows as queries over text keys one
// pass yields gq and gvv, and with text rows as queries over image keys the
// same pass yields gk and gvl:
//   rows (a, a_val, a_g), keys (b, b_val, b_g), S = a.b, X = a_g.b_val,
//   Y = a_val.b_g, P_row = exp(S - lse_row) on live keys,
//   P_col = exp(S - lse_key) on live rows,
//   dL = P_row (X - t_row) + P_col (Y - t_key),
//   acc1 += dL . b,   acc2 += P_col . b_g
// (image side: a = q, b = k, acc1 = gq, acc2 = gvv; text side: a = k, b = q,
// acc1 = gk, acc2 = gvl).  Every product has the form rows x keys x D.
//
// What bounds it: operations.  At the flagship bucket (Nv ~ 20k, Nl = 256,
// E = 1024, H = 4, D = 256, B = 4) each pass computes five products of
// ~21 GFLOP, against a few hundred MB of compulsory traffic.  The f32 SIMT
// design this replaced ran ten products at ~10% of the SIMT peak: one scalar
// shared-memory load per FMA set its pace, and its 195 KB of shared memory
// allowed one block of 8 warps an SM with no copy overlapping compute.  On
// the tensor cores the limit is the instruction stream around the MMAs: the
// split of every fragment element into its two tf32 parts, most of all.
//
// What the design does about it.  Every product runs on the tensor cores
// (mma.sync m16n8k8 tf32) in 3xTF32 (tf32x3.cuh), which keeps the error near
// f32's (the smoke holds each gradient to 1e-4 of its largest |reference|).
// A block holds 32 query rows (two 16-row slabs) of its three row operands
// and stages key tiles of 16 keys x three operands, with the keys' lse and t,
// by cp.async into two shared-memory stages, so the next tile loads while
// this one computes (one block barrier a tile).  Four warps share a slab,
// each owning a 64-lane channel slice: a warp takes S, X and Y over its slice
// of the reduction lanes (six products in two accumulator chains each), the
// four partials meet in shared memory, each warp of the slab sums a quarter
// of them in a fixed order and forms P_row, P_col and dL there, and every
// warp then reads all of dL and P_col and accumulates its channel slice of
// acc1 and acc2 (64 f32 registers a thread; 211 in all, no spills), P and dL
// feeding the products in accumulator-fragment order (the key tile read in
// the matching permuted key order).  Fragments come in by ldmatrix (rows,
// keys) and scalar loads at per-thread offsets computed once.  On the TPU,
// gk and gvl accumulate across the sequential image-block axis; GPU blocks
// run in no order, so the text side splits the image axis in S chunks, each
// writing a partial, and a third kernel sums the partials in a fixed order:
// the result is deterministic, with no atomics.  A key tile with no live
// key contributes nothing to P_row, so neither b_val is loaded nor X
// computed for it (the image side's dead text tiles; P_col still needs every
// key that g_ol or g_ov reaches).  Rows and keys past the ragged end are
// zero-filled on load, masked and never written.
#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int D = kD;
constexpr int kRows = 32;                  // query rows per block: two 16-row slabs
constexpr int kSlices = 4;                 // warps per slab, one channel slice each
constexpr int kWarps = 2 * kSlices;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 16;                  // key tile
constexpr int kSliceD = D / kSlices;       // 64 lanes of a warp's slice
constexpr int kSliceNT = kSliceD / 8;      // its 8-lane output tiles
constexpr int kTile = kKeys * D;           // floats of one staged key operand
// rows: a, a_val, a_g; keys: 2 stages x (b, b_val, b_g) and the keys'
// (lse_key, t_key); partials of S, X, Y: one [3][2][4][32] block per warp;
// dL and P_col of each slab; then the key-padding flags of the block's key
// range and a live flag per key tile (chunk and chunk / kKeys bytes, see
// `smem_bytes`)
constexpr int kRed = 3 * 2 * 4 * 32;
constexpr size_t kSmemTiles = sizeof(float) * (3 * (size_t)kRows * D + 2 * 3 * (size_t)kTile +
                                               2 * 2 * kKeys + (size_t)kWarps * kRed +
                                               2 * 2 * kRed / 3);

size_t smem_bytes(int chunk) { return kSmemTiles + round16(chunk) + round16(chunk / kKeys); }

// keys per split: whole key tiles, so a split never starts mid-tile
int split_chunk(int Nk, int n_splits) {
  const int chunk = (Nk + n_splits - 1) / n_splits;
  return (chunk + kKeys - 1) / kKeys * kKeys;
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
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(Operands op, int Nr, int Nk, int E, int H, int n_splits, int chunk,
           float* __restrict__ out1, float* __restrict__ out2,
           float* __restrict__ part1, float* __restrict__ part2) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // [kRows][D] each
  float* sAval = sA + kRows * D;
  float* sAg = sAval + kRows * D;
  float* sKeys = sAg + kRows * D;                // [2 stages][b, b_val, b_g][kKeys][D]
  float* sStat = sKeys + 2 * 3 * kTile;          // [2 stages][lse_key, t_key][kKeys]
  float* sRed = sStat + 2 * 2 * kKeys;           // [kWarps][3][2][4][32]
  float* sDl = sRed + kWarps * kRed;             // [2 slabs][dL, P_col][2][4][32]
  uint8_t* sPad = reinterpret_cast<uint8_t*>(sDl + 2 * 2 * kRed / 3);   // [chunk]
  uint8_t* sLive = sPad + round16(chunk);                             // [chunk / kKeys]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp / kSlices, slice = warp % kSlices;
  const int m0 = 16 * slab, d0 = kSliceD * slice;
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y % H;
  const int split = blockIdx.y / H;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(Nk, k_begin + chunk);

  const long long row_base = (long long)b * Nr * E + h * D;
  const long long key_base = (long long)b * Nk * E + h * D;
  const long long hstat = ((long long)b * H + h);
  const uint8_t* pad_k = op.pad_key + (long long)b * Nk;

  load_tile<kRows, kThreads>(sA, op.a + row_base, E, r0, Nr, tid);
  load_tile<kRows, kThreads>(sAval, op.a_val + row_base, E, r0, Nr, tid);
  load_tile<kRows, kThreads>(sAg, op.a_g + row_base, E, r0, Nr, tid);
  stage_pads(sPad, sLive, pad_k, k_begin, k_end, chunk, kKeys, tid, kThreads);
  // key tile c0 into stage st; b_val only where some key is live (it feeds X)
  auto load_keys = [&](int st, int c0, bool live) {
    float* s = sKeys + st * 3 * kTile;
    load_tile<kKeys, kThreads>(s, op.b + key_base, E, c0, k_end, tid);
    if (live) load_tile<kKeys, kThreads>(s + kTile, op.b_val + key_base, E, c0, k_end, tid);
    load_tile<kKeys, kThreads>(s + 2 * kTile, op.b_g + key_base, E, c0, k_end, tid);
    if (tid < 2 * kKeys) {
      const int key = c0 + tid % kKeys;
      const float* stat = tid < kKeys ? op.lse_key : op.t_key;
      cp_async4(sStat + st * 2 * kKeys + tid, stat + hstat * Nk + min(key, Nk - 1), key < k_end);
    }
  };
  auto tile_live = [&](int c0) { return sLive[(c0 - k_begin) / kKeys] != 0; };
  bool live = k_begin < k_end && tile_live(k_begin);
  if (k_begin < k_end) load_keys(0, k_begin, live);
  cp_async_commit();

  // this thread's rows m0 + g (i = 0) and m0 + g + 8 (i = 1): statistics
  float lse_r[2], t_r[2];
  bool in_r[2], live_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + m0 + g + 8 * i;
    in_r[i] = r < Nr;
    lse_r[i] = in_r[i] ? op.lse_row[hstat * Nr + r] : 0.f;
    t_r[i] = in_r[i] ? op.t_row[hstat * Nr + r] : 0.f;
    live_r[i] = in_r[i] && op.pad_row[(long long)b * Nr + r] == 0;
  }

  float acc1[kSliceNT][4], acc2[kSliceNT][4];
#pragma unroll
  for (int n = 0; n < kSliceNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = acc2[n][e] = 0.f;
  }
  // fragment offsets within the tiles, the same for every key tile
  const StepOffsets ro = a_offsets(m0, d0, lane), ko = key2_offsets(d0, lane);
  const ValOffsets vo = val_offsets(d0 / 8, g, t);
  const uint32_t sAa = smem_addr(sA), sAvala = smem_addr(sAval), sAga = smem_addr(sAg);

  int stage = 0;
  for (int c0 = k_begin; c0 < k_end; c0 += kKeys) {
    cp_async_wait<0>();   // this stage (and the row tiles) have landed
    // every warp is past the previous tile: its stage and the partials are free
    __syncthreads();
    const int c1 = c0 + kKeys;
    const bool live1 = c1 < k_end && tile_live(c1);
    if (c1 < k_end) load_keys(stage ^ 1, c1, live1);   // loads while this tile computes
    cp_async_commit();
    const float* Kb = sKeys + stage * 3 * kTile;
    const float* Kv = Kb + kTile;
    const float* Kg = Kv + kTile;
    const float* stat = sStat + stage * 2 * kKeys;

    // partial S, X, Y of this warp's slab over its slice of the reduction
    // lanes, each in two accumulator chains (big and small terms)
    float ps[2][2][4], px[2][2][4], py[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[u][j][e] = px[u][j][e] = py[u][j][e] = 0.f;
      }
    }
    const uint32_t Kba = smem_addr(Kb), Kva = smem_addr(Kv), Kga = smem_addr(Kg);
#pragma unroll
    for (int it = 0; it < kSliceD / 32; ++it) {   // reduction steps 4 it + q of the slice
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const FragA fa = load_a(sAa, ro, q, it);
        const FragA fv = load_a(sAvala, ro, q, it);
        FragB bb[2], bg[2];
        load_b_key2(bb, Kba, ko, q, it);
        load_b_key2(bg, Kga, ko, q, it);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma3(ps[0][j], ps[1][j], fa, bb[j]);
          mma3(py[0][j], py[1][j], fv, bg[j]);
        }
        if (live) {
          const FragA fg = load_a(sAga, ro, q, it);
          FragB bv[2];
          load_b_key2(bv, Kva, ko, q, it);
#pragma unroll
          for (int j = 0; j < 2; ++j) mma3(px[0][j], px[1][j], fg, bv[j]);
        }
      }
    }
    float* red = sRed + warp * kRed;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[((0 * 2 + j) * 4 + e) * 32 + lane] = ps[0][j][e] + ps[1][j][e];
        red[((1 * 2 + j) * 4 + e) * 32 + lane] = px[0][j][e] + px[1][j][e];
        red[((2 * 2 + j) * 4 + e) * 32 + lane] = py[0][j][e] + py[1][j][e];
      }
    }
    // the slab's four warps meet (named barrier 1 + slab)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slab), "n"(kSlices * 32));
    // Warp `slice` of the slab sums, in warp order, the partials of n-tile
    // j = slice >> 1 and row half i = slice & 1 (elements e = 2i, 2i + 1: row
    // m0 + g + 8i, key c0 + 8j + 2t + (e & 1)), forms P_col and dL there and
    // shares them; then every warp of the slab reads all of them.
    float* shared_dl = sDl + slab * 2 * kRed / 3;   // [dL, P_col][2][4][32]
    {
      const int j = slice >> 1, i = slice & 1;
      const float lse_ri = i ? lse_r[1] : lse_r[0], t_ri = i ? t_r[1] : t_r[0];
      const bool in_ri = i ? in_r[1] : in_r[0], live_ri = i ? live_r[1] : live_r[0];
      const float* red0 = sRed + slab * kSlices * kRed;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * i + u;
        float s = 0.f, x = 0.f, y = 0.f;
#pragma unroll
        for (int w = 0; w < kSlices; ++w) {
          s += red0[w * kRed + ((0 * 2 + j) * 4 + e) * 32 + lane];
          x += red0[w * kRed + ((1 * 2 + j) * 4 + e) * 32 + lane];
          y += red0[w * kRed + ((2 * 2 + j) * 4 + e) * 32 + lane];
        }
        const int kt = 8 * j + 2 * t + u;   // key c0 + kt
        const bool key_in = c0 + kt < k_end;
        const bool key_live = sPad[c0 - k_begin + kt] == 0;
        const float p_row = (key_live && in_ri) ? __expf(s - lse_ri) : 0.f;
        // a padded row's logit may exceed the live rows' lse: select, never multiply
        const float p_col = (key_in && live_ri) ? __expf(s - stat[kt]) : 0.f;
        shared_dl[((0 * 2 + j) * 4 + e) * 32 + lane] =
            p_row * (x - t_ri) + p_col * (y - stat[kKeys + kt]);
        shared_dl[((1 * 2 + j) * 4 + e) * 32 + lane] = p_col;
      }
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slab), "n"(kSlices * 32));
    float dl[2][4], pc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dl[j][e] = shared_dl[((0 * 2 + j) * 4 + e) * 32 + lane];
        pc[j][e] = shared_dl[((1 * 2 + j) * 4 + e) * 32 + lane];
      }
    }

    // acc1 += dL . b, acc2 += P_col . b_g over this warp's channel slice
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const FragA fd = a_from_acc(dl[j]);
      const FragA fp = a_from_acc(pc[j]);
#pragma unroll
      for (int n = 0; n < kSliceNT; ++n) {
        mma3(acc1[n], fd, load_b_val(Kb, vo, j, n));
        mma3(acc2[n], fp, load_b_val(Kg, vo, j, n));
      }
    }
    live = live1;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!in_r[i]) continue;
    const int r = r0 + m0 + g + 8 * i;
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
    for (int n = 0; n < kSliceNT; ++n) {
      const int col = d0 + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(o1 + col) = make_float2(acc1[n][2 * i], acc1[n][2 * i + 1]);
      *reinterpret_cast<float2*>(o2 + col) = make_float2(acc2[n][2 * i], acc2[n][2 * i + 1]);
    }
  }
}

// out[b, r, h*D + d] = sum over s, in order, of part[b, h, s, r, d], for both
// partial buffers
__global__ void sum_splits_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                                  float* __restrict__ out1, float* __restrict__ out2,
                                  int Nr, int E, int H, int n_splits) {
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

cudaError_t run_side(const Operands& op, int B, int Nr, int Nk, int E, int H, int n_splits,
                     float* out1, float* out2, float* part1, float* part2, cudaStream_t stream) {
  const int chunk = split_chunk(Nk, n_splits);
  const size_t smem = smem_bytes(chunk);   // a chunk too long for shared memory fails here
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nr + kRows - 1) / kRows, H * n_splits, B);
  bwd_kernel<<<grid, kThreads, smem, stream>>>(op, Nr, Nk, E, H, n_splits, chunk,
                                                out1, out2, part1, part2);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  sum_splits_kernel<<<dim3(Nr, H, B), 256, 0, stream>>>(part1, part2, out1, out2, Nr, E, H,
                                                       n_splits);
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
  if (H * D != E || n_splits < 2) return (int)cudaErrorInvalidValue;
  const float* f[12] = {(const float*)q, (const float*)k, (const float*)val_v, (const float*)val_l,
                        nullptr, nullptr, (const float*)lse_v, (const float*)lse_l,
                        (const float*)rv, (const float*)cl, (const float*)g_ov, (const float*)g_ol};
  const uint8_t* pv = (const uint8_t*)pad_v;
  const uint8_t* pl = (const uint8_t*)pad_l;
  // image rows over text keys -> gq, gvv
  const Operands image_side = {f[0], f[2], f[10], f[1], f[3], f[11],
                               f[6], f[8], pv, f[7], f[9], pl};
  cudaError_t err = run_side(image_side, B, Nv, Nl, E, H, 1, (float*)gq, (float*)gvv,
                             nullptr, nullptr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // text rows over image keys, image axis in n_splits chunks -> gk, gvl
  const Operands text_side = {f[1], f[3], f[11], f[0], f[2], f[10],
                              f[7], f[9], pl, f[6], f[8], pv};
  err = run_side(text_side, B, Nl, Nv, E, H, n_splits, (float*)gk, (float*)gvl,
                 (float*)part_k, (float*)part_vl, (cudaStream_t)stream);
  return (int)err;
}


// Dynamic shared memory (bytes) of bwd_kernel for a pass over Nk keys in
// n_splits chunks (the image-row pass has Nk = Nl and one chunk).
int fusion_bwd_smem_bytes(int Nk, int n_splits) {
  return (int)smem_bytes(split_chunk(Nk, n_splits));
}

}  // extern "C"
