// K8: multi-scale deformable attention forward on corner taps, for Hopper
// (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_kernel (the
// corner-tap sweep under MSDA_FWD_VARIANT=corner, reached through the
// op-level ms_deform_attn_pallas), launched by _msda_pallas_fwd_call.  No
// model path runs it, in the JAX package or here: the op-level
// ms_deform_attn_sweep(fwd="corner") and the MSDA microbench do.  On the
// corner taps ops/msda_sweep.py::corner_indices_and_weights makes, it
// computes
//   out[bh, q, :] = sum_t w[t, q] * V[bh, idx[t, q], :]
//   value  (B, L, H, 32) f32, the reference layout
//   idx    (B*H, NL*P*4, Qp) int32, the flat position of each corner;
//   w      (B*H, NL*P*4, Qp) f32, its bilinear weight times the attention
//          weight; w == 0 marks a dead tap (off the map, a padded query),
//          whose idx is clamped into its level; point p of level l has its
//          four corners at taps l*4P + 4p + c, c = x0y0, x1y0, x0y1, x1y1
//   out    (B*H, Qp, 32) f32
// or, in the bf16 entry (msda_sweep_fwd_corner_bf16; the TPU kernel's bf16
// branch, msda_pallas.py:244-246, its output in the value's dtype, :299),
// value and out bf16: a value row is 64 B, 8 B a lane (msda_common.cuh
// load4), idx stays int32, w and every sum f32, and each output is rounded
// to bf16 once (store4).  The TPU kernel rounds its weight matrix S to bf16
// for the MXU (:246); the port keeps the weights f32, as K1's, K5's, K6's
// and K7's bf16 entries do, so the bf16 entry computes the f32 function of
// the bf16 value rows, rounded once.
// For Q != L the queries arrive sorted by their first corner tap's position
// (ops/msda_sweep.py query_order), as msda_pallas.py sorts them.
//
// What bounds it: gather traffic, as for K1 (same function, same compulsory
// bytes; the smoke reports K1's bound).  Each live tap reads one 128-B row
// at a data-dependent place, almost all re-reads from L1 and L2.
//
// The TPU kernel sweeps, for each 128-query block, the tiles of positions
// its taps touch and builds a dense (positions x queries) weight matrix S
// for the MXU: on this card that product does T * 128 * 32 FMAs a (block,
// tile) for at most 16 non-zeros a query a level.  The corner taps are
// already what msda_common.cuh's gather_staged_corners consumes, four
// positions and four weights a (point, query), so K8 is K5's design with
// no arithmetic in its staging:
//   - a CTA takes one b*h and a tile of consecutive queries (ops/msda.py
//     msda_fwd_tile, as for K1, K5 and K6).  Its threads first stage the
//     tile's (point, query) pairs, one pair a thread, reading the point's
//     four idx and w coalesced along q into shared memory, position -1 for
//     a corner of zero weight: dead taps and padded queries cost no loads;
//   - gather_staged_corners then takes two queries a warp at a time, 4 lane
//     groups of 8 lanes on point g of each level, a float4 a lane, the
//     groups' sums meeting in shuffles.
// ptxas -v (-O3, sm_90a, CUDA 12.8): 48 registers for either value type, no
// spills; dynamic shared memory 8,704 B at 16 queries a CTA, 33,280 B at 64.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// 5 CTAs an SM, as K5 and K6.  T: the value's and the output's type.
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
corner_fwd_kernel(const T* __restrict__ value, const int* __restrict__ idx,
                  const float* __restrict__ w, T* __restrict__ out, int L, int H, int Qp,
                  int NL, int tile_q, int n_tiles) {
  // dynamic shared memory: the corners of every (point, query) of the tile,
  // positions then weights, a row of tile_q + 1 per point (the pad puts the
  // four groups' points on different banks)
  extern __shared__ int4 smem[];
  const int stride = tile_q + 1;
  const int nlp = NL * kP;
  int4* cpos = smem;
  float4* cw = reinterpret_cast<float4*>(smem + nlp * stride);

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int q0 = tile * tile_q;
  const int nq = min(tile_q, Qp - q0);

  for (int i = threadIdx.x; i < nlp * tile_q; i += kThreads) {
    const int t = i / tile_q, qq = i % tile_q;
    int pc[4] = {-1, -1, -1, -1};
    float wc[4] = {0.f, 0.f, 0.f, 0.f};
    if (qq < nq) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {   // the point's four corners, taps 4t .. 4t + 3
        const size_t o = ((size_t)bh * 4 * nlp + 4 * t + c) * Qp + q0 + qq;
        const float a = __ldg(w + o);
        if (a == 0.f) continue;
        pc[c] = __ldg(idx + o);
        wc[c] = a;
      }
    }
    cpos[t * stride + qq] = make_int4(pc[0], pc[1], pc[2], pc[3]);
    cw[t * stride + qq] = make_float4(wc[0], wc[1], wc[2], wc[3]);
  }
  __syncthreads();

  gather_staged_corners<kWarps>(cpos, cw, stride, nq, NL,
                                value + ((long long)b * L * H + h) * kD, (long long)H * kD,
                                out + ((long long)bh * Qp + q0) * kD);
}

int smem_bytes(int NL, int tile_q) {
  return NL * kP * (tile_q + 1) * (int)(sizeof(int4) + sizeof(float4));
}

template <typename T>
int launch(const void* value, const void* idx, const void* w, void* out, int B, int L, int H,
           int Qp, int NL, int P, int tile_q, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || NL <= 0 || NL > kMaxLevels || P != kP ||
      tile_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(NL, tile_q);
  cudaError_t err = cudaFuncSetAttribute(corner_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Qp + tile_q - 1) / tile_q;
  corner_fwd_kernel<T><<<(unsigned)((long long)B * H * n_tiles), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const T*)value, (const int*)idx, (const float*)w, (T*)out, L, H, Qp, NL, tile_q, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of msda_sweep_fwd_corner_f32 and _bf16 at tile_q
// queries a CTA.
int msda_corner_fwd_smem_bytes(int NL, int tile_q) { return smem_bytes(NL, tile_q); }

// value, w, out f32, idx int32, all contiguous; value and out 16-byte
// aligned.  Built for D = 32 and P = 4 (msda_common.cuh): 4 * P corner taps
// a level; tile_q queries a CTA (ops/msda.py msda_fwd_tile).  Returns a
// cudaError_t (0 = launched).
int msda_sweep_fwd_corner_f32(const void* value, const void* idx, const void* w, void* out,
                              int B, int L, int H, int Qp, int NL, int P, int tile_q,
                              void* stream) {
  return launch<float>(value, idx, w, out, B, L, H, Qp, NL, P, tile_q, stream);
}

// The bf16 entry: value and out bf16, idx int32 and w f32 as above; f32
// weights and sums, each output rounded to bf16 once.
int msda_sweep_fwd_corner_bf16(const void* value, const void* idx, const void* w, void* out,
                               int B, int L, int H, int Qp, int NL, int P, int tile_q,
                               void* stream) {
  return launch<__nv_bfloat16>(value, idx, w, out, B, L, H, Qp, NL, P, tile_q, stream);
}

}  // extern "C"
