// K6: multi-scale deformable attention forward on row taps, for Hopper
// (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_rowtap_kernel
// (with its _msda_rowtap_nblk_kernel, several query blocks a sweep), the
// forward of the MSDA_BANDED=0 path, launched by
// _msda_pallas_fwd_rowtap_call.  On the row taps
// ops/msda_sweep.py::rowtap_positions_and_weights makes, it computes
//   out[bh, q, :] = sum_r w[r, q] * sum_x relu(1 - |px[r, q] - x|) * V[bh, row[r, q] + x, :]
//   value  (B, L, H, 32) f32, the reference layout
//   row    (B*H, NL*2*P, Qp) int32, the flat position of the tap's row;
//   px, w  (B*H, NL*2*P, Qp) f32: px edge-collapsed and clipped into
//          [0, W_l - 1], w == 0 marks a dead tap (off the map, a padded query);
//          level l's taps are l*2P + p (row y0 of point p) and l*2P + P + p
//          (row y0 + 1)
//   out    (B*H, Qp, 32) f32
// A tap touches at most two positions: i0 = row + floor(px), weight
// r0 = 1 - (px - floor(px)), and i0 + 1, weight r1 = 1 - ((floor(px) + 1) - px),
// as the dense relu gives them.  r1 is exactly 0 where px is an integer (the
// last column, an edge point), and there i0 + 1 may lie in the next row or
// past L - 1: a corner of zero weight is dropped before it is loaded.  The
// positions arrive from the expansion in PyTorch: no product precedes
// floor() here, and r0, r1 have none to contract.
//
// What bounds it: gather traffic, as for K1 (same function, same compulsory
// bytes; the smoke reports K1's bound).  Each live tap reads up to two
// 128-B rows at data-dependent places, almost all re-reads from L1 and L2.
//
// The TPU kernel sweeps, for each 128-query block, the tiles of positions
// its taps touch and builds a dense (positions x queries) weight matrix S
// for the MXU: on this card that product does T * 128 * 32 FMAs a (block,
// tile) for at most 8 non-zeros a query a level.  Here each live tap is two
// gathered rows (K5's design, msda_common.cuh):
//   - a CTA takes one b*h and a tile of consecutive queries (ops/msda.py
//     msda_fwd_tile, as for K1 and K5).  Its threads first stage the tile's
//     (point, query) pairs, one pair a thread, reading row, px and w of the
//     point's two taps coalesced along q, and put the point's four corners
//     (i0 and i0 + 1 of each tap, weights r0 * w and r1 * w) into shared
//     memory, -1 for a corner with zero weight: dead taps, padded queries
//     and integer px cost no loads;
//   - gather_staged_corners then takes two queries a warp at a time, 4 lane
//     groups of 8 lanes on point g of each level, a float4 a lane, the
//     groups' sums meeting in shuffles.
// ptxas -v (-O3, sm_90a, CUDA 12.8): 48 registers, no spills; dynamic shared
// memory 8,704 B at 16 queries a CTA, 33,280 B at 64.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// 5 CTAs an SM: without the bound ptxas took 44 registers and the kernel
// ran ~3% slower (PERF.md)
__global__ void __launch_bounds__(kThreads, 5)
rowtap_fwd_kernel(const float* __restrict__ value, const int* __restrict__ row,
                  const float* __restrict__ px, const float* __restrict__ w,
                  float* __restrict__ out, int L, int H, int Qp, int NL, int tile_q,
                  int n_tiles) {
  // dynamic shared memory: the corners of every (point, query) of the tile,
  // positions then weights, a row of tile_q + 1 per point (the pad puts the
  // four groups' points on different banks)
  extern __shared__ int4 smem[];
  const int stride = tile_q + 1;
  const int nlp = NL * kP;
  const int R = 2 * nlp;
  int4* cpos = smem;
  float4* cw = reinterpret_cast<float4*>(smem + nlp * stride);

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H, b = bh / H;
  const int q0 = tile * tile_q;
  const int nq = min(tile_q, Qp - q0);

  for (int i = threadIdx.x; i < nlp * tile_q; i += kThreads) {
    const int t = i / tile_q, qq = i % tile_q;
    const int l = t / kP, p = t % kP;
    int pc[4] = {-1, -1, -1, -1};
    float wc[4] = {0.f, 0.f, 0.f, 0.f};
    if (qq < nq) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {   // the point's y0 and y0 + 1 taps
        const size_t o = ((size_t)bh * R + l * 2 * kP + k * kP + p) * Qp + q0 + qq;
        const float a = __ldg(w + o);
        if (a == 0.f) continue;
        const float x = __ldg(px + o);
        const float xf = floorf(x);
        const int i0 = __ldg(row + o) + (int)xf;
        const float w0 = (1.f - (x - xf)) * a;
        const float w1 = (1.f - ((xf + 1.f) - x)) * a;
        pc[2 * k] = w0 != 0.f ? i0 : -1;
        pc[2 * k + 1] = w1 != 0.f ? i0 + 1 : -1;
        wc[2 * k] = w0;
        wc[2 * k + 1] = w1;
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

}  // namespace

extern "C" {

// Dynamic shared memory of msda_rowtap_fwd_f32 at tile_q queries a CTA.
int msda_rowtap_fwd_smem_bytes(int NL, int tile_q) {
  return NL * kP * (tile_q + 1) * (int)(sizeof(int4) + sizeof(float4));
}

// value, px, w, out f32, row int32, all contiguous; value and out 16-byte
// aligned.  Built for D = 32 and P = 4 (msda_common.cuh): 2 * P row taps a
// level; tile_q queries a CTA (ops/msda.py msda_fwd_tile).  Returns a
// cudaError_t (0 = launched).
int msda_rowtap_fwd_f32(const void* value, const void* row, const void* px, const void* w,
                        void* out, int B, int L, int H, int Qp, int NL, int P, int tile_q,
                        void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || NL <= 0 || NL > kMaxLevels || P != kP ||
      tile_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = msda_rowtap_fwd_smem_bytes(NL, tile_q);
  cudaError_t err = cudaFuncSetAttribute(rowtap_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Qp + tile_q - 1) / tile_q;
  rowtap_fwd_kernel<<<(unsigned)((long long)B * H * n_tiles), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)value, (const int*)row, (const float*)px, (const float*)w, (float*)out, L, H,
      Qp, NL, tile_q, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
