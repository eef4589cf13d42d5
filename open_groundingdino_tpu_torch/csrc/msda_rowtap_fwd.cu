// K6 and K7: multi-scale deformable attention forward on row taps, for
// Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_rowtap_kernel
// (with its _msda_rowtap_nblk_kernel, several query blocks a sweep), the
// forward of the MSDA_BANDED=0 path, launched by
// _msda_pallas_fwd_rowtap_call, as K6; and ::_msda_rowtap_allq_kernel (every
// query block of one (b, h) in one program, the decoder under
// MSDA_DEC_FUSED=1), launched by _msda_pallas_fwd_rowtap_allq_call, as K7.
// Both compute, on the row taps
// ops/msda_sweep.py::rowtap_positions_and_weights makes,
//   out[bh, q, :] = sum_r w[r, q] * sum_x relu(1 - |px[r, q] - x|) * V[bh, row[r, q] + x, :]
//   value  (B, L, H, 32) f32, the reference layout
//   row    (B*H, NL*2*P, Qp) int32, the flat position of the tap's row;
//   px, w  (B*H, NL*2*P, Qp) f32: px edge-collapsed and clipped into
//          [0, W_l - 1], w == 0 marks a dead tap (off the map, a padded query);
//          level l's taps are l*2P + p (row y0 of point p) and l*2P + P + p
//          (row y0 + 1)
//   out    (B*H, Qp, 32) f32
// or, in the bf16 entries (msda_rowtap_fwd_bf16, msda_sweep_fwd_allq_bf16;
// the TPU kernels' bf16 branch, msda_pallas.py:520, 538-544 and :651, 675),
// value and out bf16: a value row is 64 B, 8 B a lane (msda_common.cuh
// load4), the tap weights r0 * w, r1 * w and every sum stay f32, and each
// output is rounded to bf16 once (store4).  The TPU kernel rounds its
// combined weight matrix S to bf16 for the MXU product; the weights here
// stay f32, as K1's bf16 entry keeps them (msda_fwd.cu), so the bf16 entry
// computes the f32 function of the bf16 value rows, rounded once.
// K7 takes the decoder's query set, sorted by the first row tap's position
// (ops/msda_sweep.py query_order), so consecutive queries read neighbouring
// rows.  A tap touches at most two positions: i0 = row + floor(px), weight
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
// The TPU kernels sweep, for each 128-query block, the tiles of positions
// its taps touch and build a dense (positions x queries) weight matrix S
// for the MXU: on this card that product does T * 128 * 32 FMAs a (block,
// tile) for at most 8 non-zeros a query a level.  Here each live tap is two
// gathered rows (K5's design, msda_common.cuh):
//   - a tile is one b*h and consecutive queries (ops/msda.py msda_fwd_tile,
//     as for K1 and K5).  The CTA's threads first stage the tile's
//     (point, query) pairs, one pair a thread, reading row, px and w of the
//     point's two taps coalesced along q, and put the point's four corners
//     (i0 and i0 + 1 of each tap, weights r0 * w and r1 * w) into shared
//     memory, -1 for a corner with zero weight: dead taps, padded queries
//     and integer px cost no loads;
//   - gather_staged_corners then takes two queries a warp at a time, 4 lane
//     groups of 8 lanes on point g of each level, a float4 a lane, the
//     groups' sums meeting in shuffles.
// K7 is K6's kernel under its own name, for the decoder's sorted query set.
// The TPU's all-q program amortises per-grid-step cost over every query
// block of a (b, h); its Hopper counterpart, a persistent grid of at most
// the CTAs the card holds (5 an SM), each walking a run of consecutive
// sorted tiles so that its start-up is paid once and L1 still holds the
// rows the last tile read, lost to one CTA a tile (device time at the
// B = 4 decoder on an H100 SXM at 700 W: 0.0395 against 0.0359 ms; 0.0600
// and 0.1031 ms with 2 and 1 CTAs an SM; PERF.md): the sort is by one tap,
// so a tile's other taps spread, and the CTAs that replace a finished one
// keep the SMs fuller.  At B = 1 the decoder has 512 tiles, fewer than the
// card holds, and the two launches are one.
// ptxas -v (-O3, sm_90a, CUDA 12.8): K6 and K7 48 registers each (f32), 40
// (bf16), no spills; dynamic shared memory 8,704 B at 16 queries a CTA,
// 33,280 B at 64, for either value type.  The bf16 entries run ~1.2-1.3x
// the f32 ones (PERF.md): a bf16 row is one 8-B load a lane and four
// unpacking instructions where f32 is one 16-B load, and the gather is
// bound by the instructions its warps can start, not by bytes.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// One tile, queries q0 .. q0 + tile_q - 1 of b*h = bh: its corners staged
// into cpos / cw (a row of tile_q + 1 per point: the pad puts the four
// groups' points on different banks), then gathered into out.  T: the
// value's and the output's type.
template <typename T>
__device__ __forceinline__ void rowtap_tile(const T* __restrict__ value,
                                            const int* __restrict__ row,
                                            const float* __restrict__ px,
                                            const float* __restrict__ w,
                                            T* __restrict__ out, int L, int H, int Qp,
                                            int NL, int tile_q, int bh, int q0, int4* cpos,
                                            float4* cw) {
  const int stride = tile_q + 1;
  const int nlp = NL * kP;
  const int R = 2 * nlp;
  const int h = bh % H, b = bh / H;
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

// K6 and K7: one tile a CTA, tile blockIdx.x % n_tiles of b*h =
// blockIdx.x / n_tiles; two kernels of one body, so that a profile tells
// the sweep's K6 from the fused decoder's K7.
// 5 CTAs an SM: without the bound ptxas took 44 registers and the kernel
// ran ~3% slower (PERF.md)
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
rowtap_fwd_kernel(const T* __restrict__ value, const int* __restrict__ row,
                  const float* __restrict__ px, const float* __restrict__ w,
                  T* __restrict__ out, int L, int H, int Qp, int NL, int tile_q, int n_tiles) {
  extern __shared__ int4 smem[];   // the staged corners, positions then weights
  rowtap_tile(value, row, px, w, out, L, H, Qp, NL, tile_q, blockIdx.x / n_tiles,
              (blockIdx.x % n_tiles) * tile_q, smem,
              reinterpret_cast<float4*>(smem + NL * kP * (tile_q + 1)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
allq_fwd_kernel(const T* __restrict__ value, const int* __restrict__ row,
                const float* __restrict__ px, const float* __restrict__ w,
                T* __restrict__ out, int L, int H, int Qp, int NL, int tile_q, int n_tiles) {
  extern __shared__ int4 smem[];
  rowtap_tile(value, row, px, w, out, L, H, Qp, NL, tile_q, blockIdx.x / n_tiles,
              (blockIdx.x % n_tiles) * tile_q, smem,
              reinterpret_cast<float4*>(smem + NL * kP * (tile_q + 1)));
}

int smem_bytes(int NL, int tile_q) {
  return NL * kP * (tile_q + 1) * (int)(sizeof(int4) + sizeof(float4));
}

template <typename T>
int launch(decltype(&rowtap_fwd_kernel<T>) kernel, const void* value, const void* row,
           const void* px, const void* w, void* out, int B, int L, int H, int Qp, int NL, int P,
           int tile_q, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || NL <= 0 || NL > kMaxLevels || P != kP ||
      tile_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(NL, tile_q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Qp + tile_q - 1) / tile_q;
  kernel<<<(unsigned)((long long)B * H * n_tiles), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)value, (const int*)row, (const float*)px, (const float*)w, (T*)out, L, H, Qp, NL,
      tile_q, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the K6 and K7 entries at tile_q queries a CTA
// (either value type).
int msda_rowtap_fwd_smem_bytes(int NL, int tile_q) { return smem_bytes(NL, tile_q); }

// K6 (msda_rowtap_fwd_f32) and K7 (msda_sweep_fwd_allq_f32, the decoder's
// sorted query set under dec_fused).  value, px, w, out f32, row int32, all
// contiguous; value and out 16-byte aligned.  Built for D = 32 and P = 4
// (msda_common.cuh): 2 * P row taps a level; tile_q queries a CTA
// (ops/msda.py msda_fwd_tile).  Return a cudaError_t (0 = launched).
int msda_rowtap_fwd_f32(const void* value, const void* row, const void* px, const void* w,
                        void* out, int B, int L, int H, int Qp, int NL, int P, int tile_q,
                        void* stream) {
  return launch<float>(rowtap_fwd_kernel<float>, value, row, px, w, out, B, L, H, Qp, NL, P,
                       tile_q, stream);
}

int msda_sweep_fwd_allq_f32(const void* value, const void* row, const void* px, const void* w,
                            void* out, int B, int L, int H, int Qp, int NL, int P, int tile_q,
                            void* stream) {
  return launch<float>(allq_fwd_kernel<float>, value, row, px, w, out, B, L, H, Qp, NL, P,
                       tile_q, stream);
}

// The bf16 entries of K6 and K7: value and out bf16, row, px, w as above;
// f32 weights and sums, each output rounded to bf16 once.
int msda_rowtap_fwd_bf16(const void* value, const void* row, const void* px, const void* w,
                         void* out, int B, int L, int H, int Qp, int NL, int P, int tile_q,
                         void* stream) {
  return launch<__nv_bfloat16>(rowtap_fwd_kernel<__nv_bfloat16>, value, row, px, w, out, B, L,
                               H, Qp, NL, P, tile_q, stream);
}

int msda_sweep_fwd_allq_bf16(const void* value, const void* row, const void* px, const void* w,
                             void* out, int B, int L, int H, int Qp, int NL, int P, int tile_q,
                             void* stream) {
  return launch<__nv_bfloat16>(allq_fwd_kernel<__nv_bfloat16>, value, row, px, w, out, B, L,
                               H, Qp, NL, P, tile_q, stream);
}

}  // extern "C"
