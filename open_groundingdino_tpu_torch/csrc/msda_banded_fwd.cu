// K5: multi-scale deformable attention forward on the per-point banded
// operands, for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_kernel
// (the banded forward under MSDA_BANDED_MP=0, launched by _banded_call).  It
// computes ms_deform_attn_xla's function in its separable form
//   out[bh, q, :] = sum_{l,p} sum_y relu(1 - |py - y|) * wa
//                   * sum_x relu(1 - |px - x|) * V[bh, l, y, x, :]
// on the operands ops/msda_banded.py::banded_prep makes:
//   value  (B, L, H, 32) f32, the reference layout (the TPU's
//          (BH, H_l*D, W_l) banded copy is not made)
//   px, py, wa (B*H, NL*P, Qp) f32; px edge-collapsed and clipped into the
//          row, py clipped to [-1, H_l], wa == 0 marks a dead point (outside
//          the map, or a padded query)
//   out    (B*H, Qp, 32) f32
// or, in the bf16 entry (msda_banded_fwd_bf16; the TPU kernel's bf16 branch,
// msda_banded.py:175, 190, 199-204), value and out bf16: a value row is 64 B,
// 8 B a lane (msda_common.cuh load4), px, py, wa, the corner weights and
// every sum stay f32, and each output is rounded to bf16 once (store4).
// Departure: the TPU kernel rounds its x-tap matrix sx to bf16 for the MXU
// (:190); the port keeps the tap weights f32, as K1's, K6's and K7's bf16
// entries do, so the bf16 entry computes the f32 function of the bf16 value
// rows, rounded once.
// A live point has at most two rows with a non-zero y-weight, y0 = floor(py)
// and y0 + 1 (those inside the level), and in each at most two columns,
// x0 = floor(px) (weight 1 - (px - x0)) and x0 + 1 (weight
// 1 - ((x0 + 1) - px), zero where px is an integer, as on the last column).
// The TPU's band windows only enumerate rows around these: every window row
// outside them has a zero y-weight, and rows at or past H_l read zero.  So
// the kernel takes the (at most) four corners of each point directly; `band`
// shapes only the plain version's loop.  The positions arrive from the prep
// in PyTorch: no product precedes floor() here, and 1 - (px - x0),
// 1 - ((x0 + 1) - px) and 1 - |py - y| have none to contract.
//
// What bounds it: gather traffic, as for K1 (same function, same compulsory
// bytes; the smoke reports K1's bound).  The value map sits in L2; each live
// point reads up to four 128-B rows at data-dependent places, almost all of
// them re-reads that L1 and L2 serve.
//
// Design (K1's, msda_common.cuh, on K5's operands):
//   - a CTA takes one b*h and a tile of consecutive queries (ops/msda.py
//     msda_fwd_tile, as for K1).  Its threads first stage the tile's
//     (point, query) pairs, one pair a thread, reading px, py and wa
//     coalesced along q, and compute each point's corner positions and
//     weights once into shared memory (-1 for a corner with zero weight or
//     outside the map: dead points and padded queries cost no loads);
//   - each warp then takes two queries at a time as 4 lane groups of 8 lanes,
//     group g on the points (level i, point g), each lane on 4 channels
//     (one float4 a corner row, read through L1), loops unrolled: 32 corner
//     rows in flight a warp; the groups' sums meet in two shuffle levels.
// No value rows are staged: the old design staged whole band-window rows
// (78 KB at level 0) for each point, of which a query read two columns.
#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// 5 CTAs an SM: ptxas then takes 48 registers (f32) and 40 (bf16), no
// spills; without the bound the f32 kernel took 40 with 12 B of spills, and
// ran ~3% slower (PERF.md).  T: the value's and the output's type.
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
banded_fwd_kernel(const T* __restrict__ value, const float* __restrict__ px,
                  const float* __restrict__ py, const float* __restrict__ wa,
                  T* __restrict__ out, int L, int H, int Qp, int NL, int tile_q,
                  int n_tiles, Levels lv) {
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
    int4 pos = make_int4(-1, -1, -1, -1);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t o = ((size_t)bh * nlp + t) * Qp + q0 + qq;
    const float a = qq < nq ? __ldg(wa + o) : 0.f;
    if (a != 0.f) {
      const int l = t / kP;
      // the level's constants by compile-time index: a run-time index into
      // the kernel's parameters would copy them to the stack
      int Hl = lv.h[0], Wl = lv.w[0], start = lv.start[0];
#pragma unroll
      for (int k = 1; k < kMaxLevels; ++k) {
        if (l == k) {
          Hl = lv.h[k];
          Wl = lv.w[k];
          start = lv.start[k];
        }
      }
      const float x = __ldg(px + o), y = __ldg(py + o);
      const float xf = floorf(x), yf = floorf(y);
      const int x0 = (int)xf, y0 = (int)yf;
      const float r0 = 1.f - (x - xf);
      const float r1 = 1.f - ((xf + 1.f) - x);
      const float wy0 = fmaxf(1.f - fabsf(y - yf), 0.f) * a;
      const float wy1 = fmaxf(1.f - fabsf(y - (yf + 1.f)), 0.f) * a;
      const bool c0 = r0 != 0.f, c1 = x0 + 1 < Wl && r1 != 0.f;
      const bool row0 = y0 >= 0 && y0 < Hl && wy0 != 0.f;
      const bool row1 = y0 + 1 >= 0 && y0 + 1 < Hl && wy1 != 0.f;
      const int p00 = start + y0 * Wl + x0;
      pos = make_int4(row0 && c0 ? p00 : -1, row0 && c1 ? p00 + 1 : -1,
                      row1 && c0 ? p00 + Wl : -1, row1 && c1 ? p00 + Wl + 1 : -1);
      w = make_float4(wy0 * r0, wy0 * r1, wy1 * r0, wy1 * r1);
    }
    cpos[t * stride + qq] = pos;
    cw[t * stride + qq] = w;
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
int launch(const void* value, const void* px, const void* py, const void* wa, void* out, int B,
           int L, int H, int Qp, int NL, int P, const int* shapes_hw, const int* level_start,
           int tile_q, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || NL <= 0 || NL > kMaxLevels || P != kP ||
      tile_q <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < NL;
    lv.h[l] = live ? shapes_hw[2 * l] : 0;
    lv.w[l] = live ? shapes_hw[2 * l + 1] : 0;
    lv.start[l] = live ? level_start[l] : 0;
    lv.smem_row[l] = -1;
  }
  const int smem = smem_bytes(NL, tile_q);
  cudaError_t err = cudaFuncSetAttribute(banded_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Qp + tile_q - 1) / tile_q;
  banded_fwd_kernel<T><<<(unsigned)((long long)B * H * n_tiles), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const T*)value, (const float*)px, (const float*)py, (const float*)wa, (T*)out, L, H, Qp,
      NL, tile_q, n_tiles, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of msda_banded_fwd_f32 and _bf16 at tile_q queries a
// CTA.
int msda_banded_fwd_smem_bytes(int NL, int tile_q) { return smem_bytes(NL, tile_q); }

// value, px, py, wa, out f32, contiguous; value and out 16-byte aligned.
// Built for D = 32 and P = 4 (msda_common.cuh); shapes_hw: (h, w) per level;
// level_start: each level's offset in L; tile_q queries a CTA (ops/msda.py
// msda_fwd_tile).  Returns a cudaError_t (0 = launched).
int msda_banded_fwd_f32(const void* value, const void* px, const void* py, const void* wa,
                        void* out, int B, int L, int H, int Qp, int NL, int P,
                        const int* shapes_hw, const int* level_start, int tile_q, void* stream) {
  return launch<float>(value, px, py, wa, out, B, L, H, Qp, NL, P, shapes_hw, level_start,
                       tile_q, stream);
}

// The bf16 entry: value and out bf16, px, py, wa f32 as above; f32 weights
// and sums, each output rounded to bf16 once.
int msda_banded_fwd_bf16(const void* value, const void* px, const void* py, const void* wa,
                         void* out, int B, int L, int H, int Qp, int NL, int P,
                         const int* shapes_hw, const int* level_start, int tile_q, void* stream) {
  return launch<__nv_bfloat16>(value, px, py, wa, out, B, L, H, Qp, NL, P, shapes_hw,
                               level_start, tile_q, stream);
}

}  // extern "C"
