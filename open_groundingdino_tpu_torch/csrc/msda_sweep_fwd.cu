// K7 and K8: multi-scale deformable attention forward as a tile sweep, for
// Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_rowtap_allq_kernel
// (every query block of one (b, h) in one program, MSDA_DEC_FUSED=1) as K7,
// and ::_msda_kernel (corner taps, MSDA_FWD_VARIANT=corner, reached through
// the op-level ms_deform_attn(impl="pallas")) as K8.  K7 computes K6's
// function (msda_rowtap_fwd.cu)
//   out[bh, q, :] = sum_r w[r, q] * sum_x relu(1 - |px[r, q] - x|) * V[bh, row[r, q] + x, :]
// over the row taps r of each query (ops/msda_sweep.py expands each sample
// point into two bilinear rows: the flat position of the row's first pixel,
// the continuous position px within the row, the weight w; grouped by
// level, rows_per_level each).  The TPU kernel takes row + px as one f32
// flat position; kept apart, px keeps its fraction (see msda_sweep.py).
//   value  (B, L, H, 32) f32, the reference layout (no transposed copy)
//   row    (B*H, R, Qp) int32; px, w (B*H, R, Qp) f32, Qp a multiple of 128;
//          w == 0 marks a dead tap
//   out    (B*H, Qp, 32) f32
// K8 computes out[bh, q, :] = sum_t w[t, q] * V[bh, idx[t, q], :] over the
// corner taps t (four a sample point, grouped by level: taps_per_level each;
// idx int32 (B*H, T, Qp) flat positions, clamped into the level where w == 0).
//
// Design.  A kernel block of 128 threads owns one 128-query block (K8: one
// such group per CTA, one CTA per (b*h, query block); K7: up to 8 groups
// per CTA, one CTA per (b, h) that walks all of its query blocks).  Per
// level, each group reduces the range of positions its live taps touch
// (warp min/max, then shared atomics): dead taps and padded queries do not
// widen it.  The CTA sweeps the union of its groups' ranges in tiles of T
// positions: the tile's T x 32 values are staged in shared memory once, and
// every group whose range meets the tile builds its S (T x 128, zeroed, then
// each thread scatters its query's non-zeros per row: K7 the weights
// (1 - f) and 1 - ((p0 + 1) - px) of each row tap, as the dense relu gives
// them; K8 each corner tap's one weight at its position, up to 16 a level)
// and accumulates S^T-by-V into registers (8 queries x 4 channels a thread,
// f32 SIMT FMAs; a tile no tap of the group lands in skips its product).
// The TPU's (TILE, 128) compare/select build of S is not carried over.
// K7's point is the shared staging: at B = 1 the decoder has only 8 (b, h)
// pairs, so each pair gets a whole SM (8 groups = 1024 threads, T = 32,
// 132 KB of shared memory); K8 runs T = 64 and 40 KB a CTA, five CTAs an SM.
//
// What bounds it on this card: operations.  The dense S-by-V product does
// T * 128 * 32 FMAs per (block, tile) where the gather (K1) needs 64 taps a
// query; the bound the smoke reports is K1's (same function, same compulsory
// bytes and operations), and this design is tens of times above it.  K6
// took K1's gather shape on the row taps (msda_rowtap_fwd.cu); the same
// move for K7 and K8 is later work.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kQB = 128;   // queries a group (one thread each in the S build)
constexpr int kD = 32;     // channels a head
constexpr int kMaxGroups = 8;

__device__ __forceinline__ const float* value_row(const float* value, int b, int pos, int h,
                                                  int L, int H) {
  return value + (((size_t)b * L + pos) * H + h) * kD;
}

// kCorner: row holds corner positions and px is unused (K8).
template <int T, int NB, bool kCorner>
__global__ void __launch_bounds__(kQB * NB, 1)
sweep_fwd_kernel(const float* __restrict__ value, const int* __restrict__ row,
                 const float* __restrict__ px, const float* __restrict__ w,
                 float* __restrict__ out,
                 int L, int H, int Qp, int NL, int rows_per_level, int nb) {
  extern __shared__ float4 smem4[];
  float* vt = reinterpret_cast<float*>(smem4);   // T x kD value tile
  float* S_all = vt + T * kD;                    // nb x (T x kQB), S[s][q]
  __shared__ int g_lo[NB], g_hi[NB], g_live[NB];
  __shared__ int u_lo, u_hi;

  const int tid = threadIdx.x;
  const int grp = tid / kQB;
  const int lt = tid % kQB;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nqb = Qp / kQB;
  const int R = NL * rows_per_level;
  const int* rowb = row + (size_t)bh * R * Qp;
  const float* pxb = px + (size_t)bh * R * Qp;
  const float* wb = w + (size_t)bh * R * Qp;
  float* S = S_all + grp * T * kQB;
  const int q0 = (lt >> 3) * 8;   // product tile: 8 queries x 4 channels
  const int d0 = (lt & 7) * 4;

  for (int blk0 = blockIdx.x * nb; blk0 < nqb; blk0 += gridDim.x * nb) {
    const int blk = blk0 + grp;
    const bool active = blk < nqb;
    const int q = blk * kQB + lt;   // this thread's query in the S build
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int l = 0; l < NL; ++l) {
      const int r0 = l * rows_per_level, r1 = r0 + rows_per_level;
      if (tid < nb) { g_lo[tid] = INT_MAX; g_hi[tid] = INT_MIN; }
      if (tid == 0) { u_lo = INT_MAX; u_hi = INT_MIN; }
      __syncthreads();
      if (active) {
        int mn = INT_MAX, mx = INT_MIN;
        for (int r = r0; r < r1; ++r) {
          if (wb[(size_t)r * Qp + q] != 0.f) {
            if (kCorner) {
              const int p0 = rowb[(size_t)r * Qp + q];
              mn = min(mn, p0);
              mx = max(mx, p0);
            } else {
              const int p0 = rowb[(size_t)r * Qp + q] + (int)floorf(pxb[(size_t)r * Qp + q]);
              mn = min(mn, p0);
              mx = max(mx, p0 + 1);
            }
          }
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        if ((lt & 31) == 0 && mn <= mx) {
          atomicMin(&g_lo[grp], mn);
          atomicMax(&g_hi[grp], mx);
          atomicMin(&u_lo, mn);
          atomicMax(&u_hi, mx);
        }
      }
      __syncthreads();
      const int lo = g_lo[grp], hi = g_hi[grp];
      int t_first = 0, t_last = -1;
      if (u_lo <= u_hi && u_hi >= 0 && u_lo < L) {
        t_first = max(u_lo, 0) / T;
        t_last = min(u_hi, L - 1) / T;
      }
      __syncthreads();   // every thread has read the ranges before the next level resets them

      for (int t = t_first; t <= t_last; ++t) {
        const int base = t * T;
        for (int i = tid; i < T * kD / 4; i += blockDim.x) {
          const int s = i / (kD / 4), c = i % (kD / 4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (base + s < L)   // and base >= 0, since t_first >= 0
            v = *reinterpret_cast<const float4*>(value_row(value, b, base + s, h, L, H) + 4 * c);
          reinterpret_cast<float4*>(vt)[i] = v;
        }
        const bool covers = active && lo <= hi && lo < base + T && hi >= base;
        if (covers)
          for (int i = lt; i < T * kQB / 4; i += kQB)
            reinterpret_cast<float4*>(S)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tid < nb) g_live[tid] = 0;
        __syncthreads();
        if (covers) {
          bool any = false;
          for (int r = r0; r < r1; ++r) {
            const float wv = wb[(size_t)r * Qp + q];
            if (wv == 0.f) continue;
            if (kCorner) {
              const int s0 = rowb[(size_t)r * Qp + q] - base;
              if (s0 >= 0 && s0 < T) {
                S[s0 * kQB + lt] += wv;
                any = true;
              }
              continue;
            }
            const float x = pxb[(size_t)r * Qp + q];
            const float xf = floorf(x);
            const int s0 = rowb[(size_t)r * Qp + q] + (int)xf - base;
            if (s0 >= 0 && s0 < T) {
              S[s0 * kQB + lt] += (1.f - (x - xf)) * wv;
              any = true;
            }
            if (s0 + 1 >= 0 && s0 + 1 < T) {
              S[(s0 + 1) * kQB + lt] += (1.f - ((xf + 1.f) - x)) * wv;
              any = true;
            }
          }
          if (any) g_live[grp] = 1;
        }
        __syncthreads();
        if (covers && g_live[grp]) {
#pragma unroll 4
          for (int s = 0; s < T; ++s) {
            const float4 a0 = *reinterpret_cast<const float4*>(S + s * kQB + q0);
            const float4 a1 = *reinterpret_cast<const float4*>(S + s * kQB + q0 + 4);
            const float4 v = *reinterpret_cast<const float4*>(vt + s * kD + d0);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][0] += a[i] * v.x;
              acc[i][1] += a[i] * v.y;
              acc[i][2] += a[i] * v.z;
              acc[i][3] += a[i] * v.w;
            }
          }
        }
        __syncthreads();   // the tile and S are free for the next tile
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(out + ((size_t)bh * Qp + blk * kQB + q0 + i) * kD + d0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int T, int NB, bool kCorner = false>
int launch(const void* value, const void* row, const void* px, const void* w, void* out, int B,
           int L, int H,
           int Qp, int NL, int rows_per_level, int nb, int grid_x, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)T * kD + (size_t)nb * T * kQB);
  cudaError_t err = cudaFuncSetAttribute(sweep_fwd_kernel<T, NB, kCorner>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, B * H);
  sweep_fwd_kernel<T, NB, kCorner><<<grid, kQB * nb, smem, stream>>>(
      (const float*)value, (const int*)row, (const float*)px, (const float*)w, (float*)out, L, H,
      Qp, NL,
      rows_per_level, nb);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int L, int H, int Qp, int NL, int rows_per_level) {
  return B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || Qp % kQB || NL <= 0 || rows_per_level <= 0 ||
         B * H > 65535;
}

}  // namespace

extern "C" {

// K7: grid (1, B*H), one CTA per (b, h) holding min(Qp / 128, 8) query
// blocks at a time and walking all of them.
int msda_sweep_fwd_allq_f32(const void* value, const void* row, const void* px, const void* w,
                            void* out, int B, int L, int H, int Qp, int NL, int rows_per_level,
                            void* stream) {
  if (bad_args(B, L, H, Qp, NL, rows_per_level)) return (int)cudaErrorInvalidValue;
  const int nqb = Qp / kQB;
  const int nb = nqb < kMaxGroups ? nqb : kMaxGroups;
  return launch<32, kMaxGroups>(value, row, px, w, out, B, L, H, Qp, NL, rows_per_level, nb, 1,
                                (cudaStream_t)stream);
}

// K8: grid (Qp / 128, B*H), one 128-query block a CTA, on corner taps.
// idx int32 (B*H, NL * taps_per_level, Qp), w f32 of the same shape, all
// contiguous; out is written whole.  Returns a cudaError_t (0 = launched).
int msda_sweep_fwd_corner_f32(const void* value, const void* idx, const void* w, void* out, int B,
                              int L, int H, int Qp, int NL, int taps_per_level, void* stream) {
  if (bad_args(B, L, H, Qp, NL, taps_per_level)) return (int)cudaErrorInvalidValue;
  return launch<64, 1, true>(value, idx, nullptr, w, out, B, L, H, Qp, NL, taps_per_level, 1,
                             Qp / kQB, (cudaStream_t)stream);
}

}  // extern "C"
