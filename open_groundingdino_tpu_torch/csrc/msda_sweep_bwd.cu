// K10: multi-scale deformable attention backward as a row-tap tile sweep,
// for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_pallas.py::_msda_rowtap_bwd_kernel
// (row taps, MSDA_BWD_VARIANT=rowtap; the corner-tap backward K9 is
// msda_corner_bwd.cu).  With P[s, q] = V[bh, s, :] . g[bh, q, :] over the
// value positions s, row (int32), px, w (B*H, NL*2*P, Qp): a row tap puts
// w * relu(1 - |px - x|) at position row + x (the TPU kernel takes row + px
// as one f32 flat position; see msda_sweep.py)
//   gw[r, q]  = sum_x relu(1 - |px - x|) P[row + x, q]
//   gpx[r, q] = sum_x -sign(px - x) [|px - x| < 1] P[row + x, q]  (the
//               caller multiplies by w, as msda_pallas.py:1464-1466 does)
//   grad_value[s, :] = sum_q S[q, s] g[q, :], S the taps' weights
// value (B, L, H, 32) f32 (reference layout), g (B*H, Qp, 32) f32,
// grad_value (B, L, H, 32) f32 (zeroed by the caller).
//
// Design.  One CTA of 128 threads per (b*h, 128-query block), thread = query.
// Per level the block reduces the range of positions its live taps touch
// (dead taps and padded queries do not widen it) and sweeps it in tiles of
// 64 positions.  Per tile: the 64 x 32 values are staged in shared memory;
// each thread scatters its query's taps into its own row of S (128 x 64) and
// marks the positions hit; if any tap landed, each thread computes its
// column of P = V g^T (64 dots of 32 against its own g row, held in
// registers), reads its taps' gw (and gpx) from that column, and the block
// computes the tile's grad_value partial S^T g (4 positions x 4 channels a
// thread, g staged in shared memory) and adds it with f32 atomicAdd to the
// positions some tap hit.  The TPU kernel instead carries grad_value across
// its sequential query-block axis (msda_pallas.py:988-990, :1213-1215); GPU
// blocks run in no order, so the carry becomes atomics, as in K3, and the
// order of grad_value's f32 sums changes from run to run (not deterministic;
// gw and gpx are).  gw is computed for every tap whose position lies in a
// tile its block sweeps; a dead tap (w == 0) outside every swept tile gets 0,
// which the chain rule multiplies by zero.
//
// What bounds it on this card: operations.  The dense P and S^T g products
// do 2 * 64 * 128 * 32 FMAs per (block, tile) where K3 needs a few per
// corner; the bound the smoke reports is K3's (same function).  Both
// products have tensor-core shape (wgmma), later work; f32 SIMT first.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kQB = 128;
constexpr int kD = 32;
constexpr int kT = 64;   // value positions a tile

__global__ void __launch_bounds__(kQB)
sweep_bwd_kernel(const float* __restrict__ value, const int* __restrict__ row,
                 const float* __restrict__ px,
                 const float* __restrict__ w, const float* __restrict__ g,
                 float* __restrict__ gv, float* __restrict__ gw, float* __restrict__ gpx,
                 int L, int H, int Qp, int NL, int per_level) {
  constexpr int kMaxTaps = 8;   // a level's row taps of one query (P <= 4)
  extern __shared__ float4 smem4[];
  float* gsm = reinterpret_cast<float*>(smem4);   // kQB x kD, g of the block
  float* vt = gsm + kQB * kD;                     // kT x kD, value tile
  float* S = vt + kT * kD;                        // kQB x kT, S[q][s]
  float* Pm = S + kQB * kT;                       // kT x kQB, P[s][q]
  int* touched = reinterpret_cast<int*>(Pm + kT * kQB);   // kT
  __shared__ int lo_s, hi_s, live_s;

  const int lt = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q = blockIdx.x * kQB + lt;
  const int R = NL * per_level;
  const int* rowb = row + (size_t)bh * R * Qp;
  const float* pxb = px + (size_t)bh * R * Qp;
  const float* wb = w + (size_t)bh * R * Qp;
  const int s0 = (lt >> 3) * 4;   // grad_value tile: 4 positions x 4 channels
  const int d0 = (lt & 7) * 4;

  float greg[kD];
  {
    const float4* grow = reinterpret_cast<const float4*>(g + ((size_t)bh * Qp + q) * kD);
#pragma unroll
    for (int c = 0; c < kD / 4; ++c) {
      const float4 v = grow[c];
      greg[4 * c] = v.x;
      greg[4 * c + 1] = v.y;
      greg[4 * c + 2] = v.z;
      greg[4 * c + 3] = v.w;
      reinterpret_cast<float4*>(gsm + lt * kD)[c] = v;
    }
  }

  for (int l = 0; l < NL; ++l) {
    const int t0 = l * per_level;
    float gwa[kMaxTaps], gpa[kMaxTaps];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) gwa[k] = gpa[k] = 0.f;

    if (lt == 0) { lo_s = INT_MAX; hi_s = INT_MIN; }
    __syncthreads();
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k >= per_level) break;
      const size_t o = (size_t)(t0 + k) * Qp + q;
      if (wb[o] == 0.f) continue;
      const int p0 = rowb[o] + (int)floorf(pxb[o]);
      mn = min(mn, p0);
      mx = max(mx, p0 + 1);
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if ((lt & 31) == 0 && mn <= mx) {
      atomicMin(&lo_s, mn);
      atomicMax(&hi_s, mx);
    }
    __syncthreads();
    int t_first = 0, t_last = -1;
    if (lo_s <= hi_s && hi_s >= 0 && lo_s < L) {
      t_first = max(lo_s, 0) / kT;
      t_last = min(hi_s, L - 1) / kT;
    }
    __syncthreads();   // every thread has read the range before the next level resets it

    for (int t = t_first; t <= t_last; ++t) {
      const int base = t * kT;
      for (int i = lt; i < kT * kD / 4; i += kQB) {
        const int s = i / (kD / 4), c = i % (kD / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (base + s < L)
          v = *reinterpret_cast<const float4*>(value + (((size_t)b * L + base + s) * H + h) * kD +
                                               4 * c);
        reinterpret_cast<float4*>(vt)[i] = v;
      }
#pragma unroll
      for (int i = 0; i < kT / 4; ++i)
        reinterpret_cast<float4*>(S + lt * kT)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lt < kT) touched[lt] = 0;
      if (lt == 0) live_s = 0;
      __syncthreads();

      bool any = false;
#pragma unroll
      for (int k = 0; k < kMaxTaps; ++k) {
        if (k >= per_level) break;
        const size_t o = (size_t)(t0 + k) * Qp + q;
        const float wv = wb[o];
        if (wv == 0.f) continue;
        const float x = pxb[o];
        const float xf = floorf(x);
        const int s = rowb[o] + (int)xf - base;
        if (s >= 0 && s < kT) {
          S[lt * kT + s] += (1.f - (x - xf)) * wv;
          touched[s] = 1;
          any = true;
        }
        if (s + 1 >= 0 && s + 1 < kT) {
          S[lt * kT + s + 1] += (1.f - ((xf + 1.f) - x)) * wv;
          touched[s + 1] = 1;
          any = true;
        }
      }
      if (any) live_s = 1;
      __syncthreads();

      if (live_s) {
        // this thread's column of P: only it reads the column back
        for (int s = 0; s < kT; ++s) {
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < kD / 4; ++c) {
            const float4 v = reinterpret_cast<const float4*>(vt + s * kD)[c];
            p += v.x * greg[4 * c] + v.y * greg[4 * c + 1] + v.z * greg[4 * c + 2] +
                 v.w * greg[4 * c + 3];
          }
          Pm[s * kQB + lt] = p;
        }
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k >= per_level) break;
          const size_t o = (size_t)(t0 + k) * Qp + q;
          const float x = pxb[o];
          const float xf = floorf(x);
          const int s = rowb[o] + (int)xf - base;
          const bool in0 = s >= 0 && s < kT, in1 = s + 1 >= 0 && s + 1 < kT;
          const float p0 = in0 ? Pm[s * kQB + lt] : 0.f;
          const float p1 = in1 ? Pm[(s + 1) * kQB + lt] : 0.f;
          gwa[k] += (1.f - (x - xf)) * p0 + (1.f - ((xf + 1.f) - x)) * p1;
          if (x > xf) gpa[k] += p1 - p0;
        }
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 4
        for (int qq = 0; qq < kQB; ++qq) {
          const float4 sv = *reinterpret_cast<const float4*>(S + qq * kT + s0);
          const float4 gg = *reinterpret_cast<const float4*>(gsm + qq * kD + d0);
          const float si[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i][0] += si[i] * gg.x;
            a[i][1] += si[i] * gg.y;
            a[i][2] += si[i] * gg.z;
            a[i][3] += si[i] * gg.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = base + s0 + i;
          if (!touched[s0 + i] || pos >= L) continue;
          float* row = gv + (((size_t)b * L + pos) * H + h) * kD + d0;
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(row + j, a[i][j]);
        }
      }
      __syncthreads();   // the tile, S and touched are free for the next tile
    }
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k >= per_level) break;
      const size_t o = ((size_t)bh * R + t0 + k) * Qp + q;
      gw[o] = gwa[k];
      gpx[o] = gpa[k];
    }
  }
}

}  // namespace

extern "C" {

// K10.  row int32, the rest f32, all contiguous; grad_value zeroed by the
// caller, gw and gpx written whole.  Returns a cudaError_t.
int msda_sweep_bwd_rowtap_f32(const void* value, const void* row, const void* px, const void* w,
                              const void* g, void* grad_value, void* gw, void* gpx, int B, int L,
                              int H, int Qp, int NL, int rows_per_level, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || Qp % kQB || NL <= 0 || rows_per_level <= 0 ||
      rows_per_level > 8 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kQB * kD + kT * kD + 2 * kQB * kT) +
                      sizeof(int) * kT;
  cudaError_t err = cudaFuncSetAttribute(sweep_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Qp / kQB, B * H);
  sweep_bwd_kernel<<<grid, kQB, smem, (cudaStream_t)stream>>>(
      (const float*)value, (const int*)row, (const float*)px, (const float*)w, (const float*)g,
      (float*)grad_value, (float*)gw, (float*)gpx, L, H, Qp, NL, rows_per_level);
  return (int)cudaGetLastError();
}

}  // extern "C"
