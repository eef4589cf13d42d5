// K5: multi-scale deformable attention forward with one band sweep per
// sample point, for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_kernel
// (the banded forward under MSDA_BANDED_MP=0, launched by _banded_call).  It
// computes ms_deform_attn_xla's function in its separable form
//   out[bh, q, :] = sum_{l,p} sum_{y in the point's windows}
//                   relu(1 - |py - y|) * wa * sum_x relu(1 - |px - x|) * V[bh, l, y, x, :]
// on the operands ops/msda_banded.py::banded_prep makes:
//   value  (B, L, H, 32) f32, the reference layout (the TPU's
//          (BH, H_l*D, W_l) banded copy is not made)
//   px, py, wa (B*H, NL*P, Qp) f32, Qp a multiple of 128; px edge-collapsed
//          and clipped into the row, py clipped to [-1, H_l], wa == 0 marks a
//          dead point (outside the map, or a padded query)
//   out    (B*H, Qp, 32) f32
// Each x-interpolation has two non-zeros, at x0 = floor(px) (weight
// 1 - (px - x0)) and x0 + 1 (weight 1 - ((x0 + 1) - px), zero where px is the
// last column), which is what the TPU's (W, 128) relu matrix holds.  The
// positions arrive from the prep in PyTorch: no product precedes floor() here,
// so no contracted fma can move a point across a pixel (K1 needs __fmul_rn
// for that).
//
// Design.  One CTA of 256 threads per (b*h, 128-query block).  The TPU read
// each (block, level, point)'s [ylo, n_it] by scalar prefetch; here the
// block finds them itself: per tap (level, point), a warp min/max of the
// first and second corner rows of its live points, then shared atomics, so
// dead points and padded queries widen nothing (rows are clipped into the
// level, as _band_ranges clips them).  For each tap and each band window
// [ylo + i*band, +band) the window's value rows, band x W_l x 32 f32 (78 KB
// at level 0 of the 800x1216 bucket: dynamic shared memory), are staged once
// for the whole block, zeros past H_l (the TPU's band-1 pad rows).  Each warp
// then owns 16 queries, lane = channel: for each query and window row with a
// non-zero y-weight (warp-uniform), one conflict-free read of each of the two
// columns and an f32 FMA into that query's accumulator.  Sharing the staged
// rows across the block's 128 queries is the TPU's reuse of one A-slice per
// window.
//
// What bounds it on this card: bytes moved into shared memory.  Every
// (block, tap, window) stages whole rows, of which each query reads two
// columns; the same rows are staged again for each of the level's points
// and by each neighbouring block.  The L2 serves the re-reads (the value map
// fits), so staging bandwidth and the synchronisation around each window,
// not HBM, set its time; the smoke reports K1's bound (same function, same
// compulsory bytes).  Staging only the columns a block touches, double
// buffering the windows, or K1's union band over the points are the levers.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kQB = 128;              // queries a block
constexpr int kD = 32;                // channels a head
constexpr int kWarps = 8;
constexpr int kQW = kQB / kWarps;     // queries a warp
constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 64;          // levels x points
constexpr int kMaxSmem = 232448;      // a block's shared memory on Hopper

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void __launch_bounds__(kWarps * 32)
banded_fwd_kernel(const float* __restrict__ value, const float* __restrict__ px,
                  const float* __restrict__ py, const float* __restrict__ wa,
                  float* __restrict__ out, int L, int H, int Qp, int NL, int P, int band,
                  Levels lv) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);   // band x W_l x kD: one window
  __shared__ int s_lo[kMaxTaps], s_hi[kMaxTaps];
  __shared__ float s_x[kQB], s_y[kQB], s_a[kQB];   // the current tap's operands

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int R = NL * P;
  const size_t tap0 = (size_t)bh * R * Qp + (size_t)blockIdx.x * kQB;   // + t * Qp + query

  // each tap's rows over the block's live points
  for (int t = tid; t < R; t += blockDim.x) {
    s_lo[t] = INT_MAX;
    s_hi[t] = INT_MIN;
  }
  __syncthreads();
  if (tid < kQB) {   // warps 0-3, one query a thread: warp-uniform
    for (int t = 0; t < R; ++t) {
      const int Hl = lv.h[t / P];
      int lo = INT_MAX, hi = INT_MIN;
      if (wa[tap0 + (size_t)t * Qp + tid] != 0.f) {
        const int y0 = (int)floorf(py[tap0 + (size_t)t * Qp + tid]);
        lo = min(max(y0, 0), Hl - 1);
        hi = min(max(y0 + 1, 0), Hl - 1);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0 && lo <= hi) {
        atomicMin(&s_lo[t], lo);
        atomicMax(&s_hi[t], hi);
      }
    }
  }
  __syncthreads();

  float acc[kQW];
#pragma unroll
  for (int i = 0; i < kQW; ++i) acc[i] = 0.f;

  for (int t = 0; t < R; ++t) {
    const int lo = s_lo[t], hi = s_hi[t];
    if (lo > hi) continue;   // no live point: the same for every thread
    const int l = t / P;
    const int Hl = lv.h[l], Wl = lv.w[l], start = lv.start[l];
    const int bl = min(band, Hl);
    const int n_it = (hi - lo) / bl + 1;
    if (tid < kQB) {   // the previous tap's readers passed its last window's barrier
      s_x[tid] = px[tap0 + (size_t)t * Qp + tid];
      s_y[tid] = py[tap0 + (size_t)t * Qp + tid];
      s_a[tid] = wa[tap0 + (size_t)t * Qp + tid];
    }
    for (int it = 0; it < n_it; ++it) {
      const int y_base = lo + it * bl;
      __syncthreads();   // the previous window is read (and this tap's operands written)
      const int n4 = bl * Wl * (kD / 4);
      for (int i = tid; i < n4; i += blockDim.x) {
        const int c = i % (kD / 4), pos = i / (kD / 4);
        const int y = y_base + pos / Wl, x = pos % Wl;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < Hl)
          v = *reinterpret_cast<const float4*>(
              value + (((size_t)b * L + start + (size_t)y * Wl + x) * H + h) * kD + 4 * c);
        reinterpret_cast<float4*>(rows)[i] = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const int q = warp * kQW + i;
        const float a = s_a[q];
        if (a == 0.f) continue;   // a dead point adds nothing
        const float x = s_x[q], y = s_y[q];
        const float xf = floorf(x);
        const int x0 = (int)xf;
        const float r0 = 1.f - (x - xf);
        const float r1 = 1.f - ((xf + 1.f) - x);
        const bool two = x0 + 1 < Wl;   // else px is the last column and r1 == 0
        for (int r = 0; r < bl && y_base + r < Hl; ++r) {
          const float wy = fmaxf(1.f - fabsf(y - (float)(y_base + r)), 0.f) * a;
          if (wy == 0.f) continue;
          const float* vr = rows + (r * Wl + x0) * kD;
          float c = r0 * vr[lane];
          if (two) c += r1 * vr[kD + lane];
          acc[i] += wy * c;
        }
      }
    }
    __syncthreads();   // s_x/s_y/s_a are free for the next tap
  }
#pragma unroll
  for (int i = 0; i < kQW; ++i)
    out[((size_t)bh * Qp + blockIdx.x * kQB + warp * kQW + i) * kD + lane] = acc[i];
}

}  // namespace

extern "C" {

// Grid (Qp / 128, B*H), 256 threads, dynamic shared memory for one window of
// the widest level.  shapes_hw: (h, w) per level; level_start: each level's
// offset in L.  Returns a cudaError_t (0 = launched).
int msda_banded_fwd_f32(const void* value, const void* px, const void* py, const void* wa,
                        void* out, int B, int L, int H, int Qp, int NL, int P, int band,
                        const int* shapes_hw, const int* level_start, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Qp <= 0 || Qp % kQB || NL <= 0 || NL > kMaxLevels ||
      P <= 0 || NL * P > kMaxTaps || band <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  size_t smem = 0;
  for (int l = 0; l < NL; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = level_start[l];
    const int bl = band < lv.h[l] ? band : lv.h[l];
    const size_t need = sizeof(float) * (size_t)bl * lv.w[l] * kD;
    if (need > smem) smem = need;
  }
  if (smem > (size_t)kMaxSmem - sizeof(int) * 2 * kMaxTaps - sizeof(float) * 3 * kQB)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(banded_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Qp / kQB, B * H);
  banded_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)px, (const float*)py, (const float*)wa, (float*)out, L, H,
      Qp, NL, P, band, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
