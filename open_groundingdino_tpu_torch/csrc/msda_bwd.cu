// K3: multi-scale deformable attention backward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_bwd_kernel
// (the TPU's default MSDA backward).  Computes the gradient of K1's function
// (open_groundingdino_tpu/ops/msda.py::ms_deform_attn_xla, i.e. jax.grad of
// it) on the reference operand layout:
//   value (B, L, H, D), locations (B, Q, H, NL, P, 2), weights (B, Q, H, NL, P),
//   upstream gradient g (B, Q, H*D)
//   -> grad_value (B, L, H, D), grad_locs (B, Q, H, NL, P, 2), grad_attn (B, Q, H, NL, P)
// With px = x*W_l - 0.5, fx = px - floor(px) (floor has zero derivative, so
// the derivative is the one-sided one of the bilinear weights), corners
// outside the map contribute nothing (their weight is zero, so is its
// derivative), and for each sample s with weight a and corner values v_c:
//   grad_value[corner c] += a * w_c * g
//   grad_attn[s]          = sum_d g * sum_c w_c v_c
//   d/dpx                 = a * sum_d g * ((1-fy)(v10 - v00) + fy (v11 - v01))
//   d/dpy                 = a * sum_d g * ((1-fx)(v01 - v00) + fx (v11 - v10))
//   grad_locs[s]          = (d/dpx * W_l, d/dpy * H_l)
//
// What bounds it: the grad_value scatter.  Each (b, q, h) adds NL*P*4 corner
// rows of D values at data-dependent places; the compulsory bytes (value,
// locations, weights and g read once, the three gradients written once) are
// ~145 MB per encoder call at the flagship bucket, and the scatter turns
// every corner row into D atomic read-modify-writes in L2.
//
// What the design does about it: the reference CUDA op's ms_deform_col2im
// shape.  One warp per (b, q, h), lane = channel d (D = 32: one coalesced
// 128-byte row per corner read and per corner scatter), f32 atomicAdd into a
// grad_value buffer the wrapper zeroes.  grad_attn and grad_locs are per-lane
// partial sums reduced by warp shuffles.  The TPU kernel zeroes grad_value at
// the first query block and read-modify-writes it across the sequential
// query axis; GPU blocks run in no order, so that carry becomes atomics, and
// the order of the f32 sums changes from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ locs,
                const float* __restrict__ attn, const float* __restrict__ grad_out,
                float* __restrict__ grad_value, float* __restrict__ grad_locs,
                float* __restrict__ grad_attn,
                int B, int L, int H, int D, int Q, int NL, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_warps = (long long)B * Q * H;
  if (warp >= n_warps) return;   // whole warps exit together: shuffles stay full
  const int h = (int)(warp % H);
  const long long bq = warp / H;          // b * Q + q
  const int b = (int)(bq / Q);

  const long long samp0 = warp * NL * P;
  const float* loc = locs + samp0 * 2;
  const float* wgt = attn + samp0;
  const float* g_row = grad_out + warp * D;   // grad_out[b, q, h*D + d]
  const long long vbase = ((long long)b * L * H + h) * D;
  const long long row_stride = (long long)H * D;

  for (int l = 0; l < NL; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const long long lbase = vbase + (long long)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const float a = wgt[s];
      // px rounded twice, as the plain version and the reference compute it:
      // a contracted fma(x, W, -0.5) can land on the other side of an integer,
      // where floor() picks other corners (and the derivative jumps)
      const float x = __fmul_rn(loc[2 * s], (float)Wl) - 0.5f;
      const float y = __fmul_rn(loc[2 * s + 1], (float)Hl) - 0.5f;
      const float xf = floorf(x), yf = floorf(y);
      const int x0 = (int)xf, y0 = (int)yf;
      const float fx = x - xf, fy = y - yf;
      const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                           (1.f - fx) * fy, fx * fy};
      const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
      const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
      bool in[4];
      long long off[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        in[c] = cx[c] >= 0 && cx[c] < Wl && cy[c] >= 0 && cy[c] < Hl;
        off[c] = lbase + ((long long)cy[c] * Wl + cx[c]) * row_stride;
      }
      float pa = 0.f, pdx = 0.f, pdy = 0.f;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        if (d >= D) break;
        const float g = g_row[d];
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = in[c] ? value[off[c] + d] : 0.f;
          if (in[c]) atomicAdd(grad_value + off[c] + d, a * cw[c] * g);
        }
        pa += g * (cw[0] * v[0] + cw[1] * v[1] + cw[2] * v[2] + cw[3] * v[3]);
        pdx += g * ((1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]));
        pdy += g * ((1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]));
      }
      pa = warp_sum(pa);
      pdx = warp_sum(pdx);
      pdy = warp_sum(pdy);
      if (lane == 0) {
        grad_attn[samp0 + s] = pa;
        grad_locs[(samp0 + s) * 2] = a * pdx * Wl;
        grad_locs[(samp0 + s) * 2 + 1] = a * pdy * Hl;
      }
    }
  }
}

}  // namespace

extern "C" {

// All f32 contiguous.  grad_value must be zeroed by the caller (the kernel
// accumulates into it); grad_locs and grad_attn are written whole.
// Returns a cudaError_t (0 = launched).
int msda_bwd_f32(const void* value, const void* locs, const void* attn, const void* grad_out,
                 void* grad_value, void* grad_locs, void* grad_attn,
                 int B, int L, int H, int D, int Q, int NL, int P,
                 const int* shapes_hw, const int* level_start, void* stream) {
  if (NL > kMaxLevels || NL <= 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < NL; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = level_start[l];
  }
  const long long n_warps = (long long)B * Q * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)locs, (const float*)attn, (const float*)grad_out,
      (float*)grad_value, (float*)grad_locs, (float*)grad_attn, B, L, H, D, Q, NL, P, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
