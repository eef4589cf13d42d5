// K1: multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/msda_banded.py::_msda_banded_mp_kernel
// (the TPU's default MSDA forward), computing the function of
// open_groundingdino_tpu/ops/msda.py::ms_deform_attn_xla on the reference
// operand layout:
//   value (B, L, H, D), locations (B, Q, H, NL, P, 2) in [0, 1],
//   weights (B, Q, H, NL, P)  ->  out (B, Q, H*D)
//   out[b,q,h,:] = sum_{l,p} w[b,q,h,l,p] * bilinear(value_l[b,:,:,h,:], loc)
// with x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5 and every corner outside the
// map contributing zero (grid_sample, align_corners=False, zero padding).
//
// What bounds it: gather traffic.  Each (b, q, h) reads NL*P*4 corner rows of
// D values at data-dependent places; the compulsory bytes (value, locations,
// weights, output, each once) are a few tens of MB per encoder call, but the
// corner rows are re-read by many neighbouring queries.  At the flagship
// bucket the value map (~20 MB in f32) fits in the 50 MB L2, so the re-reads
// are L2 hits and the kernel is bound by L2/load-issue rate, not HBM.
//
// What the design does about it: the reference CUDA op's ms_deform_im2col
// shape.  One warp per (b, q, h); lane = channel d, so each corner read is one
// coalesced D*sizeof(T)-byte row (128 B for D=32 in f32).  Consecutive warps
// take consecutive heads of one query, so a block's corner rows for one level
// sit within a few cache lines of each other.  Accumulation is in f32.  The
// TPU's banded/separable formulation exists to feed the MXU and is not ported.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                const float* __restrict__ attn, T* __restrict__ out,
                int B, int L, int H, int D, int Q, int NL, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_warps = (long long)B * Q * H;
  if (warp >= n_warps) return;
  const int h = (int)(warp % H);
  const long long bq = warp / H;          // b * Q + q
  const int b = (int)(bq / Q);

  const long long samp0 = warp * NL * P;  // (b, q, h) -> first (l, p) sample
  const float* loc = locs + samp0 * 2;
  const float* wgt = attn + samp0;
  // value[b, pos, h, d] = value[((b*L + pos)*H + h)*D + d]
  const T* vbase = value + ((long long)b * L * H + h) * D;
  const long long row_stride = (long long)H * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < D;
    float acc = 0.f;
    for (int l = 0; l < NL; ++l) {
      const int Hl = lv.h[l], Wl = lv.w[l];
      const T* vl = vbase + (long long)lv.start[l] * row_stride;
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
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cx[c] >= 0 && cx[c] < Wl && cy[c] >= 0 && cy[c] < Hl && live) {
            const float v = to_f32(vl[((long long)cy[c] * Wl + cx[c]) * row_stride + d]);
            acc += (cw[c] * a) * v;
          }
        }
      }
    }
    if (live) store(out + warp * D + d, acc);
  }
}

template <typename T>
int launch(const void* value, const void* locs, const void* attn, void* out,
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
  msda_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)locs, (const float*)attn, (T*)out,
      B, L, H, D, Q, NL, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// value/out: f32; locs, attn: f32.  Returns a cudaError_t (0 = launched).
int msda_fwd_f32(const void* value, const void* locs, const void* attn, void* out,
                 int B, int L, int H, int D, int Q, int NL, int P,
                 const int* shapes_hw, const int* level_start, void* stream) {
  return launch<float>(value, locs, attn, out, B, L, H, D, Q, NL, P,
                       shapes_hw, level_start, stream);
}

// value/out: bf16; locs, attn: f32; f32 accumulation.
int msda_fwd_bf16(const void* value, const void* locs, const void* attn, void* out,
                  int B, int L, int H, int D, int Q, int NL, int P,
                  const int* shapes_hw, const int* level_start, void* stream) {
  return launch<__nv_bfloat16>(value, locs, attn, out, B, L, H, D, Q, NL, P,
                               shapes_hw, level_start, stream);
}

}  // extern "C"
