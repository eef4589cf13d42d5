// LSAP: the Hungarian matcher's linear sum assignment on the device, for
// Hopper (sm_90a).
//
// Replaces: open_groundingdino_tpu/ops/hungarian.py::hungarian_device (an
// XLA while-loop program, vmapped over the S*B problems, not a Pallas
// kernel), with the defaults it runs: the Jonker-Volgenant row reduction
// (HUNGARIAN_RR=1) and the row mask of the alternating tree
// (HUNGARIAN_MASKED=1).  ops/lsap.py holds the algorithm's description and
// its plain PyTorch version; the kernel takes the same steps in the same
// order with the same f32 arithmetic, so the two give the same indices:
//   cost (N, G, Q) f32 (rows = GT, the costs transposed), valid (N, G) u8
//   -> assigned (N, G) int64 (the sentinel Q on invalid slots),
//      overflow (N,) u8 (a Dijkstra reached its bound of m + 1 iterations).
//
// What bounds it: latency.  The compulsory bytes are the costs once (12.9 MB
// at N = 28, Q = 900, G = 128: 3.9 us at 3.35 TB/s), but the solver is a
// chain of dependent steps: a Dijkstra iteration needs the previous one's
// column, and the rows augment one after the other.  Each iteration is one
// read of a cost row and one block-wide argmin.
//
// What the design does about it (a simple first design):
//   - one CTA a problem, all its state in shared memory (u, v, minv, p, way,
//     used, the row mask: ~21 KB at Q = 900, G = 128), so an iteration
//     touches device memory only for its cost row (3.6 KB, coalesced, from
//     L2 after the row reduction's pass);
//   - the row reduction reads the whole matrix once, one warp a row; most
//     rows claim their argmin column and need no Dijkstra;
//   - 512 threads, each owning the columns j = tid + k * 512, so a column's
//     used flag, minv and v are written only by their owner; one argmin over
//     (value, column) pairs in a total order (the lower value, a NaN below
//     every number, the lower column on equal values: jnp.argmin's first
//     minimum), so any reduction tree picks the same column.
// 28 problems fill 28 of the 132 SMs; the rest idle (later work).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kInf = 1e18f;   // the JAX solver's INF

// (a, ia) before (b, ib): a NaN is less than any number, equal values order
// by index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (an) return ia < ib;
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// every thread returns the block's least (v, i); two barriers
__device__ __forceinline__ void block_argmin(float& v, int& i, float* sv, int* si) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_argmin(v, i);
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  v = lane < kWarps ? sv[lane] : INFINITY;
  i = lane < kWarps ? si[lane] : INT32_MAX;
  warp_argmin(v, i);
  __syncthreads();   // sv, si free again
}

__host__ __device__ inline size_t smem_bytes(int n, int m) {
  // f32: v, minv (m + 1 each), u (n + 1), the reduction's 32
  // i32: p, way, winner (m + 1 each), order, free rows (n each), amin (n + 1),
  //      the reduction's 32, 8 scalars
  // u8:  used (m + 1), rowmask and claim (n + 1 each)
  return sizeof(float) * (2 * (m + 1) + (n + 1) + 32)
       + sizeof(int) * (3 * (m + 1) + 2 * n + (n + 1) + 32 + 8)
       + (m + 1) + 2 * (n + 1);
}

__global__ void __launch_bounds__(kThreads)
lsap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
            int64_t* __restrict__ out, uint8_t* __restrict__ overflow, int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = G, m = Q, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* v = reinterpret_cast<float*>(smem);
  float* minv = v + (m + 1);
  float* u = minv + (m + 1);
  float* red_v = u + (n + 1);
  int* p = reinterpret_cast<int*>(red_v + 32);
  int* way = p + (m + 1);
  int* winner = way + (m + 1);
  int* order = winner + (m + 1);      // sorted row r (1-based) is GT order[r - 1]
  int* free_rows = order + n;
  int* amin = free_rows + n;          // a row's claimed column; later its query
  int* red_i = amin + (n + 1);
  int* scalars = red_i + 32;          // [0] valid rows, [1] free rows
  uint8_t* used = reinterpret_cast<uint8_t*>(scalars + 8);
  uint8_t* rowmask = used + (m + 1);
  uint8_t* claim = rowmask + (n + 1);

  const float* C = cost + (size_t)blockIdx.x * G * Q;
  const uint8_t* vb = valid + (size_t)blockIdx.x * G;

  // valid rows first, each part in GT order (a stable sort)
  if (tid == 0) {
    int k = 0;
    for (int g = 0; g < G; ++g) if (vb[g]) order[k++] = g;
    scalars[0] = k;
    for (int g = 0; g < G; ++g) if (!vb[g]) order[k++] = g;
  }
  for (int j = tid; j <= m; j += kThreads) { v[j] = 0.f; p[j] = 0; winner[j] = n + 1; }
  for (int r = tid; r <= n; r += kThreads) { u[r] = 0.f; claim[r] = 0; }
  __syncthreads();
  const int n_rows = scalars[0];

  // 1. row reduction: a warp a row; the virtual column 0 holds INF
  for (int r = 1 + warp; r <= n_rows; r += kWarps) {
    const float* row = C + (size_t)order[r - 1] * Q;
    float bv = kInf;
    int bi = 0;
    for (int j = 1 + lane; j <= m; j += 32) {
      const float c = row[j - 1];
      if (before(c, j, bv, bi)) { bv = c; bi = j; }
    }
    warp_argmin(bv, bi);
    if (lane == 0) {
      u[r] = isfinite(bv) ? bv : 0.f;
      amin[r] = bi;
      atomicMin(&winner[bi], r);   // the lowest row wins a column
    }
  }
  __syncthreads();
  for (int r = 1 + tid; r <= n_rows; r += kThreads) {
    if (winner[amin[r]] == r) { claim[r] = 1; p[amin[r]] = r; }
  }
  __syncthreads();
  if (tid == 0) {
    int k = 0;
    for (int r = 1; r <= n_rows; ++r) if (!claim[r]) free_rows[k++] = r;
    scalars[1] = k;
  }
  __syncthreads();
  const int n_free = scalars[1];

  // 2. a Dijkstra and an augmentation for each free row
  bool over = false;
  for (int k = 0; k < n_free; ++k) {
    const int i = free_rows[k];
    for (int j = tid; j <= m; j += kThreads) { minv[j] = kInf; used[j] = 0; way[j] = 0; }
    for (int r = tid; r <= n; r += kThreads) rowmask[r] = 0;
    if (tid == 0) p[0] = i;
    __syncthreads();
    int j0 = 0;
    bool done = false;
    for (int it = 0; it <= m && !done; ++it) {
      const int i0 = p[j0];              // >= 1: column 0 holds i, others end the loop at 0
      const float ui0 = u[i0];
      const float* row = C + (size_t)order[i0 - 1] * Q;
      float bv = INFINITY;
      int bi = INT32_MAX;
      for (int j = tid; j <= m; j += kThreads) {
        const bool uj = used[j] || j == j0;
        if (j == j0) used[j] = 1;
        float cand = kInf;
        if (j > 0) {
          float mv = minv[j];
          if (!uj) {
            const float cur = (row[j - 1] - ui0) - v[j];
            if (cur < mv) { mv = cur; minv[j] = cur; way[j] = j0; }
            cand = mv;
          }
        }
        if (before(cand, j, bv, bi)) { bv = cand; bi = j; }
      }
      block_argmin(bv, bi, red_v, red_i);
      const int j1 = bi;
      const float delta = bv;
      for (int r = tid; r <= n; r += kThreads) {
        const bool rm = rowmask[r] || r == i0;
        if (r == i0) rowmask[r] = 1;
        if (rm) u[r] = u[r] + delta;
      }
      for (int j = tid; j <= m; j += kThreads) {
        if (used[j]) v[j] = v[j] - delta;
        else minv[j] = minv[j] - delta;
      }
      __syncthreads();
      j0 = j1;
      done = p[j0] == 0;
    }
    if (done) {
      if (tid == 0) {   // augment along the alternating path
        for (int s = 0; j0 != 0 && s <= m; ++s) {
          const int j1 = way[j0];
          p[j0] = p[j1];
          j0 = j1;
        }
      }
    } else {
      over = true;      // the row stays unassigned
    }
    __syncthreads();
  }

  // 3. p inverted to a query per sorted row, scattered back to the GT order
  for (int r = tid; r <= n; r += kThreads) amin[r] = m;
  __syncthreads();
  for (int j = 1 + tid; j <= m; j += kThreads) {
    if (p[j] != 0) amin[p[j]] = j - 1;
  }
  __syncthreads();
  int64_t* ob = out + (size_t)blockIdx.x * G;
  for (int k = tid; k < n; k += kThreads) {
    const int g = order[k];
    ob[g] = vb[g] ? (int64_t)min(amin[k + 1], m) : (int64_t)m;
  }
  if (tid == 0) overflow[blockIdx.x] = over ? 1 : 0;
}

}  // namespace

extern "C" {

// cost: (N, G, Q) f32 contiguous; valid: (N, G) u8; assigned: (N, G) int64;
// overflow: (N,) u8 (a torch.bool tensor).  Returns a cudaError_t
// (0 = launched).
int lsap_f32(const void* cost, const void* valid, void* assigned, void* overflow,
             int N, int G, int Q, void* stream) {
  if (N <= 0) return 0;
  const size_t bytes = smem_bytes(G, Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  lsap_kernel<<<N, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(valid),
      static_cast<int64_t*>(assigned), static_cast<uint8_t*>(overflow), G, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
