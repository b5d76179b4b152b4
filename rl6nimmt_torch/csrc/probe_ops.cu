// K7: the act kernel's building blocks, each as a small CUDA kernel.
//
// Replaces: experiments/probe_pallas_ops.py:probe, which ran seven Pallas
// bodies (k1-k7) to check that the blocks of the TPU act kernel lowered in
// Mosaic.  Here each body is written in the warp-level form a redesign of the
// play loop (act_play.cuh) would use, and checked against its plain twin:
//   k1  C^T @ W1, C f32[F, N] feature-major, W1 f32[F, 64] -> f32[N, 64];
//   k2  int32 transpose [R, C] -> [C, R];
//   k3  argmax over the last axis, f32[N, A] -> int32[N, 1], first maximum;
//   k4  reshape int32[n] -> [rows, n / rows] (a copy);
//   k5  f32[F, S, L] -> transpose (1, 2, 0) -> [S*L, F];
//   k6  f32[F, S, L] x f32[F, 64] contracted over F -> f32[S, L, 64];
//   k7  f32[S, L, 64] @ f32[64, A], masked to the column hand[s, l], argmax
//       -> int32[S, L].
// Forms: k1 and k6 run one warp over 32 games (lane = game, 64 accumulators in
// registers, the weights in shared memory, C read coalesced along the games);
// k3 and k7 reduce with a warp-shuffle argmax that keeps the first maximum
// (one warp per row, lanes striding the columns; k7's lanes take their row's
// hidden values by shuffle); k2, k4 and k5 copy through a shared-memory tile,
// so loads and stores are both coalesced.
//
// Bound on the H100: bytes, and every body moves under 0.5 MB at the probe's
// shapes (inputs read once, output written once: k1 68.9 KB, k2 16.4 KB, k3
// 53.8 KB, k4 8.2 KB, k5 385 KB, k6 467 KB, k7 297 KB), 0.002-0.14 us at
// 3.35 TB/s; the largest product, k7's 13.6 MFLOP, is 0.2 us at 67 TFLOP/s.
// A launch costs microseconds, so they are launch-bound.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int DOT_K = 64;  // width of the dot probes' weight rows (the hidden width)
constexpr int TILE = 32;   // transpose tile: 32 x 32 through shared memory, 32 x 8 threads
constexpr unsigned FULL = 0xffffffffu;

// out[g, k] = sum_f c[f, g] * w[f, k], lane = game; blockDim.x threads.
__device__ __forceinline__ void dot_lanes(const float* __restrict__ c, const float* __restrict__ w,
                                          float* __restrict__ out, int F, int N) {
  extern __shared__ float s_w[];  // [F, DOT_K]
  for (int i = threadIdx.x; i < F * DOT_K; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= N) return;
  float acc[DOT_K];
#pragma unroll
  for (int k = 0; k < DOT_K; ++k) acc[k] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = c[(size_t)f * N + g];
#pragma unroll
    for (int k = 0; k < DOT_K; ++k) acc[k] = fmaf(x, s_w[f * DOT_K + k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < DOT_K; ++k) out[(size_t)g * DOT_K + k] = acc[k];
}

// out[C, R] = in[R, C]^T through a 32 x 33 tile; block (32, 8), grid over 32 x 32 tiles.
template <class T>
__device__ __forceinline__ void transpose_tile(const T* __restrict__ in, T* __restrict__ out,
                                               int R, int C) {
  __shared__ T tile[TILE][TILE + 1];
  const int x = blockIdx.x * TILE + threadIdx.x;  // input column
  const int y0 = blockIdx.y * TILE;                // first input row of the tile
  for (int j = threadIdx.y; j < TILE; j += blockDim.y) {
    const int y = y0 + j;
    if (x < C && y < R) tile[j][threadIdx.x] = in[(size_t)y * C + x];
  }
  __syncthreads();
  const int ox = y0 + threadIdx.x;  // output column = input row
  for (int j = threadIdx.y; j < TILE; j += blockDim.y) {
    const int oy = blockIdx.x * TILE + j;  // output row = input column
    if (ox < R && oy < C) out[(size_t)oy * R + ox] = tile[threadIdx.x][j];
  }
}

// Keep (v, i) against (best, idx): the larger value, the lower index on ties.
__device__ __forceinline__ void first_max(float v, int i, float& best, int& idx) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

// Warp-shuffle reduction of per-lane first maxima; lane 0 ends with the row's.
__device__ __forceinline__ int warp_first_argmax(float best, int idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, idx, off);
    first_max(ob, oi, best, idx);
  }
  return idx;
}

__global__ void probe_k1_kernel(const float* c, const float* w, float* out, int F, int N) {
  dot_lanes(c, w, out, F, N);
}

__global__ void probe_k2_kernel(const int* in, int* out, int R, int C) {
  transpose_tile(in, out, R, C);
}

// One warp per row: lanes stride the A columns, then shuffle.
__global__ void probe_k3_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int A) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  float best = -FLT_MAX;
  int idx = INT_MAX;
  for (int j = lane; j < A; j += 32) first_max(x[(size_t)row * A + j], j, best, idx);
  idx = warp_first_argmax(best, idx);
  if (lane == 0) out[row] = idx;
}

// A contiguous copy through a shared-memory tile of blockDim.x elements.
__global__ void probe_k4_kernel(const int* __restrict__ in, int* __restrict__ out, int n) {
  extern __shared__ int s_buf[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) s_buf[threadIdx.x] = in[i];
  __syncthreads();
  if (i < n) out[i] = s_buf[threadIdx.x];
}

__global__ void probe_k5_kernel(const float* in, float* out, int F, int N) {
  transpose_tile(in, out, F, N);
}

__global__ void probe_k6_kernel(const float* s, const float* w, float* out, int F, int N) {
  dot_lanes(s, w, out, F, N);
}

// One warp per game: lane holds h[lane] and h[lane + 32]; each lane evaluates
// the columns j = lane, lane + 32, ... of the head (weights in shared memory),
// masks every column but hand[game], and the warp shuffles the first maximum.
__global__ void probe_k7_kernel(const float* __restrict__ h, const float* __restrict__ wa,
                                const int* __restrict__ hand, int* __restrict__ out, int N,
                                int A) {
  extern __shared__ float s_wa[];  // [DOT_K, A]
  for (int i = threadIdx.x; i < DOT_K * A; i += blockDim.x) s_wa[i] = wa[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int game = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (game >= N) return;
  const float h_lo = h[(size_t)game * DOT_K + lane];
  const float h_hi = h[(size_t)game * DOT_K + 32 + lane];
  const int legal = hand[game];
  float best = -FLT_MAX;
  int idx = INT_MAX;
  for (int j0 = 0; j0 < A; j0 += 32) {  // every lane takes part in the shuffles
    const int j = j0 + lane;
    float adv = 0.f;
#pragma unroll
    for (int k = 0; k < DOT_K; ++k) {
      const float hk = __shfl_sync(FULL, k < 32 ? h_lo : h_hi, k & 31);
      if (j < A) adv = fmaf(hk, s_wa[k * A + j], adv);
    }
    if (j < A) first_max(j == legal ? adv : -1e9f, j, best, idx);
  }
  idx = warp_first_argmax(best, idx);
  if (lane == 0) out[game] = idx;
}

int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

}  // namespace

extern "C" int rl6_probe_k1(const void* c, const void* w, void* out, int F, int N, void* stream) {
  probe_k1_kernel<<<blocks_for(N, 128), 128, sizeof(float) * F * DOT_K, (cudaStream_t)stream>>>(
      (const float*)c, (const float*)w, (float*)out, F, N);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k2(const void* in, void* out, int R, int C, void* stream) {
  const dim3 grid(blocks_for(C, TILE), blocks_for(R, TILE));
  probe_k2_kernel<<<grid, dim3(TILE, 8), 0, (cudaStream_t)stream>>>((const int*)in, (int*)out, R,
                                                                     C);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k3(const void* x, void* out, int N, int A, void* stream) {
  probe_k3_kernel<<<blocks_for(N, 4), 128, 0, (cudaStream_t)stream>>>((const float*)x, (int*)out,
                                                                      N, A);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k4(const void* in, void* out, int n, void* stream) {
  probe_k4_kernel<<<blocks_for(n, 256), 256, 256 * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k5(const void* in, void* out, int F, int N, void* stream) {
  const dim3 grid(blocks_for(N, TILE), blocks_for(F, TILE));
  probe_k5_kernel<<<grid, dim3(TILE, 8), 0, (cudaStream_t)stream>>>((const float*)in,
                                                                     (float*)out, F, N);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k6(const void* s, const void* w, void* out, int F, int N, void* stream) {
  probe_k6_kernel<<<blocks_for(N, 128), 128, sizeof(float) * F * DOT_K, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)w, (float*)out, F, N);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k7(const void* h, const void* wa, const void* hand, void* out, int N,
                            int A, void* stream) {
  const size_t smem = sizeof(float) * DOT_K * A;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(probe_k7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_k7_kernel<<<blocks_for(N, 8), 256, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)wa, (const int*)hand, (int*)out, N, A);
  return (int)cudaGetLastError();
}
