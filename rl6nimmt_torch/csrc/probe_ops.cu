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
// Forms: k1 and k6 give each game 16 threads of 4 output units (16 games a
// block of 256, so 128 games spread over 8 SMs rather than one thread per
// game on one SM); the block stages W1 and its games' columns of C in shared
// memory in one round of 16-byte loads (at F = 47 four a thread, all in
// flight at once), then each thread sums its units over F in order; k3
// reduces with a warp-shuffle argmax that keeps the first maximum (one warp
// per row, its row read 16 bytes a lane, one row a block while the rows fit
// the card's first wave); k7 computes the one dot product its mask leaves, 8
// lanes a row (probe_k7_kernel); k4 is a direct copy, 16 bytes a thread; k2
// and k5 move a panel of 16 input columns over all input rows (up to 256)
// through shared memory: the panel's loads are 16 bytes a thread along each
// input row, and its output rows are one contiguous run, stored 16 bytes a
// thread whatever the row length (k5's rows are 47 floats, so square 32 x 32
// tiles would leave the second tile over F 15/32 full and store 4 bytes a
// thread).
//
// Bound on the H100: bytes, and every body moves under 0.5 MB at the probe's
// shapes (inputs read once, output written once: k1 68.9 KB, k2 16.4 KB, k3
// 53.8 KB, k4 8.2 KB, k5 385 KB, k6 467 KB; k7 297 KB, the h rows of its
// in-range hands, hand, out and one wa column a distinct hand), 0.002-0.14
// us at 3.35 TB/s.  A launch costs microseconds, so they are launch-bound.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int DOT_K = 64;  // width of the dot probes' weight rows (the hidden width)
constexpr int DOT_THREADS = 256;
constexpr int DOT_QUADS = DOT_K / 4;                  // threads a game: 4 output units each
constexpr int DOT_GAMES = DOT_THREADS / DOT_QUADS;    // games a block
constexpr int PANEL = 16;         // transpose: input columns (= output rows) a block
constexpr int PANEL_ROWS = 256;   // transpose: input rows a block at most
constexpr int PANEL_THREADS = 256;
constexpr int COPY_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

constexpr int STAGE_QUADS = 4;  // 16-byte loads a thread has in flight at once while staging

// Rows x width floats at src (row stride ld) bound for shared memory at dst
// (row stride dld); `quads` when the rows allow 16-byte loads.
struct Rows2D {
  float* dst;
  const float* src;
  size_t ld;
  int dld, per_row, n;
  bool quads;

  __device__ Rows2D(float* d, int dld_, const float* s, size_t ld_, int rows, int width)
      : dst(d), src(s), ld(ld_), dld(dld_),
        quads((width & 3) == 0 && (ld_ & 3) == 0 && (dld_ & 3) == 0 && aligned16(s)) {
    per_row = quads ? width / 4 : width;
    n = rows * per_row;
  }
  __device__ __forceinline__ float4 load(int q) const {
    const float* at = src + (q / per_row) * ld;
    return quads ? *reinterpret_cast<const float4*>(at + q % per_row * 4) : float4{at[q % per_row], 0.f, 0.f, 0.f};
  }
  __device__ __forceinline__ void store(int q, float4 v) const {
    float* to = dst + (q / per_row) * dld;
    if (quads) *reinterpret_cast<float4*>(to + q % per_row * 4) = v;
    else to[q % per_row] = v.x;
  }
};

// Stage a and then b (one sequence of units) into shared memory in rounds of
// STAGE_QUADS loads a thread, all started before any of their stores, so the
// block waits for device memory once a round.
__device__ __forceinline__ void stage_rows(const Rows2D& a, const Rows2D& b) {
  const int n = a.n + b.n;
  for (int base = 0; base < n; base += STAGE_QUADS * blockDim.x) {
    float4 v[STAGE_QUADS];
#pragma unroll
    for (int j = 0; j < STAGE_QUADS; ++j) {
      const int q = base + threadIdx.x + j * blockDim.x;
      if (q < n) v[j] = q < a.n ? a.load(q) : b.load(q - a.n);
    }
#pragma unroll
    for (int j = 0; j < STAGE_QUADS; ++j) {
      const int q = base + threadIdx.x + j * blockDim.x;
      if (q < a.n) a.store(q, v[j]);
      else if (q < n) b.store(q - a.n, v[j]);
    }
  }
}

// out[g, k] = sum_f c[f, g] * w[f, k] for a block of 16 games: w [F][64] and
// the games' columns of c [F][16] staged in shared memory, then thread (game,
// quad) sums units 4 * quad .. + 3 over f in order, one fmaf a term.
__device__ __forceinline__ void dot_units(const float* __restrict__ c, const float* __restrict__ w,
                                          float* __restrict__ out, int F, int N) {
  extern __shared__ float4 s_dot[];  // w [F][DOT_K], then c [F][DOT_GAMES]
  float* s_w = reinterpret_cast<float*>(s_dot);
  float* s_c = s_w + F * DOT_K;
  const int g0 = blockIdx.x * DOT_GAMES, ng = min(DOT_GAMES, N - g0);
  stage_rows(Rows2D(s_w, DOT_K, w, DOT_K, F, DOT_K), Rows2D(s_c, DOT_GAMES, c + g0, N, F, ng));
  __syncthreads();
  const int gi = threadIdx.x / DOT_QUADS, q = threadIdx.x % DOT_QUADS;
  if (gi >= ng) return;
  float4 acc{0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int f = 0; f < F; ++f) {
    const float x = s_c[f * DOT_GAMES + gi];
    const float4 wv = reinterpret_cast<const float4*>(s_w + f * DOT_K)[q];
    acc.x = fmaf(x, wv.x, acc.x);
    acc.y = fmaf(x, wv.y, acc.y);
    acc.z = fmaf(x, wv.z, acc.z);
    acc.w = fmaf(x, wv.w, acc.w);
  }
  float* o = out + (size_t)(g0 + gi) * DOT_K + 4 * q;
  if (aligned16(out)) {
    *reinterpret_cast<float4*>(o) = acc;
  } else {
    o[0] = acc.x;
    o[1] = acc.y;
    o[2] = acc.z;
    o[3] = acc.w;
  }
}

// out[C, R] = in[R, C]^T on 32-bit words.  Block (x, y) moves input rows
// [y * PANEL_ROWS, +256) of columns [x * PANEL, +16) through a [256][17] tile.
__device__ __forceinline__ void transpose_panel(const int* __restrict__ in, int* __restrict__ out,
                                                int R, int C) {
  __shared__ int tile[PANEL_ROWS][PANEL + 1];
  const int c0 = blockIdx.x * PANEL, r0 = blockIdx.y * PANEL_ROWS;
  const int cols = min(PANEL, C - c0), rows = min(PANEL_ROWS, R - r0);
  if ((C & 3) == 0 && aligned16(in)) {  // then c0 + j and cols are multiples of 4 too
    const int quads = cols / 4;
    for (int q = threadIdx.x; q < rows * quads; q += blockDim.x) {
      const int i = q / quads, j = q % quads * 4;
      const int4 v = *reinterpret_cast<const int4*>(in + (size_t)(r0 + i) * C + c0 + j);
      tile[i][j] = v.x;
      tile[i][j + 1] = v.y;
      tile[i][j + 2] = v.z;
      tile[i][j + 3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
      tile[e / cols][e % cols] = in[(size_t)(r0 + e / cols) * C + c0 + e % cols];
  }
  __syncthreads();
  if (rows == R) {  // the panel's output rows are whole: one run of cols * R words
    int* run = out + (size_t)c0 * R;
    const int n = cols * R;
    int e0 = 0;
    if (aligned16(run)) {
      e0 = n & ~3;
      for (int e = 4 * threadIdx.x; e < e0; e += 4 * blockDim.x) {
        const int4 v{tile[e % R][e / R], tile[(e + 1) % R][(e + 1) / R],
                     tile[(e + 2) % R][(e + 2) / R], tile[(e + 3) % R][(e + 3) / R]};
        *reinterpret_cast<int4*>(run + e) = v;
      }
    }
    for (int e = e0 + threadIdx.x; e < n; e += blockDim.x) run[e] = tile[e % R][e / R];
  } else {  // R > PANEL_ROWS: each output row's share, coalesced along it
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
      out[(size_t)(c0 + e / rows) * R + r0 + e % rows] = tile[e % rows][e / rows];
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

__global__ void __launch_bounds__(DOT_THREADS) probe_k1_kernel(const float* c, const float* w, float* out, int F,
                                                               int N) {
  dot_units(c, w, out, F, N);
}

__global__ void __launch_bounds__(PANEL_THREADS) probe_k2_kernel(const int* in, int* out, int R, int C) {
  transpose_panel(in, out, R, C);
}

// One warp per row: lanes take 4 columns each, 16 bytes a load where the rows
// allow it (A % 4 == 0), else one column each; then shuffle.
__global__ void probe_k3_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int A) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const float* xr = x + (size_t)row * A;
  float best = -FLT_MAX;
  int idx = INT_MAX;
  if ((A & 3) == 0 && aligned16(x)) {
    for (int j = 4 * lane; j < A; j += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      first_max(v.x, j, best, idx);
      first_max(v.y, j + 1, best, idx);
      first_max(v.z, j + 2, best, idx);
      first_max(v.w, j + 3, best, idx);
    }
  } else {
    for (int j = lane; j < A; j += 32) first_max(xr[j], j, best, idx);
  }
  idx = warp_first_argmax(best, idx);
  if (lane == 0) out[row] = idx;
}

// A direct copy: 16 bytes a thread when both ends are aligned, then the tail.
__global__ void __launch_bounds__(COPY_THREADS) probe_k4_kernel(const int* __restrict__ in,
                                                                int* __restrict__ out, int n) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  int i0 = 0;
  if (aligned16(in) && aligned16(out)) {
    i0 = n & ~3;
    for (int q = tid; 4 * q < i0; q += stride)
      reinterpret_cast<int4*>(out)[q] = reinterpret_cast<const int4*>(in)[q];
  }
  for (int i = i0 + tid; i < n; i += stride) out[i] = in[i];
}

__global__ void __launch_bounds__(PANEL_THREADS) probe_k5_kernel(const float* in, float* out, int F, int N) {
  transpose_panel(reinterpret_cast<const int*>(in), reinterpret_cast<int*>(out), F, N);
}

__global__ void __launch_bounds__(DOT_THREADS) probe_k6_kernel(const float* s, const float* w, float* out, int F,
                                                               int N) {
  dot_units(s, w, out, F, N);
}

// k7 computes out[s, l] = first argmax_a where(a == hand, (h @ wa)[s, l, a],
// -1e9): every column but hand[s, l] is -1e9, so the result depends on the
// one dot product v = h[s, l] . wa[:, hand] alone (k7_rule below).  A group
// of K7_LANES = 8 lanes a row: each lane loads 8 of the row's 64 h values
// (two 16-byte loads, so a row is 256 contiguous bytes and a warp reads four
// rows' 1 KB; scalar loads for an h off a 16-byte boundary), gathers its 8
// weights wa[k, hand] straight from memory (26.6 KB at A=104, resident in L1
// and L2) and does 8 FMAs; three xor shuffles sum the group, and its first
// lane applies the rule and stores.  A row whose hand lies outside [0, A)
// reads nothing of h or wa.
//
// k7_rule: argmax's answer on such a row (torch.argmax and jnp.argmax both
// take the first maximum and treat NaN as the largest value):
//   hand,  if 0 <= hand < A and (v > -1e9 or v is NaN);
//   1,     if hand == 0, A > 1 and v < -1e9 (column 1's -1e9 is the maximum);
//   0,     otherwise: hand outside [0, A), v == -1e9 (a tie goes to column 0),
//          v < -1e9 with hand != 0, or A == 1.
__device__ __forceinline__ int k7_rule(float v, int hand, int A) {
  const float masked = -1e9f;
  if (hand < 0 || hand >= A) return 0;
  if (v > masked || v != v) return hand;
  return v < masked && hand == 0 && A > 1 ? 1 : 0;
}

constexpr int K7_LANES = 8;                 // lanes a row
constexpr int K7_PER_LANE = DOT_K / K7_LANES;  // h values a lane
constexpr int K7_THREADS = 128;

__global__ void __launch_bounds__(K7_THREADS)
    probe_k7_kernel(const float* __restrict__ h, const float* __restrict__ wa, const int* __restrict__ hand,
                    int* __restrict__ out, int N, int A) {
  const int tid = blockIdx.x * K7_THREADS + threadIdx.x;
  const int row = tid / K7_LANES, sub = tid % K7_LANES;
  const bool live = row < N;  // every lane takes part in the shuffles
  const int legal = live ? hand[row] : -1;
  float v = 0.f;
  if (legal >= 0 && legal < A) {
    const float* hr = h + (size_t)row * DOT_K + K7_PER_LANE * sub;
    float x[K7_PER_LANE];
    if (aligned16(h)) {
      const float4 a = *reinterpret_cast<const float4*>(hr), b = *reinterpret_cast<const float4*>(hr + 4);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < K7_PER_LANE; ++i) x[i] = hr[i];
    }
    const float* wc = wa + (size_t)K7_PER_LANE * sub * A + legal;
#pragma unroll
    for (int i = 0; i < K7_PER_LANE; ++i) v = fmaf(x[i], wc[(size_t)i * A], v);
  }
#pragma unroll
  for (int m = K7_LANES / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  if (live && sub == 0) out[row] = k7_rule(v, legal, A);
}

int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

dim3 panels(int R, int C) { return dim3(blocks_for(C, PANEL), blocks_for(R, PANEL_ROWS)); }

// The dots' shared memory: w [F][64] and c [F][16] floats; above 48 KB the
// kernel is allowed it first.
template <class Kernel>
int launch_dot(Kernel kernel, const void* c, const void* w, void* out, int F, int N, void* stream) {
  const size_t smem = sizeof(float) * F * (DOT_K + DOT_GAMES);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks_for(N, DOT_GAMES), DOT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)c, (const float*)w, (float*)out, F, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rl6_probe_k1(const void* c, const void* w, void* out, int F, int N, void* stream) {
  return launch_dot(probe_k1_kernel, c, w, out, F, N, stream);
}

extern "C" int rl6_probe_k2(const void* in, void* out, int R, int C, void* stream) {
  probe_k2_kernel<<<panels(R, C), PANEL_THREADS, 0, (cudaStream_t)stream>>>((const int*)in,
                                                                             (int*)out, R, C);
  return (int)cudaGetLastError();
}

// One row a block: an SM holds 32 such blocks, so up to 4224 rows are one wave
// with every row on its own warp slot; beyond that 4 rows a block.
extern "C" int rl6_probe_k3(const void* x, void* out, int N, int A, void* stream) {
  const int rows = N <= 4224 ? 1 : 4;
  probe_k3_kernel<<<blocks_for(N, rows), 32 * rows, 0, (cudaStream_t)stream>>>((const float*)x,
                                                                               (int*)out, N, A);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k4(const void* in, void* out, int n, void* stream) {
  probe_k4_kernel<<<blocks_for(n, 4 * COPY_THREADS), COPY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k5(const void* in, void* out, int F, int N, void* stream) {
  probe_k5_kernel<<<panels(F, N), PANEL_THREADS, 0, (cudaStream_t)stream>>>((const float*)in,
                                                                             (float*)out, F, N);
  return (int)cudaGetLastError();
}

extern "C" int rl6_probe_k6(const void* s, const void* w, void* out, int F, int N, void* stream) {
  return launch_dot(probe_k6_kernel, s, w, out, F, N, stream);
}

extern "C" int rl6_probe_k7(const void* h, const void* wa, const void* hand, void* out, int N,
                            int A, void* stream) {
  if (N <= 0) return 0;
  probe_k7_kernel<<<blocks_for((long long)N * K7_LANES, K7_THREADS), K7_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)wa, (const int*)hand, (int*)out, N, A);
  return (int)cudaGetLastError();
}
