// policy_mlp: the action-in-input policy's logits in one launch, from the
// shared state product to the masked logit.
//
// Replaces: no pallas_call.  It ports the jnp forward of the JAX package's
// action-in-input policy (rl6nimmt_tpu/agents/reinforce.py
// action_in_input_heads and the NEG_INF mask of action_in_input_logits) past
// the state product, for a trunk of two linears with ReLU and one 1-wide head.
// For every candidate row (m, s) of cards[M, S] (int32, row stride cs, -1 where
// padded), at one hidden width D (a multiple of 4, at most 112):
//   a     = -1 + 2 * card / den                  (den = 103: the action feature)
//   h1    = relu(shared[m] + a * w0)             f32[D]   (rank-1 first layer)
//   h2    = relu(h1 @ W2 + b2)                   f32[D]
//   logit = h2 . w3 + b3, and NEG_INF where card < 0.
// With save (the autograd path) it also writes h1 and h2 as [M, S, D] each,
// zeros on padded rows: the two tensors autograd would have kept.
//
// Bound on the H100: FFMA.  A live row costs 2 * D * D FLOPs in h1 @ W2
// (20,000 at D = 100) against ~4 bytes of input (its card; shared[m] is
// shared by the S rows of m) and 4 bytes of output, so nothing but the float32
// FMA rate (67 TFLOP/s) bounds it once no hidden activation goes to memory.
// With save, 8 * D bytes a row go out as well (800 at D = 100).
//
// Design (Hopper, float32 FFMA, no tensor cores):
//   * Persistent blocks: as many as fit on the SMs at once (2 an SM at
//     D = 100, 110 KB of shared memory each), each walking one contiguous
//     range of the M * S candidate rows.  W2 (zero-padded to DP = 8 * CT
//     columns), w0, b2 and w3 are staged in shared memory once a block.
//   * Padded rows do no FLOPs: each chunk of NT candidates is tested (one
//     card read a thread, loaded a chunk ahead), a padded one gets NEG_INF at
//     once, and the live ones join the block's list (id, m and action
//     feature; warp ballots and a scan of the warps' counts).  Whenever the
//     list holds TM = 128 rows they are one tile; the block's last rows make
//     one partial tile.
//   * A tile: h1 is built in shared memory k-major (As[k][row], stride
//     LDA = 132 words), lanes along rows, from shared[m] (16-byte loads), the
//     card and w0, with ReLU, rounded as PyTorch's two ops
//     (a * w0, then + shared).  A warp reads all it needs for 8 items before
//     it stores any: a store into shared memory orders every later shared read
//     behind it.  Each of the NT = 16 * CT threads then holds an 8 x 8
//     register tile of h1 @ W2 -- rows 4 rt .. + 3 and 64 + 4 rt .. + 3,
//     columns 4 ct .. + 3 and 4 CT + 4 ct .. + 3 -- and per k reads two
//     float4 of h1 (a warp's three row quads share one wavefront) and two of
//     W2 (14 distinct addresses a warp, two wavefronts, the fewest) for 64
//     FMAs, issued column by column (1.14x the rate of row by row on an H100).
//   * Epilogue in registers: + b2, ReLU, times w3, summed over the thread's 8
//     columns; the CT partial sums of a row meet in shared memory and one
//     thread adds them in column order and adds b3: one float written a row.
//     The sum runs in another order than cuBLAS's (PARITY_TORCH.md section 22).
// One instance: CT = 14 column threads (224 threads a block, DP = 112), so
// D <= 112 and S <= 16; wider nets take the plain ops.  At D = 100, 12 of the
// 112 padded columns are zeros: the FMAs a live row issues are 1.12x its FLOPs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RT = 16;        // row threads: thread rt's rows are 4 rt + i and TM / 2 + 4 rt + i, i < 4
constexpr int RPT = 8;        // rows a thread
constexpr int TM = RT * RPT;  // rows a tile
constexpr int LDA = TM + 4;   // the h1 tile's k stride in words: 16-byte aligned, not a multiple of 32
constexpr int CT = 14;        // column threads: thread ct's columns are 4 ct + j and 4 CT + 4 ct + j, j < 4
constexpr int NT = CT * RT;   // threads a block
constexpr int NW = NT / 32;   // warps a block
constexpr int DP = 8 * CT;    // padded W2 columns
constexpr int MAX_D = DP;
constexpr int MAX_S = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e9f;

static_assert(NT % 32 == 0, "whole warps");
static_assert(4 * RT == TM / 2, "a thread's two row quads split the tile in halves");

struct Layout {
  int D;
  // Float offsets, then int offsets after the floats.
  int b, a, red, w0, b2, w3, list_a, floats;
  int ids, list_m, warp_cnt, pad, ints;

  __host__ __device__ explicit Layout(int D_) : D(D_) {
    b = 0;               // W2, [D][DP], zero past D columns
    a = b + D * DP;      // h1, k-major [D][LDA]
    red = a + D * LDA;   // the row sums' partials, [TM][CT]
    w0 = red + TM * CT;
    b2 = w0 + D;
    w3 = b2 + DP;
    list_a = w3 + DP;               // the listed rows' action features
    floats = list_a + TM + NT;
    ids = 0;                        // the live rows not yet in a tile: their ids (m * S + s)
    list_m = ids + TM + NT;         // and their m
    warp_cnt = list_m + TM + NT;
    pad = warp_cnt + 32;
    ints = pad + NT;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * floats + sizeof(int) * ints; }
};

struct Args {
  const float* shared;  // [M, D]
  const int* cards;     // [M, S], row stride cs
  long long cs;
  int M, S, D;
  const float *w0, *w2, *b2, *w3, *b3;  // [D], [D, D], [D], [D], [1]
  float den;
  float* logits;  // [M, S]
  float* h1;      // [M, S, D] or null
  float* h2;      // [M, S, D] or null
};

__device__ __forceinline__ float a_norm(int card, float den) {
  // -1 + 2 * card / den, rounded op by op as the plain forward.
  return __fadd_rn(-1.0f, __fdiv_rn(__fmul_rn(2.0f, (float)card), den));
}

// Tile row of a thread's accumulator row r < 8.
__device__ __forceinline__ int tile_row(int rt, int r) { return (r < 4 ? 0 : TM / 2 - 4) + 4 * rt + r; }

// One tile of n <= TM live rows, ids[0 .. n).  Ends with a barrier.
__device__ void tile(const Args& g, const Layout& L, float* fs, int* is, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* ids = is + L.ids;
  const int* row_m = is + L.list_m;
  const float* row_a = fs + L.list_a;
  float* As = fs + L.a;
  const float* Bs = fs + L.b;
  const float* w0s = fs + L.w0;
  const bool save = g.h1 != nullptr;

  // h1 = relu(shared[m] + a * w0) into As[k][row]: items of 32 rows (the
  // lanes) by 4 k, one 16-byte load a lane (the S rows of one m read one
  // address).  A warp reads everything BATCH items need (device memory, a, w0)
  // before it stores any: the stores into shared memory would otherwise order
  // every later shared read behind them.  Zeros past n.
  {
    constexpr int GROUPS = TM / 32, BATCH = 8;
    const int items = GROUPS * (g.D / 4);
    for (int first = warp; first < items; first += BATCH * NW) {
      float4 x[BATCH], w[BATCH];
      float a[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int item = first + b * NW, r = (item % GROUPS) * 32 + lane, k = 4 * (item / GROUPS);
        x[b] = w[b] = make_float4(0.f, 0.f, 0.f, 0.f);
        a[b] = 0.f;
        if (item < items) w[b] = *reinterpret_cast<const float4*>(w0s + k);
        if (item < items && r < n) {
          a[b] = row_a[r];
          x[b] = *reinterpret_cast<const float4*>(g.shared + (size_t)row_m[r] * g.D + k);
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int item = first + b * NW, r = (item % GROUPS) * 32 + lane, k = 4 * (item / GROUPS);
        if (item >= items) break;
        float* dst = As + k * LDA + r;
        dst[0] = fmaxf(__fadd_rn(x[b].x, __fmul_rn(a[b], w[b].x)), 0.f);
        dst[LDA] = fmaxf(__fadd_rn(x[b].y, __fmul_rn(a[b], w[b].y)), 0.f);
        dst[2 * LDA] = fmaxf(__fadd_rn(x[b].z, __fmul_rn(a[b], w[b].z)), 0.f);
        dst[3 * LDA] = fmaxf(__fadd_rn(x[b].w, __fmul_rn(a[b], w[b].w)), 0.f);
      }
    }
  }
  __syncthreads();
  if (save) {  // h1 rows out, a warp a row, lanes along k
    for (int r = warp; r < n; r += NW) {
      float* out = g.h1 + (size_t)ids[r] * g.D;
      for (int k = lane; k < g.D; k += 32) out[k] = As[k * LDA + r];
    }
  }

  // h1 @ W2: per k two float4 of h1 (rows 4 rt .. + 3 and TM / 2 + 4 rt .. + 3)
  // and two of W2 (columns 4 ct .. + 3 and 4 CT + 4 ct .. + 3), 64 FMAs.
  const int ct = tid % CT, rt = tid / CT;
  float acc[RPT][8];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const float* a_base = As + 4 * rt;
  const float* b_base = Bs + 4 * ct;
#pragma unroll 4
  for (int k = 0; k < g.D; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_base + k * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a_base + k * LDA + TM / 2);
    const float4 b0 = *reinterpret_cast<const float4*>(b_base + k * DP);
    const float4 b1 = *reinterpret_cast<const float4*>(b_base + k * DP + 4 * CT);
    const float av[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }

  // + b2, ReLU, . w3 over the thread's columns (padded columns add zeros);
  // b2 and w3 are read before the first store, which would order them behind it.
  float b2v[8], w3v[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float4 bq = *reinterpret_cast<const float4*>(fs + L.b2 + 4 * ct + 4 * CT * half);
    const float4 wq = *reinterpret_cast<const float4*>(fs + L.w3 + 4 * ct + 4 * CT * half);
    b2v[4 * half] = bq.x, b2v[4 * half + 1] = bq.y, b2v[4 * half + 2] = bq.z, b2v[4 * half + 3] = bq.w;
    w3v[4 * half] = wq.x, w3v[4 * half + 1] = wq.y, w3v[4 * half + 2] = wq.z, w3v[4 * half + 3] = wq.w;
  }
  float* red = fs + L.red;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float p = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[r][c] = fmaxf(__fadd_rn(acc[r][c], b2v[c]), 0.f);
      p = fmaf(acc[r][c], w3v[c], p);
    }
    red[tile_row(rt, r) * CT + ct] = p;
  }
  if (save) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = tile_row(rt, r);
      if (row >= n) continue;
      float* out = g.h2 + (size_t)ids[row] * g.D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 4 * ct + 4 * CT * half;
        if (col < g.D)
          *reinterpret_cast<float4*>(out + col) =
              make_float4(acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2], acc[r][4 * half + 3]);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < n; i += NT) {
    float sum = 0.f;
    for (int c = 0; c < CT; ++c) sum += red[i * CT + c];
    g.logits[ids[i]] = __fadd_rn(sum, g.b3[0]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 2) policy_mlp_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(g.D);
  float* fs = smem;
  int* is = reinterpret_cast<int*>(smem + L.floats);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool save = g.h1 != nullptr;

  for (int i = tid; i < g.D * DP; i += NT) {
    const int k = i / DP, c = i - k * DP;
    fs[L.b + i] = c < g.D ? g.w2[(size_t)k * g.D + c] : 0.f;
  }
  for (int i = tid; i < g.D; i += NT) fs[L.w0 + i] = g.w0[i];
  for (int i = tid; i < DP; i += NT) {
    fs[L.b2 + i] = i < g.D ? g.b2[i] : 0.f;
    fs[L.w3 + i] = i < g.D ? g.w3[i] : 0.f;
  }
  __syncthreads();

  const int total = g.M * g.S;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per;
  const int r1 = min(total, r0 + per);
  int* ids = is + L.ids;
  int* warp_cnt = is + L.warp_cnt;
  int* pad = is + L.pad;
  int count = 0;  // live rows in the list; the same in every thread

  // Each chunk's cards are loaded one chunk ahead.
  auto card_at = [&](int idx, int m) { return idx < r1 ? g.cards[(long long)m * g.cs + (idx - m * g.S)] : -1; };
  int next_m = (r0 + tid) / g.S, next = card_at(r0 + tid, next_m);
  for (int base = r0; base < r1; base += NT) {
    const int idx = base + tid, card = next, m = next_m;
    next_m = (idx + NT) / g.S;
    next = card_at(idx + NT, next_m);
    const bool in = idx < r1, live = in && card >= 0;
    if (in && !live) g.logits[idx] = NEG_INF;
    const unsigned ballot = __ballot_sync(FULL, live);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    pad[tid] = in && !live;
    __syncthreads();
    int before = count, added = 0;
    for (int w = 0; w < NW; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      added += c;
    }
    if (live) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      ids[at] = idx;
      is[L.list_m + at] = m;
      fs[L.list_a + at] = a_norm(card, g.den);
    }
    const int seen = min(NT, r1 - base);
    if (save && added < seen) {  // zero the padded rows' h1 and h2
      for (int i = tid; i < seen * g.D; i += NT) {
        const int r = i / g.D, k = i - r * g.D;
        if (!pad[r]) continue;
        g.h1[(size_t)(base + r) * g.D + k] = 0.f;
        g.h2[(size_t)(base + r) * g.D + k] = 0.f;
      }
    }
    count += added;
    __syncthreads();
    while (count >= TM) {  // count < TM + NT, so a thread moves at most one leftover row
      tile(g, L, fs, is, TM);
      const int left = count - TM;
      const int keep = tid < left ? ids[TM + tid] : 0, keep_m = tid < left ? is[L.list_m + TM + tid] : 0;
      const float keep_a = tid < left ? fs[L.list_a + TM + tid] : 0.f;
      __syncthreads();
      if (tid < left) {
        ids[tid] = keep;
        is[L.list_m + tid] = keep_m;
        fs[L.list_a + tid] = keep_a;
      }
      count = left;
      __syncthreads();
    }
  }
  if (count > 0) tile(g, L, fs, is, count);
}

constexpr int MAX_DEVICES = 64;

// Blocks that run at once on the current card at width D (the persistent
// grid): its SMs times the blocks an SM holds, asked once a card and D.  The
// kernel's dynamic shared memory limit is raised once a card, to the largest
// width's size, so no width's launch finds it lowered by another's.
int resident_blocks(int D, int* blocks) {
  static int cache[MAX_DEVICES][MAX_D + 1];
  static bool raised[MAX_DEVICES];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cache[device][D] > 0) {
    *blocks = cache[device][D];
    return 0;
  }
  if (!raised[device]) {
    e = cudaFuncSetAttribute(policy_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout(MAX_D).bytes());
    if (e != cudaSuccess) return (int)e;
    raised[device] = true;
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, policy_mlp_kernel, NT, Layout(D).bytes())) !=
          cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  cache[device][D] = *blocks;
  return 0;
}

}  // namespace

extern "C" int rl6_policy_mlp(const void* shared, const void* cards, long long cs, int M, int S, int D,
                              const void* w0, const void* w2, const void* b2, const void* w3, const void* b3,
                              float den, void* logits, void* h1, void* h2, void* stream) {
  if (M <= 0 || S <= 0) return 0;
  if (S > MAX_S || D < 4 || D > MAX_D || D % 4 || (long long)M * S >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Args g{(const float*)shared, (const int*)cards, cs, M, S, D, (const float*)w0, (const float*)w2,
               (const float*)b2, (const float*)w3, (const float*)b3, den, (float*)logits, (float*)h1, (float*)h2};
  int resident = 0;
  if (const int e = resident_blocks(D, &resident)) return e;
  const int tiles = (M * S + TM - 1) / TM;
  policy_mlp_kernel<<<tiles < resident ? tiles : resident, NT, Layout(D).bytes(), (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
