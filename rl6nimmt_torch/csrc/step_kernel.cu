// K1: one simultaneous turn of 6 nimmt! for G games, in two layouts.
//
// Replaces: rl6nimmt_tpu/ops/step_kernel.py:_turn_kernel (with _row_aggregates
// and _apply_subplay), built by _make_resolvers into both of its entries:
// resolve (row-major board [G, R, T], make_turn_resolver) and resolve_t
// (games-last board [R*T, G], make_turn_resolver_t).
//
// Bound on the H100: bytes.  Per game it reads the board (R*T int32), the row
// lengths (R) and the actions (P) and writes the board, the row lengths and the
// rewards (P): 2 * 4 * (R*T + R + P) = 256 bytes at P=4, R=4, T=6, 1.05 MB at
// G=4096, 0.31 us at 3.35 TB/s.  What it computes is a serial chain per game
// (P sub-plays, each a scan over the R rows), so the launch and the latency of
// one load-compute-store pass set its time, not the bytes.
//
// Design (Hopper).  A block holds GAMES = 32 games, so G=4096 is 128 blocks:
// one wave over the 132 SMs.  Each game's state lives in its own slice of
// shared memory -- board cells, row lengths, actions, rewards, the sort
// scratch and the row aggregates (game.cuh Rows) -- whose stride is an odd
// number of words, so the 32 threads of warp 0, each playing one game, hit 32
// distinct banks; nothing is indexed at run time in registers, so nothing goes
// to local memory.  game.cuh's row_aggregates and resolve_plays run on that
// state: the P plays sorted by card, the row with the highest last card below
// it or, on an undercut, the cheapest row (first minimum), the capture at the
// threshold.  All THREADS = 256 threads of the block move the games in and
// out, and each first starts every load it has, then stores what it loaded
// into the slices, so the block waits for device memory once:
//   * row-major: a block's games are one contiguous run of each [G, n] array
//     (32 x 24 words of board at the flagship shape), copied 16 bytes a thread
//     where the run is 16-byte aligned (always, unless the caller passes a view
//     at an odd offset, which is copied a word at a time);
//   * games-last: warp w's lane g reads and writes word g of the block's
//     segment of a row of the [n, G] arrays: one coalesced 128-byte line a
//     warp access.
// The actions [G, P] are row-major in both entries and staged as a row-major
// run.  (P, R, T) are template arguments for the flagship shape (4, 4, 6),
// where every loop unrolls and a thread stages one 16-byte quad; any other
// shape the wrapper accepts (P <= 16, R <= 8, T <= 8) runs the instance with
// runtime sizes.  At the flagship shape that instance takes 1.4x the device
// time of the constant one (0.0081-0.0084 against 0.0057-0.0060 ms a launch at
// G=4096 on an H100 80GB HBM3, 700 W; experiments/kernel_times.py), so both stay.
#include <cuda_runtime.h>

#include <cstdint>

#include "game.cuh"

namespace {

constexpr int GAMES = 32;     // games a block; warp 0 plays them, a thread each
constexpr int THREADS = 256;  // threads a block: all of them stage the games
constexpr int ROWS_WORDS = sizeof(rl6::Rows) / sizeof(int);

static_assert(sizeof(rl6::Rows) % sizeof(int) == 0, "Rows is a block of ints");

// Word offsets of one game's slice of shared memory; the stride is odd.  The
// row lengths follow the board cells, so a games-last row i < R*T + R is slot i.
struct Slots {
  int board, len, acts, rew, cards, players, rows, stride;

  __host__ __device__ explicit Slots(const rl6::Cfg& c)
      : board(0),
        len(c.R * c.T),
        acts(len + c.R),
        rew(acts + c.P),
        cards(rew + c.P),
        players(cards + c.P),
        rows(players + c.P),
        stride((rows + ROWS_WORDS) | 1) {}
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A block's share of a row-major [G, n] array: its ng games' runs of n words,
// one contiguous run at `words` (device memory), whose word i belongs in slot
// `off` + i % n of game i / n.  `quads` counts its 16-byte quads when it is
// 16-byte aligned, else 0: then every word is moved on its own.
struct Run {
  int* words;
  int n, off, count, quads;

  __device__ Run(const int* w, int n_, int off_, int ng)
      : words(const_cast<int*>(w)), n(n_), off(off_), count(ng * n_),
        quads(aligned16(w) ? ng * n_ / 4 : 0) {}

  __device__ __forceinline__ int slot(int stride, int i) const { return (i / n) * stride + off + i % n; }
};

// Quad q of runs[0..kRuns) taken in turn: its run r (-1 past the last) and its index there.
template <int kRuns>
__device__ __forceinline__ int locate(const Run (&runs)[kRuns], int& q) {
  int r = -1;
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    if (r < 0 && q < runs[k].quads) r = k;
    if (r < 0) q -= runs[k].quads;
  }
  return r;
}

// Field-by-field select of runs[r] (a runtime index into the array would put it in local memory).
template <int kRuns>
__device__ __forceinline__ Run pick(const Run (&runs)[kRuns], int r) {
  Run out = runs[0];
#pragma unroll
  for (int k = 1; k < kRuns; ++k)
    if (r == k) out = runs[k];
  return out;
}

// The runs into the game slices.  Each thread holds at most kQuads quads: it
// starts all their 16-byte loads, then the words past the quads, and only then
// stores, so the block waits for device memory once.
template <int kQuads, int kRuns>
__device__ __forceinline__ void stage_in(int* s, int stride, const Run (&runs)[kRuns]) {
  int4 v[kQuads];
  int which[kQuads], at[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    at[j] = threadIdx.x + j * THREADS;
    which[j] = locate(runs, at[j]);
    if (which[j] >= 0) {
      const Run r = pick(runs, which[j]);
      v[j] = *reinterpret_cast<const int4*>(r.words + 4 * at[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRuns; ++k)
    for (int i = 4 * runs[k].quads + threadIdx.x; i < runs[k].count; i += THREADS)
      s[runs[k].slot(stride, i)] = runs[k].words[i];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    if (which[j] < 0) continue;
    const Run r = pick(runs, which[j]);
    const int i = 4 * at[j];
    s[r.slot(stride, i)] = v[j].x;
    s[r.slot(stride, i + 1)] = v[j].y;
    s[r.slot(stride, i + 2)] = v[j].z;
    s[r.slot(stride, i + 3)] = v[j].w;
  }
}

// The game slices back into a run; 16-byte stores where it is aligned.
__device__ __forceinline__ void stage_out(const Run& r, const int* s, int stride) {
  for (int q = threadIdx.x; q < r.quads; q += THREADS) {
    const int i = 4 * q;
    *reinterpret_cast<int4*>(r.words + i) =
        int4{s[r.slot(stride, i)], s[r.slot(stride, i + 1)], s[r.slot(stride, i + 2)], s[r.slot(stride, i + 3)]};
  }
  for (int i = 4 * r.quads + threadIdx.x; i < r.count; i += THREADS) r.words[i] = s[r.slot(stride, i)];
}

// Quads a thread stages at most (the row-major runs of board, lengths and
// actions), and games-last words a thread loads at most (board and lengths).
template <int kP, int kR, int kT>
struct Per {
  static constexpr int P = kP ? kP : rl6::MAX_P, R = kP ? kR : rl6::MAX_R, T = kP ? kT : rl6::MAX_T;
  static constexpr int quads = (GAMES * (R * T + R + P) / 4 + THREADS - 1) / THREADS;
  static constexpr int cells = (GAMES * (R * T + R) + THREADS - 1) / THREADS;
};

// Row-major: board [G, R*T], row_len [G, R], rewards [G, P].  Games-last:
// board [R*T, G], row_len [R, G], rewards [P, G].  Actions [G, P] in both.
template <bool kGamesLast, int kP, int kR, int kT>
__global__ void __launch_bounds__(THREADS)
    resolve_turn_kernel(const int* __restrict__ board, const int* __restrict__ row_len,
                        const int* __restrict__ actions, int* __restrict__ board_out,
                        int* __restrict__ len_out, int* __restrict__ rewards_out, int G,
                        rl6::Cfg runtime_cfg) {
  using Sizes = Per<kP, kR, kT>;
  rl6::Cfg c = runtime_cfg;
  if constexpr (kP > 0) c = rl6::Cfg{kP, kR, kT, 0, 0, 0};
  extern __shared__ int smem[];
  const Slots k(c);
  const int RT = c.R * c.T;
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, G - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if constexpr (kGamesLast) {
    const Run acts[1] = {Run(actions + (size_t)g0 * c.P, c.P, k.acts, ng)};
    int v[Sizes::cells];
#pragma unroll
    for (int j = 0; j < Sizes::cells; ++j) {  // row i of board_t, then of row_len_t
      const int i = warp + j * (THREADS / 32);
      if (i < RT + c.R && lane < ng)
        v[j] = i < RT ? board[(size_t)i * G + g0 + lane] : row_len[(size_t)(i - RT) * G + g0 + lane];
    }
    stage_in<1>(smem, k.stride, acts);
#pragma unroll
    for (int j = 0; j < Sizes::cells; ++j) {
      const int i = warp + j * (THREADS / 32);
      if (i < RT + c.R && lane < ng) smem[lane * k.stride + i] = v[j];
    }
  } else {
    const Run runs[3] = {Run(board + (size_t)g0 * RT, RT, k.board, ng),
                         Run(row_len + (size_t)g0 * c.R, c.R, k.len, ng),
                         Run(actions + (size_t)g0 * c.P, c.P, k.acts, ng)};
    stage_in<Sizes::quads>(smem, k.stride, runs);
  }
  __syncthreads();

  if (threadIdx.x < ng) {  // warp 0: one game a thread
    int* game = smem + threadIdx.x * k.stride;
    rl6::Rows& a = *reinterpret_cast<rl6::Rows*>(game + k.rows);
    rl6::row_aggregates(c, game + k.board, game + k.len, a);
    rl6::resolve_plays(c, game + k.board, a, game + k.acts, game + k.rew, game + k.cards,
                       game + k.players);
    for (int r = 0; r < c.R; ++r) game[k.len + r] = a.len[r];
  }
  __syncthreads();

  if constexpr (kGamesLast) {
    for (int i = warp; i < RT + c.R + c.P; i += THREADS / 32) {
      if (lane >= ng) continue;
      const int* game = smem + lane * k.stride;
      const size_t at = (size_t)g0 + lane;
      if (i < RT + c.R) {
        if (i < RT) board_out[(size_t)i * G + at] = game[i];
        else len_out[(size_t)(i - RT) * G + at] = game[i];
      } else {
        rewards_out[(size_t)(i - RT - c.R) * G + at] = game[k.rew + i - RT - c.R];
      }
    }
  } else {
    stage_out(Run(board_out + (size_t)g0 * RT, RT, k.board, ng), smem, k.stride);
    stage_out(Run(len_out + (size_t)g0 * c.R, c.R, k.len, ng), smem, k.stride);
    stage_out(Run(rewards_out + (size_t)g0 * c.P, c.P, k.rew, ng), smem, k.stride);
  }
}

template <bool kGamesLast>
int launch(const void* board, const void* row_len, const void* actions, void* board_out,
           void* len_out, void* rewards_out, int G, int P, int R, int T, void* stream) {
  if (G <= 0) return 0;
  if (P < 1 || P > rl6::MAX_P || R < 1 || R > rl6::MAX_R || T < 1 || T > rl6::MAX_T)
    return (int)cudaErrorInvalidValue;
  const rl6::Cfg c{P, R, T, 0, 0, 0};
  const size_t smem = sizeof(int) * GAMES * Slots(c).stride;
  const int blocks = (G + GAMES - 1) / GAMES;
  auto kernel = (P == 4 && R == 4 && T == 6) ? &resolve_turn_kernel<kGamesLast, 4, 4, 6>
                                             : &resolve_turn_kernel<kGamesLast, 0, 0, 0>;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)row_len, (const int*)actions, (int*)board_out, (int*)len_out,
      (int*)rewards_out, G, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Games and threads a K1 block: the launch shape, for the reports.
extern "C" int rl6_resolve_games(void) { return GAMES; }
extern "C" int rl6_resolve_threads(void) { return THREADS; }

extern "C" int rl6_resolve_turn(const void* board, const void* row_len, const void* actions,
                                void* board_out, void* len_out, void* rewards_out, int G, int P,
                                int R, int T, void* stream) {
  return launch<false>(board, row_len, actions, board_out, len_out, rewards_out, G, P, R, T, stream);
}

extern "C" int rl6_resolve_turn_t(const void* board_t, const void* row_len_t, const void* actions,
                                  void* board_out_t, void* len_out_t, void* rewards_out_t, int G,
                                  int P, int R, int T, void* stream) {
  return launch<true>(board_t, row_len_t, actions, board_out_t, len_out_t, rewards_out_t, G, P, R,
                      T, stream);
}
