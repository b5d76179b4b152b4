// K2 (deal_games) and K3 (play_random_games).
//
// Replaces: rl6nimmt_tpu/ops/game_kernel.py:_deal_kernel (K2; the deal body is
// _deal_in_kernel with _bitonic_sort_packed and _seed_hash) and
// _selfdeal_game_kernel + _play_turns (K3).
//
// Bound on the H100.  K2: bytes -- it writes the board, row lengths and sorted
// hands, ~1.1 MB at G=4096, P=4 (~0.34 us at 3.35 TB/s).  K3: integer
// operations -- its only output is 20 bytes a game, while each game costs 21
// Philox blocks (44 deal draws + 40 picks), a 44-step Fisher-Yates and 40
// sub-plays.  Neither comes near its bound: what sets the time is the
// dependent chain of one game (the Fisher-Yates swaps, then the turns) and the
// launch.  At 4x the games both take only 1.5-2.3x as long on an H100.
//
// Design (Hopper).  Both deal as random_play.cuh does (32 games and 128
// threads a block, so G=4096 is 128 blocks, one per SM; the partial
// Fisher-Yates of game.cuh's deal() on a deck in shared memory).  The TPU
// shuffled with a 24-bit-key bitonic network because its 128-lane min/max
// registers suited that.
//   K2: one (game, seat) a thread turns the seat's H cards into a card set
//   (game.cuh set_*), so no hand is sorted, and stores each card at slot
//   rank(card) of a shared stage; then all threads write the hands, the board
//   (seed cards, -1 elsewhere) and the row lengths (1) as one contiguous run
//   each, 16 bytes a store over the run's aligned quads.
//   K3: random_play.cuh's play (four lanes a game at the flagship shape, a
//   game's shared slice at every other) with a hook that adds up the
//   observation checksum, whose term a turn is every seat's hand block plus P
//   copies of the game block: hand_sum (the hand block) drops by pick + 1 a
//   pick, and the board is never materialised.  The checksum is
//   integer-valued and below 2^24 per game, so the float written at the end
//   is exact.
// (P, R, T, H, C) are template arguments for the flagship shape (4, 4, 6, 10,
// 104), where every loop over seats, rows and set words unrolls; every other
// shape the wrapper accepts runs the runtime-sized instance.  Neither keeps a
// runtime-indexed local array.
#include <cuda_runtime.h>

#include <cstdint>

#include "game.cuh"
#include "random_play.cuh"

namespace {

using namespace rl6::random_games;

// Words [0, count) of a block's run out of f(i): 16 bytes a store, the last
// count % 4 words one at a time.  `out` is 16-byte aligned: the arrays are
// (the C entry checks) and a block's run starts at word 32 * blockIdx.x * n.
template <class F>
__device__ __forceinline__ void store_run(int* out, int count, const F& f) {
  const int quads = count / 4;
  for (int q = threadIdx.x; q < quads; q += THREADS)
    *reinterpret_cast<int4*>(out + 4 * q) = make_int4(f(4 * q), f(4 * q + 1), f(4 * q + 2), f(4 * q + 3));
  for (int i = 4 * quads + threadIdx.x; i < count; i += THREADS) out[i] = f(i);
}

// Board [G, R, T], row_len [G, R], hands [G, P, H].
template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    deal_games_kernel(uint64_t seed, int* __restrict__ board_out, int* __restrict__ len_out,
                      int* __restrict__ hands_out, int G, rl6::Cfg runtime_cfg) {
  const rl6::Cfg c = sizes<kP, kR, kT, kH, kC>(runtime_cfg);
  const Layout L(c, false, false);
  unsigned char* smem = block_smem();
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, G - g0);
  const int PH = c.P * c.H, RT = c.R * c.T;
  int* hands = reinterpret_cast<int*>(smem + L.hands);
  int* seeds = reinterpret_cast<int*>(smem + L.seeds);

  draw_words_and_decks(L, smem, seed, g0, ng);
  __syncthreads();
  if (threadIdx.x < ng) {
    const int gl = threadIdx.x;
    shuffle_deck<deal_blocks<kP, kR, kH>()>(c, L, smem, gl);
    const uint8_t* deck = smem + L.deck + gl * L.ds;
#pragma unroll
    for (int r = 0; r < c.R; ++r) seeds[gl * L.rs + r] = deck[PH + r];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < c.P * GAMES; q += THREADS) {
    const int gl = q % GAMES, p = q / GAMES;
    if (gl >= ng) continue;
    const uint8_t* deck = smem + L.deck + gl * L.ds;
    uint32_t set[rl6::SET_WORDS];
    seat_set(deck, c.H, p, set);
    int* hand = hands + gl * L.hs + p * c.H;
#pragma unroll
    for (int i = 0; i < c.H; ++i) {
      const int card = deck[p * c.H + i];
      hand[rl6::set_rank(set, card)] = card;
    }
  }
  __syncthreads();

  store_run(hands_out + (size_t)g0 * PH, ng * PH, [&](int i) { return hands[(i / PH) * L.hs + i % PH]; });
  store_run(board_out + (size_t)g0 * RT, ng * RT, [&](int i) {
    const int cell = i % RT;
    return cell % c.T ? -1 : seeds[(i / RT) * L.rs + cell / c.T];
  });
  store_run(len_out + (size_t)g0 * c.R, ng * c.R, [](int) { return 1; });
}

// Observation checksum term of a turn: every seat's hand block plus P copies
// of the game block.  Empty board cells hold -1: board sum = csum - (T - len).
__device__ __forceinline__ int checksum_term(const rl6::Cfg& c, int hand_sum, int len_sum, int pts_sum,
                                             int high_sum, int csum_sum) {
  const int board_sum = csum_sum + len_sum - c.R * c.T;
  const int game_block =
      c.include_summaries ? c.P + len_sum + high_sum + pts_sum + board_sum : c.P + board_sum;
  return hand_sum + c.P * game_block;
}

// The checksum term from a game's rows (the first R of kRows).
template <int kRows>
__device__ __forceinline__ int rows_term(const rl6::Cfg& c, int hand_sum, const int (&len)[kRows],
                                         const int (&pts)[kRows], const int (&last)[kRows],
                                         const int (&csum)[kRows]) {
  int len_sum = 0, pts_sum = 0, high_sum = 0, csum_sum = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= c.R) break;
    len_sum += len[r];
    pts_sum += pts[r];
    high_sum += last[r];
    csum_sum += csum[r];
  }
  return checksum_term(c, hand_sum, len_sum, pts_sum, high_sum, csum_sum);
}

// K3's hook at the flagship shape: lane p adds its hand block to the game's
// checksum each turn, lane 0 also the P game blocks; end() sums the lanes
// with shuffles and stores the seat's total and the checksum.
template <int P>
struct LaneChecksum {
  static constexpr bool kBoard = false, kTerminal = false;
  rl6::Cfg c;
  int p;
  bool live;
  int* rewards;  // the game's P totals
  float* checksum_out;
  long long checksum = 0;

  template <int R>
  __device__ __forceinline__ void observe(int, const uint32_t*, int hand_sum, const int (&len)[R],
                                         const int (&pts)[R], const int (&last)[R], const int (&csum)[R],
                                         const uint64_t (&)[R]) {
    checksum += p == 0 ? rows_term(c, hand_sum, len, pts, last, csum) : hand_sum;
  }
  __device__ __forceinline__ void played(int, int, int) {}
  __device__ __forceinline__ void flush(int) {}
  __device__ __forceinline__ void end(int total) {
#pragma unroll
    for (int m = 1; m < P; m <<= 1) checksum += __shfl_xor_sync(0xFFFFFFFFu, checksum, m);
    if (!live) return;
    rewards[p] = total;
    if (p == 0) *checksum_out = (float)checksum;
  }
};

// K3's hook at a runtime shape: the game's thread adds the whole term.
struct SharedChecksum {
  static constexpr bool kBoard = false, kTerminal = false;
  rl6::Cfg c;
  int* rewards;
  float* checksum_out;
  long long checksum = 0;

  __device__ __forceinline__ void observe(int, const uint32_t*, int hand_sum, const int (&len)[rl6::MAX_R],
                                         const int (&pts)[rl6::MAX_R], const int (&last)[rl6::MAX_R],
                                         const int (&csum)[rl6::MAX_R], const uint64_t (&)[rl6::MAX_R]) {
    checksum += rows_term(c, hand_sum, len, pts, last, csum);
  }
  __device__ __forceinline__ void played(int, const int*, const int*) {}
  __device__ __forceinline__ void flush(int) {}
  __device__ __forceinline__ void end(const int* total) {
    for (int p = 0; p < c.P; ++p) rewards[p] = total[p];
    *checksum_out = (float)checksum;
  }
};

// Rewards [G, P], checksum [G].
template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    play_random_games_kernel(uint64_t seed, int* __restrict__ rewards_out, float* __restrict__ checksum_out,
                             int G, rl6::Cfg runtime_cfg) {
  constexpr bool kConst = kP > 0;
  static_assert(!kConst || kP * GAMES == THREADS, "the flagship instance plays a seat a thread");
  const rl6::Cfg c = sizes<kP, kR, kT, kH, kC>(runtime_cfg);
  const Layout L(c, true, kConst);
  unsigned char* smem = block_smem();
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, G - g0);

  deal_block<deal_blocks<kP, kR, kH>()>(c, L, smem, seed, g0, ng);
  if constexpr (kConst) {
    const int gl = threadIdx.x / kP, g = g0 + gl, p = threadIdx.x % kP;
    LaneChecksum<kP> hook{c, p, gl < ng, rewards_out + (size_t)g * kP, checksum_out + g};
    play_seat_lanes<kP, kR, kT, kH>(c, L, smem, gl, p, hook);
  } else {
    fill_seat_slices(c, L, smem, ng);
    __syncthreads();
    if (threadIdx.x >= ng) return;  // the last barrier is behind
    const int gl = threadIdx.x, g = g0 + gl;
    SharedChecksum hook{c, rewards_out + (size_t)g * c.P, checksum_out + g};
    play_in_shared(c, L, smem, gl, true, seed, (uint32_t)g, hook);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Games and threads a K2/K3 block: the launch shape, for the reports.
extern "C" int rl6_game_games(void) { return GAMES; }
extern "C" int rl6_game_threads(void) { return THREADS; }

extern "C" int rl6_deal_games(uint64_t seed, void* board_out, void* len_out, void* hands_out, int G, int P,
                              int R, int T, int H, int C, void* stream) {
  const rl6::Cfg c{P, R, T, H, C, 0};
  if (!accepted(c) || !aligned16(board_out) || !aligned16(len_out) || !aligned16(hands_out))
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  auto kernel = flagship(c) ? &deal_games_kernel<4, 4, 6, 10, 104> : &deal_games_kernel<0, 0, 0, 0, 0>;
  kernel<<<(G + GAMES - 1) / GAMES, THREADS, Layout(c, false, false).bytes, (cudaStream_t)stream>>>(
      seed, (int*)board_out, (int*)len_out, (int*)hands_out, G, c);
  return (int)cudaGetLastError();
}

extern "C" int rl6_play_random_games(uint64_t seed, void* rewards_out, void* checksum_out, int G, int P, int R,
                                     int T, int H, int C, int include_summaries, void* stream) {
  const rl6::Cfg c{P, R, T, H, C, include_summaries};
  if (!accepted(c)) return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  const bool constant = flagship(c);
  auto kernel = constant ? &play_random_games_kernel<4, 4, 6, 10, 104> : &play_random_games_kernel<0, 0, 0, 0, 0>;
  kernel<<<(G + GAMES - 1) / GAMES, THREADS, Layout(c, true, constant).bytes, (cudaStream_t)stream>>>(
      seed, (int*)rewards_out, (float*)checksum_out, G, c);
  return (int)cudaGetLastError();
}
