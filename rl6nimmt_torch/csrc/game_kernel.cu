// K2 (deal_games) and K3 (play_random_games).
//
// Replaces: rl6nimmt_tpu/ops/game_kernel.py:_deal_kernel (K2; the deal body is
// _deal_in_kernel with _bitonic_sort_packed and _seed_hash) and
// _selfdeal_game_kernel + _play_turns (K3).
//
// Bound on the H100.  K2: bytes -- it writes the board, row lengths and sorted
// hands, ~1.1 MB at G=4096, P=4 (~0.34 us at 3.35 TB/s); launch latency
// dominates.  K3: integer operations -- its only output is 20 bytes a game,
// while each game costs 21 Philox blocks (44 deal draws + 40 picks), a
// 44-step Fisher-Yates and 40 sub-plays.
//
// Design: one thread per game, 128 threads a block, ragged edge masked.  The
// TPU shuffled with a 24-bit-key bitonic network because its 128-lane
// min/max registers suited that; a GPU thread instead runs a partial
// Fisher-Yates on a 104-byte local deck and draws only the P*H + R = 44
// positions it deals (game.cuh deal()).  K3 then plays 10 turns on the row
// aggregates alone (the board is never materialised): per turn the
// observation checksum term, one Philox draw per seat picking
// (word * count) >> 32 into the sorted hand, the hand shift, an insertion
// sort of the P picks and apply_subplay.  The checksum is integer-valued and
// below 2^24 per game, so the float written at the end is exact.
#include <cuda_runtime.h>

#include "game.cuh"

namespace {

__global__ void deal_games_kernel(uint64_t seed, int* __restrict__ board_out,
                                  int* __restrict__ len_out, int* __restrict__ hands_out, int G,
                                  rl6::Cfg c) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int hands[rl6::MAX_C];
  int seeds[rl6::MAX_R];
  uint8_t deck[rl6::MAX_C];
  rl6::deal(c, seed, (uint32_t)g, hands, seeds, deck);
  const int PH = c.P * c.H;
  for (int i = 0; i < PH; ++i) hands_out[(size_t)g * PH + i] = hands[i];
  for (int r = 0; r < c.R; ++r) {
    int* row = board_out + ((size_t)g * c.R + r) * c.T;
    row[0] = seeds[r];
    for (int t = 1; t < c.T; ++t) row[t] = -1;
    len_out[(size_t)g * c.R + r] = 1;
  }
}

__global__ void play_random_games_kernel(uint64_t seed, int* __restrict__ rewards_out,
                                         float* __restrict__ checksum_out, int G, rl6::Cfg c) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int hands[rl6::MAX_C];
  int seeds[rl6::MAX_R];
  uint8_t deck[rl6::MAX_C];
  rl6::deal(c, seed, (uint32_t)g, hands, seeds, deck);
  rl6::Rows a;
  rl6::seed_aggregates(c, seeds, a);

  int total[rl6::MAX_P];
  for (int p = 0; p < c.P; ++p) total[p] = 0;
  int hand_sum = 0;
  for (int i = 0; i < c.P * c.H; ++i) hand_sum += hands[i];

  rl6::Stream picks(seed, (uint32_t)g, rl6::STREAM_PLAY);
  long long checksum = 0;
  int cards[rl6::MAX_P], players[rl6::MAX_P];
  for (int t = 0; t < c.H; ++t) {
    const int count = c.H - t;
    // Observation checksum: every seat's hand block plus P copies of the
    // game block.  Empty board cells hold -1: board sum = csum - (T - len).
    int len_sum = 0, pts_sum = 0, high_sum = 0, board_sum = 0;
    for (int r = 0; r < c.R; ++r) {
      len_sum += a.len[r];
      pts_sum += a.pts[r];
      high_sum += a.last[r];
      board_sum += a.csum[r];
    }
    board_sum += len_sum - c.R * c.T;
    const int game_block =
        c.include_summaries ? c.P + len_sum + high_sum + pts_sum + board_sum : c.P + board_sum;
    checksum += hand_sum + c.P * game_block;

    for (int p = 0; p < c.P; ++p) {
      int* h = hands + p * c.H;
      const int r = picks.below(count);
      const int pick = h[r];
      for (int i = r; i + 1 < count; ++i) h[i] = h[i + 1];
      h[count - 1] = -1;
      hand_sum -= pick + 1;  // removed card, new -1 pad
      cards[p] = pick;
      players[p] = p;
    }
    rl6::sort_plays(c.P, cards, players);
    for (int i = 0; i < c.P; ++i) total[players[i]] -= rl6::apply_subplay(c, nullptr, a, cards[i]);
  }
  for (int p = 0; p < c.P; ++p) rewards_out[(size_t)g * c.P + p] = total[p];
  checksum_out[g] = (float)checksum;
}

}  // namespace

extern "C" int rl6_deal_games(uint64_t seed, void* board_out, void* len_out, void* hands_out,
                              int G, int P, int R, int T, int H, int C, void* stream) {
  rl6::Cfg c{P, R, T, H, C, 0};
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  deal_games_kernel<<<blocks, rl6::THREADS, 0, (cudaStream_t)stream>>>(
      seed, (int*)board_out, (int*)len_out, (int*)hands_out, G, c);
  return (int)cudaGetLastError();
}

extern "C" int rl6_play_random_games(uint64_t seed, void* rewards_out, void* checksum_out, int G,
                                     int P, int R, int T, int H, int C, int include_summaries,
                                     void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  play_random_games_kernel<<<blocks, rl6::THREADS, 0, (cudaStream_t)stream>>>(
      seed, (int*)rewards_out, (float*)checksum_out, G, c);
  return (int)cudaGetLastError();
}
