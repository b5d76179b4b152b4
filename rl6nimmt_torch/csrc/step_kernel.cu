// K1: one simultaneous turn of 6 nimmt! for G games.
//
// Replaces: rl6nimmt_tpu/ops/step_kernel.py:_turn_kernel (with _row_aggregates
// and _apply_subplay), built by _make_resolvers.
//
// Bound on the H100: bytes.  Per game it reads the board (R*T int32), the row
// lengths (R) and the actions (P) and writes the same plus the rewards --
// about 256 bytes at P=4, ~1.05 MB at G=4096, some 0.3 us at 3.35 TB/s.  At
// that size launch latency dominates, not the memory system.
//
// Design: one thread per game, 128 threads a block, ragged edge masked (any G).
// The TPU sorted the cards outside the kernel and laid games on lanes; here a
// thread loads its own game, sorts its P (card, player) pairs with an
// insertion sort, resolves the P sub-plays on per-row aggregate registers
// (game.cuh apply_subplay) and writes board', row_len' and rewards.  The
// row-major [G, ...] layout makes each thread's loads strided; that is left
// for a later PR (the bytes are tiny).
#include <cuda_runtime.h>

#include "game.cuh"

namespace {

__global__ void resolve_turn_kernel(const int* __restrict__ board, const int* __restrict__ row_len,
                                    const int* __restrict__ actions, int* __restrict__ board_out,
                                    int* __restrict__ len_out, int* __restrict__ rewards_out, int G,
                                    rl6::Cfg c) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int cells = c.R * c.T;
  int b[rl6::MAX_R * rl6::MAX_T];
  int len[rl6::MAX_R];
  int acts[rl6::MAX_P], rew[rl6::MAX_P], cards[rl6::MAX_P], players[rl6::MAX_P];
  for (int i = 0; i < cells; ++i) b[i] = board[(size_t)g * cells + i];
  for (int r = 0; r < c.R; ++r) len[r] = row_len[(size_t)g * c.R + r];
  for (int p = 0; p < c.P; ++p) acts[p] = actions[(size_t)g * c.P + p];

  rl6::Rows a;
  rl6::row_aggregates(c, b, len, a);
  rl6::resolve_plays(c, b, a, acts, rew, cards, players);

  for (int i = 0; i < cells; ++i) board_out[(size_t)g * cells + i] = b[i];
  for (int r = 0; r < c.R; ++r) len_out[(size_t)g * c.R + r] = a.len[r];
  for (int p = 0; p < c.P; ++p) rewards_out[(size_t)g * c.P + p] = rew[p];
}

}  // namespace

extern "C" int rl6_resolve_turn(const void* board, const void* row_len, const void* actions,
                                void* board_out, void* len_out, void* rewards_out, int G, int P,
                                int R, int T, void* stream) {
  rl6::Cfg c{P, R, T, 0, 0, 0};
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  resolve_turn_kernel<<<blocks, rl6::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)row_len, (const int*)actions, (int*)board_out, (int*)len_out,
      (int*)rewards_out, G, c);
  return (int)cudaGetLastError();
}
