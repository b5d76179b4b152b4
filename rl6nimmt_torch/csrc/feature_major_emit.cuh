// K4's feature-major trajectory emitter for the play loop (act_play.cuh), used
// by the rl6_act_rollout_fm entry of act_rollout_kernel.cu.
//
// Replaces: the feature_major branch of emit_obs/emit_action/emit_rewards in
// rl6nimmt_tpu/ops/act_rollout_kernel.py:_act_rollout_kernel, whose output
// reshapes to obs [S, (T+1)*P, G] with row order (f, t, p) and games last.
//
// Layout: obs int8 [S, (T+1)*P, G], entry (f, t, p, g) at
// ((f*(T+1) + t)*P + p)*G + g; actions and rewards int32 [T*P, G], entry
// (t, p, g) at (t*P + p)*G + g.  Within a block of PLAY_GAMES = 32 games each
// (f, t, p) is one run of up to 32 consecutive bytes, so flush() gives one run
// to a worker warp, a lane a game, read straight from the feature tile (column
// gl of row f, conflict-free in shared memory) with no stage: one byte store a
// lane, one 32-byte sector a run when G % 32 == 0 and the tensor is 32-byte
// aligned.  A ragged last block writes its nb < 32 lanes; any G and any
// alignment work, since every store is a byte.  The game thread of game g
// writes its actions and rewards, a warp's 32 games contiguous.
#pragma once

#include <cstdint>

#include "act_play.cuh"

namespace rl6 {

struct FeatureMajorEmit {
  int8_t* obs_out;
  int* act_out;
  int* rew_out;
  int G, P, n_turns;

  __host__ __device__ static size_t stage_bytes(int, int) { return 0; }

  // Workers only: turn t's (t == n_turns: the terminal) observations, one
  // (f, p) run of the block's games a warp instruction.  Reads only the
  // feature tile, which the game warp rewrites after the turn's last seat
  // barrier, so it needs no barrier of its own.
  __device__ __forceinline__ void flush(int t, const PlayTile& tile) {
    constexpr int WARPS = WORKERS / 32;
    const int lane = (int)threadIdx.x & 31, warp = worker_index() >> 5;
    if (lane >= tile.nb) return;
    const int runs = tile.S * P;
    for (int q = warp; q < runs; q += WARPS) {
      const int f = q / P, p = q - f * P;
      const size_t row = ((size_t)f * (n_turns + 1) + t) * P + p;
      obs_out[row * G + tile.g0 + lane] = tile.obs(lane, p, f);
    }
  }
  __device__ __forceinline__ void action(int t, int g, int p, int card) {
    act_out[((size_t)t * P + p) * G + g] = card;
  }
  __device__ __forceinline__ void rewards(int t, int g, const int* rew) {
    for (int p = 0; p < P; ++p) rew_out[((size_t)t * P + p) * G + g] = rew[p];
  }
};

}  // namespace rl6
