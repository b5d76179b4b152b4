// K4's row-major trajectory emitter for the play loop (act_play.cuh), shared
// by K4 (act_rollout_kernel.cu) and K6's mm (act_ablate_kernel.cu).
//
// Layout: obs [T+1, G, P, S] int8, actions and rewards [T, G, P] int32.  A
// block's games are one contiguous run of nb*P*S observation bytes per turn
// (32*4*47 = 6,016 at the main path's shapes).  flush() builds that run in
// shared memory from the feature tile with the worker warps, then stores it
// 16 bytes a store over the 16-byte-aligned chunks it covers; the ragged ends
// of the run are stored a byte at a time.  Actions and rewards are written by each game's thread as
// they are produced.
#pragma once

#include <cstdint>

#include "act_play.cuh"

namespace rl6 {

struct RowMajorEmit {
  int8_t* obs_out;
  int* act_out;
  int* rew_out;
  int G, P;

  // The block's run, at its global alignment (up to 15 bytes of lead).
  __host__ __device__ static size_t stage_bytes(int P, int S) { return (size_t)PLAY_GAMES * P * S + 16; }

  // The workers write the run into the stage, byte i at stage[lead + i] (one
  // (game, seat) row of S bytes per item), then copy it out: the 16-byte
  // chunks wholly inside the run as one uint4 each, the ragged ends by byte.
  // Workers only: it holds two barriers of the worker warps.
  __device__ __forceinline__ void flush(int t, const PlayTile& tile) {
    const int S = tile.S, PS = P * S;
    const int run = tile.nb * PS;
    int8_t* base = obs_out + ((size_t)t * G + tile.g0) * PS;
    const int lead = (int)((uintptr_t)base & 15);
    int8_t* stage = (int8_t*)tile.stage + lead;
    for (int q = worker_index(); q < tile.nb * P; q += WORKERS) {
      const int gl = q / P, p = q - gl * P;
      int8_t* row = stage + q * S;
      for (int i = 0; i < S; ++i) row[i] = tile.obs(gl, p, i);
    }
    worker_sync();
    int8_t* first = base - lead;  // 16-byte aligned, as tile.stage is
    const int chunks = (lead + run + 15) / 16;
    for (int ch = worker_index(); ch < chunks; ch += WORKERS) {
      const int at0 = ch * 16 - lead;  // run index of the chunk's first byte
      const uint8_t* from = tile.stage + ch * 16;
      if (at0 >= 0 && at0 + 16 <= run) {
        *reinterpret_cast<uint4*>(first + ch * 16) = *reinterpret_cast<const uint4*>(from);
      } else {
        for (int j = max(-at0, 0); j < 16 && at0 + j < run; ++j) first[ch * 16 + j] = (int8_t)from[j];
      }
    }
    worker_sync();  // the stage is read: the forward may write h, which it can share
  }
  __device__ __forceinline__ void action(int t, int g, int p, int card) {
    act_out[((size_t)t * G + g) * P + p] = card;
  }
  __device__ __forceinline__ void rewards(int t, int g, const int* rew) {
    for (int p = 0; p < P; ++p) rew_out[((size_t)t * G + g) * P + p] = rew[p];
  }
};

}  // namespace rl6
