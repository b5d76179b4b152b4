// K4's row-major trajectory emitter for the play loop (act_play.cuh), shared
// by K4 (act_rollout_kernel.cu) and K6 (act_ablate_kernel.cu).
//
// It writes each observation, action and reward as it is produced:
// obs [T+1, G, P, S] int8, actions and rewards [T, G, P] int32.
// ActionRewardEmit is the same layout without the observations (K6's env
// variant).
#pragma once

#include <cstdint>

namespace rl6 {

struct RowMajorEmit {
  int8_t* obs_out;
  int* act_out;
  int* rew_out;
  int g, G, P, H, S;

  __device__ void obs(int t, const int* hands, const int* feat) {
    for (int p = 0; p < P; ++p) {
      int8_t* o = obs_out + (((size_t)t * G + g) * P + p) * S;
      for (int i = 0; i < H; ++i) o[i] = (int8_t)hands[p * H + i];
      for (int f = 0; f < S - H; ++f) o[H + f] = (int8_t)feat[f];
    }
  }
  __device__ void action(int t, int p, int card) { act_out[((size_t)t * G + g) * P + p] = card; }
  __device__ void rewards(int t, const int* rew) {
    for (int p = 0; p < P; ++p) rew_out[((size_t)t * G + g) * P + p] = rew[p];
  }
};

struct ActionRewardEmit : RowMajorEmit {
  __device__ void obs(int, const int*, const int*) {}
};

}  // namespace rl6
