// K4: whole greedy noisy-DQN games, trajectory written row-major.
//
// Replaces: rl6nimmt_tpu/ops/act_rollout_kernel.py:_act_rollout_kernel with
// _play_block, built by make_act_rollout_kernel (row-major layout).
//
// Bound on the H100: float32 operations.  Per game and turn the 37 shared
// game features cost 37*64*2 FLOPs of hidden work, each seat 10*64*2 more for
// its hand rows, and the advantage head is evaluated only for the cards in
// the seat's hand: (10 - t)*64*2.  At G=4096 that is ~0.52 GFLOP a call
// (~7.7 us at 67 TFLOP/s fp32); the bytes -- the weights once, the int8
// observations and int32 actions/rewards out -- are ~10.2 MB (~3.0 us).
//
// Design: one thread per game, 128 threads a block, ragged edge masked.  Turn
// t's effective weights (w1[t] S*Hd, b1[t], wa[t] Hd*A, ba[t]; ~39 KB in f32
// at Hd=64) are staged in shared memory, with __syncthreads() between turns;
// every thread, in range or not, takes part in the staging, and all play the
// same turn count.  Per turn a thread computes its game's 37 shared features
// and their hidden contribution once, then for each seat adds the 10 hand
// rows, applies ReLU, and evaluates the advantage only for the <= 10 cards
// of its sorted hand, keeping the first maximum in ascending card order --
// argmax over the legal-masked 104-wide row, lowest index on ties, with no
// way to pick an illegal card (the TPU kernel's -1e9 masking hazard is gone).
// The dueling V - mean(A) shift is a per-state constant and is skipped, as
// on the TPU.  Hands come from the shared deal() (game.cuh), so
// deal_games(seed) reproduces every game.
#include <cuda_runtime.h>

#include "game.cuh"

namespace {

constexpr int MAX_HIDDEN = 256;
constexpr int MAX_FEATURES = 128;

__global__ void act_rollout_kernel(uint64_t seed, const float* __restrict__ w1,
                                   const float* __restrict__ b1, const float* __restrict__ wa,
                                   const float* __restrict__ ba, int8_t* __restrict__ obs_out,
                                   int* __restrict__ act_out, int* __restrict__ rew_out, int G,
                                   rl6::Cfg c, int S, int A, int Hd, int n_turns) {
  extern __shared__ float smem[];
  float* s_w1 = smem;                 // [S, Hd]
  float* s_b1 = s_w1 + S * Hd;        // [Hd]
  float* s_wa = s_b1 + Hd;            // [Hd, A]
  float* s_ba = s_wa + Hd * A;        // [A]

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < G;
  const int H = c.H, P = c.P;
  const int n_game = S - H;

  int hands[rl6::MAX_C];
  int board[rl6::MAX_R * rl6::MAX_T];
  int seeds[rl6::MAX_R];
  rl6::Rows a;
  if (live) {
    rl6::deal(c, seed, (uint32_t)g, hands, seeds);
    for (int r = 0; r < c.R; ++r) {
      board[r * c.T] = seeds[r];
      for (int t = 1; t < c.T; ++t) board[r * c.T + t] = -1;
    }
    rl6::seed_aggregates(c, seeds, a);
  }

  int feat[MAX_FEATURES];
  float h_game[MAX_HIDDEN];
  float h[MAX_HIDDEN];
  int cards[rl6::MAX_P];

  // Game features in observation order: P | len/row | last/row | pts/row | board.
  auto game_features = [&]() {
    int k = 0;
    feat[k++] = P;
    if (c.include_summaries) {
      for (int r = 0; r < c.R; ++r) feat[k++] = a.len[r];
      for (int r = 0; r < c.R; ++r) feat[k++] = a.last[r];
      for (int r = 0; r < c.R; ++r) feat[k++] = a.pts[r];
    }
    for (int i = 0; i < c.R * c.T; ++i) feat[k++] = board[i];
  };
  auto emit_obs = [&](int t) {
    for (int p = 0; p < P; ++p) {
      int8_t* o = obs_out + (((size_t)t * G + g) * P + p) * S;
      for (int i = 0; i < H; ++i) o[i] = (int8_t)hands[p * H + i];
      for (int f = 0; f < n_game; ++f) o[H + f] = (int8_t)feat[f];
    }
  };

  for (int t = 0; t < n_turns; ++t) {
    __syncthreads();  // the previous turn's weights are no longer read
    const float* gw1 = w1 + (size_t)t * S * Hd;
    const float* gwa = wa + (size_t)t * Hd * A;
    for (int i = threadIdx.x; i < S * Hd; i += blockDim.x) s_w1[i] = gw1[i];
    for (int i = threadIdx.x; i < Hd; i += blockDim.x) s_b1[i] = b1[(size_t)t * Hd + i];
    for (int i = threadIdx.x; i < Hd * A; i += blockDim.x) s_wa[i] = gwa[i];
    for (int i = threadIdx.x; i < A; i += blockDim.x) s_ba[i] = ba[(size_t)t * A + i];
    __syncthreads();
    if (!live) continue;

    const int count = H - t;
    game_features();
    emit_obs(t);
    for (int k = 0; k < Hd; ++k) h_game[k] = s_b1[k];
    for (int f = 0; f < n_game; ++f) {
      const float x = (float)feat[f];
      const float* row = s_w1 + (H + f) * Hd;
      for (int k = 0; k < Hd; ++k) h_game[k] = fmaf(x, row[k], h_game[k]);
    }

    for (int p = 0; p < P; ++p) {
      int* hand = hands + p * H;
      for (int k = 0; k < Hd; ++k) h[k] = 0.f;
      for (int i = 0; i < H; ++i) {  // all H slots: -1 pads are observation entries too
        const float x = (float)hand[i];
        const float* row = s_w1 + i * Hd;
        for (int k = 0; k < Hd; ++k) h[k] = fmaf(x, row[k], h[k]);
      }
      for (int k = 0; k < Hd; ++k) h[k] = fmaxf(h[k] + h_game[k], 0.f);

      int best_card = hand[0];
      float best = 0.f;
      for (int i = 0; i < count; ++i) {
        const int card = hand[i];
        float adv = s_ba[card];
        for (int k = 0; k < Hd; ++k) adv = fmaf(h[k], s_wa[k * A + card], adv);
        if (i == 0 || adv > best) {
          best = adv;
          best_card = card;
        }
      }
      cards[p] = best_card;
      act_out[((size_t)t * G + g) * P + p] = best_card;
      rl6::remove_card(hand, count, best_card);
    }

    int rew[rl6::MAX_P];
    rl6::resolve_plays(c, board, a, cards, rew);
    for (int p = 0; p < P; ++p) rew_out[((size_t)t * G + g) * P + p] = rew[p];
  }
  if (live) {  // terminal observation: the n-step bootstrap target
    game_features();
    emit_obs(n_turns);
  }
}

}  // namespace

extern "C" int rl6_act_rollout(uint64_t seed, const void* w1, const void* b1, const void* wa,
                               const void* ba, void* obs_out, void* act_out, void* rew_out, int G,
                               int P, int R, int T, int H, int C, int hidden, int n_turns,
                               int include_summaries, void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  const int A = C;
  if (hidden > MAX_HIDDEN || S - H > MAX_FEATURES) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)S * hidden + hidden + (size_t)hidden * A + A);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  act_rollout_kernel<<<blocks, rl6::THREADS, smem, (cudaStream_t)stream>>>(
      seed, (const float*)w1, (const float*)b1, (const float*)wa, (const float*)ba,
      (int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, c, S, A, hidden, n_turns);
  return (int)cudaGetLastError();
}
