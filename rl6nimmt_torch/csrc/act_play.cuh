// The noisy-DQN play loop shared by K4 (act_rollout_kernel.cu), K5
// (act_insert_kernel.cu) and K6's ablation variants (act_ablate_kernel.cu).
//
// Replaces: rl6nimmt_tpu/ops/act_rollout_kernel.py:_play_block, which both TPU
// kernels build on with injected emit_obs/emit_action/emit_rewards.  Here the
// emitter is a template parameter with three __device__ methods:
//   obs(t, hands, feat)    t in [0, n_turns]; t == n_turns is the terminal
//                          observation.  hands[p*H + i] are the sorted hands,
//                          feat[0 .. S-H) the shared game features;
//   action(t, p, card)     the card seat p plays at turn t;
//   rewards(t, rew)        rew[p], minus the penalty seat p paid at turn t.
// and the actor is a second one, which says
//   kForward               whether the loop stages turn t's weights and
//                          computes the hidden layer (shared game rows once a
//                          turn, then per seat the H hand rows and ReLU);
//   pick(hand, count, h, s_wa, s_ba, A, Hd)
//                          the card a seat plays from its sorted hand of
//                          `count` live cards (h: its hidden vector, kForward
//                          only); called once per seat-turn, in seat order.
// K4 and K5 instantiate the loop with GreedyActor (play_greedy_games), so
// their play cannot drift, and a redesign of the loop moves both kernels; the
// ablation's actors cut it down without copying it.
//
// Design: one thread per game, rl6::THREADS games a block, ragged edge
// masked.  With a forward, turn t's effective weights (w1[t] S*Hd, b1[t],
// wa[t] Hd*A, ba[t]; ~39 KB in f32 at Hd=64) are staged in dynamic shared
// memory, with __syncthreads() between turns; every thread, in range or not,
// takes part in the staging, and all play the same turn count.  Per turn a
// thread computes its game's shared features and their hidden contribution
// once, then for each seat adds the H hand rows, applies ReLU and asks the
// actor.  GreedyActor evaluates the advantage only for the cards of the
// sorted hand, keeping the first maximum in ascending card order -- argmax
// over the legal-masked A-wide row, lowest index on ties, with no way to pick
// an illegal card.  The dueling V - mean(A) shift is a per-state constant and
// is skipped, as on the TPU.  Hands come from the shared deal() (game.cuh),
// so deal_games(seed) reproduces every game.
#pragma once

#include "game.cuh"

namespace rl6 {

constexpr int MAX_HIDDEN = 256;
constexpr int MAX_FEATURES = 128;

struct PlayArgs {
  uint64_t seed;
  const float* w1;  // [n_turns, S, Hd]
  const float* b1;  // [n_turns, Hd]
  const float* wa;  // [n_turns, Hd, A]
  const float* ba;  // [n_turns, A]
  int G, S, A, Hd, n_turns;
  Cfg c;
};

// Bytes of dynamic shared memory the loop needs for one turn's weights.
inline size_t play_smem_bytes(int S, int A, int Hd) {
  return sizeof(float) * ((size_t)S * Hd + Hd + (size_t)Hd * A + A);
}

// K4's and K5's actor: the greedy act over the cards in hand.
struct GreedyActor {
  static constexpr bool kForward = true;

  __device__ __forceinline__ int pick(const int* hand, int count, const float* h,
                                      const float* s_wa, const float* s_ba, int A, int Hd) {
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
    return best_card;
  }
};

template <class Actor, class Emit>
__device__ void play_games(const PlayArgs& a, float* smem, Actor& actor, Emit& emit) {
  const Cfg& c = a.c;
  const int S = a.S, A = a.A, Hd = a.Hd;
  float* s_w1 = smem;           // [S, Hd]
  float* s_b1 = s_w1 + S * Hd;  // [Hd]
  float* s_wa = s_b1 + Hd;      // [Hd, A]
  float* s_ba = s_wa + Hd * A;  // [A]

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < a.G;
  const int H = c.H, P = c.P;
  const int n_game = S - H;

  int hands[MAX_C];
  int board[MAX_R * MAX_T];
  int seeds[MAX_R];
  Rows rows;
  if (live) {
    deal(c, a.seed, (uint32_t)g, hands, seeds);
    for (int r = 0; r < c.R; ++r) {
      board[r * c.T] = seeds[r];
      for (int t = 1; t < c.T; ++t) board[r * c.T + t] = -1;
    }
    seed_aggregates(c, seeds, rows);
  }

  int feat[MAX_FEATURES];
  float h_game[MAX_HIDDEN];
  float h[MAX_HIDDEN];
  int cards[MAX_P];

  // Game features in observation order: P | len/row | last/row | pts/row | board.
  auto game_features = [&]() {
    int k = 0;
    feat[k++] = P;
    if (c.include_summaries) {
      for (int r = 0; r < c.R; ++r) feat[k++] = rows.len[r];
      for (int r = 0; r < c.R; ++r) feat[k++] = rows.last[r];
      for (int r = 0; r < c.R; ++r) feat[k++] = rows.pts[r];
    }
    for (int i = 0; i < c.R * c.T; ++i) feat[k++] = board[i];
  };

  for (int t = 0; t < a.n_turns; ++t) {
    if constexpr (Actor::kForward) {
      __syncthreads();  // the previous turn's weights are no longer read
      const float* gw1 = a.w1 + (size_t)t * S * Hd;
      const float* gwa = a.wa + (size_t)t * Hd * A;
      for (int i = threadIdx.x; i < S * Hd; i += blockDim.x) s_w1[i] = gw1[i];
      for (int i = threadIdx.x; i < Hd; i += blockDim.x) s_b1[i] = a.b1[(size_t)t * Hd + i];
      for (int i = threadIdx.x; i < Hd * A; i += blockDim.x) s_wa[i] = gwa[i];
      for (int i = threadIdx.x; i < A; i += blockDim.x) s_ba[i] = a.ba[(size_t)t * A + i];
      __syncthreads();
    }
    if (!live) continue;

    const int count = H - t;
    game_features();
    emit.obs(t, hands, feat);
    if constexpr (Actor::kForward) {
      for (int k = 0; k < Hd; ++k) h_game[k] = s_b1[k];
      for (int f = 0; f < n_game; ++f) {
        const float x = (float)feat[f];
        const float* row = s_w1 + (H + f) * Hd;
        for (int k = 0; k < Hd; ++k) h_game[k] = fmaf(x, row[k], h_game[k]);
      }
    }

    for (int p = 0; p < P; ++p) {
      int* hand = hands + p * H;
      if constexpr (Actor::kForward) {
        for (int k = 0; k < Hd; ++k) h[k] = 0.f;
        for (int i = 0; i < H; ++i) {  // all H slots: -1 pads are observation entries too
          const float x = (float)hand[i];
          const float* row = s_w1 + i * Hd;
          for (int k = 0; k < Hd; ++k) h[k] = fmaf(x, row[k], h[k]);
        }
        for (int k = 0; k < Hd; ++k) h[k] = fmaxf(h[k] + h_game[k], 0.f);
      }
      const int card = actor.pick(hand, count, h, s_wa, s_ba, A, Hd);
      cards[p] = card;
      emit.action(t, p, card);
      remove_card(hand, count, card);
    }

    int rew[MAX_P];
    resolve_plays(c, board, rows, cards, rew);
    emit.rewards(t, rew);
  }
  if (live) {  // terminal observation: the n-step bootstrap target
    game_features();
    emit.obs(a.n_turns, hands, feat);
  }
}

template <class Emit>
__device__ void play_greedy_games(const PlayArgs& a, float* smem, Emit& emit) {
  GreedyActor actor;
  play_games(a, smem, actor, emit);
}

}  // namespace rl6
