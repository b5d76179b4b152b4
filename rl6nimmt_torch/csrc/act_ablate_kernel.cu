// K6: K4's play loop cut down cumulatively, to attribute K4's time.
//
// Replaces: experiments/act_rollout_ablate.py:_kernel (built by build), the
// TPU ablation of _act_rollout_kernel.  Variants, each a kernel of its own:
//   env  act_ablate_env_kernel  deal + uniform-legal play + per-turn actions
//        and rewards: seat p at turn t plays hand slot below(count) of its
//        game's STREAM_PLAY word t*P + p, K3's rule, so the games ARE K3's
//        games for the same seed (the TPU took bits % count);
//   obs  act_ablate_obs_kernel  + K4's int8 observation writes, the terminal
//        one included (the TPU ablation left it unwritten);
//   mm   act_ablate_mm_kernel   + K4's hidden layer and the full 104-wide
//        advantage head per seat; the seat plays hand[(word + argmax_a adv[a])
//        mod 2^32 % count] (uint32, first maximum over all A, unmasked), which
//        keeps the head live as the TPU formula did.
// The ablation's `full` variant is K4 itself (act_rollout_kernel.cu).  All
// three instantiate act_play.cuh's play_games with K4's RowMajorEmit
// (row_major_emit.cuh; env without observations), so the attribution
// measures K4's own loop.
//
// Bound on the H100, per launch at G=4096, P=4, S=47, Hd=64, A=104, T=10:
//   env  bytes: actions + rewards, 2*4*T*G*P = 1.31 MB, ~0.39 us at 3.35 TB/s
//        (its integer work, K3's ~17.5 M ops, is ~0.26 us at the f32 rate);
//   obs  bytes: + (T+1)*G*P*S int8 observations = 8.47 MB, ~2.9 us;
//   mm   f32 operations: per game and turn 37*64*2 shared hidden FLOPs plus
//        P*(10*64*2 + 104*64*2) per seat, 2.59 GFLOP, ~38.6 us at 67 TFLOP/s.
// Design: K4's loop and launch shape (act_play.cuh: 32 games and 256 threads
// a block, the game logic on warp 0 at one thread per game, game state in
// shared memory).  env and obs skip the weight staging, the forward and its
// barriers at compile time, since their actor has no forward; env also skips
// the feature tile and the observation stores, so its worker warps exit at
// once.  mm's 104-wide head runs over the worker warps in register tiles of 4
// games x 4 actions (the actions of a tile strided by A4/4, so a warp's loads
// and stores fall in distinct banks), like K4's hand-only head over (slot,
// game), and adds up over the loop's 64-unit hidden chunks as K4's does.
#include <cuda_runtime.h>

#include "act_play.cuh"
#include "row_major_emit.cuh"

namespace {

// env / obs: uniform-legal pick, K3's multiply-high rule.
struct RandomActor {
  static constexpr bool kForward = false;
  __host__ __device__ static int adv_rows(int, int) { return 0; }
  rl6::Stream picks;

  __device__ __forceinline__ int pick(const rl6::PlaySmem&, int, int count) {
    return picks.below(count);
  }
};

// mm: the full advantage head, folded into a legal pick with the seat's word.
struct FullHeadActor {
  static constexpr bool kForward = true;
  __host__ __device__ static int adv_rows(int, int A) { return (A + 3) / 4 * 4; }
  rl6::Stream picks;
  int A;  // the actions the argmax runs over (the tile's rows past A are padding)

  // Hidden chunk c's share of adv[a][g] for every action a < A4 (rows past A
  // are zero weights); chunk 0 starts at ba.
  __device__ __forceinline__ void head(const rl6::PlaySmem& s, const rl6::PlayTile&, int, int, int c) {
    constexpr int NG = rl6::PLAY_GAMES, HS = rl6::HS;
    const int AQ = s.A4 / 4;
    for (int it = rl6::worker_index(); it < AQ * (NG / 4); it += rl6::WORKERS) {
      const int aq = it % AQ, gb = (it / AQ) * 4;
      float v[4][4];
#pragma unroll
      for (int ai = 0; ai < 4; ++ai) {
        const int row = (aq + ai * AQ) * rl6::ADV_STRIDE + gb;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) v[gi][ai] = c == 0 ? s.ba[aq + ai * AQ] : s.adv[row + gi];
      }
      for (int k = 0; k < rl6::HIDDEN_CHUNK; k += 4) {
        float4 h[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[i] = rl6::ld4(s.h + (gb + i) * HS + k);
          w[i] = rl6::ld4(s.wa + (aq + i * AQ) * HS + k);
        }
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
#pragma unroll
          for (int ai = 0; ai < 4; ++ai) {
            v[gi][ai] = fmaf(h[gi].x, w[ai].x, v[gi][ai]);
            v[gi][ai] = fmaf(h[gi].y, w[ai].y, v[gi][ai]);
            v[gi][ai] = fmaf(h[gi].z, w[ai].z, v[gi][ai]);
            v[gi][ai] = fmaf(h[gi].w, w[ai].w, v[gi][ai]);
          }
      }
#pragma unroll
      for (int ai = 0; ai < 4; ++ai)
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) s.adv[(aq + ai * AQ) * rl6::ADV_STRIDE + gb + gi] = v[gi][ai];
    }
  }

  __device__ __forceinline__ int pick(const rl6::PlaySmem& s, int gl, int count) {
    const uint32_t word = picks.word();
    int amax = 0;
    float best = s.adv[gl];
    for (int j = 1; j < A; ++j) {
      const float adv = s.adv[j * rl6::ADV_STRIDE + gl];
      if (adv > best) {
        best = adv;
        amax = j;
      }
    }
    return (int)((word + (uint32_t)amax) % (uint32_t)count);
  }
};

__device__ __forceinline__ rl6::Stream play_stream(const rl6::PlayArgs& a) {
  return rl6::Stream(a.seed, (uint32_t)(blockIdx.x * rl6::PLAY_GAMES + threadIdx.x), rl6::STREAM_PLAY);
}

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_ablate_env_kernel(rl6::PlayArgs a, rl6::ActionRewardEmit emit) {
  RandomActor actor{play_stream(a)};
  rl6::play_games(a, actor, emit);
}

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_ablate_obs_kernel(rl6::PlayArgs a, rl6::RowMajorEmit emit) {
  RandomActor actor{play_stream(a)};
  rl6::play_games(a, actor, emit);
}

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_ablate_mm_kernel(rl6::PlayArgs a, rl6::RowMajorEmit emit) {
  FullHeadActor actor{play_stream(a), a.A};
  rl6::play_games(a, actor, emit);
}

}  // namespace

// variant: 0 = env (obs_out unused), 1 = obs, 2 = mm.
extern "C" int rl6_act_ablate(int variant, uint64_t seed, const void* w1, const void* b1,
                              const void* wa, const void* ba, void* obs_out, void* act_out,
                              void* rew_out, int G, int P, int R, int T, int H, int C, int hidden,
                              int n_turns, int include_summaries, void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  if (variant < 0 || variant > 2 || hidden < 1)
    return (int)cudaErrorInvalidValue;
  const rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa,
                        (const float*)ba, G, S, C, hidden, n_turns, c};
  const rl6::RowMajorEmit emit{(int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, P};
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    return rl6::launch_play(act_ablate_env_kernel, G,
                            rl6::play_smem_bytes<RandomActor, rl6::ActionRewardEmit>(c, S, C), s, a,
                            rl6::ActionRewardEmit{emit});
  if (variant == 1)
    return rl6::launch_play(act_ablate_obs_kernel, G,
                            rl6::play_smem_bytes<RandomActor, rl6::RowMajorEmit>(c, S, C), s, a, emit);
  return rl6::launch_play(act_ablate_mm_kernel, G,
                          rl6::play_smem_bytes<FullHeadActor, rl6::RowMajorEmit>(c, S, C), s, a, emit);
}
