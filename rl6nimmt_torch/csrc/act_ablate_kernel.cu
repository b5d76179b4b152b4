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
// Design: exactly K4's (one thread per game, 128 games a block, per-turn
// weights staged in shared memory for mm); env and obs skip the staging and
// both __syncthreads() at compile time, since their actor has no forward.
#include <cuda_runtime.h>

#include "act_play.cuh"
#include "row_major_emit.cuh"

namespace {

// env / obs: uniform-legal pick, K3's multiply-high rule.
struct RandomActor {
  static constexpr bool kForward = false;
  rl6::Stream picks;

  __device__ int pick(const int* hand, int count, const float*, const float*, const float*, int,
                      int) {
    return hand[picks.below(count)];
  }
};

// mm: the full advantage head, folded into a legal pick with the seat's word.
struct FullHeadActor {
  static constexpr bool kForward = true;
  rl6::Stream picks;

  __device__ int pick(const int* hand, int count, const float* h, const float* s_wa,
                      const float* s_ba, int A, int Hd) {
    const uint32_t word = picks.word();
    int amax = 0;
    float best = 0.f;
    for (int j = 0; j < A; ++j) {
      float adv = s_ba[j];
      for (int k = 0; k < Hd; ++k) adv = fmaf(h[k], s_wa[k * A + j], adv);
      if (j == 0 || adv > best) {
        best = adv;
        amax = j;
      }
    }
    return hand[(word + (uint32_t)amax) % (uint32_t)count];
  }
};

__device__ __forceinline__ int game_index() { return blockIdx.x * blockDim.x + threadIdx.x; }

__global__ void act_ablate_env_kernel(rl6::PlayArgs a, int* __restrict__ act_out,
                                      int* __restrict__ rew_out) {
  extern __shared__ float smem[];
  const int g = game_index();
  RandomActor actor{rl6::Stream(a.seed, (uint32_t)g, rl6::STREAM_PLAY)};
  rl6::ActionRewardEmit emit{{nullptr, act_out, rew_out, g, a.G, a.c.P, a.c.H, a.S}};
  rl6::play_games(a, smem, actor, emit);
}

__global__ void act_ablate_obs_kernel(rl6::PlayArgs a, int8_t* __restrict__ obs_out,
                                      int* __restrict__ act_out, int* __restrict__ rew_out) {
  extern __shared__ float smem[];
  const int g = game_index();
  RandomActor actor{rl6::Stream(a.seed, (uint32_t)g, rl6::STREAM_PLAY)};
  rl6::RowMajorEmit emit{obs_out, act_out, rew_out, g, a.G, a.c.P, a.c.H, a.S};
  rl6::play_games(a, smem, actor, emit);
}

__global__ void act_ablate_mm_kernel(rl6::PlayArgs a, int8_t* __restrict__ obs_out,
                                     int* __restrict__ act_out, int* __restrict__ rew_out) {
  extern __shared__ float smem[];
  const int g = game_index();
  FullHeadActor actor{rl6::Stream(a.seed, (uint32_t)g, rl6::STREAM_PLAY)};
  rl6::RowMajorEmit emit{obs_out, act_out, rew_out, g, a.G, a.c.P, a.c.H, a.S};
  rl6::play_games(a, smem, actor, emit);
}

}  // namespace

// variant: 0 = env (obs_out unused), 1 = obs, 2 = mm.
extern "C" int rl6_act_ablate(int variant, uint64_t seed, const void* w1, const void* b1,
                              const void* wa, const void* ba, void* obs_out, void* act_out,
                              void* rew_out, int G, int P, int R, int T, int H, int C, int hidden,
                              int n_turns, int include_summaries, void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  if (variant < 0 || variant > 2 || hidden > rl6::MAX_HIDDEN || S - H > rl6::MAX_FEATURES)
    return (int)cudaErrorInvalidValue;
  rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa, (const float*)ba,
                  G, S, C, hidden, n_turns, c};
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    act_ablate_env_kernel<<<blocks, rl6::THREADS, 0, s>>>(a, (int*)act_out, (int*)rew_out);
  } else if (variant == 1) {
    act_ablate_obs_kernel<<<blocks, rl6::THREADS, 0, s>>>(a, (int8_t*)obs_out, (int*)act_out,
                                                          (int*)rew_out);
  } else {
    const size_t smem = rl6::play_smem_bytes(S, C, hidden);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          act_ablate_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    act_ablate_mm_kernel<<<blocks, rl6::THREADS, smem, s>>>(a, (int8_t*)obs_out, (int*)act_out,
                                                            (int*)rew_out);
  }
  return (int)cudaGetLastError();
}
