// K4: whole greedy noisy-DQN games, trajectory written row-major
// (rl6_act_rollout) or feature-major (rl6_act_rollout_fm).
//
// Replaces: rl6nimmt_tpu/ops/act_rollout_kernel.py:_act_rollout_kernel with
// _play_block, built by make_act_rollout_kernel, in both of its layouts
// (feature_major False and True).
//
// Bound on the H100: float32 operations.  Per game and turn the 37 shared
// game features cost 37*64*2 FLOPs of hidden work, each seat 10*64*2 more for
// its hand rows, and the advantage head is evaluated only for the cards in
// the seat's hand: (10 - t)*64*2.  At G=4096 that is ~0.52 GFLOP a call
// (~7.7 us at 67 TFLOP/s fp32); the bytes -- the weights once, the int8
// observations and int32 actions/rewards out -- are ~10.2 MB (~3.0 us).
//
// Design: the play loop is act_play.cuh's, shared with K5 (act_insert_kernel.cu),
// so a redesign of the loop moves both kernels.  One thread per game and 128
// games a block would keep 100 of the 132 SMs idle at G=4096 and make each
// game's forward one thread's serial chain of ~63,500 multiply-adds.  Instead a
// block holds 32 games (128 blocks at G=4096, one per SM) and 256 threads:
// warp 0 runs the game logic on shared-memory game state, and seven worker
// warps run the forward in register tiles, 64 hidden units a pass, with h and
// the features in shared memory, so nothing lives in local memory and one
// kernel serves every width.  K4's emitter (row_major_emit.cuh, shared with
// K6) builds each turn's observation run of the block in shared memory and
// stores it 16 bytes a store; each game's actions and rewards come from its
// thread: obs [T+1, G, P, S] int8, actions and rewards [T, G, P] int32.
// The feature-major entry plays the same games through the same loop and
// differs only in its emitter (feature_major_emit.cuh): obs [S, (T+1)*P, G]
// int8 in row order (f, t, p), actions and rewards [T*P, G] int32.  Its bound
// is K4's: the same 0.52 GFLOP at G=4096 (7.7 us at 67 TFLOP/s f32) and the
// same ~10.2 MB of traffic in another order.
#include <cuda_runtime.h>

#include "act_play.cuh"
#include "feature_major_emit.cuh"
#include "row_major_emit.cuh"

namespace {

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_rollout_kernel(rl6::PlayArgs a, rl6::RowMajorEmit emit) {
  rl6::GreedyActor actor;
  rl6::play_games(a, actor, emit);
}

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_rollout_fm_kernel(rl6::PlayArgs a, rl6::FeatureMajorEmit emit) {
  rl6::GreedyActor actor;
  rl6::play_games(a, actor, emit);
}

}  // namespace

// Games a CUDA block of the play loop (K4, K5, K6): the launch shape, for the
// reports.
extern "C" int rl6_play_games(void) { return rl6::PLAY_GAMES; }

// Both entries: the play arguments from the game shape, then one launch of
// `kernel` with its emitter.
template <class Emit>
int launch_rollout(void (*kernel)(rl6::PlayArgs, Emit), const Emit& emit, uint64_t seed,
                   const void* w1, const void* b1, const void* wa, const void* ba, int G, int P,
                   int R, int T, int H, int C, int hidden, int n_turns, int include_summaries,
                   void* stream) {
  if (hidden < 1) return (int)cudaErrorInvalidValue;
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  const rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa,
                        (const float*)ba, G, S, C, hidden, n_turns, c};
  return rl6::launch_play(kernel, G, rl6::play_smem_bytes<rl6::GreedyActor, Emit>(c, S, C),
                          (cudaStream_t)stream, a, emit);
}

extern "C" int rl6_act_rollout(uint64_t seed, const void* w1, const void* b1, const void* wa,
                               const void* ba, void* obs_out, void* act_out, void* rew_out, int G,
                               int P, int R, int T, int H, int C, int hidden, int n_turns,
                               int include_summaries, void* stream) {
  const rl6::RowMajorEmit emit{(int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, P};
  return launch_rollout(act_rollout_kernel, emit, seed, w1, b1, wa, ba, G, P, R, T, H, C, hidden,
                        n_turns, include_summaries, stream);
}

extern "C" int rl6_act_rollout_fm(uint64_t seed, const void* w1, const void* b1, const void* wa,
                                  const void* ba, void* obs_out, void* act_out, void* rew_out, int G,
                                  int P, int R, int T, int H, int C, int hidden, int n_turns,
                                  int include_summaries, void* stream) {
  const rl6::FeatureMajorEmit emit{(int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, P, n_turns};
  return launch_rollout(act_rollout_fm_kernel, emit, seed, w1, b1, wa, ba, G, P, R, T, H, C, hidden,
                        n_turns, include_summaries, stream);
}
