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
// Design: the play loop is act_play.cuh's play_greedy_games, shared with K5
// (act_insert_kernel.cu), so a redesign of the loop moves both kernels.  K4's
// emitter (row_major_emit.cuh, shared with K6) writes each observation, action
// and reward as it is produced: obs [T+1, G, P, S] int8, actions and rewards
// [T, G, P] int32.
#include <cuda_runtime.h>

#include "act_play.cuh"
#include "row_major_emit.cuh"

namespace {

__global__ void act_rollout_kernel(rl6::PlayArgs a, int8_t* __restrict__ obs_out,
                                   int* __restrict__ act_out, int* __restrict__ rew_out) {
  extern __shared__ float smem[];
  rl6::RowMajorEmit emit{obs_out, act_out, rew_out,
                         (int)(blockIdx.x * blockDim.x + threadIdx.x), a.G, a.c.P, a.c.H, a.S};
  rl6::play_greedy_games(a, smem, emit);
}

}  // namespace

extern "C" int rl6_act_rollout(uint64_t seed, const void* w1, const void* b1, const void* wa,
                               const void* ba, void* obs_out, void* act_out, void* rew_out, int G,
                               int P, int R, int T, int H, int C, int hidden, int n_turns,
                               int include_summaries, void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  if (hidden > rl6::MAX_HIDDEN || S - H > rl6::MAX_FEATURES) return (int)cudaErrorInvalidValue;
  rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa, (const float*)ba,
                  G, S, C, hidden, n_turns, c};
  const size_t smem = rl6::play_smem_bytes(S, C, hidden);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (G + rl6::THREADS - 1) / rl6::THREADS;
  act_rollout_kernel<<<blocks, rl6::THREADS, smem, (cudaStream_t)stream>>>(
      a, (int8_t*)obs_out, (int*)act_out, (int*)rew_out);
  return (int)cudaGetLastError();
}
