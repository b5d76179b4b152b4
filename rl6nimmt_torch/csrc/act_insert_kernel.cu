// K5: whole greedy noisy-DQN games whose finished n-step transitions are
// written straight into the replay planes at the ring pointer.
//
// Replaces: rl6nimmt_tpu/ops/act_rollout_kernel.py:_act_insert_kernel, built
// by make_act_insert_kernel (the flagship cycle's kernel_insert path).
//
// Bound on the H100: float32 operations, narrowly.  The play is K4's: ~0.52
// GFLOP at G=4096 (~7.7 us at 67 TFLOP/s fp32).  The bytes are the weights
// once (393 KB), the planes written, 163,840 columns x (48 + 48 int8 + 8 f32)
// = 21.0 MB, and the rewards, 0.66 MB: ~22.0 MB, ~6.6 us at 3.35 TB/s.
//
// Design: the play loop is act_play.cuh's play_greedy_games, shared with K4,
// so a redesign of the loop moves both kernels.  K5's emitter:
// * writes each turn's observation as the `state` columns of that turn, and
//   the terminal observation as the `next_state` columns of every turn of the
//   seat (n_steps >= max_turns: every transition bootstraps from it), with
//   the pad rows S..state_rows-1 zero;
// * keeps the game's actions and rewards (T*P ints each) in the thread, then
//   runs the reverse recursion acc = r'_t + gamma * acc per seat, with
//   r'_t = r_{t-1} (r'_0 = 0) under reward_lag, through __fmul_rn/__fadd_rn so
//   that nvcc cannot contract it into an FMA and the plain twin's torch
//   recursion equals it bit for bit; scal rows 0/1/2 get the return, the
//   action and done = (t >= tail_start), rows 3.. zero.
// Column map: block i (THREADS = 128 games, the port's tile) owns tile blocks
// base = (ptr/128 + i*T*P) % (cap/128) onward; game gi of the block writes
// column (base + t*P + p)*128 + gi of every plane row, so neighbouring threads
// write neighbouring bytes of one feature row.  The wrapper requires
// G % 128 == 0 and cap, ptr multiples of T*P*128, so a block's region never
// straddles the ring end, and G*T*P <= cap, so no two blocks own the same
// columns (blocks run concurrently: an overlap would be a write race).
#include <cuda_runtime.h>

#include "act_play.cuh"

namespace {

constexpr int MAX_TP = 128;  // turns x players of one game (6 nimmt!: <= 100)

struct InsertEmit {
  int8_t* state;
  int8_t* next;
  int* rew_out;
  long long cap, cap_blocks, base_blk;
  int gi, g, G, P, H, S, state_rows, n_turns;
  int acts[MAX_TP];  // this game's actions and rewards, (t, p) order
  int rews[MAX_TP];

  __device__ size_t col(int t, int p) const {
    const long long blk = (base_blk + t * P + p) % cap_blocks;
    return (size_t)blk * rl6::THREADS + gi;
  }
  __device__ void write_obs(int8_t* plane, size_t c, const int* hand, const int* feat) const {
    for (int i = 0; i < H; ++i) plane[(size_t)i * cap + c] = (int8_t)hand[i];
    for (int f = 0; f < S - H; ++f) plane[(size_t)(H + f) * cap + c] = (int8_t)feat[f];
    for (int r = S; r < state_rows; ++r) plane[(size_t)r * cap + c] = 0;
  }
  __device__ void obs(int t, const int* hands, const int* feat) {
    for (int p = 0; p < P; ++p) {
      if (t < n_turns) {
        write_obs(state, col(t, p), hands + p * H, feat);
      } else {  // terminal observation: next_state of every turn of the seat
        for (int tt = 0; tt < n_turns; ++tt) write_obs(next, col(tt, p), hands + p * H, feat);
      }
    }
  }
  __device__ void action(int t, int p, int card) { acts[t * P + p] = card; }
  __device__ void rewards(int t, const int* rew) {
    for (int p = 0; p < P; ++p) {
      rews[t * P + p] = rew[p];
      rew_out[(size_t)(t * P + p) * G + g] = rew[p];
    }
  }
};

__global__ void act_insert_kernel(rl6::PlayArgs a, int8_t* __restrict__ state,
                                  int8_t* __restrict__ next, float* __restrict__ scal,
                                  int* __restrict__ rew_out, long long cap, long long ptr,
                                  int state_rows, int scal_rows, float gamma, int n_steps,
                                  int reward_lag) {
  extern __shared__ float smem[];
  const int P = a.c.P, T = a.n_turns, TP = T * P;
  const long long cap_blocks = cap / rl6::THREADS;
  InsertEmit emit;
  emit.state = state;
  emit.next = next;
  emit.rew_out = rew_out;
  emit.cap = cap;
  emit.cap_blocks = cap_blocks;
  emit.base_blk = (ptr / rl6::THREADS + (long long)blockIdx.x * TP) % cap_blocks;
  emit.gi = threadIdx.x;
  emit.g = blockIdx.x * blockDim.x + threadIdx.x;
  emit.G = a.G;
  emit.P = P;
  emit.H = a.c.H;
  emit.S = a.S;
  emit.state_rows = state_rows;
  emit.n_turns = T;
  rl6::play_greedy_games(a, smem, emit);
  if (emit.g >= a.G) return;

  const int tail_start = n_steps > 1 ? T - n_steps + 1 : T - 1;
  for (int p = 0; p < P; ++p) {
    float acc = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const float r = reward_lag ? (t > 0 ? (float)emit.rews[(t - 1) * P + p] : 0.f)
                                 : (float)emit.rews[t * P + p];
      acc = __fadd_rn(r, __fmul_rn(gamma, acc));
      const size_t c = emit.col(t, p);
      scal[c] = acc;
      scal[(size_t)cap + c] = (float)emit.acts[t * P + p];
      scal[2 * (size_t)cap + c] = t >= tail_start ? 1.f : 0.f;
      for (int row = 3; row < scal_rows; ++row) scal[(size_t)row * cap + c] = 0.f;
    }
  }
}

}  // namespace

extern "C" int rl6_act_insert(uint64_t seed, long long ptr, const void* w1, const void* b1,
                              const void* wa, const void* ba, void* state, void* next, void* scal,
                              void* rew_out, int G, int P, int R, int T, int H, int C, int hidden,
                              int n_turns, int include_summaries, long long capacity,
                              int state_rows, int scal_rows, float gamma, int n_steps,
                              int reward_lag, void* stream) {
  rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  const long long region = (long long)n_turns * P * rl6::THREADS;
  if (hidden > rl6::MAX_HIDDEN || S - H > rl6::MAX_FEATURES || n_turns * P > MAX_TP ||
      G % rl6::THREADS != 0 || capacity % region != 0 || ptr % region != 0 || ptr < 0 ||
      ptr >= capacity || (long long)G * n_turns * P > capacity || state_rows < S ||
      scal_rows < 3 || n_steps < n_turns)
    return (int)cudaErrorInvalidValue;
  rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa, (const float*)ba,
                  G, S, C, hidden, n_turns, c};
  const size_t smem = rl6::play_smem_bytes(S, C, hidden);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0) return 0;
  act_insert_kernel<<<G / rl6::THREADS, rl6::THREADS, smem, (cudaStream_t)stream>>>(
      a, (int8_t*)state, (int8_t*)next, (float*)scal, (int*)rew_out, capacity, ptr, state_rows,
      scal_rows, gamma, n_steps, reward_lag);
  return (int)cudaGetLastError();
}
