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
// Design: the play loop is act_play.cuh's, shared with K4, so a redesign of
// the loop moves both kernels (32 games a block, 128 blocks at G=4096; warp 0
// plays the games, seven worker warps run the forward, 64 hidden units a
// pass; nothing in local memory; one kernel for every width).  K5's emitter:
// * flush() writes each turn's observations as the `state` columns of that
//   turn with the worker warps, 16 games (16 bytes) a store, and the terminal
//   observation as the `next_state` columns of every turn of the seat
//   (n_steps >= max_turns: every transition bootstraps from it), with the pad
//   rows S..state_rows-1 zero, together with scal rows 2.. (done = (t >=
//   tail_start), then zeros);
// * each game's thread writes its actions (scal row 1) and rewards as they
//   are produced, then runs the reverse recursion acc = r'_t + gamma * acc per
//   seat over the rewards it wrote, with r'_t = r_{t-1} (r'_0 = 0) under
//   reward_lag, through __fmul_rn/__fadd_rn so that nvcc cannot contract it
//   into an FMA and the plain twin's torch recursion equals it bit for bit;
//   scal row 0 gets the return.
// Column map (the layout contract with the kd sampler, buffers/per.py): tile
// i of TILE = 128 games (four blocks) owns tile blocks base = (ptr/128 +
// i*T*P) % (cap/128) onward; game gi of the tile writes column (base + t*P +
// p)*128 + gi of every plane row, so a block's 32 games write 32 neighbouring
// bytes of one feature row.  The wrapper requires G % 128 == 0, planes on a
// 16-byte boundary
// and cap, ptr multiples of T*P*128, so a tile's region never straddles the
// ring end, and G*T*P <= cap, so no two tiles own the same columns (blocks
// run concurrently: an overlap would be a write race).
#include <cuda_runtime.h>

#include <climits>

#include "act_play.cuh"

namespace {

constexpr int TILE = 128;  // games a tile of the column map
static_assert(TILE % rl6::PLAY_GAMES == 0, "a block's games lie in one tile");

struct InsertEmit {
  int8_t* state;
  int8_t* next;
  float* scal;
  int* rew_out;
  long long cap;
  unsigned cap_blocks, ptr_blk;  // capacity and ptr in tile blocks (the launcher checks < 2^31)
  int G, P, state_rows, scal_rows, n_turns, tail_start;

  // First tile block of game g's tile.  Its T*P blocks never pass the ring's
  // end (cap and ptr are multiples of T*P*TILE), so they need no wrap.
  // Both terms are below 2^31, so the 32-bit sum cannot wrap.
  __device__ __forceinline__ unsigned tile_base(int g) const {
    return (ptr_blk + (unsigned)(g / TILE) * (unsigned)(n_turns * P)) % cap_blocks;
  }
  // Column of transition (t, p) of game g, whose tile starts at `base`.
  __device__ __forceinline__ size_t col(unsigned base, int t, int p, int g) const {
    return (size_t)(base + t * P + p) * TILE + g % TILE;
  }
  __host__ __device__ static size_t stage_bytes(int, int) { return 0; }

  // Plane row `row` of seat p for the 16 games from gl: 16 bytes, game-ordered.
  __device__ __forceinline__ uint4 plane_bytes(const rl6::PlayTile& tile, int gl, int p, int row) const {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < tile.S) {
      const int f = row < tile.H ? tile.n_game + p * tile.H + row : row - tile.H;
      const float* x = tile.x + f * rl6::PLAY_GAMES + gl;
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)x[j] << (8 * (j & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // The workers' stores, 16 games (16 bytes, or 4 games of f32) an item: the
  // blocks are full (G % 128 == 0) and every plane row's columns of a tile
  // block are 16-byte aligned (cap % 128 == 0, planes 16-byte aligned).
  __device__ __forceinline__ void flush(int t, const rl6::PlayTile& tile) {
    constexpr int NH = rl6::PLAY_GAMES / 16, NQ = rl6::PLAY_GAMES / 4;
    const unsigned base = tile_base(tile.g0);  // a block's games share one tile
    if (t < n_turns) {
      for (int q = rl6::worker_index(); q < P * state_rows * NH; q += rl6::WORKERS) {
        const int gl = (q % NH) * 16, row = (q / NH) % state_rows, p = q / NH / state_rows;
        *reinterpret_cast<uint4*>(state + (size_t)row * cap + col(base, t, p, tile.g0 + gl)) =
            plane_bytes(tile, gl, p, row);
      }
      return;
    }
    for (int q = rl6::worker_index(); q < n_turns * P * state_rows * NH; q += rl6::WORKERS) {
      const int gl = (q % NH) * 16, row = (q / NH) % state_rows, tp = q / NH / state_rows;
      *reinterpret_cast<uint4*>(next + (size_t)row * cap + col(base, tp / P, tp % P, tile.g0 + gl)) =
          plane_bytes(tile, gl, tp % P, row);
    }
    const int rows = scal_rows - 2;
    for (int q = rl6::worker_index(); q < n_turns * P * rows * NQ; q += rl6::WORKERS) {
      const int gl = (q % NQ) * 4, row = 2 + (q / NQ) % rows, tp = q / NQ / rows, tt = tp / P;
      const float v = row == 2 && tt >= tail_start ? 1.f : 0.f;
      *reinterpret_cast<float4*>(scal + (size_t)row * cap + col(base, tt, tp % P, tile.g0 + gl)) =
          make_float4(v, v, v, v);
    }
  }
  __device__ __forceinline__ void action(int t, int g, int p, int card) {
    scal[(size_t)cap + col(tile_base(g), t, p, g)] = (float)card;
  }
  __device__ __forceinline__ void rewards(int t, int g, const int* rew) {
    for (int p = 0; p < P; ++p) rew_out[(size_t)(t * P + p) * G + g] = rew[p];
  }
};

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_insert_kernel(rl6::PlayArgs a, InsertEmit emit, float gamma, int reward_lag) {
  rl6::GreedyActor actor;
  rl6::play_games(a, actor, emit);
  const int g = blockIdx.x * rl6::PLAY_GAMES + threadIdx.x;
  if (threadIdx.x >= rl6::PLAY_GAMES || g >= a.G) return;

  // The n-step returns, from the rewards this thread wrote (own writes: visible).
  const int P = a.c.P, T = a.n_turns, G = a.G;
  const unsigned base = emit.tile_base(g);
  for (int p = 0; p < P; ++p) {
    float acc = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const float r = reward_lag ? (t > 0 ? (float)emit.rew_out[(size_t)((t - 1) * P + p) * G + g] : 0.f)
                                 : (float)emit.rew_out[(size_t)(t * P + p) * G + g];
      acc = __fadd_rn(r, __fmul_rn(gamma, acc));
      emit.scal[emit.col(base, t, p, g)] = acc;
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
  const long long region = (long long)n_turns * P * TILE;
  if ((((uintptr_t)state | (uintptr_t)next | (uintptr_t)scal) & 15) != 0 ||
      G % TILE != 0 || capacity % region != 0 || ptr % region != 0 || ptr < 0 || ptr >= capacity ||
      (long long)G * n_turns * P > capacity || capacity / TILE > INT_MAX || state_rows < S ||
      scal_rows < 3 || n_steps < n_turns || hidden < 1)
    return (int)cudaErrorInvalidValue;
  const rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa,
                        (const float*)ba, G, S, C, hidden, n_turns, c};
  const InsertEmit emit{(int8_t*)state, (int8_t*)next, (float*)scal, (int*)rew_out,
                        capacity, (unsigned)(capacity / TILE), (unsigned)(ptr / TILE), G, P,
                        state_rows, scal_rows,
                        n_turns, n_steps > 1 ? n_turns - n_steps + 1 : n_turns - 1};
  return rl6::launch_play(act_insert_kernel, G, rl6::play_smem_bytes<rl6::GreedyActor, InsertEmit>(c, S, C),
                          (cudaStream_t)stream, a, emit, gamma, reward_lag);
}
