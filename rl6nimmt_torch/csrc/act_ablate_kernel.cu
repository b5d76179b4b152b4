// K6: K4's work cut down cumulatively, to attribute K4's time.
//
// Replaces: experiments/act_rollout_ablate.py:_kernel (built by build), the
// TPU ablation of _act_rollout_kernel.  Variants, each a kernel of its own:
//   env  act_ablate_env_kernel  deal + uniform-legal play + per-turn actions
//        and rewards: seat p at turn t plays hand slot (word * count) >> 32
//        of its game's STREAM_PLAY word t*P + p, K3's rule, so the games ARE
//        K3's games for the same seed (the TPU took bits % count);
//   obs  act_ablate_obs_kernel  + K4's int8 observations, the terminal one
//        included (the TPU ablation left it unwritten);
//   mm   act_ablate_mm_kernel   + K4's hidden layer and the full 104-wide
//        advantage head per seat; the seat plays hand[(word + argmax_a adv[a])
//        mod 2^32 % count] (uint32, first maximum over all A, unmasked), which
//        keeps the head live as the TPU formula did.
// The ablation's `full` variant is K4 itself (act_rollout_kernel.cu).
//
// Bound on the H100, per launch at G=4096, P=4, S=47, Hd=64, A=104, T=10:
//   env  bytes: actions + rewards, 2*4*T*G*P = 1.31 MB, ~0.39 us at 3.35 TB/s
//        (its integer work, K3's ~17.5 M ops, is ~0.26 us at the f32 rate);
//   obs  bytes: + (T+1)*G*P*S int8 observations = 8.47 MB, 9.78 MB in all,
//        ~2.9 us;
//   mm   f32 operations: per game and turn 37*64*2 shared hidden FLOPs plus
//        P*(10*64*2 + 104*64*2) per seat, 2.59 GFLOP, ~38.6 us at 67 TFLOP/s.
// Neither env nor obs comes near its bound: one game's dependent chain (the
// 44-step Fisher-Yates, then ten turns of picks and sub-plays) and the launch
// set the time, as in K3.
//
// Design.  env and obs play K3's games in K3's design (random_play.cuh: 32
// games and 128 threads a block; the Philox words and decks drawn by every
// warp, the Fisher-Yates on warp 0; at the flagship shape a game on four
// lanes with its seats' card sets and rows in registers, at every other shape
// one game a thread on its shared slice), with a hook that stores the
// trajectory.  Each lane writes its seat's pick to actions[t, g, p] and its
// turn's reward to rewards[t, g, p]: at the flagship a block's 128 lanes
// store 128 consecutive words a turn, one coalesced store each.  obs also
// keeps each row's cells in one 64-bit word (a card a byte, 0xFF an empty
// cell: the observation's board bytes as they stand), each seat writes its
// S-byte row into a shared stage in K4's order, and the block stores turn t's
// slice of obs as one contiguous run, 16 bytes a thread.  mm stays on K4's
// play loop (act_play.cuh: 32 games and 256 threads a block, the game logic on
// warp 0 at one thread per game on shared-memory state, the deal by
// game.cuh's deal(), which deals the same games) with K4's RowMajorEmit
// (row_major_emit.cuh); its 104-wide head runs over the worker warps in
// register tiles of 4 games x 4 actions (the actions of a tile strided by
// A4/4, so a warp's loads and stores fall in distinct banks), like K4's
// hand-only head over (slot, game), and adds up over the loop's 64-unit
// hidden chunks as K4's does.
#include <cuda_runtime.h>

#include <cstdint>

#include "act_play.cuh"
#include "random_play.cuh"
#include "row_major_emit.cuh"

namespace {

using namespace rl6::random_games;

// ------------------------------------------------------------- env and obs

// The trajectory: actions and rewards int32 [T, G, P], obs int8 [T+1, G, P, S]
// (obs only).
struct Trajectory {
  int8_t* obs;
  int* act;
  int* rew;
  int G, S;
};

// obs's stage: two halves, turn t's rows in half t % 2, row q = gl*P + p at
// byte lead + q*S, where lead is the offset of the block's run of turn t past
// a 16-byte boundary.  A turn needs one barrier: half t % 2 is written again
// at turn t + 2, after every thread has passed turn t + 1's barrier, which
// follows its copy of turn t.
struct ObsStage {
  uint8_t* base;
  int8_t* obs;
  size_t half;  // half_bytes(P, S)
  int G, S, PS, g0, ng;

  __host__ __device__ static size_t half_bytes(int P, int S) {
    return ((size_t)GAMES * P * S + 16 + 15) & ~(size_t)15;
  }

  // Turn t's run: the block's nb*P*S bytes of obs[t].
  __device__ __forceinline__ int8_t* run(int t) const { return obs + ((size_t)t * G + g0) * PS; }

  __device__ __forceinline__ uint8_t* row(int t, int q) const {
    return base + (t & 1) * half + ((uintptr_t)run(t) & 15) + (size_t)q * S;
  }

  // Every thread of the block: once turn t's rows are staged, the run out, 16
  // bytes a store over the 16-byte chunks wholly inside it and a byte at a
  // time at its ragged ends.
  __device__ __forceinline__ void flush(int t) const {
    __syncthreads();
    int8_t* to = run(t);
    const int lead = (int)((uintptr_t)to & 15), bytes = ng * PS;
    int8_t* first = to - lead;  // 16-byte aligned, as the half is
    const uint8_t* from = base + (t & 1) * half;
    const int chunks = (lead + bytes + 15) / 16;
    for (int ch = threadIdx.x; ch < chunks; ch += THREADS) {
      const int at0 = ch * 16 - lead;  // run byte of the chunk's first byte
      if (at0 >= 0 && at0 + 16 <= bytes) {
        *reinterpret_cast<uint4*>(first + ch * 16) = *reinterpret_cast<const uint4*>(from + ch * 16);
      } else {
        for (int j = max(-at0, 0); j < 16 && at0 + j < bytes; ++j) first[ch * 16 + j] = (int8_t)from[ch * 16 + j];
      }
    }
  }
};

// One seat's observation row, as K4 writes it (act_play.cuh write_features):
// the sorted hand, -1 padded (the set's members in ascending order), P, then
// len, last and points per row if include_summaries, then the board, one
// int8 an entry (0xFF: -1).  The first R of kRows rows are the game's.
template <int kRows>
__device__ __forceinline__ void write_row(uint8_t* row, const uint32_t* set, const rl6::Cfg& c,
                                          const int (&len)[kRows], const int (&pts)[kRows],
                                          const int (&last)[kRows], const uint64_t (&cells)[kRows]) {
  int i = 0;
#pragma unroll
  for (int k = 0; k < rl6::SET_WORDS; ++k)
    for (uint32_t w = set[k]; w; w &= w - 1u) row[i++] = (uint8_t)(32 * k + __ffs(w) - 1);
  for (; i < c.H; ++i) row[i] = 0xFF;
  row[c.H] = (uint8_t)c.P;
  int f = c.H + 1;
  if (c.include_summaries) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= c.R) break;
      row[f + r] = (uint8_t)len[r];
      row[f + c.R + r] = (uint8_t)last[r];
      row[f + 2 * c.R + r] = (uint8_t)pts[r];
    }
    f += 3 * c.R;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= c.R) break;
#pragma unroll
    for (int j = 0; j < rl6::MAX_T; ++j) {
      if (j >= c.T) break;
      row[f + r * c.T + j] = (uint8_t)(cells[r] >> (8 * j));
    }
  }
}

// The hook at the flagship shape: lane p of game gl stores seat p's pick and
// reward each turn (word (t*G + g)*P + p: the block's lanes store 128
// consecutive words), and with kObs its observation row.
template <bool kObs>
struct LaneTrajectory {
  static constexpr bool kBoard = kObs, kTerminal = kObs;
  rl6::Cfg c;
  Trajectory out;
  ObsStage stage;
  size_t at;  // (g0 + gl) * P + p
  bool live;

  template <int R>
  __device__ __forceinline__ void observe(int t, const uint32_t* set, int, const int (&len)[R],
                                         const int (&pts)[R], const int (&last)[R], const int (&)[R],
                                         const uint64_t (&cells)[R]) {
    if constexpr (kObs) write_row(stage.row(t, threadIdx.x), set, c, len, pts, last, cells);
  }
  __device__ __forceinline__ void played(int t, int pick, int paid) {
    if (!live) return;
    const size_t w = (size_t)t * out.G * c.P + at;
    out.act[w] = pick;
    out.rew[w] = -paid;
  }
  __device__ __forceinline__ void flush(int t) {
    if constexpr (kObs) stage.flush(t);
  }
  __device__ __forceinline__ void end(int) {}
};

// The hook at a runtime shape: the game's thread stores its P picks and the
// turn's rewards (the totals' change since the last turn), and with kObs the
// P observation rows.
template <bool kObs>
struct SharedTrajectory {
  static constexpr bool kBoard = kObs, kTerminal = kObs;
  rl6::Cfg c;
  Trajectory out;
  ObsStage stage;
  size_t at;        // g * P
  int gl;
  int* last_total;  // the totals after the last turn, in the game's slice

  __device__ __forceinline__ void observe(int t, const uint32_t* sets, int, const int (&len)[rl6::MAX_R],
                                         const int (&pts)[rl6::MAX_R], const int (&last)[rl6::MAX_R],
                                         const int (&)[rl6::MAX_R], const uint64_t (&cells)[rl6::MAX_R]) {
    if constexpr (kObs)
      for (int p = 0; p < c.P; ++p)
        write_row(stage.row(t, gl * c.P + p), sets + rl6::SET_WORDS * p, c, len, pts, last, cells);
  }
  __device__ __forceinline__ void played(int t, const int* key, const int* total) {
    const size_t w = (size_t)t * out.G * c.P + at;
    for (int i = 0; i < c.P; ++i) out.act[w + (key[i] & 15)] = key[i] >> 8;
    for (int p = 0; p < c.P; ++p) {
      out.rew[w + p] = total[p] - last_total[p];
      last_total[p] = total[p];
    }
  }
  __device__ __forceinline__ void flush(int t) {
    if constexpr (kObs) stage.flush(t);
  }
  __device__ __forceinline__ void end(const int*) {}
};

// A block's shared memory: K3's, plus the runtime-sized slices' cells and last
// totals, plus obs's stage.
__host__ __device__ inline Layout trajectory_layout(const rl6::Cfg& c, bool flagship_shape, bool obs, int S) {
  return Layout(c, true, flagship_shape, true, obs ? 2 * ObsStage::half_bytes(c.P, S) : 0);
}

template <bool kObs, int kP, int kR, int kT, int kH, int kC>
__device__ __forceinline__ void play_trajectories(uint64_t seed, const Trajectory& out,
                                                  const rl6::Cfg& runtime_cfg) {
  constexpr bool kConst = kP > 0;
  static_assert(!kConst || kP * GAMES == THREADS, "the flagship instance plays a seat a thread");
  const rl6::Cfg c = sizes<kP, kR, kT, kH, kC>(runtime_cfg);
  const Layout L = trajectory_layout(c, kConst, kObs, out.S);
  unsigned char* smem = block_smem();
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, out.G - g0);
  const ObsStage stage{smem + L.stage, out.obs, ObsStage::half_bytes(c.P, out.S), out.G, out.S, c.P * out.S,
                       g0, ng};

  deal_block<deal_blocks<kP, kR, kH>()>(c, L, smem, seed, g0, ng);
  if constexpr (kConst) {
    const int gl = threadIdx.x / kP, p = threadIdx.x % kP;
    LaneTrajectory<kObs> hook{c, out, stage, (size_t)(g0 + gl) * kP + p, gl < ng};
    play_seat_lanes<kP, kR, kT, kH>(c, L, smem, gl, p, hook);
  } else {
    fill_seat_slices(c, L, smem, ng);
    __syncthreads();
    const int gl = threadIdx.x;
    const bool game = gl < ng;
    if (!kObs && !game) return;  // env: the last barrier is behind
    int* last_total = reinterpret_cast<int*>(smem + L.scratch) + gl * L.ks + 2 * c.P;
    if (game)
      for (int p = 0; p < c.P; ++p) last_total[p] = 0;
    SharedTrajectory<kObs> hook{c, out, stage, (size_t)(g0 + gl) * c.P, gl, last_total};
    play_in_shared(c, L, smem, gl, game, seed, (uint32_t)(g0 + gl), hook);
  }
}

template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    act_ablate_env_kernel(uint64_t seed, Trajectory out, rl6::Cfg runtime_cfg) {
  play_trajectories<false, kP, kR, kT, kH, kC>(seed, out, runtime_cfg);
}

template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    act_ablate_obs_kernel(uint64_t seed, Trajectory out, rl6::Cfg runtime_cfg) {
  play_trajectories<true, kP, kR, kT, kH, kC>(seed, out, runtime_cfg);
}

// env (obs = false) or obs over out.G games: the flagship instance at the
// flagship shape, else the runtime-sized one; above 48 KB of dynamic shared
// memory the kernel is allowed it first.
int launch_trajectories(bool obs, uint64_t seed, const Trajectory& out, const rl6::Cfg& c, cudaStream_t stream) {
  const bool constant = flagship(c);
  void (*kernel)(uint64_t, Trajectory, rl6::Cfg) =
      obs ? (constant ? &act_ablate_obs_kernel<4, 4, 6, 10, 104> : &act_ablate_obs_kernel<0, 0, 0, 0, 0>)
          : (constant ? &act_ablate_env_kernel<4, 4, 6, 10, 104> : &act_ablate_env_kernel<0, 0, 0, 0, 0>);
  const size_t smem = trajectory_layout(c, constant, obs, out.S).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(out.G + GAMES - 1) / GAMES, THREADS, smem, stream>>>(seed, out, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------- mm

// mm: the full advantage head, folded into a legal pick with the seat's word.
struct FullHeadActor {
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

__global__ void __launch_bounds__(rl6::PLAY_THREADS)
    act_ablate_mm_kernel(rl6::PlayArgs a, rl6::RowMajorEmit emit) {
  FullHeadActor actor{rl6::Stream(a.seed, (uint32_t)(blockIdx.x * rl6::PLAY_GAMES + threadIdx.x), rl6::STREAM_PLAY),
                      a.A};
  rl6::play_games(a, actor, emit);
}

}  // namespace

// variant: 0 = env (obs_out unused), 1 = obs, 2 = mm (the only one that reads
// the weights).  env and obs play all H turns: n_turns must be H.
extern "C" int rl6_act_ablate(int variant, uint64_t seed, const void* w1, const void* b1,
                              const void* wa, const void* ba, void* obs_out, void* act_out,
                              void* rew_out, int G, int P, int R, int T, int H, int C, int hidden,
                              int n_turns, int include_summaries, void* stream) {
  const rl6::Cfg c{P, R, T, H, C, include_summaries};
  const int S = H + 1 + (include_summaries ? 3 * R : 0) + R * T;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant < 0 || variant > 2 || hidden < 1) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    const rl6::PlayArgs a{seed, (const float*)w1, (const float*)b1, (const float*)wa,
                          (const float*)ba, G, S, C, hidden, n_turns, c};
    const rl6::RowMajorEmit emit{(int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, P};
    return rl6::launch_play(act_ablate_mm_kernel, G,
                            rl6::play_smem_bytes<FullHeadActor, rl6::RowMajorEmit>(c, S, C), s, a, emit);
  }
  if (!accepted(c) || n_turns != H) return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  return launch_trajectories(variant == 1, seed, Trajectory{(int8_t*)obs_out, (int*)act_out, (int*)rew_out, G, S},
                             c, s);
}
