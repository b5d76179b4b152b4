// The noisy-DQN play loop shared by K4 (act_rollout_kernel.cu), K5
// (act_insert_kernel.cu) and K6's mm variant (act_ablate_kernel.cu).
//
// Replaces: rl6nimmt_tpu/ops/act_rollout_kernel.py:_play_block, which both TPU
// kernels build on with injected emit_obs/emit_action/emit_rewards.  What it
// keeps from the TPU block: the shared game features contract against their
// w1 rows once a turn, each seat adds only its H hand rows, and the head is
// evaluated per seat over the cards in its hand.
//
// Design (Hopper): a block plays PLAY_GAMES = 32 games with PLAY_THREADS =
// 256 threads, so a 4096-game launch is 128 blocks, one per SM of the H100.
// Warp 0 is the game warp: one thread per game runs the game logic (deal,
// hands, board, row aggregates, remove_slot, resolve_plays from game.cuh) on
// game state kept in shared memory, so no thread keeps a runtime-indexed
// array.  Warps 1-7 are the workers: they stage the weights, store the
// observations and run the forward.  The forward runs over the hidden units
// in chunks of HIDDEN_CHUNK = 64, so one kernel serves every width and its
// shared memory does not grow with the width.  Per turn t:
//   1. (before the turn) the workers stage chunk 0 of turn t's weights into
//      shared memory (w1 [S][64], b1, wa transposed [A4][68], ba; zero beyond
//      the real Hd and A) while the game warp resolves turn t-1 and writes each
//      game's features as f32 into one [F][32] tile: the game block (P | len,
//      last, pts per row | board), then every seat's hand;
//   2. the workers store the turn's observations (Emit::flush) and compute
//      the chunk's shared part of the hidden layer, b1 + game features .
//      w1[H:], in register tiles of 4 games x 4 hidden units (HiddenTiles:
//      each pair of 16-byte shared loads feeds 16 FMAs);
//   3. per seat p and chunk c: the same tiles add the seat's H hand rows,
//      apply ReLU and write the chunk's h [32][68]; then threads over (hand
//      slot, game) add the chunk's share of the advantages of the cards in
//      hand (Actor::head).  After the last chunk the game warp picks seat p's
//      card (Actor::pick) while the workers already compute seat p+1.
// At Hd <= 64 (the flagship's 64) a turn is one chunk, staged once.  A wider
// net restages chunk c for every seat and recomputes its shared part: more
// L2 reads and FLOPs at widths no workload runs, for a layout that fits the
// card at every configuration the wrappers accept.  Units past Hd carry zero
// weights, so h = 0 there and they add exact zeros.  Sums run in another
// order than the plain twin's matmul (b1 first, then the game rows, then the
// hand rows, sequential in each register; the head ba first, then per chunk
// four interleaved partial sums), which moves near-ties only
// (PARITY_TORCH.md section 7).
//
// Interfaces.  The actor:
//   adv_rows(H, A)      rows of the [rows][33] advantage tile it needs;
//   head(s, tile, p, count, c)  workers: hidden chunk c's share of seat p's
//                       advantages into s.adv (c == 0 starts them at ba);
//   pick(s, gl, count)  game thread gl: the hand slot of the card seat p
//                       plays from its sorted hand of `count` live cards,
//                       called once per seat-turn in seat order.
// The emitter:
//   stage_bytes(P, S)   shared bytes it needs;
//   flush(t, tile)      workers: turn t's observations from the feature tile
//                       (t == n_turns: the terminal one);
//   action(t, g, p, card), rewards(t, g, rew)   game thread of game g.
// Hands come from the shared deal() (game.cuh), so deal_games(seed)
// reproduces every game.
#pragma once

#include <cuda_runtime.h>

#include "game.cuh"

namespace rl6 {

constexpr int PLAY_GAMES = 32;     // games a block: warp 0 plays them, a thread each
constexpr int PLAY_THREADS = 256;  // threads a block of the play loop
constexpr int WORKERS = PLAY_THREADS - 32;  // warps 1.. run the forward and the stores
constexpr int HIDDEN_CHUNK = 64;   // hidden units a pass of the forward
constexpr int HS = HIDDEN_CHUNK + 4;  // row stride of h and of the transposed wa
constexpr int ROWS_STRIDE = sizeof(Rows) / 4 + 1;  // ints per game's Rows, odd: no bank conflicts
constexpr int ADV_STRIDE = PLAY_GAMES + 1;

static_assert(sizeof(Rows) % 4 == 0, "Rows is a block of ints");
static_assert(PLAY_GAMES % 16 == 0 && PLAY_GAMES <= 32 && PLAY_THREADS % 32 == 0,
              "one game warp, whole worker warps, 16-game stores");
static_assert(HIDDEN_CHUNK % 4 == 0, "4-unit register tiles");

struct PlayArgs {
  uint64_t seed;
  const float* w1;  // [n_turns, S, Hd]
  const float* b1;  // [n_turns, Hd]
  const float* wa;  // [n_turns, Hd, A]
  const float* ba;  // [n_turns, A]
  int G, S, A, Hd, n_turns;
  Cfg c;
};

__host__ __device__ inline size_t take_smem(size_t& at, size_t bytes) {
  const size_t start = at;
  at = (at + bytes + 15) & ~(size_t)15;
  return start;
}

// Byte offsets of one block's dynamic shared memory (the same on host and device).
struct PlayLayout {
  int F, A4, hs, bs, ss;
  size_t w1, b1, wa, ba, x, h, adv, hands, board, rows, scratch, deck, stage, bytes;

  __host__ __device__ PlayLayout(const Cfg& c, int S, int A, int adv_rows, size_t stage_bytes) {
    const size_t n = PLAY_GAMES, f4 = sizeof(float);
    F = S - c.H + c.P * c.H;     // the game block, then every seat's hand
    A4 = (A + 3) / 4 * 4;
    hs = (c.P * c.H) | 1;        // odd strides: game threads hit distinct banks
    bs = (c.R * c.T) | 1;
    ss = (4 * c.P + c.R) | 1;    // cards, sorted cards, players, rewards, seeds
    size_t at = 0;
    w1 = take_smem(at, f4 * S * HIDDEN_CHUNK);
    b1 = take_smem(at, f4 * HIDDEN_CHUNK);
    wa = take_smem(at, f4 * A4 * HS);
    ba = take_smem(at, f4 * A4);
    x = take_smem(at, f4 * F * n);
    h = take_smem(at, f4 * n * HS);
    adv = take_smem(at, f4 * adv_rows * ADV_STRIDE);
    hands = take_smem(at, 4 * n * hs);
    board = take_smem(at, 4 * n * bs);
    rows = take_smem(at, 4 * n * ROWS_STRIDE);
    scratch = take_smem(at, 4 * n * ss);
    // The deal's decks (n*C <= 4096 bytes) are dead before h is first written,
    // so they share h's region (8,704 bytes).
    deck = h;
    // The emitter's bytes; its flush ends before the turn's h is written, so
    // they share h's region where they fit in it.
    stage = stage_bytes <= f4 * n * HS ? h : take_smem(at, stage_bytes);
    bytes = at;
  }
};

// Pointers into one block's shared memory.
struct PlaySmem {
  float *w1, *b1, *wa, *ba, *x, *h, *adv;
  int *hands, *board, *rows, *scratch;
  uint8_t *deck, *stage;
  int hs, A4;

  __device__ PlaySmem(unsigned char* base, const PlayLayout& L)
      : w1((float*)(base + L.w1)), b1((float*)(base + L.b1)), wa((float*)(base + L.wa)),
        ba((float*)(base + L.ba)), x((float*)(base + L.x)), h((float*)(base + L.h)),
        adv((float*)(base + L.adv)), hands((int*)(base + L.hands)), board((int*)(base + L.board)),
        rows((int*)(base + L.rows)), scratch((int*)(base + L.scratch)), deck(base + L.deck),
        stage(base + L.stage), hs(L.hs), A4(L.A4) {}
};

// What the emitters and actors see of the block's games this turn.
struct PlayTile {
  const float* x;  // [F][PLAY_GAMES]: rows [0, n_game) the game block, then hand p*H + i
  uint8_t* stage;  // the emitter's shared bytes
  int n_game, H, P, S;
  int g0, nb;      // the block's first game and its live games

  // Observation entry i (0 <= i < S) of seat p of game gl, as the int8 it is.
  __device__ __forceinline__ int8_t obs(int gl, int p, int i) const {
    const int f = i < H ? n_game + p * H + i : i - H;
    return (int8_t)(int)x[f * PLAY_GAMES + gl];
  }
};

// The one dynamic shared-memory array of every play-loop kernel, 16-byte aligned.
__device__ __forceinline__ unsigned char* play_smem() {
  extern __shared__ float4 play_smem_f4[];
  return reinterpret_cast<unsigned char*>(play_smem_f4);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// This thread's index among the worker threads (warps 1..; negative in the game warp).
__device__ __forceinline__ int worker_index() { return (int)threadIdx.x - 32; }

// A barrier of the worker warps alone (named barrier 1; 0 is __syncthreads').
__device__ __forceinline__ void worker_sync() { asm volatile("bar.sync 1, %0;" ::"n"(WORKERS) : "memory"); }

// ------------------------------------------------------------------ forward

// Chunk c (hidden units 64c..64c+63) of turn t's weights into shared memory,
// zero past the real Hd hidden units and A actions.
__device__ inline void stage_weights(const PlayArgs& a, const PlaySmem& s, int t, int c) {
  constexpr int KC = HIDDEN_CHUNK;
  const int S = a.S, A = a.A, Hd = a.Hd, A4 = s.A4, k0 = c * KC;
  const float* gw1 = a.w1 + (size_t)t * S * Hd;
  const float* gb1 = a.b1 + (size_t)t * Hd;
  const float* gwa = a.wa + (size_t)t * Hd * A;
  const float* gba = a.ba + (size_t)t * A;
  const int wt = worker_index();
  for (int i = wt; i < S * KC; i += WORKERS) {
    const int f = i / KC, k = k0 + i % KC;
    s.w1[i] = k < Hd ? gw1[f * Hd + k] : 0.f;
  }
  for (int k = wt; k < KC; k += WORKERS) s.b1[k] = k0 + k < Hd ? gb1[k0 + k] : 0.f;
  for (int i = wt; i < KC * A4; i += WORKERS) {  // action-fastest: coalesced reads
    const int k = i / A4, j = i - k * A4;
    s.wa[j * HS + k] = (k0 + k < Hd && j < A) ? gwa[(k0 + k) * A + j] : 0.f;
  }
  for (int j = wt; j < A4; j += WORKERS) s.ba[j] = j < A ? gba[j] : 0.f;
}

__device__ __forceinline__ void fma_tile(float (&v)[4][4], const float4 x, const float4 w) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) v[gi][ki] = fmaf(xs[gi], ws[ki], v[gi][ki]);
}

// One chunk of the hidden layer over the block: items of 4 games x 4 hidden
// units, hidden quad fastest across threads, so a warp's weight loads are
// contiguous and its stores to h fall in distinct banks.  game[] holds each
// item's shared part (b1 + game features) of the chunk, in registers.
struct HiddenTiles {
  static constexpr int KQ = HIDDEN_CHUNK / 4, ITEMS = KQ * (PLAY_GAMES / 4);
  static constexpr int PER = (ITEMS + WORKERS - 1) / WORKERS;
  float game[PER][4][4];

  __device__ __forceinline__ void shared_part(const PlaySmem& s, int H, int n_game) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int it = worker_index() + j * WORKERS;
      if (ITEMS % WORKERS != 0 && it >= ITEMS) continue;
      const int k0 = (it % KQ) * 4, gb = (it / KQ) * 4;
      const float4 b = ld4(s.b1 + k0);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        game[j][gi][0] = b.x;
        game[j][gi][1] = b.y;
        game[j][gi][2] = b.z;
        game[j][gi][3] = b.w;
      }
      for (int f = 0; f < n_game; ++f)
        fma_tile(game[j], ld4(s.x + f * PLAY_GAMES + gb), ld4(s.w1 + (H + f) * HIDDEN_CHUNK + k0));
    }
  }

  // Seat p: h = relu(shared part + hand . w1[:H]) into s.h [game][HS].
  __device__ __forceinline__ void seat(const PlaySmem& s, int H, int n_game, int p) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int it = worker_index() + j * WORKERS;
      if (ITEMS % WORKERS != 0 && it >= ITEMS) continue;
      const int k0 = (it % KQ) * 4, gb = (it / KQ) * 4;
      float v[4][4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
#pragma unroll
        for (int ki = 0; ki < 4; ++ki) v[gi][ki] = game[j][gi][ki];
      const float* xr = s.x + (n_game + p * H) * PLAY_GAMES + gb;
      for (int i = 0; i < H; ++i)  // all H slots: -1 pads are observation entries too
        fma_tile(v, ld4(xr + i * PLAY_GAMES), ld4(s.w1 + i * HIDDEN_CHUNK + k0));
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        *reinterpret_cast<float4*>(s.h + (gb + gi) * HS + k0) =
            make_float4(fmaxf(v[gi][0], 0.f), fmaxf(v[gi][1], 0.f), fmaxf(v[gi][2], 0.f),
                        fmaxf(v[gi][3], 0.f));
    }
  }
};

// The chunk's share of one advantage, h . wa[:, j] over four interleaved partial sums.
__device__ __forceinline__ float advantage_chunk(const PlaySmem& s, int gl, int j) {
  const float* hv = s.h + gl * HS;
  const float* wv = s.wa + j * HS;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int k = 0; k < HIDDEN_CHUNK; k += 4) {
    const float4 h = ld4(hv + k), w = ld4(wv + k);
    a0 = fmaf(h.x, w.x, a0);
    a1 = fmaf(h.y, w.y, a1);
    a2 = fmaf(h.z, w.z, a2);
    a3 = fmaf(h.w, w.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// K4's and K5's actor: the greedy act over the cards in hand.  head()
// evaluates the hand's advantages, threads over (slot, game) with the game
// fastest; pick() keeps the first maximum in ascending card order -- argmax
// over the legal-masked A-wide row, lowest index on ties, with no way to pick
// an illegal card.  The dueling V - mean(A) shift is a per-state constant and
// is skipped, as on the TPU.
struct GreedyActor {
  __host__ __device__ static int adv_rows(int H, int) { return H; }

  __device__ __forceinline__ void head(const PlaySmem& s, const PlayTile& tile, int p, int count, int c) {
    for (int q = worker_index(); q < count * PLAY_GAMES; q += WORKERS) {
      const int gl = q % PLAY_GAMES, slot = q / PLAY_GAMES;
      if (gl >= tile.nb) continue;
      const int card = s.hands[gl * s.hs + p * tile.H + slot];
      float& adv = s.adv[slot * ADV_STRIDE + gl];
      adv = (c == 0 ? s.ba[card] : adv) + advantage_chunk(s, gl, card);
    }
  }

  __device__ __forceinline__ int pick(const PlaySmem& s, int gl, int count) {
    int best_slot = 0;
    float best = s.adv[gl];
    for (int i = 1; i < count; ++i) {
      const float adv = s.adv[i * ADV_STRIDE + gl];
      if (adv > best) {
        best = adv;
        best_slot = i;
      }
    }
    return best_slot;
  }
};

// -------------------------------------------------------------------- loop

// Game gl's features into column gl of the tile x: P | len/row | last/row |
// pts/row | board, then every seat's hand (observation order, hand last).
__device__ inline void write_features(const Cfg& c, const Rows& rows, const int* board,
                                      const int* hands, float* x, int gl) {
  float* col = x + gl;
  int f = 0;
  col[f++ * PLAY_GAMES] = (float)c.P;
  if (c.include_summaries) {
    for (int r = 0; r < c.R; ++r) col[f++ * PLAY_GAMES] = (float)rows.len[r];
    for (int r = 0; r < c.R; ++r) col[f++ * PLAY_GAMES] = (float)rows.last[r];
    for (int r = 0; r < c.R; ++r) col[f++ * PLAY_GAMES] = (float)rows.pts[r];
  }
  for (int i = 0; i < c.R * c.T; ++i) col[f++ * PLAY_GAMES] = (float)board[i];
  for (int i = 0; i < c.P * c.H; ++i) col[f++ * PLAY_GAMES] = (float)hands[i];
}

// Bytes of dynamic shared memory a play-loop kernel with this actor and emitter needs.
template <class Actor, class Emit>
inline size_t play_smem_bytes(const Cfg& c, int S, int A) {
  return PlayLayout(c, S, A, Actor::adv_rows(c.H, A), Emit::stage_bytes(c.P, S)).bytes;
}

template <class Actor, class Emit>
__device__ __forceinline__ void play_games(const PlayArgs& a, Actor& actor, Emit& emit) {
  const Cfg& c = a.c;
  const PlayLayout L(c, a.S, a.A, Actor::adv_rows(c.H, a.A), Emit::stage_bytes(c.P, a.S));
  const PlaySmem s(play_smem(), L);
  const int H = c.H, P = c.P, n_game = a.S - H;
  const int NC = (a.Hd + HIDDEN_CHUNK - 1) / HIDDEN_CHUNK;  // chunks of the hidden layer
  const int gl = threadIdx.x, g0 = blockIdx.x * PLAY_GAMES, g = g0 + gl;
  const int nb = min(PLAY_GAMES, a.G - g0);
  const bool worker = gl >= 32;
  const bool game = gl < nb;  // this thread plays game g
  const PlayTile tile{s.x, s.stage, n_game, H, P, a.S, g0, nb};

  int* hands = s.hands + gl * L.hs;
  int* board = s.board + gl * L.bs;
  Rows& rows = *reinterpret_cast<Rows*>(s.rows + gl * ROWS_STRIDE);
  int* cards = s.scratch + gl * L.ss;  // the seats' cards in seat order
  int* sorted = cards + P;             // resolve_plays' scratch
  int* players = sorted + P;
  int* rew = players + P;
  int* seeds = rew + P;
  if (game) {
    deal(c, a.seed, (uint32_t)g, hands, seeds, s.deck + gl * c.C);
    for (int r = 0; r < c.R; ++r) {
      board[r * c.T] = seeds[r];
      for (int t = 1; t < c.T; ++t) board[r * c.T + t] = -1;
    }
    seed_aggregates(c, seeds, rows);
    write_features(c, rows, board, hands, s.x, gl);
  } else if (gl < PLAY_GAMES) {  // past the ragged edge: a zero feature column
    for (int f = 0; f < L.F; ++f) s.x[f * PLAY_GAMES + gl] = 0.f;
  }
  if (worker) stage_weights(a, s, 0, 0);
  __syncthreads();

  // Per turn the workers store the observations and run the forward, while
  // the game warp waits for each seat's advantages, then picks; between
  // turns the workers stage the next weights while the game warp resolves
  // the turn and writes the next features.
  HiddenTiles hidden;
  for (int t = 0; t < a.n_turns; ++t) {
    const int count = H - t;
    if (worker) {
      emit.flush(t, tile);
      if (NC == 1) hidden.shared_part(s, H, n_game);
    }
    for (int p = 0; p < P; ++p) {
      for (int ch = 0; ch < NC; ++ch) {
        if (worker) {
          if (NC > 1) {  // chunk 0 of seat 0 was staged before the turn
            if (ch > 0 || p > 0) {
              worker_sync();  // the last chunk's h, w1 and wa are read
              stage_weights(a, s, t, ch);
              worker_sync();
            }
            hidden.shared_part(s, H, n_game);
          }
          hidden.seat(s, H, n_game, p);
        }
        if (ch == 0)
          __syncthreads();  // h is ready, and the game warp has picked seat p-1 from adv
        else if (worker)
          worker_sync();  // h of chunk ch is ready
        if (worker) actor.head(s, tile, p, count, ch);
      }
      __syncthreads();  // seat p's advantages are ready; h and adv are free after the pick
      if (game) {
        int* hand = hands + p * H;
        const int slot = actor.pick(s, gl, count);
        cards[p] = hand[slot];
        emit.action(t, g, p, hand[slot]);
        remove_slot(hand, count, slot);
      }
    }
    if (game) {
      resolve_plays(c, board, rows, cards, rew, sorted, players);
      emit.rewards(t, g, rew);
    }
    // t + 1 == n_turns: the terminal observation, the n-step bootstrap target.
    if (game) write_features(c, rows, board, hands, s.x, gl);
    if (worker && t + 1 < a.n_turns) stage_weights(a, s, t + 1, 0);
    __syncthreads();
  }
  if (worker) emit.flush(a.n_turns, tile);
}

// ------------------------------------------------------------------- host

// Launch a play-loop kernel over G games (one block per PLAY_GAMES); above
// 48 KB of dynamic shared memory the kernel is allowed it first.
template <class... KArgs, class... Args>
inline int launch_play(void (*kernel)(KArgs...), int G, size_t smem, cudaStream_t stream,
                       Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0) return 0;
  kernel<<<(G + PLAY_GAMES - 1) / PLAY_GAMES, PLAY_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace rl6
