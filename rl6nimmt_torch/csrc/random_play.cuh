// Whole uniform-legal random games in K3's design, shared by K3
// (game_kernel.cu play_random_games_kernel) and K6's env and obs variants
// (act_ablate_kernel.cu), which play the same games.
//
// A block holds GAMES = 32 games and THREADS = 128 threads.  The deal
// (deal_block):
//   1. all four warps draw the Philox blocks of the block's games into shared
//      memory (words[block][game], 16 bytes each: the deal's blocks of
//      STREAM_DEAL and, at the flagship shape, the picks' blocks of
//      STREAM_PLAY) and fill each game's deck 0..C-1, four cards a store.
//      The words do not depend on the game, so none of this waits on a chain;
//   2. warp 0, one thread a game, runs the partial Fisher-Yates of game.cuh's
//      deal() (fy_draw) on its C-byte deck in shared memory, the only state
//      indexed at run time, with deal()'s draws, so the deals are deal()'s.
// The play: seat p at turn t plays hand slot (word * count) >> 32 of its
// game's STREAM_PLAY word t*P + p, a hand being a card set (game.cuh set_*);
// the P picks, packed card << 8 | points << 4 | seat and sorted by card,
// resolve as game.cuh apply_subplay does, on the row aggregates alone.
//   * play_seat_lanes, at the flagship shape (4, 4, 6, 10, 104), every loop
//     over seats, rows and set words unrolled: a game on four lanes, one a
//     seat, each holding its seat's set and a copy of the rows in registers,
//     indexed at compile time only.  One game a thread took 1.6x the device
//     time: a lone warp per scheduler waits out the latency of every
//     dependent instruction of a turn, and the lanes split the picks.
//   * play_in_shared, every other shape (C <= 128, P <= 16, R <= 8, T <= 8,
//     H <= 16): one game a thread of warp 0 on the game's shared slice (sets,
//     game.cuh Rows, picks, totals; an insertion sort), the picks' words read
//     in-thread (game.cuh Stream).
// Neither keeps a runtime-indexed local array.
//
// A Hook sees the play.  observe(t, ...) before turn t's picks, with the
// seat's set (play_in_shared: the P sets) and the rows; played(t, ...) after
// its sub-plays; flush(t) at the end of the turn, reached by every thread of
// the block; end(total) once after the last turn.  Hook::kBoard keeps each
// row's cells too, as the bytes of one 64-bit word (0xFF an empty cell), and
// Hook::kTerminal observes (and flushes) the state after the last turn.  K3's
// hooks add up its checksum and store totals; K6's store the trajectory.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "game.cuh"

namespace rl6::random_games {

constexpr int GAMES = 32;     // games a block
constexpr int THREADS = 128;  // threads a block: a seat each at the flagship shape
constexpr int ROWS_STRIDE = sizeof(Rows) / sizeof(int) + 1;  // odd: distinct banks
constexpr int CELLS_STRIDE = MAX_R + 1;                       // board words a game's slice
constexpr uint64_t ONE_CARD_ROW = ~0xFFull;                   // | card: a row of that card alone

static_assert(sizeof(Rows) % sizeof(int) == 0, "Rows is a block of ints");
static_assert(MAX_R <= 8 && MAX_P <= 16, "packed keys: 3 bits of row, 4 of seat");
static_assert(MAX_T <= 8 && MAX_C <= 128, "a board row is 8 bytes of cards below 0xFF");
static_assert(GAMES <= 32, "the game threads are warp 0");

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t start = at;
  at = (at + bytes + 15) & ~(size_t)15;
  return start;
}

// Byte offsets of a block's dynamic shared memory (the same on host and
// device).  `play`: K3 or K6 (else K2); `play_words`: the picks drawn into
// shared memory (the flagship instance) rather than in-thread; `trajectory`:
// K6, whose runtime-sized slices also hold the board and the last totals;
// `stage_bytes`: K6 obs's observation stage.
struct Layout {
  int bd, bp, ds, hs, rs, ss, ks;
  size_t words, deck, hands, seeds, sets, rows, scratch, cells, stage, bytes;

  __host__ __device__ Layout(const Cfg& c, bool play, bool play_words, bool trajectory = false,
                             size_t stage_bytes = 0) {
    bd = (c.P * c.H + c.R + 3) / 4;                     // Philox blocks of the deal
    bp = play && play_words ? (c.P * c.H + 3) / 4 : 0;  // ... and of the picks
    ds = (c.C + 3) & ~3;                                // deck bytes a game
    hs = (c.P * c.H) | 1;                               // odd strides: distinct banks
    rs = c.R | 1;
    ss = ((SET_WORDS + 1) * c.P) | 1;                   // the seats' sets, then their card sums
    ks = ((trajectory ? 3 : 2) * c.P) | 1;              // picks, totals (, the last turn's totals)
    const bool runtime_play = play && !play_words;
    size_t at = 0;
    words = take(at, sizeof(uint4) * GAMES * (bd + bp));
    deck = take(at, (size_t)GAMES * ds);
    hands = take(at, play ? 0 : sizeof(int) * GAMES * hs);
    seeds = take(at, play ? 0 : sizeof(int) * GAMES * rs);
    sets = take(at, runtime_play ? sizeof(uint32_t) * GAMES * ss : 0);
    rows = take(at, runtime_play ? sizeof(int) * GAMES * ROWS_STRIDE : 0);
    scratch = take(at, runtime_play ? sizeof(int) * GAMES * ks : 0);
    cells = take(at, runtime_play && trajectory ? sizeof(uint64_t) * GAMES * CELLS_STRIDE : 0);
    stage = take(at, stage_bytes);
    bytes = at;
  }
};

__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ uint4 smem_u4[];
  return reinterpret_cast<unsigned char*>(smem_u4);
}

__device__ __forceinline__ uint32_t lane_of(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

template <int kP, int kR, int kT, int kH, int kC>
__device__ __forceinline__ Cfg sizes(const Cfg& runtime_cfg) {
  if constexpr (kP > 0) return Cfg{kP, kR, kT, kH, kC, runtime_cfg.include_summaries};
  return runtime_cfg;
}

// The deal's Philox blocks at a constant shape (P*H + R draws), else 0.
template <int kP, int kR, int kH>
__host__ __device__ constexpr int deal_blocks() {
  return kP > 0 ? (kP * kH + kR + 3) / 4 : 0;
}

// Step 1, all threads: Philox block b of game gl into words[b * GAMES + gl]
// (b < bd: block b of STREAM_DEAL, else block b - bd of STREAM_PLAY), and
// every game's deck 0..C-1, four cards a 32-bit store.
__device__ __forceinline__ void draw_words_and_decks(const Layout& L, unsigned char* smem, uint64_t seed,
                                                     int g0, int ng) {
  uint4* words = reinterpret_cast<uint4*>(smem + L.words);
  const uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFull), k1 = (uint32_t)(seed >> 32);
#pragma unroll 2
  for (int q = threadIdx.x; q < (L.bd + L.bp) * GAMES; q += THREADS) {
    const int b = q / GAMES, gl = q % GAMES;
    if (gl >= ng) continue;
    const bool deal = b < L.bd;
    const Words w = philox4x32_10((uint32_t)(g0 + gl), (uint32_t)(deal ? b : b - L.bd),
                                  deal ? STREAM_DEAL : STREAM_PLAY, 0u, k0, k1);
    words[q] = make_uint4(w.w[0], w.w[1], w.w[2], w.w[3]);
  }
  uint32_t* deck = reinterpret_cast<uint32_t*>(smem + L.deck);
  const int dw = L.ds / 4;
  for (int q = threadIdx.x; q < GAMES * dw; q += THREADS) deck[q] = 0x03020100u + 0x04040404u * (uint32_t)(q % dw);
}

// Step 2, game thread gl: the P*H + R draws on its deck; slots [0, P*H) end
// as the hands in seat order, slots [P*H, P*H + R) as the rows' seed cards.
// kBlocks: the deal's Philox blocks at a constant shape, whose words are all
// loaded into registers before the first swap; 0 at a runtime shape.
template <int kBlocks>
__device__ __forceinline__ void shuffle_deck(const Cfg& c, const Layout& L, unsigned char* smem, int gl) {
  const uint4* words = reinterpret_cast<const uint4*>(smem + L.words) + gl;
  uint8_t* deck = smem + L.deck + gl * L.ds;
  const int n = c.P * c.H + c.R;
  if constexpr (kBlocks > 0) {
    uint4 w[kBlocks];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) w[b] = words[b * GAMES];
#pragma unroll
    for (int i = 0; i < 4 * kBlocks; ++i)
      if (i < n) fy_draw(deck, i, c.C, lane_of(w[i / 4], i % 4));
  } else {
    for (int b = 0; b < L.bd; ++b) {
      const uint4 w = words[b * GAMES];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * b + k < n) fy_draw(deck, 4 * b + k, c.C, lane_of(w, k));
    }
  }
}

// Steps 1 and 2 for the block's games g0 .. g0 + ng - 1, between barriers.
template <int kBlocks>
__device__ __forceinline__ void deal_block(const Cfg& c, const Layout& L, unsigned char* smem, uint64_t seed,
                                           int g0, int ng) {
  draw_words_and_decks(L, smem, seed, g0, ng);
  __syncthreads();
  if ((int)threadIdx.x < ng) shuffle_deck<kBlocks>(c, L, smem, threadIdx.x);
  __syncthreads();
}

// Seat p's hand (deck slots [p*H, p*H + H)) as a card set; returns its card sum.
__device__ __forceinline__ int seat_set(const uint8_t* deck, int H, int p, uint32_t (&set)[SET_WORDS]) {
  int sum = 0;
#pragma unroll
  for (int k = 0; k < SET_WORDS; ++k) set[k] = 0u;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int card = deck[p * H + i];
    set_insert(set, card);
    sum += card;
  }
  return sum;
}

// play_in_shared's start, all threads: every (game, seat)'s set and card sum
// into the game's slice.  A barrier must follow.
__device__ __forceinline__ void fill_seat_slices(const Cfg& c, const Layout& L, unsigned char* smem, int ng) {
  for (int q = threadIdx.x; q < c.P * GAMES; q += THREADS) {
    const int gl = q % GAMES, p = q / GAMES;
    if (gl >= ng) continue;
    uint32_t set[SET_WORDS];
    const int sum = seat_set(smem + L.deck + gl * L.ds, c.H, p, set);
    uint32_t* slice = reinterpret_cast<uint32_t*>(smem + L.sets) + gl * L.ss;
#pragma unroll
    for (int k = 0; k < SET_WORDS; ++k) slice[SET_WORDS * p + k] = set[k];
    slice[SET_WORDS * c.P + p] = (uint32_t)sum;
  }
}

// game.cuh card_points without branches, for a card id 0 <= card < 128:
// divisibility of the face by 5 and by 11 as a multiply by the inverse mod 2^32.
// card_points' branches in the pick phase cost the flagship K3 a tenth of its
// device time on an H100 (0.0101 against 0.0091 ms at G=4096, kernel_times.py).
__device__ __forceinline__ int points_of(int card) {
  const uint32_t face = (uint32_t)card + 1u;
  const bool by5 = face * 0xCCCCCCCDu <= 0x33333333u, by11 = face * 0xBA2E8BA3u <= 0x1745D174u;
  const int p5 = by5 ? ((face & 1u) ? 2 : 3) : 1;
  return face == 55u ? 7 : by11 ? 5 : p5;
}

// A pick packed as card << 8 | its points << 4 | seat: sorting the keys sorts the cards.
__device__ __forceinline__ int pick_key(int card, int seat) {
  return card << 8 | points_of(card) << 4 | seat;
}

// One sub-play of key `key` (game.cuh apply_subplay, every row index
// compile-time): the card joins the row with the highest last card below it
// (a max over last << 3 | row of those rows); an undercut captures the
// cheapest row (a min over points << 3 | row: the first minimum); the T-th
// card captures.  kRows is R at a constant shape (the arrays are registers)
// or MAX_R at a runtime one (the arrays of a game's slice, rows past R
// skipped).  kCells: also the rows' cells (a card joins at byte len; a capture
// leaves the card alone in byte 0).  Returns the penalty.
template <int kRows, bool kCells>
__device__ __forceinline__ int subplay(int R, int T, int (&len)[kRows], int (&pts)[kRows], int (&last)[kRows],
                                       int (&csum)[kRows], uint64_t (&cells)[kRows], int key) {
  const int card = key >> 8, cpts = (key >> 4) & 15;
  int best = -1, cheap = INT_MAX;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= R) break;
    best = max(best, last[r] < card ? last[r] << 3 | r : -1);
    cheap = min(cheap, pts[r] << 3 | r);
  }
  const bool undercut = best < 0;
  const int row = (undercut ? cheap : best) & 7;
  int old_len = 0, old_pts = 0, old_csum = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= R) break;
    old_len = r == row ? len[r] : old_len;
    old_pts = r == row ? pts[r] : old_pts;
    old_csum = r == row ? csum[r] : old_csum;
  }
  const bool captures = undercut || old_len + 1 >= T;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= R) break;
    if (r != row) continue;
    len[r] = captures ? 1 : old_len + 1;
    pts[r] = captures ? cpts : old_pts + cpts;
    csum[r] = captures ? card : old_csum + card;
    last[r] = card;
    if constexpr (kCells) {  // old_len < T <= 8 when the card joins
      const int at = 8 * old_len;
      cells[r] = captures ? ONE_CARD_ROW | (uint64_t)card
                          : (cells[r] & ~(0xFFull << at)) | (uint64_t)card << at;
    }
  }
  return captures ? old_pts : 0;
}

// The turns at a constant shape, P lanes a game (P divides 32): lane p plays
// seat p.  Each lane keeps its seat's card set and card sum, its total and a
// copy of the rows, all in registers.  Per turn each lane picks for its seat,
// a shuffle gathers the game's P keys, every lane sorts them with a
// compare-exchange network and runs the P sub-plays, and each keeps the
// penalty of its own seat.  All lanes play (past the ragged edge on a deck of
// garbage), so every shuffle has the full warp and every thread of the block
// reaches the hook's flush; the hook masks the stores.
template <int P, int R, int T, int H, class Hook>
__device__ __forceinline__ void play_seat_lanes(const Cfg& c, const Layout& L, const unsigned char* smem, int gl,
                                                int p, Hook& hook) {
  static_assert(32 % P == 0, "a game's lanes in one warp");
  const uint8_t* deck = smem + L.deck + gl * L.ds;
  const uint4* words = reinterpret_cast<const uint4*>(smem + L.words) + L.bd * GAMES + gl;
  uint32_t set[SET_WORDS];
  int hand_sum = seat_set(deck, H, p, set);
  int len[R], pts[R], last[R], csum[R];
  uint64_t cells[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = deck[P * H + r];
    len[r] = 1;
    pts[r] = points_of(s);
    last[r] = s;
    csum[r] = s;
    cells[r] = ONE_CARD_ROW | (uint64_t)s;
  }
  const int base = (int)(threadIdx.x & 31u) & ~(P - 1);  // the game's first lane
  int total = 0;

#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    const int count = H - t;
    hook.observe(t, set, hand_sum, len, pts, last, csum, cells);
    const int i = t * P + p;  // the pick's word: word i % 4 of block i / 4
    const uint32_t word = lane_of(words[(i >> 2) * GAMES], i & 3);
    const int pick = set_select(set, (int)__umulhi(word, (uint32_t)count));
    set_remove(set, pick);
    hand_sum -= pick + 1;  // removed card, new -1 pad
    const int mine = pick_key(pick, p);
    int key[P];
#pragma unroll
    for (int j = 0; j < P; ++j) key[j] = __shfl_sync(0xFFFFFFFFu, mine, base + j);
#pragma unroll
    for (int a = 0; a < P; ++a)  // bubble network, as the TPU kernel sorts
#pragma unroll
      for (int j = 0; j + 1 < P - a; ++j) {
        const int lo = min(key[j], key[j + 1]), hi = max(key[j], key[j + 1]);
        key[j] = lo;
        key[j + 1] = hi;
      }
    int paid = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int penalty = subplay<R, Hook::kBoard>(R, T, len, pts, last, csum, cells, key[j]);
      paid += (key[j] & 15) == p ? penalty : 0;
    }
    total -= paid;
    hook.played(t, pick, paid);
    hook.flush(t);
  }
  if constexpr (Hook::kTerminal) {
    hook.observe(H, set, hand_sum, len, pts, last, csum, cells);
    hook.flush(H);
  }
  hook.end(total);
}

// The turns at a runtime shape, one game a thread on the game's shared slice
// (sets, row aggregates, cells, picks and totals; the picks' words read
// in-thread).  Every thread of the block that will reach a hook's flush calls
// it; `game` says whether this one plays game `game_id` in slice gl.
template <class Hook>
__device__ __forceinline__ void play_in_shared(const Cfg& c, const Layout& L, unsigned char* smem, int gl,
                                               bool game, uint64_t seed, uint32_t game_id, Hook& hook) {
  const uint8_t* deck = smem + L.deck + gl * L.ds;
  uint32_t* sets = reinterpret_cast<uint32_t*>(smem + L.sets) + gl * L.ss;
  Rows& a = *reinterpret_cast<Rows*>(reinterpret_cast<int*>(smem + L.rows) + gl * ROWS_STRIDE);
  uint64_t(&cells)[MAX_R] =
      *reinterpret_cast<uint64_t(*)[MAX_R]>(reinterpret_cast<uint64_t*>(smem + L.cells) + gl * CELLS_STRIDE);
  int* key = reinterpret_cast<int*>(smem + L.scratch) + gl * L.ks;
  int* total = key + c.P;
  int hand_sum = 0;
  if (game) {
    for (int p = 0; p < c.P; ++p) {
      hand_sum += (int)sets[SET_WORDS * c.P + p];
      total[p] = 0;
    }
    for (int r = 0; r < c.R; ++r) {
      const int s = deck[c.P * c.H + r];
      a.len[r] = 1;
      a.pts[r] = points_of(s);
      a.last[r] = s;
      a.csum[r] = s;
      if constexpr (Hook::kBoard) cells[r] = ONE_CARD_ROW | (uint64_t)s;
    }
  }
  Stream picks(seed, game_id, STREAM_PLAY);
  for (int t = 0; t < c.H; ++t) {
    if (game) {
      const int count = c.H - t;
      hook.observe(t, sets, hand_sum, a.len, a.pts, a.last, a.csum, cells);
      for (int p = 0; p < c.P; ++p) {
        uint32_t* s = sets + SET_WORDS * p;
        const int pick = set_select(s, picks.below(count));
        set_remove(s, pick);
        hand_sum -= pick + 1;
        key[p] = pick_key(pick, p);
      }
      for (int i = 1; i < c.P; ++i) {  // insertion sort of the keys
        const int v = key[i];
        int k = i;
        for (; k > 0 && key[k - 1] > v; --k) key[k] = key[k - 1];
        key[k] = v;
      }
      for (int i = 0; i < c.P; ++i)
        total[key[i] & 15] -= subplay<MAX_R, Hook::kBoard>(c.R, c.T, a.len, a.pts, a.last, a.csum, cells, key[i]);
      hook.played(t, key, total);
    }
    hook.flush(t);
  }
  if constexpr (Hook::kTerminal) {
    if (game) hook.observe(c.H, sets, hand_sum, a.len, a.pts, a.last, a.csum, cells);
    hook.flush(c.H);
  }
  if (game) hook.end(total);
}

// The shapes the kernels take, checked by the C entries (the wrappers check
// them first): C <= 128, P <= 16, R <= 8, T <= 8, H <= 16, enough cards.
inline bool accepted(const Cfg& c) {
  return c.P >= 1 && c.P <= MAX_P && c.R >= 1 && c.R <= MAX_R && c.T >= 1 && c.T <= MAX_T && c.H >= 1 &&
         c.H <= MAX_H && c.C <= MAX_C && c.P * c.H + c.R <= c.C;
}

// The shape with a constant-sized instance: 4 seats, 4 rows, threshold 6, hands of 10, 104 cards.
inline bool flagship(const Cfg& c) { return c.P == 4 && c.R == 4 && c.T == 6 && c.H == 10 && c.C == 104; }

}  // namespace rl6::random_games
