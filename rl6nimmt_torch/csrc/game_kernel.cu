// K2 (deal_games) and K3 (play_random_games).
//
// Replaces: rl6nimmt_tpu/ops/game_kernel.py:_deal_kernel (K2; the deal body is
// _deal_in_kernel with _bitonic_sort_packed and _seed_hash) and
// _selfdeal_game_kernel + _play_turns (K3).
//
// Bound on the H100.  K2: bytes -- it writes the board, row lengths and sorted
// hands, ~1.1 MB at G=4096, P=4 (~0.34 us at 3.35 TB/s).  K3: integer
// operations -- its only output is 20 bytes a game, while each game costs 21
// Philox blocks (44 deal draws + 40 picks), a 44-step Fisher-Yates and 40
// sub-plays.  Neither comes near its bound: what sets the time is the
// dependent chain of one game (the Fisher-Yates swaps, then the turns) and the
// launch.  At 4x the games both take only 1.5-2.3x as long on an H100.
//
// Design (Hopper).  A block holds GAMES = 32 games and THREADS = 128 threads,
// so G=4096 is 128 blocks, one per SM.  The TPU shuffled with a 24-bit-key
// bitonic network because its 128-lane min/max registers suited that; here a
// game runs the partial Fisher-Yates of game.cuh's deal() over the P*H + R
// positions it deals, with the same Philox draws, so the deals are deal()'s.
//   1. All four warps draw the Philox blocks of the block's games into shared
//      memory (words[block][game], 16 bytes each: the deal's blocks of
//      STREAM_DEAL and, in K3's flagship instance, the picks' blocks of
//      STREAM_PLAY) and fill each game's deck 0..C-1, four cards a store.
//      The words do not depend on the game, so none of this waits on a chain.
//   2. Warp 0: one thread per game runs the draws (fy_draw) on its deck of C
//      bytes in shared memory, the only state indexed at run time, with the
//      words loaded ahead of the swaps.
//   3. One (game, seat) a thread: the seat's H cards become a card set
//      (game.cuh set_*), so no hand is sorted.  K2 stores each card at slot
//      rank(card) of a shared stage, then all threads write the hands, the
//      board (seed cards, -1 elsewhere) and the row lengths (1) as one
//      contiguous run each, 16 bytes a store over the run's aligned quads.
//   4. K3 plays max_turns turns on the row aggregates alone (the board is
//      never materialised): per turn the observation checksum term, each
//      seat's pick set_select((word * count) >> 32) and set_remove, the P
//      picks packed card << 8 | points << 4 | seat and sorted by card, then
//      the P sub-plays, whose row searches are a max and a min over packed
//      (value << 3 | row) keys.  hand_sum (the hand block of the checksum)
//      drops by pick + 1 a pick.  The checksum is integer-valued and below
//      2^24 per game, so the float written at the end is exact.
// (P, R, T, H, C) are template arguments for the flagship shape (4, 4, 6, 10,
// 104), where every loop over seats, rows and set words unrolls.  There K3
// plays a game on four lanes, one a seat (play_seat_lanes): the sets, the row
// aggregates and the totals live in registers, indexed at compile time only.
// One game a thread took 1.6x the device time: a lone warp per scheduler waits
// out the latency of every dependent instruction of a turn, and the lanes
// split the picks, the largest part.  Every other shape the wrapper accepts
// (C <= 128, P <= 16, R <= 8, T <= 8, H <= 16) runs the runtime-sized
// instance: one game a thread of warp 0 on the game's shared slice (sets,
// game.cuh Rows, picks, totals; an insertion sort), the picks' words read
// in-thread (game.cuh Stream).  Neither instance keeps a runtime-indexed local
// array.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "game.cuh"

namespace {

constexpr int GAMES = 32;     // games a block
constexpr int THREADS = 128;  // threads a block: a seat each in the flagship K3
constexpr int ROWS_STRIDE = sizeof(rl6::Rows) / sizeof(int) + 1;  // odd: distinct banks

static_assert(sizeof(rl6::Rows) % sizeof(int) == 0, "Rows is a block of ints");
static_assert(rl6::MAX_R <= 8 && rl6::MAX_P <= 16, "packed keys: 3 bits of row, 4 of seat");

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t start = at;
  at = (at + bytes + 15) & ~(size_t)15;
  return start;
}

// Byte offsets of a block's dynamic shared memory (the same on host and
// device).  `play`: K3 (else K2); `play_words`: K3's picks drawn into shared
// memory (the flagship instance) rather than in-thread.
struct Layout {
  int bd, bp, ds, hs, rs, ss, ks;
  size_t words, deck, hands, seeds, sets, rows, scratch, bytes;

  __host__ __device__ Layout(const rl6::Cfg& c, bool play, bool play_words) {
    bd = (c.P * c.H + c.R + 3) / 4;                     // Philox blocks of the deal
    bp = play && play_words ? (c.P * c.H + 3) / 4 : 0;  // ... and of the picks
    ds = (c.C + 3) & ~3;                                // deck bytes a game
    hs = (c.P * c.H) | 1;                               // odd strides: distinct banks
    rs = c.R | 1;
    ss = ((rl6::SET_WORDS + 1) * c.P) | 1;              // the seats' sets, then their card sums
    ks = (2 * c.P) | 1;                                 // picks, then totals
    const bool runtime_play = play && !play_words;
    size_t at = 0;
    words = take(at, sizeof(uint4) * GAMES * (bd + bp));
    deck = take(at, (size_t)GAMES * ds);
    hands = take(at, play ? 0 : sizeof(int) * GAMES * hs);
    seeds = take(at, play ? 0 : sizeof(int) * GAMES * rs);
    sets = take(at, runtime_play ? sizeof(uint32_t) * GAMES * ss : 0);
    rows = take(at, runtime_play ? sizeof(int) * GAMES * ROWS_STRIDE : 0);
    scratch = take(at, runtime_play ? sizeof(int) * GAMES * ks : 0);
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
__device__ __forceinline__ rl6::Cfg sizes(const rl6::Cfg& runtime_cfg) {
  if constexpr (kP > 0) return rl6::Cfg{kP, kR, kT, kH, kC, runtime_cfg.include_summaries};
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
    const rl6::Words w = rl6::philox4x32_10((uint32_t)(g0 + gl), (uint32_t)(deal ? b : b - L.bd),
                                            deal ? rl6::STREAM_DEAL : rl6::STREAM_PLAY, 0u, k0, k1);
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
__device__ __forceinline__ void shuffle_deck(const rl6::Cfg& c, const Layout& L, unsigned char* smem, int gl) {
  const uint4* words = reinterpret_cast<const uint4*>(smem + L.words) + gl;
  uint8_t* deck = smem + L.deck + gl * L.ds;
  const int n = c.P * c.H + c.R;
  if constexpr (kBlocks > 0) {
    uint4 w[kBlocks];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) w[b] = words[b * GAMES];
#pragma unroll
    for (int i = 0; i < 4 * kBlocks; ++i)
      if (i < n) rl6::fy_draw(deck, i, c.C, lane_of(w[i / 4], i % 4));
  } else {
    for (int b = 0; b < L.bd; ++b) {
      const uint4 w = words[b * GAMES];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * b + k < n) rl6::fy_draw(deck, 4 * b + k, c.C, lane_of(w, k));
    }
  }
}

// Step 3: seat p's hand (deck slots [p*H, p*H + H)) as a card set; returns its card sum.
__device__ __forceinline__ int seat_set(const uint8_t* deck, int H, int p, uint32_t (&set)[rl6::SET_WORDS]) {
  int sum = 0;
#pragma unroll
  for (int k = 0; k < rl6::SET_WORDS; ++k) set[k] = 0u;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int card = deck[p * H + i];
    rl6::set_insert(set, card);
    sum += card;
  }
  return sum;
}

// Words [0, count) of a block's run out of f(i): 16 bytes a store, the last
// count % 4 words one at a time.  `out` is 16-byte aligned: the arrays are
// (the C entry checks) and a block's run starts at word 32 * blockIdx.x * n.
template <class F>
__device__ __forceinline__ void store_run(int* out, int count, const F& f) {
  const int quads = count / 4;
  for (int q = threadIdx.x; q < quads; q += THREADS)
    *reinterpret_cast<int4*>(out + 4 * q) = make_int4(f(4 * q), f(4 * q + 1), f(4 * q + 2), f(4 * q + 3));
  for (int i = 4 * quads + threadIdx.x; i < count; i += THREADS) out[i] = f(i);
}

// Board [G, R, T], row_len [G, R], hands [G, P, H].
template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    deal_games_kernel(uint64_t seed, int* __restrict__ board_out, int* __restrict__ len_out,
                      int* __restrict__ hands_out, int G, rl6::Cfg runtime_cfg) {
  const rl6::Cfg c = sizes<kP, kR, kT, kH, kC>(runtime_cfg);
  const Layout L(c, false, false);
  unsigned char* smem = block_smem();
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, G - g0);
  const int PH = c.P * c.H, RT = c.R * c.T;
  int* hands = reinterpret_cast<int*>(smem + L.hands);
  int* seeds = reinterpret_cast<int*>(smem + L.seeds);

  draw_words_and_decks(L, smem, seed, g0, ng);
  __syncthreads();
  if (threadIdx.x < ng) {
    const int gl = threadIdx.x;
    shuffle_deck<deal_blocks<kP, kR, kH>()>(c, L, smem, gl);
    const uint8_t* deck = smem + L.deck + gl * L.ds;
#pragma unroll
    for (int r = 0; r < c.R; ++r) seeds[gl * L.rs + r] = deck[PH + r];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < c.P * GAMES; q += THREADS) {
    const int gl = q % GAMES, p = q / GAMES;
    if (gl >= ng) continue;
    const uint8_t* deck = smem + L.deck + gl * L.ds;
    uint32_t set[rl6::SET_WORDS];
    seat_set(deck, c.H, p, set);
    int* hand = hands + gl * L.hs + p * c.H;
#pragma unroll
    for (int i = 0; i < c.H; ++i) {
      const int card = deck[p * c.H + i];
      hand[rl6::set_rank(set, card)] = card;
    }
  }
  __syncthreads();

  store_run(hands_out + (size_t)g0 * PH, ng * PH, [&](int i) { return hands[(i / PH) * L.hs + i % PH]; });
  store_run(board_out + (size_t)g0 * RT, ng * RT, [&](int i) {
    const int cell = i % RT;
    return cell % c.T ? -1 : seeds[(i / RT) * L.rs + cell / c.T];
  });
  store_run(len_out + (size_t)g0 * c.R, ng * c.R, [](int) { return 1; });
}

// Observation checksum term of a turn: every seat's hand block plus P copies
// of the game block.  Empty board cells hold -1: board sum = csum - (T - len).
__device__ __forceinline__ int checksum_term(const rl6::Cfg& c, int hand_sum, int len_sum, int pts_sum,
                                             int high_sum, int csum_sum) {
  const int board_sum = csum_sum + len_sum - c.R * c.T;
  const int game_block =
      c.include_summaries ? c.P + len_sum + high_sum + pts_sum + board_sum : c.P + board_sum;
  return hand_sum + c.P * game_block;
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
// or MAX_R at a runtime one (the arrays of a Rows in shared memory, rows past
// R skipped).  Returns the penalty.
template <int kRows>
__device__ __forceinline__ int subplay(int R, int T, int (&len)[kRows], int (&pts)[kRows], int (&last)[kRows],
                                       int (&csum)[kRows], int key) {
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
  }
  return captures ? old_pts : 0;
}

// K3's turns at a constant shape, P lanes a game (P divides 32): lane p plays
// seat p.  Each lane keeps its seat's card set, card sum and total, and a copy
// of the row aggregates, all in registers.  Per turn each lane picks for its
// seat, a shuffle gathers the game's P keys, every lane sorts them with a
// compare-exchange network and runs the P sub-plays, and each keeps the
// penalties of its own seat.  Lane p adds its hand block to the checksum,
// lane 0 also the P game blocks; two shuffles sum the lanes at the end.  All
// lanes play (past the ragged edge on a deck of garbage), so every shuffle
// has the full warp; only the stores are masked.
template <int P, int R, int T, int H>
__device__ __forceinline__ void play_seat_lanes(const rl6::Cfg& c, const Layout& L, const unsigned char* smem,
                                                int gl, int p, bool live, int* rewards, float* checksum_out) {
  static_assert(32 % P == 0, "a game's lanes in one warp");
  const uint8_t* deck = smem + L.deck + gl * L.ds;
  const uint4* words = reinterpret_cast<const uint4*>(smem + L.words) + L.bd * GAMES + gl;
  uint32_t set[rl6::SET_WORDS];
  int hand_sum = seat_set(deck, H, p, set);
  int len[R], pts[R], last[R], csum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = deck[P * H + r];
    len[r] = 1;
    pts[r] = points_of(s);
    last[r] = s;
    csum[r] = s;
  }
  const int base = (int)(threadIdx.x & 31u) & ~(P - 1);  // the game's first lane
  int total = 0;
  long long checksum = 0;

#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    const int count = H - t;
    int len_sum = 0, pts_sum = 0, high_sum = 0, csum_sum = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      len_sum += len[r];
      pts_sum += pts[r];
      high_sum += last[r];
      csum_sum += csum[r];
    }
    checksum += p == 0 ? checksum_term(c, hand_sum, len_sum, pts_sum, high_sum, csum_sum) : hand_sum;

    const int i = t * P + p;  // the pick's word: word i % 4 of block i / 4
    const uint32_t word = lane_of(words[(i >> 2) * GAMES], i & 3);
    const int pick = rl6::set_select(set, (int)__umulhi(word, (uint32_t)count));
    rl6::set_remove(set, pick);
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
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int penalty = subplay<R>(R, T, len, pts, last, csum, key[j]);
      total -= (key[j] & 15) == p ? penalty : 0;
    }
  }
#pragma unroll
  for (int m = 1; m < P; m <<= 1) checksum += __shfl_xor_sync(0xFFFFFFFFu, checksum, m);
  if (!live) return;
  rewards[p] = total;
  if (p == 0) *checksum_out = (float)checksum;
}

// K3's turns at a runtime shape, on the game's shared slice: sets, row
// aggregates, picks and totals; the picks' words read in-thread.
__device__ __forceinline__ void play_in_shared(const rl6::Cfg& c, const Layout& L, unsigned char* smem, int gl,
                                               uint64_t seed, uint32_t game, int* rewards, float* checksum_out) {
  const uint8_t* deck = smem + L.deck + gl * L.ds;
  uint32_t* sets = reinterpret_cast<uint32_t*>(smem + L.sets) + gl * L.ss;
  rl6::Rows& a = *reinterpret_cast<rl6::Rows*>(reinterpret_cast<int*>(smem + L.rows) + gl * ROWS_STRIDE);
  int* key = reinterpret_cast<int*>(smem + L.scratch) + gl * L.ks;
  int* total = key + c.P;
  int hand_sum = 0;
  for (int p = 0; p < c.P; ++p) {
    hand_sum += (int)sets[rl6::SET_WORDS * c.P + p];
    total[p] = 0;
  }
  for (int r = 0; r < c.R; ++r) {
    const int s = deck[c.P * c.H + r];
    a.len[r] = 1;
    a.pts[r] = points_of(s);
    a.last[r] = s;
    a.csum[r] = s;
  }
  rl6::Stream picks(seed, game, rl6::STREAM_PLAY);
  long long checksum = 0;
  for (int t = 0; t < c.H; ++t) {
    const int count = c.H - t;
    int len_sum = 0, pts_sum = 0, high_sum = 0, csum_sum = 0;
    for (int r = 0; r < c.R; ++r) {
      len_sum += a.len[r];
      pts_sum += a.pts[r];
      high_sum += a.last[r];
      csum_sum += a.csum[r];
    }
    checksum += checksum_term(c, hand_sum, len_sum, pts_sum, high_sum, csum_sum);
    for (int p = 0; p < c.P; ++p) {
      uint32_t* s = sets + rl6::SET_WORDS * p;
      const int pick = rl6::set_select(s, picks.below(count));
      rl6::set_remove(s, pick);
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
      total[key[i] & 15] -= subplay<rl6::MAX_R>(c.R, c.T, a.len, a.pts, a.last, a.csum, key[i]);
  }
  for (int p = 0; p < c.P; ++p) rewards[p] = total[p];
  *checksum_out = (float)checksum;
}

// Rewards [G, P], checksum [G].
template <int kP, int kR, int kT, int kH, int kC>
__global__ void __launch_bounds__(THREADS)
    play_random_games_kernel(uint64_t seed, int* __restrict__ rewards_out, float* __restrict__ checksum_out,
                             int G, rl6::Cfg runtime_cfg) {
  constexpr bool kConst = kP > 0;
  static_assert(!kConst || kP * GAMES == THREADS, "the flagship instance plays a seat a thread");
  const rl6::Cfg c = sizes<kP, kR, kT, kH, kC>(runtime_cfg);
  const Layout L(c, true, kConst);
  unsigned char* smem = block_smem();
  const int g0 = blockIdx.x * GAMES, ng = min(GAMES, G - g0);

  draw_words_and_decks(L, smem, seed, g0, ng);
  __syncthreads();
  if (threadIdx.x < ng) shuffle_deck<deal_blocks<kP, kR, kH>()>(c, L, smem, threadIdx.x);
  __syncthreads();
  if constexpr (kConst) {
    const int gl = threadIdx.x / kP, g = g0 + gl;
    play_seat_lanes<kP, kR, kT, kH>(c, L, smem, gl, threadIdx.x % kP, gl < ng, rewards_out + (size_t)g * kP,
                                    checksum_out + g);
  } else {
    for (int q = threadIdx.x; q < c.P * GAMES; q += THREADS) {  // the seats' sets into the game slices
      const int gl = q % GAMES, p = q / GAMES;
      if (gl >= ng) continue;
      uint32_t set[rl6::SET_WORDS];
      const int sum = seat_set(smem + L.deck + gl * L.ds, c.H, p, set);
      uint32_t* slice = reinterpret_cast<uint32_t*>(smem + L.sets) + gl * L.ss;
#pragma unroll
      for (int k = 0; k < rl6::SET_WORDS; ++k) slice[rl6::SET_WORDS * p + k] = set[k];
      slice[rl6::SET_WORDS * c.P + p] = (uint32_t)sum;
    }
    __syncthreads();
    if (threadIdx.x >= ng) return;  // the last barrier is behind
    const int gl = threadIdx.x, g = g0 + gl;
    play_in_shared(c, L, smem, gl, seed, (uint32_t)g, rewards_out + (size_t)g * c.P, checksum_out + g);
  }
}

bool accepted(const rl6::Cfg& c) {
  return c.P >= 1 && c.P <= rl6::MAX_P && c.R >= 1 && c.R <= rl6::MAX_R && c.T >= 1 && c.T <= rl6::MAX_T &&
         c.H >= 1 && c.H <= rl6::MAX_H && c.C <= rl6::MAX_C && c.P * c.H + c.R <= c.C;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool flagship(const rl6::Cfg& c) { return c.P == 4 && c.R == 4 && c.T == 6 && c.H == 10 && c.C == 104; }

}  // namespace

// Games and threads a K2/K3 block: the launch shape, for the reports.
extern "C" int rl6_game_games(void) { return GAMES; }
extern "C" int rl6_game_threads(void) { return THREADS; }

extern "C" int rl6_deal_games(uint64_t seed, void* board_out, void* len_out, void* hands_out, int G, int P,
                              int R, int T, int H, int C, void* stream) {
  const rl6::Cfg c{P, R, T, H, C, 0};
  if (!accepted(c) || !aligned16(board_out) || !aligned16(len_out) || !aligned16(hands_out))
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  auto kernel = flagship(c) ? &deal_games_kernel<4, 4, 6, 10, 104> : &deal_games_kernel<0, 0, 0, 0, 0>;
  kernel<<<(G + GAMES - 1) / GAMES, THREADS, Layout(c, false, false).bytes, (cudaStream_t)stream>>>(
      seed, (int*)board_out, (int*)len_out, (int*)hands_out, G, c);
  return (int)cudaGetLastError();
}

extern "C" int rl6_play_random_games(uint64_t seed, void* rewards_out, void* checksum_out, int G, int P, int R,
                                     int T, int H, int C, int include_summaries, void* stream) {
  const rl6::Cfg c{P, R, T, H, C, include_summaries};
  if (!accepted(c)) return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  const bool constant = flagship(c);
  auto kernel = constant ? &play_random_games_kernel<4, 4, 6, 10, 104> : &play_random_games_kernel<0, 0, 0, 0, 0>;
  kernel<<<(G + GAMES - 1) / GAMES, THREADS, Layout(c, true, constant).bytes, (cudaStream_t)stream>>>(
      seed, (int*)rewards_out, (float*)checksum_out, G, c);
  return (int)cudaGetLastError();
}
