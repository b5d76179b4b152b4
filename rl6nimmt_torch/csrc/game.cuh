// Shared device code of the port's game kernels (K1-K3 and the K4/K5/K6 play loop).
//
// * philox4x32_10: the one random stream of the kernels and their plain
//   twins (rl6nimmt_torch/ops/philox.py).  Counter layout, identical there:
//     key     = (seed & 0xFFFFFFFF, seed >> 32)
//     counter = (game, draw block, stream, 0)
//   draw i of a game's stream is word i % 4 of block i / 4; a draw in [0, n)
//   is the multiply-high (uint64(word) * n) >> 32.
// * card_points: the 6 nimmt! scoring rule (reference env.py:224-239).
// * deal(): partial Fisher-Yates over the P*H + R dealt positions of a
//   per-thread deck, laid out like engine.init_from_deck.  The K4-K6 play
//   loop calls it.  K2 and K3 deal the same games with fy_draw on a deck in
//   shared memory and card sets (set_*) for the hands, so deal_games(seed)
//   reproduces the deals of K3 and K4.
// * Rows + row_aggregates + apply_subplay: one sub-play resolved on per-row
//   (points, last, card-sum) registers, as ops/step_kernel.py's
//   _row_aggregates/_apply_subplay do on the TPU.  The board cells are
//   optional (K3 never materialises them).
//
// Sizes are runtime values bounded by the MAX_* constants; the Python
// wrappers check the bounds before launching.  Functions that need scratch
// take it as a pointer: K1 and the play loop pass shared memory.
#pragma once

#include <cstdint>

namespace rl6 {

constexpr int MAX_P = 16;
constexpr int MAX_R = 8;
constexpr int MAX_T = 8;
constexpr int MAX_H = 16;
constexpr int MAX_C = 128;

constexpr uint32_t STREAM_DEAL = 0;
constexpr uint32_t STREAM_PLAY = 1;

struct Cfg {
  int P, R, T, H, C;
  int include_summaries;
};

// ------------------------------------------------------------------ Philox

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Words out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// Sequential reader of one game's stream: draw i = word i % 4 of block i / 4.
struct Stream {
  uint32_t k0, k1, game, stream, next;
  Words cur;

  __device__ Stream(uint64_t seed, uint32_t game_, uint32_t stream_)
      : k0((uint32_t)(seed & 0xFFFFFFFFull)), k1((uint32_t)(seed >> 32)),
        game(game_), stream(stream_), next(0) {}

  __device__ __forceinline__ uint32_t word() {
    const uint32_t n = next++, i = n & 3u;
    if (i == 0u) cur = philox4x32_10(game, n >> 2, stream, 0u, k0, k1);
    // Selects, not cur.w[i]: a runtime index would put `cur` in local memory.
    return i == 0u ? cur.w[0] : i == 1u ? cur.w[1] : i == 2u ? cur.w[2] : cur.w[3];
  }

  // Uniform draw in [0, n): multiply-high of one 32-bit word.
  __device__ __forceinline__ int below(int n) {
    return (int)(((uint64_t)word() * (uint64_t)n) >> 32);
  }
};

// ------------------------------------------------------------------ scoring

__device__ __forceinline__ int card_points(int card) {
  if (card < 0) return 0;
  const int face = card + 1;
  if (face == 55) return 7;
  if (face % 11 == 0) return 5;
  const int m10 = face % 10;
  if (m10 == 0) return 3;
  if (m10 == 5) return 2;
  return 1;
}

// ------------------------------------------------------------------ dealing

// Deal one game: hands[p*H + i] sorted ascending per seat, seeds[r] the card
// that starts row r.  Equivalent to init_from_deck on a deck whose slots
// [0, P*H) are the first P*H Fisher-Yates draws and whose slot C-1-r is draw
// P*H + r.  `deck` is C bytes of scratch.
__device__ inline void deal(const Cfg& c, uint64_t seed, uint32_t game, int* hands, int* seeds,
                            uint8_t* deck) {
  for (int i = 0; i < c.C; ++i) deck[i] = (uint8_t)i;
  Stream s(seed, game, STREAM_DEAL);
  const int PH = c.P * c.H;
  const int n = PH + c.R;
  for (int i = 0; i < n; ++i) {
    const int j = i + s.below(c.C - i);
    const uint8_t t = deck[i];
    deck[i] = deck[j];
    deck[j] = t;
  }
  for (int p = 0; p < c.P; ++p) {
    int* h = hands + p * c.H;
    for (int i = 0; i < c.H; ++i) {  // insertion sort of the seat's hand
      const int v = deck[p * c.H + i];
      int k = i;
      while (k > 0 && h[k - 1] > v) {
        h[k] = h[k - 1];
        --k;
      }
      h[k] = v;
    }
  }
  for (int r = 0; r < c.R; ++r) seeds[r] = deck[PH + r];
}

// ------------------------------------------------- the deal of K2 and K3
//
// K2 and K3 deal the same games as deal() with two changes to the data
// structures.  The deck lives in shared memory and takes one draw at a time
// (fy_draw), the only state indexed at run time.  A seat's hand is a card set
// (set_*), so dealing a card sets a bit and needs no sort: slot r of the
// sorted, -1-padded hand is the (r+1)-th smallest member.  K4-K6 keep deal().

// Draw i of the partial Fisher-Yates on a deck of bytes: swap slot i with slot
// i + ((word * (C - i)) >> 32), as deal() does.
__device__ __forceinline__ void fy_draw(uint8_t* deck, int i, int C, uint32_t word) {
  const int j = i + (int)__umulhi(word, (uint32_t)(C - i));
  const uint8_t at_i = deck[i], at_j = deck[j];
  deck[i] = at_j;
  deck[j] = at_i;
}

// A set of card ids < 128: bit (card & 31) of word card >> 5.  Every word
// index is compile-time (a select over the four words), so a set kept in a
// local array stays in registers.
constexpr int SET_WORDS = 4;

__device__ __forceinline__ void set_insert(uint32_t* s, int card) {
#pragma unroll
  for (int k = 0; k < SET_WORDS; ++k) s[k] |= (card >> 5) == k ? 1u << (card & 31) : 0u;
}

__device__ __forceinline__ void set_remove(uint32_t* s, int card) {
#pragma unroll
  for (int k = 0; k < SET_WORDS; ++k) s[k] &= (card >> 5) == k ? ~(1u << (card & 31)) : ~0u;
}

// Members below `card`: its slot in the sorted hand, when it is a member.
__device__ __forceinline__ int set_rank(const uint32_t* s, int card) {
  const int q = card >> 5;
  const uint32_t below = (1u << (card & 31)) - 1u;
  int n = 0;
#pragma unroll
  for (int k = 0; k < SET_WORDS; ++k) n += __popc(s[k] & (k < q ? ~0u : k == q ? below : 0u));
  return n;
}

// Bit position of the (n+1)-th set bit of x (n < popc(x)): a binary search on popcounts.
__device__ __forceinline__ int nth_set_bit(uint32_t x, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(x & ((1u << w) - 1u));
    if (n >= low) {
      n -= low;
      x >>= w;
      pos += w;
    }
  }
  return pos;
}

// The (r+1)-th smallest member (r < the set's size): hand slot r.
__device__ __forceinline__ int set_select(const uint32_t* s, int r) {
  uint32_t word = s[0];
  int base = 0;
  bool found = false;
#pragma unroll
  for (int k = 0; k < SET_WORDS; ++k) {
    const int n = __popc(s[k]);
    const bool here = !found && r < n;
    word = here ? s[k] : word;
    base = here ? 32 * k : base;
    r -= (!found && !here) ? n : 0;
    found = found || here;
  }
  return base + nth_set_bit(word, r);
}

// ------------------------------------------------------------- resolution

struct Rows {
  int len[MAX_R];
  int pts[MAX_R];   // row penalty including the last card
  int last[MAX_R];  // highest (= last appended) card
  int csum[MAX_R];  // sum of the filled card ids
};

// Aggregates of a materialised board (board[r*T + t], -1 for empty cells).
// Every cell is read and masked by the row length, as the TPU's
// _row_aggregates does, so no load waits on another (K1 only).
__device__ inline void row_aggregates(const Cfg& c, const int* board, const int* row_len, Rows& a) {
  for (int r = 0; r < c.R; ++r) {
    const int len = row_len[r];
    int pts = 0, csum = 0, last = 0;
    for (int t = 0; t < c.T; ++t) {
      const int cell = board[r * c.T + t];
      if (t < len) {
        pts += card_points(cell);
        csum += cell;
      }
      if (t == len - 1) last = cell;
    }
    a.len[r] = len;
    a.pts[r] = pts;
    a.csum[r] = csum;
    a.last[r] = last;
  }
}

// Aggregates of a fresh deal: each row holds only its seed card.
__device__ inline void seed_aggregates(const Cfg& c, const int* seeds, Rows& a) {
  for (int r = 0; r < c.R; ++r) {
    a.len[r] = 1;
    a.pts[r] = card_points(seeds[r]);
    a.last[r] = seeds[r];
    a.csum[r] = seeds[r];
  }
}

// Resolve one sub-play: the card joins the row with the highest last card
// below it; an undercut captures the cheapest row (first minimum); the
// threshold-th card captures.  Returns the penalty (points of the captured
// row, or 0).  board may be nullptr: every decision reads the aggregates.
__device__ inline int apply_subplay(const Cfg& c, int* board, Rows& a, int card) {
  int best_last = -1, target = 0;
  for (int r = 0; r < c.R; ++r) {
    if (a.last[r] < card && a.last[r] > best_last) {
      best_last = a.last[r];
      target = r;
    }
  }
  const bool undercut = best_last < 0;
  int cheapest = 0;
  for (int r = 1; r < c.R; ++r)
    if (a.pts[r] < a.pts[cheapest]) cheapest = r;
  const int row = undercut ? cheapest : target;
  const int old_len = a.len[row];
  const int old_pts = a.pts[row];
  const bool captures = undercut || (old_len + 1 >= c.T);
  const int cpts = card_points(card);
  if (captures) {
    if (board) {
      board[row * c.T] = card;
      for (int t = 1; t < c.T; ++t) board[row * c.T + t] = -1;
    }
    a.len[row] = 1;
    a.pts[row] = cpts;
    a.csum[row] = card;
  } else {
    if (board) board[row * c.T + old_len] = card;
    a.len[row] = old_len + 1;
    a.pts[row] += cpts;
    a.csum[row] += card;
  }
  a.last[row] = card;
  return captures ? old_pts : 0;
}

// Sort the P (card, player) pairs of a turn by card (insertion sort, P <= 16).
__device__ inline void sort_plays(int P, int* cards, int* players) {
  for (int i = 1; i < P; ++i) {
    const int cv = cards[i], pv = players[i];
    int k = i;
    while (k > 0 && cards[k - 1] > cv) {
      cards[k] = cards[k - 1];
      players[k] = players[k - 1];
      --k;
    }
    cards[k] = cv;
    players[k] = pv;
  }
}

// Resolve a whole turn: P sub-plays in ascending card order; rewards[p] gets
// minus the penalty seat p paid this turn.  cards and players are P ints of
// scratch each.
__device__ inline void resolve_plays(const Cfg& c, int* board, Rows& a, const int* actions, int* rewards,
                                     int* cards, int* players) {
  for (int p = 0; p < c.P; ++p) {
    cards[p] = actions[p];
    players[p] = p;
    rewards[p] = 0;
  }
  sort_plays(c.P, cards, players);
  for (int i = 0; i < c.P; ++i) rewards[players[i]] -= apply_subplay(c, board, a, cards[i]);
}

// Remove slot `slot` from a sorted, -1-padded hand of `count` live cards.
__device__ inline void remove_slot(int* hand, int count, int slot) {
  for (int i = slot; i + 1 < count; ++i) hand[i] = hand[i + 1];
  if (count > 0) hand[count - 1] = -1;
}

}  // namespace rl6
