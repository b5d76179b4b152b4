"""Whole search decisions on the device, game-batched (port of ``agents/device_search.py``).

A decision runs ``n_rounds = ceil(n_mc / K)`` playout rounds for a block of
G games at once.  Every round

1. picks the K forced first moves of each game (uniform / policy sample /
   PUCT over the accumulated outcome statistics, mcts.py:276-323),
2. re-deals the unseen cards to the opponents (uniform determinization by
   sorting uniforms over the availability mask, mcts.py:116-127),
3. plays the G x K determinized games in lockstep through the shared playout
   body (:func:`.search.make_single_playout`, K1 on every turn), and
4. folds the returns into per-action sums and counts and the return buffer
   that feeds PUCT's min/max/median normalization (mcts.py:304-315).

The choice is the host rule: the first maximum of the mean outcome, actions
never rolled out excluded (mcts.py:156-172).

The JAX package compiled this into one program: a ``fori_loop`` over rounds,
``vmap`` over games and playouts.  Here the rounds and turns are Python loops
over batched tensors -- ``n``, ``n_mc`` and K are the same for every game of
a call (``n_mc`` may differ per game in the kind-traced decision, whose
inactive slots are masked as in JAX) -- and the G x K playouts are one flat
batch, game-major.

Randomness is injected: a decision takes a ``torch.Generator``, from which it
draws each round's noise when the round starts, or a :class:`DecisionNoise`
that holds every round's noise.  Per round (:class:`RoundNoise`): the root
samples' Gumbel noise ``f32[G, K, H]`` (``jax.random.categorical`` is an
argmax over logits plus Gumbel noise), the determinizations' uniforms
``f32[G, K, C]``, and the playouts' Gumbel noise per turn (see
:mod:`.search`).  The kind-traced decision's random seats take one more
Gumbel block ``f32[G, H]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..engine.env import _hands_mask
from ..engine.state import EnvConfig, EnvState
from ..nets import MLPSpec
from ..utils.device import resolve_device
from .reinforce import action_in_input_logits
from .search import draw_gumbel, make_single_playout

KIND_RANDOM, KIND_UNIFORM, KIND_POLICY, KIND_PUCT = 0, 1, 2, 3
# Decoupled Alpha0.5 (net ROOT prior, uniform playouts -- agents.mcs
# .PUCTUniformAgent).  Ordered after the net-prior kinds so `kind >=
# KIND_POLICY` still means "root prior from the net".
KIND_PUCT_UNIFORM = 4
ROOTS = ("uniform", "policy", "puct")


def factorial_table(hand_size: int, device="cuda") -> torch.Tensor:
    """int32-saturated factorial table ``[0!, ..., hand_size!]`` (13! would overflow)."""
    cap = 2**31 - 1
    return torch.tensor([min(math.factorial(i), cap) for i in range(hand_size + 1)],
                        dtype=torch.int32, device=resolve_device(device))


def playout_budget(mc_max, mc_per, fact_n) -> torch.Tensor:
    """``min(mc_max, mc_per * n!)`` (mcts.py:105-106) in int32 without overflow.

    The product is used only when it provably fits: whenever ``fact_n >
    mc_max // mc_per`` the true product already exceeds ``mc_max``, so the
    clamp resolves without it.
    """
    fact_n = torch.as_tensor(fact_n, dtype=torch.int32)
    mc_max = torch.as_tensor(mc_max, dtype=torch.int32, device=fact_n.device)
    mc_per = torch.as_tensor(mc_per, dtype=torch.int32, device=fact_n.device)
    capped = (mc_per > 0) & (fact_n > torch.div(mc_max, torch.clamp(mc_per, min=1), rounding_mode="floor"))
    return torch.minimum(mc_max, torch.where(capped, mc_max, mc_per * fact_n))


def build_root_state(cfg: EnvConfig, board, row_len, my_hand, opp) -> EnvState:
    """Mid-game states for B determinizations (searcher = seat 0).

    ``board int[B, R, T]``, ``row_len int[B, R]``, ``my_hand int[B, H]`` and
    ``opp int[B, P-1, H]`` ascending with ``-1`` pads, which hold no card.
    """
    hands_sorted = torch.cat([my_hand[:, None], opp], dim=1).to(torch.int32)
    B, P = hands_sorted.shape[:2]
    dev = hands_sorted.device
    return EnvState(
        board=board.to(torch.int32),
        row_len=row_len.to(torch.int32),
        hands=_hands_mask(cfg, hands_sorted),
        hands_sorted=hands_sorted,
        scores=torch.zeros((B, P), dtype=torch.int32, device=dev),
        turn=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def _masked_median(rets_buf, count):
    """``np.median`` over ``rets_buf[..., :count]``, per leading index.

    Invalid slots sort to +inf; even counts average the two middle values
    (``np.median`` in the host path's ``_normalize_q``).
    """
    count = torch.as_tensor(count, device=rets_buf.device)
    valid = torch.arange(rets_buf.shape[-1], device=rets_buf.device) < count[..., None]
    ordered = torch.sort(torch.where(valid, rets_buf, torch.inf), dim=-1).values
    lo = torch.gather(ordered, -1, torch.clamp((count - 1) // 2, min=0)[..., None].expand(ordered.shape[:-1] + (1,)))
    hi = torch.gather(ordered, -1, torch.clamp(count // 2, min=0)[..., None].expand(ordered.shape[:-1] + (1,)))
    return (0.5 * (lo + hi))[..., 0]


def _normalized_q(act_sum, act_cnt, rets_buf, completed):
    """Min-max normalized per-action q from the ``completed`` outcomes.

    ``PUCTAgent._compute_pucts``/``_normalize_q`` (mcts.py:276-315), with the
    cold-start constants (0, -10, -5) below 10 outcomes and the all-equal
    fallback q = 0.5 (the JAX package's PARITY #9).  Batched over leading axes.
    """
    completed = torch.as_tensor(completed, device=rets_buf.device)
    valid = torch.arange(rets_buf.shape[-1], device=rets_buf.device) < completed[..., None]
    cold = completed < 10
    max_r = torch.where(cold, 0.0, torch.where(valid, rets_buf, -torch.inf).amax(dim=-1))
    min_r = torch.where(cold, -10.0, torch.where(valid, rets_buf, torch.inf).amin(dim=-1))
    mid_r = torch.where(cold, -5.0, _masked_median(rets_buf, completed))
    q = torch.where(act_cnt > 0, act_sum / torch.clamp(act_cnt, min=1.0), mid_r[..., None])
    flat = (max_r == min_r)[..., None]
    span = torch.where(flat, 1.0, (max_r - min_r)[..., None])
    return torch.where(flat, 0.5, torch.clamp((q - min_r[..., None]) / span, 0.0, 1.0))


def puct_select(q, probs, act_cnt, valid, active, c_puct):
    """K sequential PUCT picks with pending visit counts (one round), per game.

    ``PUCTAgent._choose_first_moves`` (mcts.py:276-302): ``q`` (``[..., H]``)
    is fixed for the round, the visit counts grow by one per pick.  ``valid``
    masks the -1 hand pads; ``active[..., i] = False`` slots still pick (their
    playouts are masked out later) but do not bump the counts.  ``c_puct`` is
    a float or one per game (``[...]``).  Returns the picks ``int64[..., K]``;
    ties go to the first maximum.
    """
    c = torch.as_tensor(c_puct, dtype=torch.float32, device=q.device)
    c = c[..., None] if c.dim() else c
    slots = torch.arange(q.shape[-1], device=q.device)
    counts, picks = act_cnt, []
    for i in range(active.shape[-1]):
        n_total = counts.sum(dim=-1, keepdim=True)
        puct = q + c * probs * torch.sqrt(n_total + 1e-9) / (1.0 + counts)
        pick = torch.argmax(torch.where(valid, puct, -torch.inf), dim=-1)
        counts = counts + ((slots == pick[..., None]) & active[..., i, None]).to(counts.dtype)
        picks.append(pick)
    return torch.stack(picks, dim=-1)


def deal_opponents(avail, u, num_opponents: int, n: int, slots: int):
    """Uniform determinizations: sorted opponent hands of ``n`` unseen cards.

    ``avail bool[..., C]`` is the card memory and ``u f32[..., C]`` one
    uniform per card.  The available cards in ascending order of their
    uniforms (a stable sort, as ``jnp.argsort``), the first
    ``num_opponents * n`` fill the opponents (mcts.py:116-127).  Hands come
    back ``int32[..., num_opponents, slots]`` ascending with ``-1`` pads past
    ``n`` (the engine's hands_sorted convention).
    """
    C = avail.shape[-1]
    dev = avail.device
    order = torch.argsort(torch.where(avail, u, torch.inf), dim=-1, stable=True)
    lin = torch.arange(num_opponents, device=dev)[:, None] * n + torch.arange(slots, device=dev)[None, :]
    picked = order[..., torch.clamp(lin, 0, C - 1)]
    valid = torch.arange(slots, device=dev) < n
    hands = torch.sort(torch.where(valid, picked, C + 1), dim=-1).values
    return torch.where(hands > C, -1, hands).to(torch.int32)


# ------------------------------------------------------------------ noise


@dataclass
class RoundNoise:
    """One round's noise for G games of K playouts each (lanes game-major).

    * ``first`` ``f32[G, K, H]``: Gumbel noise of the root samples (rounds
      where every game picks by PUCT need none);
    * ``deal`` ``f32[G, K, C]``: uniforms in [0, 1) of the determinizations;
    * ``uniform`` ``f32[n, G*K, P, C]`` / ``net`` ``f32[n, G*K, P, H]``: the
      playouts' Gumbel noise per turn for the uniform and the net move rule
      (a rule no lane plays needs none).
    """

    deal: torch.Tensor
    first: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    net: Optional[torch.Tensor] = None


@dataclass
class DecisionNoise:
    """Every round's :class:`RoundNoise` of one decision, and the random
    seats' Gumbel noise ``f32[G, H]`` (kind-traced decisions with random seats)."""

    rounds: List[RoundNoise]
    random: Optional[torch.Tensor] = None


class _Noise:
    """The decision's noise, drawn round by round from a generator or read from a :class:`DecisionNoise`."""

    def __init__(self, noise, device):
        if not isinstance(noise, (torch.Generator, DecisionNoise)):
            raise TypeError("noise must be a torch.Generator or a DecisionNoise")
        self.noise, self.device = noise, device

    def round(self, r: int, G, K, cfg: EnvConfig, n: int, first: bool, uniform: bool, net: bool) -> RoundNoise:
        if isinstance(self.noise, DecisionNoise):
            rn = self.noise.rounds[r]
            get = lambda x: None if x is None else x.to(self.device)
            return RoundNoise(get(rn.deal), get(rn.first), get(rn.uniform), get(rn.net))
        gen, dev = self.noise, self.device
        P, C, H = cfg.num_players, cfg.num_cards, cfg.hand_size
        return RoundNoise(
            deal=torch.rand((G, K, C), generator=gen, device=gen.device).to(dev),
            first=draw_gumbel(gen, (G, K, H), dev) if first else None,
            uniform=draw_gumbel(gen, (n, G * K, P, C), dev) if uniform else None,
            net=draw_gumbel(gen, (n, G * K, P, H), dev) if net else None,
        )

    def random(self, G, H) -> torch.Tensor:
        if isinstance(self.noise, DecisionNoise):
            return self.noise.random.to(self.device)
        return draw_gumbel(self.noise, (G, H), self.device)


def draw_decision_noise(generator: torch.Generator, cfg: EnvConfig, G: int, K: int, n: int, n_rounds: int,
                        first: bool = True, uniform: bool = True, net: bool = False) -> DecisionNoise:
    """A whole decision's noise at once, on the generator's device: the rounds
    a decision given ``generator`` would draw one by one.  For running one
    decision twice on the same noise (the card against the CPU); a decision
    is never given more than this."""
    src = _Noise(generator, generator.device)
    return DecisionNoise([src.round(r, G, K, cfg, n, first, uniform, net) for r in range(n_rounds)])


# --------------------------------------------------------------- decisions


@dataclass
class _Roots:
    """Per-game root behaviour (host bool arrays of length G)."""

    net_root: np.ndarray      # root log-probs (and PUCT's prior) from the net
    sample_net: np.ndarray    # root samples from the net's log-probs, else uniform
    puct: np.ndarray          # root picks by PUCT
    net_playout: np.ndarray   # playouts on the net move rule
    random: np.ndarray        # random seat: one uniform legal card, no search


def _make_search(cfg: EnvConfig, spec: Optional[MLPSpec], max_n_mc: int, batch: int, device):
    """The round loop shared by every decision.

    Returns ``search(params, roots, board, row_len, my_hand, n, n_mc, c_puct,
    avail, obs, noise) -> (act_sum f32[G, H], act_cnt f32[G, H], logp f32[G, H],
    logp_uni f32[G, H])`` where ``noise`` is a :class:`_Noise`.
    """
    P, C, H = cfg.num_players, cfg.num_cards, cfg.hand_size
    K = min(batch, max_n_mc)
    max_rounds = math.ceil(max_n_mc / K)
    single = make_single_playout(cfg, "mixed", spec)
    dev = device

    def search(params, roots: _Roots, board, row_len, my_hand, n: int, n_mc, c_puct, avail, obs, noise: _Noise):
        my_hand = torch.as_tensor(my_hand, device=dev).to(torch.int32)
        board = torch.as_tensor(board, device=dev).to(torch.int32)
        row_len = torch.as_tensor(row_len, device=dev).to(torch.int32)
        avail = torch.as_tensor(avail, device=dev)
        G = my_hand.shape[0]
        n_mc_host = torch.as_tensor(n_mc, dtype=torch.int64).cpu().expand(G)
        if int(n_mc_host.max()) > max_n_mc:
            raise ValueError(f"n_mc {int(n_mc_host.max())} exceeds the decision's mc_max {max_n_mc}")
        n_mc_dev = n_mc_host.to(dev)
        n_rounds = -(-int(n_mc_host.max()) // K)
        on = lambda flags: torch.as_tensor(flags, device=dev)

        valid = my_hand >= 0
        logp_uni = torch.where(valid, 0.0, -torch.inf)
        probs = torch.where(valid, torch.tensor(1.0, device=dev) / n, 0.0)
        logp = logp_uni
        if roots.net_root.any():
            logits = action_in_input_logits(spec, params, torch.as_tensor(obs, device=dev), my_hand)
            logp_net = torch.log_softmax(logits, dim=-1)
            net_root = on(roots.net_root)[:, None]
            logp = torch.where(net_root, logp_net, logp_uni)
            probs = torch.where(net_root, torch.exp(logp_net), probs)
        sample_logp = torch.where(on(roots.sample_net)[:, None], logp, logp_uni)
        use_puct = on(roots.puct)[:, None]
        use_net = on(roots.net_playout).repeat_interleave(K)

        rets_buf = torch.zeros((G, max_rounds * K), dtype=torch.float32, device=dev)
        act_sum = torch.zeros((G, H), dtype=torch.float32, device=dev)
        act_cnt = torch.zeros((G, H), dtype=torch.float32, device=dev)
        slots = torch.arange(H, device=dev)
        lanes = torch.arange(K, device=dev)
        for r in range(n_rounds):
            rn = noise.round(r, G, K, cfg, n, first=not roots.puct.all(),
                             uniform=not roots.net_playout.all(), net=roots.net_playout.any())
            active = (r * K + lanes)[None, :] < n_mc_dev[:, None]                          # [G, K]
            firsts = None
            if not roots.puct.all():
                firsts = torch.argmax(rn.first + sample_logp[:, None, :], dim=-1)        # [G, K]
            if roots.puct.any():
                completed = torch.clamp(n_mc_dev, max=r * K)
                q = _normalized_q(act_sum, act_cnt, rets_buf, completed)
                pucts = puct_select(q, probs, act_cnt, valid, active, c_puct)
                firsts = pucts if firsts is None else torch.where(use_puct, pucts, firsts)

            opp = deal_opponents(avail[:, None, :], rn.deal, P - 1, n, H)                 # [G, K, P-1, H]
            states0 = build_root_state(cfg, board.repeat_interleave(K, 0), row_len.repeat_interleave(K, 0),
                                       my_hand.repeat_interleave(K, 0), opp.reshape(G * K, P - 1, H))
            first_cards = torch.gather(my_hand, 1, firsts)
            rets = single(params, states0, first_cards.reshape(-1), n, gumbel_uniform=rn.uniform,
                          gumbel_net=rn.net, use_net=use_net).reshape(G, K)

            # Masked append: inactive slots keep their zeros.
            rets_buf[:, r * K:(r + 1) * K] = torch.where(active, rets, 0.0)
            hit = (firsts[:, :, None] == slots) & active[:, :, None]                        # [G, K, H]
            act_sum = act_sum + torch.where(hit, rets[:, :, None], 0.0).sum(dim=1)
            act_cnt = act_cnt + hit.sum(dim=1).to(torch.float32)
        return act_sum, act_cnt, logp, logp_uni

    return search


def _best(act_sum, act_cnt):
    """argmax mean outcome, never-rolled-out actions excluded (mcts.py:156-172);
    the first maximum on ties, like ``np.argmax``."""
    mean = torch.where(act_cnt > 0, act_sum / torch.clamp(act_cnt, min=1.0), -torch.inf)
    return torch.argmax(mean, dim=-1)


def _static_roots(root: str, playout_policy: str, G: int) -> _Roots:
    flag = lambda v: np.full(G, v, dtype=bool)
    return _Roots(net_root=flag(root != "uniform"), sample_net=flag(root == "policy"), puct=flag(root == "puct"),
                  net_playout=flag(playout_policy == "net"), random=flag(False))


def _check_static(root: str, playout_policy: str, spec) -> None:
    if root not in ROOTS:
        raise ValueError(f"unknown root {root!r}; choose from {ROOTS}")
    if playout_policy not in ("uniform", "net"):
        raise ValueError(f"unknown playout policy {playout_policy!r}; choose 'uniform' or 'net'")
    if spec is None and (root != "uniform" or playout_policy == "net"):
        raise ValueError(f"root {root!r} with {playout_policy!r} playouts needs the policy net's spec")


def make_device_decision_fn_many(
    cfg: EnvConfig,
    playout_policy: str,
    spec: Optional[MLPSpec],
    root: str,
    max_n_mc: int,
    batch: int,
    c_puct: float,
    device="cuda",
):
    """The kind-static decision for a block of G games: per-game arguments
    carry a leading games axis and ONE call decides the whole block (the JAX
    package's ``_make_decide``).

    Returns ``decide(params, board, row_len, my_hand, n, n_mc, avail, obs,
    noise) -> (action int32[G], log_prob f32[G])`` where

    * ``board int[G, R, T]`` / ``row_len int[G, R]`` -- each game's public board,
    * ``my_hand int[G, hand_size]`` -- the searcher's legal cards, ascending,
      ``-1``-padded past ``n``,
    * ``n`` / ``n_mc`` -- ints shared by the block: remaining-hand size and
      playout budget (``min(mc_max, mc_per_card * n!)``, at most ``max_n_mc``),
    * ``avail bool[G, C]`` -- the card memory (unseen cards, mcts.py:62-73),
    * ``obs f32[G, S]`` -- the searcher's current observation (root prior input),
    * ``noise`` -- a ``torch.Generator`` or a :class:`DecisionNoise`,
    * ``root`` in {"uniform", "policy", "puct"} -- MCS / PolicyMCS / Alpha0.5,
      and ``playout_policy`` in {"uniform", "net"}.

    ``max_n_mc`` (the mc_max ceiling) and ``batch`` size the outcome buffer
    and the per-round playouts K = min(batch, max_n_mc).
    """
    _check_static(root, playout_policy, spec)
    dev = resolve_device(device)
    search = _make_search(cfg, spec, max_n_mc, batch, dev)

    def decide(params, board, row_len, my_hand, n, n_mc, avail, obs, noise):
        my_hand = torch.as_tensor(my_hand, device=dev).to(torch.int32)
        roots = _static_roots(root, playout_policy, my_hand.shape[0])
        act_sum, act_cnt, logp, _ = search(params, roots, board, row_len, my_hand, n, n_mc, c_puct, avail, obs,
                                           _Noise(noise, dev))
        pick = _best(act_sum, act_cnt)[:, None]
        return torch.gather(my_hand, 1, pick)[:, 0], torch.gather(logp, 1, pick)[:, 0]

    return decide


def make_unified_decision_fn(
    cfg: EnvConfig,
    spec: MLPSpec,
    max_n_mc: int,
    batch: int,
    uniform_playouts: bool = False,
    device="cuda",
):
    """The kind-traced decision for a block of games: one program for every
    agent family, per game (the JAX package's ``_make_decide_unified``).

    Same decision semantics as :func:`make_device_decision_fn_many`, but each
    game's root kind (``KIND_RANDOM`` DrunkHamster / ``KIND_UNIFORM`` MCS /
    ``KIND_POLICY`` PolicyMCS / ``KIND_PUCT`` Alpha0.5 / ``KIND_PUCT_UNIFORM``
    decoupled Alpha0.5 with net root + uniform playouts) and ``c_puct`` are
    arguments.

    Returns ``decide(params, kind, board, row_len, my_hand, n, n_mc, c_puct,
    avail, obs, noise) -> (action, log_prob, pick)``: ``kind`` is an int or
    ``int[G]``, ``n_mc`` an int or ``int[G]`` (random seats pass 0: no round
    runs for them), ``c_puct`` a float or ``f32[G]``, ``pick`` the chosen
    index into the padded hand (the ``step_record`` chosen idx).  Given the
    same noise it equals the kind-static decision of the same root and
    playout rule, as in JAX, where every root draws from the same subkeys.
    Random seats take a uniform legal card with the Gumbel noise
    ``DecisionNoise.random``.

    A block without PUCT seats skips the PUCT bookkeeping by itself, so JAX's
    ``puct_free`` variant needs no option here.  ``uniform_playouts=True``
    plays every playout on the uniform move rule (lineups without
    net-playout seats); net ROOT priors still work.
    """
    dev = resolve_device(device)
    search = _make_search(cfg, spec, max_n_mc, batch, dev)
    H = cfg.hand_size

    def decide(params, kind, board, row_len, my_hand, n, n_mc, c_puct, avail, obs, noise):
        my_hand = torch.as_tensor(my_hand, device=dev).to(torch.int32)
        G = my_hand.shape[0]
        kinds = np.broadcast_to(np.asarray(torch.as_tensor(kind).cpu(), dtype=np.int64), (G,))
        if ((kinds < KIND_RANDOM) | (kinds > KIND_PUCT_UNIFORM)).any():
            raise ValueError(f"unknown kinds {sorted(set(kinds.tolist()))}")
        puct = (kinds == KIND_PUCT) | (kinds == KIND_PUCT_UNIFORM)
        roots = _Roots(net_root=kinds >= KIND_POLICY, sample_net=kinds == KIND_POLICY, puct=puct,
                       net_playout=((kinds == KIND_POLICY) | (kinds == KIND_PUCT)) & (not uniform_playouts),
                       random=kinds == KIND_RANDOM)
        src = _Noise(noise, dev)
        act_sum, act_cnt, logp, logp_uni = search(params, roots, board, row_len, my_hand, n, n_mc, c_puct, avail,
                                                  obs, src)
        pick = _best(act_sum, act_cnt)
        if roots.random.any():
            # Random seats: a uniform legal card from noise drawn after the rounds.
            pick_random = torch.argmax(src.random(G, H) + logp_uni, dim=-1)
            pick = torch.where(torch.as_tensor(roots.random, device=dev), pick_random, pick)
        pick = pick[:, None]
        return torch.gather(my_hand, 1, pick)[:, 0], torch.gather(logp, 1, pick)[:, 0], pick[:, 0].to(torch.int32)

    return decide


def make_device_decision_fn(cfg: EnvConfig, playout_policy: str, spec: Optional[MLPSpec], root: str,
                            max_n_mc: int, batch: int, c_puct: float, device="cuda"):
    """The single-game decision: :func:`make_device_decision_fn_many`'s
    arguments without the games axis (``board int[R, T]``, ``my_hand
    int[H]``, ...); returns ``(action, log_prob)`` as 0-dim tensors."""
    many = make_device_decision_fn_many(cfg, playout_policy, spec, root, max_n_mc, batch, c_puct, device)

    def decide(params, board, row_len, my_hand, n, n_mc, avail, obs, noise):
        one = lambda x: torch.as_tensor(x)[None]
        action, logp = many(params, one(board), one(row_len), one(my_hand), n, n_mc, one(avail),
                            None if obs is None else one(obs), noise)
        return action[0], logp[0]

    return decide

