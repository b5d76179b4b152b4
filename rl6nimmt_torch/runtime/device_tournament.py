"""Device-block tournament driver: heterogeneous lineups as whole games on the card
(port of ``runtime/device_tournament.py``).

A block plays G games of one player count to their end on the device: one K2
deal (``engine.deal``), then every turn each seat's decision and one K1
resolution (``engine.step``), recording the full trajectory -- per turn and
seat the observation, the padded legal hand, the chosen index, its log-prob,
ACER's behaviour log-prob vector and the reward -- from which every learner's
``learn`` stream replays in the exact GameSession argument order: host-side, or
with ``device_learning`` the DQN, ACER and REINFORCE streams through the
planners of :mod:`.device_learn`, whose updates run on the device.

Seat kinds (an int per seat, as in JAX):

* the search families 0-4 (``device_search.KIND_*``: random, MCS, PolicyMCS,
  PUCT, decoupled PUCT) make the kind-traced decision of
  :func:`..agents.device_search.make_unified_decision_fn`, whose playout turns
  are K1 launches;
* learner seats are ``KIND_LEARNER_BASE + s`` for the static
  :class:`LearnerSlot` ``s`` of the block: one net forward a decision -- the DQN
  lattice (masked argmax, epsilon-greedy, noisy argmax), ACER (categorical over
  the legal [action|state] rows with the log-epsilon clamp), both REINFORCE
  variants and PUCTCustomed's value argmax.

JAX evaluated every slot on every seat and selected by kind, one vmapped
program.  Here each turn calls one search decision for every group of search
seats that share a net (the seats without one -- random and MCS -- form one
group; each PolicyMCS/PUCT agent its own) and one forward for every learner
agent on the seats it holds: the same picks, log-probs and ACER vectors.

Randomness comes from a ``torch.Generator`` or from an injected
:class:`BlockNoise`: the deal's Philox seed, then per turn the search seats'
:class:`~..agents.device_search.DecisionNoise` over all G x P seats and the
learner seats' draws (:class:`LearnerNoise`) -- the Gumbel noise of the
categorical samples, the epsilon-greedy uniform and pick, and the noisy nets'
factorized noise.  JAX derived these from ``fold_in(seat key, 1..3)``; given
them, the port plays JAX's block (``tests/test_torch_device_block.py``).

Protocol notes (the block deviations of PARITY.md #10-#12):

* acting uses parameters frozen for the whole block; for epsilon-greedy DQNs
  the frozen quantity includes ``self.eps``;
* ``learn`` receives the identical GameSession argument stream, replayed per
  game in block order after the block (or its planner does);
* NumPy's global generator is consumed in JAX's order: one ``randint`` a
  :meth:`DeviceBlockSession.dispatch`, which here seeds the block's generator;
* only Human seats, PUCT with temperature sampling and PUCT whose
  ``batch_playouts`` is not the session's K have no device decision.

``PARITY_TORCH.md`` §14 records the decisions this port makes: the session's
K (default 8, PUCT eligibility gated on it), the cap of the PUCT-free single
round (default 256 lanes a seat), and the unpadded game axis.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..agents.acer import BatchedACERAgent, actor_critic_heads
from ..agents.device_search import (
    KIND_POLICY,
    KIND_PUCT,
    KIND_PUCT_UNIFORM,
    KIND_RANDOM,
    KIND_UNIFORM,
    DecisionNoise,
    RoundNoise,
    draw_decision_noise,
    factorial_table,
    make_unified_decision_fn,
    playout_budget,
)
from ..agents.dqn import DQNAgent, tree_map
from ..agents.mcs import MCSAgent, PolicyMCSAgent, PUCTAgent, PUCTCustomedAgent, PUCTUniformAgent, _policy_value
from ..agents.random_agent import DrunkHamster
from ..agents.reinforce import (
    BatchedReinforceAgent,
    MaskedReinforceAgent,
    action_in_input_logits,
    masked_policy_logits,
)
from ..agents.search import draw_gumbel, state_to
from ..engine import EnvConfig, EnvState, deal, observe, step
from ..nets import MLPSpec, draw_mlp_noise, dueling_apply, mlp_apply, noisy_effective_params
from ..nets.mlp import _activation
from ..utils.device import resolve_device
from .device_learn import make_planner
from .device_match import board_seen

# Seat kinds 0-4 are the search families (device_search.KIND_*); learner
# seats get 8 + (index into the block's static LearnerSlot tuple).
KIND_LEARNER_BASE = 8
# The session's PUCT round width K: the search agents' own batch_playouts
# default, so a default PUCT seat plays its host cadence on the device.
DEFAULT_BATCH = 8
# Playout lanes a seat of a PUCT-free block runs in one round (ADVICE r5):
# the published budget (mc_max 200, pow2 ceiling 256) stays one round, a
# larger one runs several rounds of this width.
SINGLE_ROUND_CAP = 256
NET_KINDS = (KIND_POLICY, KIND_PUCT, KIND_PUCT_UNIFORM)


@dataclass(frozen=True)
class LearnerSlot:
    """One static (family, architecture) acting rule of a block.

    ``family``: ``"dqn"`` (masked argmax / epsilon-greedy / noisy argmax over
    Q, dqn.py:196-261; dueling and noisy structure are in ``spec``),
    ``"acer"`` (categorical over the legal [action|state] policy logits with
    the log-epsilon clamp, actor_critic.py:85-106), ``"rai"`` (action-in-input
    REINFORCE sampling, policy.py:137-172), ``"rmask"`` (masked 104-logit
    REINFORCE sampling, policy.py:40-77), ``"pv"`` (PUCTCustomed's value
    argmax over its (pi, V) head, mcts.py:376-392).
    """

    family: str
    spec: MLPSpec

    def sort_key(self):
        return (self.family, repr(self.spec))


# ------------------------------------------------------------------- noise


@dataclass
class LearnerNoise:
    """One turn's learner draws for every seat of a block, leading ``[G, P]``.

    ``sample_hand`` ``f32[G, P, H]`` / ``sample_card`` ``f32[G, P, C]``: the
    Gumbel noise of ACER's and action-in-input REINFORCE's categorical over
    the hand slots and of masked REINFORCE's over the cards (JAX:
    ``fold_in(key, 1)``); ``explore`` ``f32[G, P]`` and ``explore_pick``
    ``f32[G, P, H]``: epsilon-greedy's uniform and its uniform legal pick's
    Gumbel noise (``fold_in(key, 3)`` and ``fold_in(fold_in(key, 3), 1)``);
    ``q``: per noisy DQN slot, its per-layer factorized noise with leading
    ``[G, P]`` (``fold_in(key, 2)``).
    """

    sample_hand: torch.Tensor
    sample_card: torch.Tensor
    explore: torch.Tensor
    explore_pick: torch.Tensor
    q: dict = field(default_factory=dict)


@dataclass
class TurnNoise:
    """One turn: the search seats' decision noise over all ``G * P`` seats
    (seat ``g * P + p``) and the learner seats' draws."""

    search: DecisionNoise
    learner: LearnerNoise


@dataclass
class BlockNoise:
    """A whole block's randomness: the deal's Philox seed and every turn's noise."""

    deal_seed: int
    turns: List[TurnNoise]


def _learner_needs(slot: LearnerSlot) -> Tuple[str, ...]:
    return {"dqn": ("explore", "explore_pick") + (("q",) if slot.spec.noisy else ()),
            "acer": ("sample_hand",), "rai": ("sample_hand",), "rmask": ("sample_card",), "pv": ()}[slot.family]


def draw_block_noise(generator: torch.Generator, cfg: EnvConfig, num_games: int, K: int, rounds: Sequence[int],
                     slots: Sequence[LearnerSlot] = (), net: bool = False) -> BlockNoise:
    """A whole block's noise at once, on the generator's device: ``rounds[t]``
    search rounds at turn ``t`` (:func:`turn_rounds`), net playout noise when
    ``net``.  For playing one block twice on the same noise (the card against
    the CPU); a block given a generator draws only what it uses."""
    P, C, H = cfg.num_players, cfg.num_cards, cfg.hand_size
    G, gdev = num_games, generator.device
    turns = []
    for t, n_rounds in enumerate(rounds):
        n = H - t
        search = draw_decision_noise(generator, cfg, G * P, K, n, n_rounds, net=net)
        search.random = draw_gumbel(generator, (G * P, H), gdev)
        learner = LearnerNoise(
            sample_hand=draw_gumbel(generator, (G, P, H), gdev),
            sample_card=draw_gumbel(generator, (G, P, C), gdev),
            explore=torch.rand((G, P), generator=generator, device=gdev),
            explore_pick=draw_gumbel(generator, (G, P, H), gdev),
            q={slot: draw_mlp_noise(slot.spec, generator, batch=(G, P)) for slot in slots
               if slot.family == "dqn" and slot.spec.noisy})
        turns.append(TurnNoise(search, learner))
    return BlockNoise(int(torch.randint(0, 2**62, (1,), generator=generator, device=gdev)), turns)


def shard_block_noise(noise: BlockNoise, lo: int, hi: int, P: int, K: int) -> BlockNoise:
    """The noise of games ``lo:hi`` of a block's :class:`BlockNoise`: the search
    seats ``lo*P:hi*P`` (playout lanes ``lo*P*K:hi*P*K``) and the learner draws
    of those games, with the block's deal seed."""
    seats, lanes = slice(lo * P, hi * P), slice(lo * P * K, hi * P * K)
    cut = lambda x, s, dim=0: None if x is None else x[(slice(None),) * dim + (s,)]
    turns = []
    for tn in noise.turns:
        rounds = [RoundNoise(deal=cut(r.deal, seats), first=cut(r.first, seats), uniform=cut(r.uniform, lanes, 1),
                             net=cut(r.net, lanes, 1)) for r in tn.search.rounds]
        ln = tn.learner
        learner = LearnerNoise(
            sample_hand=ln.sample_hand[lo:hi], sample_card=ln.sample_card[lo:hi], explore=ln.explore[lo:hi],
            explore_pick=ln.explore_pick[lo:hi],
            q={slot: [{k: v[lo:hi] for k, v in layer.items()} for layer in layers] for slot, layers in ln.q.items()})
        turns.append(TurnNoise(DecisionNoise(rounds, cut(tn.search.random, seats)), learner))
    return BlockNoise(noise.deal_seed, turns)


class _BlockSource:
    """A block's randomness, drawn from a generator as it is needed or read from a :class:`BlockNoise`."""

    def __init__(self, noise, device, P: int):
        if not isinstance(noise, (torch.Generator, BlockNoise)):
            raise TypeError("noise must be a torch.Generator or a BlockNoise")
        self.noise, self.device, self.P = noise, device, P

    def deal_seed(self) -> int:
        if isinstance(self.noise, BlockNoise):
            return self.noise.deal_seed
        gen = self.noise
        return int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))

    def search(self, t: int, seats: np.ndarray, K: int):
        """The decision noise of the seats ``seats`` (flat indices) at turn ``t``."""
        if isinstance(self.noise, torch.Generator):
            return self.noise
        full = self.noise.turns[t].search
        idx = torch.as_tensor(seats, dtype=torch.long)
        lanes = (idx[:, None] * K + torch.arange(K)).reshape(-1)
        pick = lambda x, i: None if x is None else x.index_select(0, i.to(x.device))
        pick_lanes = lambda x: None if x is None else x.index_select(1, lanes.to(x.device))
        rounds = [RoundNoise(deal=pick(r.deal, idx), first=pick(r.first, idx), uniform=pick_lanes(r.uniform),
                             net=pick_lanes(r.net)) for r in full.rounds]
        return DecisionNoise(rounds, pick(full.random, idx))

    def learner(self, t: int, seats: np.ndarray, slot: LearnerSlot, cfg: EnvConfig) -> SimpleNamespace:
        """The draws of one learner group's seats, ``[N, ...]`` on the block's device."""
        needs, dev, N = _learner_needs(slot), self.device, len(seats)
        if isinstance(self.noise, torch.Generator):
            gen = self.noise
            make = {
                "sample_hand": lambda: draw_gumbel(gen, (N, cfg.hand_size), dev),
                "sample_card": lambda: draw_gumbel(gen, (N, cfg.num_cards), dev),
                "explore": lambda: torch.rand((N,), generator=gen, device=gen.device).to(dev),
                "explore_pick": lambda: draw_gumbel(gen, (N, cfg.hand_size), dev),
                "q": lambda: [{k: v.to(dev) for k, v in layer.items()}
                              for layer in draw_mlp_noise(slot.spec, gen, batch=(N,))],
            }
            return SimpleNamespace(**{k: make[k]() for k in needs})
        ln = self.noise.turns[t].learner
        g = torch.as_tensor(seats // self.P, dtype=torch.long)
        p = torch.as_tensor(seats % self.P, dtype=torch.long)
        at = lambda x: x[g.to(x.device), p.to(x.device)].to(dev)
        fields = {k: at(getattr(ln, k)) for k in needs if k != "q"}
        if "q" in needs:
            fields["q"] = [{k: at(v) for k, v in layer.items()} for layer in ln.q[slot]]
        return SimpleNamespace(**fields)


# --------------------------------------------------------------- decisions


def _q_per_seat(spec: MLPSpec, params, obs, noise):
    """Q over every card for N seats of one DQN: ``obs f32[N, S]``; a noisy
    net's per-seat noise (layers with leading ``[N]``) gives each seat its
    own effective weights, as JAX's per-seat forward did."""
    dueling = len(spec.head_sizes) == 2
    if noise is None:
        return dueling_apply(spec, params, obs) if dueling else mlp_apply(spec, params, obs)[0]
    eff = noisy_effective_params(spec, params, noise)
    act = _activation(spec.activation)
    lin = lambda layer, h: torch.bmm(h[:, None, :], layer["w"])[:, 0] + layer["b"]
    h = obs
    for layer in eff["trunk"]:
        h = act(lin(layer, h))
    heads = [lin(layer, h) for layer in eff["heads"]]
    if dueling:
        v, a = heads
        return v + (a - a.mean(dim=-1, keepdim=True))
    return heads[0]


def learner_decide(cfg: EnvConfig, slot: LearnerSlot, params, hand, obs, eps, draws):
    """One learner agent's decisions on N seats (JAX's ``_make_learner_decide``
    for one slot): ``hand int32[N, H]`` (-1 padded), ``obs f32[N, S]``, ``eps
    f32[N]`` (epsilon-greedy DQNs), ``draws`` the seats' noise.  Returns
    ``(pick int64[N], log_prob f32[N], log_probs_vec f32[N, H])``; the vector
    is ACER's behaviour policy over the padded hand (zeros for the others)."""
    C = cfg.num_cards
    valid = hand >= 0
    logp_uni = torch.where(valid, 0.0, -torch.inf)
    vec = torch.zeros(hand.shape, dtype=torch.float32, device=hand.device)
    logp = vec[:, 0]
    take = lambda x, i: torch.gather(x, 1, i[:, None])[:, 0]
    family, spec = slot.family, slot.spec
    if family == "dqn":
        q = _q_per_seat(spec, params, obs, draws.q if spec.noisy else None)
        # argmax over the legal subset == the host's -1e8 masking (first max).
        q_hand = torch.where(valid, torch.gather(q, 1, hand.clamp(0, C - 1).long()), -torch.inf)
        greedy = torch.argmax(q_hand, dim=1)
        pick = torch.where(draws.explore <= eps, torch.argmax(draws.explore_pick + logp_uni, dim=1), greedy)
    elif family == "acer":
        lp, _ = actor_critic_heads(spec, params, obs, hand)
        pick = torch.argmax(draws.sample_hand + torch.where(valid, lp, -torch.inf), dim=1)
        logp, vec = take(lp, pick), lp
    elif family == "rai":
        logits = action_in_input_logits(spec, params, obs, hand)
        pick = torch.argmax(logits + draws.sample_hand, dim=1)
        logp = take(torch.log_softmax(logits, dim=-1), pick)
    elif family == "rmask":
        mask = torch.zeros((hand.shape[0], C + 1), dtype=torch.bool, device=hand.device)
        mask.scatter_(1, torch.where(valid, hand, C).long(), True)
        logits = masked_policy_logits(spec, params, obs, mask[:, :C])
        card = torch.argmax(logits + draws.sample_card, dim=1)
        pick = torch.argmax((hand == card[:, None]).to(torch.int8), dim=1)
        logp = take(torch.log_softmax(logits, dim=-1), card)
    elif family == "pv":
        lp, values = _policy_value(spec, params, obs, hand)
        pick = torch.argmax(values, dim=1)
        logp = take(lp, pick)
    else:
        raise ValueError(f"unknown learner family {family!r}")
    return pick, logp.to(torch.float32), vec


# --------------------------------------------------------------- the block


def turn_rounds(cfg: EnvConfig, kinds, mc_maxes, mc_pers, K: int) -> List[int]:
    """Search rounds of each turn, the most any search seat runs:
    ``ceil(n_mc / K)``, ``n_mc = min(mc_max, mc_per * n!)`` (mcts.py:105-106)."""
    kinds = np.asarray(kinds)
    searching = (kinds > KIND_RANDOM) & (kinds < KIND_LEARNER_BASE)
    fact = factorial_table(cfg.hand_size, device="cpu")
    out = []
    for t in range(cfg.hand_size):
        n_mc = playout_budget(np.asarray(mc_maxes, np.int32), np.asarray(mc_pers, np.int32),
                              fact[cfg.hand_size - t]).numpy()
        out.append(int(-(-np.where(searching, n_mc, 0).max(initial=0) // K)))
    return out


def make_device_block_fn(
    cfg: EnvConfig,
    spec: MLPSpec,
    num_games: int,
    mc_max: int,
    batch: int = DEFAULT_BATCH,
    slots: Tuple[LearnerSlot, ...] = (),
    device="cuda",
):
    """G heterogeneous games with trajectory capture (JAX's ``make_device_block_fn``).

    ``block(params, lparams, kinds, mc_maxes, mc_pers, c_pucts, epses, noise,
    state=None) -> (scores f32[G, P], traj, final_obs f32[G, P, S])`` where

    * ``params[g][p]`` -- the search seat's net params (None for seats
      without one), ``lparams[g][p]`` -- the learner seat's params (None for
      the others); seats holding the same tree share one call a turn;
    * ``kinds int[G, P]`` -- KIND_* per seat (learner seats:
      ``KIND_LEARNER_BASE + slot index``);
    * ``mc_maxes / mc_pers int[G, P]`` -- per-seat budgets (``n_mc =
      min(mc_max, mc_per * n!)``), ``c_pucts f32[G, P]``, ``epses f32[G, P]``
      (epsilon-greedy DQN seats);
    * ``noise`` -- a ``torch.Generator`` or a :class:`BlockNoise`; ``state``
      replaces the K2 deal (for JAX's decks);
    * ``traj`` -- per-turn stacks on the device: ``obs f32[T, G, P, S]``,
      ``hands int32[T, G, P, H]`` (the padded legal hands before the turn),
      ``picks int32[T, G, P]`` (chosen index into the padded hand), ``logps
      f32[T, G, P]``, ``logp_vecs f32[T, G, P, H]``, ``rewards int32[T, G, P]``.

    ``mc_max`` is the budget ceiling that sizes the outcome buffers, ``batch``
    the playouts a round (K = min(batch, mc_max)).  JAX compiled a block
    without PUCT seats (``puct_free``) or net-playout seats
    (``uniform_playouts``) as static variants; here each search call skips
    that work by itself, from its seats' kinds.  Random and learner seats run
    no rounds.
    """
    dev = resolve_device(device)
    P, C, H, G = cfg.num_players, cfg.num_cards, cfg.hand_size, num_games
    fact = factorial_table(H, device="cpu")
    decide = make_unified_decision_fn(cfg, spec, mc_max, batch, device=dev)
    K = min(batch, mc_max)

    def block(params, lparams, kinds, mc_maxes, mc_pers, c_pucts, epses, noise, state: Optional[EnvState] = None):
        kinds = np.asarray(kinds, np.int64)
        if kinds.shape != (G, P):
            raise ValueError(f"kinds of shape {kinds.shape}, expected {(G, P)}")
        if (kinds >= KIND_LEARNER_BASE + len(slots)).any():
            raise ValueError(f"learner kinds past the block's {len(slots)} slots")
        src = _BlockSource(noise, dev, P)
        state = deal(cfg, src.deal_seed(), G, device=dev) if state is None else state_to(state, dev)
        flat = kinds.reshape(-1)
        search_groups, learner_groups = {}, {}
        for s, kind in enumerate(flat):
            g, p = divmod(s, P)
            if kind >= KIND_LEARNER_BASE:
                tree = lparams[g][p]
                learner_groups.setdefault((kind, id(tree)), (slots[kind - KIND_LEARNER_BASE], tree, []))[2].append(s)
            else:
                tree = params[g][p] if kind in NET_KINDS else None
                search_groups.setdefault(id(tree) if tree is not None else None, (tree, []))[1].append(s)
        search_groups = [(tree, np.asarray(seats)) for tree, seats in search_groups.values()]
        learner_groups = [(slot, tree, np.asarray(seats)) for slot, tree, seats in learner_groups.values()]
        playout_free = (kinds == KIND_RANDOM) | (kinds >= KIND_LEARNER_BASE)
        c_all = torch.as_tensor(np.asarray(c_pucts, np.float32).reshape(-1), device=dev)
        eps_all = torch.as_tensor(np.asarray(epses, np.float32).reshape(-1), device=dev)
        kinds_t = torch.as_tensor(flat)
        mc_maxes, mc_pers = np.asarray(mc_maxes, np.int32), np.asarray(mc_pers, np.int32)

        seen = board_seen(cfg, state)
        traj = {k: [] for k in ("obs", "hands", "picks", "logps", "logp_vecs", "rewards")}
        for t in range(H):
            n = H - t
            seen = seen | board_seen(cfg, state)
            obs, _ = observe(cfg, state)
            n_mc = torch.as_tensor(np.where(playout_free, 0, playout_budget(mc_maxes, mc_pers, fact[n]).numpy()))
            n_mc = n_mc.reshape(-1)
            hands = state.hands_sorted.reshape(G * P, H)
            obs_f = obs.reshape(G * P, -1)
            # Card memory: unseen cards, own hand excluded (mcts.py:62-73).
            avail = (~(seen[:, None, :] | state.hands)).reshape(G * P, C)
            picks = torch.zeros(G * P, dtype=torch.long, device=dev)
            logps = torch.zeros(G * P, dtype=torch.float32, device=dev)
            vecs = torch.zeros((G * P, H), dtype=torch.float32, device=dev)
            for tree, seats in search_groups:
                idx = torch.as_tensor(seats, device=dev)
                gi = torch.div(idx, P, rounding_mode="floor")
                _, logp, pick = decide(tree, kinds_t[seats], state.board[gi], state.row_len[gi], hands[idx], n,
                                       n_mc[seats], c_all[idx], avail[idx], obs_f[idx], src.search(t, seats, K))
                picks[idx], logps[idx] = pick.long(), logp
            for slot, tree, seats in learner_groups:
                idx = torch.as_tensor(seats, device=dev)
                pick, logp, vec = learner_decide(cfg, slot, tree, hands[idx], obs_f[idx], eps_all[idx],
                                                 src.learner(t, seats, slot, cfg))
                picks[idx], logps[idx], vecs[idx] = pick, logp, vec
            picks = picks.reshape(G, P)
            actions = torch.gather(state.hands_sorted, 2, picks[..., None])[..., 0]
            traj["obs"].append(obs)
            traj["hands"].append(state.hands_sorted)
            traj["picks"].append(picks.to(torch.int32))
            traj["logps"].append(logps.reshape(G, P))
            traj["logp_vecs"].append(vecs.reshape(G, P, H))
            state, rewards = step(cfg, state, actions)
            traj["rewards"].append(rewards)
        final_obs, _ = observe(cfg, state)
        return -state.scores.to(torch.float32), {k: torch.stack(v) for k, v in traj.items()}, final_obs

    return block


# -------------------------------------------------------------- eligibility


def seat_kind(agent, batch: int = DEFAULT_BATCH) -> Optional[int]:
    """KIND_* for agents with a device *search* decision, None otherwise.

    PUCT seats are eligible only when their ``batch_playouts`` (default 8) is
    the session's K, ``batch``: a PUCT root reads the outcome statistics
    between rounds, so its round width is part of its semantics (JAX gated on
    8 while its session ran K=32; ``PARITY_TORCH.md`` §14).
    """
    if isinstance(agent, DrunkHamster):
        return KIND_RANDOM
    if isinstance(agent, PUCTCustomedAgent):
        return None  # playout-free (pi, V) decisions: a "pv" learner slot
    if isinstance(agent, PUCTAgent):
        if agent.temperature is not None and agent.temperature > 1e-12:
            return None  # NotImplementedError parity (mcts.py:318-323)
        if (agent.batch_playouts or 8) != batch:
            return None
        return KIND_PUCT_UNIFORM if isinstance(agent, PUCTUniformAgent) else KIND_PUCT
    if isinstance(agent, PolicyMCSAgent):
        return KIND_POLICY
    if isinstance(agent, MCSAgent):
        return KIND_UNIFORM
    return None


def seat_slot(agent, batch: int = DEFAULT_BATCH):
    """``("search", KIND_*)`` for the search families, ``("learner",
    LearnerSlot)`` for the single-forward families (DQN lattice, ACER,
    REINFORCE variants, PUCTCustomed), or None when the seat has no device
    decision (Human stdin seats, PUCT with temperature sampling or another
    K, non-ACER actor-critic bases whose ``learn`` raises)."""
    if isinstance(agent, PUCTCustomedAgent):
        return "learner", LearnerSlot("pv", agent.spec)
    kind = seat_kind(agent, batch)
    if kind is not None:
        return "search", kind
    if isinstance(agent, DQNAgent):
        return "learner", LearnerSlot("dqn", agent.spec)
    if isinstance(agent, BatchedACERAgent):
        if agent.max_num_actions != agent.env_config.hand_size:
            return None  # padded log_probs would not line up with the hand
        return "learner", LearnerSlot("acer", agent.spec)
    if isinstance(agent, MaskedReinforceAgent):
        return "learner", LearnerSlot("rmask", agent.spec)
    if isinstance(agent, BatchedReinforceAgent):
        return "learner", LearnerSlot("rai", agent.spec)
    return None


def _seat_dims(agent, role) -> tuple:
    """Env dimensions a seat assumes (for mixed-lineup consistency checks)."""
    if role == "search" and not isinstance(agent, DrunkHamster):
        return (agent.num_rows, agent.num_cards, agent.threshold, agent.include_summaries, agent.handsize)
    ec = agent.env_config
    return (ec.num_rows, ec.num_cards, ec.threshold, ec.include_summaries, ec.hand_size)


def lineup_signature(agents, batch: int = DEFAULT_BATCH) -> Optional[tuple]:
    """(EnvConfig, MLPSpec | None, frozenset[LearnerSlot]) if the lineup can
    run on the device, else None."""
    roles = [seat_slot(a, batch) for a in agents]
    if any(r is None for r in roles):
        return None
    dims, specs, slots = set(), set(), set()
    for agent, (role, what) in zip(agents, roles):
        if role == "search":
            if what != KIND_RANDOM:
                dims.add(_seat_dims(agent, role))
            if what in NET_KINDS:
                specs.add(agent.spec)
        else:
            dims.add(_seat_dims(agent, role))
            slots.add(what)
    if len(dims) > 1 or len(specs) > 1:
        return None
    num_rows, num_cards, threshold, summaries, handsize = dims.pop() if dims else (4, 104, 6, True, 10)
    cfg = EnvConfig(num_players=len(agents), num_rows=num_rows, num_cards=num_cards, threshold=threshold,
                    include_summaries=summaries, hand_size=handsize)
    return cfg, (specs.pop() if specs else None), frozenset(slots)


def device_lineup_eligible(agents, batch: int = DEFAULT_BATCH) -> bool:
    return lineup_signature(agents, batch) is not None


def lineup_fastclass(agents, batch: int = DEFAULT_BATCH) -> tuple:
    """(has_puct, has_net_playout): the fast-path class of a lineup.  PUCT-free
    lineups run one round of up to ``single_round_cap`` playouts a decision
    and net-playout-free ones play uniform playouts only; the tournament
    groups games by this class so one PUCT game does not drag a group of
    MCS-only games through the multi-round schedule."""
    has_puct = has_net = False
    for a in agents:
        k = seat_kind(a, batch)
        if k in (KIND_PUCT, KIND_PUCT_UNIFORM):
            has_puct = True
        if k in (KIND_POLICY, KIND_PUCT):
            has_net = True
    return has_puct, has_net


# ------------------------------------------------------------------ session


@dataclass
class BlockInputs:
    """A session's block, assembled: the fn's configuration and arguments,
    and each seat's family for the learn replay."""

    mc_ceiling: int
    K: int
    puct_free: bool
    params: list
    lparams: list
    kinds: np.ndarray
    mc_maxes: np.ndarray
    mc_pers: np.ndarray
    c_pucts: np.ndarray
    epses: np.ndarray
    families: list


class DeviceBlockSession:
    """Play G same-player-count games as one device block, then replay learning
    on the host or the device (the device twin of
    :class:`..runtime.block.BlockSession` for eligible lineups).

    ``batch`` is the PUCT round width K (default 8, the search agents' own
    default; JAX's session ran 32) and gates PUCT eligibility
    (:func:`seat_kind`).  A block without PUCT seats runs each decision's
    playouts in as few rounds as ``single_round_cap`` lanes a seat allow (JAX:
    one round of the budget's pow2 ceiling, uncapped).  ``bucket`` only
    checks that it covers the games (JAX padded to it).  ``device_learning=True``
    routes the learner streams (DQN, ACER, both REINFORCE variants) to the
    device planners of :mod:`.device_learn` instead of the host ``learn``
    replay.

    ``mesh`` (a :class:`~..parallel.mesh.Mesh`, every rank of it holding the
    same session and ``np.random`` state) shards the block's games over the
    mesh's ranks: the games are rounded up to a multiple of the mesh's size
    with random seats (as JAX rounded its bucket), the block's noise is drawn
    whole on every rank (:func:`draw_block_noise`) and each rank plays its
    contiguous slice of the games on ``mesh.device``; ``all_gather`` brings
    back the scores, trajectories and final observations, and every rank runs
    the same learn replay.  A mesh block draws its noise whole, a mesh-free
    block as it needs it, so the two differ in their draws; mesh blocks of
    every size play the same games (``PARITY_TORCH.md`` §16).
    """

    def __init__(
        self,
        lineups: Sequence[Sequence],
        batch: int = DEFAULT_BATCH,
        bucket: Optional[int] = None,
        mesh=None,
        slots: Optional[Tuple[LearnerSlot, ...]] = None,
        device_learning: bool = False,
        single_round_cap: int = SINGLE_ROUND_CAP,
        device="cuda",
    ):
        assert lineups, "need at least one game"
        P = len(lineups[0])
        assert all(len(l) == P for l in lineups), "uniform player count required"
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the session's device {self.device} is not the mesh's {mesh.device}")
            self.device = mesh.device
        self.lineups = [list(agents) for agents in lineups]
        self.batch = batch
        self.bucket = bucket
        assert bucket is None or bucket >= len(self.lineups), (bucket, len(self.lineups))
        self.single_round_cap = single_round_cap
        self.device_learning = device_learning
        sigs = {lineup_signature(agents, batch) for agents in self.lineups}
        assert None not in sigs, "ineligible lineup (use BlockSession)"
        cfgs = {cfg for cfg, _, _ in sigs}
        specs = {spec for _, spec, _ in sigs if spec is not None}
        assert len(cfgs) == 1 and len(specs) <= 1, "mixed env dims / net specs"
        self.cfg = cfgs.pop()
        self.spec = specs.pop() if specs else MLPSpec(
            input_size=self.cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
        needed = set().union(*(s for _, _, s in sigs))
        if slots is None:
            slots = tuple(sorted(needed, key=LearnerSlot.sort_key))
        else:
            slots = tuple(slots)
            assert needed <= set(slots), "lineup uses a learner slot not provided"
        self.slots = slots
        self.results: List[np.ndarray] = []
        # Wall-clock split of the last block: host assembly, the block on the
        # device (until its trajectory is on the host) and the learn replay.
        self.timings: dict = {}

    def play(self) -> List[np.ndarray]:
        """Assemble, play and replay one block (dispatch then finalize)."""
        self.dispatch()
        return self.finalize()

    def assemble(self) -> BlockInputs:
        """The block's per-seat arguments, parameters on the session's device."""
        G, P = len(self.lineups), self.cfg.num_players
        slot_index = {slot: s for s, slot in enumerate(self.slots)}
        kinds = np.zeros((G, P), np.int32)
        mc_maxes = np.zeros((G, P), np.int32)
        mc_pers = np.zeros((G, P), np.int32)
        c_pucts = np.zeros((G, P), np.float32)
        epses = np.zeros((G, P), np.float32)
        families = [["random"] * P for _ in range(G)]
        params = [[None] * P for _ in range(G)]
        lparams = [[None] * P for _ in range(G)]
        on_device = {}

        def placed(agent):
            if id(agent) not in on_device:
                on_device[id(agent)] = tree_map(lambda x: x.to(self.device), agent.params)
            return on_device[id(agent)]

        for g, agents in enumerate(self.lineups):
            for p, agent in enumerate(agents):
                role, what = seat_slot(agent, self.batch)
                if role == "search":
                    kinds[g, p] = what
                    families[g][p] = "random" if what == KIND_RANDOM else "search"
                    if what != KIND_RANDOM:
                        mc_maxes[g, p] = agent.mc_max
                        mc_pers[g, p] = agent.mc_per_card
                    c_pucts[g, p] = float(getattr(agent, "c_puct", 0.0) or 0.0)
                    if what in NET_KINDS:
                        params[g][p] = placed(agent)
                else:
                    kinds[g, p] = KIND_LEARNER_BASE + slot_index[what]
                    families[g][p] = what.family
                    if what.family == "dqn" and not what.spec.noisy:
                        epses[g, p] = float(agent.eps)
                    lparams[g][p] = placed(agent)

        mc_ceiling = int(max(self.batch, mc_maxes.max(), 1))
        mc_ceiling = 1 << (mc_ceiling - 1).bit_length()
        # No PUCT-family seat: rounds exist only for PUCT's between-round root
        # statistics, so the playouts run in as few rounds as the cap allows
        # (the same outcome distribution for iid uniform/policy roots).
        puct_free = not bool(np.isin(kinds, (KIND_PUCT, KIND_PUCT_UNIFORM)).any())
        K = min(mc_ceiling, self.single_round_cap) if puct_free else self.batch
        return BlockInputs(mc_ceiling, K, puct_free, params, lparams, kinds, mc_maxes, mc_pers, c_pucts, epses,
                           families)

    def block_fn(self, inputs: BlockInputs):
        return make_device_block_fn(self.cfg, self.spec, len(self.lineups), inputs.mc_ceiling, inputs.K,
                                    self.slots, device=self.device)

    def dispatch(self) -> "DeviceBlockSession":
        """Assemble and play the block; its trajectory stays on the device for
        :meth:`finalize`.  Draws the one ``np.random.randint`` JAX's dispatch
        draws (its block key) and seeds the block's generator with it."""
        self.timings = {}
        t0 = time.perf_counter()
        inputs = self.assemble()
        fn = self.block_fn(inputs)
        gen = torch.Generator(device=self.device).manual_seed(int(np.random.randint(0, 2**31 - 1)))
        t1 = time.perf_counter()
        with record_function("block.play"):
            if self.mesh is None:
                scores, traj, final_obs = fn(inputs.params, inputs.lparams, inputs.kinds, inputs.mc_maxes,
                                             inputs.mc_pers, inputs.c_pucts, inputs.epses, gen)
            else:
                scores, traj, final_obs = self._play_sharded(inputs, gen)
        self._block = {"scores": scores, "traj": traj, "final_obs": final_obs, "families": inputs.families,
                       "t0": t0, "t1": t1}
        return self

    def _play_sharded(self, inputs: BlockInputs, gen: torch.Generator):
        """This rank's slice of the block's games on the whole block's noise,
        then every rank's slice gathered: the block's scores, trajectory and
        final observations for the session's games."""
        from ..parallel.mesh import game_sharding

        cfg, mesh, G, P = self.cfg, self.mesh, len(self.lineups), self.cfg.num_players
        B = -(-G // mesh.size) * mesh.size
        pad = lambda a: np.concatenate([a, np.zeros((B - G,) + a.shape[1:], a.dtype)])
        kinds, mc_maxes, mc_pers = pad(inputs.kinds), pad(inputs.mc_maxes), pad(inputs.mc_pers)
        rounds = turn_rounds(cfg, kinds, mc_maxes, mc_pers, inputs.K)
        noise = draw_block_noise(gen, cfg, B, inputs.K, rounds, self.slots,
                                 net=bool(np.isin(kinds, (KIND_POLICY, KIND_PUCT)).any()))
        sharding = game_sharding(mesh)
        lo, hi = sharding.bounds(B)
        full = deal(cfg, noise.deal_seed, B, device=self.device)
        state = EnvState(**{f.name: getattr(full, f.name)[lo:hi] for f in dataclasses.fields(EnvState)})
        empty = [[None] * P for _ in range(B - G)]
        fn = make_device_block_fn(cfg, self.spec, hi - lo, inputs.mc_ceiling, inputs.K, self.slots,
                                  device=self.device)
        scores, traj, final_obs = fn(
            (inputs.params + empty)[lo:hi], (inputs.lparams + empty)[lo:hi], kinds[lo:hi], mc_maxes[lo:hi],
            mc_pers[lo:hi], pad(inputs.c_pucts)[lo:hi], pad(inputs.epses)[lo:hi],
            shard_block_noise(noise, lo, hi, P, inputs.K), state=state)
        return (sharding.gather(scores)[:G], {k: sharding.gather(v, axis=1)[:, :G] for k, v in traj.items()},
                sharding.gather(final_obs)[:G])

    def finalize(self) -> List[np.ndarray]:
        """Fetch the trajectory and replay every learner's ``learn`` stream per
        game in block order: on the host, or with ``device_learning`` through
        the device planners (the same bookkeeping and ``np.random`` order, the
        updates on the device)."""
        blk, self._block = self._block, None
        families, t0, t1 = blk["families"], blk["t0"], blk["t1"]
        P, H = self.cfg.num_players, self.cfg.hand_size
        host = lambda x, dtype: x.cpu().numpy().astype(dtype)
        scores = host(blk["scores"], np.float32)
        traj = blk["traj"]
        obs = host(traj["obs"], np.float32)
        hands = host(traj["hands"], np.int32)
        picks = host(traj["picks"], np.int32)
        logps = host(traj["logps"], np.float32)
        logp_vecs = host(traj["logp_vecs"], np.float32)
        rewards = host(traj["rewards"], np.int64)
        final_obs = host(blk["final_obs"], np.float32)
        t2 = time.perf_counter()

        # A learner's planner is made at its first step, as JAX's: its device
        # buffer is created (or migrated) from the agent's state then.
        planners = {}

        def planner_for(agent):
            if not self.device_learning:
                return None
            if id(agent) not in planners:
                planners[id(agent)] = make_planner(agent)
            return planners[id(agent)]

        # The GameSession argument stream per game in block order (reward lag
        # incl., play.py:29-72).  Per-family infos mirror what each host
        # forward returns and its learn consumes: search/pv/reinforce step
        # records, ACER's behaviour log_probs + action_id, nothing for DQN or
        # random seats.
        with record_function("block.learn"):
            for g, agents in enumerate(self.lineups):
                prev_rewards = np.zeros(P, np.int64)
                for t in range(H):
                    done = t == H - 1
                    for i, agent in enumerate(agents):
                        pick = int(picks[t, g, i])
                        action = int(hands[t, g, i, pick])
                        fam = families[g][i]
                        if fam == "rmask":
                            mask = np.zeros(self.cfg.num_cards, dtype=bool)
                            mask[hands[t, g, i][hands[t, g, i] >= 0]] = True
                            # masked variant: chosen indexes the 104-card logits, i.e. the card itself.
                            record = {"state": obs[t, g, i], "legal_mask": mask, "chosen": np.int32(action)}
                        elif fam not in ("random", "dqn", "acer"):  # search / pv / rai: padded-hand records
                            record = {"state": obs[t, g, i], "legal_cards": hands[t, g, i], "chosen": np.int32(pick)}
                        planner = planner_for(agent) if fam in ("dqn", "acer", "rai", "rmask") else None
                        if planner is not None:
                            if fam == "dqn":
                                planner.on_step(state=obs[t, g, i], reward=prev_rewards[i], action=action,
                                                next_state=final_obs[g, i] if done else obs[t + 1, g, i], done=done)
                            elif fam == "acer":
                                planner.on_step(state=obs[t, g, i], legal_cards=hands[t, g, i],
                                                log_probs=logp_vecs[t, g, i], action_id=pick,
                                                next_reward=rewards[t, g, i], done=done, episode_end=done)
                            else:
                                planner.on_step(step_record=record, reward=prev_rewards[i], episode_end=done)
                            continue
                        if fam in ("random", "dqn"):
                            info = {}
                        elif fam == "acer":
                            info = {"log_probs": logp_vecs[t, g, i], "action_id": pick}
                        else:
                            info = {"log_prob": float(logps[t, g, i]), "step_record": record}
                        agent.learn(
                            state=obs[t, g, i],
                            legal_actions=[int(c) for c in hands[t, g, i] if c >= 0],
                            reward=prev_rewards[i],
                            action=action,
                            done=done,
                            next_state=final_obs[g, i] if done else obs[t + 1, g, i],
                            next_legal_actions=[] if done else [int(c) for c in hands[t + 1, g, i] if c >= 0],
                            next_reward=rewards[t, g, i],
                            num_episode=0,  # fresh-session parity (play.py:69)
                            episode_end=done,
                            **info,
                        )
                    prev_rewards = rewards[t, g]
            # Two phases, as JAX's: every agent's replay is dispatched before
            # any result is installed; nothing waits for the card in between.
            dispatched = [(p, p.dispatch()) for p in planners.values() if p is not None]
            for planner, handles in dispatched:
                if handles is not None:
                    planner.finalize(handles)
        t3 = time.perf_counter()
        self.timings = {"assemble_s": t1 - t0, "device_s": t2 - t1, "replay_s": t3 - t2}
        self.results = [scores[g] for g in range(len(self.lineups))]
        return self.results
