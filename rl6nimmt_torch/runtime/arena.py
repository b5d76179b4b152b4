"""Device arena: matchups of device-representable agents, thousands of games at
a time (port of ``runtime/arena.py``).

The reference evaluates matchups one hosted game at a time.  For the agents
whose acting rule is one net forward -- random, REINFORCE, ACER, any DQN --
a whole matchup runs on the card instead: one K2 deal (``engine.deal``), then
every turn each seat's rule over all G games and one K1 resolution
(``engine.step``).  Search and human agents keep the host ``GameSession``.
Each seat's rule runs inside an ``arena.seat.<kind>`` span (``utils/spans.py``).

Acting rules, as JAX's (``PARITY_TORCH.md`` section 15):

* ``random`` -- a uniform pick over the hand (random.py:5-13);
* ``policy`` -- a categorical sample, ``argmax(logits + Gumbel)``, over the
  action-in-input logits, for REINFORCE (policy.py:137-156) and for ACER,
  whose actor head is the same net's first head (a-c.py:49-57; no log-epsilon
  clamp, unlike the device block's ACER rule);
* ``dqn`` -- the masked argmax of Q at ``NEG_INF``: with one factorized noise
  a seat and turn, shared by the G games, for noisy configs; epsilon-greedy
  otherwise, epsilon a per-call value (dqn.py:196-230, 251-261).

Randomness comes from a ``torch.Generator`` or an injected :class:`ArenaNoise`
(the deal's Philox seed or a start ``EnvState``, and each turn's
:class:`SeatDraws`): given JAX's dealt state and draws, the port plays JAX's
match (``tests/test_torch_arena.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..agents.dqn import DQNAgent, DQNConfig, q_values, tree_map
from ..agents.reinforce import action_in_input_logits
from ..agents.search import draw_gumbel, state_to
from ..engine import EnvConfig, EnvState, deal, observe, step
from ..nets import draw_mlp_noise
from ..utils.device import resolve_device
from ..utils.ops import onehot_select, uniform_index
from ..utils.spans import span

NEG_INF = -1e9


class SeatPolicy(NamedTuple):
    """Static per-seat policy description; params and epsilon come at call time."""

    kind: str                      # "random" | "policy" | "dqn"
    spec: object = None            # MLPSpec for nets
    dqn_cfg: Optional[DQNConfig] = None


@dataclass
class SeatDraws:
    """One seat's draws of one turn over the G games (JAX: the seat's key).

    ``u`` ``f32[G]``: a random seat's uniform; ``gumbel`` ``f32[G, H]``: a
    policy seat's categorical noise; ``q``: a noisy DQN's per-layer factorized
    noise, one draw shared by all games (``noise_key``); ``explore`` and
    ``pick`` ``f32[G]``: epsilon-greedy's uniforms (``eps_key``, ``rand_key``).
    """

    u: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    q: Optional[list] = None
    explore: Optional[torch.Tensor] = None
    pick: Optional[torch.Tensor] = None


@dataclass
class ArenaNoise:
    """A whole match's randomness: the deal's Philox seed, or a start position
    in its place, and per turn every seat's :class:`SeatDraws`."""

    deal_seed: int
    turns: List[List[SeatDraws]]
    state: Optional[EnvState] = field(default=None)


def draw_seat(policy: SeatPolicy, generator: torch.Generator, num_games: int, hand_size: int) -> SeatDraws:
    """One seat's draws of one turn, on the generator's device."""
    G, dev = num_games, generator.device
    uniform = lambda: torch.rand((G,), generator=generator, device=dev)
    if policy.kind == "random":
        return SeatDraws(u=uniform())
    if policy.kind == "policy":
        return SeatDraws(gumbel=draw_gumbel(generator, (G, hand_size), dev))
    if policy.kind == "dqn":
        if policy.dqn_cfg.noisy:
            return SeatDraws(q=draw_mlp_noise(policy.spec, generator))
        return SeatDraws(explore=uniform(), pick=uniform())
    raise ValueError(f"unknown seat policy kind: {policy.kind}")


def _seat_actions(policy: SeatPolicy, params, eps: float, obs, hands_sorted, masks, draws: SeatDraws):
    """One seat's cards over all games: ``int32[G]``."""
    if policy.kind == "random":
        r = uniform_index(draws.u, (hands_sorted >= 0).sum(dim=-1))
        return onehot_select(hands_sorted, r)
    if policy.kind == "policy":
        logits = action_in_input_logits(policy.spec, params, obs, hands_sorted)
        return onehot_select(hands_sorted, torch.argmax(logits + draws.gumbel, dim=-1))
    if policy.kind == "dqn":
        cfg = policy.dqn_cfg
        q = q_values(cfg, policy.spec, params, obs, draws.q if cfg.noisy else None)
        greedy = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1).to(torch.int32)
        if cfg.noisy:
            return greedy
        uniform = onehot_select(hands_sorted, uniform_index(draws.pick, (hands_sorted >= 0).sum(dim=-1)))
        return torch.where(draws.explore < eps, uniform, greedy)
    raise ValueError(f"unknown seat policy kind: {policy.kind}")


def make_arena(cfg: EnvConfig, policies: Tuple[SeatPolicy, ...], num_games: int, device="cuda"):
    """``arena(params_per_seat, eps_per_seat, noise) -> scores int32[G, P]`` (the
    games' total rewards, on the device).

    ``policies`` has one entry a seat; ``params_per_seat`` holds None for the
    parameter-free seats and each net's params on ``device``;
    ``eps_per_seat`` the epsilon-greedy seats' epsilon (ignored elsewhere);
    ``noise`` a ``torch.Generator`` on ``device`` or an :class:`ArenaNoise`.
    """
    assert len(policies) == cfg.num_players
    dev = resolve_device(device)
    G, P, H = num_games, cfg.num_players, cfg.hand_size
    seat_spans = tuple(f"arena.seat.{pol.kind}" for pol in policies)

    def run(params_tuple, eps_tuple, noise):
        if isinstance(noise, ArenaNoise):
            state = deal(cfg, noise.deal_seed, G, device=dev) if noise.state is None else state_to(noise.state, dev)
            draws = lambda t: [SeatDraws(**{k: _to(v, dev) for k, v in vars(d).items()}) for d in noise.turns[t]]
        elif isinstance(noise, torch.Generator):
            seed = int(torch.randint(0, 2**62, (1,), generator=noise, device=noise.device))
            state = deal(cfg, seed, G, device=dev)
            draws = lambda t: [draw_seat(pol, noise, G, H) for pol in policies]
        else:
            raise TypeError("noise must be a torch.Generator or an ArenaNoise")
        for t in range(cfg.max_turns):
            obs, masks = observe(cfg, state)
            turn = draws(t)
            actions = []
            for p in range(P):
                with span(seat_spans[p]):
                    actions.append(_seat_actions(policies[p], params_tuple[p], eps_tuple[p], obs[:, p],
                                                 state.hands_sorted[:, p], masks[:, p], turn[p]).to(torch.int32))
            state, _ = step(cfg, state, torch.stack(actions, dim=1))
        return -state.scores

    return run


def _to(x, dev):
    if x is None:
        return None
    if isinstance(x, list):
        return [{k: v.to(dev) for k, v in layer.items()} for layer in x]
    return x.to(dev)


def seat_policy_of(agent) -> Optional[Tuple[SeatPolicy, object]]:
    """Map a host agent to its (SeatPolicy, params); None if host-only."""
    from ..agents.acer import BatchedActionValueActorCriticAgent
    from ..agents.mcs import BaseMCAgent
    from ..agents.random_agent import DrunkHamster
    from ..agents.reinforce import BatchedReinforceAgent

    if isinstance(agent, DrunkHamster):
        return SeatPolicy("random"), None
    if isinstance(agent, BaseMCAgent):
        return None  # search agents need host-side determinization
    if isinstance(agent, BatchedReinforceAgent):
        return SeatPolicy("policy", spec=agent.spec), agent.params
    if isinstance(agent, BatchedActionValueActorCriticAgent):
        return SeatPolicy("policy", spec=agent.spec), agent.params
    if isinstance(agent, DQNAgent):
        return SeatPolicy("dqn", spec=agent.spec, dqn_cfg=agent.cfg), agent.params
    return None


def play_match(agents, num_games: int, seed: int = 0, device="cuda", noise: Optional[ArenaNoise] = None) -> np.ndarray:
    """Play ``num_games`` device games between host agents; returns scores ``[G, P]``.

    Randomness from a generator on ``device`` seeded with ``seed``, or the
    injected ``noise``.  Raises ``ValueError`` if any agent is not
    device-representable (Human, search agents): those play through the host
    ``GameSession``.
    """
    mapped = [seat_policy_of(a) for a in agents]
    if any(m is None for m in mapped):
        bad = [type(a).__name__ for a, m in zip(agents, mapped) if m is None]
        raise ValueError(f"agents not device-representable: {bad}")
    dev = resolve_device(device)
    policies = tuple(m[0] for m in mapped)
    params = tuple(None if m[1] is None else tree_map(lambda x: x.to(dev), m[1]) for m in mapped)
    # Epsilon is a per-call value (it decays while the agent trains), in float32 as JAX's.
    eps = tuple(float(np.float32(getattr(a, "eps", 0.0))) for a in agents)
    cfg = EnvConfig(num_players=len(agents))
    arena = make_arena(cfg, policies, num_games, device=dev)
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(int(seed))
    return arena(params, eps, noise).cpu().numpy()
