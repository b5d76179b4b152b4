"""Whole search-vs-search matches on the device (port of ``runtime/device_match.py``).

For rosters made of search and random agents -- the shape of strength
evaluations and head-to-head experiments -- nothing in the game loop needs
the host's agents: :func:`make_device_match_fn` plays G matches at once,
deal -> (decide per seat -> step) x hand_size, with each searcher's
determinization card memory (mcts.py:62-73) kept as a ``[G, C]`` mask on the
device.  The deal is K2 (``engine.deal``), every match turn and every
playout turn one K1 launch (``engine.step``).

Per-seat roster kinds:

* ``"random"`` -- uniform legal card (DrunkHamster, random.py:5-13),
* ``"uniform"`` -- MCS: determinized playouts, uniform playout policy,
* ``"policy"`` -- PolicyMCS: policy root sampling + policy playouts,
* ``"puct"`` -- Alpha0.5: PUCT root over policy playouts,
* ``"puct_uniform"`` -- decoupled Alpha0.5: PUCT root over the net's prior,
  uniform playouts.

Search seats make the device decision of :mod:`..agents.device_search`, with
the budget ``n_mc = min(mc_max, mc_per_card * n!)`` (mcts.py:105-106) from the
factorial table.  The JAX program was one ``lax.scan``; here the turns and
seats are Python loops over the batched games.
"""

from __future__ import annotations

import math

import torch

from ..agents.device_search import factorial_table, make_device_decision_fn_many, playout_budget
from ..agents.search import draw_gumbel, uniform_actions
from ..engine.env import deal, observe, step
from ..engine.state import EnvConfig, EnvState
from ..nets import MLPSpec
from ..utils.device import resolve_device

_PLAYOUT_POLICY = {
    "random": None,
    "uniform": "uniform",
    "policy": "net",
    "puct": "net",
    # Decoupled Alpha0.5: the net drives the ROOT prior only; determinized
    # playouts stay uniform.
    "puct_uniform": "uniform",
}
_ROOT = {
    "uniform": "uniform",
    "policy": "policy",
    "puct": "puct",
    "puct_uniform": "puct",
}


def budgets(cfg: EnvConfig, mc_max: int, mc_per_card: int) -> list:
    """``n_mc`` of the decision at each match turn ``t`` (``n = hand_size - t`` cards left)."""
    fact = factorial_table(cfg.hand_size, device="cpu")
    return [int(playout_budget(mc_max, mc_per_card, fact[cfg.hand_size - t])) for t in range(cfg.max_turns)]


def playout_turns_per_seat(cfg: EnvConfig, mc_max: int, mc_per_card: int = 10, batch: int = 8) -> int:
    """Playout turns (K1 launches) one search seat plays over a match:
    ``ceil(n_mc / K)`` rounds of ``n`` turns at every match turn, K = min(batch, mc_max)."""
    K = min(batch, mc_max)
    return sum(math.ceil(n_mc / K) * (cfg.hand_size - t) for t, n_mc in enumerate(budgets(cfg, mc_max, mc_per_card)))


def board_seen(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """``bool[G, C]``: the cards on each game's board."""
    cards = state.board.reshape(state.board.shape[0], -1)
    return (cards[:, :, None] == torch.arange(cfg.num_cards, device=cards.device)).any(dim=1)


def make_device_match_fn(
    cfg: EnvConfig,
    roster: tuple,
    spec: MLPSpec | None,
    num_games: int,
    mc_max: int = 100,
    mc_per_card: int = 10,
    batch: int = 8,
    c_puct: float = 2.0,
    device="cuda",
):
    """``match(params_per_seat, generator, state=None) -> scores f32[G, P]`` (rewards <= 0).

    ``roster`` is one kind per seat (``len == cfg.num_players``);
    ``params_per_seat`` holds one parameter tree per seat (None for random
    and uniform seats).  The match draws from the ``torch.Generator``: a deal
    seed (K2 deals the G games; an injected initial ``state``, e.g. from
    ``init_from_deck``, replaces the deal), then per turn and seat in seat
    order a random seat's Gumbel noise or a search seat's decision noise.
    Returns each seat's final accumulated reward per game (negated
    penalties, the GameSession ``results`` convention).
    """
    if len(roster) != cfg.num_players:
        raise ValueError(f"roster {roster} must name one kind per seat ({cfg.num_players})")
    unknown = set(roster) - set(_PLAYOUT_POLICY)
    if unknown:
        raise ValueError(f"unknown roster kinds {sorted(unknown)}; choose from {sorted(_PLAYOUT_POLICY)}")
    dev = resolve_device(device)
    C, H, G = cfg.num_cards, cfg.hand_size, num_games
    n_mcs = budgets(cfg, mc_max, mc_per_card)

    deciders = {}
    for kind in set(roster) - {"random"}:
        needs_net = _ROOT[kind] in ("policy", "puct") or _PLAYOUT_POLICY[kind] == "net"
        deciders[kind] = make_device_decision_fn_many(cfg, _PLAYOUT_POLICY[kind], spec if needs_net else None,
                                                      _ROOT[kind], mc_max, batch, c_puct, device=dev)

    def match(params_per_seat, generator: torch.Generator, state: EnvState | None = None):
        if state is None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
            state = deal(cfg, seed, G, device=dev)
        seen = board_seen(cfg, state)
        for t in range(H):
            n = H - t
            seen = seen | board_seen(cfg, state)
            obs, masks = observe(cfg, state)
            actions = []
            for p, kind in enumerate(roster):
                if kind == "random":
                    act = uniform_actions(masks[:, p], draw_gumbel(generator, (G, C), dev))
                else:
                    # Card memory: unseen cards, own hand excluded (mcts.py:62-73, cumulative `seen`).
                    avail = ~(seen | state.hands[:, p])
                    act, _ = deciders[kind](params_per_seat[p], state.board, state.row_len,
                                            state.hands_sorted[:, p], n, n_mcs[t], avail, obs[:, p], generator)
                actions.append(act)
            state, _ = step(cfg, state, torch.stack(actions, dim=1))
        return -state.scores.to(torch.float32)

    return match
