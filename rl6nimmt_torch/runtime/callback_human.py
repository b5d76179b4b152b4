"""Human-vs-device game with a host prompt for the human seat (port of
``runtime/callback_human.py``).

JAX compiled the whole game -- deal, every AI seat's device-search decision,
resolution, all ten turns -- into one program and crossed to the host only for
the human's card, with one ordered ``io_callback`` a turn.  PyTorch runs
eagerly, so a host loop stands in for the callback: the deal (K2 on the
card), every AI decision (:func:`~..agents.device_search
.make_unified_decision_fn`) and each turn's resolution (K1) stay on the
device, and once a turn the human's observation and hand come to the host,
the prompt runs, and the chosen card goes back into the turn's actions.

The prompt/retry semantics replicate the reference ``Human`` agent
(human.py:7-33): 1-indexed card faces, re-prompt until a held card is named;
the board is rendered from the observation's board grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..agents.device_search import (KIND_POLICY, KIND_PUCT, KIND_PUCT_UNIFORM, KIND_RANDOM, KIND_UNIFORM,
                                    factorial_table, make_unified_decision_fn, playout_budget)
from ..agents.human import prompt_for_card
from ..engine.cards import format_card
from ..engine.env import deal, observe, step
from ..engine.state import EnvConfig
from ..nets import MLPSpec, mlp_init
from ..utils.device import resolve_device
from .device_match import board_seen

KIND_OF = {"random": KIND_RANDOM, "uniform": KIND_UNIFORM, "policy": KIND_POLICY, "puct": KIND_PUCT,
           "puct_uniform": KIND_PUCT_UNIFORM}


def _render_board(obs, num_rows: int, threshold: int):
    """Print the board grid from the tail of an observation."""
    grid = np.asarray(obs)[-num_rows * threshold:].reshape(num_rows, threshold).astype(int)
    print("Board:")
    for row in grid:
        cells = [format_card(c) if c >= 0 else "  _  " for c in row]
        print("  " + " ".join(cells))


def _prompt_human(obs, hand, name: str = "Human", num_rows: int = 4, threshold: int = 6) -> int:
    """Board render from the observation + the shared reference prompt loop (human.py)."""
    legal = [int(c) for c in np.asarray(hand) if c >= 0]
    _render_board(obs, num_rows, threshold)
    return int(prompt_for_card(legal, name))


def make_callback_human_game(cfg: EnvConfig, spec: MLPSpec, mc_max: int = 100, mc_per_card: int = 10,
                             batch: int = 8, c_puct: float = 2.0, name: str = "Human", device="cuda"):
    """``game(params, kinds int[P], generator) -> scores f32[P]`` (numpy).

    Seat 0 is the human (its ``kinds`` entry is ignored); seats 1.. make the
    kind-traced device decision (random / uniform MCS / policy / PUCT /
    decoupled PUCT), all with the prior net ``params`` (None when no seat
    uses a net).  ``generator`` (on the device) draws the deal and every
    decision's noise.
    """
    dev = resolve_device(device)
    P, H = cfg.num_players, cfg.hand_size
    fact = factorial_table(H, device="cpu")
    decide = make_unified_decision_fn(cfg, spec, mc_max, batch, device=dev)
    ai = torch.arange(1, P, device=dev)

    def game(params, kinds, generator: torch.Generator):
        kinds = np.asarray(kinds, np.int64)
        if kinds.shape != (P,):
            raise ValueError(f"kinds of shape {kinds.shape}, expected {(P,)}")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        state = deal(cfg, seed, 1, device=dev)
        seen = board_seen(cfg, state)
        ai_kinds = kinds[1:]
        for t in range(H):
            n = H - t
            seen = seen | board_seen(cfg, state)
            obs, _ = observe(cfg, state)
            # The one host crossing of the turn: the human's view out, the card back.
            human = _prompt_human(obs[0, 0].cpu().numpy(), state.hands_sorted[0, 0].cpu().numpy(), name,
                                  cfg.num_rows, cfg.threshold)
            n_mc = np.where(ai_kinds == KIND_RANDOM, 0, playout_budget(mc_max, mc_per_card, fact[n]).numpy())
            avail = ~(seen[:, None, :] | state.hands)[0]
            hands = state.hands_sorted[0, ai]
            _, _, pick = decide(params, ai_kinds, state.board.expand(P - 1, -1, -1),
                                state.row_len.expand(P - 1, -1), hands, n, n_mc, c_puct, avail[ai], obs[0, ai],
                                generator)
            ai_cards = torch.gather(hands, 1, pick.long()[:, None])[:, 0]
            actions = torch.cat([torch.tensor([human], dtype=ai_cards.dtype, device=dev), ai_cards])[None]
            state, _ = step(cfg, state, actions)
        return (-state.scores[0].to(torch.float32)).cpu().numpy()

    return game


def play_callback_game(opponents, params=None, mc_max: int = 100, seed: int = 0, name: str = "Human",
                       device="cuda"):
    """Play one human-vs-device game; returns the final scores (seat 0 = human).

    ``opponents`` are kinds per AI seat: "random" / "uniform" (MCS) /
    "policy" / "puct" / "puct_uniform".  ``params`` is one prior-net tree
    shared by the policy/puct seats (initialized from ``seed`` when None).
    """
    dev = resolve_device(device)
    P = 1 + len(opponents)
    cfg = EnvConfig(num_players=P)
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    kinds = np.asarray([KIND_RANDOM] + [KIND_OF[o] for o in opponents], np.int64)
    if params is None and np.isin(kinds, (KIND_POLICY, KIND_PUCT, KIND_PUCT_UNIFORM)).any():
        params = mlp_init(torch.Generator(device=dev).manual_seed(seed), spec, dev)
    game = make_callback_human_game(cfg, spec, mc_max=mc_max, name=name, device=dev)
    scores = game(params, kinds, torch.Generator(device=dev).manual_seed(seed + 1))
    print("Final scores:", {name: float(scores[0]),
                            **{f"seat{i}": float(s) for i, s in enumerate(scores[1:], 1)}})
    return scores
