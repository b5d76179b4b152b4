"""K6: K4's play loop cut down by variant (port of ``experiments/act_rollout_ablate.py``).

``make_act_ablate_kernel(cfg, num_games, hidden, variant)`` returns ``play(seed,
w1, b1, wa, ba) -> (obs, actions, rewards)`` with K4's shapes: ``obs`` int8
``[T+1, G, P, S]`` (``None`` for ``env``), ``actions`` and ``rewards`` int32
``[T, G, P]``.  The variants are cumulative:

* ``env``  -- deal and uniform-legal play: seat ``p`` at turn ``t`` plays hand
  slot ``(word * count) >> 32`` of its game's ``STREAM_PLAY`` word ``t*P + p``,
  K3's rule, so the games are ``play_random_games(seed)``'s;
* ``obs``  -- plus K4's int8 observations, the terminal one included;
* ``mm``   -- plus K4's hidden layer and the full ``A``-wide advantage head;
  the seat plays ``hand[((word + argmax_a adv) mod 2**32) % count]`` (first
  maximum, unmasked), the TPU ablation's fold;
* ``full`` -- K4 itself: ``make_act_rollout_kernel``'s ``play``.

On CUDA weights ``env``/``obs``/``mm`` launch ``csrc/act_ablate_kernel.cu``
(the three variants instantiate K4's loop, ``csrc/act_play.cuh``); on CPU
weights they run :func:`act_ablate_plain`.  ``env`` and ``obs`` read no
weights, but take them so that every variant has one signature and one device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine.env import observe, state_from_deal, step_with
from ..engine.state import EnvConfig
from . import _build
from .act_rollout_kernel import (_check_kernel_cfg, _check_tensors, _weight_specs, act_rollout_plain,
                                 make_act_rollout_kernel)
from .game_kernel import _check_seed, deal_games_plain, random_pick_words, random_picks
from .philox import MASK32
from .step_kernel import resolve_turn_plain

VARIANTS = _build.ABLATE_VARIANTS + ("full",)
_CODE = {v: i for i, v in enumerate(_build.ABLATE_VARIANTS)}   # rl6_act_ablate's variant argument
_ABLATE = {v: _build.Launcher("rl6_act_ablate", f"act_ablate_{v}") for v in _build.ABLATE_VARIANTS}


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}; expected one of {VARIANTS}")


def full_head_picks(hands_sorted, words, obs, w1, b1, wa, ba):
    """``mm``'s pick: the hand slot ``((word + argmax_a adv) mod 2**32) % count``,
    ``adv = relu(obs @ w1 + b1) @ wa + ba`` over all ``A`` columns.  Returns
    ``(cards int32[G, P], adv f32[G, P, A])``."""
    adv = torch.relu(obs @ w1 + b1) @ wa + ba
    amax = torch.argmax(adv, dim=-1)
    slot = ((words + amax) & MASK32) % (hands_sorted >= 0).sum(dim=-1)
    return torch.gather(hands_sorted, -1, slot[..., None]).squeeze(-1).to(torch.int32), adv


def act_ablate_plain(cfg: EnvConfig, variant: str, seed: int, num_games: int, w1, b1, wa, ba):
    """Plain twin of K6 (``full``: K4's twin): the same deals and Philox
    words, played on the engine with the plain resolver."""
    _check_variant(variant)
    seed = _check_seed(seed)
    if variant == "full":
        return act_rollout_plain(cfg, seed, num_games, w1, b1, wa, ba)
    dev = w1.device
    state = state_from_deal(cfg, *deal_games_plain(cfg, seed, num_games, dev))
    words = random_pick_words(cfg, seed, num_games, dev)
    obs_all, actions_all, rewards_all = [], [], []
    for t in range(cfg.max_turns):
        if variant == "env":
            actions = random_picks(state.hands_sorted, words[t])
        else:
            obs = observe(cfg, state)[0]
            obs_all.append(obs.to(torch.int8))
            if variant == "obs":
                actions = random_picks(state.hands_sorted, words[t])
            else:
                actions, _ = full_head_picks(state.hands_sorted, words[t], obs, w1[t], b1[t], wa[t], ba[t])
        state, rewards = step_with(cfg, state, actions, resolve_turn_plain)
        actions_all.append(actions.to(torch.int32))
        rewards_all.append(rewards)
    if variant == "env":
        return None, torch.stack(actions_all), torch.stack(rewards_all)
    obs_all.append(observe(cfg, state)[0].to(torch.int8))
    return torch.stack(obs_all), torch.stack(actions_all), torch.stack(rewards_all)


def make_act_ablate_kernel(cfg: EnvConfig, num_games: int, hidden: int, variant: str):
    """Build ``play(seed, w1, b1, wa, ba)`` for one ablation ``variant`` (any G)."""
    _check_variant(variant)
    if variant == "full":
        return make_act_rollout_kernel(cfg, num_games, hidden)
    _check_kernel_cfg(cfg, hidden)
    G, P, S = num_games, cfg.num_players, cfg.state_length
    n_turns = cfg.max_turns
    counter, launch = f"act_ablate_{variant}", _ABLATE.get(variant)

    def play(seed, w1, b1, wa, ba):
        seed = _check_seed(seed)
        dev = w1.device
        _check_tensors(counter, dev, _weight_specs(cfg, hidden, w1, b1, wa, ba))
        if dev.type == "cpu":
            return act_ablate_plain(cfg, variant, seed, G, w1, b1, wa, ba)
        if dev.type != "cuda":
            raise ValueError(f"{counter}: unsupported device {dev}")
        obs = None
        if variant != "env":
            obs = torch.empty((n_turns + 1, G, P, S), dtype=torch.int8, device=dev)
        actions = torch.empty((n_turns, G, P), dtype=torch.int32, device=dev)
        rewards = torch.empty((n_turns, G, P), dtype=torch.int32, device=dev)
        if G:
            launch(dev.index, _CODE[variant], seed, w1.data_ptr(), b1.data_ptr(), wa.data_ptr(), ba.data_ptr(),
                   0 if obs is None else obs.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
                   G, P, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.num_cards,
                   hidden, n_turns, int(cfg.include_summaries))
        return obs, actions, rewards

    return play


def ablate_twin_agreement(cfg: EnvConfig, variant: str, num_games: int, hidden: int, seed: int,
                          weights) -> Tuple[float, int, float]:
    """One K6 variant against its plain twin on the same inputs (the card's check).

    The deals (``obs[0]``) must be equal; in the games whose actions all agree
    (``mm``'s 104-wide argmax sums in another order than the twin's matmul,
    so a near-tie may flip), the observations and rewards must be equal bit
    for bit.  Returns ``(action agreement, agreeing games, largest difference
    in agreeing games)``; raises ``AssertionError`` on a mismatch.
    """
    ok, ak, rk = make_act_ablate_kernel(cfg, num_games, hidden, variant)(seed, *weights)
    op, ap, rp = act_ablate_plain(cfg, variant, seed, num_games, *weights)
    if ok is not None and not torch.equal(ok[0], op[0]):
        raise AssertionError(f"K6 {variant}: the deals differ from its twin's")
    same = (ak == ap).all(dim=(0, 2))                                    # [G]
    pairs = [(ak[:, same], ap[:, same]), (rk[:, same], rp[:, same])]
    if ok is not None:
        pairs.append((ok[:, same], op[:, same]))
    for name, (a, b) in zip(("actions", "rewards", "observations"), pairs):
        if not torch.equal(a, b):
            raise AssertionError(f"K6 {variant}: {name} differ from its twin in games whose actions agree")
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in pairs)
    return (ak == ap).float().mean().item(), int(same.sum()), err
