"""Plain reference of one arena match: the deal, then every turn each seat's
rule on every game and the turn's resolution (``game.play``).

Seat rules, on the draws the traffic made for the match:

* ``random``: hand slot ``min(floor(u * n), n - 1)`` of the ``n`` cards held,
  in float32;
* ``policy``: ``argmax(logits + gumbel)`` over the hand (a categorical draw);
* ``dqn``: the argmax of the noisy dueling Q over the cards held.

A net's pick is *decided* where its best value leads the second by more than
``DECIDE_MARGIN`` of the row's largest magnitude; a game is decided where
every pick of every turn in it is.  Rounding in float32 moves a value by about
1e-7 of that magnitude, so no order of float32 sums can turn a decided pick;
in an undecided game a pick of the program may rightly differ, and with it the
rest of the game.
"""

from __future__ import annotations

import torch

from . import game, nets

DECIDE_MARGIN = 1e-4


def decided(values: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """``bool[G]``: the best legal value leads the next by more than the margin."""
    v = torch.where(legal, values, -torch.inf)
    top = torch.topk(v, 2, dim=-1).values
    scale = torch.where(legal, values.abs(), 0).amax(dim=-1).clamp(min=1e-6)
    single = legal.sum(dim=-1) < 2
    return single | (top[:, 0] - top[:, 1] > DECIDE_MARGIN * scale)


def seat_cards(rules, kind: str, params, obs, hands, draws):
    """One seat's cards ``int64[G]`` and whether each pick is decided."""
    G = hands.shape[0]
    held = hands >= 0
    if kind == "random":
        n = held.sum(dim=-1)
        slot = torch.minimum(torch.floor(draws["u"].float() * n.float()).long(), n - 1)
        return torch.gather(hands, 1, slot[:, None])[:, 0], torch.ones(G, dtype=torch.bool, device=hands.device)
    if kind == "policy":
        values = nets.policy_logits(rules, params, obs, hands) + draws["gumbel"]
        slot = torch.argmax(torch.where(held, values, -torch.inf), dim=-1)
        return torch.gather(hands, 1, slot[:, None])[:, 0], decided(values, held)
    if kind == "dqn":
        q = nets.dueling_q(params, obs, draws["q"])
        cards = torch.arange(rules.num_cards, device=hands.device)
        legal = (hands[:, :, None] == cards).any(dim=1)
        return torch.argmax(torch.where(legal, q, -torch.inf), dim=-1), decided(q, legal)
    raise ValueError(f"unknown seat kind {kind!r}")


@torch.no_grad()
def play_match(rules, kinds, params, deal_seed: int, turns, games: torch.Tensor):
    """``(scores int64[G, P], decided bool[G])`` of the games ``games`` of one match.

    ``turns[t][p]`` is seat ``p``'s draws at turn ``t``, over all the match's
    games; the rows of ``games`` are taken from them."""
    g = game.deal(rules, deal_seed, games)
    clear = torch.ones(games.shape[0], dtype=torch.bool, device=games.device)
    for t in range(rules.hand_size):
        obs = game.observe(rules, g)
        picks = []
        for p, kind in enumerate(kinds):
            draws = {k: (v if k == "q" else v[games]) for k, v in turns[t][p].items()}
            card, ok = seat_cards(rules, kind, params[p], obs[:, p], g.hands[:, p], draws)
            picks.append(card)
            clear &= ok
        g, _ = game.play(rules, g, torch.stack(picks, dim=1))
    return g.scores, clear
