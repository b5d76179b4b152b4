"""Plain reference of one REINFORCE self-play update (Williams 1992), as the
published agent learns: every seat of every game is an episode of the policy.

* Rollout: at turn ``t`` each seat picks ``argmax(logits + gumbel[t])`` over its
  hand (a categorical draw) with the action-in-input policy (``nets``).
* Rewards are lagged one turn (the reward of turn ``t`` is credited at
  ``t + 1``, the first is 0), scaled by ``r_factor``; returns ``G_t = r_t +
  gamma G_{t+1}``.
* A seat's loss is ``-actor_weight sum_t gamma^t G_t log pi(a_t) -
  entropy_weight sum_t H_t``; the update's loss is the mean over the seats.
* Adam (Kingma and Ba 2015): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
  g^2``, ``p -= lr (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps)``.

The loss is summed over blocks of games, each block's backward added to the
gradient, so that a rollout of any size fits.  The rollout also counts the
games in which some pick is undecided (``arena.decided``: its best value leads
the next by no more than rounding could move them), where the program may
rightly pick the other card and play the rest of the game otherwise.
"""

from __future__ import annotations

import torch

from . import game, nets
from .arena import decided


def _block_loss_sum(rules, learner: dict, params, deal_seed: int, gumbel, games):
    """The sum of the seats' losses over the games ``games``, and how many of
    those games hold an undecided pick."""
    g = game.deal(rules, deal_seed, games)
    T = H = rules.hand_size
    clear = torch.ones(games.shape[0], dtype=torch.bool, device=games.device)
    logps, ents, rewards = [], [], []
    for t in range(T):
        obs = game.observe(rules, g)
        logits = nets.policy_logits(rules, params, obs, g.hands)              # [B, P, H]
        values = logits.detach() + gumbel[t]
        pick = torch.argmax(values, dim=-1)
        clear &= decided(values.reshape(-1, H), (g.hands >= 0).reshape(-1, H)).view(values.shape[:2]).all(dim=1)
        logp = torch.log_softmax(logits, dim=-1)
        p = torch.exp(logp)
        ents.append(-torch.sum(torch.where(p > 0, p * logp, 0.0), dim=-1))
        logps.append(torch.gather(logp, -1, pick[..., None])[..., 0])
        g, r = game.play(rules, g, torch.gather(g.hands, -1, pick[..., None])[..., 0])
        rewards.append(r.to(torch.float32))
    r = torch.stack(rewards)
    if learner["reward_lag"]:
        r = torch.cat([torch.zeros_like(r[:1]), r[:-1]])
    r = r * learner["r_factor"]
    gamma = learner["gamma"]
    returns, acc = torch.empty_like(r), torch.zeros_like(r[0])
    for t in range(T - 1, -1, -1):
        acc = r[t] + gamma * acc
        returns[t] = acc
    disc = gamma ** torch.arange(T, dtype=torch.float32, device=r.device)
    actor = -torch.sum(disc[:, None, None] * returns * torch.stack(logps), dim=0)
    seat = learner["actor_weight"] * actor - learner["entropy_weight"] * torch.stack(ents).sum(dim=0)
    return seat.sum(), int((~clear).sum())


def loss_and_grads(rules, learner: dict, params, deal_seed: int, gumbel, block: int):
    """``(loss, grads, undecided)`` of one update: ``gumbel`` is ``f32[T, G, P, H]``;
    ``undecided`` counts the games with a pick within rounding of a tie."""
    inputs = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    live = rebuild(params, inputs)
    G, P = gumbel.shape[1], gumbel.shape[2]
    total, undecided = 0.0, 0
    grads = [torch.zeros_like(x) for x in inputs]
    dev = gumbel.device
    for a in range(0, G, block):
        games = torch.arange(a, min(a + block, G), device=dev)
        s, open_games = _block_loss_sum(rules, learner, live, deal_seed, gumbel[:, a:a + block], games)
        s = s / (G * P)
        undecided += open_games
        for acc, g in zip(grads, torch.autograd.grad(s, inputs, allow_unused=True)):
            if g is not None:
                acc += g
        total += float(s.detach())
    return total, rebuild(params, grads), undecided


def adam(learner: dict, params, grads, state, count: int):
    """One Adam step: ``(params', state')``; ``state`` ``(m, v)`` trees or None."""
    b1, b2, lr, eps = learner["b1"], learner["b2"], learner["lr"], learner["eps"]
    p, g = leaves(params), leaves(grads)
    m, v = ([torch.zeros_like(x) for x in p] for _ in range(2)) if state is None else map(leaves, state)
    m = [b1 * mi + (1 - b1) * gi for mi, gi in zip(m, g)]
    v = [b2 * vi + (1 - b2) * gi * gi for vi, gi in zip(v, g)]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = [pi - lr * (mi / c1) / (torch.sqrt(vi / c2) + eps) for pi, mi, vi in zip(p, m, v)]
    return rebuild(params, new), (rebuild(params, m), rebuild(params, v))


def leaves(tree):
    return [layer[k] for part in ("trunk", "heads") for layer in tree[part] for k in sorted(layer)]


def rebuild(like, values):
    it = iter(values)
    return {part: [{k: next(it) for k in sorted(layer)} for layer in like[part]] for part in ("trunk", "heads")}


def leaf_names(tree):
    return [f"{part}.{i}.{k}" for part in ("trunk", "heads") for i, layer in enumerate(tree[part])
            for k in sorted(layer)]
