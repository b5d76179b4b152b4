"""Plain reference of one Noisy-D3QN-PER-n-step self-play cycle (Hessel et al.
2018's pieces: double DQN, dueling heads, noisy nets, prioritized replay,
n-step returns), as the published agent learns from every seat of G games.

* Rollout: each turn every seat plays the argmax, over the cards it holds, of
  the noisy dueling Q on the raw observation, with one noise draw a turn shared
  by all games and seats.
* Harvest: rewards lagged one turn; the n-step return ``R_t = sum_i gamma^i
  r_{t+i}`` (nothing past the last turn); the next state is the one ``n`` turns
  on, the final one past the end; the last ``n - 1`` turns (the last one for
  ``n = 1``) are terminal.  Rows in (turn, game, seat) order.
* Replay: a ring of ``capacity`` rows; a batch goes in at the ring pointer with
  the largest priority held (1 in an empty buffer).  A sample of ``m`` rows
  takes, for ``k < m``, the first row whose running priority sum reaches ``(k +
  u_k) total / m``, the sum formed as block sums, a running sum over the
  blocks, then a running sum inside the block (blocks of a power of two from
  64 to 1024 near sqrt(capacity)); a row of priority 0 is replaced by the one
  of largest priority.  Weights ``(p / p_min)^-beta``, beta raised by 0.001 a
  sample from 0.4 up to 1.  After an update a sampled row's priority is
  ``min(|error| + 0.01, 1)^0.6``, the last of its duplicates winning.
* Update: ``y = R + gamma^n Q_target(s', argmax_a Q_online(s', a)) (1 - done)``,
  online and target Q each under its own noise draw; loss ``mean(w (Q(s, a) -
  y)^2)`` under a third; Adam; every ``retrain_interval``-th update of the
  cycle (the first included) the target moves ``tau`` of the way to the online
  weights.
"""

from __future__ import annotations

import torch

from . import arena, game, nets, reinforce

ABS_ERROR_UPPER, PRIORITY_EPS, ALPHA, BETA0, BETA_STEP = 1.0, 0.01, 0.6, 0.4, 0.001


class Replay:
    def __init__(self, capacity: int, state_size: int, device):
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
        self.rows = {"state": z(capacity, state_size), "action": z(capacity, dt=torch.int64), "reward": z(capacity),
                     "next_state": z(capacity, state_size), "done": z(capacity)}
        self.priority = z(capacity)
        self.ptr, self.capacity = 0, capacity
        self.beta = torch.tensor(BETA0, device=device)

    def insert(self, rows: dict) -> None:
        n = rows["reward"].shape[0]
        top = self.priority.max()
        p = torch.where(top == 0, torch.ones_like(top) * ABS_ERROR_UPPER, top)
        slots = (self.ptr + torch.arange(n, device=self.priority.device)) % self.capacity
        for k, v in rows.items():
            self.rows[k][slots] = v.to(self.rows[k].dtype)
        self.priority[slots] = p
        self.ptr = (self.ptr + n) % self.capacity

    def sample(self, u: torch.Tensor):
        pri, m = self.priority, u.shape[0]
        total = pri.sum()
        self.beta = torch.clamp(self.beta + BETA_STEP, max=1.0)
        targets = (torch.arange(m, dtype=torch.float32, device=u.device) + u) * (total / m)
        B = 64
        while B * B < self.capacity and B < 1024:
            B *= 2
        nb = -(-self.capacity // B)
        blocks = torch.cat([pri, pri.new_zeros(nb * B - self.capacity)]).reshape(nb, B)
        run = torch.cumsum(blocks.sum(dim=1), dim=0)
        b = torch.clamp((run[None, :] < targets[:, None]).sum(dim=1), max=nb - 1)
        before = torch.where(b > 0, run[torch.clamp(b - 1, min=0)], torch.zeros_like(targets))
        inner = torch.cumsum(blocks[b], dim=1)
        idx = b * B + torch.clamp((inner < (targets - before)[:, None]).sum(dim=1), max=B - 1)
        idx = torch.where(pri[idx] > 0, idx, torch.argmax(pri))
        p_min = torch.where(pri > 0, pri, torch.inf).min() / total
        weights = torch.pow(pri[idx] / total / p_min, -self.beta)
        return idx, weights, {k: v[idx] for k, v in self.rows.items()}

    def update(self, idx: torch.Tensor, err: torch.Tensor) -> None:
        p = torch.pow(torch.clamp(err.abs() + PRIORITY_EPS, max=ABS_ERROR_UPPER), ALPHA)
        same = idx[None, :] == idx[:, None]
        last = torch.where(same, torch.arange(idx.shape[0], device=idx.device)[None, :], -1).max(dim=1).values
        self.priority[idx] = p[last]


@torch.no_grad()
def harvest(rules, params, turn_noise, deal_seed: int, games: int, gamma: float, n: int,
            seat_major: bool = False) -> dict:
    """One rollout's n-step rows and, a row, whether its game is decided (every
    pick leads its runner-up by more than ``arena.DECIDE_MARGIN``); ``turn_noise[t]``
    is turn ``t``'s noise a layer.  Rows in (turn, game, seat) order, or (turn,
    seat, game) with ``seat_major`` (the feature-major replay's slot order)."""
    g = game.deal(rules, deal_seed, torch.arange(games, device=params["trunk"][0]["w"].device))
    T, P = rules.hand_size, rules.num_players
    cards = torch.arange(rules.num_cards, device=g.hands.device)
    obs, acts, rews = [], [], []
    decided = torch.ones(games, dtype=torch.bool, device=g.hands.device)
    for t in range(T):
        o = game.observe(rules, g)
        q = nets.dueling_q(params, o, turn_noise[t])
        legal = (g.hands[..., None] == cards).any(dim=-2)
        a = torch.argmax(torch.where(legal, q, -torch.inf), dim=-1)
        decided &= arena.decided(q.reshape(games * P, -1), legal.reshape(games * P, -1)).reshape(games, P).all(dim=1)
        g, r = game.play(rules, g, a)
        obs.append(o), acts.append(a), rews.append(r.to(torch.float32))
    final = game.observe(rules, g)
    r = torch.stack(rews)
    r = torch.cat([torch.zeros_like(r[:1]), r[:-1]])
    padded = torch.cat([r, r.new_zeros((n - 1,) + r.shape[1:])])
    disc = torch.tensor([gamma ** i for i in range(n)], dtype=torch.float32, device=r.device)
    ret = sum(disc[i] * padded[i: i + T] for i in range(n))
    states = torch.stack(obs + [final])
    nxt = states[torch.clamp(torch.arange(T, device=r.device) + n, max=T)]
    tail = T - n + 1 if n > 1 else T - 1
    done = (torch.arange(T, device=r.device) >= tail).to(torch.float32)[:, None, None].expand_as(r)
    order = (lambda x: x.transpose(1, 2)) if seat_major else (lambda x: x)
    flat = lambda x: order(x).reshape((-1,) + tuple(x.shape[3:]))
    rows = {"state": flat(torch.stack(obs)), "action": flat(torch.stack(acts)), "reward": flat(ret),
            "next_state": flat(nxt), "done": flat(done)}
    return rows, flat(decided[None, :, None].expand(T, games, P))


def update(learner: dict, params, target, batch, weights, noise):
    """One double-DQN update's ``(loss, grads, abs errors)``; ``noise`` ``(eval, (online, target))``."""
    inputs = [p.detach().clone().requires_grad_(True) for p in reinforce.leaves(params)]
    live = reinforce.rebuild(params, inputs)
    noise_eval, (n_online, n_target) = noise
    with torch.no_grad():
        best = torch.argmax(nets.dueling_q(params, batch["next_state"], n_online), dim=-1)
        boot = torch.gather(nets.dueling_q(target, batch["next_state"], n_target), 1, best[:, None])[:, 0]
        y = batch["reward"] + learner["gamma"] ** learner["n_steps"] * boot * (1 - batch["done"])
    q = torch.gather(nets.dueling_q(live, batch["state"], noise_eval), 1, batch["action"][:, None])[:, 0]
    err = q - y
    loss = torch.mean(weights * err ** 2)
    grads = torch.autograd.grad(loss, inputs)
    return float(loss.detach()), reinforce.rebuild(params, list(grads)), err.detach().abs()


def learn(learner: dict, state: dict, rows: dict, draws: dict):
    """A cycle's replay insert of ``rows`` and its updates on ``state``
    (``params``, ``target``, ``adam`` ``(m, v)``, ``count``, ``replay``);
    returns the mean of the updates' losses."""
    state["replay"].insert(rows)
    losses = []
    for i, (u, noise) in enumerate(zip(draws["per_uniforms"], draws["learn_noise"])):
        idx, w, batch = state["replay"].sample(u)
        loss, grads, err = update(learner, state["params"], state["target"], batch, w, noise)
        state["count"] += 1
        state["params"], state["adam"] = reinforce.adam(learner, state["params"], grads, state["adam"], state["count"])
        if i % learner["retrain_interval"] == 0:
            tau = learner["tau"]
            state["target"] = reinforce.rebuild(state["target"], [
                tau * p + (1.0 - tau) * t for t, p in zip(reinforce.leaves(state["target"]),
                                                          reinforce.leaves(state["params"]))])
        state["replay"].update(idx, err)
        losses.append(loss)
    return sum(losses) / len(losses)
