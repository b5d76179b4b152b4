"""Closed-loop REINFORCE training: one ``make_reinforce_train_step`` step after
another, each on G fresh games, every seat learning; a step ends when its loss
is read on the host.

Set-up builds the one step object with its weights (drawn from the seed on the
device) and Adam's state, and drives it through ``setup_steps`` steps by the
window's own call; the window goes on from there.  The check replays those
steps with the plain reference (``reference/reinforce.py``) from the same
weights, deals and Gumbel draws, and compares:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the gap between the norms of the program's
  first gradient (Adam's first moment after one step over ``1 - b1``) and the
  reference's, over the larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the same for the change of the parameters over the set-up
  steps, as the first window step takes them, over the leaves the reference's
  first gradient moves (a leaf whose gradient is under a thousandth of the
  median leaf's moves by round-off alone under Adam: the policy head's bias,
  which the softmax does not see).
"""

from __future__ import annotations

import math

import torch

from ..common import derive
from ..flops import policy_flops
from ..reference import game, nets, reinforce

# Limits of the compared numbers (PERF.md gives the readings they come from).
LIMITS = {"loss_gap": 1.5e-4, "grad_gap": 6e-4, "change_gap": 0.1}
TINY = torch.finfo(torch.float32).tiny


class ReinforceTrain:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from rl6nimmt_torch.agents.dqn import Adam
        from rl6nimmt_torch.engine import EnvConfig
        from rl6nimmt_torch.nets import MLPSpec
        from rl6nimmt_torch.runtime.vector import make_reinforce_train_step

        self.rules = game.rules_of(config["game"])
        self.net, self.learner = config["net"], config["learner"]
        self.seed, self.dev = int(seed), device
        self.G = int(traffic["games"])
        self.setup_steps = int(traffic["setup_steps"])
        self.block = int(traffic["check_block"])
        r, L = self.rules, self.learner
        cfg = EnvConfig(num_players=r.num_players, num_rows=r.num_rows, num_cards=r.num_cards,
                        threshold=r.threshold, hand_size=r.hand_size)
        spec = MLPSpec(int(self.net["input_size"]), tuple(self.net["hidden_sizes"]), tuple(self.net["head_sizes"]),
                       activation=self.net["activation"], compute_dtype=dtype or self.net["dtype"])
        self.adam = Adam(L["lr"], L["b1"], L["b2"], L["eps"])
        self.train = make_reinforce_train_step(
            cfg, spec, self.adam, self.G, gamma=L["gamma"], r_factor=L["r_factor"], actor_weight=L["actor_weight"],
            entropy_weight=L["entropy_weight"], reward_lag=L["reward_lag"], fused_grad=L["fused_grad"], device=device)
        self.params = nets.make_weights(self.net, derive(self.seed, "weights"), device)
        self.opt_state = self.adam.init(self.params)
        self.env_steps = self.G * r.hand_size
        self.model_flops = 3 * policy_flops(self.net, self.G * r.num_players, r.hand_size)
        self.first_step = self.setup_steps
        self.losses, self.bad = [], 0

    def randomness(self, i: int):
        """Step ``i``'s deal seed and Gumbel draws ``f32[T, G, P, H]``."""
        from rl6nimmt_torch.runtime.vector import RolloutRandomness

        r = self.rules
        gen = torch.Generator(device=self.dev).manual_seed(derive(self.seed, "gumbel", i))
        u = torch.rand((r.hand_size, self.G, r.num_players, r.hand_size), generator=gen, device=self.dev)
        gumbel = -torch.log(-torch.log(u.clamp_(min=TINY)))
        return RolloutRandomness(gumbel=gumbel, deal_seed=derive(self.seed, "deal", i))

    def step(self, i: int):
        self.params, self.opt_state, metrics = self.train(self.params, self.opt_state, self.randomness(i))
        return metrics["loss"]

    def read(self, loss) -> None:
        value = float(loss)
        self.bad += not math.isfinite(value)
        if len(self.losses) < self.setup_steps:
            self.losses.append(value)

    def warm_up(self) -> None:
        self.start = [x.detach().cpu() for x in reinforce.leaves(self.params)]
        for i in range(self.setup_steps):
            self.read(self.step(i))
            if i == 0:
                self.first_moment = [x.detach().cpu() for x in reinforce.leaves(self.opt_state.mu)]
        self.after = [x.detach().cpu() for x in reinforce.leaves(self.params)]

    def release(self) -> None:
        del self.params, self.opt_state, self.train

    def check(self):
        """``({name: (value, limit)}, failed)``: the set-up steps against the reference."""
        L = self.learner
        params = nets.make_weights(self.net, derive(self.seed, "weights"), self.dev)
        state, losses, first, undecided = None, [], None, []
        for k in range(self.setup_steps):
            rnd = self.randomness(k)
            loss, grads, open_games = reinforce.loss_and_grads(self.rules, L, params, rnd.deal_seed, rnd.gumbel,
                                                               self.block)
            del rnd
            losses.append(loss)
            undecided.append(open_games)
            first = first or [g.detach().cpu() for g in reinforce.leaves(grads)]
            params, state = reinforce.adam(L, params, grads, state, k + 1)
        change_ref = [(p.detach().cpu() - s) for p, s in zip(reinforce.leaves(params), self.start)]
        change_prog = [(a - s) for a, s in zip(self.after, self.start)]
        grad_prog = [m / (1 - L["b1"]) for m in self.first_moment]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        names = reinforce.leaf_names(params)
        moving = leaves_moved(first)
        grad_gaps = leaf_gaps(grad_prog, first)
        change_gaps = leaf_gaps([c for c, m in zip(change_prog, moving) if m],
                                [c for c, m in zip(change_ref, moving) if m])
        kept = [n for n, m in zip(names, moving) if m]
        self.notes = {"losses": self.losses, "reference_losses": losses, "undecided_games": undecided,
                      "grad_gaps": dict(zip(names, grad_gaps)), "change_gaps": dict(zip(kept, change_gaps)),
                      "left_out_of_change": [n for n, m in zip(names, moving) if not m]}
        checks = {"loss_gap": loss_gap, "grad_gap": max(grad_gaps), "change_gap": max(change_gaps)}
        return {k: (v, LIMITS[k]) for k, v in checks.items()}, self.bad


def leaves_moved(grads) -> list:
    """Leaves whose first gradient is at least a thousandth of the median leaf's."""
    norms = [float(g.norm()) for g in grads]
    med = sorted(norms)[len(norms) // 2]
    return [n >= 1e-3 * med for n in norms]


def leaf_gaps(program, reference) -> list:
    """Each leaf's gap of norms, over the larger of its reference norm and the median leaf's."""
    ref = [float(r.norm()) for r in reference]
    med = sorted(ref)[len(ref) // 2]
    return [abs(float(p.norm()) - r) / max(r, med) for p, r in zip(program, ref)]


def build(config, traffic, seed, device, dtype=None):
    return ReinforceTrain(config, traffic, seed, device, dtype)
