"""Closed-loop Noisy-D3QN self-play training: one ``make_dqn_selfplay_step``
cycle after another (a rollout of G games, the n-step harvest, the prioritized
replay insert, ``updates`` double/dueling Bellman updates with Adam); a cycle
ends when its loss is read on the host.

The traffic's ``mode`` picks the rollout: ``engine`` (K2, torch observe, the
noisy forward, K1; row-major replay) or ``kernel_fm`` (K4's feature-major emit
into a feature-major replay).  Set-up builds the one cycle object with its
weights (drawn from the seed on the device), target, Adam state and replay of
``capacity`` compact rows, and drives it through ``setup_steps`` cycles by the
window's own call.  Each cycle's randomness (deal seed, per-turn acting noise,
each update's three noise draws, the replay's sampling uniforms) comes from
the seed and the cycle's number.  The check follows the first cycle in two
stages with ``reference/dqn_cycle.py``:

* the start, ``mismatched_rows``: the reference's rollout and n-step harvest
  against the rows the program inserted, over the games the reference decides
  (no pick within round-off of a tie; exact);
* the learn phase, from the program's own inserted rows: the replay insert,
  the sampling on the same uniforms, the double/dueling updates and Adam, which
  give ``loss_gap`` (the cycle's relative loss gap), ``moment_gap`` (per leaf,
  the norms of Adam's first moment after the cycle) and ``change_gap`` (the
  norms of the parameters' change over it), each leaf's over the larger of its
  reference norm and the median leaf's.

The learn phase starts from the program's rows because a pick within round-off
of a tie (a few of a cycle's 163,840 at 4,096 games, by estimate) changes
the rest of its game's rows, and a sampled row among them moves a loss by up
to a thousandth.
"""

from __future__ import annotations

import math

import torch

from ..common import derive
from ..flops import mlp_flops
from ..reference import dqn_cycle, game, nets, reinforce
from .reinforce_train import leaf_gaps, leaves_moved

# Above the program's readings on six seeds at the flagship's sizes (PERF.md);
# the control and the faults are for the change that adds a cell on this entry.
LIMITS = {"mismatched_rows": 0, "loss_gap": 1e-3, "moment_gap": 2e-3, "change_gap": 1e-4}


class DqnCycle:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        import dataclasses

        from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec
        from rl6nimmt_torch.buffers import per_init, per_init_fm
        from rl6nimmt_torch.engine import EnvConfig
        from rl6nimmt_torch.runtime.vector import dqn_replay_example, make_dqn_selfplay_step

        self.rules = r = game.rules_of(config["game"])
        self.net, self.learner = net, L = config["net"], config["learner"]
        self.seed, self.dev = int(seed), device
        self.G, self.updates = int(traffic["games"]), int(traffic["updates"])
        self.mode = traffic["mode"]
        if self.mode not in ("engine", "kernel_fm"):
            raise ValueError(f"mode {self.mode!r}: engine or kernel_fm")
        fm = self.mode == "kernel_fm"
        cfg = EnvConfig(num_players=r.num_players, num_rows=r.num_rows, num_cards=r.num_cards,
                        threshold=r.threshold, hand_size=r.hand_size)
        self.dqn = DQNConfig(double=L["double"], dueling=L["dueling"], noisy=L["noisy"], per=L["per"],
                             n_steps=L["n_steps"], hidden_sizes=tuple(net["hidden_sizes"]), minibatch=L["minibatch"],
                             tau=L["tau"], retrain_interval=L["retrain_interval"],
                             noisy_init_sigma=float(net["sigma_init"]))
        if not (self.dqn.noisy and self.dqn.per and self.dqn.double and self.dqn.dueling):
            raise ValueError("this entry drives the noisy double dueling PER cycle")
        self.spec = dataclasses.replace(q_network_spec(self.dqn, r.obs_size, r.num_cards),
                                        compute_dtype=dtype or net["dtype"])
        self.adam = Adam(L["lr"], L["b1"], L["b2"], L["eps"])
        self.cycle = make_dqn_selfplay_step(cfg, self.dqn, self.adam, self.G, gamma=L["gamma"],
                                            learn_iters=self.updates, kernel_act_rollout=fm, feature_major=fm,
                                            device=device)
        self.capacity = int(traffic["capacity"])
        self.buf = (per_init_fm if fm else per_init)(self.capacity, dqn_replay_example(cfg, compact=True), device)
        self.params = nets.make_weights(net, derive(self.seed, "weights"), device)
        self.target = {part: [{k: v.clone() for k, v in layer.items()} for layer in self.params[part]]
                       for part in ("trunk", "heads")}
        self.opt_state = self.adam.init(self.params)
        self.setup_steps = int(traffic["setup_steps"])
        self.first_step = self.setup_steps
        T = r.hand_size
        self.env_steps = self.G * T
        # Acting: one forward a seat and turn; each update: three forwards on the
        # next states and the states, and the backward (2x) of the one that learns.
        self.model_flops = (mlp_flops(net, self.G * r.num_players * T)
                            + self.updates * 5 * mlp_flops(net, self.dqn.minibatch))
        self.losses, self.bad = [], 0

    def randomness(self, i: int):
        """Cycle ``i``'s draws, as the program takes them and as the reference does."""
        from rl6nimmt_torch.runtime.vector import CycleRandomness

        T, sizes = self.rules.hand_size, nets.layer_sizes(self.net)
        gen = torch.Generator(device=self.dev).manual_seed(derive(self.seed, "cycle", i))
        width = sum(a + b for a, b in sizes)
        z = torch.randn((T + 3 * self.updates, width), generator=gen, device=self.dev)
        f = torch.sign(z) * torch.sqrt(torch.abs(z))

        def layers(row):
            out, at = [], 0
            for a, b in sizes:
                out.append({"eps_in": row[..., at:at + a].unsqueeze(-1), "eps_out": row[..., at + a:at + a + b].unsqueeze(-2)})
                at += a + b
            return out

        turn = layers(f[:T])                                   # eps_in [T, in, 1], eps_out [T, 1, out]
        learn = [(layers(f[T + 3 * k]), (layers(f[T + 3 * k + 1]), layers(f[T + 3 * k + 2])))
                 for k in range(self.updates)]
        u = torch.rand((self.updates, self.dqn.minibatch), generator=gen, device=self.dev)
        rnd = CycleRandomness(per_uniforms=u, deal_seed=derive(self.seed, "deal", i), turn_noise=turn,
                              learn_noise=learn)
        per_turn = [[{k: v[t] for k, v in layer.items()} for layer in turn] for t in range(T)]
        return rnd, {"deal_seed": rnd.deal_seed, "turn_noise": per_turn, "learn_noise": learn, "per_uniforms": u}

    def step(self, i: int):
        rnd, _ = self.randomness(i)
        self.params, self.target, self.opt_state, self.buf, metrics = self.cycle(
            self.params, self.target, self.opt_state, self.buf, rnd, 0.0)
        return metrics["loss"]

    def read(self, loss) -> None:
        value = float(loss)
        self.bad += not math.isfinite(value)
        if len(self.losses) < self.setup_steps:
            self.losses.append(value)

    def warm_up(self) -> None:
        self.start = [x.detach().cpu() for x in reinforce.leaves(self.params)]
        n = self.G * self.rules.num_players * self.rules.hand_size
        for i in range(self.setup_steps):
            self.read(self.step(i))
            if i == 0:
                self.first_moment = [x.detach().cpu() for x in reinforce.leaves(self.opt_state.mu)]
                self.after = [x.detach().cpu() for x in reinforce.leaves(self.params)]
                fm = self.mode == "kernel_fm"
                # A copy: later cycles overwrite the replay in place.
                self.rows = {k: (v[..., :n].T if fm and v.dim() > 1 else v[..., :n] if fm else v[:n]).cpu().clone()
                             for k, v in self.buf.storage.items()}

    def release(self) -> None:
        del self.params, self.target, self.opt_state, self.buf, self.cycle

    def check(self):
        """``({name: (value, limit)}, failed)``: the first cycle against the reference."""
        L = self.learner
        params = nets.make_weights(self.net, derive(self.seed, "weights"), self.dev)
        _, draws = self.randomness(0)
        ref_rows, clear = dqn_cycle.harvest(self.rules, params, draws["turn_noise"], draws["deal_seed"], self.G,
                                            L["gamma"], L["n_steps"], seat_major=self.mode == "kernel_fm")
        rows = {k: v.to(self.dev).to(ref_rows[k].dtype) for k, v in self.rows.items()}
        differ = torch.zeros_like(clear)
        for k, v in rows.items():
            differ |= (v != ref_rows[k]).reshape(v.shape[0], -1).any(dim=1)
        state = {"params": params, "target": params, "adam": None, "count": 0,
                 "replay": dqn_cycle.Replay(self.capacity, self.rules.obs_size, self.dev)}
        loss = dqn_cycle.learn(L, state, rows, draws)
        names = reinforce.leaf_names(params)
        moment = [m.detach().cpu() for m in reinforce.leaves(state["adam"][0])]
        moved = leaves_moved(moment)
        change_ref = [p.detach().cpu() - s for p, s in zip(reinforce.leaves(state["params"]), self.start)]
        change_prog = [a - s for a, s in zip(self.after, self.start)]
        moment_gaps = leaf_gaps(self.first_moment, moment)
        change_gaps = leaf_gaps([c for c, m in zip(change_prog, moved) if m], [c for c, m in zip(change_ref, moved) if m])
        self.notes = {"loss": self.losses[0], "reference_loss": loss, "undecided_rows": int((~clear).sum()),
                      "moment_gaps": dict(zip(names, moment_gaps)),
                      "change_gaps": dict(zip([n for n, m in zip(names, moved) if m], change_gaps))}
        checks = {"mismatched_rows": int((differ & clear).sum()), "loss_gap": abs(self.losses[0] - loss) / abs(loss),
                  "moment_gap": max(moment_gaps), "change_gap": max(change_gaps)}
        return {k: (v, LIMITS[k]) for k, v in checks.items()}, self.bad


def build(config, traffic, seed, device, dtype=None):
    return DqnCycle(config, traffic, seed, device, dtype)
