"""Closed-loop arena evaluation: one ``make_arena`` match after another, each of
G fresh games, seat 0 the configuration's net and the other seats the
traffic's ``opponents``; a match ends when its scores are read on the host.

Each match's randomness comes from the seed and the match's number: the deal's
seed and every seat's draws of every turn (a random seat's uniforms, a policy
seat's Gumbel noise, a noisy net's factorized noise), handed to the program as
an ``ArenaNoise``.  The check replays ``check_matches`` matches drawn from the
seed among the first ``check_pool`` of the window (those it played), with the
plain reference (``reference/arena.py``), on the same draws, and counts
``mismatched_games``: the games the reference decides (no pick of a net within
rounding of a tie) whose scores differ.  Only the drawn matches' scores are
kept past their read.
"""

from __future__ import annotations

import random

import torch

from ..common import derive
from ..flops import mlp_flops, policy_flops
from ..reference import arena, game, nets

LIMITS = {"mismatched_games": 0}
TINY = torch.finfo(torch.float32).tiny


class ArenaMatch:
    def __init__(self, config: dict, traffic: dict, seed: int, device, dtype=None):
        from rl6nimmt_torch.agents.dqn import DQNConfig
        from rl6nimmt_torch.engine import EnvConfig
        from rl6nimmt_torch.nets import MLPSpec
        from rl6nimmt_torch.runtime.arena import SeatPolicy, make_arena

        self.rules = r = game.rules_of(config["game"])
        self.net = net = config["net"]
        self.kinds = [config["seat"]] + list(traffic["opponents"])
        if len(self.kinds) != r.num_players:
            raise ValueError(f"{len(self.kinds)} seats for {r.num_players} players")
        self.seed, self.dev = int(seed), device
        self.G = int(traffic["games"])
        spec = MLPSpec(int(net["input_size"]), tuple(net["hidden_sizes"]), tuple(net["head_sizes"]),
                       noisy=bool(net.get("noisy", False)), sigma_init=float(net.get("sigma_init", 0.5)),
                       activation=net["activation"], compute_dtype=dtype or net["dtype"])
        dqn = None
        if config["seat"] == "dqn":
            q = config["learner"]
            dqn = DQNConfig(double=q["double"], dueling=q["dueling"], noisy=q["noisy"], per=q["per"],
                            n_steps=q["n_steps"], hidden_sizes=tuple(net["hidden_sizes"]), minibatch=q["minibatch"],
                            tau=q["tau"], noisy_init_sigma=float(net["sigma_init"]))
            if not (dqn.noisy and dqn.dueling):
                raise ValueError("the arena's dqn seat here is the noisy dueling net")
        policies = tuple(SeatPolicy(k, spec, dqn) if p == 0 else SeatPolicy(k) for p, k in enumerate(self.kinds))
        self.arena = make_arena(EnvConfig(num_players=r.num_players, num_rows=r.num_rows, num_cards=r.num_cards,
                                          threshold=r.threshold, hand_size=r.hand_size), policies, self.G, device)
        self.weights = nets.make_weights(net, derive(self.seed, "weights"), device)
        self.params = (self.weights,) + (None,) * (r.num_players - 1)
        self.eps = (0.0,) * r.num_players
        self.env_steps = self.G * r.hand_size
        seat_flops = {"policy": lambda: policy_flops(net, self.G, r.hand_size),
                      "dqn": lambda: mlp_flops(net, self.G * r.hand_size)}
        self.model_flops = seat_flops[config["seat"]]()
        self.warmup = int(traffic["warmup_matches"])
        self.check_matches = int(traffic["check_matches"])
        self.block = int(traffic["check_block"])
        self.first_step = self.warmup
        pool = range(self.first_step, self.first_step + int(traffic["check_pool"]))
        self.picks = set(random.Random(derive(self.seed, "check")).sample(pool, min(self.check_matches, len(pool))))
        self.scores = {}

    def draws(self, i: int):
        """Match ``i``'s deal seed and ``turns[t][p]``: each seat's draws of turn ``t``."""
        r, G, T, dev = self.rules, self.G, self.rules.hand_size, self.dev
        gen = torch.Generator(device=dev).manual_seed(derive(self.seed, "match", i))
        per_seat = []
        for kind in self.kinds:
            if kind == "random":
                u = torch.rand((T, G), generator=gen, device=dev)
                per_seat.append([{"u": u[t]} for t in range(T)])
            elif kind == "policy":
                u = torch.rand((T, G, r.hand_size), generator=gen, device=dev).clamp_(min=TINY)
                gumbel = -torch.log(-torch.log(u))
                per_seat.append([{"gumbel": gumbel[t]} for t in range(T)])
            elif kind == "dqn":
                sizes = nets.layer_sizes(self.net)
                z = torch.randn((T, sum(i + o for i, o in sizes)), generator=gen, device=dev)
                f = torch.sign(z) * torch.sqrt(torch.abs(z))
                turns = []
                for t in range(T):
                    layers, at = [], 0
                    for a, b in sizes:
                        layers.append({"eps_in": f[t, at:at + a].view(a, 1), "eps_out": f[t, at + a:at + a + b].view(1, b)})
                        at += a + b
                    turns.append({"q": layers})
                per_seat.append(turns)
            else:
                raise ValueError(f"unknown seat kind {kind!r}")
        return derive(self.seed, "deal", i), [[per_seat[p][t] for p in range(len(self.kinds))] for t in range(T)]

    def step(self, i: int):
        from rl6nimmt_torch.runtime.arena import ArenaNoise, SeatDraws

        deal_seed, turns = self.draws(i)
        noise = ArenaNoise(deal_seed, [[SeatDraws(**d) for d in turn] for turn in turns])
        return i, self.arena(self.params, self.eps, noise)

    def read(self, handle) -> None:
        i, scores = handle
        scores = scores.cpu().numpy()
        if i in self.picks:
            self.scores[i] = scores

    def warm_up(self) -> None:
        for i in range(self.warmup):
            self.read(self.step(i))

    def release(self) -> None:
        del self.arena, self.params

    def check(self):
        """``({name: (value, limit)}, failed)``: sampled matches against the reference."""
        picks = sorted(self.scores)
        mismatched, undecided, failed = 0, 0, 0
        params = self.params_ref()
        for i in picks:
            deal_seed, turns = self.draws(i)
            bad = 0
            for a in range(0, self.G, self.block):
                games = torch.arange(a, min(a + self.block, self.G), device=self.dev)
                ref, decided = arena.play_match(self.rules, self.kinds, params, deal_seed, turns, games)
                prog = torch.from_numpy(self.scores[i][a:a + self.block]).to(self.dev).long()
                differ = (prog != -ref).any(dim=1)
                bad += int((differ & decided).sum())
                undecided += int((~decided).sum())
            mismatched += bad
            failed += bad > 0
        share = undecided / max(len(picks) * self.G, 1)
        self.notes = {"matches_checked": len(picks), "undecided_share": share}
        failed += not picks          # nothing was checked: the run cannot vouch for its answers
        return {"mismatched_games": (mismatched, LIMITS["mismatched_games"])}, failed

    def params_ref(self):
        """Seat 0's weights drawn again from the seed, so that nothing the program holds reaches the reference."""
        return [nets.make_weights(self.net, derive(self.seed, "weights"), self.dev)] + [None] * (self.rules.num_players - 1)


def build(config, traffic, seed, device, dtype=None):
    return ArenaMatch(config, traffic, seed, device, dtype)
