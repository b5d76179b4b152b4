"""Trainable throughput of the REINFORCE and ACER self-play learners on the card.

    python -m rl6nimmt_torch.experiments.trainable_bench [--games 4096] [--learners reinforce,acer]
        [--cycles 8] [--acer-packed] [--reinforce-recompute] [--device cuda]

Port of the ``reinforce`` and ``acer`` arms of ``experiments/bench_trainable.py``
at their configurations: P=4, the action-in-input net 48 -> 100 -> 100 ->
(1) for REINFORCE (Adam 1e-3, the fused-gradient step) and (1, 1) for ACER
(Adam 1e-3, a 65,536-sequence buffer, minibatch 512, 512 on-policy sequences).  One env step is one
simultaneous turn of one game, so a step or cycle counts ``G * 10`` env steps
whatever its updates.  Host clock around each step, which ends in
``torch.cuda.synchronize()``; the median of ``--cycles`` after two warm-up
steps.  Prints one JSON line per learner with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..agents.dqn import Adam
from ..buffers.sequence import seq_init
from ..engine import EnvConfig
from ..nets import MLPSpec, mlp_init
from ..runtime import vector
from ..utils.device import resolve_device
from .kernel_times import smi_line

HIDDEN = (100, 100)
ACER_CAPACITY = 65_536
ACER_MINIBATCH = 512
ACER_ON_POLICY = 512


class ReinforceArm:
    """The REINFORCE learner at ``bench_trainable.py:57-65``; ``step()`` runs one train step."""

    def __init__(self, cfg: EnvConfig, games: int, device, fused: bool = True, seed: int = 0):
        dev = resolve_device(device)
        self.spec = MLPSpec(cfg.state_length + 1, hidden_sizes=HIDDEN, head_sizes=(1,))
        self.params = mlp_init(torch.Generator(device=dev).manual_seed(seed), self.spec, dev)
        self.adam = Adam(1e-3)
        self.opt_state = self.adam.init(self.params)
        self.train = vector.make_reinforce_train_step(cfg, self.spec, self.adam, games, fused_grad=fused, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(self) -> dict:
        self.params, self.opt_state, metrics = self.train(self.params, self.opt_state, self.generator)
        return metrics


class AcerArm:
    """The ACER learner at ``bench_trainable.py:135-156``; ``step()`` runs one cycle."""

    def __init__(self, cfg: EnvConfig, games: int, device, packed: bool = False, seed: int = 2):
        dev = resolve_device(device)
        self.spec = MLPSpec(cfg.state_length + 1, hidden_sizes=HIDDEN, head_sizes=(1, 1))
        self.params = mlp_init(torch.Generator(device=dev).manual_seed(seed), self.spec, dev)
        self.adam = Adam(1e-3)
        self.opt_state = self.adam.init(self.params)
        self.buf = seq_init(ACER_CAPACITY, cfg.max_turns, vector.acer_sequence_example(cfg), device=dev)
        self.cycle = vector.make_acer_selfplay_step(cfg, self.spec, self.adam, games, minibatch=ACER_MINIBATCH,
                                                    on_policy_sequences=ACER_ON_POLICY, packed_rows=packed, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(self) -> dict:
        self.params, self.opt_state, self.buf, metrics = self.cycle(self.params, self.opt_state, self.buf,
                                                                    self.generator)
        return metrics


def seconds_per_step(arm, cycles: int, warmup: int = 2) -> float:
    """Median host seconds of one ``arm.step()``, each ending in a synchronize."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    for _ in range(warmup):
        arm.step()
    sync()
    times = []
    for _ in range(cycles):
        t0 = time.perf_counter()
        arm.step()
        sync()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=4096)
    parser.add_argument("--learners", default="reinforce,acer")
    parser.add_argument("--cycles", type=int, default=8)
    parser.add_argument("--acer-packed", action="store_true", help="the packed-row ACER train step")
    parser.add_argument("--reinforce-recompute", action="store_true",
                        help="fused_grad=False: recompute the logits inside the loss")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    card = smi_line() if dev.type == "cuda" else None
    for name in args.learners.split(","):
        if name == "reinforce":
            arm = ReinforceArm(cfg, args.games, dev, fused=not args.reinforce_recompute)
            label = "reinforce" + (", recompute" if args.reinforce_recompute else ", fused-grad")
        elif name == "acer":
            arm = AcerArm(cfg, args.games, dev, packed=args.acer_packed)
            label = f"acer, on-policy {ACER_ON_POLICY}" + (", packed" if args.acer_packed else "")
        else:
            raise ValueError(f"unknown learner {name!r}: reinforce or acer")
        sec = seconds_per_step(arm, args.cycles)
        print(json.dumps({"metric": f"trainable env-steps/s @ {args.games} games ({label})",
                          "value": args.games * cfg.max_turns / sec, "unit": "steps/s", "seconds_per_cycle": sec,
                          "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
