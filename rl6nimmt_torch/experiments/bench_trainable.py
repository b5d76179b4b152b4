"""Trainable throughput: env-steps/s of the real training cycles.

    python -m rl6nimmt_torch.experiments.bench_trainable [--games 4096] [--learners reinforce,dqn,acer]
        [--chain 1] [--dtype float32|bfloat16] [--reinforce-fused] [--acer-packed] [--acer-on-policy N]
        [--device cuda]

Port of ``experiments/bench_trainable.py`` with its flags and defaults: P=4,
G games a cycle, one env step one simultaneous turn of one game, so a cycle
counts ``G * 10`` env steps whatever its updates.  The learners:

* ``reinforce``: the action-in-input net 48 -> 100 -> 100 -> (1), Adam 1e-3,
  ``make_reinforce_train_step`` with ``fused_grad=False`` unless
  ``--reinforce-fused`` (``trainable_bench.ReinforceArm``);
* ``dqn``: the flagship Noisy-D3QN-PER-10step cycle (hidden 64, minibatch 64,
  PER 200,000 of float32 transitions, 8 updates, Adam 1e-3, eps 0.1) on the
  engine path (:class:`DqnArm`);
* ``acer``: the (1, 1)-headed net, a 65,536-sequence buffer, minibatch 512,
  the on-policy update on every fresh sequence unless ``--acer-on-policy N``
  (``trainable_bench.AcerArm``).

``--dtype`` is the spec's ``compute_dtype``; as in JAX the DQN cycle builds
its own float32 spec, so there it reaches only the spec its params are drawn
for.  A JAX chain was ``--chain`` cycles in one ``lax.scan`` dispatch; here
it is ``--chain`` eager cycles, then a read of the metrics on the host
(``PARITY_TORCH.md`` section 20).  Host clock, the median of 8 chains after 2
untimed ones.  Prints JAX's JSON line a learner, then one line with the
card's name and power limit; returns ``{learner: line}``.
``trainable_bench.py`` stays beside it with its own defaults.
"""

from __future__ import annotations

import argparse
import json

import torch

from .trainable_bench import AcerArm, ReinforceArm


class DqnArm:
    """The flagship cycle at ``bench_trainable.py:86-132``; ``step()`` runs one cycle."""

    def __init__(self, cfg, games: int, device, dtype: str = "float32", seed: int = 1):
        from ..utils.device import resolve_device
        from .chain_timing import flagship_cycle

        dev = resolve_device(device)
        self.cycle, _, self.spec, self.state = flagship_cycle(cfg, games, dev, 8, seed=seed, compute_dtype=dtype)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(self) -> dict:
        *self.state, metrics = self.cycle(*self.state, self.generator, 0.1)
        return metrics


def time_cycles(arm, chain: int, iters: int = 8, warmup: int = 2) -> float:
    """Median seconds of ``chain`` cycles, each chain ended by a read of its
    last cycle's first metric on the host."""
    from .chain_timing import timed

    def chained():
        for _ in range(chain):
            metrics = arm.step()
        return next(iter(metrics.values()))

    return timed(chained, arm.generator.device, iters, warmup)


def make_parser() -> argparse.ArgumentParser:
    """JAX's flags and defaults, and ``--device``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=4096)
    parser.add_argument("--learners", default="reinforce,dqn,acer")
    parser.add_argument("--chain", type=int, default=1, help="cycles a timed chain")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="the products' input dtype (float32 params and results)")
    parser.add_argument("--reinforce-fused", action="store_true",
                        help="differentiate through the rollout's own forward (fused_grad=True)")
    parser.add_argument("--acer-packed", action="store_true", help="packed-row ACER train step")
    parser.add_argument("--acer-on-policy", type=int, default=None,
                        help="subsample the ACER on-policy phase to this many fresh sequences (default: all G*P)")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device
    from .kernel_times import smi_line

    args = make_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=4)
    G = args.games
    steps_per_call = G * cfg.max_turns * args.chain
    arms = {"reinforce": lambda: ReinforceArm(cfg, G, dev, fused=args.reinforce_fused, dtype=args.dtype),
            "dqn": lambda: DqnArm(cfg, G, dev, dtype=args.dtype),
            "acer": lambda: AcerArm(cfg, G, dev, packed=args.acer_packed, dtype=args.dtype,
                                    on_policy=args.acer_on_policy)}
    out = {}
    for name in args.learners.split(","):
        if name not in arms:
            raise ValueError(f"unknown learner {name!r}: reinforce, dqn or acer")
        sec = time_cycles(arms[name](), args.chain)
        out[name] = line = {
            "metric": f"trainable env-steps/s @ {G} games ({name} selfplay+update cycle"
                      + (f", {args.chain} chained" if args.chain > 1 else "")
                      + (", bf16" if args.dtype == "bfloat16" else "")
                      + (f", on-policy {args.acer_on_policy}" if name == "acer" and args.acer_on_policy else "")
                      + (", fused-grad" if name == "reinforce" and args.reinforce_fused else "")
                      + (", packed" if name == "acer" and args.acer_packed else "")
                      + ")",
            "value": round(steps_per_call / sec, 1),
            "unit": "steps/s",
            "seconds_per_cycle": round(sec / args.chain, 4),
        }
        print(json.dumps(line), flush=True)
    print(json.dumps({"device": str(dev), "card": smi_line() if dev.type == "cuda" else "cpu"}), flush=True)
    return out


if __name__ == "__main__":
    main()
