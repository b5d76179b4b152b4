"""Long self-play training with periodic arena strength evals.

    python -m rl6nimmt_torch.experiments.long_train_eval --algo reinforce --updates 20000
    python -m rl6nimmt_torch.experiments.long_train_eval --algo dqn --cycles 2000

Port of ``experiments/long_train_eval.py``: trains the REINFORCE learner
(``make_reinforce_train_step``, ``--games`` games an update) or the
Noisy-D3QN-PER-3step learner (``make_dqn_selfplay_step``, ``--games // 4``
games and 8 updates a cycle, PER 2^18, epsilon ``max(exp(-0.0025 i),
0.05)``) on the card and measures its strength along the way: the win rate
of the learner in seat 0 against three ``DrunkHamster`` seats over
``--eval-games`` arena games (``runtime/arena.py`` ``play_match``; a tied win
counts fractionally, as in the tournament).  REINFORCE evaluates at 8
log-spaced marks (or every ``--eval-every`` updates), DQN ten times over the
run.  Writes the params (npz, ``utils.save_params``) and the history (JSON)
under ``--out``.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def win_rate_from(scores: np.ndarray) -> float:
    """Seat 0's win rate over ``scores [G, P]``, ties shared as midranks."""
    winners = scores == scores.max(axis=1, keepdims=True)
    return float((winners[:, 0] / winners.sum(axis=1)).mean())


def eval_win_rate(agent, params, seed: int, num_games: int, dev) -> float:
    """``agent`` with ``params`` in seat 0 against three DrunkHamsters."""
    from ..agents import DrunkHamster
    from ..runtime.arena import play_match

    agent.set_parameters(params)
    opponents = [DrunkHamster(seed=seed + i + 1, device=dev) for i in range(3)]
    return win_rate_from(play_match([agent] + opponents, num_games=num_games, seed=seed, device=dev))


def reinforce_marks(updates: int, eval_every: int):
    """``(chunk, marks)``: the update counts at which to evaluate, as the JAX
    script's device chunks place them (8 log-spaced marks by default)."""
    chunk = max(min(eval_every or updates // 64, 10_000), 1)
    total = (updates // chunk) * chunk
    if eval_every:
        step = max(eval_every // chunk, 1) * chunk
        return chunk, list(range(step, total + 1, step))
    return chunk, sorted({((int(total ** (i / 7)) + chunk - 1) // chunk) * chunk for i in range(8)} | {total})


def main(argv=None):
    from ..agents import BatchedReinforceAgent, Noisy_D3QN_PRB_NStep
    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..runtime.vector import make_dqn_selfplay_step, make_reinforce_train_step
    from ..utils import save_params
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=["reinforce", "dqn"], default="reinforce")
    parser.add_argument("--games", type=int, default=2048)
    parser.add_argument("--updates", type=int, default=20000, help="reinforce updates")
    parser.add_argument("--cycles", type=int, default=2000, help="dqn cycles")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="eval cadence in updates, rounded down to a multiple of the 10k chunk cap; "
                             "0 = 8 log-spaced points")
    parser.add_argument("--eval-games", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--entropy", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="rl6nimmt_torch/experiments/results/longtrain")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = EnvConfig(num_players=4)
    optimizer = Adam(args.lr)
    history = []
    start = time.perf_counter()
    init = torch.Generator(device=dev).manual_seed(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    if args.algo == "reinforce":
        spec = MLPSpec(input_size=cfg.state_length + 1, head_sizes=(1,))
        params = mlp_init(init, spec, dev)
        opt_state = optimizer.init(params)
        step = make_reinforce_train_step(cfg, spec, optimizer, args.games, entropy_weight=args.entropy, device=dev)
        agent = BatchedReinforceAgent(seed=args.seed, device=dev)
        _, marks = reinforce_marks(args.updates, args.eval_every)
        wr0 = eval_win_rate(agent, params, args.seed, args.eval_games, dev)
        history.append({"updates": 0, "win_rate": wr0, "loss": None})
        print(f"updates {0:>6}  win_rate {wr0:.3f}", flush=True)
        done, loss = 0, None
        for mark in marks:
            while done < mark:
                params, opt_state, metrics = step(params, opt_state, gen)
                loss = metrics["loss"]
                done += 1
            wr = eval_win_rate(agent, params, args.seed, args.eval_games, dev)
            history.append({"updates": done, "win_rate": wr, "loss": float(loss)})
            print(f"updates {done:>6}  win_rate {wr:.3f}  loss {float(loss):>9.3f}  "
                  f"({time.perf_counter() - start:5.1f}s, {done * args.games * 4:,} episodes)", flush=True)
        save_params(str(out / "reinforce_params.npz"), params)
    else:
        dqn_cfg = DQNConfig(double=True, dueling=True, noisy=True, per=True, n_steps=3, minibatch=1024)
        spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
        params = mlp_init(init, spec, dev)
        target = tree_map(torch.clone, params)
        opt_state = optimizer.init(params)
        example = {"state": torch.zeros(cfg.state_length), "action": torch.zeros((), dtype=torch.int32),
                   "reward": torch.zeros(()), "next_state": torch.zeros(cfg.state_length), "done": torch.zeros(())}
        buf = per_init(1 << 18, example, device=dev)
        cycle = make_dqn_selfplay_step(cfg, dqn_cfg, optimizer, max(args.games // 4, 1), learn_iters=8, device=dev)
        agent = Noisy_D3QN_PRB_NStep(n_steps=3, seed=args.seed, device=dev)
        evals = max(args.cycles // 10, 1)
        wr0 = eval_win_rate(agent, params, args.seed, args.eval_games, dev)
        history.append({"cycles": 0, "win_rate": wr0, "loss": None})
        print(f"cycle {0:>5}  win_rate {wr0:.3f}", flush=True)
        for i in range(args.cycles):
            eps = max(np.exp(-0.0025 * i), 0.05)
            params, target, opt_state, buf, metrics = cycle(params, target, opt_state, buf, gen, eps)
            if i % evals == 0 or i == args.cycles - 1:
                loss = float(metrics["loss"])
                wr = eval_win_rate(agent, params, args.seed, args.eval_games, dev)
                history.append({"cycles": i + 1, "win_rate": wr, "loss": loss})
                print(f"cycle {i:>5}  win_rate {wr:.3f}  loss {loss:.4f}  eps {eps:.3f}", flush=True)
        save_params(str(out / "dqn_params.npz"), params)

    (out / f"{args.algo}_history.json").write_text(json.dumps(history, indent=1))
    print("wrote", out / f"{args.algo}_history.json", flush=True)
    return history


if __name__ == "__main__":
    main()
