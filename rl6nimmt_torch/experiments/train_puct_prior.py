"""Train Alpha0.5's prior net by self-imitation over device self-play games.

    python -m rl6nimmt_torch.experiments.train_puct_prior [--iters 100] [--games 64] [--mc-max 128]
        [--objective imitation|advantage] [--eval-games 256] [--eval-mc-max 200] [--out PATH] [--device cuda]

Port of ``experiments/train_puct_prior.py``.  The reference's PUCTAgent
improves its prior by imitating its own search choices, one game at a time
(mcts.py:191-261).  Here each iteration plays ``--games`` whole games with
every seat a PUCT search (``runtime/device_tournament.py``
``make_device_block_fn``: K2 deals, K1 resolves every game and playout turn)
and takes one Adam step on the self-imitation loss over every (observation,
legal hand, chosen index) record of every seat's episode:
``-sum(w * log pi(chosen)) / G``, ``w = 1`` (``imitation``, the reference's
rule, mcts.py:245-256) or each seat's score advantage over its game's mean,
normalised (``advantage``).  Summing over the batch's episodes before one
step is a batched-update deviation from the reference's per-episode updates,
as in the JAX script.  Then the trained prior plays a fresh one, both at
``--eval-mc-max``, in two-seat device matches with the seats alternated
(``make_device_match_fn(("puct", "puct"))``), and the win rate is printed.
``--out`` saves the params as npz (``utils.save_params``, the JAX package's
key names), which load into a ``PUCTAgent``.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch


def prior_spec(cfg):
    from ..nets import MLPSpec

    return MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))


def imitation_loss(spec, params, obs, hands, picks, weights, num_games: int):
    """``-sum(weights * log pi(picks)) / num_games`` over records ``obs [N, S]``,
    ``hands int[N, H]`` (padded with -1), ``picks int[N]``, ``weights [N]``."""
    from ..agents.reinforce import action_in_input_logits

    logp = torch.log_softmax(action_in_input_logits(spec, params, obs, hands), dim=-1)
    chosen = torch.gather(logp, 1, picks.long()[:, None])[:, 0]
    return -torch.sum(weights * chosen) / num_games


def record_weights(objective: str, scores, n_turns: int):
    """Each record's weight ``[T*G*P]``: ones, or its seat's normalised score advantage."""
    if objective == "advantage":
        adv = scores - scores.mean(dim=1, keepdim=True)                  # [G, P]
        adv = adv / (adv.std(unbiased=False) + 1e-6)
        return adv[None].expand((n_turns,) + tuple(adv.shape)).reshape(-1)
    return torch.ones(n_turns * scores.numel(), dtype=torch.float32, device=scores.device)


def update(cfg, spec, optimizer, params, opt_state, traj, scores, objective: str = "imitation"):
    """One Adam step on the loss over a block's trajectory ``traj`` (``obs
    [T, G, P, S]``, ``hands [T, G, P, H]``, ``picks [T, G, P]``) and its
    ``scores [G, P]``; returns ``(params, opt_state, loss, mean score)``."""
    from ..agents.dqn import grad_leaves, optimizer_step

    T, G = traj["obs"].shape[:2]
    obs = traj["obs"].reshape(-1, cfg.state_length)
    hands = traj["hands"].reshape(-1, cfg.hand_size)
    picks = traj["picks"].reshape(-1)
    weights = record_weights(objective, scores, T)
    leaves, live = grad_leaves(params)
    loss = imitation_loss(spec, live, obs, hands, picks, weights, G)
    params, opt_state = optimizer_step(optimizer, params, opt_state, loss, leaves)
    return params, opt_state, loss.detach(), scores.mean()


def head_to_head(params, fresh, spec, eval_games: int, mc_max: int, seed: int, dev):
    """Trained against fresh prior, seats alternated: ``(win rate, its standard error, games)``."""
    from ..engine import EnvConfig
    from ..runtime.device_match import make_device_match_fn

    match = make_device_match_fn(EnvConfig(num_players=2), ("puct", "puct"), spec, max(eval_games // 2, 1),
                                 mc_max=mc_max, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_a = match((params, fresh), gen).cpu()           # trained in seat 0
    s_b = match((fresh, params), gen).cpu()           # trained in seat 1
    wins = float((s_a[:, 0] > s_a[:, 1]).sum() + (s_b[:, 1] > s_b[:, 0]).sum())
    ties = float((s_a[:, 0] == s_a[:, 1]).sum() + (s_b[:, 1] == s_b[:, 0]).sum())
    n = s_a.shape[0] + s_b.shape[0]
    win_rate = (wins + 0.5 * ties) / n
    return win_rate, (win_rate * (1 - win_rate) / n) ** 0.5, n


def main(argv=None):
    from ..agents.device_search import KIND_PUCT
    from ..agents.dqn import Adam
    from ..engine import EnvConfig
    from ..nets import mlp_init
    from ..runtime.device_tournament import make_device_block_fn
    from ..utils import save_params
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--games", type=int, default=64, help="self-play games per iteration")
    parser.add_argument("--players", type=int, default=4)
    parser.add_argument("--mc-max", type=int, default=128, help="training playout budget")
    parser.add_argument("--eval-mc-max", type=int, default=200, help="head-to-head budget")
    parser.add_argument("--eval-games", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None, help="save trained params (.npz)")
    parser.add_argument("--objective", choices=["imitation", "advantage"], default="imitation",
                        help="'imitation': the reference's unconditional self-imitation (mcts.py:245-256); "
                             "'advantage': each seat's episode weighted by its score minus the game mean")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=args.players)
    spec = prior_spec(cfg)
    params = mlp_init(torch.Generator(device=dev).manual_seed(args.seed), spec, dev)
    optimizer = Adam(args.lr)
    opt_state = optimizer.init(params)
    G, P = args.games, args.players
    selfplay = make_device_block_fn(cfg, spec, G, args.mc_max, batch=8, device=dev)
    kinds = [[KIND_PUCT] * P for _ in range(G)]
    mc_maxes = [[args.mc_max] * P for _ in range(G)]
    mc_pers = [[10] * P for _ in range(G)]
    c_pucts = [[2.0] * P for _ in range(G)]
    epses = [[0.0] * P for _ in range(G)]          # no learner seats
    no_learners = [[None] * P for _ in range(G)]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    start = time.perf_counter()
    history = []
    for it in range(args.iters):
        seat_params = [[params] * P for _ in range(G)]    # one tree: one search call a turn
        scores, traj, _ = selfplay(seat_params, no_learners, kinds, mc_maxes, mc_pers, c_pucts, epses, gen)
        params, opt_state, loss, mean_score = update(cfg, spec, optimizer, params, opt_state, traj, scores,
                                                     args.objective)
        history.append((float(loss), float(mean_score)))
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  games {G * (it + 1):7d}  loss {history[-1][0]:8.2f}  "
                  f"mean score {history[-1][1]:6.2f}  ({time.perf_counter() - start:.0f}s)", flush=True)
    elapsed = time.perf_counter() - start
    print(f"trained on {G * args.iters} self-play games in {elapsed:.0f}s", flush=True)

    if args.out:
        save_params(args.out, params)
        print(f"saved params to {args.out}", flush=True)

    fresh = mlp_init(torch.Generator(device=dev).manual_seed(args.seed + 1234), spec, dev)
    win_rate, se, n = head_to_head(params, fresh, spec, args.eval_games, args.eval_mc_max, args.seed + 2, dev)
    print(f"trained-vs-fresh Alpha0.5 @mc_max={args.eval_mc_max}: win rate {win_rate:.3f} ± {se:.3f} "
          f"over {n} alternating-seat games", flush=True)
    return {"win_rate": win_rate, "history": history, "params": params, "seconds": elapsed}


if __name__ == "__main__":
    main()
