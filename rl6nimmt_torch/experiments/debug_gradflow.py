"""Debug experiment: gradient-flow figure for the flagship DQN.

    python -m rl6nimmt_torch.experiments.debug_gradflow [--out PATH] [--device cuda]

Port of ``experiments/debug_gradflow.py``: 3 flagship self-play cycles
(Noisy-D3QN-PER-10step, hidden 64, minibatch 64, 256 games, PER 50,000 of
compact transitions, 8 updates, Adam 1e-3, eps 0.1) fill the buffer and move
the parameters; then the gradient of the same importance-weighted
double-DQN loss (:func:`gradflow_loss`, ``agents/dqn.py``'s learn step) on
a freshly sampled minibatch with fresh learn noise; its per-leaf
``grad_stats`` are printed and ``runtime/metrics.py`` ``plot_grad_flow``
writes the figure to ``--out``.  The figure needs matplotlib: where it does
not import, the script says so and writes none; the gradient and the
statistics run either way.  ``--platform`` is an alias of ``--device``.
Returns ``(grad_stats, the figure's path or None)``.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import torch

OUT = "rl6nimmt_torch/experiments/results/grad_flow.png"


def gradflow_loss(dqn_cfg, spec, params, target, batch, weights, noise, gamma: float = 0.99):
    """The IS-weighted Bellman loss of ``dqn.py``'s learn step on one batch:
    double-DQN target from the online net's argmax on ``next_state`` (noise
    ``nz1``) read off the target net (``nz2``), held constant; ``noise`` is
    ``(noise_eval, (nz1, nz2))``."""
    from ..agents.dqn import q_values
    from ..utils.ops import onehot_select

    noise_eval, (nz1, nz2) = noise
    q = q_values(dqn_cfg, spec, params, batch["state"], noise_eval)
    q_eval = onehot_select(q, batch["action"])
    with torch.no_grad():
        q_local = q_values(dqn_cfg, spec, params, batch["next_state"], nz1)
        q_tgt = q_values(dqn_cfg, spec, target, batch["next_state"], nz2)
        boot = onehot_select(q_tgt, torch.argmax(q_local, dim=-1))
        y = batch["reward"] + (gamma ** dqn_cfg.n_steps) * boot * (1.0 - batch["done"])
    return torch.mean(weights * (q_eval - y) ** 2)


def loss_gradient(dqn_cfg, spec, params, target, batch, weights, noise):
    """``(loss, grads)``: :func:`gradflow_loss` and its gradient as a parameter tree."""
    from ..agents.dqn import grad_leaves, grads_of

    leaves, live = grad_leaves(params)
    loss = gradflow_loss(dqn_cfg, spec, live, target, batch, weights, noise)
    return loss.detach(), grads_of(loss, leaves, params)


def main(argv=None):
    from ..agents.dqn import Adam, DQNConfig, learn_noise, q_network_spec, tree_map
    from ..buffers import per_init
    from ..buffers.per import per_sample
    from ..engine import EnvConfig
    from ..nets import mlp_init
    from ..runtime.metrics import grad_stats, plot_grad_flow
    from ..runtime.vector import dqn_replay_example, make_dqn_selfplay_step
    from ..utils.device import resolve_device
    from .chain_timing import FLAGSHIP

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--device", "--platform", dest="device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=4)
    dqn_cfg = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
    params = mlp_init(torch.Generator().manual_seed(0), spec, dev)
    target = tree_map(torch.clone, params)
    optimizer = Adam(1e-3)
    opt_state = optimizer.init(params)
    buf = per_init(50_000, dqn_replay_example(cfg), device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn_cfg, optimizer, num_games=256, learn_iters=8, device=dev)

    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        params, target, opt_state, buf, metrics = cycle(params, target, opt_state, buf, gen, 0.1)
    print(f"after 3 cycles: loss={float(metrics['loss']):.4f} mean_score={float(metrics['mean_score']):.2f}")

    # Gradient of the same IS-weighted Bellman loss on a fresh minibatch, fresh learn noise.
    _, _, weights, batch = per_sample(buf, torch.rand(dqn_cfg.minibatch, generator=gen, device=dev),
                                      dqn_cfg.minibatch)
    batch = {k: v.to(torch.int64) if k == "action" else v.to(torch.float32) for k, v in batch.items()}
    _, grads = loss_gradient(dqn_cfg, spec, params, target, batch, weights, learn_noise(dqn_cfg, spec, gen))
    stats = grad_stats(grads)
    for name, s in sorted(stats.items()):
        print(f"  {name:30s} mean|g|={s['mean_abs']:.2e}  max|g|={s['max_abs']:.2e}")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no figure written (the gradient statistics above are complete)")
        return stats, None
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    plot_grad_flow(grads, str(out))
    print(f"wrote {out}")
    return stats, str(out)


if __name__ == "__main__":
    main()
