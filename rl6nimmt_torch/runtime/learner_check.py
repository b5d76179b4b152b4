"""The REINFORCE step and the ACER cycle on the card against the CPU on one randomness.

:func:`learners_card_against_cpu` draws the parameters, the Gumbel noise and
the sample indices on the CPU and hands both devices the same ones (and the
same K2 deal seed: K2 deals on the card, its plain twin on the CPU).  On each
device it runs the REINFORCE rollout and the ACER rollout, one fused REINFORCE
step and one ACER cycle under :class:`~..agents.dqn.Sgd`, and two REINFORCE
steps and two ACER cycles under Adam.  The rollouts' observations, legal
sets, actions, rewards and scores must be equal; log-probs, losses and
parameters after the SGD updates agree within ``PARITY_TORCH.md`` section 7's
float32 tolerance (rtol 1e-5, atol 1e-6 times the largest magnitude); the
losses of the Adam runs within the same tolerance.  The parameters after an
Adam step are not compared: Adam's first step moves a parameter by about
``lr`` whatever its gradient's size, and the policy head's bias has a zero
gradient by construction, so each device steps it by the sign of its own
round-off.  Needs full float32 matmuls on the card (TF32 off).
"""

from __future__ import annotations

import torch

from ..agents.dqn import Adam, Sgd, tree_leaves
from ..agents.search import draw_gumbel
from ..buffers.sequence import seq_init
from ..engine import EnvConfig
from ..nets import MLPSpec, mlp_init
from ..utils.device import resolve_device
from . import vector

RTOL, ATOL = 1e-5, 1e-6


def f32_err(actual: torch.Tensor, desired: torch.Tensor) -> float:
    """The largest ``|a - d| - rtol |d|`` over ``atol * max(1, max |d|)``: at most 1 within tolerance."""
    a, d = actual.detach().double().cpu(), desired.detach().double().cpu()
    scale = max(1.0, float(d.abs().max())) if d.numel() else 1.0
    return float(((a - d).abs() - RTOL * d.abs()).max() / (ATOL * scale)) if d.numel() else 0.0


def learners_card_against_cpu(num_games: int = 64, seed: int = 0, hidden=(100, 100), minibatch: int = 64,
                              on_policy_sequences: int = 128) -> dict:
    """Run both learners on the card and on the CPU on one randomness.

    Returns ``{"exact": {name: bool}, "f32": {name: error}, "equal": bool}``:
    ``exact`` names the integer outputs that must be equal, ``f32`` the float
    outputs with their :func:`f32_err` (at most 1 passes).
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("learners_card_against_cpu needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    cfg = EnvConfig(4)
    G, P, T, H, S = num_games, cfg.num_players, cfg.max_turns, cfg.hand_size, cfg.state_length
    gen = torch.Generator().manual_seed(seed)
    rspec = MLPSpec(S + 1, hidden_sizes=tuple(hidden), head_sizes=(1,))
    aspec = MLPSpec(S + 1, hidden_sizes=tuple(hidden), head_sizes=(1, 1))
    rparams, aparams = mlp_init(gen, rspec, "cpu"), mlp_init(gen, aspec, "cpu")
    rolls = [vector.RolloutRandomness(gumbel=draw_gumbel(gen, (T, G, P, H), "cpu"), deal_seed=seed + i)
             for i in range(2)]
    k_on, n_fresh = min(on_policy_sequences, G * P), G * P
    acer_rnd = [vector.AcerRandomness(rollout=r, on_idx=torch.randperm(n_fresh, generator=gen)[:k_on],
                                      off_idx=torch.randint(0, (i + 1) * n_fresh, (minibatch,), generator=gen))
                for i, r in enumerate(rolls)]

    out = {}
    for where in ("cuda", "cpu"):
        dev = resolve_device(where)
        to = lambda tree: {part: [{k: v.to(dev) for k, v in layer.items()} for layer in tree[part]]
                           for part in ("trunk", "heads")}
        res = out[where] = {}
        traj, scores = vector.make_reinforce_rollout(cfg, rspec, G, dev)(to(rparams), rolls[0])
        res.update(reinforce_obs=traj.obs, reinforce_cards=traj.legal_cards, reinforce_chosen=traj.chosen,
                   reinforce_reward=traj.reward, reinforce_scores=scores)
        seqs, scores = vector.make_acer_rollout(cfg, aspec, G, 0.1, dev)(to(aparams), rolls[0])
        res.update({f"acer_{k}": v for k, v in seqs.items()}, acer_scores=scores)
        for name, opt, steps in (("sgd", Sgd(1e-2), 1), ("adam", Adam(1e-3), 2)):
            rstep = vector.make_reinforce_train_step(cfg, rspec, opt, G, device=dev)
            cycle = vector.make_acer_selfplay_step(cfg, aspec, opt, G, minibatch=minibatch,
                                                   on_policy_sequences=on_policy_sequences, device=dev)
            rp, ro = to(rparams), opt.init(to(rparams))
            ap, ao = to(aparams), opt.init(to(aparams))
            buf = seq_init(4 * n_fresh, T, vector.acer_sequence_example(cfg), device=dev)
            for i in range(steps):
                rp, ro, rm = rstep(rp, ro, rolls[i])
                ap, ao, buf, am = cycle(ap, ao, buf, acer_rnd[i])
                res.update({f"{name}{i}_reinforce_{k}": v for k, v in rm.items()})
                res.update({f"{name}{i}_acer_{k}": v for k, v in am.items()})
            if name == "sgd":
                res.update({f"sgd_reinforce_param{j}": x for j, x in enumerate(tree_leaves(rp))})
                res.update({f"sgd_acer_param{j}": x for j, x in enumerate(tree_leaves(ap))})
    card, cpu = out["cuda"], out["cpu"]
    exact = {k: torch.equal(card[k].cpu(), cpu[k]) for k in card
             if not card[k].is_floating_point() or k.endswith(("_obs", "_state", "_reward", "_done", "mean_score"))}
    f32 = {k: f32_err(card[k], cpu[k]) for k in card if k not in exact}
    return {"exact": exact, "f32": f32, "equal": all(exact.values()) and all(e <= 1.0 for e in f32.values())}
