"""One device block on the card against the same block on the CPU, on one noise.

:func:`tournament_card_against_cpu` builds 8 games at P=4 from two lineups that
between them seat every family of the device block -- random, MCS (uniform
playouts), Noisy-D3QN, ACER / both REINFORCE variants, PUCTCustomed and the
decoupled PUCT (net root, uniform playouts) -- draws the block's whole
randomness on the CPU (:func:`~.device_tournament.draw_block_noise`) and plays
the block once on the card (its deal one K2 launch, every game turn and every
playout turn one K1 launch) and once with ``device="cpu"`` (the plain twins).
The scores, observations, hands, picks and rewards must be equal, the
log-probs and ACER's vectors within ``PARITY_TORCH.md`` §7's float32
tolerance.  ``chip_smoke.py`` and the GPU tests use it.

The agents are the families' own classes at their default widths, seeded.
The decoupled PUCT seat's root prior is :func:`.search_check.exact_prior`:
its PUCT scores tie by construction under a uniform prior, and a 1-ulp
difference between the devices then flips picks (``PARITY_TORCH.md`` §12).
The learners' random nets give distinct values, so their argmaxes and samples
do not tie.  Needs full float32 matmuls on the card (TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from ..agents.acer import BatchedACERAgent
from ..agents.device_search import KIND_POLICY, KIND_PUCT, KIND_RANDOM, KIND_UNIFORM
from ..agents.dqn import Noisy_D3QN_PRB_NStep
from ..agents.mcs import MCSAgent, PUCTCustomedAgent, PUCTUniformAgent
from ..agents.random_agent import DrunkHamster
from ..agents.reinforce import BatchedReinforceAgent, MaskedReinforceAgent
from ..engine import EnvConfig, deal
from ..engine.env import step_with
from ..ops.step_kernel import resolve_turn_plain
from .device_tournament import NET_KINDS, DeviceBlockSession, draw_block_noise, turn_rounds
from .learner_check import f32_err
from .search_check import exact_prior

GAMES, MC_MAX = 8, 16


def check_lineups(mc_max: int = MC_MAX, seed: int = 0) -> list:
    """Two four-seat lineups, alternating over :data:`GAMES` games, agents on the CPU."""
    dev = "cpu"
    first = [DrunkHamster(seed=seed, device=dev), MCSAgent(mc_max=mc_max, seed=seed + 1, device=dev),
             Noisy_D3QN_PRB_NStep(history_length=1000, n_steps=10, seed=seed + 2, device=dev),
             BatchedACERAgent(minibatch=10, seed=seed + 3, device=dev)]
    puct = PUCTUniformAgent(mc_max=mc_max, seed=seed + 4, device=dev)
    puct.params = exact_prior(puct.spec, dev)
    second = [BatchedReinforceAgent(seed=seed + 5, device=dev), MaskedReinforceAgent(seed=seed + 6, device=dev),
              PUCTCustomedAgent(mc_max=mc_max, seed=seed + 7, device=dev), puct]
    return [first if g % 2 == 0 else second for g in range(GAMES)]


def replay_k1_inputs(cfg: EnvConfig, deal_seed: int, hands, picks) -> list:
    """The block's K1 inputs, turn by turn: ``(board, row_len, actions)`` on the
    CPU, rebuilt from the deal seed (the plain deal) and the trajectory's picks."""
    state = deal(cfg, deal_seed, hands.shape[1], device="cpu")
    inputs = []
    for t in range(cfg.hand_size):
        actions = torch.gather(hands[t], 2, picks[t].long()[..., None])[..., 0].contiguous()
        inputs.append((state.board, state.row_len, actions))
        state, _ = step_with(cfg, state, actions, resolve_turn_plain)
    return inputs


def tournament_card_against_cpu(seed: int = 0, mc_max: int = MC_MAX) -> dict:
    """Play the check's block on the card and on the CPU with one noise.

    Returns ``{"exact": {name: bool}, "f32": {name: error}, "equal": bool,
    "card": (scores, traj), "cpu": (scores, traj), "deal": (cfg, seed, games),
    "k1_inputs": [...], "lanes": [...]}``: ``lanes`` are the playout widths of
    the block's search calls (seats x K), at which ``chip_smoke.py`` holds K1
    against its twin beside the block's own turns (``k1_inputs``).
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("tournament_card_against_cpu needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    lineups = check_lineups(mc_max, seed)
    out, noise = {}, None
    for where in ("cuda", "cpu"):
        session = DeviceBlockSession(lineups, device=where)
        inputs = session.assemble()
        cfg = session.cfg
        if noise is None:
            rounds = turn_rounds(cfg, inputs.kinds, inputs.mc_maxes, inputs.mc_pers, inputs.K)
            noise = draw_block_noise(torch.Generator().manual_seed(seed), cfg, len(lineups), inputs.K, rounds,
                                     session.slots, net=bool(np.isin(inputs.kinds, (KIND_POLICY, KIND_PUCT)).any()))
        scores, traj, final_obs = session.block_fn(inputs)(
            inputs.params, inputs.lparams, inputs.kinds, inputs.mc_maxes, inputs.mc_pers, inputs.c_pucts,
            inputs.epses, noise)
        out[where] = {"scores": scores.cpu(), "final_obs": final_obs.cpu(), **{k: v.cpu() for k, v in traj.items()}}
    card, cpu = out["cuda"], out["cpu"]
    floats = ("logps", "logp_vecs")
    exact = {k: torch.equal(card[k], cpu[k]) for k in card if k not in floats}
    f32 = {k: f32_err(card[k], cpu[k]) for k in floats}
    kinds = inputs.kinds.reshape(-1).tolist()
    net_seats = sum(k in NET_KINDS for k in kinds)
    plain_seats = sum(k in (KIND_RANDOM, KIND_UNIFORM) for k in kinds)
    return {"exact": exact, "f32": f32, "equal": all(exact.values()) and all(e <= 1.0 for e in f32.values()),
            "card": card, "cpu": cpu, "deal": (cfg, noise.deal_seed, len(lineups)),
            "k1_inputs": replay_k1_inputs(cfg, noise.deal_seed, cpu["hands"], cpu["picks"]),
            "lanes": sorted({plain_seats * inputs.K, net_seats * inputs.K})}
