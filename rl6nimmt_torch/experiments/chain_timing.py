"""What the profiling and micro-benchmark twins share: the flagship cycle's
construction and the timing of a chain of eager steps.

A JAX profiler ran N cycles in one ``lax.scan`` dispatch and fetched a scalar
that depends on all of them.  Eager PyTorch has no such dispatch: a *chain*
here is N calls between two ``torch.cuda.synchronize()`` calls, ended by a
read of the same scalar on the host (``PARITY_TORCH.md`` section 20).  State
that the JAX scan carried (parameters, buffers) is carried by the tensors
themselves; the replay buffers are written in place (section 6), so a buffer
stays filled from one timed chain to the next.
"""

from __future__ import annotations

import time

import torch

FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10, hidden_sizes=(64,), minibatch=64)
CAPACITY = 200_000


def timed(run, dev, iters: int, warmup: int = 2) -> float:
    """Median host seconds of ``run()`` over ``iters`` calls after ``warmup``
    untimed ones; each call's result is read on the host (``float``), which
    waits for every kernel it depends on."""
    for _ in range(warmup):
        float(run())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(run())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def replay_example(cfg) -> dict:
    """The float32 transition the JAX profilers build their buffers from."""
    S = cfg.state_length
    return {"state": torch.zeros(S), "action": torch.zeros((), dtype=torch.int32), "reward": torch.zeros(()),
            "next_state": torch.zeros(S), "done": torch.zeros(())}


def flagship_cycle(cfg, games: int, dev, learn_iters: int, capacity: int = CAPACITY, seed: int = 1,
                   compute_dtype: str = "float32", **dqn_overrides):
    """``(cycle, dqn_cfg, spec, state)``: ``make_dqn_selfplay_step`` of the
    flagship configuration (``dqn_overrides`` replace its fields) with
    ``learn_iters`` updates and Adam 1e-3, and a fresh ``(params, target,
    opt_state, buffer)`` from ``seed`` on ``per_init`` (PER configs) or
    ``ring_init`` of ``capacity`` float32 transitions.  ``compute_dtype`` goes
    into the spec the params are drawn for; the cycle builds its own spec from
    the config, float32, as JAX's does."""
    import dataclasses

    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init, ring_init
    from ..nets import mlp_init
    from ..runtime.vector import make_dqn_selfplay_step

    dqn = DQNConfig(**{**FLAGSHIP, **dqn_overrides})
    spec = dataclasses.replace(q_network_spec(dqn, cfg.state_length, cfg.num_actions), compute_dtype=compute_dtype)
    params = mlp_init(torch.Generator(device=dev).manual_seed(seed), spec, dev)
    adam = Adam(1e-3)
    buf = (per_init if dqn.per else ring_init)(capacity, replay_example(cfg), device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, games, learn_iters=learn_iters, device=dev)
    return cycle, dqn, spec, (params, tree_map(torch.clone, params), adam.init(params), buf)


def run_cycles(cycle, state, gen, n: int, eps: float = 0.1):
    """``n`` cycles from ``state``: ``(state', [metrics of each cycle])``."""
    metrics = []
    for _ in range(n):
        *state, m = cycle(*state, gen, eps)
        metrics.append(m)
    return tuple(state), metrics
