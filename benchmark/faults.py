"""Faults planted under the timed path, to show that ``correct`` catches them.

Each is a context manager that replaces a function of the program for as long
as it is open, so a cell built inside it runs broken:

* ``frozen``: a step that returns its state unchanged (training: the optimizer
  leaves parameters and state as they were; an arena: the turn leaves the games
  as they were);
* ``half``: half of the batch left out (training: the second half of the games
  carries no return, the first half counts twice, so the loss is the mean over
  the rest; an arena: the second half of the games scores nothing);
* ``token``: one answer altered where it is produced (training: seat 0 of game
  0 plays its second card where it picked its first, or the reverse; an arena:
  seat 0 of game 0 takes one more point at the last turn).

The one-chip cells have no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "half", "token")


@contextlib.contextmanager
def _patched(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def training(fault: str):
    from rl6nimmt_torch.runtime import vector

    if fault == "frozen":
        return _patched(vector, "optimizer_apply", lambda f: lambda opt, params, state, grads: (params, state))
    if fault == "half":
        def returns(f):
            def broken(reward, gamma):
                out = f(reward, gamma)
                half = out.shape[1] // 2
                return torch.cat([2 * out[:, :half], torch.zeros_like(out[:, half:])], dim=1)
            return broken
        return _patched(vector, "discounted_returns", returns)
    if fault == "token":
        def pick(f):
            def broken(logits, gumbel):
                idx = f(logits, gumbel)
                if float(logits[0, 0, 1].detach()) > -1e8:          # two cards or more held
                    idx = idx.clone()
                    idx[0, 0] = 1 - torch.clamp(idx[0, 0], max=1)
                return idx
            return broken
        return _patched(vector, "_pick", pick)
    raise ValueError(f"unknown fault {fault!r}: {FAULTS}")


def arena(fault: str, turns: int):
    from rl6nimmt_torch.runtime import arena as arena_mod

    if fault == "frozen":
        return _patched(arena_mod, "step", lambda f: lambda cfg, state, actions: (state, torch.zeros_like(actions)))
    if fault == "half":
        def step(f):
            def broken(cfg, state, actions):
                new, rewards = f(cfg, state, actions)
                half = rewards.shape[0] // 2
                new.scores[half:] = state.scores[half:]
                return new, rewards
            return broken
        return _patched(arena_mod, "step", step)
    if fault == "token":
        calls = [0]

        def step(f):
            def broken(cfg, state, actions):
                new, rewards = f(cfg, state, actions)
                calls[0] += 1
                if calls[0] % turns == 0:
                    new.scores[0, 0] += 1
                return new, rewards
            return broken
        return _patched(arena_mod, "step", step)
    raise ValueError(f"unknown fault {fault!r}: {FAULTS}")


def planted(entry: str, fault: str, turns: int = 10):
    """The fault ``fault`` under the entry ``entry``'s timed path."""
    if entry == "reinforce_train":
        return training(fault)
    if entry == "arena_match":
        return arena(fault, turns)
    raise ValueError(f"no faults for entry {entry!r}")
