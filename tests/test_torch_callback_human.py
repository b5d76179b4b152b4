"""The human-vs-device game with a host prompt (port of
``tests/test_callback_human.py``): scripted stdin plays whole games on the
CPU, the reference prompt semantics (1-indexed faces, re-prompts) hold, and
the board render and the prompt equal the JAX package's for the same view."""

import builtins
import re

import numpy as np
import pytest
import torch

from rl6nimmt_tpu.runtime import callback_human as jax_callback
from rl6nimmt_torch.runtime import callback_human
from rl6nimmt_torch.runtime.callback_human import play_callback_game


def first_card(prompt):
    m = re.search(r"cards:\s*((?:\s*\d+)+)", prompt)
    if m is None:  # re-prompt line
        m = re.search(r"((?:\s*\d+)+)\s*$", prompt)
    return m.group(1).split()[0]


def test_callback_game_completes_with_scripted_human(monkeypatch, capsys):
    """Scripted stdin plays the first held card every turn."""
    prompts = []

    def scripted_input(prompt=""):
        prompts.append(prompt)
        return first_card(prompt)

    monkeypatch.setattr(builtins, "input", scripted_input)
    scores = play_callback_game(["random", "uniform"], mc_max=8, seed=3, name="Tester", device="cpu")
    assert scores.shape == (3,)
    assert np.all(scores <= 0)
    assert len(prompts) == 10  # one prompt per turn, no re-prompts
    assert all("Tester" in p for p in prompts)
    out = capsys.readouterr().out
    assert out.count("Board:") == 10  # board rendered from obs every turn
    assert "Final scores" in out


def test_callback_game_reprompts_on_bad_card(monkeypatch):
    """Invalid entries re-prompt until a held card is named (human.py:7-33)."""
    state = {"bad": True, "count": 0}

    def scripted_input(prompt=""):
        state["count"] += 1
        if state["bad"]:
            state["bad"] = False
            return "not-a-card"
        state["bad"] = True  # fail first try of the next turn too
        return first_card(prompt)

    monkeypatch.setattr(builtins, "input", scripted_input)
    scores = play_callback_game(["random"], mc_max=8, seed=5, device="cpu")
    assert scores.shape == (2,)
    assert state["count"] == 20  # 10 turns x (1 bad + 1 good)


@pytest.mark.parametrize("opponents", [["puct", "policy", "puct_uniform"], ["random", "random", "random", "random"]])
def test_callback_game_with_every_seat_kind(monkeypatch, opponents):
    """Net-prior seats (one shared prior) and wider tables; the penalties the
    game hands out are those its played cards can carry."""
    monkeypatch.setattr(builtins, "input", first_card)
    scores = play_callback_game(opponents, mc_max=8, seed=1, device="cpu")
    assert scores.shape == (1 + len(opponents),)
    assert np.all(scores <= 0) and scores.sum() < 0


def test_board_render_and_prompt_match_jax(monkeypatch, capsys):
    """The same observation and hand print the same board and ask the same
    prompts (including the re-prompt) as the JAX package's callback."""
    from rl6nimmt_torch.engine import EnvConfig, deal, observe

    cfg = EnvConfig(4)
    state = deal(cfg, 11, 1, device="cpu")
    obs, hand = observe(cfg, state)[0][0, 0].numpy(), state.hands_sorted[0, 0].numpy()
    seen = []
    for impl in (callback_human, jax_callback):
        answers = iter(["0", str(int(hand[2]) + 1)])
        prompts = []
        monkeypatch.setattr(builtins, "input", lambda p="": (prompts.append(p), next(answers))[1])
        card = impl._prompt_human(obs, hand, "Ann", cfg.num_rows, cfg.threshold)
        seen.append((int(card), prompts, capsys.readouterr().out))
    assert seen[0] == seen[1]
    assert seen[0][0] == int(hand[2]) and len(seen[0][1]) == 2


def test_callback_game_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        play_callback_game(["random"])
