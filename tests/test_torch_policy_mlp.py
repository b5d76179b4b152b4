"""The fused action-in-input policy forward (``ops/policy_mlp.py``) on the CPU:
its twin against the plain route of ``action_in_input_logits``, the autograd
Function's hand-written backward against autograd, a train step through the
Function, and the rule that decides when the kernel's route is taken.  The
kernel itself runs on the card only (``tests/test_torch_kernels_gpu.py``)."""

import pytest
import torch

from rl6nimmt_torch.agents import reinforce
from rl6nimmt_torch.agents.dqn import Adam, grad_leaves, tree_leaves
from rl6nimmt_torch.engine import EnvConfig, deal, observe, step
from rl6nimmt_torch.nets import MLPSpec, mlp_init
from rl6nimmt_torch.ops import policy_mlp
from rl6nimmt_torch.runtime.vector import make_reinforce_train_step
from rl6nimmt_torch.utils.ops import onehot_select

CFG = EnvConfig(4)
SPEC = MLPSpec(CFG.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
H = CFG.hand_size


def _params(spec=SPEC, seed=0):
    return mlp_init(torch.Generator().manual_seed(seed), spec, "cpu")


def _position(G, turns, seed=0):
    """``(obs f32[G, P, S], hands int32[G, P, H])`` after ``turns`` turns of first-card play."""
    state = deal(CFG, seed, G, device="cpu")
    for _ in range(turns):
        state, _ = step(CFG, state, state.hands_sorted[:, :, 0].contiguous())
    return observe(CFG, state)[0], state.hands_sorted


def _cards(hands, kind, turns):
    """The candidates of a case: the whole hand (trailing -1 past ``H - turns``),
    its ``H - turns`` live slots, or the hand with every third seat's row padded."""
    if kind == "trailing":
        return hands
    if kind == "live":
        return hands[..., : H - turns]
    padded = hands.clone()
    padded.reshape(-1, H)[::3] = -1
    return padded


def _on_card(monkeypatch):
    """Make the rule see CUDA tensors: the fused route then runs the twin on the CPU."""
    monkeypatch.setattr(policy_mlp, "_on_card", lambda x: True)


CASES = [(G, kind, turns) for G in (1, 3, 37) for kind, turns in (("trailing", 4), ("live", 4), ("all_padded", 2))]


@pytest.mark.parametrize("G,kind,turns", CASES)
def test_plain_twin_equals_action_in_input_logits(G, kind, turns):
    obs, hands = _position(G, turns, seed=G)
    cards = _cards(hands, kind, turns)
    params = _params()
    want = reinforce.action_in_input_logits(SPEC, params, obs, cards)
    w0, w2, b2, w3, b3 = (params["trunk"][0]["w"][0], params["trunk"][1]["w"], params["trunk"][1]["b"],
                          params["heads"][0]["w"], params["heads"][0]["b"])
    shared = reinforce._state_product(SPEC, params, obs)
    got = policy_mlp.policy_mlp_plain(shared, cards, w0, w2, b2, w3, b3, reinforce.CARDS - 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got == policy_mlp.NEG_INF, cards < 0)
    if kind == "all_padded":
        assert (got.reshape(-1, H)[::3] == policy_mlp.NEG_INF).all()


def _loss(logits, cards, pad_to, seed):
    """A REINFORCE-like scalar: log-softmax over the slots padded back to
    ``pad_to`` with NEG_INF (``fused_loss``'s cat), a drawn slot's log-prob and
    the entropy, both weighted."""
    if logits.shape[-1] < pad_to:
        logits = torch.cat([logits, logits.new_full(logits.shape[:-1] + (pad_to - logits.shape[-1],),
                                                    policy_mlp.NEG_INF)], dim=-1)
    gen = torch.Generator().manual_seed(seed)
    live = (cards >= 0).sum(dim=-1).clamp(min=1)
    idx = (torch.rand(live.shape, generator=gen) * live).long()
    weight = torch.randn(live.shape, generator=gen)
    logp, entropy = reinforce.log_probs_and_entropy(logits)
    return (weight * onehot_select(logp, idx)).sum() - 0.1 * entropy.sum()


@pytest.mark.parametrize("G,kind,turns", CASES)
def test_function_backward_equals_autograd(G, kind, turns, monkeypatch):
    """The six leaves' gradients through the Function (twin forward, the
    hand-written backward) equal autograd's through ``action_in_input_heads``,
    and so does the gradient of the state product.  The head bias's gradient
    is the sum of the logits' gradients, which the softmax makes zero row by
    row: both backwards must read float32 round-off of 0 there, at most 1e-6
    of the sum of their magnitudes."""
    obs, hands = _position(G, turns, seed=G + 1)
    cards = _cards(hands, kind, turns)
    params = _params(seed=1)
    grads, shared_grads = [], []
    for fused in (False, True):
        if fused:
            _on_card(monkeypatch)
        leaves, live = grad_leaves(params)
        logits = reinforce.action_in_input_logits(SPEC, live, obs, cards)
        *leaf_grads, g = torch.autograd.grad(_loss(logits, cards, H, G), leaves + [logits])
        grads.append(leaf_grads)
        db3 = leaf_grads[[id(x) for x in leaves].index(id(live["heads"][0]["b"]))]
        assert float(db3.abs().max()) <= 1e-6 * float(torch.where(cards >= 0, g, 0.0).abs().sum())
        shared = reinforce._state_product(SPEC, params, obs).detach().requires_grad_(True)
        w = (live["trunk"][0]["w"][0], live["trunk"][1]["w"], live["trunk"][1]["b"], live["heads"][0]["w"],
             live["heads"][0]["b"])
        logits = (policy_mlp.policy_logits(shared, cards, *w, reinforce.CARDS - 1) if fused
                  else policy_mlp.policy_mlp_plain(shared, cards, *w, reinforce.CARDS - 1))
        shared_grads.append(torch.autograd.grad(_loss(logits, cards, H, G), shared)[0])
    assert len(grads[0]) == 6
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(shared_grads[1], shared_grads[0], rtol=1e-5, atol=1e-6)


def test_function_keeps_the_hidden_tensors_with_padded_rows_zero(monkeypatch):
    obs, hands = _position(5, 3)
    params = _params()
    shared = reinforce._state_product(SPEC, params, obs).reshape(-1, 100)
    cards = hands.reshape(-1, H)
    w = (params["trunk"][0]["w"][0], params["trunk"][1]["w"], params["trunk"][1]["b"], params["heads"][0]["w"],
         params["heads"][0]["b"])
    logits, h1, h2 = policy_mlp._forward(shared, cards, *w, 103.0, save=True)
    assert h1.shape == (20, H, 100) and h2.shape == (20, H, 100)
    padded = cards < 0
    assert padded.any() and not h1[padded].any() and not h2[padded].any()
    torch.testing.assert_close(logits, policy_mlp.policy_mlp_plain(shared, cards, *w, 103.0))


@pytest.mark.parametrize("fused_grad", [True, False])
def test_train_step_through_the_function_equals_the_plain_path(fused_grad, monkeypatch):
    """A 32-game REINFORCE train step, twice: through the Function the same
    losses and parameters as the plain ops.  The head's bias is left out: the
    softmax does not see it, so its gradient is float32 round-off of a sum
    that is zero (held to that in ``test_function_backward_equals_autograd``),
    taken in another order by the two backwards, and Adam scales any
    round-off, of either sign, to a step of about lr."""
    adam = Adam(1e-3)
    runs = []
    for fused in (False, True):
        if fused:
            _on_card(monkeypatch)
        train = make_reinforce_train_step(CFG, SPEC, adam, 32, fused_grad=fused_grad, device="cpu")
        params = _params(seed=2)
        opt_state = adam.init(params)
        gen = torch.Generator().manual_seed(3)
        losses = []
        for _ in range(2):
            params, opt_state, metrics = train(params, opt_state, gen)
            losses.append(float(metrics["loss"]))
        runs.append((losses, params))
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-5)
    fused, plain = runs[1][1], runs[0][1]
    fused["heads"][0].pop("b"), plain["heads"][0].pop("b")
    for a, b in zip(tree_leaves(fused), tree_leaves(plain)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


FALLBACK_SPECS = {
    "bf16": MLPSpec(SPEC.input_size, compute_dtype="bfloat16"),
    "tanh": MLPSpec(SPEC.input_size, activation="tanh"),
    "two_heads": MLPSpec(SPEC.input_size, head_sizes=(1, 1)),
    "three_layer_trunk": MLPSpec(SPEC.input_size, hidden_sizes=(100, 100, 100)),
    "d129": MLPSpec(SPEC.input_size, hidden_sizes=(129, 129)),
    "d116": MLPSpec(SPEC.input_size, hidden_sizes=(116, 116)),
    "d102": MLPSpec(SPEC.input_size, hidden_sizes=(102, 102)),
    "two_widths": MLPSpec(SPEC.input_size, hidden_sizes=(100, 96)),
}


@pytest.mark.parametrize("case", [*FALLBACK_SPECS, "cpu"])
def test_fallback_cases_take_the_plain_path(case, monkeypatch):
    """Each case the kernel does not serve runs the plain ops; a CUDA one is counted."""
    spec = FALLBACK_SPECS.get(case, SPEC)
    if case != "cpu":
        _on_card(monkeypatch)
    fused = []
    monkeypatch.setattr(policy_mlp, "policy_logits", lambda *a: fused.append(a))
    obs, hands = _position(3, 2)
    params = _params(spec)
    policy_mlp.FALLBACKS["policy_mlp"] = 0
    assert policy_mlp.fused_weights(spec, params, obs, hands) is None
    assert policy_mlp.FALLBACKS["policy_mlp"] == (case != "cpu")
    logits = reinforce.action_in_input_logits(spec, params, obs, hands)
    assert not fused and logits.shape == hands.shape
    heads = reinforce.action_in_input_heads(spec, params, obs, hands)
    assert torch.equal(logits, torch.where(hands >= 0, heads[0][..., 0], policy_mlp.NEG_INF))


def test_the_reference_spec_takes_the_fused_route(monkeypatch):
    _on_card(monkeypatch)
    obs, hands = _position(3, 2)
    params = _params()
    policy_mlp.FALLBACKS["policy_mlp"] = 0
    w = policy_mlp.fused_weights(SPEC, params, obs, hands)
    assert w is not None and w[1] is params["trunk"][1]["w"] and w[3] is params["heads"][0]["w"]
    calls = []
    real = policy_mlp.policy_logits
    monkeypatch.setattr(policy_mlp, "policy_logits", lambda *a: calls.append(a) or real(*a))
    got = reinforce.action_in_input_logits(SPEC, params, obs, hands)
    assert len(calls) == 1 and policy_mlp.FALLBACKS["policy_mlp"] == 0
    monkeypatch.setattr(policy_mlp, "_on_card", lambda x: False)
    torch.testing.assert_close(got, reinforce.action_in_input_logits(SPEC, params, obs, hands), rtol=1e-5, atol=1e-6)
