"""The profilers', micro-benchmarks' and debug scripts' twins under
``rl6nimmt_torch/experiments`` and the port's ``compute_dtype``, against the
JAX package on the CPU at small sizes.

* ``MLPSpec(compute_dtype="bfloat16")``: ``mlp_apply``, ``dueling_apply`` and
  ``action_in_input_logits`` on converted params equal JAX's within float32
  round-off (rtol 1e-5, atol 1e-6): the product of two bfloat16 values is
  exact in float32, so only the float32 summation order can differ.  One
  REINFORCE gradient equals ``jax.grad``'s within two bfloat16 ulps
  (rtol 2^-7; atol 1e-5 of the largest element, for the head bias whose
  gradient is round-off alone): JAX rounds each operand's gradient of a
  bfloat16 product to bfloat16, and a summation-order difference may round
  an element the other way; so does the product's transpose alone.  The float32 default is bit for bit
  the plain products it was before the option existed.
* The roofline's byte and FLOP counts equal the JAX script's own lines.
* ``profile_ab``'s ``welch_t``, ``arena_vs_random`` and ``head_to_head`` equal
  JAX's on JAX's replayed arena noise; ``debug_gradflow``'s loss gradient and
  ``grad_stats`` equal ``jax.grad`` of the JAX script's ``loss_fn`` on one
  minibatch and one learn noise.
* ``act_rollout_probe``'s structural checks pass on K4's twin's games and
  fail on one illegal action; both packages refuse the over-capacity inserts
  of ``micro_cycle`` and ``micro_cycle2``; ``bench_trainable``'s flags and defaults are the JAX
  script's, read from its source.

The JAX scripts enable a compilation cache at import, so their functions and
lines are compiled from their source here, not imported.
"""

import ast
import dataclasses
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.nets as jnets
from rl6nimmt_tpu.agents import reinforce as jreinforce
from rl6nimmt_torch import nets as tnets
from rl6nimmt_torch.agents import reinforce as treinforce
from rl6nimmt_torch.agents.dqn import grad_leaves, grads_of, tree_leaves
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.experiments import act_rollout_probe, bench_trainable, debug_gradflow, profile_ab, roofline_cycle
from rl6nimmt_torch.nets import params_from_jax
from rl6nimmt_torch.nets.mlp import _mm
from torch_jax_noise import arena_noise

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
BF16_ULP = 2.0 ** -8


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _specs(hidden, heads, noisy=False, dtype="bfloat16", input_size=47):
    return (jnets.MLPSpec(input_size, hidden, heads, noisy=noisy, compute_dtype=dtype),
            tnets.MLPSpec(input_size, hidden, heads, noisy=noisy, compute_dtype=dtype))


def _jax_lines(script, first, last, ns, starts):
    """Run lines ``first..last`` of ``experiments/<script>.py`` (dedented) in ``ns``."""
    lines = (ROOT / "experiments" / f"{script}.py").read_text().splitlines(keepends=True)[first - 1:last]
    assert lines[0].strip().startswith(starts), (script, first, lines[0])
    exec(compile(textwrap.dedent("".join(lines)), f"{script}.py:{first}", "exec"), ns)
    return ns


def _jax_functions(script, names, ns):
    """Top-level functions ``names`` of ``experiments/<script>.py``, compiled in ``ns``."""
    path = ROOT / "experiments" / f"{script}.py"
    nodes = [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef) and n.name in names]
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"), ns)
    return [ns[n] for n in names]


def _states_and_legal(n, seed=0):
    rng = np.random.RandomState(seed)
    state = rng.randint(-1, 40, (n, 47)).astype(np.float32)
    legal = np.sort(rng.choice(104, (n, 10)), -1).astype(np.int32)
    legal[:, 7:] = -1
    return state, legal


# ------------------------------------------------------------- compute_dtype


@pytest.mark.parametrize("noisy", [False, True])
def test_bf16_mlp_and_dueling_match_jax(noisy):
    jspec, tspec = _specs((32,), (1, 104), noisy=noisy)
    jp = jnets.mlp_init(jax.random.key(3), jspec)
    tp = params_from_jax(_np_tree(jp), "cpu")
    x = np.random.RandomState(1).randn(24, 47).astype(np.float32) * 4
    jnoise = jnets.draw_mlp_noise(jspec, jax.random.key(4)) if noisy else None
    tnoise = tnets.noise_from_jax(_np_tree(jnoise), "cpu") if noisy else None
    jouts = jnets.mlp_apply(jspec, jp, jnp.asarray(x), noise=jnoise)
    touts = tnets.mlp_apply(tspec, tp, torch.as_tensor(x), tnoise)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD)
    jq = jnets.dueling_apply(jspec, jp, jnp.asarray(x), noise=jnoise)
    np.testing.assert_allclose(tnets.dueling_apply(tspec, tp, torch.as_tensor(x), tnoise).numpy(), np.asarray(jq),
                               **FWD)
    # The option changes the result: the float32 spec's output is not the bfloat16 one.
    (f32,) = tnets.mlp_apply(dataclasses.replace(tspec, compute_dtype="float32"), tp, torch.as_tensor(x), tnoise)[1:]
    assert not torch.equal(f32, touts[1])


def test_bf16_action_in_input_logits_match_jax():
    jspec, tspec = _specs((32, 32), (1,), input_size=48)
    jp = jnets.mlp_init(jax.random.key(5), jspec)
    tp = params_from_jax(_np_tree(jp), "cpu")
    state, legal = _states_and_legal(16)
    jl = jax.vmap(lambda s, l: jreinforce.action_in_input_logits(jspec, jp, s, l))(jnp.asarray(state),
                                                                               jnp.asarray(legal))
    tl = treinforce.action_in_input_logits(tspec, tp, torch.as_tensor(state), torch.as_tensor(legal).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)


def _reinforce_batch(T=10, seed=2):
    state, legal = _states_and_legal(T, seed)
    rng = np.random.RandomState(seed)
    return {"state": state, "legal_cards": legal, "chosen": rng.randint(0, 7, T).astype(np.int32),
            "reward": -rng.randint(0, 6, T).astype(np.float32)}


def test_bf16_reinforce_gradient_matches_jax():
    """``reinforce_loss`` through the action-in-input net: loss within float32
    round-off, every gradient element within two bfloat16 ulps of JAX's."""
    jspec, tspec = _specs((32, 32), (1,), input_size=48)
    jp = jnets.mlp_init(jax.random.key(6), jspec)
    tp = params_from_jax(_np_tree(jp), "cpu")
    b = _reinforce_batch()
    jlogits = lambda p, bb: jax.vmap(lambda s, l: jreinforce.action_in_input_logits(jspec, p, s, l))(
        bb["state"], bb["legal_cards"])
    jloss = lambda p: jreinforce.reinforce_loss(jlogits, p, jax.tree.map(jnp.asarray, b), 0.99, 1.0, 0.01)[0]
    jl, jg = jax.value_and_grad(jloss)(jp)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tb["legal_cards"], tb["chosen"] = tb["legal_cards"].long(), tb["chosen"].long()
    leaves, live = grad_leaves(tp)
    tlogits = lambda p, bb: treinforce.action_in_input_logits(tspec, p, bb["state"], bb["legal_cards"])
    tl = treinforce.reinforce_loss(tlogits, live, tb, 0.99, 1.0, 0.01)[0]
    tg = grads_of(tl, leaves, tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = tree_leaves(params_from_jax(_np_tree(jg), "cpu"))
    # The head bias's gradient is zero but for round-off (the softmax is shift-invariant): the absolute
    # tolerance is float32 round-off at the scale of the largest gradient element.
    atol = 1e-5 * max(float(j.abs().max()) for j in want)
    for t, j in zip(tree_leaves(tg), want):
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=2 * BF16_ULP, atol=atol)


@pytest.mark.parametrize("x_shape", [(5, 9), (3, 4, 9), (9,)])
def test_bf16_product_and_its_transpose_match_jax(x_shape):
    """``_mm(x, w, "bfloat16")`` and its vector-Jacobian product against JAX's
    ``dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)`` and its
    transpose: values within float32 summation order, each operand's gradient
    rounded to bfloat16 as JAX's and within two of its ulps."""
    rng = np.random.RandomState(7)
    x0, w0 = rng.randn(*x_shape).astype(np.float32), rng.randn(9, 6).astype(np.float32)
    g = rng.randn(*x_shape[:-1], 6).astype(np.float32)
    jdot = lambda x, w: jnp.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    jy, vjp = jax.vjp(jdot, jnp.asarray(x0), jnp.asarray(w0))
    x, w = torch.tensor(x0, requires_grad=True), torch.tensor(w0, requires_grad=True)
    y = _mm(x, w, "bfloat16")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD)
    for t, j in zip(torch.autograd.grad(y, (x, w), torch.as_tensor(g)), vjp(jnp.asarray(g))):
        assert torch.equal(t, t.to(torch.bfloat16).float())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2 * BF16_ULP, atol=1e-6)


def test_float32_default_is_the_plain_product():
    """The default spec runs ``x @ w + b``, bit for bit, in every apply function."""
    jspec, tspec = _specs((32,), (1, 104), noisy=True, dtype="float32")
    assert tspec == tnets.MLPSpec(47, (32,), (1, 104), noisy=True)
    tp = params_from_jax(_np_tree(jnets.mlp_init(jax.random.key(8), jspec)), "cpu")
    noise = tnets.noise_from_jax(_np_tree(jnets.draw_mlp_noise(jspec, jax.random.key(9))), "cpu")
    x = torch.as_tensor(np.random.RandomState(2).randn(12, 47).astype(np.float32))
    layers = [{"w": p["w"] + p["sigma_w"] * (z["eps_in"] * z["eps_out"]), "b": p["b"] + p["sigma_b"] * z["eps_out"][0]}
              for p, z in zip(tp["trunk"] + tp["heads"], noise)]
    h = torch.relu(x @ layers[0]["w"] + layers[0]["b"])
    want = [h @ layer["w"] + layer["b"] for layer in layers[1:]]
    got = tnets.mlp_apply(tspec, tp, x, noise)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    aspec = tnets.MLPSpec(48, (32,), (1,))
    ap = tnets.mlp_init(torch.Generator().manual_seed(0), aspec, "cpu")
    state, legal = (torch.as_tensor(a) for a in _states_and_legal(6))
    logits = treinforce.action_in_input_logits(aspec, ap, state, legal.long())
    w, b = ap["trunk"][0]["w"], ap["trunk"][0]["b"]
    a_norm = -1.0 + 2.0 * legal.to(torch.float32) / 103
    h = torch.relu((tnets.normalize_state(state) @ w[1:] + b)[:, None, :] + a_norm[..., None] * w[0])
    plain = (h @ ap["heads"][0]["w"] + ap["heads"][0]["b"])[..., 0]
    assert torch.equal(logits, torch.where(legal >= 0, plain, treinforce.NEG_INF))


def test_compute_dtype_refuses_other_dtypes():
    with pytest.raises(ValueError, match="compute_dtype"):
        _mm(torch.ones(2, 3), torch.ones(3, 4), "float16")


# ------------------------------------------------------------------ roofline


@pytest.mark.parametrize("shape", [dict(G=4096, H=64, CAP=200_000, MB=64, ITERS=8),
                                   dict(G=1000, H=256, CAP=50_000, MB=128, ITERS=3)])
def test_roofline_counts_equal_jax_lines(shape):
    cfg = EnvConfig(num_players=4)
    ns = dict(T=cfg.max_turns, P=cfg.num_players, S=cfg.state_length, A=cfg.num_actions, **shape)
    ns["N"] = ns["T"] * ns["P"] * ns["G"]
    want = _jax_lines("roofline_cycle", 143, 168, dict(ns), "int8 = 1")
    got = roofline_cycle.analytic_counts(ns["T"], ns["P"], ns["S"], ns["G"], ns["H"], ns["A"], ns["N"], ns["CAP"],
                                         ns["MB"], ns["ITERS"])
    assert got == {k: want[k] for k in got}


def test_roofline_uses_h100_rates_only():
    assert (roofline_cycle.H100_HBM_BYTES_PER_S, roofline_cycle.H100_F32_FLOPS) == (3.35e12, 67e12)
    assert roofline_cycle.floor_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline_cycle.floor_ms(0, 67e9) == pytest.approx(1.0)
    src = (ROOT / "rl6nimmt_torch" / "experiments" / "roofline_cycle.py").read_text()
    assert "819" not in src and "197" not in src


# ---------------------------------------------------------------- profile_ab


@pytest.mark.parametrize("arrays", [([0.2, 0.3, 0.25], [0.1, 0.15, 0.12]), ([0.5, 0.5], [0.5, 0.5]),
                                    ([0.25, 0.31, 0.22, 0.29, 0.3], [0.33, 0.2, 0.27, 0.24, 0.26])])
def test_welch_t_equals_jax(arrays):
    (j_welch,) = _jax_functions("profile_ab", ["welch_t"], {"np": np})
    assert profile_ab.welch_t(*arrays) == j_welch(*arrays)


def test_profile_ab_arena_scoring_equals_jax():
    from rl6nimmt_tpu.engine import EnvConfig as JEnvConfig
    from rl6nimmt_tpu.runtime.arena import SeatPolicy as JSeatPolicy
    from rl6nimmt_tpu.runtime.arena import make_arena as jmake_arena

    ns = {"np": np, "jax": jax, "jnp": jnp, "EnvConfig": JEnvConfig, "SeatPolicy": JSeatPolicy,
          "make_arena": jmake_arena}
    j_vs_random, j_h2h = _jax_functions("profile_ab", ["arena_vs_random", "head_to_head"], ns)
    G = 24
    jcfg, cfg = JEnvConfig(num_players=4), EnvConfig(num_players=4)
    jspec = jnets.MLPSpec(input_size=48, hidden_sizes=(16,), head_sizes=(1,))
    spec = tnets.MLPSpec(input_size=48, hidden_sizes=(16,), head_sizes=(1,))
    jparams = [jnets.mlp_init(jax.random.key(s), jspec) for s in (11, 12)]
    tparams = [params_from_jax(_np_tree(p), "cpu") for p in jparams]
    pol, rand = JSeatPolicy("policy", jspec), JSeatPolicy("random")
    got = profile_ab.arena_vs_random(cfg, spec, tparams[0], G, 777, "cpu",
                                     noise=arena_noise((pol,) + (rand,) * 3, G, 777))
    assert got == j_vs_random(jcfg, jspec, jparams[0], G, 777)
    noises = (arena_noise((pol, pol), G, 900), arena_noise((pol, pol), G, 901))
    got = profile_ab.head_to_head(spec, tparams[0], tparams[1], G, 900, "cpu", noises=noises)
    assert got == j_h2h(jspec, jparams[0], jparams[1], G, 900)


# ------------------------------------------------------------ debug_gradflow


def test_gradflow_gradient_and_stats_equal_jax():
    from rl6nimmt_tpu.agents.dqn import DQNConfig as JDQNConfig
    from rl6nimmt_tpu.agents.dqn import learn_noise as jlearn_noise
    from rl6nimmt_tpu.agents.dqn import q_network_spec as jq_network_spec
    from rl6nimmt_tpu.agents.dqn import q_values as jq_values
    from rl6nimmt_tpu.runtime.metrics import grad_stats as jgrad_stats
    from rl6nimmt_tpu.utils.tpu_ops import onehot_select as jonehot_select
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
    from rl6nimmt_torch.runtime.metrics import grad_stats

    flag = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10, hidden_sizes=(16,), minibatch=8)
    jcfg, cfg = JDQNConfig(**flag), DQNConfig(**flag)
    jspec, spec = jq_network_spec(jcfg, 47, 104), q_network_spec(cfg, 47, 104)
    jp, jt = jnets.mlp_init(jax.random.key(0), jspec), jnets.mlp_init(jax.random.key(1), jspec)
    rng = np.random.RandomState(3)
    n = flag["minibatch"]
    batch = {"state": rng.randint(-1, 40, (n, 47)).astype(np.float32), "action": rng.randint(0, 104, n),
             "reward": -rng.randint(0, 8, n).astype(np.float32),
             "next_state": rng.randint(-1, 40, (n, 47)).astype(np.float32),
             "done": (rng.rand(n) < 0.3).astype(np.float32)}
    weights = rng.rand(n).astype(np.float32)
    noise_eval, (nz1, nz2) = jlearn_noise(jcfg, jspec, jax.random.key(2))
    ns = {"jax": jax, "jnp": jnp, "q_values": jq_values, "onehot_select": jonehot_select, "dqn_cfg": jcfg,
          "spec": jspec, "target": jt, "noise_eval": noise_eval, "nz1": nz1, "nz2": nz2,
          "weights": jnp.asarray(weights),
          "batch": {k: jnp.asarray(v, jnp.int32 if k == "action" else jnp.float32) for k, v in batch.items()}}
    j_loss = _jax_lines("debug_gradflow", 73, 82, ns, "def loss_fn")["loss_fn"]
    jl, jg = jax.value_and_grad(j_loss)(jp)

    tnoise = (tnets.noise_from_jax(_np_tree(noise_eval), "cpu"),
              tuple(tnets.noise_from_jax(_np_tree(z), "cpu") for z in (nz1, nz2)))
    tbatch = {k: torch.as_tensor(v).long() if k == "action" else torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = debug_gradflow.loss_gradient(cfg, spec, params_from_jax(_np_tree(jp), "cpu"),
                                          params_from_jax(_np_tree(jt), "cpu"), tbatch, torch.as_tensor(weights),
                                          tnoise)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for t, j in zip(tree_leaves(tg), tree_leaves(params_from_jax(_np_tree(jg), "cpu"))):
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-4, atol=1e-5)
    got, want = grad_stats(tg), jgrad_stats(jg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose([got[k]["mean_abs"], got[k]["max_abs"]], [v["mean_abs"], v["max_abs"]],
                                   rtol=1e-4, atol=1e-6)


# --------------------------------------------------------- act_rollout_probe


def test_probe_structural_checks_on_k4_twin_games():
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
    from rl6nimmt_torch.ops.act_rollout_check import turn_effective_weights
    from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_plain

    cfg = EnvConfig(num_players=4)
    from rl6nimmt_torch.experiments.chain_timing import FLAGSHIP

    spec = q_network_spec(DQNConfig(**FLAGSHIP), cfg.state_length, cfg.num_actions)
    params = tnets.mlp_init(torch.Generator().manual_seed(1), spec, "cpu")
    eff = turn_effective_weights(spec, params, tnets.draw_mlp_noise(spec, torch.Generator().manual_seed(42),
                                                                    batch=(cfg.max_turns,)))
    obs, actions, rewards = (x.numpy() for x in act_rollout_plain(
        cfg, 7, 16, eff["trunk"][0]["w"], eff["trunk"][0]["b"], eff["heads"][1]["w"], eff["heads"][1]["b"]))
    assert act_rollout_probe.structural_checks(obs, actions, rewards, cfg.hand_size) == []
    bad = actions.copy()
    hand = obs[3, 5, 2, :cfg.hand_size]
    bad[3, 5, 2] = next(c for c in range(104) if c not in hand)
    fails = act_rollout_probe.structural_checks(obs, bad, rewards, cfg.hand_size)
    assert fails == ["FAIL: illegal action at t=3 (1 seats)"]
    fails = act_rollout_probe.structural_checks(obs, actions, -rewards + 1, cfg.hand_size)
    assert fails == ["FAIL: positive rewards"]


# --------------------------------------------------- micro_cycle2, bench_trainable


@pytest.mark.parametrize("row", ["micro_cycle2", "micro_cycle"])
def test_over_capacity_insert_raises_in_both(row):
    """``micro_cycle2``'s ``cap=16384, G=1024`` rows insert 40,960 transitions a
    cycle into 16,384 slots (experiments/micro_cycle2.py:80-81), ``micro_cycle``'s
    last row 163,840 into 50,000 (experiments/micro_cycle.py:80): both packages'
    insert refuses them."""
    from rl6nimmt_tpu.buffers import per_init as jper_init
    from rl6nimmt_tpu.buffers.per import per_add_batch as jper_add_batch
    from rl6nimmt_torch.buffers import per_add_batch, per_init
    from rl6nimmt_torch.experiments import micro_cycle, micro_cycle2
    from rl6nimmt_torch.experiments.chain_timing import replay_example

    cfg = EnvConfig(num_players=4)
    if row == "micro_cycle2":
        (tag, games, cap, _, _), = [r for r in micro_cycle2.ROWS if r[0].startswith("cap=16384 li=1")]
    else:
        (_, cap, _), games = micro_cycle.ROWS[-1], micro_cycle.G
    n = games * cfg.num_players * cfg.max_turns
    assert (cap, n) == ((16_384, 40_960) if row == "micro_cycle2" else (50_000, 163_840))
    example = replay_example(cfg)
    items = {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype) for k, v in example.items()}
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        per_add_batch(per_init(cap, example, "cpu"), items)
    jexample = {k: jnp.asarray(v.numpy()) for k, v in example.items()}
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        jper_add_batch(jper_init(cap, jexample), {k: jnp.asarray(v.numpy()) for k, v in items.items()})


def _jax_add_argument_calls(script):
    """``(flags, kwargs)`` of every ``parser.add_argument`` in ``experiments/<script>.py``."""
    tree = ast.parse((ROOT / "experiments" / f"{script}.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags = [ast.literal_eval(a) for a in node.args]
            kw = {k.arg: (k.value.id if isinstance(k.value, ast.Name) else ast.literal_eval(k.value))
                  for k in node.keywords if k.arg != "help"}
            out.append((flags, kw))
    return out


def test_bench_trainable_flags_and_defaults_equal_jax():
    calls = _jax_add_argument_calls("bench_trainable")
    parser = bench_trainable.make_parser()
    actions = {a.option_strings[0]: a for a in parser._actions if a.option_strings}
    assert set(actions) - {"-h", "--device"} == {flags[0] for flags, _ in calls}
    for flags, kw in calls:
        a = actions[flags[0]]
        assert a.default == kw.get("default", False if kw.get("action") == "store_true" else None), flags
        assert (a.type.__name__ if a.type else None) == kw.get("type"), flags
        assert a.choices == kw.get("choices"), flags
        assert (kw.get("action") == "store_true") == (a.const is True and a.nargs == 0), flags
    assert parser.parse_args([]).learners == "reinforce,dqn,acer"
