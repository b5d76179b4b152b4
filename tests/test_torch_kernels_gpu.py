"""K1-K7 on the card vs their plain twins (marked ``gpu``; skip without a card).

Run on a machine with an NVIDIA card: ``python -m pytest tests/ -m gpu -q``.
"""

import pytest
import torch

from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec
from rl6nimmt_torch.buffers import per_init, per_init_kd
from rl6nimmt_torch.experiments import act_rollout_ablate as ablate
from rl6nimmt_torch.experiments.probe_ops import compare, probe_inputs, probes
from rl6nimmt_torch.engine import EnvConfig, deal, observe, step
from rl6nimmt_torch.nets import draw_mlp_noise, mlp_init
from rl6nimmt_torch.ops import _build
from rl6nimmt_torch.ops.act_rollout_check import (
    greedy_replay_agreement,
    insert_planes_agreement,
    insert_twin_agreement,
    turn_effective_weights,
)
from rl6nimmt_torch.ops.act_ablate_kernel import ablate_twin_agreement, make_act_ablate_kernel
from rl6nimmt_torch.ops.act_rollout_kernel import S_PAD, SCAL_ROWS, act_rollout_plain, make_act_rollout_kernel
from rl6nimmt_torch.ops.game_kernel import (
    deal_games,
    deal_games_plain,
    play_random_games,
    play_random_games_plain,
)
from rl6nimmt_torch.ops.step_kernel import resolve_turn, resolve_turn_plain, resolve_turn_t, resolve_turn_t_plain
from rl6nimmt_torch.runtime.vector import (dqn_replay_example, make_dqn_selfplay_step,
                                           make_random_rollout_generations)

pytestmark = pytest.mark.gpu

FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10,
                hidden_sizes=(64,), minibatch=64)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("num_players,G", [(4, 4096), (2, 1000), (6, 129)])
def test_k1_resolve_turn_matches_twin(num_players, G):
    dev = _cuda()
    cfg = EnvConfig(num_players)
    state = deal(cfg, 3, G, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(cfg.max_turns):
        hs = state.hands_sorted
        r = torch.floor(torch.rand(hs.shape[:2], generator=gen, device=dev) * (hs >= 0).sum(-1)).long()
        acts = torch.gather(hs, -1, r[..., None]).squeeze(-1).contiguous()
        out_k = resolve_turn(cfg, state.board, state.row_len, acts)
        out_p = resolve_turn_plain(cfg, state.board, state.row_len, acts)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)
        state, _ = step(cfg, state, acts)


def _k1_both_layouts(cfg, G, dev, misaligned=False):
    """Play random turns; at each, K1 in both layouts must equal both twins
    and each other.  ``misaligned``: the row-major inputs start 4 bytes past a
    16-byte boundary, so the kernel takes its 4-byte loads."""
    R, T = cfg.num_rows, cfg.threshold
    state = deal(cfg, 3, G, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(cfg.max_turns):
        hs = state.hands_sorted
        r = torch.floor(torch.rand(hs.shape[:2], generator=gen, device=dev) * (hs >= 0).sum(-1)).long()
        acts = torch.gather(hs, -1, r[..., None]).squeeze(-1).contiguous()
        board, row_len = state.board, state.row_len
        if misaligned:
            board, row_len, acts = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
                                    for x in (board, row_len, acts))
        out_k = resolve_turn(cfg, board, row_len, acts)
        for a, b in zip(out_k, resolve_turn_plain(cfg, board, row_len, acts)):
            assert torch.equal(a, b)
        board_t, len_t = board.reshape(G, R * T).T.contiguous(), row_len.T.contiguous()
        out_t = resolve_turn_t(cfg, board_t, len_t, acts)
        for a, b, c in zip(out_t, resolve_turn_t_plain(cfg, board_t, len_t, acts),
                           (out_k[0].reshape(G, R * T).T, out_k[1].T, out_k[2].T)):
            assert torch.equal(a, b) and torch.equal(a, c)
        state, _ = step(cfg, state, acts)


@pytest.mark.parametrize("G", [1, 31, 33, 4095])
@pytest.mark.parametrize("num_players", range(2, 11))
def test_k1_both_layouts_match_twins(num_players, G):
    _k1_both_layouts(EnvConfig(num_players), G, _cuda())


@pytest.mark.parametrize("shape,num_players,G,misaligned", [
    ("most_smem", 16, 129, False),       # the largest P, R and T the wrapper accepts
    ("long_rows", 7, 4095, False), ("default", 4, 1000, True)])
def test_k1_largest_shape_and_misaligned_inputs(shape, num_players, G, misaligned):
    _k1_both_layouts(EnvConfig(num_players, **SHAPES[shape]), G, _cuda(), misaligned)


def test_k1_launches_on_the_current_stream():
    dev = _cuda()
    cfg = EnvConfig(4)
    s = deal(cfg, 5, 4096, device=dev)
    acts = s.hands_sorted[:, :, 0].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.stream_reader()(dev.index or 0) == side.cuda_stream
        out = resolve_turn(cfg, s.board, s.row_len, acts)
    side.synchronize()
    for a, b in zip(out, resolve_turn_plain(cfg, s.board, s.row_len, acts)):
        assert torch.equal(a, b)


def test_games_last_rollout_matches_fused_on_card():
    dev = _cuda()
    cfg = EnvConfig(4)
    _build.reset_launches()
    games_last = make_random_rollout_generations(cfg, 4096, 2, games_last=True, device=dev)(17)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 2, "resolve_turn_t": 20}
    fused = make_random_rollout_generations(cfg, 4096, 2, fused=True, device=dev)(17)
    assert torch.equal(games_last[0], fused[0]) and float(games_last[1]) == float(fused[1])


def _flagship_weights(dev, G=4096):
    cfg, dqn = EnvConfig(4), DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = mlp_init(gen, spec)
    noise = draw_mlp_noise(spec, gen, batch=(cfg.max_turns,))
    return cfg, dqn, spec, params, noise


def _k4_args(dev, cfg, hidden):
    """K4's per-turn effective weights (w1, b1, wa, ba) of a flagship net of width ``hidden``."""
    dqn = DQNConfig(**{**FLAGSHIP, "hidden_sizes": (hidden,)})
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = mlp_init(gen, spec)
    eff = turn_effective_weights(spec, params, draw_mlp_noise(spec, gen, batch=(cfg.max_turns,)))
    return tuple(x.contiguous() for x in (eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                          eff["heads"][1]["w"], eff["heads"][1]["b"]))


# Game shapes beside the default 6 nimmt! deck: the summaries off; a 127-card deck
# (12 seats); the longest observation the kernels accept (S = 105, 7 seats); the
# shape whose play loop needs the most shared memory (16 seats of 7 cards, S = 96).
SHAPES = {"default": {}, "no_summaries": dict(include_summaries=False), "deck_127": dict(num_cards=127),
          "long_rows": dict(num_rows=8, threshold=8, hand_size=16, num_cards=127),
          "most_smem": dict(num_rows=8, threshold=8, hand_size=7, num_cards=125)}

# K2/K3 cases: (P, G, shape).  Every seat count the 104-card deck deals (P = 10
# fills it) at G ragged against the 32 games of a block; the extreme shapes,
# which run the runtime-sized instances; 4x the flagship's games; and the
# earlier fixed cases.
GAME_CASES = [(P, G, "default") for P in range(2, 11) for G in (1, 31, 33, 4095)] + [
    (12, 129, "deck_127"), (7, 4095, "long_rows"), (16, 129, "most_smem"), (4, 300, "no_summaries"),
    (4, 16_384, "default"), (4, 4096, "default"), (6, 333, "default"), (3, 777, "default")]


@pytest.mark.parametrize("num_players,G,shape", GAME_CASES)
def test_k2_deal_matches_twin(num_players, G, shape):
    dev = _cuda()
    cfg = EnvConfig(num_players, **SHAPES[shape])
    for a, b in zip(deal_games(cfg, 2**40 + 5, G, device=dev), deal_games_plain(cfg, 2**40 + 5, G, dev)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("num_players,G,shape", GAME_CASES)
def test_k3_random_games_match_twin(num_players, G, shape):
    dev = _cuda()
    cfg = EnvConfig(num_players, **SHAPES[shape])
    rk, ck = play_random_games(cfg, 11, G, device=dev)
    rp, cp = play_random_games_plain(cfg, 11, G, dev)
    assert torch.equal(rk, rp) and torch.equal(ck, cp)


def test_k2_k3_launch_on_the_current_stream():
    dev = _cuda()
    cfg = EnvConfig(4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dealt = deal_games(cfg, 8, 4096, device=dev)
        played = play_random_games(cfg, 9, 4096, device=dev)
    side.synchronize()
    for a, b in zip(dealt, deal_games_plain(cfg, 8, 4096, dev)):
        assert torch.equal(a, b)
    for a, b in zip(played, play_random_games_plain(cfg, 9, 4096, dev)):
        assert torch.equal(a, b)


# G ragged against the 32 games of a block; hidden widths of one 64-unit chunk (64),
# part of one (32), two (100) and four (256); the widest net at the most seats of
# each deck.
K4_CASES = [(P, G, hidden, "default") for P, G in [(4, 4096), (2, 1000), (6, 129), (4, 33)]
            for hidden in (64, 32, 100, 256)] + [
    (4, 1000, 64, "no_summaries"), (10, 1000, 256, "default"), (12, 129, 256, "deck_127"),
    (7, 129, 256, "long_rows"), (16, 129, 256, "most_smem")]


@pytest.mark.parametrize("num_players,G,hidden,shape", K4_CASES)
def test_k4_act_rollout_matches_twin(num_players, G, hidden, shape):
    dev = _cuda()
    cfg = EnvConfig(num_players, **SHAPES[shape])
    args = _k4_args(dev, cfg, hidden)
    ok, ak, rk = make_act_rollout_kernel(cfg, G, hidden)(21, *args)
    op, ap, rp = act_rollout_plain(cfg, 21, G, *args)
    assert torch.equal(ok[0], op[0])                        # same deals
    agree = (ak == ap).all(dim=(0, 2))                      # games whose actions all agree
    assert (ak == ap).float().mean().item() >= 0.999
    assert torch.equal(ok[:, agree], op[:, agree]) and torch.equal(rk[:, agree], rp[:, agree])


def test_greedy_replay_agreement_on_card():
    dev = _cuda()
    cfg, dqn, spec, params, noise = _flagship_weights(dev)
    action_agree, score_agree = greedy_replay_agreement(cfg, dqn, spec, params, 4096, 5, noise)
    assert action_agree >= 0.999 and score_agree >= 0.999


@pytest.mark.parametrize("kernel_act_rollout", [False, True])
def test_flagship_cycle_runs_through_the_kernels(kernel_act_rollout):
    dev = _cuda()
    cfg, dqn, spec, params, _ = _flagship_weights(dev)
    adam = Adam(1e-3)
    buf = per_init(200_000, dqn_replay_example(cfg), device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, 1024, learn_iters=8,
                                   kernel_act_rollout=kernel_act_rollout, device=dev)
    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(1)
    p, t, o, buf, m = cycle(params, params, adam.init(params), buf, gen, 0.0)
    assert bool(torch.isfinite(m["loss"]))
    used = ("act_rollout",) if kernel_act_rollout else ("deal_games", "resolve_turn")
    for name in used:
        assert _build.LAUNCHES[name] > 0
    o0, _ = observe(cfg, deal(cfg, 1, 8, device=dev))
    assert o0.shape == (8, 4, 47)


# (P, G, hidden, capacity, ptr): the flagship shapes with a ptr whose tile regions
# wrap past the ring end; two seats with 1280 games (10 tiles, wrapping too); width
# 32; ten seats at width 256 (wrapping too).
K5_CASES = [(4, 4096, 64, 204_800, 163_840), (2, 1280, 64, 38_400, 25_600), (4, 4096, 32, 204_800, 163_840),
            (10, 1280, 256, 128_000, 64_000)]


@pytest.mark.parametrize("num_players,G,hidden,capacity,ptr", K5_CASES)
def test_k5_act_insert_matches_twin(num_players, G, hidden, capacity, ptr):
    dev = _cuda()
    cfg = EnvConfig(num_players)
    args = _k4_args(dev, cfg, hidden)
    agree, games, err = insert_twin_agreement(cfg, G, hidden, capacity, ptr, 31, args)
    assert agree >= 0.999 and games >= G * 0.99 and err == 0.0


def test_insert_planes_agreement_on_card():
    dev = _cuda()
    cfg, dqn, spec, params, noise = _flagship_weights(dev)
    assert insert_planes_agreement(cfg, dqn, spec, params, 4096, 204_800, 9, 163_840, noise) <= 1e-3


def test_kernel_insert_cycle_runs_through_k5():
    dev = _cuda()
    cfg, dqn, spec, params, _ = _flagship_weights(dev)
    adam = Adam(1e-3)
    buf = per_init_kd(204_800, S_PAD, SCAL_ROWS, device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, 1024, learn_iters=8, kernel_insert=True, device=dev)
    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(1)
    p, t, o = params, params, adam.init(params)
    for _ in range(2):
        p, t, o, buf, m = cycle(p, t, o, buf, gen, 0.0)
        assert bool(torch.isfinite(m["loss"]))
    assert _build.LAUNCHES["act_insert"] == 2
    assert (buf.ptr, buf.size) == (2 * 40 * 1024, 2 * 40 * 1024)


# (variant, G, P, hidden, shape): the ablation's own configuration, then mm's
# A-wide head at width 256 with six seats, on the 127-card deck with twelve, and at
# the shape that needs the most shared memory.
K6_CASES = [("env", 4096, 4, 64, "default"), ("obs", 4096, 4, 64, "default"), ("mm", 4096, 4, 64, "default"),
            ("obs", 333, 4, 64, "default"), ("mm", 1000, 6, 256, "default"), ("mm", 129, 12, 256, "deck_127"),
            ("mm", 129, 16, 256, "most_smem")]


@pytest.mark.parametrize("variant,G,num_players,hidden,shape", K6_CASES)
def test_k6_ablation_matches_twin(variant, G, num_players, hidden, shape):
    """env and obs bit-exact; mm at action agreement >= 0.999 with equal deals,
    observations and rewards in the games that agree."""
    dev = _cuda()
    cfg = EnvConfig(num_players, **SHAPES[shape])
    w = ablate.weights(cfg, dev, hidden)
    agree, games, err = ablate_twin_agreement(cfg, variant, G, hidden, 13, w)
    assert agree >= 0.999 and err == 0.0
    if variant != "mm":
        assert agree == 1.0 and games == G


def test_k6_env_plays_k3s_games():
    dev = _cuda()
    cfg = ablate.config()
    _, actions, rewards = make_act_ablate_kernel(cfg, 4096, 64, "env")(29, *ablate.weights(cfg, dev))
    assert torch.equal(rewards.sum(dim=0), play_random_games(cfg, 29, 4096, device=dev)[0])


def test_k6_ablation_entry_point_counts_its_launches():
    dev = _cuda()
    _build.reset_launches()
    for v in ("env", "obs", "mm", "full"):
        assert int(ablate.build(v, device=dev, games=256, chain=2)(3)) != 0
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "act_ablate_env": 2, "act_ablate_obs": 2, "act_ablate_mm": 2, "act_rollout": 2}


# K7's bodies off the probe shapes: ragged blocks, rows that allow no 16-byte
# access, a transpose of more input rows than one panel holds, inputs at a
# 4-byte offset.
K7_SHAPES = [("dot_lhs_t", (47, 131), (47, 64)), ("dot_lhs_t", (300, 37), (300, 64)),
             ("dot_3d", (5, 3, 7), (5, 64)), ("transpose_2d", (300, 50), None), ("transpose_2d", (7, 13), None),
             ("transpose_3d", (47, 3, 5), None), ("transpose_3d", (260, 2, 9), None), ("argmax_rows", (5000, 103), None),
             ("argmax_rows", (33, 8), None), ("reshape_rows", (1027,), 13), ("reshape_rows", (4096,), 4)]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("fn,shape,other", K7_SHAPES)
def test_k7_bodies_at_other_shapes(fn, shape, other, misaligned):
    from rl6nimmt_torch.ops import probe_ops

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)

    def tensor(shape, dtype):
        n = 1
        for d in shape:
            n *= d
        flat = (torch.randn(n + 1, generator=gen, device=dev) * 50).to(dtype)
        return (flat[1:] if misaligned else flat[:n]).view(shape)

    x = tensor(shape, torch.int32 if fn in ("transpose_2d", "reshape_rows") else torch.float32)
    args = (x, tensor(other, torch.float32)) if fn.startswith("dot") else (x, other) if fn == "reshape_rows" else (x,)
    ok, diff = compare(getattr(probe_ops, fn)(*args), getattr(probe_ops, f"{fn}_plain")(*args),
                       exact=not fn.startswith("dot"))
    assert ok, f"{fn} {shape}: max|diff| {diff}"


@pytest.mark.parametrize("key", [f"k{i}" for i in range(1, 8)])
def test_k7_probe_matches_twin(key):
    dev = _cuda()
    _build.reset_launches()
    (_, label, kernel, twin, args, exact), = [p for p in probes(probe_inputs(dev)) if p[0] == key]
    ok, diff = compare(kernel(*args), twin(*args), exact)
    assert ok, f"{key} {label}: max|diff| {diff}"
    assert _build.LAUNCHES[f"probe_{key}"] == 1
