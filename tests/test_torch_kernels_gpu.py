"""K1-K7 on the card vs their plain twins (marked ``gpu``; skip without a card).

Run on a machine with an NVIDIA card: ``python -m pytest tests/ -m gpu -q``.
"""

import math
import re

import numpy as np
import pytest
import torch

from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec
from rl6nimmt_torch.buffers import per_init, per_init_aligned_fm, per_init_fm, per_init_kd
from rl6nimmt_torch.experiments import act_rollout_ablate as ablate
from rl6nimmt_torch.experiments.probe_ops import compare, probe_inputs, probes
from rl6nimmt_torch.engine import EnvConfig, deal, observe, step
from rl6nimmt_torch.nets import draw_mlp_noise, mlp_init
from rl6nimmt_torch.ops import _build, policy_mlp
from rl6nimmt_torch.ops.act_rollout_check import (
    fm_agreement,
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


# K4's feature-major emit: the flagship games, a ragged last block (4000 = 125 blocks
# of 32) and one game past a block (33), at one chunk of the hidden layer and four.
K4_FM_CASES = [(G, hidden) for G in (4096, 4000, 33) for hidden in (64, 256)]


@pytest.mark.parametrize("G,hidden", K4_FM_CASES)
def test_k4_fm_matches_row_major_and_twin(G, hidden):
    """K4 feature-major == K4 row-major permuted, bit for bit; against its twin
    (the row-major twin permuted) equal in every game whose actions agree."""
    from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_fm_plain

    dev = _cuda()
    cfg = EnvConfig(4)
    T, P, S = cfg.max_turns, cfg.num_players, cfg.state_length
    args = _k4_args(dev, cfg, hidden)
    fm_agreement(cfg, G, hidden, 23, args)
    ok, ak, rk = make_act_rollout_kernel(cfg, G, hidden, feature_major=True)(23, *args)
    op, ap, rp = act_rollout_fm_plain(cfg, 23, G, *args)
    assert ok.shape == (S, (T + 1) * P, G) and ak.shape == rk.shape == (T * P, G)
    assert torch.equal(ok[:, :P], op[:, :P])                # same deals: the t = 0 observations
    agree = (ak == ap).all(dim=0)
    assert (ak == ap).float().mean().item() >= 0.999
    assert torch.equal(ok[..., agree], op[..., agree]) and torch.equal(rk[:, agree], rp[:, agree])


@pytest.mark.parametrize("offset", [1, 5, 16])
def test_k4_fm_entry_writes_misaligned_outputs(offset):
    """The feature-major entry stores bytes and ints one a lane, so outputs
    that start ``offset`` bytes (obs) or ints (actions, rewards) past an
    aligned address get the same values (G = 4000: a ragged last block)."""
    from rl6nimmt_torch.ops.act_rollout_kernel import _ROLLOUT_FM

    dev = _cuda()
    cfg, G, hidden = EnvConfig(4), 4000, 64
    T, P, S = cfg.max_turns, cfg.num_players, cfg.state_length
    args = _k4_args(dev, cfg, hidden)
    want = make_act_rollout_kernel(cfg, G, hidden, feature_major=True)(29, *args)
    raw_obs = torch.full((S * (T + 1) * P * G + offset,), -7, dtype=torch.int8, device=dev)
    raw_act = torch.full((T * P * G + offset,), -7, dtype=torch.int32, device=dev)
    raw_rew = torch.full((T * P * G + offset,), -7, dtype=torch.int32, device=dev)
    _ROLLOUT_FM(dev.index or 0, 29, *(x.data_ptr() for x in args), raw_obs[offset:].data_ptr(),
                raw_act[offset:].data_ptr(), raw_rew[offset:].data_ptr(), G, P, cfg.num_rows, cfg.threshold,
                cfg.hand_size, cfg.num_cards, hidden, T, int(cfg.include_summaries))
    torch.cuda.synchronize()
    for raw, w in zip((raw_obs, raw_act, raw_rew), want):
        assert bool((raw[:offset] == -7).all())
        assert torch.equal(raw[offset:].view(w.shape), w)


@pytest.mark.parametrize("aligned", [False, True], ids=["kernel_fm", "kernel_fm_aligned"])
def test_fm_cycle_runs_through_k4_fm(aligned):
    dev = _cuda()
    cfg, dqn, spec, params, _ = _flagship_weights(dev)
    adam = Adam(1e-3)
    G, cap = 1024, 200_000
    block = G * cfg.max_turns * cfg.num_players
    example = dqn_replay_example(cfg)
    buf = per_init_aligned_fm(cap, block, example, device=dev) if aligned else per_init_fm(cap, example, device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, G, learn_iters=8, kernel_act_rollout=True, feature_major=True,
                                   per_aligned_capacity=cap if aligned else None, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    p, t, o = params, params, adam.init(params)
    for c in range(2):
        _build.reset_launches()
        p, t, o, buf, m = cycle(p, t, o, buf, gen, 0.0, c * 8)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"act_rollout_fm": 1}
        assert bool(torch.isfinite(m["loss"]))
    assert (buf.size, buf.ptr) == (min(2 * block, cap), 2 * block % buf.capacity)


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
# the shape that needs the most shared memory; then env and obs on their
# runtime-sized instance (six seats at G ragged against the 32 games of a block,
# sixteen at the largest stage, twelve on the 127-card deck, six without
# summaries) and on the flagship one without summaries (S = 35).
K6_CASES = [("env", 4096, 4, 64, "default"), ("obs", 4096, 4, 64, "default"), ("mm", 4096, 4, 64, "default"),
            ("obs", 333, 4, 64, "default"), ("mm", 1000, 6, 256, "default"), ("mm", 129, 12, 256, "deck_127"),
            ("mm", 129, 16, 256, "most_smem")] + [
    (v, G, P, 64, shape) for v in ("env", "obs")
    for G, P, shape in [(1, 6, "default"), (31, 6, "default"), (33, 6, "default"), (333, 6, "default"),
                        (129, 16, "most_smem"), (129, 12, "deck_127"), (333, 6, "no_summaries"),
                        (33, 4, "no_summaries")]]


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


@pytest.mark.parametrize("num_players,G", [(4, 4096), (6, 333)])
def test_k6_env_plays_k3s_games(num_players, G):
    """At the flagship shape and on the runtime-sized instances of both kernels."""
    dev = _cuda()
    cfg = EnvConfig(num_players)
    _, actions, rewards = make_act_ablate_kernel(cfg, G, 64, "env")(29, *ablate.weights(cfg, dev))
    assert torch.equal(rewards.sum(dim=0), play_random_games(cfg, 29, G, device=dev)[0])


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


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("A", [1, 103, 200])
def test_k7_masked_argmax_edges_match_twin(A, misaligned):
    """k7 at 1,027 rows (a ragged block) against its literal twin, on hands out
    of range and masked values at, below and above -1e9 and NaN."""
    from rl6nimmt_torch.experiments.probe_ops import k7_edge_inputs
    from rl6nimmt_torch.ops.probe_ops import dot_mask_argmax, dot_mask_argmax_plain

    dev = _cuda()
    h, wa, hand = k7_edge_inputs(A, dev, misaligned)
    assert (h.data_ptr() % 16 != 0) == misaligned
    _build.reset_launches()
    got = dot_mask_argmax(h, wa, hand)
    assert _build.LAUNCHES["probe_k7"] == 1
    assert torch.equal(got, dot_mask_argmax_plain(h, wa, hand))


# ------------------------------------------------------------ the search path


@pytest.mark.parametrize("root", ["uniform", "puct"])
@pytest.mark.parametrize("K", [8, 32])
@pytest.mark.parametrize("G", [1, 8, 64])
def test_search_decision_on_card_equals_cpu(G, K, root):
    """A decision block on uniform playouts (K1 every playout turn) equals the
    same block on the CPU given the same noise: actions, sums and counts."""
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.runtime.search_check import card_against_cpu

    _cuda()
    cfg = EnvConfig(4)
    _build.reset_launches()
    out = card_against_cpu(cfg, MLPSpec(cfg.state_length + 1), root, G, K, 40, seed=G + K)
    assert out["equal"], (out["card"][0], out["cpu"][0])
    assert (out["card"][2].sum(dim=1) == 40).all()
    # One decision: two rounds of ten turns, or five at K = 8.
    assert _build.LAUNCHES["resolve_turn"] == -(-40 // min(K, 40)) * cfg.hand_size


@pytest.mark.parametrize("root", ["uniform", "puct"])
@pytest.mark.parametrize("players,games", [(2, 128), (4, 64)])
def test_search_at_match_shapes_on_card_equals_cpu(players, games, root):
    """The matches' shapes: K2 deals ``games`` games of ``players`` seats (the
    runtime-sized instance at P = 2) and K1 resolves their 8 x ``games`` playouts."""
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.runtime.search_check import card_against_cpu

    _cuda()
    cfg = EnvConfig(players)
    out = card_against_cpu(cfg, MLPSpec(cfg.state_length + 1), root, games, 8, 16, seed=players)
    assert out["equal"], (out["card"][0], out["cpu"][0])


@pytest.mark.parametrize("roster", [("puct", "uniform"), ("puct", "policy", "uniform", "random")])
def test_device_match_launches(roster):
    """A match launches K2 once and K1 once for every match turn and every
    playout turn; each net seat (puct, policy) launches policy_mlp once a
    decision for its root and once a playout turn; nothing else launches and
    no policy forward falls back to the plain ops."""
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.runtime.device_match import make_device_match_fn, playout_turns_per_seat

    dev = _cuda()
    cfg = EnvConfig(len(roster))
    spec = MLPSpec(cfg.state_length + 1)
    params = mlp_init(torch.Generator(device=dev).manual_seed(0), spec)
    fn = make_device_match_fn(cfg, roster, spec, num_games=16, mc_max=24, device=dev)
    _build.reset_launches()
    policy_mlp.FALLBACKS["policy_mlp"] = 0
    scores = fn(tuple(params if k in ("puct", "policy") else None for k in roster),
                torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    searchers = sum(k != "random" for k in roster)
    nets = sum(k in ("puct", "policy") for k in roster)
    want = {"deal_games": 1, "resolve_turn": cfg.max_turns + searchers * playout_turns_per_seat(cfg, 24),
            "policy_mlp": nets * (cfg.max_turns + playout_turns_per_seat(cfg, 24))}
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    assert policy_mlp.FALLBACKS["policy_mlp"] == 0
    assert scores.shape == (16, len(roster)) and (scores <= 0).all()


def test_argmax_first_maximum_on_card():
    """The decisions' tie rule: ``torch.argmax`` keeps the first maximum on the card too."""
    from rl6nimmt_torch.agents.device_search import _best

    dev = _cuda()
    x = torch.zeros((64, 1000), device=dev)
    x[:, 500:] = 1.0
    x[torch.arange(64), torch.arange(64) + 600] = 2.0
    x[::2, 999] = 2.0
    assert torch.equal(torch.argmax(x, dim=-1).cpu(), torch.arange(64) + 600)
    act_sum = torch.tensor([[-4.0, -2.0, -2.0, 0.0], [-1.0, -1.0, -1.0, -1.0]], device=dev)
    act_cnt = torch.tensor([[2.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 1.0]], device=dev)
    assert _best(act_sum, act_cnt).tolist() == [0, 0]


# ------------------------------------------------------- REINFORCE and ACER


@pytest.mark.parametrize("G", [4096, 64])
def test_learner_path_k1_k2_match_twins(G):
    """K2 and K1 at the learners' shapes (P = 4, the flagship instances), on
    the deals and the turns of a REINFORCE rollout: each turn's K1 output
    equals its twin's on the same board and actions."""
    from rl6nimmt_torch.agents.reinforce import action_in_input_logits
    from rl6nimmt_torch.agents.search import draw_gumbel
    from rl6nimmt_torch.nets import MLPSpec

    dev = _cuda()
    cfg = EnvConfig(4)
    for a, b in zip(deal_games(cfg, 11, G, device=dev), deal_games_plain(cfg, 11, G, dev)):
        assert torch.equal(a, b)
    spec = MLPSpec(cfg.state_length + 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = mlp_init(gen, spec)
    state = deal(cfg, 11, G, device=dev)
    for _ in range(cfg.max_turns):
        obs, _ = observe(cfg, state)
        logits = action_in_input_logits(spec, params, obs, state.hands_sorted)
        idx = torch.argmax(logits + draw_gumbel(gen, logits.shape, dev), dim=-1)
        acts = torch.gather(state.hands_sorted, -1, idx[..., None]).squeeze(-1).contiguous()
        for a, b in zip(resolve_turn(cfg, state.board, state.row_len, acts),
                        resolve_turn_plain(cfg, state.board, state.row_len, acts)):
            assert torch.equal(a, b)
        state, _ = step(cfg, state, acts)


def test_learners_on_card_equal_cpu():
    """One REINFORCE step and one ACER cycle at G = 64 on the card and on the
    CPU on one randomness (``runtime/learner_check.py``)."""
    from rl6nimmt_torch.runtime.learner_check import learners_card_against_cpu

    _cuda()
    out = learners_card_against_cpu(64)
    assert out["equal"], ({k: v for k, v in out["exact"].items() if not v},
                          {k: v for k, v in out["f32"].items() if v > 1.0})


@pytest.mark.parametrize("learner", ["reinforce", "acer"])
def test_learner_step_launches_k2_once_and_k1_ten_times(learner):
    from rl6nimmt_torch.experiments.trainable_bench import AcerArm, ReinforceArm

    dev = _cuda()
    cfg = EnvConfig(4)
    arm = ReinforceArm(cfg, 256, dev) if learner == "reinforce" else AcerArm(cfg, 256, dev)
    _build.reset_launches()
    metrics = arm.step()
    torch.cuda.synchronize()
    # REINFORCE's policy forward is one policy_mlp launch a turn; ACER's two heads run the plain ops.
    policy = {"policy_mlp": cfg.max_turns} if learner == "reinforce" else {}
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": cfg.max_turns,
                                                                **policy}
    assert all(torch.isfinite(v).all() for v in metrics.values())


# ------------------------------------------------------------- the tournament


def test_tournament_block_on_card_equals_cpu():
    """Eight games at P = 4 seating every family, on the card and on the CPU
    on one noise (``runtime/tournament_check.py``); then K1 against its twin on
    the block's own turns and K2 on its deal."""
    from rl6nimmt_torch.runtime.tournament_check import tournament_card_against_cpu

    dev = _cuda()
    out = tournament_card_against_cpu()
    assert out["equal"], ({k: v for k, v in out["exact"].items() if not v},
                          {k: v for k, v in out["f32"].items() if v > 1.0})
    cfg, seed, games = out["deal"]
    for a, b in zip(deal_games(cfg, seed, games, device=dev), deal_games_plain(cfg, seed, games, "cpu")):
        assert torch.equal(a.cpu(), b)
    for board, row_len, acts in out["k1_inputs"]:
        got = resolve_turn(cfg, board.to(dev), row_len.to(dev), acts.to(dev))
        for a, b in zip(got, resolve_turn_plain(cfg, board, row_len, acts)):
            assert torch.equal(a.cpu(), b)


def test_wrapper_launches_k2_a_reset_and_k1_a_step():
    from rl6nimmt_torch.engine.wrapper import SechsNimmtEnv

    _cuda()
    env = SechsNimmtEnv(4, seed=3)
    _build.reset_launches()
    _, legal = env.reset()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1}
    done = False
    while not done:
        (_, legal), rewards, done, _ = env.step([hand[0] for hand in legal])
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": 10}
    assert (env.scores >= 0).all()


@pytest.mark.parametrize("K", [8, 32])
def test_device_block_launches(K):
    """A block launches K2 once and K1 once a game turn and once a playout turn
    of every search call: the seats without a net (random, MCS) and each
    PUCT agent decide in one call each, ceil(n_mc / K) rounds of n turns.  The
    PUCT agent's call launches policy_mlp once for its roots and once a
    playout turn; no policy forward falls back to the plain ops."""
    from rl6nimmt_torch import agents as tag
    from rl6nimmt_torch.runtime.device_tournament import DeviceBlockSession

    _cuda()
    kw = dict(mc_max=16, mc_per_card=10)
    rnd, mcs = tag.DrunkHamster(seed=0), tag.MCSAgent(seed=1, **kw)
    puct = tag.PUCTAgent(seed=2, batch_playouts=K, **kw)
    dqn = tag.Noisy_D3QN(seed=3)
    session = DeviceBlockSession([[rnd, mcs, puct], [mcs, puct, dqn], [puct, rnd, dqn]] * 4, batch=K)
    _build.reset_launches()
    policy_mlp.FALLBACKS["policy_mlp"] = 0
    session.dispatch()
    torch.cuda.synchronize()
    rounds = lambda n: -(-min(16, 10 * math.factorial(n)) // K)
    playout_turns = sum(rounds(n) * n for n in range(1, 11))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": 10 + 2 * playout_turns,
                                                                "policy_mlp": 10 + playout_turns}
    assert policy_mlp.FALLBACKS["policy_mlp"] == 0
    scores = session.finalize()
    assert len(scores) == 12 and all((s <= 0).all() for s in scores)


# ------------------------------------------- device learner updates, the arena


def _learners(kind, dev):
    from rl6nimmt_torch import agents as tag

    hid = (16,)
    if kind == "ring":
        agents = [tag.DQNVanilla(seed=11, minibatch=8, hidden_sizes=hid, device=dev),
                  tag.BatchedReinforceAgent(seed=12, hidden_sizes=hid, device=dev),
                  tag.MaskedReinforceAgent(seed=13, hidden_sizes=hid, device=dev)]
    else:
        agents = [tag.DQN_PRBAgent(seed=31, minibatch=8, history_length=64, hidden_sizes=hid, device=dev),
                  tag.Noisy_D3QN_PRB_NStep(seed=32, minibatch=8, n_steps=3, history_length=64, hidden_sizes=hid,
                                           device=dev),
                  tag.BatchedACERAgent(seed=33, hidden_sizes=hid, warmup=2, minibatch=3, device=dev)]
    for a in agents:
        a.train()
    return agents


@pytest.mark.parametrize("kind", ["ring", "per"])
def test_device_learning_on_card_matches_host_replay(kind):
    """Two blocks of 6 games on the card, learned on the host and on the device:
    ring DQN and both REINFORCE variants bit for bit, PER and ACER within the
    CPU test's tolerances, with no planner's replay waiting for the card."""
    from rl6nimmt_torch.agents.dqn import tree_leaves
    from rl6nimmt_torch.runtime import device_learn as dl
    from rl6nimmt_torch.runtime.device_tournament import DeviceBlockSession

    dev = _cuda()
    runs = {}
    for device_learning in (False, True):
        agents = _learners(kind, dev)
        np.random.seed(77)
        originals = {p: p.dispatch for p in (dl.DQNPlanner, dl.ACERPlanner, dl.ReinforcePlanner)}

        def unsynced(dispatch):
            def run(self):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return dispatch(self)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return run

        for p, d in originals.items():
            p.dispatch = unsynced(d)
        try:
            for _ in range(2):
                DeviceBlockSession([list(agents)] * 6, device_learning=device_learning).play()
        finally:
            for p, d in originals.items():
                p.dispatch = d
        runs[device_learning] = agents
    for h, d in zip(runs[False], runs[True]):
        assert h.opt_state.count == d.opt_state.count > 0
        tol = ({"rtol": 2e-2, "atol": 1e-4} if type(h).__name__ == "BatchedACERAgent"
               else {"rtol": 1e-4, "atol": 1e-6} if kind == "per" else {"rtol": 0.0, "atol": 0.0})
        for x, y in zip(tree_leaves(h.params), tree_leaves(d.params)):
            torch.testing.assert_close(y, x, **tol)


def test_arena_launches_and_card_equals_cpu():
    """``play_match`` launches K2 once and K1 once a turn, and the card plays
    the CPU's games on one injected noise."""
    from rl6nimmt_torch import agents as tag
    from rl6nimmt_torch.runtime import play_match, seat_policy_of
    from rl6nimmt_torch.runtime.arena import ArenaNoise, draw_seat

    dev = _cuda()
    agents = [tag.DrunkHamster(seed=0, device=dev), tag.Noisy_D3QN_PRB_NStep(seed=1, device=dev),
              tag.BatchedACERAgent(seed=2, device=dev), tag.BatchedReinforceAgent(seed=3, device=dev)]
    for lineup in (agents, agents[2:]):
        _build.reset_launches()
        policy_mlp.FALLBACKS["policy_mlp"] = 0
        scores = play_match(lineup, 4096, seed=5, device=dev)
        torch.cuda.synchronize()
        # The REINFORCE seat's forward is one policy_mlp launch a turn; the ACER seat's two heads fall back.
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": 10,
                                                                    "policy_mlp": 10}
        assert policy_mlp.FALLBACKS["policy_mlp"] == 10
        assert scores.shape == (4096, len(lineup)) and (scores <= 0).all()
    gen = torch.Generator().manual_seed(6)
    noise = ArenaNoise(deal_seed=int(torch.randint(0, 2**62, (1,), generator=gen)),
                       turns=[[draw_seat(seat_policy_of(a)[0], gen, 64, 10) for a in agents] for _ in range(10)])
    np.testing.assert_array_equal(play_match(agents, 64, device=dev, noise=noise),
                                  play_match(agents, 64, device="cpu", noise=noise))


# ------------------------------------------------- data parallel and host extras


def _nccl_world_of_one(tmp_path):
    import torch.distributed as dist
    from rl6nimmt_torch.parallel.launch import check_backend

    check_backend("nccl", 1)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    return dist


@pytest.mark.parametrize("mode", ["engine", "kernel", "insert"])
def test_dp_dqn_cycle_nccl_world_size_one_equals_plain(tmp_path, mode):
    """A DP DQN cycle over one NCCL rank is the plain cycle bit for bit and
    launches the plain cycle's kernels."""
    from rl6nimmt_torch.agents.dqn import tree_map
    from rl6nimmt_torch.parallel import make_dp_dqn_step, make_mesh
    from rl6nimmt_torch.runtime.dp_check import trees_equal
    from rl6nimmt_torch.utils.ops import ALLREDUCES

    dev = _cuda()
    dist = _nccl_world_of_one(tmp_path)
    try:
        cfg, G = EnvConfig(4), 512
        dqn = DQNConfig(**FLAGSHIP)
        spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
        kw = dict(learn_iters=4, kernel_act_rollout=mode == "kernel", kernel_insert=mode == "insert")
        outs, launches = [], []
        for mesh in (None, make_mesh()):
            cycle = make_dqn_selfplay_step(cfg, dqn, Adam(1e-3), G, device=dev, **kw) if mesh is None else \
                make_dp_dqn_step(cfg, dqn, Adam(1e-3), G, mesh, **kw)
            p = mlp_init(torch.Generator(device=dev).manual_seed(0), spec)
            buf = per_init_kd(20 * 5120, S_PAD, SCAL_ROWS, device=dev) if mode == "insert" else \
                per_init(50_000, dqn_replay_example(cfg), device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            st = (p, tree_map(torch.clone, p), Adam(1e-3).init(p), buf)
            _build.reset_launches()
            calls = ALLREDUCES["calls"]
            for _ in range(2):
                *st, m = cycle(*st, gen, 0.0)
            torch.cuda.synchronize()
            launches.append({k: v for k, v in _build.LAUNCHES.items() if v})
            outs.append((st[:3], m))
        assert launches[0] == launches[1] and launches[0]
        assert trees_equal(outs[0], outs[1])
        assert ALLREDUCES["calls"] - calls == 2 * (4 + 1)
    finally:
        dist.destroy_process_group()


def test_dp_two_gloo_ranks_share_the_card():
    """Two gloo ranks on the one card: replicated params, reruns, the 1-rank
    mesh equal to the plain steps and the sharded block equal to the unsharded
    one (``runtime/dp_check.py``)."""
    from rl6nimmt_torch.parallel.launch import spawn
    from rl6nimmt_torch.runtime.dp_check import run_checks

    _cuda()
    _build.library()            # built once here, before the ranks load it
    inputs = {"dqn_cycle": {"cfg": FLAGSHIP, "games": 256, "learn_iters": 2, "capacity": 20 * 5120,
                            "mode": "insert"},
              "reinforce_games": 256, "acer_games": 64, "block_games": 8}
    out = spawn(run_checks, 2, inputs, "cuda", backend="gloo", timeout=600)[0]
    assert out["replicated"] and all(out["replicated"].values())
    assert out["rerun"] and all(out["rerun"].values())
    assert out["size1"] == {"reinforce": True, "dqn": True, "acer": True}
    assert all(v["identity"] and v["max_err"] <= 1e-6 for v in out["pmean"].values())
    np.testing.assert_array_equal(out["block"]["n2"], out["block"]["n1"])
    np.testing.assert_array_equal(out["block"]["n1"], out["block"]["fn"])
    assert out["tournament"]["n2"] == out["tournament"]["n1"]
    assert all(out["launches"].get(k) for k in ("deal_games", "resolve_turn", "act_insert"))


@pytest.mark.parametrize("opponents", [["random", "random", "random"], ["uniform", "puct"]])
def test_callback_game_on_the_card(monkeypatch, opponents):
    """The human-vs-device game deals with K2 once and resolves each turn with
    K1 (search seats add their playout turns)."""
    import builtins
    import re

    from rl6nimmt_torch.runtime.callback_human import play_callback_game

    dev = _cuda()
    monkeypatch.setattr(builtins, "input",
                        lambda p="": re.search(r"cards:\s*((?:\s*\d+)+)", p).group(1).split()[0])
    _build.reset_launches()
    scores = play_callback_game(opponents, mc_max=16, seed=2, device=dev)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["deal_games"] == 1
    if opponents[0] == "random":
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": 10}
    else:
        assert _build.LAUNCHES["resolve_turn"] > 10
    assert scores.shape == (1 + len(opponents),) and (scores <= 0).all()


@pytest.mark.parametrize("x_shape,out", [((64, 47), 32), ((8, 4, 10, 100), 32), ((48,), 32),
                                         ((64, 4, 10, 100), 1)])
def test_bf16_product_on_card_matches_cpu_route(x_shape, out):
    """``compute_dtype="bfloat16"`` on the card against the CPU: the rounded
    operands' float32 product within float32 summation order (1e-4 of the
    output's scale, under a bfloat16 ulp), gradients rounded to bfloat16 and
    within two of its ulps; a one-column product among them (the nets' heads)."""
    from rl6nimmt_torch.nets.mlp import _mm

    dev = _cuda()
    gen = torch.Generator().manual_seed(sum(x_shape))
    x0, w0 = torch.randn(x_shape, generator=gen), torch.randn(x_shape[-1], out, generator=gen)
    g = torch.randn(x_shape[:-1] + (out,), generator=gen)
    outs, grads = [], []
    for d in (torch.device("cpu"), dev):
        x, w = x0.to(d).requires_grad_(True), w0.to(d).requires_grad_(True)
        y = _mm(x, w, "bfloat16")
        assert y.dtype == torch.float32
        outs.append(y.detach().cpu())
        grads.append([t.cpu() for t in torch.autograd.grad(y, (x, w), g.to(d))])
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-4 * float(outs[0].abs().max())
    for a, b in zip(grads[1], grads[0]):
        assert torch.equal(a, a.to(torch.bfloat16).float())
        assert bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-5 * float(b.abs().max())).all())


# ----------------------------------------- the action-in-input policy forward


def _policy_inputs(dev, M, S, D=100, live="random", seed=0):
    """``(shared, cards, weights)`` of a policy net drawn as ``mlp_init`` draws
    it: ``shared`` the state product of uniform states in [-1, 1], ``cards``
    ``int32[M, S]`` whose first ``n`` slots of a row hold cards and the rest -1
    (``live="random"``: n uniform in 0..S; ``"all"``: n = S)."""
    from rl6nimmt_torch.nets import MLPSpec

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp_init(gen, MLPSpec(48, hidden_sizes=(D, D)), dev)
    w1, b1 = params["trunk"][0]["w"], params["trunk"][0]["b"]
    shared = (torch.rand((M, 47), generator=gen, device=dev) * 2 - 1) @ w1[1:] + b1
    cards = torch.randint(0, 104, (M, S), generator=gen, device=dev, dtype=torch.int32)
    n = torch.randint(0, S + 1, (M, 1), generator=gen, device=dev) if live == "random" else S
    cards = torch.where(torch.arange(S, device=dev) < n, cards, -1)
    weights = (w1[0], params["trunk"][1]["w"], params["trunk"][1]["b"], params["heads"][0]["w"],
               params["heads"][0]["b"])
    return shared, cards, weights


def _policy_gap(got, want, cards, h2, w3, b3):
    """The largest gap of a live logit over its row's scale: the largest, over
    the row's live slots, of ``|b3| + sum |h2 * w3|`` (the twin's ``h2``), which
    bounds a logit's float32 round-off.  (The row's largest |logit| is no scale:
    a row whose live logits all sit near 0 reads gaps of 1e-3 and more between
    any two float32 summation orders; the twin against itself in float64 reads
    up to 6.7e-3 of it at 131,072 rows, 1.2e-7 of this scale.)"""
    live = cards >= 0
    terms = (h2 * w3[:, 0]).abs().sum(dim=-1) + b3.abs()
    scale = torch.where(live, terms, 0.0).amax(dim=-1, keepdim=True).clamp(min=1e-30)
    return float(torch.where(live, (got - want).abs() / scale, 0.0).max())


POLICY_SHAPES = ([(131072, 10, 100, "random")]                     # the REINFORCE evaluation's seat
                 + [(262144, s, 100, "all") for s in range(10, 0, -1)]  # the train rollout's H - t slots
                 + [(m, 10, d, "random") for m in (1, 33) for d in (100, 112)]
                 + [(77, 16, 112, "random"), (50, 3, 4, "random"), (5000, 7, 36, "random")])


@pytest.mark.parametrize("M,S,D,live", POLICY_SHAPES)
def test_policy_mlp_matches_twin(M, S, D, live):
    """The kernel against its twin: every live logit within 1e-5 of its row's
    largest, NEG_INF exactly on the padded slots; with the hidden tensors kept,
    the same logits, h1 as the twin's and h2 within float32 summation order."""
    from rl6nimmt_torch.ops.policy_mlp import NEG_INF, _launch, policy_mlp_plain

    dev = _cuda()
    shared, cards, w = _policy_inputs(dev, M, S, D, live, seed=M + S)
    _build.reset_launches()
    logits, _, _ = _launch(shared, cards, *w, 103.0, save=False)
    kept, h1, h2 = _launch(shared, cards, *w, 103.0, save=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["policy_mlp"] == 2
    want, h1_want, h2_want = policy_mlp_plain(shared, cards, *w, 103.0, save=True)
    assert torch.equal(logits == NEG_INF, cards < 0)
    assert _policy_gap(logits, want, cards, h2_want, w[3], w[4]) <= 1e-5
    assert torch.equal(kept, logits)
    torch.testing.assert_close(h1, h1_want, rtol=1e-6, atol=1e-6)
    assert float((h2 - h2_want).abs().max()) <= 1e-5 * float(h2_want.abs().max())


def test_policy_mlp_strided_cards_and_all_padded_rows():
    """A seat's hands are a strided view of ``[G, P, H]``; rows with no card
    get NEG_INF only and zeros in the kept tensors."""
    from rl6nimmt_torch.ops.policy_mlp import NEG_INF, _launch, policy_logits, policy_mlp_plain

    dev = _cuda()
    shared, cards, w = _policy_inputs(dev, 4 * 999, 10, seed=5)
    cards[::3] = -1
    seat = cards.reshape(999, 4, 10)[:, 2]
    got = policy_logits(shared.reshape(999, 4, 100)[:, 2], seat, *w, 103.0)
    want, _, h2_want = policy_mlp_plain(shared.reshape(999, 4, 100)[:, 2], seat, *w, 103.0, save=True)
    assert torch.equal(got == NEG_INF, seat < 0) and _policy_gap(got, want, seat, h2_want, w[3], w[4]) <= 1e-5
    _, h1, h2 = _launch(shared, cards, *w, 103.0, save=True)
    assert not h1[::3].any() and not h2[::3].any()


def test_policy_mlp_backward_on_card_matches_autograd():
    """The Function (kernel forward, torch backward) against autograd through
    the twin on the card, padded slots included: each gradient's distance
    within 1e-5 of the larger of its norm and the median gradient's (the
    benchmark's ``grad_gap`` scale: the head bias's gradient is the round-off
    of a sum the softmax makes zero)."""
    from rl6nimmt_torch.ops.policy_mlp import PolicyMLP, policy_mlp_plain

    dev = _cuda()
    shared, cards, w = _policy_inputs(dev, 4096, 10, seed=9)
    gen = torch.Generator(device=dev).manual_seed(10)
    weight = torch.randn(cards.shape, generator=gen, device=dev)
    grads = []
    for fused in (True, False):
        leaves = [t.detach().clone().requires_grad_(True) for t in (shared,) + w]
        logits = (PolicyMLP.apply(leaves[0], cards, *leaves[1:], 103.0) if fused
                  else policy_mlp_plain(leaves[0], cards, *leaves[1:], 103.0))
        loss = (torch.log_softmax(logits, dim=-1) * weight).where(cards >= 0, 0.0).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    norms = [float(b.norm()) for b in grads[1]]
    median = sorted(norms)[len(norms) // 2]
    gaps = [float((a - b).norm()) / max(n, median) for a, b, n in zip(*grads, norms)]
    assert max(gaps) <= 1e-5, gaps


def test_policy_mlp_widths_in_any_order():
    """A wide launch after a narrower one on the same card: the kernel's shared
    memory limit, raised once for the widest net, is never lowered by a
    narrower width's first launch."""
    from rl6nimmt_torch.ops.policy_mlp import _launch, policy_mlp_plain

    dev = _cuda()
    for D in (108, 92, 108):
        shared, cards, w = _policy_inputs(dev, 999, 10, D, seed=D)
        logits, _, _ = _launch(shared, cards, *w, 103.0, save=False)
        want, _, h2_want = policy_mlp_plain(shared, cards, *w, 103.0, save=True)
        assert _policy_gap(logits, want, cards, h2_want, w[3], w[4]) <= 1e-5


def test_policy_mlp_engages_on_the_cells_paths():
    """The benchmark cells' two paths at a small G: a train step launches the
    kernel once a turn (10), a match once a turn for its policy seat, and no
    call falls back."""
    from rl6nimmt_torch.agents.dqn import Adam
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.ops import policy_mlp
    from rl6nimmt_torch.runtime.arena import SeatPolicy, make_arena
    from rl6nimmt_torch.runtime.vector import make_reinforce_train_step

    dev = _cuda()
    cfg = EnvConfig(4)
    spec = MLPSpec(cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    params = mlp_init(torch.Generator(device=dev).manual_seed(0), spec)
    adam = Adam(1e-3)
    train = make_reinforce_train_step(cfg, spec, adam, 1024, device=dev)
    arena = make_arena(cfg, (SeatPolicy("policy", spec=spec),) + (SeatPolicy("random"),) * 3, 2048, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for run, want in ((lambda: train(params, adam.init(params), gen)[2]["loss"], True),
                      (lambda: arena((params, None, None, None), (0.0,) * 4, gen), False)):
        _build.reset_launches()
        policy_mlp.FALLBACKS["policy_mlp"] = 0
        out = run()
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"deal_games": 1, "resolve_turn": 10,
                                                                    "policy_mlp": 10}
        assert policy_mlp.FALLBACKS["policy_mlp"] == 0 and torch.isfinite(out.float()).all()


def test_policy_mlp_ptxas_no_stack_no_spills():
    """The kernel builds with 0 bytes of stack and no spills."""
    _cuda()
    _build.library()
    line = _build.BUILD_INFO["ptxas"]["policy_mlp_kernel"]
    assert all(re.search(rf"(?<![\d.]){z}", line) for z in ("0 bytes stack frame", "0 bytes spill stores",
                                                           "0 bytes spill loads")), line
