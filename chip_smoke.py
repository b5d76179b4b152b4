"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rl6nimmt_torch/csrc`` (nvcc, one
process per source), then:

1. prints the card, its power limit, the torch/CUDA versions, the build time
   and ptxas registers/spills per kernel, and requires 0 B stack frame and 0
   spills of every K1, K2 and K3 instance;
2. holds K1-K5 against their plain PyTorch twins at the main path's shapes
   (P=4, G=4096, hidden 64): K1-K3 bit-exact (K1 in both layouts, the
   games-last entry also against the row-major one on the transposed state,
   on every one of the 10 turns, and a launch under ``torch.cuda.stream``
   on that stream), K4 with exact deals, action
   agreement >= 0.999 and equal observations/rewards in agreeing games; K5 at
   capacity 204,800 and ptr 163,840 (tile regions wrap past the ring end) on
   sentinel-filled planes, every written column equal to the twin's in
   agreeing games, pad rows zero and the unwritten columns untouched;
3. replays K4's games on the engine path (``greedy_replay_agreement``) and
   holds K5's planes against K4's trajectory (``insert_planes_agreement``);
4. drives the main path with every launch counter at 0: 3 random-rollout
   generations fused (K3), on the engine path (K2 + K1) and games-last (K2 +
   the games-last K1), which must agree bit for bit, then 3 flagship
   Noisy-D3QN-PER-10step cycles (PER 200,000, 8 updates, Adam 1e-3) on the
   engine path, 3 with ``kernel_act_rollout=True`` (K4), 3 with
   ``kernel_insert=True`` (K5, ``per_init_kd`` 204,800); each path must
   launch exactly its kernels; then two cycles from one state and one
   injected randomness must agree bit for bit, in every mode;
5. times each kernel and its twin with CUDA events (``ms``: per call, the
   host's launch route included) and each kernel on the device alone
   (``device_ms``: its ``torch.profiler`` kernel events per launch), and the
   rollouts and cycles in env-steps/s;
6. drives the ablation and probe path with every launch counter at 0: the
   act-rollout ablation's entry point (``env``, ``obs``, ``mm`` on K6,
   ``full`` on K4; chains of ABLATE_CHAIN generations) and the probe entry
   point (K7's seven bodies, each against its twin); then holds K6 ``env``
   and ``obs`` bit-exact to their twins, ``env`` to K3 on the same seed and
   ``mm`` at action agreement >= 0.999, and prints the attribution of K4's
   time: each variant's ms per generation, ms per launch at G=4096 (128
   blocks of 32 games, one per SM) and at G=16,384, its bound and its ptxas
   line; and each probe's ms and device ms beside those of the one PyTorch
   call that computes the same function (a yardstick must not return a view).

Prints one JSON line of kernels (K1's to K5's rows also carry their launch
shape and ptxas line, K2's and K3's their ms and device ms at G=16,384, K4's
its ms there), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when there
is no CUDA device, when the package is missing, or when any check fails.
"""

import json
import math
import os
import re
import sys
import time
import traceback

import torch

G = 4096
HIDDEN = 64
CYCLES = 3
GENERATIONS = 3
ROLLOUTS = ("fused", "engine", "games_last")
# K1's ptxas names: <layout (1: games-last), P, R, T>, constant at the flagship, 0 for runtime sizes.
K1_INSTANCES = tuple(f"resolve_turn_kernel<{layout},{sizes}>" for layout in (0, 1) for sizes in ("4,4,6", "0,0,0"))
# K2's and K3's: <P, R, T, H, C>, constant at the flagship, 0 for runtime sizes.
K2_K3_FLAGSHIP = "4,4,6,10,104"
K2_K3_INSTANCES = tuple(f"{k}_kernel<{sizes}>" for k in ("deal_games", "play_random_games")
                        for sizes in (K2_K3_FLAGSHIP, "0,0,0,0,0"))
PER_CAPACITY = 200_000
KD_CAPACITY = 204_800      # bench.py line 3: per_init_kd capacity, 40 x T*P*128
KD_PTR = 163_840           # tile regions from block 8 on wrap past the ring end
LEARN_ITERS = 8
ABLATE_CHAIN = 32          # generations per timed ablation chain (the JAX script chained 256)
REPS = 5                   # a kernel's per-call ms: the median of this many timed runs
ABLATE_G_WIDE = 16_384     # 4x the main path's games: 512 blocks of 32
FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10,
                hidden_sizes=(HIDDEN,), minibatch=64)

# Peak rates of one H100 SXM (NVIDIA's published figures): HBM
# bytes/s and float32 operations/s outside the tensor cores.  Integer work is
# charged at the float32 rate, which can only make a bound smaller.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Integer-operation model of the game kernels (per the csrc sources): one
# Philox4x32-10 block is 10 rounds of 2 mul-hi/lo pairs, 4 xors and 2 key adds.
PHILOX_BLOCK_OPS = 10 * 10
SWAP_OPS = 6            # one Fisher-Yates step: draw scale, two loads, two stores, add
SUBPLAY_OPS = 6 * 4 + 10  # row search and cheapest row over R=4 rows, update


def log(*a):
    print(*a, flush=True)


def host_seconds(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def profile_cycle(fn, mode):
    """One traced call: wall time, device busy time, idle share, the three
    cycle phases and the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Device work = the kernel (and copy) events themselves; the aten ops and
    # the cycle.* spans only attribute that same time, so they are left out.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith("cycle.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # Span times on the host clock: the cycle is dispatch-bound, so this is
    # where its time goes.  The profiler's device-side span times were not
    # reliable on the card (a rollout span holding a 3.5 ms kernel read 0.03 ms).
    spans = {e.key: e.cpu_time_total / 1e3 for e in events
             if e.key.startswith("cycle.") and e.device_type == DeviceType.CPU}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"profile": f"dqn_cycle_{mode}", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": sum(e.count for e in kernels),
            "phase_host_ms": spans,
            "top_kernels": [{"kernel": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs):
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in pairs)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec, tree_leaves
    from rl6nimmt_torch.experiments.kernel_times import (check_yardsticks, cuda_ms, device_ms, smi_line,
                                                         yardsticks)
    from rl6nimmt_torch.buffers import per_clone, per_init, per_init_kd
    from rl6nimmt_torch.engine import EnvConfig, deal, step
    from rl6nimmt_torch.nets import draw_mlp_noise, mlp_init
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.ops.act_rollout_check import (greedy_replay_agreement, insert_planes_agreement,
                                                      insert_twin_agreement, turn_effective_weights)
    from rl6nimmt_torch.ops.act_rollout_kernel import (S_PAD, SCAL_ROWS, act_insert_plain, act_rollout_plain,
                                                       make_act_insert_kernel, make_act_rollout_kernel)
    from rl6nimmt_torch.ops.game_kernel import (deal_games, deal_games_plain, play_random_games,
                                                play_random_games_plain)
    from rl6nimmt_torch.ops.step_kernel import (resolve_turn, resolve_turn_plain, resolve_turn_t,
                                                resolve_turn_t_plain)
    from rl6nimmt_torch.runtime.vector import (draw_cycle_randomness, dqn_replay_example,
                                               make_dqn_selfplay_step, make_random_rollout_generations)

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls in the twins and the learner
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_line()
    kind = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------ phase 1
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    ptxas = _build.BUILD_INFO["ptxas"]     # from this build, or kept beside a built library
    for name, info in sorted(ptxas.items()):
        log(f"[1] ptxas {name}: {info}")
    # K1's four instances (two layouts, flagship and runtime sizes) and K2's and
    # K3's two each (flagship and runtime sizes): nothing in local memory.
    lean_ptxas = {k: ptxas.get(k, "missing") for k in K1_INSTANCES + K2_K3_INSTANCES}
    if any(not all(re.search(rf"(?<![\d.]){z}", v) for z in ("0 bytes stack frame", "0 bytes spill stores",
                                                              "0 bytes spill loads"))
           for v in lean_ptxas.values()):
        raise AssertionError(f"K1, K2 and K3 instances must use no stack and no spills: {lean_ptxas}")

    cfg = EnvConfig(4)
    dqn = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    gen = torch.Generator(device=dev).manual_seed(20261016)
    params = mlp_init(gen, spec)
    turn_noise = draw_mlp_noise(spec, gen, batch=(cfg.max_turns,))
    eff = turn_effective_weights(spec, params, turn_noise)
    k4_args = tuple(x.contiguous() for x in (eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                             eff["heads"][1]["w"], eff["heads"][1]["b"]))
    play = make_act_rollout_kernel(cfg, G, HIDDEN)

    # ------------------------------------------------------------ phase 2
    errs, k1_inputs = {"resolve_turn": 0.0, "resolve_turn_t": 0.0}, None
    R, T = cfg.num_rows, cfg.threshold
    state = deal(cfg, 1, G, device=dev)
    for t in range(cfg.max_turns):
        hs = state.hands_sorted
        r = torch.floor(torch.rand(hs.shape[:2], generator=gen, device=dev) * (hs >= 0).sum(-1)).long()
        acts = torch.gather(hs, -1, r[..., None]).squeeze(-1).contiguous()
        board_t, len_t = state.board.reshape(G, R * T).T.contiguous(), state.row_len.T.contiguous()
        if t == 5:
            k1_inputs = (state.board, state.row_len, acts)
            k1t_inputs = (board_t, len_t, acts)
        out_k = resolve_turn(cfg, state.board, state.row_len, acts)
        out_p = resolve_turn_plain(cfg, state.board, state.row_len, acts)
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
            raise AssertionError(f"K1 resolve_turn differs from its twin at turn {t}")
        errs["resolve_turn"] = max(errs["resolve_turn"], max_abs_err(zip(out_k, out_p)))
        out_t = resolve_turn_t(cfg, board_t, len_t, acts)
        out_tp = resolve_turn_t_plain(cfg, board_t, len_t, acts)
        row_major = (out_k[0].reshape(G, R * T).T, out_k[1].T, out_k[2].T)
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(out_t, out_tp, row_major)):
            raise AssertionError(f"K1 resolve_turn_t differs from its twin or from resolve_turn at turn {t}")
        errs["resolve_turn_t"] = max(errs["resolve_turn_t"], max_abs_err(zip(out_t, out_tp)))
        state, _ = step(cfg, state, acts)
    # The launch route reads the current stream on every call: a launch under
    # torch.cuda.stream(side) goes on side and gives the twin's result there.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = _build.stream_reader()(dev.index or 0) == side.cuda_stream
        out_s = resolve_turn(cfg, *k1_inputs)
    side.synchronize()
    if not on_side or not all(torch.equal(a, b) for a, b in zip(out_s, resolve_turn_plain(cfg, *k1_inputs))):
        raise AssertionError("K1 under torch.cuda.stream(side): wrong stream or wrong result")
    out_k, out_p = deal_games(cfg, 77, G, device=dev), deal_games_plain(cfg, 77, G, dev)
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise AssertionError("K2 deal_games differs from its twin")
    errs["deal_games"] = max_abs_err(zip(out_k, out_p))
    out_k, out_p = play_random_games(cfg, 78, G, device=dev), play_random_games_plain(cfg, 78, G, dev)
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise AssertionError("K3 play_random_games differs from its twin")
    errs["play_random_games"] = max_abs_err(zip(out_k, out_p))
    (ok, ak, rk), (op, ap, rp) = play(79, *k4_args), act_rollout_plain(cfg, 79, G, *k4_args)
    if not torch.equal(ok[0], op[0]):
        raise AssertionError("K4 deals differ from its twin's")
    k4_agree = (ak == ap).float().mean().item()
    same = (ak == ap).all(dim=(0, 2))
    if k4_agree < 0.999 or not (torch.equal(ok[:, same], op[:, same]) and torch.equal(rk[:, same], rp[:, same])):
        raise AssertionError(f"K4 act_rollout vs twin: action agreement {k4_agree}")
    errs["act_rollout"] = max_abs_err([(ok[:, same], op[:, same]), (rk[:, same], rp[:, same])])
    log(f"[2] K1-K3 bit-exact vs twins at G={G} (K1 in both layouts on all {cfg.max_turns} turns, the "
        f"games-last entry == the row-major one; a launch under torch.cuda.stream is on that stream); "
        f"K4 deals exact, action agreement {k4_agree:.6f}, "
        f"{int(same.sum())}/{G} games identical")
    k5_agree, k5_games, errs["act_insert"] = insert_twin_agreement(cfg, G, HIDDEN, KD_CAPACITY, KD_PTR, 81, k4_args)
    if k5_agree < 0.999 or errs["act_insert"] != 0.0:
        raise AssertionError(f"K5 act_insert vs twin: action agreement {k5_agree}, error {errs['act_insert']}")
    log(f"[2] K5 vs twin at G={G}, capacity {KD_CAPACITY}, ptr {KD_PTR}: action agreement {k5_agree:.6f}, "
        f"{k5_games}/{G} games bit-exact in every plane; pad rows zero, unwritten columns untouched")

    # ------------------------------------------------------------ phase 3
    action_agree, score_agree = greedy_replay_agreement(cfg, dqn, spec, params, G, 80, turn_noise)
    if action_agree < 0.999 or score_agree < 0.999:
        raise AssertionError(f"greedy replay agreement {action_agree}, {score_agree}")
    log(f"[3] greedy_replay_agreement at G={G}: actions {action_agree:.6f}, scores {score_agree:.6f}")
    reward_err = insert_planes_agreement(cfg, dqn, spec, params, G, KD_CAPACITY, 82, KD_PTR, turn_noise)
    log(f"[3] insert_planes_agreement at G={G}: K5 planes == K4's n-step harvest, rewards within {reward_err:.3g}")

    # ------------------------------------------------------------ phase 4
    adam = Adam(1e-3)
    block = G * cfg.num_players * cfg.max_turns
    options = {"engine": {}, "kernel": dict(kernel_act_rollout=True), "insert": dict(kernel_insert=True)}
    cycles = {mode: make_dqn_selfplay_step(cfg, dqn, adam, G, learn_iters=LEARN_ITERS, device=dev, **kw)
              for mode, kw in options.items()}
    fresh_buffer = {
        "engine": lambda: per_init(PER_CAPACITY, dqn_replay_example(cfg), device=dev),
        "kernel": lambda: per_init(PER_CAPACITY, dqn_replay_example(cfg), device=dev),
        "insert": lambda: per_init_kd(KD_CAPACITY, S_PAD, SCAL_ROWS, device=dev),
    }
    rollouts = {mode: make_random_rollout_generations(cfg, G, GENERATIONS, fused=(mode == "fused"),
                                                      games_last=(mode == "games_last"), device=dev)
                for mode in ROLLOUTS}
    train_state = {}
    per_unit = {}
    _build.reset_launches()
    # ---- main path: every counter starts at 0 here ----
    totals = {}
    for mode, fn in rollouts.items():
        before = dict(_build.LAUNCHES)
        totals[mode] = fn(1000)
        per_unit[f"rollout_{mode}"] = {k: (v - before[k]) / GENERATIONS for k, v in _build.LAUNCHES.items()}
    for mode, cycle in cycles.items():
        p, tgt = params, {k: [{kk: vv.clone() for kk, vv in l.items()} for l in v] for k, v in params.items()}
        o, buf = adam.init(params), fresh_buffer[mode]()
        cgen = torch.Generator(device=dev).manual_seed(5)
        before = dict(_build.LAUNCHES)
        losses = []
        for c in range(CYCLES):
            p, tgt, o, buf, m = cycle(p, tgt, o, buf, cgen, 0.0, c * LEARN_ITERS)
            losses.append(float(m["loss"]))
        per_unit[f"cycle_{mode}"] = {k: (v - before[k]) / CYCLES for k, v in _build.LAUNCHES.items()}
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss in {mode} cycles: {losses}")
        inserted = CYCLES * block
        if (buf.size, buf.ptr) != (min(inserted, buf.capacity), inserted % buf.capacity):
            raise AssertionError(f"{mode} cycles left PER size {buf.size}, ptr {buf.ptr}")
        train_state[mode] = (p, tgt, o, buf)
        log(f"[4] {CYCLES} flagship cycles ({mode}): losses {losses}, mean score {float(m['mean_score'])}, "
            f"PER size {buf.size}, ptr {buf.ptr}")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # ---- end of the main path ----
    log(f"[4] main-path launches: {launches}")
    # Each path launches exactly its own kernels, per generation or cycle.
    engine_path = {"deal_games": 1, "resolve_turn": cfg.max_turns}
    expected = {"rollout_engine": engine_path, "rollout_fused": {"play_random_games": 1},
                "rollout_games_last": {"deal_games": 1, "resolve_turn_t": cfg.max_turns},
                "cycle_engine": engine_path, "cycle_kernel": {"act_rollout": 1},
                "cycle_insert": {"act_insert": 1}}
    missing = sorted({k for want in expected.values() for k in want if launches[k] == 0})
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for path, want in expected.items():
        got = {k: v for k, v in per_unit[path].items() if v}
        if got != want:
            raise AssertionError(f"{path} launched {got} per unit, expected {want}")
    for mode in ("engine", "games_last"):
        if not (torch.equal(totals["fused"][0], totals[mode][0])
                and float(totals["fused"][1]) == float(totals[mode][1])):
            raise AssertionError(f"fused (K3) and {mode} random rollouts disagree on one seed")
    log(f"[4] random rollouts: fused == engine path == games-last over {GENERATIONS} generations "
        f"(mean score {float(totals['fused'][0].float().mean()) / GENERATIONS:.4f}, checksum {float(totals['fused'][1])})")

    for mode, cycle in cycles.items():
        p, tgt, o, buf = train_state[mode]
        rnd = draw_cycle_randomness(cfg, dqn, G, LEARN_ITERS, torch.Generator(device=dev).manual_seed(9))
        runs = [cycle(p, tgt, o, per_clone(buf), rnd, 0.0, CYCLES * LEARN_ITERS) for _ in range(2)]
        (p1, _, _, b1, m1), (p2, _, _, b2, m2) = runs
        same = torch.equal(m1["loss"], m2["loss"]) and torch.equal(b1.priorities, b2.priorities) \
            and all(torch.equal(b1.storage[k], b2.storage[k]) for k in b1.storage) \
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
        if not same:
            raise AssertionError(f"determinism guard failed for the {mode} cycle")
    log(f"[4] determinism guard: two cycles from one state and one randomness are bit-identical "
        f"(modes {', '.join(cycles)})")

    # ------------------------------------------------------------ phase 5
    # The rates and every per-call time come before the first profiler session
    # of this process (device_ms, profile_cycle): a session may slow later host work.
    P, R, T, H, S, A = cfg.num_players, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.state_length, cfg.num_actions
    turns = cfg.max_turns
    steps_per_gen = G * turns
    rates = {}
    for mode in ROLLOUTS:
        one = make_random_rollout_generations(cfg, G, 1, fused=(mode == "fused"), games_last=(mode == "games_last"),
                                              device=dev)
        sec = host_seconds(lambda: one(4242), 10 if mode == "fused" else 3)
        rates[f"random_rollout_{mode}_env_steps_per_s"] = steps_per_gen / sec
    for mode, cycle in cycles.items():
        p, tgt, o, buf = train_state[mode]
        cgen = torch.Generator(device=dev).manual_seed(11)
        sec = host_seconds(lambda: cycle(p, tgt, o, buf, cgen, 0.0), 3)
        rates[f"dqn_cycle_{mode}_env_steps_per_s"] = steps_per_gen / sec
    for k, v in rates.items():
        log(json.dumps({"metric": k, "value": v, "card": card}))
    k1_b, k1_l, k1_a = k1_inputs
    k1t_b, k1t_l, k1t_a = k1t_inputs
    insert = make_act_insert_kernel(cfg, G, HIDDEN, KD_CAPACITY, 0.99, dqn.n_steps)
    k5_planes = (torch.zeros((S_PAD, KD_CAPACITY), dtype=torch.int8, device=dev),
                 torch.zeros((S_PAD, KD_CAPACITY), dtype=torch.int8, device=dev),
                 torch.zeros((SCAL_ROWS, KD_CAPACITY), dtype=torch.float32, device=dev))
    timing = {
        "resolve_turn": (lambda: resolve_turn(cfg, k1_b, k1_l, k1_a),
                         lambda: resolve_turn_plain(cfg, k1_b, k1_l, k1_a), 200, 20),
        "resolve_turn_t": (lambda: resolve_turn_t(cfg, k1t_b, k1t_l, k1t_a),
                           lambda: resolve_turn_t_plain(cfg, k1t_b, k1t_l, k1t_a), 200, 20),
        "deal_games": (lambda: deal_games(cfg, 5, G, device=dev),
                       lambda: deal_games_plain(cfg, 5, G, dev), 200, 5),
        "play_random_games": (lambda: play_random_games(cfg, 6, G, device=dev),
                              lambda: play_random_games_plain(cfg, 6, G, dev), 100, 3),
        "act_rollout": (lambda: play(7, *k4_args),
                        lambda: act_rollout_plain(cfg, 7, G, *k4_args), 20, 3),
        "act_insert": (lambda: insert(7, KD_PTR, *k4_args, *k5_planes),
                       lambda: act_insert_plain(cfg, 7, G, *k4_args, KD_PTR, *k5_planes, 0.99, dqn.n_steps), 20, 3),
    }
    # Bytes each kernel must move (inputs read once, outputs written once) and
    # the operations these inputs need.
    k1_bytes = 4 * G * (R * T + R + P) * 2
    k1_ops = G * (P * SUBPLAY_OPS + P * P)
    k2_bytes = 4 * G * (R * T + R + P * H)
    k2_ops = G * (math.ceil((P * H + R) / 4) * PHILOX_BLOCK_OPS + (P * H + R) * SWAP_OPS + P * H * H)
    k3_bytes = 4 * G * (P + 1)
    k3_ops = G * (math.ceil((P * H + R + turns * P) / 4) * PHILOX_BLOCK_OPS + (P * H + R) * SWAP_OPS
                  + turns * (P * (SUBPLAY_OPS + H) + 4 * R))
    weight_bytes = 4 * turns * (S * HIDDEN + HIDDEN + HIDDEN * A + A)
    k4_bytes = weight_bytes + (turns + 1) * G * P * S + 2 * 4 * turns * G * P
    k4_flops = G * sum((S - H) * HIDDEN * 2 + P * H * HIDDEN * 2 + P * (H - t) * HIDDEN * 2 for t in range(turns))
    # K5: the same play, then every transition's column of the three planes and the rewards out.
    k5_bytes = weight_bytes + turns * P * G * (2 * S_PAD + 4 * SCAL_ROWS) + 4 * turns * P * G
    work = {"resolve_turn": (k1_bytes, k1_ops), "resolve_turn_t": (k1_bytes, k1_ops),
            "deal_games": (k2_bytes, k2_ops),
            "play_random_games": (k3_bytes, k3_ops), "act_rollout": (k4_bytes, k4_flops),
            "act_insert": (k5_bytes, k4_flops)}
    meta = {
        "resolve_turn": ("rl6nimmt_torch/csrc/step_kernel.cu", "rl6nimmt_tpu/ops/step_kernel.py:147",
                         f"board i32[{G},{R},{T}], row_len i32[{G},{R}], actions i32[{G},{P}]"),
        "resolve_turn_t": ("rl6nimmt_torch/csrc/step_kernel.cu", "rl6nimmt_tpu/ops/step_kernel.py:147",
                           f"board_t i32[{R * T},{G}], row_len_t i32[{R},{G}], actions i32[{G},{P}]"),
        "deal_games": ("rl6nimmt_torch/csrc/game_kernel.cu", "rl6nimmt_tpu/ops/game_kernel.py:290",
                       f"seed -> board i32[{G},{R},{T}], row_len, hands i32[{G},{P},{H}]"),
        "play_random_games": ("rl6nimmt_torch/csrc/game_kernel.cu", "rl6nimmt_tpu/ops/game_kernel.py:143",
                              f"seed -> rewards i32[{G},{P}], checksum f32[{G}]"),
        "act_rollout": ("rl6nimmt_torch/csrc/act_rollout_kernel.cu", "rl6nimmt_tpu/ops/act_rollout_kernel.py:232",
                        f"w1 f32[{turns},{S},{HIDDEN}], wa f32[{turns},{HIDDEN},{A}] -> obs i8[{turns + 1},{G},{P},{S}]"),
        "act_insert": ("rl6nimmt_torch/csrc/act_insert_kernel.cu", "rl6nimmt_tpu/ops/act_rollout_kernel.py:351",
                       f"K4's weights, ptr {KD_PTR} -> planes i8[{S_PAD},{KD_CAPACITY}] x2, "
                       f"f32[{SCAL_ROWS},{KD_CAPACITY}] in place, rewards i32[{turns * P},{G}]"),
    }
    # The kernel each wrapper launches, as its profiler events name it.
    kernel_of = {"resolve_turn": "resolve_turn_kernel", "resolve_turn_t": "resolve_turn_kernel",
                 **{k: f"{k}_kernel" for k in _build.LAUNCHES if not k.startswith("resolve_turn")}}
    rows = []
    for name, (kern, plain, it_k, it_p) in timing.items():
        b_ms, b_by = bound_ms(*work[name])
        rows.append({"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                     "launches": launches[name], "max_abs_err": errs[name], "ms": cuda_ms(kern, it_k, REPS),
                     "device_ms": None, "plain_ms": cuda_ms(plain, it_p), "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "library_device_ms": None})
    # K2 and K3 at 4x the games (512 blocks): chain-bound if the time barely moves.
    wide = {"deal_games": lambda: deal_games(cfg, 5, ABLATE_G_WIDE, device=dev),
            "play_random_games": lambda: play_random_games(cfg, 6, ABLATE_G_WIDE, device=dev)}
    for row in rows:
        if row["name"] in wide:
            row[f"ms_g{ABLATE_G_WIDE}"] = cuda_ms(wide[row["name"]], 50, REPS)
    for row in rows:
        name, (kern, _, it_k, _) = row["name"], timing[row["name"]]
        row["device_ms"] = device_ms(kern, it_k, kernel_of[name])
        if name in wide:
            row[f"device_ms_g{ABLATE_G_WIDE}"] = device_ms(wide[name], 50, kernel_of[name])
        per = {k: v[name] for k, v in per_unit.items() if v[name]}
        log(json.dumps({"kernel": name, "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
                        "launches_per_cycle": per, "shape": meta[name][2], "card": card}))
    # Launch shapes, as the built library has them, and resources (K1-K5).
    def ptxas_of(kname):
        return ptxas.get(f"{kname}_kernel", "n/a")

    games_per_block = _build.library().rl6_play_games()
    k1_games, k1_threads = _build.library().rl6_resolve_games(), _build.library().rl6_resolve_threads()
    k23_games, k23_threads = _build.library().rl6_game_games(), _build.library().rl6_game_threads()
    for row in rows:
        if row["name"] in ("act_rollout", "act_insert"):
            row.update(ptxas=ptxas_of(row["name"]), games_per_block=games_per_block,
                       blocks=-(-G // games_per_block))
        if row["name"].startswith("resolve_turn"):
            flag = "1" if row["name"] == "resolve_turn_t" else "0"
            row.update(ptxas=ptxas[f"resolve_turn_kernel<{flag},{P},{R},{T}>"],
                       games_per_block=k1_games, blocks=-(-G // k1_games), threads=k1_threads)
        if row["name"] in wide:
            row.update(ptxas=ptxas[f"{row['name']}_kernel<{K2_K3_FLAGSHIP}>"], games_per_block=k23_games,
                       blocks=-(-G // k23_games), threads=k23_threads)

    for mode, cycle in cycles.items():
        p, tgt, o, buf = train_state[mode]
        cgen = torch.Generator(device=dev).manual_seed(12)
        log(json.dumps(profile_cycle(lambda: cycle(p, tgt, o, buf, cgen, 0.0), mode)))

    # ------------------------------------------------------------ phase 6
    from rl6nimmt_torch.experiments import act_rollout_ablate as ablate
    from rl6nimmt_torch.experiments import probe_ops as probe_exp
    from rl6nimmt_torch.ops.act_ablate_kernel import (VARIANTS, ablate_twin_agreement, act_ablate_plain,
                                                      make_act_ablate_kernel)

    acfg = ablate.config()
    aw = ablate.weights(acfg, dev)
    chains = {v: ablate.build(v, device=dev, games=G, chain=ABLATE_CHAIN) for v in VARIANTS}
    _build.reset_launches()
    # ---- the ablation and probe path: every counter starts at 0 here ----
    checksums = {v: int(chains[v](ablate.SEED)) for v in VARIANTS}
    log("[6] probes (K7) against their twins, through the probe entry point:")
    probe_results = {r["probe"]: r for r in probe_exp.run(device=dev)}
    torch.cuda.synchronize()
    path_launches = dict(_build.LAUNCHES)
    # ---- end of the ablation and probe path ----
    log(f"[6] ablation and probe path launches: { {k: v for k, v in path_launches.items() if v} }")
    want = {**{f"act_ablate_{v}": ABLATE_CHAIN for v in _build.ABLATE_VARIANTS}, "act_rollout": ABLATE_CHAIN,
            **{f"probe_{k}": 1 for k in _build.PROBES}}
    if {k: v for k, v in path_launches.items() if v} != want:
        raise AssertionError(f"the ablation and probe path launched {path_launches}, expected {want}")
    failed = [k for k, r in probe_results.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"K7 probes differ from their twins: {failed}")
    log(f"[6] ablation checksums over {ABLATE_CHAIN} generations from seed {ablate.SEED}: {checksums}")

    for v in _build.ABLATE_VARIANTS:
        agree, games, errs[f"act_ablate_{v}"] = ablate_twin_agreement(acfg, v, G, ablate.HID, 91, aw)
        if agree < 0.999 or (v != "mm" and games != G):
            raise AssertionError(f"K6 {v} vs twin: action agreement {agree}, {games}/{G} games identical")
        log(f"[6] K6 {v} vs twin at G={G}: action agreement {agree:.6f}, {games}/{G} games identical"
            + (", deals exact" if v != "env" else ""))
    k3_rewards, _ = play_random_games(acfg, 91, G, device=dev)
    env_rewards = make_act_ablate_kernel(acfg, G, ablate.HID, "env")(91, *aw)[2]
    if not torch.equal(env_rewards.sum(dim=0), k3_rewards):
        raise AssertionError("K6 env's games differ from K3's on the same seed")
    log(f"[6] K6 env's per-game reward sums == K3 (play_random_games) on seed 91, {G} games")

    # Bounds per variant at g games (3.35 TB/s, 67 TFLOP/s f32, integer work at the f32 rate).
    def ablate_work(v, g):
        act_rew = 2 * 4 * turns * g * P
        obs = (turns + 1) * g * P * S
        if v == "env":
            return act_rew, k3_ops / G * g
        if v == "obs":
            return act_rew + obs, k3_ops / G * g
        if v == "mm":
            return weight_bytes + obs + act_rew, g * turns * ((S - H) * HIDDEN * 2 + P * (H + A) * HIDDEN * 2)
        return weight_bytes + (k4_bytes - weight_bytes) / G * g, k4_flops / G * g

    for v in VARIANTS:
        kname = "act_rollout" if v == "full" else f"act_ablate_{v}"
        ms_gen = ablate.timeit(chains[v], iters=5, chain=ABLATE_CHAIN)
        per_launch, bounds = {}, {}
        for g in (G, ABLATE_G_WIDE):
            play_v = make_act_ablate_kernel(acfg, g, ablate.HID, v)
            per_launch[g] = cuda_ms(lambda: play_v(7, *aw), 20)
            bounds[g] = bound_ms(*ablate_work(v, g))
            if g == G:
                dev_ms = device_ms(lambda: play_v(7, *aw), 20, kernel_of[kname])
        log(json.dumps({"ablation": v, "kernel": kname, "ms_per_generation": ms_gen,
                        "ms_per_launch": {str(g): x for g, x in per_launch.items()}, "device_ms": dev_ms,
                        "bound_ms": {str(g): b[0] for g, b in bounds.items()}, "bound_by": bounds[G][1],
                        "ptxas": ptxas_of(kname), "card": card}))
        if v == "full":
            next(r for r in rows if r["name"] == "act_rollout")[f"ms_g{ABLATE_G_WIDE}"] = per_launch[ABLATE_G_WIDE]
            continue
        plain_ms = cuda_ms(lambda: act_ablate_plain(acfg, v, 7, G, *aw), 3)
        rows.append({"name": kname, "route": "cuda", "source": "rl6nimmt_torch/csrc/act_ablate_kernel.cu",
                     "replaces": "experiments/act_rollout_ablate.py:47", "launches": path_launches[kname],
                     "main_path_launches": launches[kname], "max_abs_err": errs[kname], "ms": per_launch[G],
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bounds[G][0], "bound_by": bounds[G][1],
                     "library_ms": None, "library_device_ms": None})

    inp = probe_exp.probe_inputs(dev)
    library = yardsticks(inp)
    check_yardsticks(inp, library)   # each yardstick writes a fresh contiguous tensor
    body_line = {"k1": 53, "k2": 66, "k3": 75, "k4": 85, "k5": 96, "k6": 118, "k7": 134}
    for key, label, kernel, twin, args, exact in probe_exp.probes(inp):
        out = kernel(*args)
        nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a)) \
            + out.numel() * out.element_size()
        # f32 multiply-adds of the dots, compares of the argmaxes; the copies have none
        ops = (2 * args[0].numel() * args[1].shape[-1] if key in ("k1", "k6", "k7")
               else args[0].numel() if key == "k3" else 0)
        b_ms, b_by = bound_ms(nbytes, ops)
        ms = cuda_ms(lambda: kernel(*args), 200, REPS)
        dev_ms = device_ms(lambda: kernel(*args), 200, kernel_of[f"probe_{key}"])
        plain_ms = cuda_ms(lambda: twin(*args), 50)
        lib_ms = cuda_ms(library[key], 200, REPS) if library[key] else None
        lib_dev_ms = device_ms(library[key], 200) if library[key] else None
        log(json.dumps({"probe": key, "label": label, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "bytes": nbytes,
                        "ptxas": ptxas_of(f"probe_{key}"), "card": card}))
        rows.append({"name": f"probe_{key}", "route": "cuda", "source": "rl6nimmt_torch/csrc/probe_ops.cu",
                     "replaces": f"experiments/probe_pallas_ops.py:{body_line[key]}",
                     "launches": path_launches[f"probe_{key}"], "main_path_launches": launches[f"probe_{key}"],
                     "max_abs_err": probe_results[key]["max_abs_err"], "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms})

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
