"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rl6nimmt_torch/csrc`` (nvcc, one
process per source), then:

1. prints the card, its power limit, the torch/CUDA versions, the build time
   and ptxas registers/spills per kernel (K4's feature-major entry
   ``act_rollout_fm_kernel`` among them, required present), and requires 0 B
   stack frame and 0 spills of every K1, K2, K3 and K6 ``env``/``obs`` instance
   and of K7's ``probe_k7``;
2. holds K1-K5 against their plain PyTorch twins at the main path's shapes
   (P=4, G=4096, hidden 64): K1-K3 bit-exact (K1 in both layouts, the
   games-last entry also against the row-major one on the transposed state,
   on every one of the 10 turns, and a launch under ``torch.cuda.stream``
   on that stream), K4 with exact deals, action
   agreement >= 0.999 and equal observations/rewards in agreeing games (K4's
   feature-major entry the same against its twin, the row-major twin's
   outputs permuted); K5 at
   capacity 204,800 and ptr 163,840 (tile regions wrap past the ring end) on
   sentinel-filled planes, every written column equal to the twin's in
   agreeing games, pad rows zero and the unwritten columns untouched;
3. replays K4's games on the engine path (``greedy_replay_agreement``) and
   holds K5's planes against the n-step harvests of K4's trajectory in both
   layouts (``insert_planes_agreement``: ``to_transitions`` of the row-major
   one, ``to_transitions_fm`` of the feature-major one);
4. drives the main path with every launch counter at 0: 3 random-rollout
   generations fused (K3), on the engine path (K2 + K1) and games-last (K2 +
   the games-last K1), which must agree bit for bit, then 3 flagship
   Noisy-D3QN-PER-10step cycles (PER 200,000, 8 updates, Adam 1e-3) on the
   engine path, 3 with ``kernel_act_rollout=True`` (K4), 3 with
   ``kernel_insert=True`` (K5, ``per_init_kd`` 204,800), 3 with K4's
   feature-major emit into ``per_init_fm`` 200,000 (``kernel_fm``) and 3 into
   ``per_init_aligned_fm(200,000, G*P*T)`` (``kernel_fm_aligned``, physical
   327,680); each path must launch exactly its kernels, every loss must be
   finite and each buffer's (size, ptr) as its layout says; then two cycles
   from one state and one injected randomness must agree bit for bit, in every
   mode;
5. holds K4's feature-major emit to its row-major emit permuted, bit for bit
   (``fm_agreement``), at G = 4096, 4000 and 33 and hidden 64 and 256; times
   each kernel and its twin with CUDA events (``ms``: per call, the host's
   launch route included) and each kernel on the device alone (``device_ms``:
   its ``torch.profiler`` kernel events per launch), and the rollouts and the
   cycles in env-steps/s, the cycle modes in turns (each mode twice, in the
   order forward then backward); then traces one cycle of each mode;
6. drives the ablation and probe path with every launch counter at 0: the
   act-rollout ablation's entry point (``env``, ``obs``, ``mm`` on K6,
   ``full`` on K4; chains of ABLATE_CHAIN generations) and the probe entry
   point (K7's seven bodies, each against its twin); then holds K6 ``env``
   and ``obs`` bit-exact to their twins, ``env`` to K3 on the same seed (at
   the flagship shape and at P=6, G=333 on the runtime-sized instances) and
   ``mm`` at action agreement >= 0.999, and prints the attribution of K4's
   time: each variant's ms per generation, ms per launch at G=4096 (128
   blocks of 32 games, one per SM) and at G=16,384, its bound and its ptxas
   line; and each probe's ms and device ms beside those of the one PyTorch
   call that computes the same function (a yardstick must not return a view);
7. drives the search core (``agents/device_search.py``,
   ``runtime/device_match.py``): kind-static decisions for the roots
   ``uniform``, ``policy`` and ``puct`` and the kind-traced decision at every
   kind, at mc_max=100 on the (100, 100) policy net, each on blocks of 1 and
   64 openings dealt by K2, timed in ms a decision (host clock after
   ``torch.cuda.synchronize()``) with their K1 launches asserted (ceil(n_mc /
   K) rounds of 10 turns); then, with every counter at 0 just before each, the
   device match of ``device_match_bench`` (128 games, ("puct", "uniform"),
   mc_max=200) and a four-seat match ("puct", "policy", "uniform", "random"),
   each required to launch K2 once and K1 once for every match turn and every
   playout turn and nothing else; then one decision block (G=8, roots
   ``uniform`` and ``puct``, uniform playouts) on the card and on the CPU with
   one noise, whose actions, outcome sums and playout counts must be equal;
   last one traced decision (its device-busy share);
8. drives the REINFORCE and ACER learners (``runtime/vector.py``, through
   ``experiments/trainable_bench.py``'s arms) at G=4096, P=4 on the (100, 100)
   action-in-input net: with every counter at 0 just before it, 3 fused
   REINFORCE steps and 3 ACER cycles with ``packed_rows`` False and True
   (65,536-sequence buffer, minibatch 512, 512 on-policy sequences), each
   step required to launch K2 once and K1 ten times and nothing else, with
   finite losses and params that moved; then their env-steps/s (taken right
   after phase 5's rates, before the first profiler session); after phase 7,
   one REINFORCE step and one ACER cycle on the card and on the CPU on one
   randomness at G=64 (``runtime/learner_check.py``: observations, actions,
   rewards and scores equal, losses and params within float32 tolerance), K1
   and K2 against their twins at the learners' shapes, four host agents
   (REINFORCE, masked REINFORCE, ACER past its warmup, PUCT) learning over
   whole games of the host loop on the card, and last one traced step of each
   learner;
9. drives the tournament (``tournament/tournament.py`` through
   ``runtime/device_tournament.py``) on the published population of
   ``experiments/simple_tournament.py`` (Random, Noisy-D3QN-PER-10step at a
   100,000 buffer, ACER minibatch 10, MCS and PUCT at mc_max 200, all in
   ``train()`` mode, ``Tournament(2, 4)``): with every counter at 0 just before
   it, 2 ``play_game`` and one ``play_block(4)`` on the host path, each game's K2
   and K1 launches asserted (one K2 a game, one K1 a game turn and a playout
   turn), then 3 ``play_device_block(32, bucket=32)`` calls with ``evolve`` before
   the last, each signature group's launches asserted (K2 once, K1 once a turn
   plus each search call's playout turns), ELO zero-sum in every game, every
   learner that took an Adam step moved, games/s and the ``block.learn`` share
   of each call; then 8 games at P=4 seating every family on the card and on the
   CPU on one noise (``runtime/tournament_check.py``), K1 and K2 against their
   twins at every group's shapes, and last one more block of two-seat
   lineups traced for its kernels (device-busy share, launches).  Device
   learning (``runtime/device_learn.py``): before the first device block the
   tournament is pickled, and after it the copy plays the same block again on
   the same ``np.random`` state with ``device_learning=True``: each group must
   launch what the host-learning block's group launched and the whole call
   nothing more, every planner's replay runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no wait for the card), and each
   learner's params must agree with the host-learning copy's (the search
   agents and ring DQNs equal, PER within rtol 1e-4, ACER within 2e-2); both
   blocks' games/s and ``block.learn`` shares are printed;
10. drives the arena (``runtime/arena.py``): with every counter at 0 just
   before each, ``play_match`` of the published learners (Random,
   Noisy-D3QN-PER-10step, ACER) and a REINFORCE agent at P=4, and of ACER
   against an epsilon-greedy D3QN-PER-10step, at G=4096, each required to
   launch K2 once and K1 ten times and nothing else, every game's penalties
   <= 0; their games/s; the four-seat match on the card and on the CPU on one
   injected noise with equal scores; K1 and K2 against their twins at the
   arena's shapes;
11. drives data parallel (``parallel/mesh.py``) and the host extras: (a) NCCL at
   world size 1 in this process, the DP REINFORCE step (the (100, 100) net), the
   DP flagship cycle in modes engine, kernel, kernel_fm and insert and the DP ACER cycle at
   G=4096, each -- with every counter at 0 just before the DP path -- equal to its
   plain step bit for bit and launching its K1/K2/K4/K5 counts a step; their
   env-steps/s beside the plain steps' (in turns), the all-reduces and bytes an
   update and one all-reduce's time; (b) two gloo ranks spawned on the one card:
   2-rank DQN and ACER updates against one rank on the concatenated minibatch,
   params bit-identical across ranks after a DP DQN cycle (insert, 2 x 2048) and
   a DP REINFORCE step (2 x 2048), the 1-rank mesh equal to the plain steps, K1/K2
   and K5 against their twins at 2048 games; (c) the sharded device block equal
   to the unsharded one; (d) ``play_callback_game`` with a scripted human (K2
   once, K1 ten times) and ``train_selfplay --algo dqn --steps 2 --save`` reloaded
   bit for bit;
12. runs the ``main()`` of each experiment script ported with the replay
   layouts, at a depth cut to keep the phase short (each cut in the log),
   with its checks and, where the path's count is exact, its K1/K2/K4/K5
   launches: ``fm_cycle_bench`` (G=4096, every arm, 2 repeats of 1 cycle),
   ``micro_insert`` at its full shape, ``fm_strength_ab`` (1 seed, 3 cycles,
   1,024 eval games), ``train_puct_prior`` (2 iterations of 64 games at mc_max
   128, a 32-game head-to-head), ``long_train_eval`` (both algorithms, a few
   updates and evals), ``strength_vs_budget`` (2 games at mc_max 32 against
   16) and ``play_human --device-game`` with a scripted human;
13. runs the ``main()`` of each evaluation, A/B and profiling script's twin at
   the published widths and a cut depth (each cut in the log), with its checks
   (win rates in [0, 1], scores in [-1040, 0]) and its exact K1/K2 launches:
   ``device_learn_strength_ab`` (1 seed, 16 games in blocks of 8, 1,024 eval
   games, every family; REINFORCE's arms bit-equal), ``device_learn_speedup``
   (16 games in blocks of 8, and 2 pairs; ``DeviceBlockSession.finalize``
   restored), ``profile_devblock`` (2 blocks of 16 games at mc_max 32),
   ``budget_saturation`` (budgets 8 and 16 against 32, 32 games),
   ``devblock_attrib`` (32 games at mc_max 32, 1 rep), ``prior_decoupled_eval``
   (32 games at budget 16, A-D), ``puct_batch_ab`` (32 games, 2 keys, K 8 and
   16 at mc_max 32; every arm dealt the same games), ``devroot_equivalence``
   (2 games at mc_max 16, ``puct`` and ``mcs``) and ``acer_onpolicy_ab`` (2
   cycles an arm at G=4096, 1,024 eval games; peak device memory); then K1
   and K2 against their twins at every shape the scripts launched them at;
14. runs the ``main()`` of each profiler's, micro-benchmark's and debug script's
   twin at the published widths and a cut depth (each cut in the log), with
   its checks and its exact K1/K2/K4/K4 fm launches: ``act_rollout_probe``
   (K4 at G=4096, its structural checks and its engine replay at action
   agreement >= 0.999, chains of 16), ``roofline_cycle`` (the fm cycle and the
   raw fm kernel, chains of 2), ``bench_trainable --dtype bfloat16`` (its
   three learners at JAX's defaults), ``profile_trainable --dtype bfloat16``,
   ``micro_cycle`` to ``micro_cycle5`` (chains of 1; the over-capacity rows of
   ``micro_cycle`` and ``micro_cycle2`` must raise), ``micro_per``, ``micro_acer``,
   ``profile_ab`` (2 seeds, 2 cycles an arm, 1,024 eval games), the three
   ``debug_*`` host games and ``debug_gradflow``; then the bfloat16 forwards of
   the D3QN, REINFORCE and ACER nets and a REINFORCE gradient on the card
   against the CPU's, and K1, K2, K4 and K4 fm against their twins at every
   shape the scripts launched them at.

Prints the ``search``, ``learners``, ``tournament``, ``arena``, ``dp``, ``scripts``, ``evals`` and
``profilers`` JSON lines,
one JSON line of kernels (K1's to K5's rows also carry their launch shape and ptxas line, K2's and
K3's their ms and device ms at G=16,384, K4's its ms there, K1's row-major and
K2's rows their launches on the search, the learners', the tournament's and the
arena's path, K1's row-major, K2's, K4's in both layouts and K5's on the DP
path, K1's, K2's, K4's and K5's on the scripts' path, K1's and K2's on the
evaluation scripts' path, and K1's, K2's and K4's in both layouts on the
profilers' path), the
card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when there
is no CUDA device, when the package is missing, or when any check fails.
"""

import json
import math
import os
import pickle
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
# K6 env's and obs's, the same pair each (they play K3's games in K3's design), and K7's k7.
K6_K7_INSTANCES = tuple(f"act_ablate_{v}_kernel<{sizes}>" for v in ("env", "obs")
                        for sizes in (K2_K3_FLAGSHIP, "0,0,0,0,0")) + ("probe_k7_kernel",)
PER_CAPACITY = 200_000
KD_CAPACITY = 204_800      # bench.py line 3: per_init_kd capacity, 40 x T*P*128
KD_PTR = 163_840           # tile regions from block 8 on wrap past the ring end
LEARN_ITERS = 8
FM_CHECK_GAMES = (G, 4000, 33)    # K4's feature-major emit: the flagship, a ragged last block, one past a block
FM_CHECK_HIDDEN = (HIDDEN, 256)   # one chunk of the hidden layer, four
ABLATE_CHAIN = 32          # generations per timed ablation chain (the JAX script chained 256)
REPS = 5                   # a kernel's per-call ms: the median of this many timed runs
ABLATE_G_WIDE = 16_384     # 4x the main path's games: 512 blocks of 32
FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10,
                hidden_sizes=(HIDDEN,), minibatch=64)
# Phase 7, the search core: the search agents' policy net and the JAX agents' defaults.
SEARCH_HIDDEN = (100, 100)
SEARCH_MC_MAX = 100
SEARCH_GAMES = (1, 64)     # decision blocks
SEARCH_REPS = 3            # timed decisions per program and block
CHECK_GAMES = 8            # the card-against-CPU block
# (label, roster, games, mc_max): the JAX device_match_bench configuration (one call
# of its 128 games), then one match in which every seat kind plays.
MATCHES = (("bench", ("puct", "uniform"), 128, 200),
           ("four_seats", ("puct", "policy", "uniform", "random"), 64, 100))

# Phase 8, the REINFORCE and ACER learners at bench_trainable.py's widths (G, P=4,
# the (100, 100) action-in-input net; ACER: 65,536 sequences, minibatch 512, 512
# on-policy sequences; experiments/trainable_bench.py holds them).
LEARNER_STEPS = 3          # steps or cycles per learner for the rates and the counts
LEARNER_CHECK_GAMES = 64   # the card-against-CPU run
HOST_GAMES = 4             # host-loop games (ACER's warmup needs 3 flushes)
SPANS = ("cycle.", "reinforce.", "acer.")

# Phase 9, the tournament: the published experiment's population
# (experiments/simple_tournament.py:113-125) in Tournament(2, 4); the host
# path's games, then device blocks of RESULTS.md's `--device-blocks --block 32`.
HOST_TOURNAMENT_GAMES = 2  # play_game() calls
HOST_TOURNAMENT_BLOCK = 4  # one play_block() of this many games
TOURNAMENT_BLOCKS = 2      # play_device_block() calls; evolve before the last
TOURNAMENT_BLOCK = 32

# Phase 10, the arena: the published learners (Random, Noisy-D3QN-PER-10step,
# ACER) and a REINFORCE agent at P = 4, and a two-seat match of ACER against an
# epsilon-greedy D3QN-PER-10step, each over ARENA_G games.
ARENA_G = 4096
ARENA_REPS = 3             # timed matches a lineup (after the counted one)
ARENA_CHECK_G = 64         # the card against the CPU on one injected noise
DP_STEPS = 2               # phase 11: steps or cycles of each DP arm on the counted path (and of its plain twin)
DP_RATE_STEPS = 3          # timed steps of each arm, DP and plain, for the rates
DP_G2 = 2048               # games a rank on the two gloo ranks sharing the card

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


def profile_call(fn, label):
    """One traced call: wall time, device busy time, idle share, the host
    time of the phase spans (``cycle.*``: a DQN cycle's three phases;
    ``reinforce.*`` and ``acer.*``: the learners') and the ops with the most
    device time."""
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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith(SPANS)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # Span times on the host clock: the cycle is dispatch-bound, so this is
    # where its time goes.  The profiler's device-side span times were not
    # reliable on the card (a rollout span holding a 3.5 ms kernel read 0.03 ms).
    spans = {e.key: e.cpu_time_total / 1e3 for e in events
             if e.key.startswith(SPANS) and e.device_type == DeviceType.CPU}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"profile": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": sum(e.count for e in kernels),
            "phase_host_ms": spans,
            "top_kernels": [{"kernel": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def trace_kernels(fn, label):
    """One call traced for its device work only (CUDA activity): wall time,
    device busy time (kernel and copy events), idle share, launches and the
    kernels with the most device time, summed from the raw trace events.  A
    tournament block launches ~10^6 kernels; building the profiler's parsed
    event tree for that many takes minutes, reading the raw events seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, calls = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    if not by_name:
        raise AssertionError(f"the trace of {label} holds no device event")
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    return {"profile": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(calls for _, calls in by_name.values()),
            "top_kernels": [{"kernel": k[:70], "device_ms": ms, "calls": calls} for k, (ms, calls) in top]}


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs):
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in pairs)


def k1_k2_against_twins(cfg, sizes, seed, dev):
    """For each game count in ``sizes``: K2's deal against ``deal_games_plain``,
    then every turn of random legal play, K1 against ``resolve_turn_plain``.
    Raises on a difference; returns the largest difference of each kernel."""
    from rl6nimmt_torch.engine import deal, step
    from rl6nimmt_torch.ops.game_kernel import deal_games, deal_games_plain
    from rl6nimmt_torch.ops.step_kernel import resolve_turn, resolve_turn_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"resolve_turn": 0.0, "deal_games": 0.0}
    for games in sizes:
        out_k, out_p = deal_games(cfg, seed, games, device=dev), deal_games_plain(cfg, seed, games, dev)
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
            raise AssertionError(f"K2 deal_games differs from its twin at P={cfg.num_players}, G={games}")
        errs["deal_games"] = max(errs["deal_games"], max_abs_err(zip(out_k, out_p)))
        state = deal(cfg, seed, games, device=dev)
        for t in range(cfg.max_turns):
            hs = state.hands_sorted
            r = torch.floor(torch.rand(hs.shape[:2], generator=gen, device=dev) * (hs >= 0).sum(-1)).long()
            acts = torch.gather(hs, -1, r[..., None]).squeeze(-1).contiguous()
            out_k = resolve_turn(cfg, state.board, state.row_len, acts)
            out_p = resolve_turn_plain(cfg, state.board, state.row_len, acts)
            if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
                raise AssertionError(f"K1 resolve_turn differs from its twin at P={cfg.num_players}, "
                                     f"G={games}, turn {t}")
            errs["resolve_turn"] = max(errs["resolve_turn"], max_abs_err(zip(out_k, out_p)))
            state, _ = step(cfg, state, acts)
    return errs


def search_phase(dev, card):
    """Phase 7, the search core: decisions, the two matches with their launch
    counts, the card against the CPU on one noise, then one traced decision.
    Returns the ``search`` line, the matches' launches and the largest
    K1/K2 differences from their twins at the matches' shapes."""
    from rl6nimmt_torch.agents.device_search import (KIND_PUCT_UNIFORM, KIND_RANDOM, make_device_decision_fn_many,
                                                     make_unified_decision_fn)
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.nets import MLPSpec, mlp_init
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.runtime.device_match import make_device_match_fn, playout_turns_per_seat
    from rl6nimmt_torch.runtime.search_check import card_against_cpu, search_position

    cfg = EnvConfig(4)
    H = cfg.hand_size
    spec = MLPSpec(cfg.state_length + 1, hidden_sizes=SEARCH_HIDDEN, head_sizes=(1,))
    params = mlp_init(torch.Generator(device=dev).manual_seed(70), spec)
    gen = torch.Generator(device=dev).manual_seed(71)

    # The decisions: K2 deals each block's opening, seat 0 searches all H cards.
    programs = {root: (make_device_decision_fn_many(cfg, "uniform" if root == "uniform" else "net", spec, root,
                                                    SEARCH_MC_MAX, 8 if root == "puct" else SEARCH_MC_MAX, 2.0,
                                                    device=dev), None)
                for root in ("uniform", "policy", "puct")}
    unified = make_unified_decision_fn(cfg, spec, SEARCH_MC_MAX, 8, device=dev)
    programs.update({f"unified_kind{k}": (unified, k) for k in range(KIND_PUCT_UNIFORM + 1)})
    ms, launches_per, blocks = {}, {}, {}
    for G in SEARCH_GAMES:
        board, row_len, hand, avail, obs = blocks[G] = search_position(cfg, 72, G, dev)
        for name, (fn, kind) in programs.items():
            if kind is None:
                call = lambda fn=fn: fn(params, board, row_len, hand, H, SEARCH_MC_MAX, avail, obs, gen)
            else:
                n_mc = 0 if kind == KIND_RANDOM else SEARCH_MC_MAX
                call = lambda fn=fn, kind=kind, n_mc=n_mc: fn(params, torch.full((G,), kind), board, row_len, hand,
                                                              H, n_mc, 2.0, avail, obs, gen)
            _build.reset_launches()
            action = call()[0]
            torch.cuda.synchronize()
            launches_per[f"G{G}_{name}"] = dict(_build.LAUNCHES)["resolve_turn"]
            if not (hand == action[:, None]).any(dim=1).all():
                raise AssertionError(f"decision {name} at G={G} chose a card outside the hand")
            ms[f"G{G}_{name}"] = host_seconds(call, SEARCH_REPS) * 1e3
    log(f"[7] ms a decision at mc_max={SEARCH_MC_MAX}, P={cfg.num_players}, net {SEARCH_HIDDEN}: "
        f"{ {k: round(v, 2) for k, v in ms.items()} }; K1 launches a decision {launches_per}")
    for name, got in launches_per.items():
        root = name.split("_", 1)[1]
        K = 8 if root.startswith("unified") or root == "puct" else SEARCH_MC_MAX
        want = 0 if root == f"unified_kind{KIND_RANDOM}" else -(-SEARCH_MC_MAX // K) * H
        if got != want:
            raise AssertionError(f"decision {name} launched K1 {got} times, expected {want}")

    # The matches: every counter at 0 just before each, read just after.
    matches, path_launches = {}, {k: 0 for k in _build.LAUNCHES}
    for label, roster, games, mc_max in MATCHES:
        mcfg = EnvConfig(len(roster))
        mspec = MLPSpec(mcfg.state_length + 1, hidden_sizes=SEARCH_HIDDEN, head_sizes=(1,))
        mparams = mlp_init(torch.Generator(device=dev).manual_seed(73), mspec)
        fn = make_device_match_fn(mcfg, roster, mspec, games, mc_max=mc_max, device=dev)
        seat_params = tuple(mparams if k in ("puct", "policy") else None for k in roster)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        scores = fn(seat_params, torch.Generator(device=dev).manual_seed(74))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in got.items():
            path_launches[k] += v
        searchers = sum(k != "random" for k in roster)
        want = {"deal_games": 1, "resolve_turn": mcfg.max_turns + searchers * playout_turns_per_seat(mcfg, mc_max)}
        if got != want:
            raise AssertionError(f"match {label} launched {got}, expected {want}")
        if scores.shape != (games, len(roster)) or not (torch.isfinite(scores).all() and (scores <= 0).all()):
            raise AssertionError(f"match {label}: scores of shape {tuple(scores.shape)} must be finite and <= 0")
        mean = scores.mean(dim=0).tolist()
        matches[label] = {"roster": list(roster), "games": games, "mc_max": mc_max, "wall_s": wall,
                          "games_per_s": games / wall, "launches": got, "mean_score": mean}
        log(f"[7] match {label} {roster}, {games} games, mc_max {mc_max}: {wall:.2f} s, "
            f"{games / wall:.1f} games/s, launches {got}, mean scores {[round(x, 3) for x in mean]}")

    # The card against the CPU on one noise drawn on the CPU: the G=8 block, then
    # each match's shapes (P seats, its games dealt by K2, K1 over games x 8 playouts).
    agree = {}
    checks = [("block", cfg, CHECK_GAMES)] + [(label, EnvConfig(len(roster)), games)
                                              for label, roster, games, _ in MATCHES]
    for label, ccfg, games in checks:
        cspec = MLPSpec(ccfg.state_length + 1, hidden_sizes=SEARCH_HIDDEN, head_sizes=(1,))
        for root in ("uniform", "puct"):
            out = card_against_cpu(ccfg, cspec, root, games, 8, SEARCH_MC_MAX, seed=75)
            if not out["equal"]:
                raise AssertionError(f"search on the card differs from the CPU ({label}, root {root}): actions "
                                     f"{out['card'][0].tolist()} vs {out['cpu'][0].tolist()}")
            agree[f"{label}_{root}"] = {"players": ccfg.num_players, "games": games, "lanes": games * 8,
                                        "playouts": int(out["card"][2].sum())}
    log(f"[7] card == CPU on one noise (K=8, uniform playouts, mc_max {SEARCH_MC_MAX}): positions, actions, sums "
        f"and counts equal for {agree}")
    # K1 and K2 against their twins at each match's shapes: the deal, then ten
    # turns of random legal cards at its games (a match turn) and games x 8 (a playout turn).
    twin_errs = {"resolve_turn": 0.0, "deal_games": 0.0}
    for label, roster, games, _ in MATCHES:
        mcfg = EnvConfig(len(roster))
        for err_k, err in k1_k2_against_twins(mcfg, (games, games * 8), 76, dev).items():
            twin_errs[err_k] = max(twin_errs[err_k], err)
    log(f"[7] K1 and K2 bit-exact vs twins at the matches' shapes "
        f"{[(len(r), g, g * 8) for _, r, g, _ in MATCHES]} (P, games, playout lanes)")

    # Last: one traced decision (PUCT over net playouts, G = the larger block).
    G = SEARCH_GAMES[-1]
    board, row_len, hand, avail, obs = blocks[G]
    puct = programs["puct"][0]
    traced = profile_call(lambda: puct(params, board, row_len, hand, H, SEARCH_MC_MAX, avail, obs, gen),
                          f"search_decision_puct_G{G}")
    log(json.dumps(traced))
    return {"search": {"ms_per_decision": ms, "resolve_turn_per_decision": launches_per, "matches": matches,
                       "card_vs_cpu": agree, "profile": {k: traced[k] for k in ("profile", "wall_ms", "device_busy_ms",
                                                                              "idle_share", "kernel_launches")},
                       "mc_max": SEARCH_MC_MAX, "hidden": list(SEARCH_HIDDEN), "card": card}}, path_launches, twin_errs


def learner_rates(dev, card):
    """Phase 8's path, with every counter at 0 just before it: LEARNER_STEPS
    REINFORCE steps and ACER cycles (``packed_rows`` False and True) at full
    width, each step's launches asserted (K2 1, K1 10); then the rates (host
    clock after ``torch.cuda.synchronize()``, before any profiler session).
    Returns the rates line, the path's launches and the arms."""
    from rl6nimmt_torch.agents.dqn import tree_leaves
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments.trainable_bench import AcerArm, ReinforceArm, seconds_per_step
    from rl6nimmt_torch.ops import _build

    cfg = EnvConfig(4)
    arms = {"reinforce": ReinforceArm(cfg, G, dev), "acer": AcerArm(cfg, G, dev),
            "acer_packed": AcerArm(cfg, G, dev, packed=True)}
    start = {name: [x.clone() for x in tree_leaves(arm.params)] for name, arm in arms.items()}
    want = {"deal_games": 1, "resolve_turn": cfg.max_turns}
    torch.cuda.synchronize()
    _build.reset_launches()
    # ---- the learners' path: every counter starts at 0 here ----
    out, path = {}, {k: 0 for k in _build.LAUNCHES}
    for name, arm in arms.items():
        steps = []
        for i in range(LEARNER_STEPS):
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            m = arm.step()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
            if got != want:
                raise AssertionError(f"{name} step {i} launched {got}, expected {want}")
            steps.append({"s": sec, **{k: float(v) for k, v in m.items()}})
        leaves = tree_leaves(arm.params)
        if not all(math.isfinite(v) for st in steps for v in st.values()) \
                or not all(torch.isfinite(x).all() for x in leaves):
            raise AssertionError(f"{name}: non-finite losses or params {steps}")
        if all(torch.equal(a, b) for a, b in zip(leaves, start[name])):
            raise AssertionError(f"{name}: {LEARNER_STEPS} steps left the params unchanged")
        out[name] = steps
        log(f"[8] {name} at G={G}: {[{k: round(v, 5) for k, v in st.items()} for st in steps]}")
    torch.cuda.synchronize()
    for k, v in _build.LAUNCHES.items():
        path[k] += v
    # ---- end of the learners' path ----
    rates = {}
    for name, arm in arms.items():
        sec = seconds_per_step(arm, 5, warmup=1)
        rates[f"{name}_env_steps_per_s"] = G * cfg.max_turns / sec
        log(json.dumps({"metric": f"trainable env-steps/s, {name}", "value": rates[f"{name}_env_steps_per_s"],
                        "seconds_per_step": sec, "games": G, "card": card}))
    return {"steps": out, "rates": rates}, path, arms


def learner_checks(dev):
    """Phase 8's checks: the card against the CPU on one randomness (G=64),
    K1/K2 against their twins at the learners' shapes, and the four host agents
    learning over whole games of the host loop on the card."""
    from rl6nimmt_torch.agents.acer import BatchedACERAgent
    from rl6nimmt_torch.agents.dqn import tree_leaves
    from rl6nimmt_torch.agents.mcs import PUCTAgent
    from rl6nimmt_torch.agents.reinforce import BatchedReinforceAgent, MaskedReinforceAgent
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.runtime.host_loop import play_games
    from rl6nimmt_torch.runtime.learner_check import learners_card_against_cpu

    t0 = time.perf_counter()
    check = learners_card_against_cpu(LEARNER_CHECK_GAMES)
    if not check["equal"]:
        raise AssertionError(f"learners on the card differ from the CPU: "
                             f"{ {k: v for k, v in check['exact'].items() if not v} } "
                             f"{ {k: v for k, v in check['f32'].items() if v > 1.0} }")
    worst = max(check["f32"].items(), key=lambda kv: kv[1])
    log(f"[8] card == CPU at G={LEARNER_CHECK_GAMES} on one randomness ({time.perf_counter() - t0:.1f} s): "
        f"{len(check['exact'])} integer outputs equal (observations, legal sets, actions, rewards, scores); "
        f"{len(check['f32'])} float outputs within rtol 1e-5, atol 1e-6 x max|x| (worst {worst[0]}: "
        f"{worst[1]:.3f} of the tolerance)")
    twin_errs = k1_k2_against_twins(EnvConfig(4), (G, LEARNER_CHECK_GAMES), 81, dev)
    log(f"[8] K1 and K2 bit-exact vs twins at the learners' shapes (P=4, G={G} and {LEARNER_CHECK_GAMES})")

    agents = {"reinforce": BatchedReinforceAgent(seed=1, device=dev),
              "masked_reinforce": MaskedReinforceAgent(seed=2, device=dev),
              "acer": BatchedACERAgent(seed=3, warmup=2, minibatch=2, device=dev),
              "puct": PUCTAgent(seed=4, mc_max=8, mc_per_card=2, device=dev)}
    start = {k: [x.clone() for x in tree_leaves(a.parameters())] for k, a in agents.items()}
    for a in agents.values():
        a.train()
    t0 = time.perf_counter()
    results = play_games(list(agents.values()), num_games=HOST_GAMES, seed=82, device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    moved = {k: any(not torch.equal(x, y) for x, y in zip(tree_leaves(a.parameters()), start[k]))
             for k, a in agents.items()}
    if not all(moved.values()) or not (results <= 0).all():
        raise AssertionError(f"host agents on the card: params moved {moved}, scores {results.tolist()}")
    if agents["acer"].opt_state.count != 2 * (HOST_GAMES - 2):   # one on- and one off-policy update a flush past warmup
        raise AssertionError(f"ACER ran {agents['acer'].opt_state.count} updates")
    log(f"[8] host agents on the card ({HOST_GAMES} games, {sec:.1f} s): params moved {moved}, "
        f"Adam steps {({k: a.opt_state.count for k, a in agents.items()})}, scores {results.tolist()}")
    return {"card_vs_cpu": {"exact": len(check["exact"]), "f32": len(check["f32"]), "worst": worst},
            "host_agents": {"games": HOST_GAMES, "seconds": sec, "adam_steps":
                            {k: a.opt_state.count for k, a in agents.items()}}}, twin_errs


def host_search_turns(agent, n):
    """K1 launches of one host search call at ``n`` cards (``mcs.py`` ``_mcts_many``):
    rounds of ``batch_playouts`` (MCS: all ``n_mc`` at once) of ``n`` playout
    turns; a single card is played without a search."""
    if n == 1:
        return 0
    n_mc = min(agent.mc_max, agent.mc_per_card * math.factorial(n))
    return -(-n_mc // (agent.batch_playouts or n_mc)) * n


def block_launches(session, cap):
    """A device block's launches and playout widths, rebuilt from its lineups:
    K2 once; K1 once a game turn and, every turn, ceil(n_mc / K) rounds of n
    playout turns for each search call -- one for the seats without a net
    (random, MCS) and one for each PUCT agent, seats x K lanes wide.  K is the
    session's, or, with no PUCT seat, the budgets' pow2 ceiling up to ``cap``
    lanes a seat."""
    from rl6nimmt_torch.agents import DrunkHamster, MCSAgent, PUCTAgent

    seats = [a for lineup in session.lineups for a in lineup]
    if any(isinstance(a, PUCTAgent) for a in seats):
        K = session.batch
    else:
        ceiling = max([session.batch] + [a.mc_max for a in seats if isinstance(a, MCSAgent)])
        K = min(1 << (ceiling - 1).bit_length(), cap)
    calls = {}
    for a in seats:
        if isinstance(a, (DrunkHamster, MCSAgent, PUCTAgent)):
            calls.setdefault(id(a) if isinstance(a, PUCTAgent) else None, []).append(a)
    k1 = session.cfg.max_turns
    for n in range(1, session.cfg.hand_size + 1):
        for group in calls.values():
            n_mc = max(min(a.mc_max, a.mc_per_card * math.factorial(n)) if hasattr(a, "mc_max") else 0
                       for a in group)
            k1 += -(-n_mc // K) * n
    return {"deal_games": 1, "resolve_turn": k1}, {len(group) * K for group in calls.values()}


def device_block(t, b, sessions, shapes, device_learning):
    """One ``play_device_block(TOURNAMENT_BLOCK)`` of ``t`` with each group's
    launches asserted (``sessions`` collects the dispatched groups and their
    launches) and the whole call launching nothing more (the learn replay, on
    the host or the device, launches no K1/K2); every learner that took an Adam
    step moved.  With ``device_learning`` every planner's replay runs under
    ``torch.cuda.set_sync_debug_mode("error")``: it must not wait for the card.
    Returns the block's record and its groups."""
    from rl6nimmt_torch.agents.dqn import tree_leaves
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.runtime import device_learn as dl
    from rl6nimmt_torch.runtime import device_tournament as dtm

    learners = {n: (r.agent.opt_state.count, [x.clone() for x in tree_leaves(r.agent.parameters())])
                for n, r in t.players.items() if r.active and r.agent.parameters() is not None
                and r.agent.opt_state is not None}
    planners = (dl.DQNPlanner, dl.ACERPlanner, dl.ReinforcePlanner)
    originals = [p.dispatch for p in planners]
    replays = []
    # The learn time of the device-learnable agents alone: their host ``learn``
    # calls, or their planners' bookkeeping, dispatch and install.
    learners_s = [0.0]

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                learners_s[0] += time.perf_counter() - t0
        return run

    if device_learning:
        methods = [(p, m) for p in planners for m in ("on_step", "dispatch", "finalize")]
    else:
        from rl6nimmt_torch.agents import BatchedACERAgent, BatchedReinforceAgent, DQNAgent, MaskedReinforceAgent
        methods = [(c, "learn") for c in (DQNAgent, BatchedACERAgent, BatchedReinforceAgent, MaskedReinforceAgent)]
    saved = [(c, m, c.__dict__.get(m)) for c, m in methods]

    def unsynced(dispatch):
        def run(self):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = dispatch(self)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            replays.append(type(self).__name__)
            return out
        return run

    first_session = len(sessions)
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    if device_learning:
        for p, dispatch in zip(planners, originals):
            p.dispatch = unsynced(dispatch)
    for c, m, _ in saved:
        setattr(c, m, timed(getattr(c, m)))
    try:
        t.play_device_block(TOURNAMENT_BLOCK, bucket=TOURNAMENT_BLOCK, device_learning=device_learning)
        torch.cuda.synchronize()
    finally:
        for c, m, fn in saved:
            if fn is None:
                delattr(c, m)
            else:
                setattr(c, m, fn)
        for p, dispatch in zip(planners, originals):
            p.dispatch = dispatch
    wall = time.perf_counter() - t0
    whole = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    groups, total = [], {}
    for session, got in sessions[first_session:]:
        want, lanes = block_launches(session, dtm.SINGLE_ROUND_CAP)
        shapes.setdefault(session.cfg.num_players, set()).update(lanes | {len(session.lineups)})
        if got != want:
            raise AssertionError(f"block {b}: a group of {len(session.lineups)} games at "
                                 f"P={session.cfg.num_players} launched {got}, expected {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        groups.append({"games": len(session.lineups), "players": session.cfg.num_players,
                       "launches": got, **session.timings})
    if sum(g["games"] for g in groups) != TOURNAMENT_BLOCK:
        raise AssertionError(f"block {b}: its device groups played {[g['games'] for g in groups]} games")
    if whole != total:
        raise AssertionError(f"block {b}: the call launched {whole}, its groups' play {total}")
    moved = {}
    for n, (count, start) in learners.items():
        agent = t.players[n].agent
        if agent.opt_state.count > count:
            moved[n] = any(not torch.equal(x, y) for x, y in zip(tree_leaves(agent.parameters()), start))
    if not all(moved.values()):
        raise AssertionError(f"block {b}: learners that learned but did not move: {moved}")
    if device_learning and not replays:
        raise AssertionError(f"block {b}: device learning ran no planner")
    learn_s = sum(g["replay_s"] for g in groups)
    block = {"wall_s": wall, "games_per_s": TOURNAMENT_BLOCK / wall, "learn_s": learn_s,
             "learn_share": learn_s / wall, "play_s": sum(g["device_s"] for g in groups),
             "groups": groups, "learned": sorted(moved), "device_learning": device_learning,
             "device_replays": sorted(set(replays)), "learners_learn_s": learners_s[0]}
    log(f"[9] device block {b} ({TOURNAMENT_BLOCK} games, {len(groups)} groups"
        f"{', device learning' if device_learning else ''}): {wall:.2f} s, {TOURNAMENT_BLOCK / wall:.2f} games/s, "
        f"block.learn {learn_s:.2f} s (the DQN/ACER/REINFORCE agents' {learners_s[0]:.2f} s); learned "
        f"{sorted(moved)}; launches a group {[g['launches'] for g in groups]}")
    return block, groups


# Host replay against device replay, each learner's params after the same
# block (tests/test_torch_device_learn.py): ring DQNs and REINFORCE bit for bit,
# PER within its float32 bookkeeping, ACER over a block; the agents that learn
# on the host in both copies (the search agents) equal.
TWIN_TOLERANCE = {"per": (1e-4, 1e-6), "acer": (2e-2, 1e-4)}


def twins_agree(t, twin):
    """Each learner of ``t`` (host learning) against its copy in ``twin``
    (device learning): params within the CPU test's tolerance, equal Adam
    counts, a DQN's host buffer size equal to its device buffer's.  Returns the
    largest difference a learner."""
    from rl6nimmt_torch.agents import BatchedACERAgent, DQNAgent
    from rl6nimmt_torch.agents.dqn import tree_leaves

    worst = {}
    for n, r in t.players.items():
        a, d = r.agent, twin.players[n].agent
        if a.parameters() is None or a.opt_state is None or a.opt_state.count == 0:
            continue
        if a.opt_state.count != d.opt_state.count:
            raise AssertionError(f"{n}: {a.opt_state.count} Adam steps on the host, {d.opt_state.count} on the device")
        kind = "per" if isinstance(a, DQNAgent) and a.cfg.per else "acer" if isinstance(a, BatchedACERAgent) else None
        rtol, atol = TWIN_TOLERANCE.get(kind, (0.0, 0.0))
        err = 0.0
        for x, y in zip(tree_leaves(a.parameters()), tree_leaves(d.parameters())):
            if not torch.allclose(y, x, rtol=rtol, atol=atol):
                raise AssertionError(f"{n}: device-learned params differ from the host-learned beyond "
                                     f"rtol {rtol}, atol {atol}: {float((x - y).abs().max())}")
            err = max(err, float((x - y).abs().max()))
        if isinstance(a, DQNAgent) and len(a.history) != d._device_replay["size"]:
            raise AssertionError(f"{n}: host buffer {len(a.history)}, device buffer {d._device_replay['size']}")
        worst[n] = err
    if not worst:
        raise AssertionError("no learner took an Adam step in the compared block")
    return worst


def tournament_phase(dev, card):
    """Phase 9, the tournament: the published population on the host path
    (play_game, play_block) and the device path (play_device_block, evolve
    before the last block; the first block played again on a pickled copy with
    device learning, :func:`device_block`, :func:`twins_agree`), each launch
    count asserted; ELO zero-sum; the
    learners that learned moved; then the card against the CPU on one noise,
    K1/K2 against their twins at the blocks' shapes, and last one traced block.
    Returns the ``tournament`` line, the path's launches and the twin errors."""
    import numpy as np

    from rl6nimmt_torch.agents import MCSAgent, PUCTAgent
    from rl6nimmt_torch.buffers.host import _native
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments.simple_tournament import population
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.runtime import device_tournament as dtm
    from rl6nimmt_torch.runtime.tournament_check import tournament_card_against_cpu
    from rl6nimmt_torch.tournament import Tournament

    # The host replay's native sum tree (D3QN's PER) builds with g++ at its first
    # sample in a process; build it here, so that no timed block pays for it.
    _native()

    np.random.seed(90)
    t = Tournament(min_players=2, max_players=4, device=dev)
    for name, agent in population(91, device=dev).items():
        agent.train()
        t.add_player(name, agent)
    games, sessions = [], []
    score_game, dispatch = t.score_game, dtm.DeviceBlockSession.dispatch

    def scored(names, scores):
        before = sum(t.players[n].elos[-1] for n in names)
        score_game(names, scores)
        games.append((list(names), sum(t.players[n].elos[-1] for n in names) - before))

    def dispatched(self):
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        out = dispatch(self)
        torch.cuda.synchronize()
        sessions.append((self, {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}))
        return out

    t.score_game = scored
    dtm.DeviceBlockSession.dispatch = dispatched
    searchers = lambda names: [t.players[n].agent for n in names
                               if isinstance(t.players[n].agent, (MCSAgent, PUCTAgent))]
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        # ---- the tournament's path: every counter starts at 0 here ----
        host = {}
        t0 = time.perf_counter()
        for _ in range(HOST_TOURNAMENT_GAMES):
            before = dict(_build.LAUNCHES)
            t.play_game()
            got = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
            names = games[-1][0]
            want = {"deal_games": 1, "resolve_turn": 10 + sum(host_search_turns(a, n) for a in searchers(names)
                                                              for n in range(1, 11))}
            if got != want:
                raise AssertionError(f"play_game {names} launched {got}, expected {want}")
        before, first = dict(_build.LAUNCHES), len(games)
        t.play_block(HOST_TOURNAMENT_BLOCK)
        got = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        block_games = [names for names, _ in games[first:]]
        counts = {}   # (agent, players): the block's search calls group games by player count
        for names in block_games:
            for a in searchers(names):
                counts[(id(a), len(names))] = a
        want = {"deal_games": HOST_TOURNAMENT_BLOCK,
                "resolve_turn": 10 * HOST_TOURNAMENT_BLOCK + sum(host_search_turns(a, n) for a in counts.values()
                                                                 for n in range(1, 11))}
        if got != want:
            raise AssertionError(f"play_block {block_games} launched {got}, expected {want}")
        torch.cuda.synchronize()
        host = {"games": HOST_TOURNAMENT_GAMES + HOST_TOURNAMENT_BLOCK, "seconds": time.perf_counter() - t0,
                "launches": {k: v for k, v in _build.LAUNCHES.items() if v}}
        log(f"[9] host path: {HOST_TOURNAMENT_GAMES} play_game + play_block({HOST_TOURNAMENT_BLOCK}) in "
            f"{host['seconds']:.1f} s, launches {host['launches']} (each game's asserted)")

        blocks, shapes, twin = [], {}, None
        for b in range(TOURNAMENT_BLOCKS):
            if b == TOURNAMENT_BLOCKS - 1:
                t.evolve(max_players=6, max_per_descendant=2, copies=(2,))
            if b == 0:
                # The device-learning copy: the tournament as it stands (agents,
                # generators, buffers), to play this block again on the same
                # np.random state with device_learning=True.
                del t.score_game        # the counting patch is a closure; it stays off the copy
                twin, rng_state = pickle.loads(pickle.dumps(t)), np.random.get_state()
                t.score_game = scored
            block, groups = device_block(t, b, sessions, shapes, device_learning=False)
            blocks.append(block)
            if b == 0:
                after = np.random.get_state()
                np.random.set_state(rng_state)
                learning, twin_groups = device_block(twin, b, sessions, shapes, device_learning=True)
                np.random.set_state(after)
                if [g["launches"] for g in twin_groups] != [g["launches"] for g in groups]:
                    raise AssertionError(f"device learning changed the groups' launches: "
                                         f"{[g['launches'] for g in twin_groups]} against "
                                         f"{[g['launches'] for g in groups]}")
                learning["params_vs_host_learning"] = twins_agree(t, twin)
                log(f"[9] device learning, block {b} again on a copy: {learning['wall_s']:.2f} s, "
                    f"{learning['games_per_s']:.2f} games/s (host learning {block['games_per_s']:.2f}), "
                    f"block.learn {learning['learn_s']:.2f} s = {100 * learning['learn_share']:.1f} % of the block "
                    f"(host learning {100 * block['learn_share']:.1f} %; PERF.md's earlier blocks: 9.8-16.8 %); the DQN/ACER/REINFORCE "
                    f"agents' learn {learning['learners_learn_s']:.2f} s (host {block['learners_learn_s']:.2f} s); "
                    f"the same launches "
                    f"a group; params against the host-learning copy {learning['params_vs_host_learning']}")
        torch.cuda.synchronize()
        path_launches = dict(_build.LAUNCHES)
        # ---- end of the tournament's path ----
    finally:
        dtm.DeviceBlockSession.dispatch = dispatch
        del t.score_game
    worst_elo = max(abs(d) for _, d in games)
    if worst_elo > 1e-9:
        raise AssertionError(f"ELO not zero-sum: {worst_elo}")
    learned = set().union(*(b["learned"] for b in blocks))
    if not any(n.startswith("D3QN") for n in learned) or not any(n.startswith("Alpha0.5") for n in learned):
        raise AssertionError(f"the D3QN and Alpha0.5 lineages must learn in the device blocks: {sorted(learned)}")
    log(f"[9] {len(games)} games scored, ELO zero-sum within {worst_elo:.3g}; tournament path launches "
        f"{ {k: v for k, v in path_launches.items() if v} }")
    log(str(t))

    t0 = time.perf_counter()
    check = tournament_card_against_cpu()
    if not check["equal"]:
        raise AssertionError(f"the tournament block on the card differs from the CPU: "
                             f"{ {k: v for k, v in check['exact'].items() if not v} } "
                             f"{ {k: v for k, v in check['f32'].items() if v > 1.0} }")
    worst = max(check["f32"].items(), key=lambda kv: kv[1])
    log(f"[9] card == CPU on one noise ({time.perf_counter() - t0:.1f} s; 8 games at P=4 seating every family): "
        f"{sorted(check['exact'])} equal; {worst[0]} within {worst[1]:.3f} of the float32 tolerance")
    cfg, seed, g = check["deal"]
    from rl6nimmt_torch.ops.game_kernel import deal_games, deal_games_plain
    from rl6nimmt_torch.ops.step_kernel import resolve_turn, resolve_turn_plain

    errs = {"deal_games": 0.0, "resolve_turn": 0.0}
    out_k, out_p = deal_games(cfg, seed, g, device=dev), deal_games_plain(cfg, seed, g, "cpu")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(out_k, out_p)):
        raise AssertionError("K2 differs from its twin at the check block's deal")
    errs["deal_games"] = max_abs_err((a.cpu(), b) for a, b in zip(out_k, out_p))
    for board, row_len, acts in check["k1_inputs"]:
        out_k = resolve_turn(cfg, board.to(dev), row_len.to(dev), acts.to(dev))
        out_p = resolve_turn_plain(cfg, board, row_len, acts)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(out_k, out_p)):
            raise AssertionError("K1 differs from its twin on the check block's turns")
        errs["resolve_turn"] = max(errs["resolve_turn"], max_abs_err((a.cpu(), b) for a, b in zip(out_k, out_p)))
    shapes.setdefault(cfg.num_players, set()).update(check["lanes"])
    shapes = {p: sorted(sizes) for p, sizes in sorted(shapes.items())}
    for players, sizes in shapes.items():
        for name, err in k1_k2_against_twins(EnvConfig(players), sizes, 92, dev).items():
            errs[name] = max(errs[name], err)
    log(f"[9] K1 and K2 bit-exact vs twins on the check block's deal and turns, and at every group's games "
        f"and playout lanes {shapes} (players: sizes)")

    # Last: one more block, traced (it plays on, so it is not part of the counted
    # path); its groups' host-clock split gives the block.play/block.learn spans.
    # Two-seat lineups: a mixed block's ~10^6 launches cost ~50 s of profiler
    # post-processing, two seats' block about a third of them.
    traced_sessions = []

    def seen(self):
        traced_sessions.append(self)
        return dispatch(self)

    dtm.DeviceBlockSession.dispatch = seen
    try:
        traced = trace_kernels(lambda: t.play_device_block(TOURNAMENT_BLOCK, num_players=2, bucket=TOURNAMENT_BLOCK),
                               f"tournament_device_block_{TOURNAMENT_BLOCK}_two_seats")
    finally:
        dtm.DeviceBlockSession.dispatch = dispatch
    traced["phase_host_ms"] = {"block.play": 1e3 * sum(s.timings["device_s"] for s in traced_sessions),
                               "block.learn": 1e3 * sum(s.timings["replay_s"] for s in traced_sessions)}
    log(json.dumps(traced))
    line = {"players": sorted(t.players), "block_shapes": shapes,
            "host": host, "device_blocks": blocks, "elo_zero_sum_max": worst_elo,
            "games_per_s": [b["games_per_s"] for b in blocks], "learn_share": [b["learn_share"] for b in blocks],
            "device_learning_block": learning,
            "card_vs_cpu": {"exact": len(check["exact"]), "f32": check["f32"]},
            "profile": {k: traced[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "kernel_launches",
                                               "phase_host_ms")},
            "card": card}
    return line, path_launches, errs


def arena_phase(dev, card):
    """Phase 10, the arena (``runtime/arena.py``): with every launch counter at
    0 just before each, ``play_match`` of the four-seat and the two-seat lineup
    at ARENA_G games, each required to launch K2 once and K1 ten times and
    nothing else, every game's penalties <= 0; then its games/s (the median of
    ARENA_REPS more matches); the four-seat match on the card and on the CPU on
    one injected noise, with equal scores; K1 and K2 against their twins at the
    arena's shapes.  Returns the ``arena`` line, the path's launches and the
    twin errors."""
    import numpy as np

    from rl6nimmt_torch.agents import BatchedReinforceAgent, D3QN_PRB_NStep
    from rl6nimmt_torch.agents.dqn import eps_func_decay
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments.simple_tournament import population
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.runtime import play_match, seat_policy_of
    from rl6nimmt_torch.runtime.arena import ArenaNoise, draw_seat

    pop = population(93, device=dev)
    reinforce = BatchedReinforceAgent(seed=97, device=dev)
    greedy = D3QN_PRB_NStep(history_length=100_000, n_steps=10, seed=98, device=dev)
    greedy.eps = eps_func_decay(400)        # epsilon-greedy past 400 episodes: both branches act
    lineups = {"four_seat": [pop["Random"], pop["D3QN"], pop["ACER"], reinforce],
               "two_seat": [pop["ACER"], greedy]}
    path = {}
    matches = {}
    for name, agents in lineups.items():
        torch.cuda.synchronize()
        _build.reset_launches()
        scores = play_match(agents, ARENA_G, seed=94, device=dev)
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        if got != {"deal_games": 1, "resolve_turn": 10}:
            raise AssertionError(f"arena {name}: launched {got}, expected K2 once and K1 ten times")
        for k, v in got.items():
            path[k] = path.get(k, 0) + v
        if scores.shape != (ARENA_G, len(agents)) or not (scores <= 0).all() or not (scores.sum(1) < 0).all():
            raise AssertionError(f"arena {name}: scores of shape {scores.shape}, max {scores.max()}")
        walls = []
        for r in range(ARENA_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            play_match(agents, ARENA_G, seed=95 + r, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]
        matches[name] = {"players": len(agents), "games": ARENA_G, "launches": got, "match_s": walls,
                         "games_per_s": ARENA_G / wall, "mean_score": scores.mean(0).tolist()}
        log(f"[10] arena {name} ({[type(a).__name__ for a in agents]}, {ARENA_G} games): launches {got}; "
            f"{1e3 * wall:.1f} ms a match, {ARENA_G / wall:.0f} games/s; mean scores {scores.mean(0).round(2)}")

    agents = lineups["four_seat"]
    gen = torch.Generator().manual_seed(96)
    policies = [seat_policy_of(a)[0] for a in agents]
    noise = ArenaNoise(deal_seed=int(torch.randint(0, 2**62, (1,), generator=gen)),
                       turns=[[draw_seat(p, gen, ARENA_CHECK_G, 10) for p in policies] for _ in range(10)])
    on_card = play_match(agents, ARENA_CHECK_G, device=dev, noise=noise)
    on_cpu = play_match(agents, ARENA_CHECK_G, device="cpu", noise=noise)
    if not np.array_equal(on_card, on_cpu):
        raise AssertionError(f"the arena on the card differs from the CPU in "
                             f"{int((on_card != on_cpu).any(1).sum())} of {ARENA_CHECK_G} games")
    log(f"[10] the four-seat match on the card == on the CPU on one noise ({ARENA_CHECK_G} games)")
    errs = {"resolve_turn": 0.0, "deal_games": 0.0}
    for players in sorted({len(a) for a in lineups.values()}):
        for k, err in k1_k2_against_twins(EnvConfig(players), [ARENA_G, ARENA_CHECK_G], 99, dev).items():
            errs[k] = max(errs[k], err)
    log(f"[10] K1 and K2 bit-exact vs twins at the arena's shapes (P 2 and 4; G {ARENA_G} and {ARENA_CHECK_G})")
    return {"matches": matches, "card_vs_cpu_games": ARENA_CHECK_G, "card": card}, path, errs


def dp_arms(cfg, dev):
    """Phase 11(a)'s arms: ``{name: (fresh_state, make_step, updates)}``; a step
    is ``make_step(mesh)`` (the plain step for ``mesh=None``), called as
    ``step(state, generator) -> (state, metrics)``.  REINFORCE (G, the (100,
    100) net, Adam 1e-3), the flagship DQN cycle in modes engine, kernel,
    kernel_fm and insert (G, PER 200,000 row-major or feature-major, or the kd
    planes, LEARN_ITERS updates) and ACER at
    ``bench_trainable.py``'s widths."""
    from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from rl6nimmt_torch.buffers import per_init, per_init_fm, per_init_kd, seq_init
    from rl6nimmt_torch.experiments import trainable_bench as tb
    from rl6nimmt_torch.nets import MLPSpec, mlp_init
    from rl6nimmt_torch.ops.act_rollout_kernel import S_PAD, SCAL_ROWS
    from rl6nimmt_torch.parallel import make_dp_acer_step, make_dp_dqn_step, make_dp_reinforce_step
    from rl6nimmt_torch.runtime import vector

    adam = Adam(1e-3)
    init = lambda spec, seed: mlp_init(torch.Generator(device=dev).manual_seed(seed), spec, dev)
    rspec = MLPSpec(cfg.state_length + 1, hidden_sizes=tb.HIDDEN, head_sizes=(1,))
    aspec = MLPSpec(cfg.state_length + 1, hidden_sizes=tb.HIDDEN, head_sizes=(1, 1))
    dqn = DQNConfig(**FLAGSHIP)
    qspec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)

    def reinforce(mesh):
        fn = vector.make_reinforce_train_step(cfg, rspec, adam, G, device=dev) if mesh is None else \
            make_dp_reinforce_step(cfg, rspec, adam, G, mesh)
        return lambda st, g: (lambda p, o, m: ((p, o), m))(*fn(*st, g))

    def dqn_cycle(mode):
        kw = dict(learn_iters=LEARN_ITERS, kernel_act_rollout=mode in ("kernel", "kernel_fm"),
                  feature_major=mode == "kernel_fm", kernel_insert=mode == "insert")

        def make(mesh):
            fn = vector.make_dqn_selfplay_step(cfg, dqn, adam, G, device=dev, **kw) if mesh is None else \
                make_dp_dqn_step(cfg, dqn, adam, G, mesh, **kw)
            return lambda st, g: (lambda p, t, o, b, m: ((p, t, o, b), m))(*fn(*st, g, 0.0))

        def fresh():
            p = init(qspec, 31)
            if mode == "insert":
                buf = per_init_kd(KD_CAPACITY, S_PAD, SCAL_ROWS, device=dev)
            else:
                buf = (per_init_fm if mode == "kernel_fm" else per_init)(PER_CAPACITY, vector.dqn_replay_example(cfg),
                                                                          device=dev)
            return p, tree_map(torch.clone, p), adam.init(p), buf
        return fresh, make

    def acer(mesh):
        kw = dict(minibatch=tb.ACER_MINIBATCH, on_policy_sequences=tb.ACER_ON_POLICY)
        fn = vector.make_acer_selfplay_step(cfg, aspec, adam, G, device=dev, **kw) if mesh is None else \
            make_dp_acer_step(cfg, aspec, adam, G, mesh, **kw)
        return lambda st, g: (lambda p, o, b, m: ((p, o, b), m))(*fn(*st, g))

    arms = {"reinforce": ((lambda: (init(rspec, 32), adam.init(init(rspec, 32)))), reinforce, 1)}
    for mode in ("engine", "kernel", "kernel_fm", "insert"):
        fresh, make = dqn_cycle(mode)
        arms[f"dqn_{mode}"] = (fresh, make, LEARN_ITERS)
    arms["acer"] = ((lambda: (init(aspec, 33), adam.init(init(aspec, 33)),
                              seq_init(tb.ACER_CAPACITY, cfg.max_turns, vector.acer_sequence_example(cfg),
                                       device=dev))), acer, 2)
    return arms


def dp_phase(dev, card, k4_args):
    """Phase 11, data parallel (``parallel/mesh.py``) and the host extras on the card.

    (a) NCCL at world size 1 in this process: every arm of :func:`dp_arms`
    runs DP_STEPS plain steps, then -- every counter at 0 just before the DP
    path -- DP_STEPS DP steps from the same state and generator; each DP arm
    must end bit-identical to its plain twin and launch exactly its K1/K2/K4/
    K5 counts a step; then both rates (DP_RATE_STEPS timed steps each, host
    clock after ``torch.cuda.synchronize()``, plain, DP, DP, plain), the
    all-reduces an update and the time of one all-reduce of the flagship's gradient.
    (b) two gloo ranks spawned on the one card (``runtime/dp_check.py``): a
    2-rank DQN learn step and ACER train step against one rank on the
    concatenated minibatch, bit-identical params after a DP DQN cycle (insert
    mode, 2 x DP_G2 games) and a DP REINFORCE step (2 x DP_G2) on meshes of 1
    and 2 ranks, the 1-rank mesh equal to the plain steps; K1/K2 and K5 against
    their twins at DP_G2.  (c) the sharded device block and a tournament's
    ``play_device_block`` over both meshes equal to the unsharded block.
    (d) one ``play_callback_game`` with a scripted human (K2 once, K1 ten
    times) and one ``train_selfplay --algo dqn --steps 2 --save`` and its reload.
    Returns the ``dp`` line, the DP path's launches and the twin errors."""
    import builtins
    import contextlib
    import io
    import re
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.nets import mlp_init, params_to_numpy
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.ops.act_rollout_check import insert_twin_agreement
    from rl6nimmt_torch.parallel import make_mesh
    from rl6nimmt_torch.parallel.launch import check_backend, spawn
    from rl6nimmt_torch.runtime.dp_check import allreduce_ms, run_checks, trees_equal
    from rl6nimmt_torch.utils.ops import ALLREDUCES, leaves_with_paths

    leaf_list = lambda tree: [x for _, x in leaves_with_paths(tree)]
    cfg = EnvConfig(4)
    line = {"card": card}
    # ---- (a) NCCL at world size 1 ----
    check_backend("nccl", 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        arms = dp_arms(cfg, dev)
        plain, counts = {}, {}
        for name, (fresh, make, _) in arms.items():
            step, st, gen = make(None), fresh(), torch.Generator(device=dev).manual_seed(40)
            before = dict(_build.LAUNCHES)
            for _ in range(DP_STEPS):
                st, m = step(st, gen)
            torch.cuda.synchronize()
            counts[name] = {k: (v - before[k]) / DP_STEPS for k, v in _build.LAUNCHES.items() if v != before[k]}
            plain[name] = (st, m)
        dp_steps = {name: make(mesh) for name, (_, make, _) in arms.items()}
        starts = {name: fresh() for name, (fresh, _, _) in arms.items()}
        reduces, dp_counts, dp_out = {}, {}, {}
        torch.cuda.synchronize()
        _build.reset_launches()
        # ---- the DP path: every counter starts at 0 here ----
        for name, step in dp_steps.items():
            st, gen = starts[name], torch.Generator(device=dev).manual_seed(40)
            before, r0 = dict(_build.LAUNCHES), dict(ALLREDUCES)
            for _ in range(DP_STEPS):
                st, m = step(st, gen)
            torch.cuda.synchronize()
            dp_counts[name] = {k: (v - before[k]) / DP_STEPS for k, v in _build.LAUNCHES.items() if v != before[k]}
            updates = DP_STEPS * arms[name][2]
            reduces[name] = {"allreduces_per_update": (ALLREDUCES["calls"] - r0["calls"]) / updates,
                             "allreduce_bytes_per_update": (ALLREDUCES["bytes"] - r0["bytes"]) / updates}
            dp_out[name] = (st, m)
        dp_path = dict(_build.LAUNCHES)
        # ---- end of the DP path ----
        arm_lines = {}
        for name, step in dp_steps.items():
            if dp_counts[name] != counts[name]:
                raise AssertionError(f"DP {name} launched {dp_counts[name]} a step, the plain step {counts[name]}")
            if not trees_equal(dp_out[name], plain[name]):
                raise AssertionError(f"DP {name} at world size 1 differs from the plain step")
            plain_step = arms[name][1](None)
            runs = {"dp": (step, dp_out[name][0]), "plain": (plain_step, plain[name][0])}
            gen = torch.Generator(device=dev).manual_seed(41)
            secs = {"dp": [], "plain": []}
            for which in ("plain", "dp", "dp", "plain"):       # in turns: the host's speed drifts
                fn, st = runs[which]
                secs[which].append(host_seconds(lambda: fn(st, gen), DP_RATE_STEPS))
            sec_dp, sec_plain = sum(secs["dp"]) / 2, sum(secs["plain"]) / 2
            steps_per = G * cfg.max_turns
            arm_lines[name] = {"equal_to_plain": True, "launches_per_step": dp_counts[name],
                               "env_steps_per_s": steps_per / sec_dp, "plain_env_steps_per_s": steps_per / sec_plain,
                               "step_s": secs, **reduces[name]}
            log(f"[11] NCCL world 1 {name}: == plain step bit for bit; launches a step {dp_counts[name]}; "
                f"{steps_per / sec_dp:.0f} env-steps/s (plain {steps_per / sec_plain:.0f}); "
                f"{reduces[name]['allreduces_per_update']:.3f} all-reduces, "
                f"{reduces[name]['allreduce_bytes_per_update']:.0f} B an update")
        floats = sum(x.numel() for x in leaf_list(dp_out["dqn_engine"][0][0])) + 1
        nccl_ms = allreduce_ms(mesh, dev, floats)
        line["nccl_world1"] = {"backend": dist.get_backend(), "games": G, "steps": DP_STEPS, "arms": arm_lines,
                               "allreduce_ms": nccl_ms, "allreduce_floats": floats}
        log(f"[11] NCCL world 1: one all-reduce of {floats} floats {nccl_ms:.4f} ms")
    finally:
        dist.destroy_process_group()

    # ---- (b) and (c): two gloo ranks sharing the card ----
    rng = np.random.RandomState(0)
    learn = {}
    for i, (name, kw) in enumerate({"vanilla": dict(hidden_sizes=(16,)),
                                    "d3qn_prb": dict(double=True, dueling=True, per=True,
                                                     hidden_sizes=(16,))}.items()):
        spec = q_network_spec(DQNConfig(**kw), cfg.state_length, cfg.num_actions)
        params = lambda seed: params_to_numpy(mlp_init(torch.Generator().manual_seed(seed), spec, "cpu"))
        n = 64
        learn[name] = {"cfg": kw, "params": params(50 + 2 * i), "target": params(51 + 2 * i), "batch": {
            "state": rng.randn(n, 47).astype(np.float32), "action": rng.randint(0, 104, n).astype(np.int32),
            "reward": rng.randn(n).astype(np.float32), "next_state": rng.randn(n, 47).astype(np.float32),
            "done": (rng.random(n) < 0.3).astype(np.float32), "weights": rng.random(n).astype(np.float32) + 0.5}}
    B, T, H = 16, 10, 10
    cards = np.sort(np.stack([rng.choice(104, size=H, replace=False) for _ in range(B * T)]), axis=1)
    logits = rng.randn(B, T, H).astype(np.float32)
    acer_batch = {"state": rng.randn(B, T, 47).astype(np.float32), "legal_cards": cards.reshape(B, T, H).astype(np.int32),
                  "log_probs": (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32),
                  "action_id": rng.randint(0, H, (B, T)).astype(np.int32), "reward": rng.randn(B, T).astype(np.float32),
                  "done": (rng.random((B, T)) < 0.1).astype(np.float32), "length": np.full((B,), T, np.int32)}
    acer_spec = MLPSpec(input_size=48, hidden_sizes=(16,), head_sizes=(1, 1))
    inputs = {"dqn_learn": learn,
              "acer_train": {"params": params_to_numpy(mlp_init(torch.Generator().manual_seed(60), acer_spec, "cpu")),
                             "batch": acer_batch},
              "dqn_cycle": {"cfg": FLAGSHIP, "games": DP_G2, "learn_iters": LEARN_ITERS, "capacity": KD_CAPACITY,
                            "mode": "insert"},
              "reinforce_games": DP_G2, "reinforce_hidden": (100, 100), "block_games": 8,
              "allreduce_floats": sum(p.numel() for p in leaf_list(mlp_init(
                  torch.Generator().manual_seed(0), q_network_spec(DQNConfig(**FLAGSHIP), 47, 104), "cpu"))) + 1}
    t0 = time.perf_counter()
    ranks = spawn(run_checks, 2, inputs, "cuda", backend="gloo", timeout=600)[0]
    gloo_s = time.perf_counter() - t0
    for key, ok in {**{f"replicated {k}": v for k, v in ranks["replicated"].items()},
                    **{f"rerun {k}": v for k, v in ranks["rerun"].items()},
                    **{f"world-size-1 {k}": v for k, v in ranks["size1"].items()},
                    **{f"pmean {k}": v["identity"] and v["max_err"] <= 1e-6 for k, v in ranks["pmean"].items()}}.items():
        if not ok:
            raise AssertionError(f"two gloo ranks on the card: {key} failed")
    learn_err = 0.0
    for name in learn:
        one, two = ranks["learn"][(name, "plain")], ranks["learn"][(name, "n2")]
        for a, b in zip(leaf_list(two["params"]) + leaf_list(two["adam"]["mu"]),
                        leaf_list(one["params"]) + leaf_list(one["adam"]["mu"])):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=f"2-rank {name} learn step")
            learn_err = max(learn_err, float(np.abs(a - b).max()))
        np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
    one, two = ranks["acer"]["plain"], ranks["acer"]["n2"]
    np.testing.assert_allclose(two["losses"], one["losses"], atol=1e-6, rtol=1e-5)
    for a, b in zip(leaf_list(two["params"]), leaf_list(one["params"])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg="2-rank ACER train step")
    blocks = ranks["block"]
    if not (np.array_equal(blocks["n2"], blocks["n1"]) and np.array_equal(blocks["n1"], blocks["fn"])
            and ranks["tournament"]["n2"] == ranks["tournament"]["n1"]):
        raise AssertionError(f"the sharded block differs from the unsharded one: {blocks}")
    rank0 = {k: v for k, v in ranks["launches"].items() if v}
    if not all(rank0.get(k) for k in ("deal_games", "resolve_turn", "act_insert")):
        raise AssertionError(f"rank 0 of the gloo pair did not launch K1, K2 and K5: {rank0}")
    errs = k1_k2_against_twins(cfg, [DP_G2], 101, dev)
    k5_agree, _, errs["act_insert"] = insert_twin_agreement(cfg, DP_G2, HIDDEN, KD_CAPACITY, KD_PTR, 102, k4_args)
    if k5_agree < 0.999 or errs["act_insert"] != 0.0:
        raise AssertionError(f"K5 vs twin at G={DP_G2}: agreement {k5_agree}, error {errs['act_insert']}")
    line["gloo_2ranks"] = {"seconds": gloo_s, "replicated": ranks["replicated"], "rerun": ranks["rerun"],
                           "world_size_1_equal": ranks["size1"], "dqn_cycle_allreduces": ranks["allreduces"],
                           "learn_max_abs_diff": learn_err, "block_games_equal": True, "rank0_launches": rank0,
                           "allreduce_ms": ranks["allreduce_ms"], "dqn_cycle_s": ranks["cycle_s"],
                           "allreduce_floats": inputs["allreduce_floats"]}
    log(f"[11] two gloo ranks on the card ({gloo_s:.1f} s): 2-rank DQN and ACER updates == one rank on the global "
        f"batch (max |diff| {learn_err:.3g}); params bit-identical across ranks after the DP DQN cycle (insert, "
        f"2 x {DP_G2}) and DP REINFORCE (2 x {DP_G2}); the sharded block == the unsharded one; rank 0 launched {rank0}; "
        f"one all-reduce of {inputs['allreduce_floats']} floats {ranks['allreduce_ms']} ms; DQN cycles {ranks['cycle_s']} s")

    # ---- (d) the host extras on the card ----
    from rl6nimmt_torch.experiments import train_selfplay
    from rl6nimmt_torch.runtime.callback_human import play_callback_game
    from rl6nimmt_torch.utils import load_params

    prompts, real_input = [], builtins.input
    builtins.input = lambda prompt="": (prompts.append(prompt),
                                        re.search(r"cards:\s*((?:\s*\d+)+)", prompt).group(1).split()[0])[1]
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        with contextlib.redirect_stdout(out):
            scores = play_callback_game(["random", "random", "random"], seed=7, device=dev)
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
    finally:
        builtins.input = real_input
    if got != {"deal_games": 1, "resolve_turn": 10} or len(prompts) != 10 or out.getvalue().count("Board:") != 10 \
            or not (scores <= 0).all():
        raise AssertionError(f"callback game: launches {got}, {len(prompts)} prompts, scores {scores}")
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        path = os.path.join(tmp, "dqn.npz")
        t0 = time.perf_counter()
        params = train_selfplay.run(["--algo", "dqn", "--steps", "2", "--save", path])
        train_s = time.perf_counter() - t0
        reloaded = load_params(path, params)
        if not trees_equal(params, reloaded) or not all(torch.isfinite(x).all() for x in leaf_list(params)):
            raise AssertionError("train_selfplay --save: the reloaded params differ")
    line["host_extras"] = {"callback_launches": got, "callback_scores": scores.tolist(),
                           "train_selfplay_dqn_2_steps_s": train_s}
    log(f"[11] callback game (3 random seats): launches {got}, scores {scores.tolist()}; train_selfplay --algo dqn "
        f"--steps 2 --save ({train_s:.1f} s) reloads bit for bit")
    return line, dp_path, errs


def scripts_phase(dev, card):
    """Phase 12: the ``main()`` of each experiment script ported with the replay
    layouts, on the card at a cut depth (each cut stated in the log), with its
    checks; every counter is set to 0 just before each script and read just
    after, and held to the script's exact K1/K2/K4/K5 launches.  Returns the
    ``scripts`` line and the launches summed over the scripts."""
    import builtins
    import contextlib
    import io
    import tempfile

    from rl6nimmt_torch.agents import PUCTAgent
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments import (fm_cycle_bench, fm_strength_ab, long_train_eval, micro_insert,
                                            play_human, strength_vs_budget, train_puct_prior)
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.runtime.device_match import playout_turns_per_seat

    line, path = {"card": card}, {k: 0 for k in _build.LAUNCHES}
    cfg4, cfg2 = EnvConfig(4), EnvConfig(2)
    T = cfg4.max_turns
    match = lambda k2, k1: {"deal_games": k2, "resolve_turn": k1}      # K2 once and K1 ten times a plain match

    def run(name, cut, argv, want, main):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in got.items():
            path[k] += v
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        line[name] = {"argv": argv, "cut": cut, "seconds": secs, "launches": got}
        log(f"[12] {name} {' '.join(argv)} ({cut}): {secs:.2f} s, launches {got}")
        for text in out.getvalue().strip().splitlines()[-6:]:
            log(f"[12]   {text}")
        return result, out.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        # fm_cycle_bench: every arm, one warm-up cycle and 2 timed runs of 1 cycle each.
        block = G * T * cfg4.num_players
        res, _ = run("fm_cycle_bench", "2 repeats of 1 cycle, not 3 of 8", ["--games", str(G), "--reps", "2",
                                                                             "--chain", "1"],
                     {"deal_games": 3, "resolve_turn": 3 * T, "act_rollout": 3, "act_rollout_fm": 6,
                      "act_insert": 3}, fm_cycle_bench.main)
        for arm, r in res.items():
            logical = min(3 * block, fm_cycle_bench.KD_CAPACITY if arm == "insert" else fm_cycle_bench.CAPACITY)
            if r["per_size"] != logical or not math.isfinite(r["ms_per_cycle"]):
                raise AssertionError(f"fm_cycle_bench {arm}: size {r['per_size']}, ms {r['ms_per_cycle']}")
        line["fm_cycle_bench"]["arms"] = res
        # micro_insert at its full shape: no kernel of the port runs (the insert is PyTorch's).
        res, _ = run("micro_insert", "full shape", [], {}, micro_insert.main)
        line["micro_insert"]["arms"] = res
        # fm_strength_ab: each arm trains 3 cycles of 1,024 games; one arena match of 1,024 games each.
        out_path = os.path.join(tmp, "ab.json")
        res, _ = run("fm_strength_ab", "1 seed, 3 cycles, 1 eval of 1,024 games",
                     ["--seeds", "1", "--cycles", "3", "--eval-games", "1024", "--eval-keys", "1", "--out", out_path],
                     {"deal_games": 3 + 3, "resolve_turn": 3 * T + 3 * T, "act_rollout": 3, "act_rollout_fm": 3},
                     fm_strength_ab.main)
        if not all(-10 * 104 <= res[a]["score_mean"] <= 0 for a in fm_strength_ab.ARMS) or not os.path.exists(out_path):
            raise AssertionError(f"fm_strength_ab: scores {[res[a]['score_mean'] for a in fm_strength_ab.ARMS]}")
        line["fm_strength_ab"]["scores"] = {a: res[a]["score_mean"] for a in fm_strength_ab.ARMS}
        # train_puct_prior: 2 device blocks of 64 all-PUCT games (one search call a turn), then two
        # 16-game two-seat matches (two searchers each).
        ptps4, ptps2 = playout_turns_per_seat(cfg4, 128), playout_turns_per_seat(cfg2, 128)
        prior_path = os.path.join(tmp, "prior.npz")
        res, _ = run("train_puct_prior", "2 iterations, not 100; a 32-game head-to-head at mc_max 128",
                     ["--iters", "2", "--games", "64", "--mc-max", "128", "--eval-games", "32", "--eval-mc-max",
                      "128", "--out", prior_path],
                     match(4, 2 * (T + ptps4) + 2 * (T + 2 * ptps2)), train_puct_prior.main)
        if not (0 <= res["win_rate"] <= 1 and all(math.isfinite(x) for x, _ in res["history"])
                and os.path.exists(prior_path)):
            raise AssertionError(f"train_puct_prior: win rate {res['win_rate']}, history {res['history']}")
        line["train_puct_prior"].update(win_rate=res["win_rate"], history=res["history"])
        # long_train_eval: REINFORCE 2 updates and evals before and after; DQN 2 cycles, 3 evals.
        for algo, flags, want in (("reinforce", ["--updates", "2", "--eval-every", "2"], match(2 + 2, 10 * 4)),
                                  ("dqn", ["--cycles", "2"], match(2 + 3, 10 * 5))):
            hist, _ = run(f"long_train_eval_{algo}", "a few updates, evals of 1,024 games",
                          ["--algo", algo, *flags, "--games", str(G), "--eval-games", "1024",
                           "--out", os.path.join(tmp, algo)], want, long_train_eval.main)
            if not all(math.isfinite(h["loss"]) for h in hist[1:]):
                raise AssertionError(f"long_train_eval {algo}: history {hist}")
            line[f"long_train_eval_{algo}"]["win_rates"] = [h["win_rate"] for h in hist]
        # strength_vs_budget: two host GameSession games; a wrapper reset is K2, a turn K1, and
        # each host search call ceil(n_mc / batch) rounds of n playout turns.
        big, small = PUCTAgent(mc_max=32, device="cpu"), PUCTAgent(mc_max=16, device="cpu")
        searches = sum(host_search_turns(a, n) for a in (big, small) for n in range(1, cfg2.hand_size + 1))
        res, _ = run("strength_vs_budget", "2 games at mc_max 32 against 16, not 100 at 800 against 400",
                     ["--games", "2", "--big", "32", "--small", "16"], match(2, 2 * (T + searches)),
                     strength_vs_budget.main)
        line["strength_vs_budget"]["result"] = res
        # play_human --device-game: a scripted human (the first held card) against one PUCT seat.
        prompts, real_input = [], builtins.input
        builtins.input = lambda prompt="": (prompts.append(prompt),
                                            re.search(r"cards:\s*((?:\s*\d+)+)", prompt).group(1).split()[0])[1]
        try:
            totals, printed = run("play_human", "1 game at mc_max 32, not 5 at 800, scripted human",
                                  ["--device-game", "--games", "1", "--mc-max", "32", "--name", "Scripted"],
                                  match(1, T + playout_turns_per_seat(cfg2, 32)), play_human.main)
        finally:
            builtins.input = real_input
        if len(prompts) != T or "Series total: Scripted" not in printed or not (totals <= 0).all():
            raise AssertionError(f"play_human: {len(prompts)} prompts, totals {totals}")
        line["play_human"]["totals"] = [float(x) for x in totals]
    line["phase_launches"] = {k: v for k, v in path.items() if v}
    return line, path


def evals_phase(dev, card):
    """Phase 13: the ``main()`` of each evaluation, A/B and profiling script's
    twin on the card at a cut depth, the widths the published ones (each cut
    stated in the log), with its checks; every counter is set to 0 just before
    each script and read just after, and held to the script's exact K1/K2
    launches: a device block group's from its lineups (``block_launches``), a
    match's from its seats' budgets (``playout_turns_per_seat``), a host game's
    from its searches (``host_search_turns``).  Last, K1 and K2 against their
    twins at every shape the scripts launched them at.  Returns the ``evals``
    line, the launches summed over the scripts and the largest K1/K2
    differences from their twins."""
    import contextlib
    import io
    import tempfile

    from rl6nimmt_torch.agents import MCSAgent, PUCTAgent
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments import (acer_onpolicy_ab, budget_saturation, devblock_attrib,
                                            device_learn_speedup, device_learn_strength_ab, devroot_equivalence,
                                            prior_decoupled_eval, profile_devblock, puct_batch_ab)
    from rl6nimmt_torch.ops import _build, game_kernel, step_kernel
    from rl6nimmt_torch.runtime import device_match, device_tournament as dtm
    from rl6nimmt_torch.runtime.device_match import playout_turns_per_seat

    line, path = {"card": card}, {k: 0 for k in _build.LAUNCHES}
    cfg4, cfg2 = EnvConfig(4), EnvConfig(2)
    T = cfg4.max_turns
    match = lambda k2, k1: {"deal_games": k2, "resolve_turn": k1}
    in_unit = lambda *xs: all(0.0 <= x <= 1.0 for x in xs)
    in_scores = lambda *xs: all(-10 * 104 <= x <= 0 for x in xs)
    # Every device block session a script dispatches, for its groups' launches.
    sessions, real_dispatch = [], dtm.DeviceBlockSession.dispatch

    def dispatch(self):
        sessions.append(self)
        return real_dispatch(self)

    # The game configuration and games of every K1 and K2 launch the scripts make (the launchers'
    # trailing arguments: K1 G, P, R, T; K2 G, P, R, T, H, N), for the twin checks at those shapes.
    shapes, real_k1, real_k2 = {}, step_kernel._ROW_MAJOR, game_kernel._DEAL

    def recording(launcher, shape):
        def launch(device_index, *args):
            cfg, games = shape(*args)
            shapes.setdefault(cfg, set()).add(games)
            return launcher(device_index, *args)
        return launch

    step_kernel._ROW_MAJOR = recording(real_k1, lambda *a: (EnvConfig(a[-3], a[-2], threshold=a[-1]), a[-4]))
    game_kernel._DEAL = recording(real_k2, lambda *a: (EnvConfig(a[-5], a[-4], a[-1], a[-3], hand_size=a[-2]),
                                                       a[-6]))

    def blocks_launches():
        got = {"deal_games": 0, "resolve_turn": 0}
        for s in sessions:
            for k, v in block_launches(s, s.single_round_cap)[0].items():
                got[k] += v
        return got

    def run(name, cut, argv, want, main):
        """``want``: the launches, or a function of the run's sessions giving them."""
        torch.cuda.synchronize()
        sessions.clear()
        _build.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in got.items():
            path[k] += v
        want = want() if callable(want) else want
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        line[name] = {"argv": argv, "cut": cut, "seconds": secs, "launches": got}
        log(f"[13] {name} {' '.join(argv)} ({cut}): {secs:.2f} s, launches {got}")
        for text in out.getvalue().strip().splitlines()[-8:]:
            log(f"[13]   {text}")
        return result

    dtm.DeviceBlockSession.dispatch = dispatch
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # device_learn_strength_ab: per family two arms of 2 blocks of 8 games, then 2 arena matches
            # against random seats and 2 head-to-head (K2 once and K1 ten times a match).
            fams = device_learn_strength_ab.FAMILIES
            arena = match(4 * len(fams), 4 * len(fams) * T)
            res = run("device_learn_strength_ab", "1 seed, 16 games in blocks of 8, 1,024 eval games (not 6 seeds, "
                      "240 games, 4,096)", ["--seeds", "1", "--games", "16", "--block", "8", "--eval-games", "1024",
                                            "--out", os.path.join(tmp, "dls.json")],
                      lambda: {k: v + arena[k] for k, v in blocks_launches().items()}, device_learn_strength_ab.main)
            for fam in fams:
                r = res[fam]
                rates = r["win_vs_3_random_host"] + r["win_vs_3_random_device"] + r["head_to_head_device_rate"]
                if not in_unit(*rates):
                    raise AssertionError(f"device_learn_strength_ab {fam}: {r}")
            if res["reinforce"]["final_params_bit_equal_per_seed"] != [True]:
                raise AssertionError(f"device_learn_strength_ab: REINFORCE's arms differ: {res['reinforce']}")
            line["device_learn_strength_ab"]["result"] = res
            # device_learn_speedup: a warm-up block and one timed block of 8 games an arm, then 2 pairs.
            original = dtm.DeviceBlockSession.finalize
            for tag, extra in (("device_learn_speedup", []), ("device_learn_speedup_pairs", ["--pairs", "2"])):
                res = run(tag, "16 games in blocks of 8 (not 1,000 in 100)" + (", 2 pairs" if extra else ""),
                          ["--games", "16", "--block", "8", *extra, "--out", os.path.join(tmp, f"{tag}.json")],
                          blocks_launches, device_learn_speedup.main)
                if dtm.DeviceBlockSession.finalize is not original:
                    raise AssertionError(f"{tag} left DeviceBlockSession.finalize patched")
                line[tag]["result"] = res
            r = line["device_learn_speedup"]["result"]
            if not (r["host"]["ms_per_game"] > 0 and r["device"]["ms_per_game"] > 0):
                raise AssertionError(f"device_learn_speedup: {r}")
            # profile_devblock: the notebook population at mc_max 32, 2 blocks of 16 games.
            res = run("profile_devblock", "2 blocks of 16 games at mc_max 32 (not 100 at 200)",
                      ["--games", "16", "--mc-max", "32", "--blocks", "2"], blocks_launches, profile_devblock.main)
            if [sum(g["games"] for g in b["groups"]) for b in res.values()] != [16, 16]:
                raise AssertionError(f"profile_devblock: {res}")
            line["profile_devblock"]["result"] = res
            # budget_saturation: per budget two blocks (one a seat order); each turn one search call over
            # both seats, as many rounds as the reference seat needs.
            res = run("budget_saturation", "budgets 8 and 16 against 32, 32 games a seat order (not 7 budgets "
                      "against 800, 512)", ["--budgets", "8,16", "--reference-budget", "32", "--games", "32",
                                           "--out", os.path.join(tmp, "bs.json")],
                      match(4, 4 * (T + playout_turns_per_seat(cfg2, 32))), budget_saturation.main)
            if not all(in_unit(v["win_rate_vs_saturated"]) and v["games"] == 64 for v in res.values()):
                raise AssertionError(f"budget_saturation: {res}")
            line["budget_saturation"]["result"] = res
            # devblock_attrib: 7 arms, one untimed and one timed block each, one search call a turn.
            arm_k = {"random": None, "mcs": 8, "puct_uniform": 8, "puct": 8, "mcs/puct_free": 32,
                     "mcs/pf+uni": 32, "puct/K32": 32}
            res = run("devblock_attrib", "32 games at mc_max 32, 1 rep (not 200, 3)",
                      ["--games", "32", "--mc-max", "32", "--reps", "1"],
                      match(2 * len(arm_k), sum(2 * (T + (playout_turns_per_seat(cfg4, 32, 10, k) if k else 0))
                                                for k in arm_k.values())), devblock_attrib.main)
            if list(res) != list(arm_k) or not all(v["min_ms"] > 0 for v in res.values()):
                raise AssertionError(f"devblock_attrib: {res}")
            line["devblock_attrib"]["result"] = res
            # prior_decoupled_eval: 4 matchups of 2 two-seat matches, both seats searching.
            res = run("prior_decoupled_eval", "32 games a seat order at budget 16 (not 512 at 50, 100)",
                      ["--games", "32", "--budgets", "16"], match(8, 8 * (T + 2 * playout_turns_per_seat(cfg2, 16))),
                      prior_decoupled_eval.main)
            if list(res) != ["A@16", "B@16", "C@16", "D@16"] or not all(in_unit(v["win_rate_A"]) for v in res.values()):
                raise AssertionError(f"prior_decoupled_eval: {res}")
            line["prior_decoupled_eval"]["result"] = res
            # puct_batch_ab: 2 keys at K 8 and 16; three search seats at the arm's K; every arm dealt alike.
            dealt, real_deal = [], device_match.deal
            device_match.deal = lambda *a, **k: dealt.append(real_deal(*a, **k)) or dealt[-1]
            try:
                res = run("puct_batch_ab", "32 games, 2 keys, K 8 and 16 at mc_max 32 (not 256, 4, 8/16/32 at 200)",
                          ["--games", "32", "--keys", "2", "--ks", "8,16", "--mc-max", "32",
                           "--out", os.path.join(tmp, "pb.json")],
                          match(4, sum(2 * (T + 3 * playout_turns_per_seat(cfg4, 32, 10, k)) for k in (8, 16))),
                          puct_batch_ab.main)
            finally:
                device_match.deal = real_deal
            same = [torch.equal(dealt[e].hands, dealt[2 + e].hands) and torch.equal(dealt[e].board, dealt[2 + e].board)
                    for e in range(2)]
            if len(dealt) != 4 or not all(same) or torch.equal(dealt[0].hands, dealt[1].hands):
                raise AssertionError(f"puct_batch_ab: {len(dealt)} deals, arms dealt alike per key: {same}")
            if not all(in_unit(a["win_rate"]) and in_scores(a["mean_score"]) for a in res["arms"].values()):
                raise AssertionError(f"puct_batch_ab: {res}")
            line["puct_batch_ab"].update(result=res, arms_dealt_alike=same)
            # devroot_equivalence: 2 host games a searcher; a wrapper reset is K2, a turn K1, and each
            # decision ceil(n_mc / K) rounds of n playout turns, device root and host root alike.
            for agent, cls in (("puct", PUCTAgent), ("mcs", MCSAgent)):
                a = cls(mc_max=16, device="cpu")
                searches = 2 * sum(host_search_turns(a, n) for n in range(1, cfg2.hand_size + 1))
                res = run(f"devroot_equivalence_{agent}", "2 games at mc_max 16 (not 200 at 200)",
                          ["--agent", agent, "--games", "2", "--mc-max", "16"], match(2, 2 * (T + searches)),
                          devroot_equivalence.main)
                if not (in_unit(res["device_root_win_rate"]) and in_scores(res["mean_score_device"],
                                                                           res["mean_score_host"])):
                    raise AssertionError(f"devroot_equivalence {agent}: {res}")
                line[f"devroot_equivalence_{agent}"]["result"] = res
            # acer_onpolicy_ab: an untimed and 2 timed cycles an arm at G=4096 (K2 once and K1 ten times a
            # cycle), one arena match an arm against random seats and 2 head-to-head.
            res = run("acer_onpolicy_ab", "2 cycles an arm (not 200), 1,024 eval games (not 4,096)",
                      ["--steps", "2", "--eval-games", "1024", "--out", os.path.join(tmp, "acer.json")],
                      match(2 * 3 + 2 + 2, 10 * (2 * 3 + 2 + 2)), acer_onpolicy_ab.main)
            for arm in ("all_fresh", "subsampled"):
                r = res[arm]
                if not (in_unit(r["win_vs_3_random"]) and in_scores(r["final_mean_score"])
                        and r["peak_device_memory_bytes"] > 0):
                    raise AssertionError(f"acer_onpolicy_ab {arm}: {r}")
            if not in_unit(res["all_fresh_win_vs_subsampled"]["rate"]):
                raise AssertionError(f"acer_onpolicy_ab: {res}")
            line["acer_onpolicy_ab"]["result"] = res
    finally:
        dtm.DeviceBlockSession.dispatch = real_dispatch
        step_kernel._ROW_MAJOR, game_kernel._DEAL = real_k1, real_k2
    line["phase_launches"] = {k: v for k, v in path.items() if v}
    # K1 and K2 against their twins at every configuration and game count the scripts launched them at
    # (games dealt, playout lanes); these launches are not the path's.
    errs = {"deal_games": 0.0, "resolve_turn": 0.0}
    for cfg, sizes in sorted(shapes.items(), key=lambda kv: kv[0].num_players):
        for name, err in k1_k2_against_twins(cfg, sorted(sizes), 113, dev).items():
            errs[name] = max(errs[name], err)
    line["twin_shapes"] = {str(cfg.num_players): sorted(sizes) for cfg, sizes in shapes.items()}
    log(f"[13] K1 and K2 bit-exact vs twins at every shape the scripts launched them at "
        f"{line['twin_shapes']} (players: games)")
    return line, path, errs


# Phase 14, the profilers', micro-benchmarks' and debug scripts' twins: the bf16 forwards on the card held against
# the CPU's (the largest difference over the output's largest magnitude; a result rounded to bfloat16 would be off by
# up to 2^-9 of it, float32 summation order by ~1e-6) and the REINFORCE gradient through them (two bfloat16 ulps:
# each operand's gradient is rounded to bfloat16, as JAX's, and a summation-order difference may round it the
# other way; the head bias's gradient is round-off alone, hence the absolute part).
BF16_FWD_RTOL = 1e-4
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 2.0 ** -7, 1e-5
PROFILE_CHECK_SEED = 115


def k4_against_twin(cfg, games, hidden, seed, dev, feature_major):
    """K4 (or its feature-major entry) against its plain twin at one shape, on
    the flagship net's per-turn effective weights: deals exact, action
    agreement >= 0.999, the agreeing games' outputs bit for bit.  Raises on a
    difference; returns the agreement and the largest difference in the agreeing games."""
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
    from rl6nimmt_torch.nets import draw_mlp_noise, mlp_init
    from rl6nimmt_torch.ops.act_rollout_check import turn_effective_weights
    from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_fm_plain, act_rollout_plain, make_act_rollout_kernel

    spec = q_network_spec(DQNConfig(**{**FLAGSHIP, "hidden_sizes": (hidden,)}), cfg.state_length, cfg.num_actions)
    gen = torch.Generator(device=dev).manual_seed(seed)
    eff = turn_effective_weights(spec, mlp_init(gen, spec, dev), draw_mlp_noise(spec, gen, batch=(cfg.max_turns,)))
    args = tuple(x.contiguous() for x in (eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                          eff["heads"][1]["w"], eff["heads"][1]["b"]))
    got = make_act_rollout_kernel(cfg, games, hidden, feature_major=feature_major)(seed, *args)
    want = (act_rollout_fm_plain if feature_major else act_rollout_plain)(cfg, seed, games, *args)
    (ok, ak, rk), (op, ap, rp) = got, want
    P = cfg.num_players
    if feature_major:        # obs [S, (T+1)*P, G], actions/rewards [T*P, G]: the games on the last axis
        same = (ak == ap).all(dim=0)
        deals = torch.equal(ok[:, :P], op[:, :P])
        pairs = [(ok[..., same], op[..., same]), (rk[:, same], rp[:, same])]
    else:                    # obs [T+1, G, P, S], actions/rewards [T, G, P]
        same = (ak == ap).all(dim=(0, 2))
        deals = torch.equal(ok[0], op[0])
        pairs = [(ok[:, same], op[:, same]), (rk[:, same], rp[:, same])]
    agree = (ak == ap).float().mean().item()
    name = "K4 feature-major" if feature_major else "K4"
    if not deals or agree < 0.999 or not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} vs twin at G={games}, hidden {hidden}: deals {deals}, agreement {agree}")
    return agree, max_abs_err(pairs)


def bf16_card_against_cpu(dev):
    """``compute_dtype="bfloat16"`` on the card against the CPU (both: the
    operands rounded to bfloat16, a float32 product) on the same params and
    inputs: the flagship D3QN's ``q_values`` (noisy, one noise draw), the
    REINFORCE net's ``action_in_input_logits`` and the ACER net's
    ``action_in_input_heads`` at G=64 four-seat observations and hands, and
    one REINFORCE loss's gradient.  Raises beyond the tolerances above.  Also
    measures, without a check, the tensor cores' product of the same rounded
    operands (``torch.mm(..., out_dtype=float32)``), which ``_mm`` does not
    use, alone and in the three forwards.  Returns the errors."""
    import dataclasses

    from rl6nimmt_torch.agents.dqn import DQNConfig, grad_leaves, grads_of, q_network_spec, q_values, tree_leaves
    from rl6nimmt_torch.agents.reinforce import action_in_input_heads, action_in_input_logits
    from rl6nimmt_torch.engine import EnvConfig, deal, observe
    from rl6nimmt_torch.nets import MLPSpec, draw_mlp_noise, mlp_init

    cpu = torch.device("cpu")
    cfg = EnvConfig(4)
    state = deal(cfg, PROFILE_CHECK_SEED, 64, device=cpu)
    obs, _ = observe(cfg, state)
    hands = state.hands_sorted.to(torch.int64)
    dqn = DQNConfig(**FLAGSHIP)
    qspec = dataclasses.replace(q_network_spec(dqn, cfg.state_length, cfg.num_actions), compute_dtype="bfloat16")
    aspec = MLPSpec(cfg.state_length + 1, (100, 100), (1,), compute_dtype="bfloat16")
    cspec = dataclasses.replace(aspec, head_sizes=(1, 1))
    gen = torch.Generator().manual_seed(PROFILE_CHECK_SEED)
    nets = {"dqn": (qspec, mlp_init(gen, qspec, cpu)), "reinforce": (aspec, mlp_init(gen, aspec, cpu)),
            "acer": (cspec, mlp_init(gen, cspec, cpu))}
    noise = draw_mlp_noise(qspec, gen)
    to = lambda tree, d: ({p: [{k: v.to(d) for k, v in layer.items()} for layer in tree[p]] for p in tree}
                          if isinstance(tree, dict) else [{k: v.to(d) for k, v in z.items()} for z in tree])
    forwards = {"dqn": lambda p, d: (q_values(dqn, qspec, p, obs.to(d), to(noise, d)),),
                "reinforce": lambda p, d: (action_in_input_logits(aspec, p, obs.to(d), hands.to(d)),),
                "acer": lambda p, d: action_in_input_heads(cspec, p, obs.to(d), hands.to(d))}
    errs = {}
    for name, (spec, params) in nets.items():
        want = forwards[name](params, cpu)
        got = forwards[name](to(params, dev), dev)
        err = max(float((g.cpu() - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))
        if not err <= BF16_FWD_RTOL:
            raise AssertionError(f"bf16 {name} forward: card vs CPU {err:.3g} of the output's scale")
        errs[f"{name}_forward"] = err
    # One REINFORCE-style loss (log-softmax of the legal logits at the first hand slot) and its gradient.
    grads = []
    for d in (cpu, dev):
        leaves, live = grad_leaves(to(nets["reinforce"][1], d))
        logits = action_in_input_logits(aspec, live, obs.to(d), hands.to(d))
        loss = -torch.log_softmax(logits, dim=-1)[..., 0].mean()
        grads.append([g.cpu() for g in tree_leaves(grads_of(loss, leaves, to(nets["reinforce"][1], d)))])
    scale = max(float(g.abs().max()) for g in grads[0])
    for g, w in zip(grads[1], grads[0]):
        if not bool(((g - w).abs() <= BF16_GRAD_RTOL * w.abs() + BF16_GRAD_ATOL * scale).all()):
            raise AssertionError(f"bf16 REINFORCE gradient: card vs CPU {float((g - w).abs().max()):.3g}")
    errs["reinforce_gradient"] = max(float((g - w).abs().max()) for g, w in zip(grads[1], grads[0])) / scale
    # Measured, not checked: the tensor cores' product of the same rounded operands with a float32 result
    # (``torch.mm(..., out_dtype=float32)``), the route ``_mm`` does not take. First alone at the nets' (M, K, N)
    # on random operands, then in the three nets' forwards (``_mm`` swapped for it), each of the output's scale.
    tensor_core = {}
    if dev.type == "cuda":
        from rl6nimmt_torch.agents import reinforce
        from rl6nimmt_torch.nets import mlp

        for m, k, n in ((256, 47, 64), (256, 64, 104), (256, 64, 1), (2560, 100, 100), (2560, 100, 1)):
            a = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
            b = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
            want = a.float() @ b.float()
            got = torch.mm(a, b, out_dtype=torch.float32)
            tensor_core[f"{m}x{k}x{n}"] = float((got - want).abs().max()) / float(want.abs().max())

        real_mm = mlp._mm

        def tensor_core_mm(x, w, dtype=None):
            if dtype != "bfloat16" or w.dim() != 2 or x.device.type != "cuda":
                return real_mm(x, w, dtype)
            out = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16), w.to(torch.bfloat16),
                           out_dtype=torch.float32)
            return out.reshape(x.shape[:-1] + (w.shape[-1],))

        mlp._mm = reinforce._mm = tensor_core_mm
        try:
            with torch.no_grad():
                for name, (spec, params) in nets.items():
                    want = forwards[name](params, cpu)
                    got = forwards[name](to(params, dev), dev)
                    tensor_core[f"{name}_forward"] = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
                                                         for g, w in zip(got, want))
        finally:
            mlp._mm = reinforce._mm = real_mm
    errs["tensor_core_product_not_used"] = tensor_core
    return errs


def profilers_phase(dev, card):
    """Phase 14: the ``main()`` of each profiler's, micro-benchmark's and debug
    script's twin on the card at the published widths and a cut depth (each cut
    stated in the log), with its checks; every counter is set to 0 just before
    each script and read just after, and held to the script's exact K1/K2/K4/K4
    fm launches.  Then the bf16 forwards and gradient against the CPU's, and K1,
    K2, K4 and K4 fm against their twins at every shape the scripts launched
    them at.  Returns the ``profilers`` line, the launches summed over the
    scripts and the largest differences of each kernel from its twin."""
    import contextlib
    import io
    import logging
    import tempfile

    from rl6nimmt_torch.agents import PUCTAgent
    from rl6nimmt_torch.engine import EnvConfig
    from rl6nimmt_torch.experiments import (act_rollout_probe, bench_trainable, debug_acer, debug_dqn,
                                            debug_gradflow, debug_mcts, micro_acer, micro_cycle, micro_cycle2,
                                            micro_cycle3, micro_cycle4, micro_cycle5, micro_per, profile_ab,
                                            profile_trainable, roofline_cycle)
    from rl6nimmt_torch.ops import _build, act_rollout_kernel, game_kernel, step_kernel

    line, path = {"card": card}, {k: 0 for k in _build.LAUNCHES}
    cfg4, cfg2 = EnvConfig(4), EnvConfig(2)
    T = cfg4.max_turns
    units = lambda n: {"deal_games": n, "resolve_turn": T * n}   # n rollouts, cycles, steps or matches
    finite = lambda *xs: all(isinstance(x, float) and math.isfinite(x) and x > 0 for x in xs)

    # The shape of every K1, K2, K4 and K4 fm launch the scripts make (the launchers' trailing
    # arguments), for the twin checks.
    shapes = {"resolve_turn": set(), "deal_games": set(), "act_rollout": set(), "act_rollout_fm": set()}
    real = {"resolve_turn": (step_kernel, "_ROW_MAJOR"), "deal_games": (game_kernel, "_DEAL"),
            "act_rollout": (act_rollout_kernel, "_ROLLOUT"), "act_rollout_fm": (act_rollout_kernel, "_ROLLOUT_FM")}
    originals = {k: getattr(m, a) for k, (m, a) in real.items()}
    shape_of = {
        "resolve_turn": lambda a: (EnvConfig(a[-3], a[-2], threshold=a[-1]), a[-4], None),          # G, P, R, T
        "deal_games": lambda a: (EnvConfig(a[-5], a[-4], a[-1], a[-3], hand_size=a[-2]), a[-6], None),  # G,P,R,T,H,N
        "act_rollout": lambda a: (EnvConfig(a[9], a[10], a[13], a[11], bool(a[16]), a[12]), a[8], a[14]),
    }
    shape_of["act_rollout_fm"] = shape_of["act_rollout"]

    def recording(name):
        def launch(device_index, *args):
            shapes[name].add(shape_of[name](args))
            return originals[name](device_index, *args)
        return launch

    def run(name, cut, argv, want, main):
        """``want``: the launches, or a function of the script's result giving them."""
        torch.cuda.synchronize()
        _build.reset_launches()
        root = logging.getLogger()
        handlers, level = root.handlers[:], root.level
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                result = main(argv)
        finally:
            for h in root.handlers[:]:
                if h not in handlers:
                    root.removeHandler(h)
            root.setLevel(level)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in got.items():
            path[k] += v
        want = want(result) if callable(want) else want
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        line[name] = {"argv": argv, "cut": cut, "seconds": secs, "launches": got}
        log(f"[14] {name} {' '.join(argv)} ({cut}): {secs:.2f} s, launches {got}")
        for text in out.getvalue().strip().splitlines()[-8:]:
            log(f"[14]   {text}")
        return result

    for k, (m, a) in real.items():
        setattr(m, a, recording(k))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # act_rollout_probe: K4 once for the checks and its replay (K2 once, K1 ten times), then
            # (1 + iters) chains of K4 generations.
            chain, iters = 16, 2
            res = run("act_rollout_probe", f"chains of {chain} generations, {iters} timed (not 256, 5)",
                      ["--chain", str(chain), "--iters", str(iters)],
                      {**units(1), "act_rollout": 1 + (1 + iters) * chain}, act_rollout_probe.main)
            if res["structural_fails"] or res["action_agreement"] < 0.999 or res["score_agreement"] < 0.999:
                raise AssertionError(f"act_rollout_probe: {res}")
            line["act_rollout_probe"]["result"] = res
            # roofline_cycle: the fm cycle at learn_iters 8 and 1, then the raw fm kernel, each one
            # untimed and reps timed chains; K4 fm once a cycle or generation.
            chain, reps = 2, 1
            res = run("roofline_cycle", f"chains of {chain} cycles, {reps} timed (not 256, 3)",
                      ["--chain", str(chain), "--reps", str(reps), "--out", os.path.join(tmp, "roof.json")],
                      {"act_rollout_fm": 3 * (1 + reps) * chain}, roofline_cycle.main)
            phases = res["phases"].values()
            if not (finite(*(p["floor_ms"] for p in phases), res["measured_ms_per_cycle"]["full_8_iters"])
                    and all(math.isfinite(p["measured_ms"]) for p in phases)):
                raise AssertionError(f"roofline_cycle: {res}")
            line["roofline_cycle"]["result"] = res
            # bench_trainable --dtype bfloat16: its three learners at JAX's defaults, 2 untimed and 8
            # timed cycles each (K2 once and K1 ten times a step or cycle).
            res = run("bench_trainable_bf16", "the JAX defaults, bf16", ["--dtype", "bfloat16"], units(3 * 10),
                      bench_trainable.main)
            if set(res) != {"reinforce", "dqn", "acer"} or not finite(*(float(v["value"]) for v in res.values())):
                raise AssertionError(f"bench_trainable: {res}")
            line["bench_trainable_bf16"]["result"] = res
            # profile_trainable --dtype bfloat16: REINFORCE 3 rollouts and 3 steps; DQN 5 warm-up
            # cycles, 3 learn-free and 3 full ones (the bare updates and samples launch neither).
            res = run("profile_trainable_bf16", "chains of 1, 1 timed (not 16, 8), bf16",
                      ["--chain", "1", "--iters", "1", "--dtype", "bfloat16"], units(6 + 11), profile_trainable.main)
            if not finite(res["reinforce"]["full_cycle_ms"], res["dqn"]["1_update_ms"], res["dqn"]["1_per_sample_ms"]):
                raise AssertionError(f"profile_trainable: {res}")
            line["profile_trainable_bf16"]["result"] = res
            short = ["--chain", "1", "--iters", "1"]
            # micro_cycle and micro_cycle2: each row 2 untimed and 1 timed cycle; a row whose cycle inserts more
            # transitions than its buffer holds (at G=4096 micro_cycle's capacity-50,000 row, and micro_cycle2's
            # two cap=16384, G=1024 rows) raises at its first insert, after its first rollout.
            over = lambda games, cap: games * cfg4.num_players * T > cap
            rows = {"micro_cycle": [(f"per={per} cap={cap} learn_iters={li}", micro_cycle.G, cap)
                                    for per, cap, li in micro_cycle.ROWS],
                    "micro_cycle2": [(tag, games or micro_cycle2.G, cap)
                                     for tag, games, cap, _, _ in micro_cycle2.ROWS]}
            for name, main in (("micro_cycle", micro_cycle.main), ("micro_cycle2", micro_cycle2.main)):
                raising = sorted(tag for tag, games, cap in rows[name] if over(games, cap))
                res = run(name, "chains of 1 cycle, 1 timed (not 16, 6)", short,
                          units(3 * (len(rows[name]) - len(raising)) + len(raising)), main)
                raised = sorted(k for k, v in res.items() if isinstance(v, str))
                if raised != raising or not finite(*(v for k, v in res.items() if k not in raised)):
                    raise AssertionError(f"{name}: {res}")
                line[name]["result"] = res
            # micro_cycle3: (a), (b), (d) 3 rollouts or cycles each; (c) the insert alone launches nothing.
            res = run("micro_cycle3", "chains of 1, 1 timed (not 16, 6)", short, units(9), micro_cycle3.main)
            if not finite(*res.values()):
                raise AssertionError(f"micro_cycle3: {res}")
            line["micro_cycle3"]["result"] = res
            # micro_cycle4 and micro_cycle5: one untimed and one timed chain a row; 4 rollouts and 2 cycles,
            # 2 rollouts and 4 cycles.
            for name, main in (("micro_cycle4", micro_cycle4.main), ("micro_cycle5", micro_cycle5.main)):
                res = run(name, "chains of 1, 1 timed (not 16 or 32, 6)", short, units(6 * 2), main)
                if not finite(*res.values()):
                    raise AssertionError(f"{name}: {res}")
                line[name]["result"] = res
            # micro_per: seven probes of per_sample's parts; no kernel of the port.
            res = run("micro_per", "chains of 16, 2 timed (not 64, 8)", ["--chain", "16", "--iters", "2"], {},
                      micro_per.main)
            if not finite(*res.values()):
                raise AssertionError(f"micro_per: {res}")
            line["micro_per"]["result"] = res
            # micro_acer: 3 rollouts and the fixed batch's; the train steps launch neither.
            res = run("micro_acer", "chains of 1, 1 timed (not 16, 6)", short, units(4), micro_acer.main)
            if not finite(*res.values()):
                raise AssertionError(f"micro_acer: {res}")
            line["micro_acer"]["result"] = res
            # profile_ab: REINFORCE 2 seeds x 2 arms x 2 steps; ACER 6 timing cycles an arm, then per seed
            # 2 all-fresh and the equal-wall count of subsampled cycles; per family and seed 2 matches
            # against random seats and a head-to-head of 2.
            seeds = 2

            def ab_units(r):
                sub = r["acer"]["equal_wall_cycle_counts"]["subsampled"]
                return units(seeds * 2 * 2 + 2 * 6 + seeds * (2 + sub) + 2 * seeds * 4)

            res = run("profile_ab", f"{seeds} seeds, 2 cycles an arm, 1,024 eval games (not 8, 400 and 120, 4,096)",
                      ["--seeds", str(seeds), "--cycles", "2", "--acer-cycles", "2", "--curve-every", "1",
                       "--curve-every-acer", "1", "--eval-games", "1024", "--out", os.path.join(tmp, "ab.json")],
                      ab_units, profile_ab.main)
            rates = [x for fam in res.values() for v in fam["win_vs_3_random"].values() for x in v]
            rates += res["reinforce"]["head_to_head_fused_rate"] + res["acer"]["head_to_head_subsampled_rate"]
            if not all(0.0 <= x <= 1.0 for x in rates):
                raise AssertionError(f"profile_ab: {res}")
            line["profile_ab"]["result"] = {fam: {k: v[k] for k in v if "curves" not in k} for fam, v in res.items()}
            # The debug scripts: host GameSession games, one K2 a game and one K1 a turn, PUCT's search
            # turns besides (debug_mcts); debug_gradflow 3 cycles of 256 games.
            for name, main, games in (("debug_dqn", debug_dqn.main, 2), ("debug_acer", debug_acer.main, 3)):
                res = run(name, "full", [], units(games), main)
                if len(res) != games or not all((r <= 0).all() for r in res):
                    raise AssertionError(f"{name}: {res}")
                line[name]["results"] = [r.tolist() for r in res]
            puct = PUCTAgent(mc_max=32, mc_per_card=4, batch_playouts=8, device="cpu")
            searches = sum(host_search_turns(puct, n) for n in range(1, cfg2.hand_size + 1))
            res = run("debug_mcts", "full", [], {"deal_games": 1, "resolve_turn": T + searches}, debug_mcts.main)
            if len(res) != 1 or not (res[0] <= 0).all():
                raise AssertionError(f"debug_mcts: {res}")
            line["debug_mcts"]["results"] = [r.tolist() for r in res]
            res = run("debug_gradflow", "full", ["--out", os.path.join(tmp, "grad_flow.png")], units(3),
                      debug_gradflow.main)
            stats, figure = res
            if not all(math.isfinite(s["max_abs"]) for s in stats.values()) or not stats:
                raise AssertionError(f"debug_gradflow: {stats}")
            line["debug_gradflow"].update(grad_stats=stats, figure=figure)
    finally:
        for k, (m, a) in real.items():
            setattr(m, a, originals[k])
    line["phase_launches"] = {k: v for k, v in path.items() if v}

    line["bf16_card_vs_cpu"] = bf16_card_against_cpu(dev)
    log(f"[14] bf16 card vs CPU (of the output's scale; limits {BF16_FWD_RTOL}, gradient {BF16_GRAD_RTOL} "
        f"relative + {BF16_GRAD_ATOL} of the largest): {line['bf16_card_vs_cpu']}")
    # K1, K2, K4 and K4 fm against their twins at every shape the scripts launched them at; these
    # launches are not the path's.
    errs = {"deal_games": 0.0, "resolve_turn": 0.0, "act_rollout": 0.0, "act_rollout_fm": 0.0}
    k12 = {}
    for name in ("resolve_turn", "deal_games"):
        for cfg, games, _ in shapes[name]:
            k12.setdefault(cfg, set()).add(games)
    for cfg, sizes in sorted(k12.items(), key=lambda kv: kv[0].num_players):
        for name, err in k1_k2_against_twins(cfg, sorted(sizes), PROFILE_CHECK_SEED, dev).items():
            errs[name] = max(errs[name], err)
    agreement = {}
    for name in ("act_rollout", "act_rollout_fm"):
        for cfg, games, hidden in sorted(shapes[name], key=lambda s: (s[1], s[2])):
            agree, err = k4_against_twin(cfg, games, hidden, PROFILE_CHECK_SEED, dev, name == "act_rollout_fm")
            errs[name] = max(errs[name], err)
            agreement[f"{name} G={games} hidden={hidden}"] = agree
    line["twin_shapes"] = {"k1_k2": {str(cfg.num_players): sorted(s) for cfg, s in k12.items()},
                           "k4": sorted(f"{n} G={g} hidden={h}" for n in ("act_rollout", "act_rollout_fm")
                                        for _, g, h in shapes[n])}
    line["k4_twin_agreement"] = agreement
    log(f"[14] K1/K2 bit-exact vs twins at {line['twin_shapes']['k1_k2']} (players: games); K4 and K4 fm "
        f"vs twins at {line['twin_shapes']['k4']}: deals exact, agreeing games bit for bit, agreement {agreement}")
    return line, path, errs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec, tree_leaves
    from rl6nimmt_torch.experiments.kernel_times import (check_yardsticks, cuda_ms, device_ms, smi_line,
                                                         yardsticks)
    from rl6nimmt_torch.buffers import per_clone, per_init, per_init_aligned_fm, per_init_fm, per_init_kd
    from rl6nimmt_torch.engine import EnvConfig, deal, step
    from rl6nimmt_torch.nets import draw_mlp_noise, mlp_init
    from rl6nimmt_torch.ops import _build
    from rl6nimmt_torch.ops.act_rollout_check import (fm_agreement, greedy_replay_agreement,
                                                      insert_planes_agreement, insert_twin_agreement,
                                                      turn_effective_weights)
    from rl6nimmt_torch.ops.act_rollout_kernel import (S_PAD, SCAL_ROWS, act_insert_plain, act_rollout_fm_plain,
                                                       act_rollout_plain, make_act_insert_kernel,
                                                       make_act_rollout_kernel)
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
    # K1's four instances (two layouts, flagship and runtime sizes), K2's, K3's,
    # K6 env's and obs's two each (flagship and runtime sizes) and K7's k7:
    # nothing in local memory.
    lean_ptxas = {k: ptxas.get(k, "missing") for k in K1_INSTANCES + K2_K3_INSTANCES + K6_K7_INSTANCES}
    if any(not all(re.search(rf"(?<![\d.]){z}", v) for z in ("0 bytes stack frame", "0 bytes spill stores",
                                                              "0 bytes spill loads"))
           for v in lean_ptxas.values()):
        raise AssertionError(f"K1, K2, K3, K6 env/obs and K7 k7 instances must use no stack and no spills: "
                             f"{lean_ptxas}")
    if "act_rollout_fm_kernel" not in ptxas:
        raise AssertionError("the build holds no ptxas line of K4's feature-major entry act_rollout_fm_kernel")
    log(f"[1] K4 feature-major entry act_rollout_fm_kernel: {ptxas['act_rollout_fm_kernel']}")

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
    play_fm = make_act_rollout_kernel(cfg, G, HIDDEN, feature_major=True)

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
    (okf, akf, rkf), (opf, apf, rpf) = play_fm(79, *k4_args), act_rollout_fm_plain(cfg, 79, G, *k4_args)
    same_fm = (akf == apf).all(dim=0)
    if not (torch.equal(okf[:, :cfg.num_players], opf[:, :cfg.num_players]) and torch.equal(same_fm, same)
            and torch.equal(okf[..., same_fm], opf[..., same_fm]) and torch.equal(rkf[:, same_fm], rpf[:, same_fm])):
        raise AssertionError("K4 act_rollout_fm vs twin: deals, agreeing games or their outputs differ")
    errs["act_rollout_fm"] = max_abs_err([(okf[..., same_fm], opf[..., same_fm]), (rkf[:, same_fm], rpf[:, same_fm])])
    log(f"[2] K1-K3 bit-exact vs twins at G={G} (K1 in both layouts on all {cfg.max_turns} turns, the "
        f"games-last entry == the row-major one; a launch under torch.cuda.stream is on that stream); "
        f"K4 deals exact, action agreement {k4_agree:.6f}, "
        f"{int(same.sum())}/{G} games identical; K4 feature-major vs its twin: the same games agree, bit for bit")
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
    log(f"[3] insert_planes_agreement at G={G}: K5 planes == the n-step harvests of K4's row-major and "
        f"feature-major trajectories, rewards within {reward_err:.3g}")

    # ------------------------------------------------------------ phase 4
    adam = Adam(1e-3)
    block = G * cfg.num_players * cfg.max_turns
    options = {"engine": {}, "kernel": dict(kernel_act_rollout=True), "insert": dict(kernel_insert=True),
               "kernel_fm": dict(kernel_act_rollout=True, feature_major=True),
               "kernel_fm_aligned": dict(kernel_act_rollout=True, feature_major=True,
                                         per_aligned_capacity=PER_CAPACITY)}
    cycles = {mode: make_dqn_selfplay_step(cfg, dqn, adam, G, learn_iters=LEARN_ITERS, device=dev, **kw)
              for mode, kw in options.items()}
    fresh_buffer = {
        "engine": lambda: per_init(PER_CAPACITY, dqn_replay_example(cfg), device=dev),
        "kernel": lambda: per_init(PER_CAPACITY, dqn_replay_example(cfg), device=dev),
        "insert": lambda: per_init_kd(KD_CAPACITY, S_PAD, SCAL_ROWS, device=dev),
        "kernel_fm": lambda: per_init_fm(PER_CAPACITY, dqn_replay_example(cfg), device=dev),
        "kernel_fm_aligned": lambda: per_init_aligned_fm(PER_CAPACITY, block, dqn_replay_example(cfg), device=dev),
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
        # The aligned buffer's size saturates at the logical capacity; its ptr runs over the physical one.
        logical = PER_CAPACITY if mode == "kernel_fm_aligned" else buf.capacity
        if (buf.size, buf.ptr) != (min(inserted, logical), inserted % buf.capacity) \
                or int((buf.priorities > 0).sum()) != min(inserted, logical):
            raise AssertionError(f"{mode} cycles left PER size {buf.size}, ptr {buf.ptr}, "
                                 f"{int((buf.priorities > 0).sum())} live slots")
        train_state[mode] = (p, tgt, o, buf)
        log(f"[4] {CYCLES} flagship cycles ({mode}): losses {losses}, mean score {float(m['mean_score'])}, "
            f"PER size {buf.size}, ptr {buf.ptr} (physical capacity {buf.capacity})")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # ---- end of the main path ----
    log(f"[4] main-path launches: {launches}")
    # Each path launches exactly its own kernels, per generation or cycle.
    engine_path = {"deal_games": 1, "resolve_turn": cfg.max_turns}
    expected = {"rollout_engine": engine_path, "rollout_fused": {"play_random_games": 1},
                "rollout_games_last": {"deal_games": 1, "resolve_turn_t": cfg.max_turns},
                "cycle_engine": engine_path, "cycle_kernel": {"act_rollout": 1},
                "cycle_insert": {"act_insert": 1}, "cycle_kernel_fm": {"act_rollout_fm": 1},
                "cycle_kernel_fm_aligned": {"act_rollout_fm": 1}}
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
    # K4's feature-major emit against its row-major emit permuted, bit for bit.
    for hidden in FM_CHECK_HIDDEN:
        hdqn = DQNConfig(**dict(FLAGSHIP, hidden_sizes=(hidden,)))
        hspec = q_network_spec(hdqn, cfg.state_length, cfg.num_actions)
        hgen = torch.Generator(device=dev).manual_seed(20261017 + hidden)
        heff = turn_effective_weights(hspec, mlp_init(hgen, hspec), draw_mlp_noise(hspec, hgen,
                                                                                  batch=(cfg.max_turns,)))
        hargs = tuple(x.contiguous() for x in (heff["trunk"][0]["w"], heff["trunk"][0]["b"],
                                               heff["heads"][1]["w"], heff["heads"][1]["b"]))
        for games in FM_CHECK_GAMES:
            fm_agreement(cfg, games, hidden, 83, hargs)
    log(f"[5] fm_agreement: K4 feature-major == K4 row-major permuted, bit for bit, at G in {FM_CHECK_GAMES} "
        f"and hidden in {FM_CHECK_HIDDEN}")
    # The rates and every per-call time come before the first profiler session
    # of this process (device_ms, profile_call): a session may slow later host work.
    P, R, T, H, S, A = cfg.num_players, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.state_length, cfg.num_actions
    turns = cfg.max_turns
    steps_per_gen = G * turns
    rates = {}
    for mode in ROLLOUTS:
        one = make_random_rollout_generations(cfg, G, 1, fused=(mode == "fused"), games_last=(mode == "games_last"),
                                              device=dev)
        sec = host_seconds(lambda: one(4242), 10 if mode == "fused" else 3)
        rates[f"random_rollout_{mode}_env_steps_per_s"] = steps_per_gen / sec
    # The cycle modes in turns, forward then backward (the host's speed drifts);
    # each mode's rate from the mean of its two runs.
    cycle_secs = {mode: [] for mode in cycles}
    for mode in list(cycles) + list(reversed(cycles)):
        p, tgt, o, buf = train_state[mode]
        cgen = torch.Generator(device=dev).manual_seed(11)
        cycle_secs[mode].append(host_seconds(lambda: cycles[mode](p, tgt, o, buf, cgen, 0.0), 3))
    for mode, secs in cycle_secs.items():
        rates[f"dqn_cycle_{mode}_env_steps_per_s"] = steps_per_gen / (sum(secs) / len(secs))
    log(json.dumps({"cycle_seconds_in_turns": cycle_secs, "order": list(cycles) + list(reversed(cycles)),
                    "card": card}))
    for k, v in rates.items():
        log(json.dumps({"metric": k, "value": v, "card": card}))
    # Phase 8's path and rates, also before the first profiler session.
    learner_line, learner_launches, learner_arms = learner_rates(dev, card)
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
        "act_rollout_fm": (lambda: play_fm(7, *k4_args),
                           lambda: act_rollout_fm_plain(cfg, 7, G, *k4_args), 20, 3),
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
            "act_rollout_fm": (k4_bytes, k4_flops), "act_insert": (k5_bytes, k4_flops)}
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
        "act_rollout_fm": ("rl6nimmt_torch/csrc/act_rollout_kernel.cu",
                           "rl6nimmt_tpu/ops/act_rollout_kernel.py:239",
                           f"K4's weights -> obs i8[{S},{(turns + 1) * P},{G}], actions/rewards i32[{turns * P},{G}]"),
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
    def ptxas_of(kname):   # a template kernel's line is its flagship instance's
        return ptxas.get(f"{kname}_kernel", ptxas.get(f"{kname}_kernel<{K2_K3_FLAGSHIP}>", "n/a"))

    games_per_block = _build.library().rl6_play_games()
    k1_games, k1_threads = _build.library().rl6_resolve_games(), _build.library().rl6_resolve_threads()
    k23_games, k23_threads = _build.library().rl6_game_games(), _build.library().rl6_game_threads()
    for row in rows:
        if row["name"] in ("act_rollout", "act_rollout_fm", "act_insert"):
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
        log(json.dumps(profile_call(lambda: cycle(p, tgt, o, buf, cgen, 0.0), f"dqn_cycle_{mode}")))

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
    # env plays K3's games: at the flagship shape, and on both kernels' runtime-sized instances.
    for ecfg, games in ((acfg, G), (EnvConfig(6), 333)):
        k3_rewards, _ = play_random_games(ecfg, 91, games, device=dev)
        env_rewards = make_act_ablate_kernel(ecfg, games, ablate.HID, "env")(91, *ablate.weights(ecfg, dev))[2]
        if not torch.equal(env_rewards.sum(dim=0), k3_rewards):
            raise AssertionError(f"K6 env's games differ from K3's on the same seed (P={ecfg.num_players}, "
                                 f"G={games})")
    log(f"[6] K6 env's per-game reward sums == K3 (play_random_games) on seed 91: P=4, {G} games and P=6, 333")

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
        ops = (2 * args[0].numel() * args[1].shape[-1] if key in ("k1", "k6")
               else args[0].numel() if key == "k3" else 0)
        if key == "k7":   # the mask leaves one dot a row: its h row and one wa column a distinct hand
            h3, wa, hand = args
            legal = hand[(hand >= 0) & (hand < wa.shape[1])]
            nbytes = (hand.numel() * hand.element_size() + out.numel() * out.element_size()
                      + (legal.numel() + torch.unique(legal).numel()) * h3.shape[-1] * h3.element_size())
            ops = 2 * legal.numel() * h3.shape[-1]
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

    # ------------------------------------------------------------ phase 7
    search_line, search_launches, twin_errs = search_phase(dev, card)
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games"):
            row["search_path_launches"] = search_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], twin_errs[row["name"]])
    print(json.dumps(search_line), flush=True)

    # ------------------------------------------------------------ phase 8
    checks, learner_twin_errs = learner_checks(dev)
    learner_line.update(checks)
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games"):
            row["learner_path_launches"] = learner_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], learner_twin_errs[row["name"]])
    for name in ("reinforce", "acer"):
        traced = profile_call(learner_arms[name].step, f"{name}_step_G{G}")
        log(json.dumps(traced))
        learner_line[f"profile_{name}"] = {k: traced[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                                   "kernel_launches", "phase_host_ms")}
    print(json.dumps({"learners": learner_line, "card": card}), flush=True)

    # ------------------------------------------------------------ phase 9
    t0 = time.perf_counter()
    tournament_line, tournament_launches, tournament_errs = tournament_phase(dev, card)
    tournament_line["phase_s"] = time.perf_counter() - t0
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games"):
            row["tournament_path_launches"] = tournament_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], tournament_errs[row["name"]])
    missing = [k for k in ("resolve_turn", "deal_games") if not tournament_launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the tournament path: {missing}")
    print(json.dumps({"tournament": tournament_line}), flush=True)

    # ------------------------------------------------------------ phase 10
    t0 = time.perf_counter()
    arena_line, arena_launches, arena_errs = arena_phase(dev, card)
    arena_line["phase_s"] = time.perf_counter() - t0
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games"):
            row["arena_path_launches"] = arena_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], arena_errs[row["name"]])
    print(json.dumps({"arena": arena_line}), flush=True)

    # ------------------------------------------------------------ phase 11
    t0 = time.perf_counter()
    dp_line, dp_launches, dp_errs = dp_phase(dev, card, k4_args)
    dp_line["phase_s"] = time.perf_counter() - t0
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games", "act_rollout", "act_rollout_fm", "act_insert"):
            row["dp_path_launches"] = dp_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], dp_errs.get(row["name"], 0.0))
    missing = [k for k in ("resolve_turn", "deal_games", "act_rollout", "act_rollout_fm", "act_insert")
               if not dp_launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the DP path: {missing}")
    print(json.dumps({"dp": dp_line}), flush=True)

    # ------------------------------------------------------------ phase 12
    t0 = time.perf_counter()
    scripts_line, scripts_launches = scripts_phase(dev, card)
    scripts_line["phase_s"] = time.perf_counter() - t0
    log(f"[12] the experiment scripts took {scripts_line['phase_s']:.1f} s")
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games", "act_rollout", "act_rollout_fm", "act_insert"):
            row["scripts_path_launches"] = scripts_launches[row["name"]]
    print(json.dumps({"scripts": scripts_line}), flush=True)

    # ------------------------------------------------------------ phase 13
    t0 = time.perf_counter()
    evals_line, evals_launches, evals_errs = evals_phase(dev, card)
    evals_line["phase_s"] = time.perf_counter() - t0
    log(f"[13] the evaluation scripts took {evals_line['phase_s']:.1f} s")
    for row in rows:
        if row["name"] in ("resolve_turn", "deal_games"):
            row["evals_path_launches"] = evals_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], evals_errs[row["name"]])
    missing = [k for k in ("resolve_turn", "deal_games") if not evals_launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the evaluation scripts' path: {missing}")
    print(json.dumps({"evals": evals_line}), flush=True)

    # ------------------------------------------------------------ phase 14
    t0 = time.perf_counter()
    profilers_line, profilers_launches, profilers_errs = profilers_phase(dev, card)
    profilers_line["phase_s"] = time.perf_counter() - t0
    log(f"[14] the profilers, micro-benchmarks and debug scripts took {profilers_line['phase_s']:.1f} s")
    path14 = ("resolve_turn", "deal_games", "act_rollout", "act_rollout_fm")
    for row in rows:
        if row["name"] in path14:
            row["profilers_path_launches"] = profilers_launches[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], profilers_errs[row["name"]])
    missing = [k for k in path14 if not profilers_launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the profilers' path: {missing}")
    print(json.dumps({"profilers": profilers_line}), flush=True)

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
