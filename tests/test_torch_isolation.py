"""The port imports no JAX and no rl6nimmt_tpu, and its entry points need a
card unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rl6nimmt_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(rl6nimmt_torch.__path__, "rl6nimmt_torch."))

# The twins of the JAX profiling, micro-benchmark and debug scripts, and of bench_trainable.py.
PROFILER_TWINS = ("roofline_cycle", "profile_trainable", "profile_ab", "micro_cycle", "micro_cycle2", "micro_cycle3",
                  "micro_cycle4", "micro_cycle5", "micro_per", "micro_acer", "debug_dqn", "debug_acer", "debug_mcts",
                  "debug_gradflow", "act_rollout_probe", "bench_trainable")

BLOCKER = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'optax', 'flax', 'rl6nimmt_tpu'):\n"
    "    sys.modules[name] = None\n"
)


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_with_jax_blocked():
    imports = "".join(f"import {m}\n" for m in MODULES)
    out = _run(imports + "print('ok')")
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


def test_module_list_covers_the_ported_slice():
    for m in ("engine.env", "ops.philox", "ops.step_kernel", "ops.game_kernel", "ops.act_rollout_kernel",
              "ops.act_rollout_check", "utils.ops", "nets.mlp", "nets.convert", "buffers.ring",
              "buffers.per", "agents.dqn", "runtime.vector", "ops._build", "ops.act_ablate_kernel",
              "ops.probe_ops", "experiments.act_rollout_ablate", "experiments.probe_ops",
              # the search core
              "nets.normalize", "agents.reinforce", "agents.base", "agents.search", "agents.device_search",
              "agents.mcs", "runtime.device_match", "experiments.search_latency",
              "experiments.device_match_bench", "runtime.search_check",
              # REINFORCE and ACER
              "utils.returns", "agents.acer", "buffers.sequence", "buffers.host", "buffers.sumtree_native",
              "runtime.host_loop", "runtime.learner_check", "experiments.trainable_bench",
              # the tournament
              "agents.random_agent", "agents.human", "engine.wrapper", "runtime.session", "tournament",
              "tournament.elo", "tournament.tournament", "utils.checkpoint", "runtime.block",
              "runtime.device_tournament", "runtime.tournament_check", "cli", "cli.run",
              "experiments.simple_tournament",
              # device learner updates and the arena
              "runtime.device_learn", "runtime.arena",
              # data parallel and the host extras
              "parallel", "parallel.mesh", "parallel.launch", "runtime.dp_check", "experiments.multiprocess_dp",
              "utils.various", "nets.cnn", "runtime.metrics", "parity", "parity.harness", "parity.refenv",
              "runtime.callback_human", "experiments.train_selfplay",
              # the feature-major and block-aligned replay layouts and the scripts' twins
              "experiments.fm_cycle_bench", "experiments.micro_insert", "experiments.fm_strength_ab",
              "experiments.train_puct_prior", "experiments.long_train_eval", "experiments.strength_vs_budget",
              "experiments.play_human",
              # the evaluation, A/B and profiling scripts' twins
              "experiments.device_learn_strength_ab", "experiments.device_learn_speedup",
              "experiments.profile_devblock", "experiments.budget_saturation", "experiments.devblock_attrib",
              "experiments.prior_decoupled_eval", "experiments.puct_batch_ab", "experiments.devroot_equivalence",
              "experiments.acer_onpolicy_ab", "experiments.arena_eval",
              # the profilers, micro-benchmarks and debug scripts' twins
              *(f"experiments.{m}" for m in PROFILER_TWINS), "experiments.chain_timing",
              # the weak-scaling bench's twin
              "experiments.scaling_bench"):
        assert "rl6nimmt_torch." + m in MODULES


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in (ROOT / "rl6nimmt_torch").rglob("*.py")))
def test_no_source_imports_jax(path):
    """No import statement (at any indentation, so lazy imports count too)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|rl6nimmt_tpu)\b", re.M)
    assert not bad.search((ROOT / path).read_text()), path


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from rl6nimmt_torch.agents import acer, device_search, mcs, reinforce, search
    from rl6nimmt_torch.buffers import seq_init
    from rl6nimmt_torch.experiments import trainable_bench
    from rl6nimmt_torch.runtime import vector
    from rl6nimmt_torch.runtime.host_loop import play_games
    from rl6nimmt_torch.runtime.learner_check import learners_card_against_cpu
    from rl6nimmt_torch.agents.dqn import Adam, DQNConfig, q_network_spec
    from rl6nimmt_torch.buffers import per_init, per_init_kd, ring_init
    from rl6nimmt_torch.engine import EnvConfig, deal
    from rl6nimmt_torch.experiments import act_rollout_ablate, device_match_bench, probe_ops, search_latency
    from rl6nimmt_torch.nets import MLPSpec, mlp_init, noise_from_jax, params_from_jax
    from rl6nimmt_torch.ops.game_kernel import (deal_decks_plain, deal_games, deal_games_plain,
                                                play_random_games, play_random_games_plain,
                                                random_pick_words)
    from rl6nimmt_torch.runtime import search_check
    from rl6nimmt_torch.runtime.device_match import make_device_match_fn
    from rl6nimmt_torch.runtime.vector import (dqn_replay_example, make_dqn_selfplay_step,
                                               make_random_rollout, make_random_rollout_generations)
    from rl6nimmt_torch.agents import DQNVanilla, DrunkHamster, Human, Noisy_D3QN_PRB_NStep
    from rl6nimmt_torch.cli import run as cli_run
    from rl6nimmt_torch.engine.wrapper import SechsNimmtEnv
    from rl6nimmt_torch.experiments import simple_tournament
    from rl6nimmt_torch.runtime import device_tournament
    from rl6nimmt_torch.runtime.block import BlockSession
    from rl6nimmt_torch.runtime.device_tournament import DeviceBlockSession
    from rl6nimmt_torch.runtime.session import GameSession
    from rl6nimmt_torch.runtime.tournament_check import tournament_card_against_cpu
    from rl6nimmt_torch.tournament import Tournament
    from rl6nimmt_torch.runtime.arena import SeatPolicy, make_arena, play_match
    from types import SimpleNamespace
    from rl6nimmt_torch.experiments import multiprocess_dp, train_selfplay
    from rl6nimmt_torch.nets import CNNSpec, cnn_init, cnn_params_from_jax
    from rl6nimmt_torch.parallel import (make_dp_acer_step, make_dp_dqn_step, make_dp_reinforce_step, make_mesh,
                                         make_mesh_2level)
    from rl6nimmt_torch.runtime.callback_human import make_callback_human_game, play_callback_game
    from rl6nimmt_torch.buffers import per_init_aligned, per_init_aligned_fm, per_init_fm
    from rl6nimmt_torch.experiments import (fm_cycle_bench, fm_strength_ab, long_train_eval, micro_insert,
                                            play_human, strength_vs_budget, train_puct_prior)
    from rl6nimmt_torch.experiments import (acer_onpolicy_ab, budget_saturation, devblock_attrib,
                                            device_learn_speedup, device_learn_strength_ab, devroot_equivalence,
                                            prior_decoupled_eval, profile_devblock, puct_batch_ab)
    import importlib

    from rl6nimmt_torch.experiments import bench_trainable, debug_gradflow, scaling_bench

    cfg = EnvConfig(4)
    cpu_hamster = DrunkHamster(seed=0, device="cpu")
    spec = q_network_spec(DQNConfig(hidden_sizes=(8,)), cfg.state_length, cfg.num_actions)
    net = MLPSpec(cfg.state_length + 1)
    tree = {"trunk": [{"w": [[0.0]], "b": [0.0]}], "heads": []}
    card_mesh = SimpleNamespace(axis_names=("games",), reduce_groups=lambda axis=None: (None,),
                                device=torch.device("cuda"))
    calls = [
        lambda: make_random_rollout(cfg, 8),
        lambda: make_random_rollout_generations(cfg, 8, 1),
        lambda: make_dqn_selfplay_step(cfg, DQNConfig(), Adam(), 8),
        lambda: deal(cfg, 0, 8),
        lambda: deal_games(cfg, 0, 8),
        lambda: play_random_games(cfg, 0, 8),
        lambda: deal_decks_plain(cfg, 0, 8),
        lambda: deal_games_plain(cfg, 0, 8),
        lambda: play_random_games_plain(cfg, 0, 8),
        lambda: random_pick_words(cfg, 0, 8),
        lambda: per_init(16, dqn_replay_example(cfg)),
        lambda: per_init_kd(5120, 48, 8),
        lambda: ring_init(16, dqn_replay_example(cfg)),
        lambda: mlp_init(torch.Generator().manual_seed(0), spec),
        lambda: params_from_jax(tree),
        lambda: noise_from_jax([{"eps_in": [[0.0]], "eps_out": [[0.0]]}]),
        lambda: act_rollout_ablate.weights(cfg),
        lambda: act_rollout_ablate.build("env", games=8, chain=1),
        lambda: act_rollout_ablate.main(["full"]),
        lambda: probe_ops.probe_inputs(),
        lambda: probe_ops.run(),
        lambda: probe_ops.main(),
        lambda: search.make_playout_fn(cfg, "uniform", None),
        lambda: search.build_root_states_batch(cfg, [[[1]] * 4], [[2]], np.zeros((1, 1, 3, 1), np.int64)),
        lambda: search.build_root_state(cfg, [[1]] * 4, [2], np.zeros((1, 3, 1), np.int64)),
        lambda: device_search.factorial_table(10),
        lambda: device_search.make_device_decision_fn(cfg, "uniform", None, "uniform", 8, 8, 2.0),
        lambda: device_search.make_device_decision_fn_many(cfg, "uniform", None, "uniform", 8, 8, 2.0),
        lambda: device_search.make_unified_decision_fn(cfg, net, 8, 8),
        lambda: mcs.MCSAgent(seed=0),
        lambda: mcs.PUCTAgent(seed=0),
        lambda: mcs.PUCTCustomedAgent(seed=0),
        lambda: make_device_match_fn(cfg, ("uniform",) * 4, None, 8),
        lambda: search_check.search_position(cfg, 0, 2),
        lambda: search_check.exact_prior(net),
        lambda: search_latency.main([]),
        lambda: device_match_bench.main([]),
        # REINFORCE and ACER
        lambda: vector.make_reinforce_rollout(cfg, net, 8),
        lambda: vector.make_reinforce_train_step(cfg, net, Adam(), 8),
        lambda: vector.make_acer_rollout(cfg, net, 8, 0.1),
        lambda: vector.make_acer_selfplay_step(cfg, net, Adam(), 8),
        lambda: seq_init(16, 10, vector.acer_sequence_example(cfg)),
        lambda: reinforce.BatchedReinforceAgent(seed=0),
        lambda: reinforce.MaskedReinforceAgent(seed=0),
        lambda: acer.BatchedActionValueActorCriticAgent(seed=0),
        lambda: acer.BatchedACERAgent(seed=0),
        lambda: mcs.PolicyMCSAgent(seed=0),
        lambda: play_games([mcs.MCSAgent(seed=0, device="cpu")] * 2),
        lambda: learners_card_against_cpu(8),
        lambda: trainable_bench.ReinforceArm(cfg, 8, "cuda"),
        lambda: trainable_bench.AcerArm(cfg, 8, "cuda"),
        lambda: trainable_bench.main([]),
        # the tournament
        lambda: SechsNimmtEnv(4),
        lambda: GameSession(object(), object()),
        lambda: BlockSession([[object(), object()]]),
        lambda: Tournament(),
        lambda: DrunkHamster(seed=0),
        lambda: Human(),
        lambda: DQNVanilla(seed=0),
        lambda: Noisy_D3QN_PRB_NStep(seed=0),
        lambda: DeviceBlockSession([[cpu_hamster, cpu_hamster]]),
        lambda: device_tournament.make_device_block_fn(cfg, net, 2, 8),
        lambda: tournament_card_against_cpu(),
        lambda: cli_run.main(["--games", "1"]),
        lambda: simple_tournament.main(["--scale", "0.001"]),
        # the arena
        lambda: make_arena(cfg, (SeatPolicy("random"),) * 4, 8),
        lambda: play_match([cpu_hamster] * 4, 8),
        # data parallel (a mesh on the card: its steps build their local steps there)
        lambda: make_mesh(),
        lambda: make_mesh_2level(1),
        lambda: make_dp_reinforce_step(cfg, net, Adam(), 8, card_mesh),
        lambda: make_dp_dqn_step(cfg, DQNConfig(), Adam(), 8, card_mesh),
        lambda: make_dp_acer_step(cfg, net, Adam(), 8, card_mesh),
        lambda: multiprocess_dp.main(["--num-processes", "1"]),
        # the host extras
        lambda: cnn_init(torch.Generator(), CNNSpec(3, (4,), 2)),
        lambda: cnn_params_from_jax([{"w": [[0.0]], "b": [0.0]}]),
        lambda: make_callback_human_game(cfg, net),
        lambda: play_callback_game(["random"]),
        lambda: train_selfplay.run(["--steps", "1"]),
        lambda: train_selfplay.main(["--dp", "--steps", "1"]),
        # the feature-major and block-aligned replay layouts and the scripts' twins
        lambda: per_init_fm(16, dqn_replay_example(cfg)),
        lambda: per_init_aligned(16, 8, dqn_replay_example(cfg)),
        lambda: per_init_aligned_fm(16, 8, dqn_replay_example(cfg)),
        lambda: make_dqn_selfplay_step(cfg, DQNConfig(per=True), Adam(), 8, feature_major=True,
                                       per_aligned_capacity=16),
        lambda: fm_cycle_bench.main([]),
        lambda: micro_insert.main([]),
        lambda: fm_strength_ab.main([]),
        lambda: train_puct_prior.main([]),
        lambda: long_train_eval.main([]),
        lambda: strength_vs_budget.main([]),
        lambda: play_human.main([]),
        lambda: play_human.main(["--device-game"]),
        # the evaluation, A/B and profiling scripts' twins
        lambda: device_learn_strength_ab.main([]),
        lambda: device_learn_speedup.main([]),
        lambda: profile_devblock.main([]),
        lambda: budget_saturation.main([]),
        lambda: devblock_attrib.main([]),
        lambda: prior_decoupled_eval.main([]),
        lambda: puct_batch_ab.main([]),
        lambda: devroot_equivalence.main([]),
        lambda: acer_onpolicy_ab.main([]),
        # the profilers, micro-benchmarks and debug scripts' twins
        *(lambda m=m: importlib.import_module(f"rl6nimmt_torch.experiments.{m}").main([]) for m in PROFILER_TWINS),
        lambda: debug_gradflow.main(["--platform", "cuda"]),
        lambda: trainable_bench.ReinforceArm(cfg, 8, "cuda", dtype="bfloat16"),
        lambda: bench_trainable.DqnArm(cfg, 8, "cuda"),
        # the weak-scaling bench's twin: NCCL needs a card whatever --device says
        lambda: scaling_bench.main([]),
        lambda: scaling_bench.main(["--backend", "nccl", "--device", "cpu"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # Asking for the CPU works.
    total, checksum = make_random_rollout_generations(cfg, 8, 1, device="cpu")(0)
    assert total.shape == (8, 4) and float(checksum) > 0
    scores = make_device_match_fn(cfg, ("uniform", "random") * 2, None, 2, mc_max=4, device="cpu")(
        (None,) * 4, torch.Generator())
    assert scores.shape == (2, 4) and (scores <= 0).all()
    states, legal = SechsNimmtEnv(4, seed=0, device="cpu").reset()
    assert len(states) == 4 and all(len(h) == 10 for h in legal)
    session = GameSession(cpu_hamster, DrunkHamster(seed=1, device="cpu"), device="cpu")
    session.play_game()
    (block,) = DeviceBlockSession([[cpu_hamster, cpu_hamster]], device="cpu").play()
    assert (session.results[0] <= 0).all() and block.shape == (2,) and (block <= 0).all()


def _exports_with_jax_blocked(package):
    out = _run(f"import {package} as p\nprint(sorted(p.__all__))\n"
               f"assert all(hasattr(p, n) for n in p.__all__)")
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip()))


# JAX names the port leaves out, each for a stated reason: the vmap/jit
# wrappers need no port (ROADMAP queue 1); the K1 factories have the port names
# resolve_turn / resolve_turn_t (PARITY_TORCH.md section 11).  parity's
# refload.py is not ported and exports nothing at the package level.
NOT_EXPORTED = {
    "rl6nimmt_torch.engine": {"batched", "jitted_core"},
    "rl6nimmt_torch.ops": {"make_turn_resolver", "make_turn_resolver_t"},
}


@pytest.mark.parametrize("package", ["rl6nimmt_torch", "rl6nimmt_torch.engine", "rl6nimmt_torch.runtime",
                                     "rl6nimmt_torch.utils", "rl6nimmt_torch.ops", "rl6nimmt_torch.buffers",
                                     "rl6nimmt_torch.nets", "rl6nimmt_torch.parallel", "rl6nimmt_torch.parity",
                                     "rl6nimmt_torch.agents", "rl6nimmt_torch.tournament"])
def test_export_surfaces_match_jax(package):
    """Each package exports the JAX package's names (less the ones stated above),
    importable with JAX blocked and without a card; the root, ``runtime``,
    ``utils``, ``parallel`` and ``parity`` export exactly JAX's ``__all__``, in its order."""
    import importlib

    jax_all = importlib.import_module(package.replace("rl6nimmt_torch", "rl6nimmt_tpu")).__all__
    port = importlib.import_module(package)
    want = set(jax_all) - NOT_EXPORTED.get(package, set())
    assert want <= _exports_with_jax_blocked(package)
    if package in ("rl6nimmt_torch", "rl6nimmt_torch.runtime", "rl6nimmt_torch.utils", "rl6nimmt_torch.parallel",
                   "rl6nimmt_torch.parity"):
        assert port.__all__ == list(jax_all)
    if package == "rl6nimmt_torch.ops":
        assert {"resolve_turn", "resolve_turn_t"} <= set(port.__all__)


def test_mlp_spec_fields_match_jax():
    """``MLPSpec`` has JAX's fields with JAX's defaults, ``compute_dtype`` among them."""
    import dataclasses

    from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
    from rl6nimmt_torch.nets import MLPSpec

    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(MLPSpec) == fields(JMLPSpec)
    assert ("compute_dtype", "float32") in fields(MLPSpec)
