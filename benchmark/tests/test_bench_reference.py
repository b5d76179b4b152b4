"""The plain references against the program on the CPU at small sizes: the deal,
the turns and observations, both seat rules, and the REINFORCE loss, gradients
and Adam step."""

import torch

from benchmark.common import derive, load_json, HERE
from benchmark.reference import arena, game, nets, reinforce

RULES = game.Rules()
G = 48


def _port_cfg():
    from rl6nimmt_torch.engine import EnvConfig

    return EnvConfig(num_players=4)


def test_deal_equals_the_programs():
    from rl6nimmt_torch.ops.game_kernel import deal_games_plain

    for seed in (0, 7, 2**40 + 3, 2**63 - 5):
        g = game.deal(RULES, seed, torch.arange(G))
        board, length, hands = deal_games_plain(_port_cfg(), seed, G, "cpu")
        assert torch.equal(g.board, board.long()) and torch.equal(g.length, length.long())
        assert torch.equal(g.hands, hands.long())


def test_deal_of_a_block_is_those_games_of_the_whole_deal():
    whole = game.deal(RULES, 99, torch.arange(G))
    part = game.deal(RULES, 99, torch.arange(10, 20))
    assert torch.equal(part.hands, whole.hands[10:20]) and torch.equal(part.board, whole.board[10:20])


def test_turns_and_observations_equal_the_programs():
    from rl6nimmt_torch.engine.env import observe, state_from_deal, step_with
    from rl6nimmt_torch.ops.game_kernel import deal_games_plain
    from rl6nimmt_torch.ops.step_kernel import resolve_turn_plain

    cfg = _port_cfg()
    ref = game.deal(RULES, 5, torch.arange(G))
    state = state_from_deal(cfg, *deal_games_plain(cfg, 5, G, "cpu"))
    gen = torch.Generator().manual_seed(1)
    for t in range(RULES.hand_size):
        obs, _ = observe(cfg, state)
        assert torch.equal(game.observe(RULES, ref), obs)
        slot = torch.randint(0, RULES.hand_size - t, (G, 4), generator=gen)
        cards = torch.gather(ref.hands, 2, slot[..., None])[..., 0]
        ref, r_ref = game.play(RULES, ref, cards)
        state, r = step_with(cfg, state, cards.to(torch.int32), resolve_turn_plain)
        assert torch.equal(r_ref, r.long())
    assert torch.equal(ref.scores, state.scores.long())


def test_policy_logits_equal_the_programs():
    from rl6nimmt_torch.agents.reinforce import action_in_input_logits
    from rl6nimmt_torch.nets import MLPSpec

    net = load_json(HERE / "configs" / "reinforce_h100.json")["net"]
    params = nets.make_weights(net, 3, "cpu")
    g = game.deal(RULES, 11, torch.arange(G))
    obs = game.observe(RULES, g)
    spec = MLPSpec(48, (100, 100), (1,))
    ours = nets.policy_logits(RULES, params, obs, g.hands)
    theirs = action_in_input_logits(spec, params, obs, g.hands.to(torch.int32))
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_noisy_dueling_q_equals_the_programs():
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec, q_values

    net = load_json(HERE / "configs" / "d3qn_h64.json")["net"]
    params = nets.make_weights(net, 4, "cpu")
    cfg = DQNConfig(double=True, dueling=True, noisy=True, per=True, n_steps=10)
    spec = q_network_spec(cfg, 47, 104)
    gen = torch.Generator().manual_seed(2)
    noise = [{"eps_in": torch.randn(i, 1, generator=gen), "eps_out": torch.randn(1, o, generator=gen)}
             for i, o in nets.layer_sizes(net)]
    obs = game.observe(RULES, game.deal(RULES, 12, torch.arange(G)))[:, 0]
    ours = nets.dueling_q(params, obs, noise)
    theirs = q_values(cfg, spec, params, obs, noise)
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-4)


def test_seat_rules_pick_the_programs_cards():
    from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.runtime.arena import SeatDraws, SeatPolicy, _seat_actions

    g = game.deal(RULES, 13, torch.arange(G))
    obs = game.observe(RULES, g)[:, 0]
    hands = g.hands[:, 0]
    mask = (hands[:, :, None] == torch.arange(104)).any(dim=1)
    gen = torch.Generator().manual_seed(5)
    pol_net = load_json(HERE / "configs" / "reinforce_h100.json")["net"]
    dqn_net = load_json(HERE / "configs" / "d3qn_h64.json")["net"]
    dqn_cfg = DQNConfig(double=True, dueling=True, noisy=True, per=True, n_steps=10)
    cases = [
        ("random", None, SeatPolicy("random"), {"u": torch.rand(G, generator=gen)}),
        ("policy", nets.make_weights(pol_net, 6, "cpu"), SeatPolicy("policy", MLPSpec(48, (100, 100), (1,))),
         {"gumbel": -torch.log(-torch.log(torch.rand(G, 10, generator=gen)))}),
        ("dqn", nets.make_weights(dqn_net, 7, "cpu"), SeatPolicy("dqn", q_network_spec(dqn_cfg, 47, 104), dqn_cfg),
         {"q": [{"eps_in": torch.randn(i, 1, generator=gen), "eps_out": torch.randn(1, o, generator=gen)}
                for i, o in nets.layer_sizes(dqn_net)]}),
    ]
    for kind, params, policy, draws in cases:
        cards, decided = arena.seat_cards(RULES, kind, params, obs, hands, draws)
        theirs = _seat_actions(policy, params, 0.0, obs, hands.to(torch.int32), mask, SeatDraws(**draws))
        assert torch.equal(cards[decided], theirs.long()[decided]), kind
        assert decided.float().mean() > 0.9


def test_reinforce_update_equals_the_programs():
    from rl6nimmt_torch.agents.dqn import Adam
    from rl6nimmt_torch.nets import MLPSpec
    from rl6nimmt_torch.runtime.vector import RolloutRandomness, make_reinforce_train_step

    config = load_json(HERE / "configs" / "reinforce_h100.json")
    net, learner = config["net"], config["learner"]
    params = nets.make_weights(net, 8, "cpu")
    gen = torch.Generator().manual_seed(9)
    gumbel = -torch.log(-torch.log(torch.rand(10, G, 4, 10, generator=gen).clamp_(min=1e-38)))
    adam = Adam(learner["lr"], learner["b1"], learner["b2"], learner["eps"])
    step = make_reinforce_train_step(_port_cfg(), MLPSpec(48, (100, 100), (1,)), adam, G, device="cpu")
    new, state, metrics = step(params, adam.init(params), RolloutRandomness(gumbel=gumbel, deal_seed=derive(1, "d")))
    loss, grads, undecided = reinforce.loss_and_grads(RULES, learner, params, derive(1, "d"), gumbel, block=20)
    assert 0 <= undecided <= G
    ref, (m, _) = reinforce.adam(learner, params, grads, None, 1)
    assert abs(loss - float(metrics["loss"])) <= 1e-5 * abs(loss)
    for a, b in zip(reinforce.leaves(state.mu), reinforce.leaves(m)):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-7)
    # Adam's first step moves every element by lr times the sign of its
    # gradient: compare the elements whose gradient stands clear of round-off.
    # The leaves the reference's gradient does not move (the head's bias) are left out, as the check does.
    from benchmark.entries.reinforce_train import leaves_moved

    g_leaves = reinforce.leaves(grads)
    for a, b, g, moved in zip(reinforce.leaves(new), reinforce.leaves(ref), g_leaves, leaves_moved(g_leaves)):
        if not moved:
            continue
        clear = g.abs() > 1e-3 * g.abs().max()
        assert torch.allclose(a[clear], b[clear], rtol=1e-5, atol=2e-6)


def test_dqn_cycle_harvest_and_insert_equal_the_programs():
    from benchmark.entries import dqn_cycle as entry
    from benchmark.reference import dqn_cycle

    config = load_json(HERE / "configs" / "d3qn_h64.json")
    for mode in ("engine", "kernel_fm"):
        traffic = {**load_json(HERE / "traffic" / "selfplay_engine.json"), "games": 16, "capacity": 1000,
                   "mode": mode, "setup_steps": 2}
        cell = entry.build(config, traffic, 21, torch.device("cpu"))
        weights = nets.make_weights(config["net"], derive(21, "weights"), "cpu")
        _, draws = cell.randomness(0)
        rows, _ = dqn_cycle.harvest(RULES, weights, draws["turn_noise"], draws["deal_seed"], 16, 0.99, 10,
                                 seat_major=mode == "kernel_fm")
        cell.read(cell.step(0))
        n = 10 * 16 * 4
        stored = {k: v[..., :n] if mode == "kernel_fm" else v[:n] for k, v in cell.buf.storage.items()}
        as_rows = (lambda x: x.T) if mode == "kernel_fm" else (lambda x: x)
        assert torch.equal(as_rows(stored["state"]).float(), rows["state"]), mode
        assert torch.equal(as_rows(stored["next_state"]).float(), rows["next_state"]), mode
        assert torch.equal(stored["action"].long(), rows["action"]) and torch.equal(stored["done"].float(), rows["done"])
        assert torch.allclose(stored["reward"], rows["reward"], rtol=1e-6, atol=1e-6)


def test_dqn_cycle_entry_agrees_with_its_reference():
    from benchmark.entries import dqn_cycle as entry

    config = load_json(HERE / "configs" / "d3qn_h64.json")
    traffic = {**load_json(HERE / "traffic" / "selfplay_engine.json"), "games": 16, "capacity": 1000,
               "setup_steps": 2}
    cell = entry.build(config, traffic, 22, torch.device("cpu"))
    cell.warm_up()
    cell.release()
    checks, failed = cell.check()
    assert failed == 0 and all(v <= limit for v, limit in checks.values()), checks
