"""A whole device block of the port against the JAX package's.

Dealt from JAX's keys and played on the noise JAX draws (rebuilt in its split
order as a ``BlockNoise``), the port's block equals JAX's
``make_device_block_fn`` trajectory -- observations, hands, picks, rewards,
scores and final observations exact, log-probs and ACER's vectors within
``PARITY_TORCH.md`` section 7 -- for a lineup of random, uniform-playout
search and learner seats, at K = 8 and at K = 32 (``PARITY_TORCH.md``
section 14 (c): K stays configurable).
"""

import jax
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
import rl6nimmt_tpu.runtime.device_tournament as jdt
from rl6nimmt_tpu.engine.env import deal as jdeal
from rl6nimmt_tpu.engine.state import EnvConfig as JEnvConfig
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.engine import EnvState
from rl6nimmt_torch.nets import params_from_jax
from rl6nimmt_torch.runtime import device_tournament as tdt
from torch_jax_noise import learner_noise, search_noise

H = 10
HID = (16,)


def _jnp(tree):
    return jax.tree.map(np.asarray, tree)



def _pair(jagent, tcls, **kwargs):
    """The port's counterpart of a JAX agent, with its converted weights."""
    tagent = tcls(device="cpu", **kwargs)
    if getattr(jagent, "params", None) is not None:
        tagent.params = params_from_jax(_jnp(jagent.params), "cpu")
    return tagent


def _block_lineups(K, mc_max, games):
    """Games of P=3 from random, MCS, decoupled PUCT and every learner family."""
    s = dict(mc_max=mc_max, mc_per_card=10)
    j = {
        "random": jag.DrunkHamster(seed=1), "mcs": jag.MCSAgent(seed=2, **s),
        "pu": jag.PUCTUniformAgent(seed=3, hidden_sizes=HID, **s),
        "noisy": jag.Noisy_D3QN(seed=4, hidden_sizes=HID), "eps": jag.DQNVanilla(seed=5, hidden_sizes=HID),
        "acer": jag.BatchedACERAgent(seed=6, hidden_sizes=HID), "rai": jag.BatchedReinforceAgent(seed=7, hidden_sizes=HID),
        "rmask": jag.MaskedReinforceAgent(seed=8, hidden_sizes=HID), "pv": jag.PUCTCustomedAgent(seed=9, hidden_sizes=HID),
    }
    t = {
        "random": _pair(j["random"], tag.DrunkHamster, seed=1), "mcs": _pair(j["mcs"], tag.MCSAgent, seed=2, **s),
        "pu": _pair(j["pu"], tag.PUCTUniformAgent, seed=3, hidden_sizes=HID, batch_playouts=K, **s),
        "noisy": _pair(j["noisy"], tag.Noisy_D3QN, seed=4, hidden_sizes=HID),
        "eps": _pair(j["eps"], tag.DQNVanilla, seed=5, hidden_sizes=HID),
        "acer": _pair(j["acer"], tag.BatchedACERAgent, seed=6, hidden_sizes=HID),
        "rai": _pair(j["rai"], tag.BatchedReinforceAgent, seed=7, hidden_sizes=HID),
        "rmask": _pair(j["rmask"], tag.MaskedReinforceAgent, seed=8, hidden_sizes=HID),
        "pv": _pair(j["pv"], tag.PUCTCustomedAgent, seed=9, hidden_sizes=HID),
    }
    j["eps"].eps = t["eps"].eps = 0.5
    return [[j[n] for n in g] for g in games], [[t[n] for n in g] for g in games]


EVERY_FAMILY = [("random", "mcs", "noisy"), ("pu", "acer", "rai"), ("rmask", "pv", "eps"), ("mcs", "pu", "random")]
SEARCH_AND_DQN = [("random", "mcs", "pu"), ("pu", "noisy", "mcs")]


# K = 32 at mc_max 40 runs two rounds where n! * 10 >= 40 (at mc_max <= 32 one
# round would be all, VERDICT r5 weak #3); its lineup keeps the JAX compile short.
@pytest.mark.parametrize("K,mc_max,games", [(8, 16, EVERY_FAMILY), (32, 40, SEARCH_AND_DQN)], ids=["K8", "K32"])
def test_block_equals_jax(K, mc_max, games):
    jl, tl = _block_lineups(K, mc_max, games)
    G, P = len(jl), 3
    np.random.seed(5)
    jsess = jdt.DeviceBlockSession(jl, batch=K).dispatch()
    np.random.seed(5)
    seed = np.random.randint(0, 2**31 - 1)
    jscores, jtraj, jfinal = (jax.tree.map(np.asarray, jsess._block[k]) for k in ("scores", "traj", "final_obs"))

    tsess = tdt.DeviceBlockSession(tl, batch=K, device="cpu")
    inputs = tsess.assemble()
    assert (inputs.K, inputs.mc_ceiling, inputs.puct_free) == (K, 1 << (mc_max - 1).bit_length(), False)
    assert [s.family for s in tsess.slots] == [s.family for s in jsess.slots]
    # JAX's block key: the deal, then per turn split(k_dec, (G, P)) seat keys.
    key = jax.random.key(seed)
    key, k_deal = jax.random.split(key)
    js = jax.vmap(lambda k: jdeal(JEnvConfig(P), k))(jax.random.split(k_deal, G))
    state = EnvState(*(torch.from_numpy(np.array(getattr(js, f))) for f in ("board", "row_len", "hands", "hands_sorted", "scores", "turn")))
    fact = [1, 1, 2, 6, 24, 120, 720, 5040, 40320, 362880, 3628800]
    searching = (inputs.kinds > 0) & (inputs.kinds < tdt.KIND_LEARNER_BASE)
    turns = []
    for t in range(H):
        key, k_dec = jax.random.split(key)
        seat_keys = jax.random.split(k_dec, (G, P)).reshape(-1)
        n = H - t
        n_mc = np.where(searching, np.minimum(inputs.mc_maxes, inputs.mc_pers * fact[n]), 0).reshape(-1)
        rounds = [-(-int(m) // K) for m in n_mc]
        turns.append(tdt.TurnNoise(search_noise(seat_keys, rounds, K, n, P),
                                   learner_noise(seat_keys, G, P, jsess.slots, tsess.slots)))
    noise = tdt.BlockNoise(deal_seed=0, turns=turns)
    scores, traj, final = tsess.block_fn(inputs)(inputs.params, inputs.lparams, inputs.kinds, inputs.mc_maxes,
                                                 inputs.mc_pers, inputs.c_pucts, inputs.epses, noise, state=state)
    for k in ("obs", "hands", "picks", "rewards"):
        np.testing.assert_array_equal(traj[k].numpy(), jtraj[k], err_msg=k)
    np.testing.assert_array_equal(scores.numpy(), jscores)
    np.testing.assert_array_equal(final.numpy(), jfinal)
    for k in ("logps", "logp_vecs"):
        np.testing.assert_allclose(traj[k].numpy(), jtraj[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert len({int(k) for k in inputs.kinds.reshape(-1)}) == len({n for g in games for n in g})
