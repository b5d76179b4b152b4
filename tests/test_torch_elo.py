"""The port's multi-player ELO against the JAX package's and the scalar oracle.

``rl6nimmt_torch/tournament/elo.py`` is the port's own copy of the NumPy
module; on randomized fields (2-8 players, midranked ties from the port's
tournament, K from 4 to 64) it must equal JAX's ``calc_elo`` and the
independent scalar transcription ``tests/vendor/multi_elo_reference.py`` to
1e-12, as ``tests/test_elo_golden.py`` holds JAX's.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from rl6nimmt_tpu.tournament import EloPlayer as JEloPlayer
from rl6nimmt_tpu.tournament import calc_elo as jcalc_elo
from rl6nimmt_tpu.tournament.tournament import Tournament as JTournament
from rl6nimmt_torch.tournament import EloPlayer, Tournament, calc_elo

_spec = importlib.util.spec_from_file_location(
    "multi_elo_reference", pathlib.Path(__file__).parent / "vendor" / "multi_elo_reference.py")
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_calc_elo_equals_jax_and_the_oracle(seed, n):
    rng = np.random.RandomState(100 * n + seed)
    for trial in range(20):
        k = float(rng.choice([4, 8, 16, 32, 64]))
        elos = rng.uniform(1200, 2000, n)
        scores = rng.randint(-30, 0, n).astype(np.float64)
        if trial % 3 == 0 and n > 2:
            scores[1] = scores[0]  # ties, regularly
        places = Tournament._compute_absolute_positions(scores)
        np.testing.assert_array_equal(places, JTournament._compute_absolute_positions(scores))
        ours = calc_elo([EloPlayer(place=p, elo=e) for p, e in zip(places, elos)], k)
        jax_side = jcalc_elo([JEloPlayer(place=p, elo=e) for p, e in zip(places, elos)], k)
        theirs = oracle.calc_elo([oracle.EloPlayer(place=p, elo=e) for p, e in zip(places, elos)], k)
        assert ours.dtype == np.float64
        np.testing.assert_allclose(ours, np.asarray(jax_side), rtol=1e-12, atol=0)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-12, atol=0)
        np.testing.assert_allclose(ours.sum(), elos.sum(), rtol=1e-12)   # zero-sum


def test_degenerate_fields():
    assert list(calc_elo([EloPlayer(place=1, elo=1700)], 32)) == [1700]
    np.testing.assert_allclose(calc_elo([EloPlayer(place=1.5, elo=1600) for _ in range(4)], 32), [1600] * 4)


def test_relative_positions_equal_jax():
    rng = np.random.RandomState(3)
    for n in range(2, 9):
        for _ in range(10):
            scores = rng.randint(-8, 0, n).astype(np.float64)
            np.testing.assert_array_equal(Tournament._compute_relative_positions(scores),
                                          JTournament._compute_relative_positions(scores))
