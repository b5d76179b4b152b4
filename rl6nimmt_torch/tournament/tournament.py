"""Population tournament with ELO tracking and evolutionary clone-and-cull
(port of ``tournament/tournament.py``).

Provides the same observable behavior as the reference ``Tournament``
(/root/reference/rl_6_nimmt/tournament.py:12-262):

* games pick a uniform random player count in [min_players, max_players] and
  a uniform random subset of active agents (tournament.py:166-177);
* scoring records per-agent scores, midrank tie positions, wins, and
  multi-player ELO with configurable K (tournament.py:140-164, 240-256);
* ``evolve`` ranks active agents by a metric (elo = last value; others =
  mean), clones top finishers ``copies[pos]`` times, culls past
  ``max_players`` / ``max_per_descendant`` (tournament.py:78-130);
* ``baseline_eval`` plays each agent against fixed baseline opponents every
  ``baseline_condition`` games (tournament.py:182-195);
* the ASCII results table matches the reference format (tournament.py:208-238).

The internal design differs deliberately: all per-agent state lives in one
:class:`PlayerRecord` (the reference keeps 11 parallel dicts keyed by name);
the legacy dict attributes (``elos``, ``played_games``, ...) remain available
as live views for compatibility.  Cloning is an in-memory pickle round trip
of the agent (params + optimizer moments + its generator's state,
``agents/base.py``), replacing the reference's ``torch.save("temp_model.pt")``
disk bounce.

Games run on ``device`` (default the card): ``play_game`` through a
:class:`~..runtime.session.GameSession`, ``play_block`` through the host
:class:`~..runtime.block.BlockSession`, ``play_device_block`` through
:class:`~..runtime.device_tournament.DeviceBlockSession`.  NumPy's global
generator is consumed in the JAX package's order, so one ``np.random.seed``
draws the same lineups on both.
"""

from __future__ import annotations

import logging
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..runtime.session import GameSession
from ..utils.device import resolve_device
from .elo import EloPlayer, calc_elo

logger = logging.getLogger(__name__)

# Midrank grouping half-width: scores closer than this tie (the reference's
# searchsorted-eps trick, tournament.py:240-256).  Game scores are integers,
# so 0.5 groups exact ties only; fractional baseline means inherit the same
# fuzzy grouping the reference has.
_TIE_EPS = 0.5


@dataclass
class PlayerRecord:
    """Everything the tournament knows about one seat name."""

    agent: Any
    descendant: str
    active: bool = True
    played_games: int = 0
    scores: List[float] = field(default_factory=list)
    positions: List[float] = field(default_factory=list)
    wins: List[float] = field(default_factory=list)
    baseline_scores: List[float] = field(default_factory=list)
    baseline_positions: List[float] = field(default_factory=list)
    baseline_wins: List[float] = field(default_factory=list)
    elos: List[float] = field(default_factory=list)

    def record_game(self, score: float, position: float, won: bool, elo: float) -> None:
        self.played_games += 1
        self.scores.append(score)
        self.positions.append(position)
        self.wins.append(1.0 if won else 0.0)
        self.elos.append(elo)

    def ranking_key(self, metric: str) -> float:
        """Sort key for :meth:`Tournament.evolve`; higher = keep/clone.

        elo ranks by the latest rating; the history metrics rank by their
        mean (reference tournament.py:79-104).  positions/wins are
        higher-is-better too, but the reference sorts them ascending --
        negate to preserve that quirk under one descending sort.
        """
        if metric == "elo":
            return self.elos[-1] if self.elos else 0.0
        series = {
            "tournament_scores": self.scores,
            "tournament_positions": self.positions,
            "tournament_wins": self.wins,
        }.get(metric)
        if series is None:
            raise NotImplementedError(metric)
        value = float(np.mean(series)) if series else 0.0
        return value if metric == "tournament_scores" else -value


class _RecordView:
    """Live read-through mapping ``name -> record.<attr>``.

    Keeps the reference-shaped attribute surface (``tournament.elos[name]``
    etc.) working on top of the record store; returned lists are the records'
    own, so in-place mutation reaches the record.
    """

    def __init__(self, records: Dict[str, PlayerRecord], attr: str):
        self._records = records
        self._attr = attr

    def __getitem__(self, name):
        return getattr(self._records[name], self._attr)

    def __contains__(self, name):
        return name in self._records

    def __iter__(self):
        return iter(self._records)

    def __len__(self):
        return len(self._records)

    def keys(self):
        return self._records.keys()

    def values(self):
        return [getattr(r, self._attr) for r in self._records.values()]

    def items(self):
        return [(n, getattr(r, self._attr)) for n, r in self._records.items()]


_VIEW_ATTRS = {
    "agents": "agent",
    "descendants": "descendant",
    "active": "active",
    "played_games": "played_games",
    "tournament_scores": "scores",
    "tournament_positions": "positions",
    "tournament_wins": "wins",
    "baseline_scores": "baseline_scores",
    "baseline_positions": "baseline_positions",
    "baseline_wins": "baseline_wins",
    "elos": "elos",
}


class Tournament:
    def __init__(
        self,
        min_players: int = 2,
        max_players: int = 4,
        baseline_agents: Optional[Sequence] = None,
        baseline_num_games: int = 1,
        baseline_condition: int = 10,
        elo_initial: float = 1600,
        elo_k: float = 32,
        device="cuda",
    ):
        assert 0 < min_players <= max_players
        self.device = resolve_device(device)
        self.min_players = min_players
        self.max_players = max_players
        self.baseline_agents = baseline_agents
        self.baseline_num_games = baseline_num_games
        self.baseline_condition = baseline_condition
        self.elo_initial = elo_initial
        self.elo_k = elo_k

        self.total_games = 0
        self.players: Dict[str, PlayerRecord] = {}

    def __getattr__(self, name):
        # Legacy per-agent dict attributes as live views over the records.
        attr = _VIEW_ATTRS.get(name)
        if attr is None or "players" not in self.__dict__:
            raise AttributeError(name)
        return _RecordView(self.__dict__["players"], attr)

    def __setstate__(self, state):
        # Load both current pickles and pre-record ones (11 parallel dicts).
        if "players" not in state and "agents" in state:
            records = {}
            for name, agent in state.pop("agents").items():
                records[name] = PlayerRecord(
                    agent=agent,
                    descendant=state["descendants"][name],
                    active=state["active"][name],
                    played_games=state["played_games"][name],
                    scores=state["tournament_scores"][name],
                    positions=state["tournament_positions"][name],
                    wins=state["tournament_wins"][name],
                    baseline_scores=state["baseline_scores"][name],
                    baseline_positions=state["baseline_positions"][name],
                    baseline_wins=state["baseline_wins"][name],
                    elos=state["elos"][name],
                )
            for legacy in _VIEW_ATTRS.values():
                state.pop(legacy, None)
            for legacy in list(_VIEW_ATTRS):
                state.pop(legacy, None)
            state["players"] = records
        state.setdefault("device", "cuda")
        self.__dict__.update(state)

    # ------------------------------------------------------------ population

    def add_player(self, name: str, agent) -> None:
        assert name not in self.players
        agent.__name__ = name
        self.players[name] = PlayerRecord(agent=agent, descendant=name)
        self.players[name].elos.append(self.elo_initial)

    def copy_player(self, old_name: str, new_name: str) -> None:
        # One pickle round trip clones agent AND stats (the reference
        # deepcopies 10 dict entries and torch.save/loads the module).
        clone = pickle.loads(pickle.dumps(self.players[old_name]))
        clone.agent.__name__ = new_name
        self.players[new_name] = clone

    def remove_player(self, name: str, full_delete: bool = False) -> None:
        if full_delete:
            del self.players[name]
        else:
            self.players[name].active = False

    def evolve(
        self,
        copies=(2,),
        max_players: Optional[int] = None,
        max_per_descendant: Optional[int] = 2,
        metric: str = "elo",
    ) -> None:
        ranked = sorted(
            self.active_agents(),
            key=lambda n: self.players[n].ranking_key(metric),
            reverse=True,
        )

        new_count = 0
        per_descendant: Dict[str, int] = {}
        for pos, name in enumerate(ranked):
            desc = self.players[name].descendant
            per_descendant.setdefault(desc, 0)

            if pos < len(copies):
                n_copies = copies[pos]
                logger.info(f"Copying player {name} into {n_copies} instances!")
            elif max_players is not None and new_count >= max_players:
                n_copies = 0
                logger.info(f"Removing player {name}")
            elif max_per_descendant is not None and per_descendant[desc] >= max_per_descendant:
                n_copies = 0
                logger.info(f"Removing player {name}")
            else:
                n_copies = 1

            for c in range(n_copies):
                self.copy_player(name, f"{name}_{c}")
            self.remove_player(name, full_delete=n_copies > 0)

            new_count += n_copies
            per_descendant[desc] += n_copies

    # ----------------------------------------------------------------- games

    def play_game(self, num_players: Optional[int] = None) -> None:
        agent_names, agents = self._choose_players(num_players)
        session = GameSession(*agents, device=self.device)
        session.play_game(render=False)
        self.score_game(agent_names, session.results[0])

    def play_block(self, n_games: int, num_players: Optional[int] = None) -> None:
        """Play ``n_games`` in lockstep with cross-game batched search acting.

        Lineup sampling and scoring are identical to ``n_games`` sequential
        :meth:`play_game` calls; games run through
        :class:`~..runtime.block.BlockSession`, which batches all
        search agents' playouts across games (orders of magnitude faster for
        search-heavy populations) and replays learning + ELO updates in game
        order at block end (the bounded-staleness deviation documented
        there).  ``play_block(1)`` reproduces sequential semantics exactly.
        """
        from ..runtime.block import BlockSession

        picks = [self._choose_players(num_players) for _ in range(n_games)]
        scores = BlockSession([agents for _, agents in picks], device=self.device).play()
        for (names, _), game_scores in zip(picks, scores):
            self.score_game(names, game_scores)

    def play_device_block(
        self,
        n_games: int,
        num_players: Optional[int] = None,
        bucket: Optional[int] = None,
        mesh=None,
        device_learning: bool = False,
        pipeline: bool = False,
    ) -> None:
        """Play ``n_games`` with eligible lineups as device blocks.

        Lineup sampling and scoring are identical to :meth:`play_block`;
        games whose every seat has a device decision -- the search families
        (random / MCS / PolicyMCS / PUCT) AND the single-forward learner
        families (the DQN lattice, ACER, both REINFORCE variants,
        PUCTCustomed), :func:`~..runtime.device_tournament.seat_slot` -- run
        as COMPLETE games in one :class:`~..runtime.device_tournament
        .DeviceBlockSession` per (env dims, search net, fast-path class)
        group: one K2 deal, then every turn the search seats' playouts and the
        learner seats' forwards on the device and one K1 resolution.  Every
        learner's updates replay host-side from the captured trajectories, or
        with ``device_learning=True`` those of the DQN, ACER and REINFORCE
        learners run on the device (:mod:`..runtime.device_learn`); a
        learner's games must then all be device games.
        Remaining games (Human seats, PUCT with temperature sampling or a
        ``batch_playouts`` other than the session's K) go through the host
        :class:`BlockSession`.  Parameter staleness is bounded by the block,
        as in :meth:`play_block` (PARITY.md deviations #10/#11/#12).

        ``bucket`` is accepted and has no effect: the JAX program padded the
        game axis to it so that one compile served every remainder, and here
        no compile exists to save, so only the real games are played
        (``PARITY_TORCH.md`` §14).  ``pipeline=True`` dispatches every group
        before finalizing any, so all seats act on block-start parameters.
        ``mesh`` (ROADMAP queue 1 item 11) is not ported yet and raises.
        """
        from ..runtime.block import BlockSession
        from ..runtime.device_tournament import (
            DeviceBlockSession,
            LearnerSlot,
            check_unported,
            lineup_fastclass,
            lineup_signature,
            seat_slot,
        )

        check_unported(mesh)
        # Learner slots are population-wide (not per-lineup), as in JAX:
        # culled-but-retained agents keep their slot, so a slot's index -- a
        # learner seat's kind -- is the same in every block.
        slots = set()
        for record in self.players.values():
            role = seat_slot(record.agent)
            if role is not None and role[0] == "learner":
                slots.add(role[1])
        slots = tuple(sorted(slots, key=LearnerSlot.sort_key))

        picks = [self._choose_players(num_players) for _ in range(n_games)]
        device_groups, host = {}, []
        for j, (names, agents) in enumerate(picks):
            # Group by env dims + search-net spec + the fast-path class, as JAX.
            sig = lineup_signature(agents)
            if sig is not None:
                key = sig[:2] + (lineup_fastclass(agents),)
                device_groups.setdefault(key, []).append((j, agents))
            else:
                host.append((j, agents))

        if device_learning:
            # A device-learned agent's replay buffer lives on the device; a
            # learner also learning through the host BlockSession would split
            # its training state, so every learner-holding lineup must be a
            # device lineup (true without Human / temperature-PUCT seats).
            for _, agents in host:
                assert not any(seat_slot(a) is not None and seat_slot(a)[0] == "learner" for a in agents), \
                    "device_learning: learner routed to a host lineup"

        scores = {}
        sessions = []
        for group in device_groups.values():
            session = DeviceBlockSession(
                [agents for _, agents in group], bucket=bucket, slots=slots, device_learning=device_learning,
                device=self.device,
            ).dispatch()
            if pipeline:
                sessions.append((group, session))
            else:
                for (j, _), game_scores in zip(group, session.finalize()):
                    scores[j] = game_scores
        for group, session in sessions:
            for (j, _), game_scores in zip(group, session.finalize()):
                scores[j] = game_scores
        if host:
            results = BlockSession([agents for _, agents in host], device=self.device).play()
            for (j, _), game_scores in zip(host, results):
                scores[j] = game_scores
        for j, (names, _) in enumerate(picks):
            self.score_game(names, scores[j])

    def score_game(self, agent_names, scores) -> None:
        scores = np.asarray(scores)
        relative_positions = self._compute_relative_positions(scores)
        winner = agent_names[int(np.argmax(scores))]
        new_elos = self._compute_elos(agent_names, scores)

        self.total_games += 1
        for name, score, rel_pos, elo in zip(agent_names, scores, relative_positions, new_elos):
            record = self.players[name]
            record.record_game(score, rel_pos, winner == name, elo)
            if record.played_games % self.baseline_condition == 0:
                self.baseline_eval(name)

    def _compute_elos(self, agent_names, scores):
        old = [self.players[name].elos[-1] for name in agent_names]
        places = self._compute_absolute_positions(np.asarray(scores))
        players = [EloPlayer(place=p, elo=e) for p, e in zip(places, old)]
        return calc_elo(players, self.elo_k)

    def _choose_players(self, num_players: Optional[int]):
        if num_players is None:
            # Clamp to the active population so a small roster doesn't crash
            # (the reference asserts instead, tournament.py:170).
            upper = min(self.max_players, len(self))
            num_players = int(np.random.choice(range(self.min_players, upper + 1)))
        assert len(self) >= num_players
        names = self.active_agents()
        idx = np.random.choice(len(names), size=num_players, replace=False)
        chosen = [names[i] for i in idx]
        return chosen, [self.players[n].agent for n in chosen]

    def active_agents(self):
        return [n for n, r in self.players.items() if r.active]

    def baseline_eval(self, agent_name: str) -> None:
        if self.baseline_agents is None:
            return
        record = self.players[agent_name]
        session = GameSession(record.agent, *self.baseline_agents, device=self.device)
        for _ in range(self.baseline_num_games):
            session.play_game(render=False)
        scores = np.mean(np.asarray(session.results), axis=0)
        relative_positions = self._compute_relative_positions(scores)
        record.baseline_scores.append(scores[0])
        record.baseline_positions.append(relative_positions[0])
        record.baseline_wins.append(float(np.argmax(scores) == 0))

    def winner(self):
        best, who = -float("inf"), None
        for record in self.players.values():
            mean_pos = np.mean(record.positions) if record.positions else -float("inf")
            if mean_pos > best:
                best, who = mean_pos, record.agent
        return who

    # ------------------------------------------------------------- reporting

    def __str__(self) -> str:
        hline = "-" * 65
        header = " Agent                | Games | Mean score | Win fraction |  ELO "
        lines = [f"Tournament after {self.total_games} games:", hline, header, hline]

        def row(name: str, r: PlayerRecord) -> str:
            score = f"{np.mean(r.scores):>5.2f}" if r.scores else "-"
            wins = f"{np.mean(r.wins):>5.2f}" if r.wins else "-"
            return (
                f" {name:>20s} | {r.played_games:>5} | {score:>10} "
                f"| {wins:>12} | {r.elos[-1]:>4.0f} "
            )

        # Active roster first, then the culled, as in the reference table.
        for want_active in (True, False):
            block = [row(n, r) for n, r in self.players.items() if r.active == want_active]
            if block:
                lines += block
                lines.append(hline)
        if lines[-1] != hline:
            lines.append(hline)
        return "\n".join(lines)

    __repr__ = __str__

    def __len__(self) -> int:
        return len(self.active_agents())

    # ------------------------------------------------------------- positions

    @staticmethod
    def _compute_absolute_positions(scores: np.ndarray) -> np.ndarray:
        """Midranked places for ELO, best-first (reference tournament.py:240-247).

        Effectively 1-based with (l+r)/2 midranks; only the ordering feeds
        ELO.  Each score's place is where it lands in the descending sort,
        with scores within ``_TIE_EPS`` sharing the midrank of their group.
        """
        by_desc = np.sort(-scores)
        lo = np.searchsorted(by_desc, -scores - _TIE_EPS)
        hi = np.searchsorted(by_desc, -scores + _TIE_EPS)
        return 0.5 * (lo + hi + 1.0)

    @staticmethod
    def _compute_relative_positions(scores: np.ndarray) -> np.ndarray:
        """Midranked positions rescaled to [0, 1], 1 = best (tournament.py:249-256)."""
        by_asc = np.sort(scores)
        lo = np.searchsorted(by_asc, scores - _TIE_EPS)
        hi = np.searchsorted(by_asc, scores + _TIE_EPS)
        midrank = 0.5 * (lo + hi + 1.0)
        return (midrank - 1) / (len(scores) - 1)
