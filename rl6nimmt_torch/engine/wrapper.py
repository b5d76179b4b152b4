"""Host-side, gym-flavored wrapper around the batched engine (port of ``engine/wrapper.py``).

The same surface as the reference ``SechsNimmtEnv`` (env.py:13-77):
``reset() -> (states, legal_actions)``, ``reset_with_deck(deck)``,
``reset_to(board, hands)``, ``step(actions) -> ((states, legal_actions),
rewards, done, info)``, ``render()``.  It holds one game as a batch of one:
a ``reset`` is one K2 launch at G=1 (``engine.deal``) and a ``step`` one K1
launch (``engine.step``) on the card, the plain twins on the CPU.  The
interactive and heterogeneous-agent paths (``GameSession``, ``Human``) use it;
batched training goes through the engine directly.

Seeding: ``seed(seed)`` seeds a CPU ``torch.Generator`` from which every
``reset`` draws the 62-bit Philox seed of its deal.  The JAX wrapper split a
threefry key instead, which cannot be replayed (``PARITY_TORCH.md`` §1), so a
seed deals other games than JAX's; ``reset_with_deck`` deals JAX's decks.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .cards import format_card
from .env import InvalidMoveException, deal, init_from_deck, is_done, observe, step
from .state import EnvConfig, EnvState

logger = logging.getLogger(__name__)


class Discrete:
    """Minimal stand-in for ``gym.spaces.Discrete`` (no gym dependency)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    """Minimal stand-in for ``gym.spaces.Box`` (no gym dependency)."""

    def __init__(self, low: float, high: float, shape, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.low = np.full(self.shape, low, dtype)
        self.high = np.full(self.shape, high, dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low) and np.all(x <= self.high))

    def __repr__(self):
        return f"Box({self.low.flat[0]}, {self.high.flat[0]}, {self.shape})"


class SechsNimmtEnv:
    """Single-game 6 nimmt! environment on the port's engine."""

    def __init__(
        self,
        num_players: int,
        num_rows: int = 4,
        num_cards: int = 104,
        threshold: int = 6,
        include_summaries: bool = True,
        player_names: Optional[Sequence[str]] = None,
        verbose: bool = True,
        seed: Optional[int] = None,
        device="cuda",
    ):
        self.config = EnvConfig(num_players=num_players, num_rows=num_rows, num_cards=num_cards,
                                threshold=threshold, include_summaries=include_summaries)
        self.device = resolve_device(device)
        self._player_names = list(player_names) if player_names is not None else None
        self.verbose = verbose
        self.seed(np.random.randint(0, 2**31 - 1) if seed is None else seed)
        self._state: Optional[EnvState] = None

        # Reference-compatible metadata (env.py:34-39); the Box bounds describe
        # the normalized state, raw observations are not clipped to them.
        self.num_actions = self.config.num_actions
        self.state_length = self.config.state_length
        self.reward_range = (-float("inf"), 0)
        self.action_space = Discrete(self.config.num_actions)
        self.observation_space = Box(-1.0, 2.0, (self.config.state_length,))

    # ------------------------------------------------------------------- API

    def seed(self, seed: int) -> None:
        self._deal_seeds = torch.Generator().manual_seed(int(seed))

    def reset(self):
        deal_seed = int(torch.randint(0, 2**62, (1,), generator=self._deal_seeds))
        self._state = deal(self.config, deal_seed, 1, device=self.device)
        return self._states_tuple()

    def reset_with_deck(self, deck: Sequence[int]):
        """Deal deterministically from an explicit deck (parity mode)."""
        decks = torch.as_tensor(np.asarray(deck, dtype=np.int32)[None], device=self.device)
        self._state = init_from_deck(self.config, decks)
        return self._states_tuple()

    def reset_to(self, board: Sequence[Sequence[int]], hands: Sequence[Sequence[int]]):
        """Re-enter an arbitrary mid-game position (reference env.py:53-62)."""
        cfg = self.config
        b = np.full((1, cfg.num_rows, cfg.threshold), -1, dtype=np.int32)
        row_len = np.zeros((1, cfg.num_rows), dtype=np.int32)
        for r, cards in enumerate(board):
            b[0, r, : len(cards)] = cards
            row_len[0, r] = len(cards)
        hand_mask = np.zeros((1, cfg.num_players, cfg.num_cards), dtype=bool)
        hands_sorted = np.full((1, cfg.num_players, cfg.hand_size), -1, dtype=np.int32)
        for p, cards in enumerate(hands):
            hand_mask[0, p, list(cards)] = True
            hands_sorted[0, p, : len(cards)] = sorted(cards)
        put = lambda x: torch.from_numpy(x).to(self.device)
        self._state = EnvState(board=put(b), row_len=put(row_len), hands=put(hand_mask),
                               hands_sorted=put(hands_sorted),
                               scores=put(np.zeros((1, cfg.num_players), np.int32)),
                               turn=put(np.zeros((1,), np.int32)))
        return self._states_tuple()

    def step(self, actions: Sequence[int]):
        assert self._state is not None, "call reset() first"
        assert len(actions) == self.config.num_players
        hands = self._state.hands[0].cpu().numpy()
        for p, card in enumerate(actions):
            if not (0 <= card < self.config.num_cards) or not hands[p, card]:
                held = sorted(np.flatnonzero(hands[p]).tolist())
                # The reference's message verbatim (env.py:117): 1-based played
                # card, raw 0-based hand list.
                raise InvalidMoveException(
                    f"Player {p + 1} tried to play card {card + 1}, but their hand is {held}"
                )
        acts = torch.tensor([list(actions)], dtype=torch.int32, device=self.device)
        self._state, rewards = step(self.config, self._state, acts)
        return self._states_tuple(), rewards[0].cpu().numpy(), self.done, {}

    # ------------------------------------------------------------ inspection

    @property
    def scores(self) -> np.ndarray:
        return self._state.scores[0].cpu().numpy()

    @property
    def board(self) -> List[List[int]]:
        b, lens = self._state.board[0].cpu().numpy(), self._state.row_len[0].cpu().numpy()
        return [b[r, : lens[r]].tolist() for r in range(self.config.num_rows)]

    @property
    def hands(self) -> List[List[int]]:
        h = self._state.hands[0].cpu().numpy()
        return [sorted(np.flatnonzero(h[p]).tolist()) for p in range(self.config.num_players)]

    @property
    def done(self) -> bool:
        return bool(is_done(self._state)[0])

    def render(self, mode: str = "human") -> None:
        """Log the board, hands and scores (reference env.py:79-97)."""
        cfg = self.config
        logger.info("-" * 120)
        logger.info("Board:")
        for cards in self.board:
            line = "  " + " ".join(format_card(c) for c in cards)
            line += "   _ " * (cfg.threshold - len(cards) - 1) + "   * "
            logger.info(line)
        logger.info("Players:")
        for p, (score, hand) in enumerate(zip(self.scores, self.hands)):
            cards = "no cards " if not hand else "cards " + " ".join(format_card(c) for c in hand)
            logger.info(f"  {self._player_name(p)}: {score:>3d} Hornochsen, {cards}")
        if self.done:
            winner, loser = int(np.argmin(self.scores)), int(np.argmax(self.scores))
            logger.info(
                f"The game is over! {self._player_name(winner)} wins, "
                f"{self._player_name(loser)} loses. Congratulations!"
            )
        logger.info("-" * 120)

    # --------------------------------------------------------------- helpers

    def _states_tuple(self):
        obs, _ = observe(self.config, self._state)
        obs = obs[0].cpu().numpy()
        hands = self._state.hands_sorted[0].cpu().numpy()
        states = [obs[p] for p in range(self.config.num_players)]
        legal = [[int(c) for c in hand if c >= 0] for hand in hands]
        return states, legal

    def _player_name(self, player: int) -> str:
        if self._player_names is None:
            return f"Player {player + 1:d}"
        width = max(len(n) for n in self._player_names)
        return f"{self._player_names[player]:<{width}} (player {player + 1:d})"
