"""Device-side learner updates for the device-block tournament (port of
``runtime/device_learn.py``).

:class:`.device_tournament.DeviceBlockSession` captures whole trajectories on
the device; without this module every learner's ``learn`` replays them on the
host, one eager call per seat and turn, each with its own round trip (the loss
fetched with ``float``, PER's errors copied back, minibatches built in NumPy
and copied over, a sum tree on the host).  With ``device_learning=True`` the
session routes the learner streams here instead, keeping the host replay's
semantics:

1. A host **planner** walks the block in the replay's (game, turn, seat) order
   and does only the bookkeeping: the n-step sums in the host's float64
   (``DQNAgent._store``), the buffer's size and pointer as host ints,
   ``agent.step`` and ``agent.eps``, and every ``np.random`` draw the host
   ``learn`` would make, in the same order (``HostHistory.sample``'s
   ``np.random.choice``, ``HostPriorityBuffer.sample``'s
   ``np.random.random(n)``, ACER's off-policy minibatch).  The result is an
   event list: store rows and learn events with their sample indices or PER
   uniforms.
2. A **replay** function per family walks that list on the device: buffer
   writes at the ring pointer, minibatch gathers, PER's stratified draw, IS
   weights and priority write-back, and the agents' own update functions
   (``agents.dqn.make_learn_step``, ``agents.acer.make_acer_train_step``,
   ``agents.reinforce.reinforce_loss`` under the functional ``Adam``).  A noisy
   DQN draws each update's ``learn_noise`` from the agent's own generator in
   event order, one draw an update, as the host does.  Nothing in the loop
   reads a device value back: the plan goes over in one pinned, non-blocking
   copy a field, ptr and size stay host ints, and the virgin-buffer priority
   ``where(max(pri) > 0, max(pri), 1)`` is computed on the device.
3. The replay buffer lives on the device across blocks on
   ``agent._device_replay`` (DQN: storage, ptr, size, priorities, beta; ACER:
   the sequence ring and its lengths).  It pickles with the agent, so
   ``clone`` carries it.

Parity (``tests/test_torch_device_learn.py``): on one device the device
replay gives the host replay's parameter trajectory -- bit for bit for
ring-buffer DQNs and both REINFORCE variants (the same minibatch indices from
the shared ``np.random`` stream, the same noise, the same update math); PER
keeps its priorities, cumulative sum, uniforms and IS weights in float64 as
the host's sum tree does (JAX: float32), so a stratified draw lands in the
host's slot and only the summation order differs; ACER agrees on its first
update and stays close over a block.  ``PARITY_TORCH.md`` section 15 lists
what differs from the JAX module: no key chains, no shape buckets
(``hint_games`` is accepted and unused), host ints for ptr and size, Python
loops in place of ``lax.scan``, float64 PER bookkeeping.

Reference behaviour preserved end to end: dqn.py:87-141 (store and minibatch
update a step), replay_buffer.py:122-203 (PER priorities, IS weights, beta
anneal), actor_critic.py:145-207 (flush cadence, one on-policy and one
off-policy update), policy.py:79-101 (episode REINFORCE).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..agents.acer import BatchedACERAgent, make_acer_train_step
from ..agents.dqn import DQNAgent, DQNConfig, grad_leaves, learn_noise, make_learn_step, optimizer_step
from ..agents.reinforce import (
    BatchedReinforceAgent,
    MaskedReinforceAgent,
    action_in_input_logits,
    masked_policy_logits,
    reinforce_loss,
)
from ..buffers.host import ABS_ERROR_UPPER, ALPHA, BETA0, BETA_INCREMENT, EPSILON
from ..buffers.per import last_occurrence
from ..buffers.ring import circular_write
from ..nets import MLPSpec

# HostHistory grows without bound when history_length is None; a device
# buffer needs a fixed capacity.  The two agree until the size reaches it.
DEFAULT_DEVICE_CAPACITY = 100_000
DEFAULT_SEQ_CAPACITY = 8_192

EV_NOOP, EV_STORE, EV_LEARN = 0, 1, 2

DEVICE_LEARN_FAMILIES = ("dqn", "acer", "rai", "rmask")


def _upload(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays on ``device``: one copy each, pinned and non-blocking on a card
    (a pageable copy may wait for the card's queue)."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def _store_runs(events: List[Tuple[int, int]]):
    """``events`` with each run of consecutive stores merged: ``(EV_STORE,
    first, count)`` and ``(EV_LEARN, sel, 1)``.  A run's rows are consecutive
    in the plan, and every store of a run gets the priority its first one gets
    (it writes the current maximum, which then stays the maximum)."""
    runs = []
    for kind, sel in events:
        if kind == EV_STORE and runs and runs[-1][0] == EV_STORE and runs[-1][1] + runs[-1][2] == sel:
            runs[-1] = (EV_STORE, runs[-1][1], runs[-1][2] + 1)
        elif kind != EV_NOOP:
            runs.append((kind, sel, 1))
    return runs


def _ring_copy(buf: torch.Tensor, items: torch.Tensor, ptr: int) -> None:
    """``items`` into ``buf`` at ``ptr`` along the leading axis, wrapping, in
    place: one slice copy when the rows do not wrap."""
    if ptr + items.shape[0] <= buf.shape[0]:
        buf[ptr:ptr + items.shape[0]].copy_(items)
    else:
        circular_write(buf, items, ptr)


def _write_rows(storage: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], first: int, n: int,
                ptr: int, cap: int) -> Tuple[int, int, int]:
    """Write plan rows ``first .. first + n`` at the ring pointer, in place; a run
    longer than the ring keeps its last ``cap`` rows.  Returns ``(start, count,
    ptr')``: where the rows went and the advanced pointer."""
    end_ptr = (ptr + n) % cap
    if n > cap:
        ptr, first, n = (ptr + n - cap) % cap, first + n - cap, cap
    for k, buf in storage.items():
        _ring_copy(buf, rows[k][first:first + n], ptr)
    return ptr, n, end_ptr


# =============================================================== DQN replay


def make_dqn_replay_fn(cfg: DQNConfig, spec: MLPSpec, optimizer, gamma: float, capacity: int):
    """Event-stream replay for one DQN agent (JAX's jitted scan).

    ``replay(params, target, opt_state, storage, ptr, size, pri, plan) ->
    (params, target, opt_state, storage, ptr, size, pri)``: ``storage`` and
    ``pri`` are written in place, ``ptr`` and ``size`` are host ints.  ``plan``
    holds the planner's event list and its tensors (see :meth:`DQNPlanner.dispatch`).
    Each learn event is the agent's own ``make_learn_step``.
    """
    learn_step = make_learn_step(cfg, spec, optimizer, gamma)
    mb, cap = cfg.minibatch, capacity

    def replay(params, target, opt_state, storage, ptr, size, pri, plan):
        dev = pri.device
        if cfg.per and plan["samples"] is not None:
            # each learn's stratum offsets k + u_k, for all learns at once
            strata = torch.arange(mb, dtype=torch.float64, device=dev) + plan["samples"]
        for kind, sel, n in _store_runs(plan["events"]):
            if kind == EV_STORE:
                # Host store: the current max priority, 1.0 in a virgin buffer.
                mp = pri.max()
                new_p = torch.where(mp > 0, mp, 1.0)
                start, count, ptr = _write_rows(storage, plan["stores"], sel, n, ptr, cap)
                _ring_copy(pri, new_p.expand(count), start)
                size = min(size + n, cap)
                continue
            if cfg.per:
                total = pri.sum()
                u = strata[sel] * (total / mb)
                idx = torch.searchsorted(torch.cumsum(pri, 0), u).clamp_(0, size - 1)
                probs = pri[idx] / total
                # the live slots are the first ``size`` ones (the ring fills from 0)
                min_prob = pri[:size].min() / total
                weights = torch.pow(probs / min_prob, -plan["betas"][sel]).to(torch.float32)
            else:
                idx = plan["samples"][sel]
                weights = torch.ones(mb, dtype=torch.float32, device=dev)
            batch = {k: v[idx] for k, v in storage.items()}
            batch["weights"] = weights
            noise = learn_noise(cfg, spec, plan["generator"]) if cfg.noisy else None
            params, target, opt_state, _, abs_err, _ = learn_step(params, target, opt_state, batch,
                                                                  plan["do_soft"][sel], noise)
            if cfg.per:
                # batch_update: min(|err| + eps, 1) ** alpha; a slot drawn twice
                # keeps its last write (PARITY_TORCH.md section 5).
                new_p = torch.pow(torch.clamp(abs_err.double() + EPSILON, max=ABS_ERROR_UPPER), ALPHA)
                pri[idx] = new_p[last_occurrence(idx)]
        return params, target, opt_state, storage, ptr, size, pri

    return replay


class DQNPlanner:
    """Host bookkeeping and device replay of one DQN agent's block stream."""

    FIELDS = ("state", "action", "reward", "next_state", "done")

    def __init__(self, agent: DQNAgent, hint_games: int = 0):
        if agent.summary_writer is not None:
            raise ValueError("a DQN with a summary_writer needs the host replay")
        self.agent = agent
        self.cfg = agent.cfg
        self.gamma = agent.gamma
        self._ensure_state()
        self._nbuf: List[dict] = []
        self.stores: List[dict] = []
        self.events: List[Tuple[int, int]] = []
        # per learn event: PER's uniforms or the uniform sample's indices, beta, soft update
        self.samples: List[np.ndarray] = []
        self.betas: List[float] = []
        self.do_soft: List[bool] = []
        # host mirrors advanced while planning, installed by finalize()
        self._size = int(agent._device_replay["size"])
        self._beta = float(agent._device_replay["beta"])
        self._pending = None

    # -------------------------------------------------------------- state

    def _ensure_state(self) -> None:
        """The agent's device buffer, created on first use; an existing host
        history migrates into it, oldest row first (a full PER ring from its
        pointer on, with its priorities and beta)."""
        agent = self.agent
        if getattr(agent, "_device_replay", None) is not None:
            return
        cap = int(agent.history_length or DEFAULT_DEVICE_CAPACITY)
        S, dev = agent.state_length, agent.device
        storage = {
            "state": torch.zeros((cap, S), dtype=torch.float32, device=dev),
            "action": torch.zeros((cap,), dtype=torch.int32, device=dev),
            "reward": torch.zeros((cap,), dtype=torch.float32, device=dev),
            "next_state": torch.zeros((cap, S), dtype=torch.float32, device=dev),
            "done": torch.zeros((cap,), dtype=torch.float32, device=dev),
        }
        ptr, size = 0, 0
        pri = np.zeros(cap, np.float64)
        beta = BETA0
        hist = agent.history
        records = getattr(hist, "_records", None)
        if records is not None and len(hist) > 0:
            if hasattr(hist, "priorities"):  # HostPriorityBuffer
                n = len(hist)
                order = [(hist._ptr + i) % hist.capacity for i in range(n)] if n == hist.capacity else list(range(n))
                rows = [records[i] for i in order]
                pri[:n] = hist.priorities[order]
                beta = float(hist.beta)
            else:
                full = hist.max_length is not None and len(hist) == hist.max_length
                rows = (list(records[hist._ptr:]) + list(records[:hist._ptr])) if full else list(records)
                rows = rows[-cap:]
            n = min(len(rows), cap)
            for k, buf in storage.items():
                buf[:n] = torch.as_tensor(np.stack([np.asarray(r[k]) for r in rows[:n]])).to(dev, buf.dtype)
            ptr, size = n % cap, n
        agent._device_replay = {"storage": storage, "ptr": ptr, "size": size,
                                "pri": torch.from_numpy(pri).to(dev), "beta": beta}

    def _cap(self) -> int:
        return self.agent._device_replay["pri"].shape[0]

    # --------------------------------------------------------------- steps

    def on_step(self, state, reward, action, next_state, done) -> None:
        """``DQNAgent.learn`` without the math (dqn.py:260-317)."""
        agent, cfg = self.agent, self.cfg
        agent.step += 1
        agent.eps = agent.eps_func(0)  # fresh-session parity: num_episode=0

        exp = {
            "state": np.asarray(state, np.float32),
            "reward": float(reward),
            "action": int(action),
            "next_state": np.asarray(next_state, np.float32),
            "done": bool(done),
        }
        if cfg.n_steps <= 1:
            self._push(exp)
        else:
            self._nbuf.append(exp)
            if len(self._nbuf) >= cfg.n_steps:
                R = sum(self._nbuf[i]["reward"] * (self.gamma ** i) for i in range(cfg.n_steps))
                head = self._nbuf.pop(0)
                head["reward"] = R
                head["next_state"] = exp["next_state"]
                self._push(head)

        if self._size > cfg.minibatch and agent.training:
            if cfg.per:
                self._beta = min(1.0, self._beta + BETA_INCREMENT)
                self.samples.append(np.random.random(cfg.minibatch))
                self.betas.append(self._beta)
            else:
                self.samples.append(np.random.choice(self._size, size=cfg.minibatch, replace=False))
            self.do_soft.append((agent.step % cfg.retrain_interval) == 0)
            self.events.append((EV_LEARN, len(self.do_soft) - 1))

        if done and self._nbuf:
            # Tail flush with done=True (dqn.py:288-301).
            last = self._nbuf[-1]
            while self._nbuf:
                R = sum(self._nbuf[i]["reward"] * (self.gamma ** i) for i in range(len(self._nbuf)))
                head = self._nbuf.pop(0)
                head["reward"] = R
                head["next_state"] = last["next_state"]
                head["done"] = True
                self._push(head)

    def _push(self, exp: dict) -> None:
        self.stores.append(exp)
        self.events.append((EV_STORE, len(self.stores) - 1))
        self._size = min(self._size + 1, self._cap())

    # ------------------------------------------------------------- execute

    def execute(self) -> None:
        handles = self.dispatch()
        if handles is not None:
            self.finalize(handles)

    def dispatch(self):
        """Upload the plan and run the replay; returns the results
        :meth:`finalize` installs (None when the agent saw no event).  Nothing
        here waits for the card."""
        agent, cfg = self.agent, self.cfg
        st = agent._device_replay
        if not self.events:
            return None
        dev = st["pri"].device
        arrays = {}
        if self.stores:
            arrays.update({
                "state": np.stack([e["state"] for e in self.stores]),
                "action": np.asarray([e["action"] for e in self.stores], np.int32),
                "reward": np.asarray([e["reward"] for e in self.stores], np.float32),
                "next_state": np.stack([e["next_state"] for e in self.stores]),
                "done": np.asarray([e["done"] for e in self.stores], np.float32),
            })
        if self.samples:
            arrays["samples"] = np.stack(self.samples)
        up = _upload(arrays, dev)
        plan = {
            "events": self.events,
            "stores": {k: up[k] for k in self.FIELDS if k in up},
            "samples": up.get("samples"),
            "betas": self.betas,
            "do_soft": self.do_soft,
            "generator": agent.generator,
        }
        fn = make_dqn_replay_fn(cfg, agent.spec, agent.optimizer, self.gamma, self._cap())
        params, target, opt_state, storage, ptr, size, pri = fn(
            agent.params, agent.target_params, agent.opt_state, st["storage"], int(st["ptr"]), int(st["size"]),
            st["pri"], plan)
        self._pending = (storage, pri)
        return params, target if cfg.double else None, opt_state, ptr, size

    def finalize(self, fetched) -> None:
        agent, cfg = self.agent, self.cfg
        storage, pri = self._pending
        self._pending = None
        params, target, opt_state, ptr, size = fetched
        agent.params = params
        if cfg.double:
            agent.target_params = target
        agent.opt_state = opt_state
        agent._device_replay = {"storage": storage, "ptr": ptr, "size": size, "pri": pri, "beta": self._beta}


# ========================================================= REINFORCE replay


def make_reinforce_replay_fn(spec: MLPSpec, optimizer, gamma: float, actor_weight: float, entropy_weight: float,
                             masked: bool):
    """Sequential episode updates for one REINFORCE agent.

    ``replay(params, opt_state, batches) -> (params, opt_state)``: one update
    an episode, in block order (params move between episodes, policy.py:79-101),
    the host agent's ``_train_step`` on each.
    """
    if masked:
        logits_fn = lambda p, b: masked_policy_logits(spec, p, b["state"], b["legal_mask"])
    else:
        logits_fn = lambda p, b: action_in_input_logits(spec, p, b["state"], b["legal_cards"])

    def replay(params, opt_state, batches):
        for batch in batches:
            leaves, live = grad_leaves(params)
            loss, _ = reinforce_loss(logits_fn, live, batch, gamma, actor_weight, entropy_weight)
            params, opt_state = optimizer_step(optimizer, params, opt_state, loss, leaves)
        return params, opt_state

    return replay


class ReinforcePlanner:
    """Episode collection and device replay of one REINFORCE agent's block stream."""

    def __init__(self, agent, hint_games: int = 0):
        self.agent = agent
        self.masked = isinstance(agent, MaskedReinforceAgent)
        self._episode: List[dict] = list(getattr(agent, "_episode", []))
        self.batches: List[dict] = []

    def on_step(self, step_record: dict, reward, episode_end: bool) -> None:
        agent = self.agent
        self._episode.append({**step_record, "reward": np.float32(reward * agent.r_factor)})
        if not episode_end:
            return
        if agent.training:
            self.batches.append({k: np.stack([rec[k] for rec in self._episode]) for k in self._episode[0]})
        self._episode = []

    def execute(self) -> None:
        handles = self.dispatch()
        if handles is not None:
            self.finalize(handles)

    def dispatch(self):
        """Upload every episode at once and run the updates (see :meth:`DQNPlanner.dispatch`)."""
        agent = self.agent
        agent._episode = list(self._episode)
        if not self.batches:
            return None
        lengths = [len(b["reward"]) for b in self.batches]
        ends = np.cumsum(lengths)
        up = _upload({k: np.concatenate([b[k] for b in self.batches]) for k in self.batches[0]}, agent.device)
        # Each episode as a tensor of its own, as the host replay builds it.
        batches = [{k: v[e - n:e].clone() for k, v in up.items()} for n, e in zip(lengths, ends)]
        fn = make_reinforce_replay_fn(agent.spec, agent.optimizer, agent.gamma, agent.actor_weight,
                                      agent.entropy_weight, self.masked)
        return fn(agent.params, agent.opt_state, batches)

    def finalize(self, fetched) -> None:
        self.agent.params, self.agent.opt_state = fetched


# ============================================================== ACER replay


def make_acer_replay_fn(spec: MLPSpec, optimizer, gamma: float, truncate: float, actor_weight: float,
                        critic_weight: float, capacity: int):
    """Event-stream replay for one ACER agent.

    Events store a flushed sequence in the device sequence ring, or run the
    reference's train pair: one on-policy update on the latest sequence and
    one off-policy update on a uniform minibatch (actor_critic.py:173-177)
    whose indices the planner drew from the shared ``np.random`` stream.
    ``replay(params, opt_state, storage, lengths, ptr, size, plan) ->
    (params, opt_state, storage, lengths, ptr, size)``.
    """
    train = make_acer_train_step(spec, optimizer, gamma, truncate, actor_weight, critic_weight)
    cap = capacity

    def replay(params, opt_state, storage, lengths, ptr, size, plan):
        ring = dict(storage, length=lengths)
        for kind, sel, n in _store_runs(plan["events"]):
            if kind == EV_STORE:
                _, _, ptr = _write_rows(ring, plan["seqs"], sel, n, ptr, cap)
                size = min(size + n, cap)
                continue
            fresh = plan["fresh"][sel]
            # The latest sequence as a tensor of its own, as the host builds it.
            on_batch = {k: v[fresh:fresh + 1].clone() for k, v in ring.items()}
            params, opt_state, _ = train(params, opt_state, on_batch)
            idx = plan["off_idx"][sel]
            params, opt_state, _ = train(params, opt_state, {k: v[idx] for k, v in ring.items()})
        return params, opt_state, storage, lengths, ptr, size

    return replay


class ACERPlanner:
    """Host bookkeeping and device replay of one ACER agent's block stream."""

    FIELDS = ("state", "legal_cards", "log_probs", "action_id", "reward", "done")

    def __init__(self, agent: BatchedACERAgent, hint_games: int = 0):
        self.agent = agent
        self._ensure_state()
        self.seqs: List[dict] = []
        self.seq_lens: List[int] = []
        self.events: List[Tuple[int, int]] = []
        self.fresh: List[int] = []
        self.off_idx: List[np.ndarray] = []
        self._cur: List[dict] = []
        self._size = int(agent._device_replay["size"])
        self._ptr = int(agent._device_replay["ptr"])
        self._pending = None

    def _ensure_state(self) -> None:
        """The agent's device sequence ring, created on first use; existing host
        sequences migrate into it, oldest first, padded as ``_padded_batch`` pads."""
        agent = self.agent
        if getattr(agent, "_device_replay", None) is not None:
            return
        cap = int(agent.history_length or DEFAULT_SEQ_CAPACITY)
        T, S, H, dev = agent.rollout_len, agent.state_length, agent.max_num_actions, agent.device
        storage = {
            "state": torch.zeros((cap, T, S), dtype=torch.float32, device=dev),
            "legal_cards": torch.zeros((cap, T, H), dtype=torch.int32, device=dev),
            "log_probs": torch.zeros((cap, T, H), dtype=torch.float32, device=dev),
            "action_id": torch.zeros((cap, T), dtype=torch.int32, device=dev),
            "reward": torch.zeros((cap, T), dtype=torch.float32, device=dev),
            "done": torch.zeros((cap, T), dtype=torch.float32, device=dev),
        }
        lengths = torch.zeros((cap,), dtype=torch.int32, device=dev)
        ptr, size = 0, 0
        hist = agent.history
        if len(hist) > 0:
            full = hist.max_length is not None and len(hist) == hist.max_length
            records = ((list(hist._records[hist._ptr:]) + list(hist._records[:hist._ptr])) if full
                       else list(hist._records))[-cap:]
            batch = agent._padded_batch({k: [r[k] for r in records] for k in records[0]})
            n = len(records)
            for k, buf in storage.items():
                buf[:n] = torch.from_numpy(np.asarray(batch[k])).to(dev, buf.dtype)
            lengths[:n] = torch.from_numpy(batch["length"]).to(dev)
            ptr, size = n % cap, n
        agent._device_replay = {"storage": storage, "lengths": lengths, "ptr": ptr, "size": size}

    def on_step(self, state, legal_cards, log_probs, action_id, next_reward, done, episode_end) -> None:
        """``BatchedACERAgent.learn`` without the math (actor_critic.py:136-155)."""
        agent = self.agent
        self._cur.append({
            "state": np.asarray(state, np.float32),
            "legal_cards": np.asarray(legal_cards, np.int32),
            "log_probs": np.asarray(log_probs, np.float32),
            "action_id": np.int32(action_id),
            "reward": np.float32(next_reward * agent.r_factor),
            "done": np.float32(done),
        })
        if len(self._cur) >= agent.rollout_len or done or episode_end:
            self._flush()
            if self._size > max(agent.warmup, agent.batchsize) and agent.training:
                self.fresh.append((self._ptr - 1) % self._cap())
                self.off_idx.append(np.random.choice(self._size, size=agent.batchsize, replace=False))
                self.events.append((EV_LEARN, len(self.fresh) - 1))

    def _cap(self) -> int:
        return self.agent._device_replay["lengths"].shape[0]

    def _flush(self) -> None:
        T = self.agent.rollout_len
        length = len(self._cur)
        seq = {}
        for k in self.FIELDS:
            v = np.stack([np.asarray(step[k]) for step in self._cur])
            if length < T:
                v = np.concatenate([v, np.zeros((T - length,) + v.shape[1:], v.dtype)])
            seq[k] = v
        self.seqs.append(seq)
        self.seq_lens.append(length)
        self.events.append((EV_STORE, len(self.seqs) - 1))
        cap = self._cap()
        self._ptr = (self._ptr + 1) % cap
        self._size = min(self._size + 1, cap)
        self._cur = []

    def execute(self) -> None:
        handles = self.dispatch()
        if handles is not None:
            self.finalize(handles)

    def dispatch(self):
        """Upload the plan and run the replay (see :meth:`DQNPlanner.dispatch`)."""
        agent = self.agent
        st = agent._device_replay
        if not self.events:
            return None
        assert not self._cur, "device-block episodes always flush at done"
        arrays = {k: np.stack([s[k] for s in self.seqs]) for k in self.FIELDS} if self.seqs else {}
        if self.seqs:
            arrays["length"] = np.asarray(self.seq_lens, np.int32)
        if self.off_idx:
            arrays["off_idx"] = np.stack(self.off_idx).astype(np.int64)
        up = _upload(arrays, st["lengths"].device)
        plan = {
            "events": self.events,
            "seqs": {k: v for k, v in up.items() if k != "off_idx"},
            "fresh": self.fresh,
            "off_idx": up.get("off_idx"),
        }
        fn = make_acer_replay_fn(agent.spec, agent.optimizer, agent.gamma, agent.truncate, agent.actor_weight,
                                 agent.critic_weight, self._cap())
        params, opt_state, storage, lengths, ptr, size = fn(
            agent.params, agent.opt_state, st["storage"], st["lengths"], int(st["ptr"]), int(st["size"]), plan)
        self._pending = (storage, lengths)
        return params, opt_state, ptr, size

    def finalize(self, fetched) -> None:
        agent = self.agent
        storage, lengths = self._pending
        self._pending = None
        agent.params, agent.opt_state, ptr, size = fetched
        agent._device_replay = {"storage": storage, "lengths": lengths, "ptr": ptr, "size": size}


# ============================================================== dispatcher


def make_planner(agent, hint_games: int = 0):
    """The planner of a device-learnable agent; None only for a DQN with a
    ``summary_writer`` (its TensorBoard hooks read host values), which keeps
    the host replay as in JAX.  ``hint_games`` is JAX's shape-bucket floor and
    has no effect here.  Any other agent raises: a learner stream never falls
    back to the host replay in silence."""
    if isinstance(agent, DQNAgent):
        if agent.summary_writer is not None:
            return None
        return DQNPlanner(agent, hint_games)
    if isinstance(agent, BatchedACERAgent):
        return ACERPlanner(agent, hint_games)
    if isinstance(agent, (MaskedReinforceAgent, BatchedReinforceAgent)):
        return ReinforcePlanner(agent, hint_games)
    raise TypeError(f"{type(agent).__name__} has no device learner (families {DEVICE_LEARN_FAMILIES})")
