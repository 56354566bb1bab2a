"""Continuous-batching scheduler: the traffic tier over ``ModelRunner``
(counterpart of ``repro.serving.scheduler``).

Where ``ServingEngine`` runs a FIFO slot loop, this scheduler treats every
decode tick as a scheduling decision:

  * **admit/evict at every tick** — waiting requests are admitted
    earliest-deadline-first (FIFO by rid among equals, so a deadline-free
    workload schedules exactly like the engine) into any free slot whose
    block budget fits; expired requests are evicted mid-flight;
  * **per-request deadlines** — ``submit(deadline=K)`` gives a request K
    ticks; a request still unfinished when the clock passes its absolute
    deadline is evicted with ``expired=True`` and its blocks returned;
  * **block-granular memory** — admission and per-tick growth are charged
    against ``serving.kvcache.BlockKVCache``; when the pool runs dry the
    latest-deadline active request is preempted (swapped out exactly, its
    blocks freed, re-queued) rather than the whole tick stalling;
  * **streaming** — ``submit(on_token=cb)`` (or a scheduler-wide
    ``stream=`` default) fires per generated token, as the token is sampled,
    not when the request completes.

Time is the tick counter — one decode step per tick — so every latency in
ticks is deterministic: no wall clock enters the scheduler, and a fixed
(seed, arrival schedule) replays identically.

The runner is driven only through ``check_prompt`` / ``admit_slot`` /
``decode`` / ``sample``: a decode tick is the runner's captured
``DecodeGraph`` replay (the pool's leaves never move — admission and page-in
write them in place — so one capture serves the whole run), an admission is
the runner's prefill: its bucket's captured ``PrefillGraph`` replay for an
attention model, an eager prefill for a recurrent one.

Exactness: with ample blocks, no deadlines and the same admission order,
``step()`` makes exactly the decisions ``ServingEngine.step()`` makes —
admit-then-decode, same slot assignment, same sampling stream — so the
generated tokens are the engine's.  On a crossbar chip a request's tokens
depend on what shares its ticks (one input scale over the pool's rows), so
under preemption or eviction the tokens are held to a replay of the same run,
and digitally to the undisturbed engine's.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import ModelRunner, Request
from repro_torch.serving.kvcache import BlockCacheConfig, BlockKVCache


def _deadline_key(req: Request):
    # EDF with FIFO tiebreak: no deadline sorts last (schedules like the
    # plain engine among themselves), earlier rid first among equals
    return (req.deadline if req.deadline is not None else float("inf"), req.rid)


class ContinuousBatchingScheduler:
    """Admit/evict-every-tick scheduler over one ``ModelRunner``; the block
    pool's cache lives on the runner's device."""

    def __init__(
        self,
        runner: ModelRunner,
        max_batch: int = 4,
        block: Optional[BlockCacheConfig] = None,
        stream: Optional[Callable[[Request, int], None]] = None,
        rid_start: int = 0,
    ):
        self.runner = runner
        self.max_batch = max_batch
        self.kv = BlockKVCache(runner.cfg, max_batch, runner.max_seq, block=block, device=runner.device)
        self.stream = stream
        self.tick = 0
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)
        self.last_tok = np.zeros(max_batch, np.int32)
        self.waiting: List[Request] = []
        self.completed: Dict[int, Request] = {}
        self.expired: Dict[int, Request] = {}
        self._rid = itertools.count(rid_start)

    # ------------------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        deadline: Optional[int] = None,
        on_token: Optional[Callable[[Request, int], None]] = None,
        truncate: bool = False,
    ) -> int:
        """Queue a request.  ``deadline`` is in ticks from now; the request
        is evicted (``expired=True``) if still unfinished after that many
        decode ticks.  ``on_token`` streams tokens as they are sampled."""
        prompt = np.asarray(prompt)
        S = self.runner.check_prompt(prompt, truncate)
        # admission control against livelock: a request whose worst-case
        # footprint exceeds the whole pool would thrash forever (preempted
        # and resumed without ever reaching max_new_tokens) — refuse it up
        # front instead
        worst = self.kv.blocks_for(min(self.runner.max_seq, S + max_new_tokens))
        if worst > self.kv.n_blocks:
            raise ValueError(
                f"request needs up to {worst} blocks "
                f"({S} prompt + {max_new_tokens} new tokens, block_size="
                f"{self.kv.block_size}) but the pool only has "
                f"{self.kv.n_blocks}: it could never run to completion"
            )
        req = Request(
            next(self._rid), prompt, max_new_tokens, eos_id,
            truncate=truncate,
            deadline=None if deadline is None else self.tick + int(deadline),
            on_token=on_token if on_token is not None else self.stream,
            arrival=self.tick,
        )
        self.waiting.append(req)
        return req.rid

    # ------------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def load(self) -> int:
        return self.n_active + len(self.waiting)

    def _finish(self, req: Request, *, expired: bool) -> None:
        req.done = True
        req.expired = expired
        req.finish = self.tick + 1
        self.kv.release(req.rid)
        (self.expired if expired else self.completed)[req.rid] = req

    def _expire(self) -> None:
        """Evict anything whose deadline has passed — active or waiting."""
        for i, req in enumerate(self.slots):
            if req is not None and req.deadline is not None and self.tick >= req.deadline:
                self._finish(req, expired=True)
                self.slots[i] = None
        still = []
        for req in self.waiting:
            if req.deadline is not None and self.tick >= req.deadline:
                self._finish(req, expired=True)
            else:
                still.append(req)
        self.waiting = still

    def _stream_tok(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.on_token is not None:
            req.on_token(req, tok)

    def _admit(self) -> None:
        """EDF admission into free slots, charged against the block pool.

        A candidate that does not fit the pool is skipped (no head-of-line
        blocking); a previously preempted request resumes from its paged
        blocks without re-prefilling.
        """
        if not self.waiting:
            return
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            order = sorted(self.waiting, key=_deadline_key)
            chosen = None
            for req in order:
                if self.kv.is_paged(req.rid):
                    need = self.kv.paged_pos(req.rid)
                else:
                    need = self.runner.check_prompt(req.prompt, req.truncate)
                if self.kv.can_admit(need):
                    chosen = req
                    break
            if chosen is None:
                return  # pool dry for every candidate; decode drains it
            self.waiting.remove(chosen)
            if self.kv.is_paged(chosen.rid):
                p, lt = self.kv.page_in(chosen.rid, slot)
                self.pos[slot] = p
                self.last_tok[slot] = lt
            else:
                S = self.runner.check_prompt(chosen.prompt, chosen.truncate)
                self.kv.allocate(chosen.rid, S)
                self.kv.cache, p, lt, first = self.runner.admit_slot(
                    self.kv.cache, slot, chosen
                )
                self.pos[slot] = p
                self.last_tok[slot] = lt
                if first is not None:
                    self._stream_tok(chosen, first)
            self.slots[slot] = chosen

    def _preempt(self, slot: int) -> None:
        """Swap a victim out exactly (freeing its blocks) and re-queue it."""
        req = self.slots[slot]
        self.kv.page_out(req.rid, slot, int(self.pos[slot]), int(self.last_tok[slot]))
        self.slots[slot] = None
        self.waiting.append(req)

    def _ensure_blocks(self) -> None:
        """Charge this tick's cache growth; preempt latest-deadline victims
        when the pool runs dry (they resume exactly later)."""
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None:
                continue
            # the decode below writes position pos[i]: the table must cover
            # pos[i] + 1 tokens
            while not self.kv.ensure(req.rid, int(self.pos[i]) + 1):
                victims = [
                    j for j in range(self.max_batch)
                    if self.slots[j] is not None and j != i
                ]
                if not victims:
                    # nothing left to steal from: preempt the request
                    # itself; it resumes when blocks free up
                    self._preempt(i)
                    break
                victim = max(victims, key=lambda j: _deadline_key(self.slots[j]))
                self._preempt(victim)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One scheduling tick: expire, admit, budget, decode, sample.

        Returns the number of slots advanced this tick."""
        self._expire()
        self._admit()
        self._ensure_blocks()
        active = [i for i in range(self.max_batch) if self.slots[i] is not None]
        if not active:
            self.tick += 1
            return 0
        logits, self.kv.cache = self.runner.decode(self.last_tok, self.pos, self.kv.cache)
        nxt = self.runner.sample(logits)
        for i in active:
            req = self.slots[i]
            self.pos[i] += 1
            tok = int(nxt[i])
            self._stream_tok(req, tok)
            self.last_tok[i] = tok
            if (
                len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or self.pos[i] >= self.runner.max_seq - 1
            ):
                self._finish(req, expired=False)
                self.slots[i] = None
        self.tick += 1
        return len(active)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drain the queue; returns completed + expired sorted by rid."""
        for _ in range(max_ticks):
            if not self.waiting and self.n_active == 0:
                break
            self.step()
        out = dict(self.completed)
        out.update(self.expired)
        for s in self.slots:
            if s is not None:
                out[s.rid] = s
        return sorted(out.values(), key=lambda r: r.rid)
