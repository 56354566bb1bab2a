"""Chip-farm router: N programmed replicas behind one submit() (counterpart
of ``repro.serving.farm``).

Every replica is a full ``ServingEngine`` restored from the *same* artifact
store (``restore_artifacts=``), serving what the chip that was saved serves.
This module adds the routing layer:

  * **policies** — ``round_robin`` (rotating cursor over undrained
    replicas) and ``least_loaded`` (fewest active + queued requests, lowest
    index tiebreak); both deterministic;
  * **disjoint rid spaces** — replica ``i`` allocates rids from
    ``i * RID_STRIDE``, so farm-wide results merge without collisions and
    ``replica_of(rid)`` recovers the placement;
  * **lifecycle-aware draining** — ``drain(i)`` takes a replica out of
    admission while its in-flight requests finish (``step()`` keeps
    advancing it); with the lifecycle verbs (``health``, per-replica
    ``refresh`` / ``hot_swap``, ``farm.replicas[i].age``) an aged replica is
    refreshed without dropping traffic: drain -> wait idle -> refresh ->
    undrain, while the other replicas keep admitting.  A swap goes through
    that replica's ``ModelRunner._rebind``: it drops that replica's captured
    tick and prefills and no other's.

The farm is a pure fan-out: replicas share no state (their decode ticks run
one after the other on one card, each its own graph replay), so farm
throughput in ticks scales with replica count, and a single-replica farm
serves the tokens of a bare engine.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving.engine import Request, ServingEngine

# rid space per replica; no request stream should plausibly exceed this
RID_STRIDE = 1_000_000

POLICIES = ("round_robin", "least_loaded")


class ChipFarm:
    """Route one request stream across N ``ServingEngine`` replicas, each on
    ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        n_replicas: int = 2,
        policy: str = "round_robin",
        max_batch: int = 4,
        max_seq: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
        crossbar: Optional[CrossbarMode] = None,
        restore_artifacts: Optional[str] = None,
        verify_coverage: bool = True,
        device="cuda",
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}: pick one of {POLICIES}")
        self.policy = policy
        # every replica restores the *same* programmed chip from the one
        # store (or programs / serves digital when no store is given), so
        # routing does not change what any request generates
        self.replicas: List[ServingEngine] = [
            ServingEngine(
                cfg,
                params,
                max_batch=max_batch,
                max_seq=max_seq,
                temperature=temperature,
                seed=seed,
                crossbar=crossbar,
                restore_artifacts=restore_artifacts,
                verify_coverage=verify_coverage,
                rid_start=i * RID_STRIDE,
                device=device,
            )
            for i in range(n_replicas)
        ]
        self._draining: set = set()
        self._rr = 0

    # -- routing -------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def load(self, i: int) -> int:
        """Queued + in-flight request count of replica ``i``."""
        eng = self.replicas[i]
        return len(eng.pending) + sum(1 for s in eng.slots if s is not None)

    def _route(self) -> int:
        open_ = [i for i in range(self.n_replicas) if i not in self._draining]
        if not open_:
            raise ValueError(
                "every replica is draining: undrain one before submitting"
            )
        if self.policy == "least_loaded":
            return min(open_, key=lambda i: (self.load(i), i))
        # round_robin: next undrained replica at or after the cursor
        for k in range(self.n_replicas):
            i = (self._rr + k) % self.n_replicas
            if i in open_:
                self._rr = (i + 1) % self.n_replicas
                return i
        raise AssertionError("unreachable")  # open_ is non-empty

    def submit(
        self,
        prompt,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        truncate: bool = False,
        on_token: Optional[Callable[[Request, int], None]] = None,
    ) -> int:
        """Route one request to a replica by the farm's policy; the rid
        encodes the placement (``replica_of``)."""
        i = self._route()
        return self.replicas[i].submit(
            prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            truncate=truncate,
            on_token=on_token,
        )

    def replica_of(self, rid: int) -> int:
        return rid // RID_STRIDE

    # -- serving -------------------------------------------------------
    def step(self) -> int:
        """Advance every replica one decode tick (draining replicas keep
        finishing their in-flight work — drain never drops traffic).
        Returns total slots advanced across the farm."""
        return sum(eng.step() for eng in self.replicas)

    def is_idle(self, i: int) -> bool:
        eng = self.replicas[i]
        return not eng.pending and all(s is None for s in eng.slots)

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        """Drain every replica; merged results sorted by rid."""
        for _ in range(max_ticks):
            if all(self.is_idle(i) for i in range(self.n_replicas)):
                break
            self.step()
        out: List[Request] = []
        for eng in self.replicas:
            out.extend(eng.run_until_done(max_ticks=0))
        return sorted(out, key=lambda r: r.rid)

    # -- lifecycle -----------------------------------------------------
    def drain(self, i: int) -> None:
        """Stop routing new requests to replica ``i``; in-flight requests
        keep serving to completion."""
        self.replicas[i]  # index check
        self._draining.add(i)

    def undrain(self, i: int) -> None:
        self._draining.discard(i)

    @property
    def draining(self) -> frozenset:
        return frozenset(self._draining)

    def refresh(self, i: int, directory: Optional[str] = None) -> Optional[str]:
        """Refresh replica ``i``'s chip (see ``ModelRunner.refresh``);
        typically called on a drained, idle replica, but a swap is safe
        mid-flight too."""
        return self.replicas[i].refresh(directory)

    def hot_swap(self, i: int, directory: str, slot: Optional[str] = None) -> None:
        self.replicas[i].hot_swap(directory, slot=slot)

    def uptimes(self) -> List[float]:
        return [eng.uptime_s for eng in self.replicas]

    def health(self, n_probes: Optional[int] = None, seed: int = 0,
               budget: Optional[float] = None) -> List[object]:
        """Per-replica ``HealthReport`` (see ``ModelRunner.health_check``)."""
        return [
            eng.health_check(n_probes=n_probes, seed=seed, budget=budget)
            for eng in self.replicas
        ]
