"""The compiled decode tick: one slot pool's ``decode_step`` captured as one
CUDA graph and replayed every tick (counterpart of the reference's
``jax.jit(decode_step)`` in ``repro.serving.engine.ModelRunner``).

``DecodeGraph`` holds the tick's static buffers: the token and position
inputs (one ``(2, B)`` int64 device tensor, filled each tick by one copy from
a pinned host buffer), the pool's cache (its leaves are written in place by
the blocks) and, after capture, the logits output.  It is built for one
cache, keyed on the data pointers of its leaves.

Building it runs the tick once on a clone of the cache (the warm-up: the
kernels' first-call work — library load, occupancy queries, the TMA encoder
lookup, cuBLAS workspaces — happens there, and the live recurrent state
and attention cache are left as they are), then captures the tick against
the live cache under the runner's crossbar mode.  Capture does not execute,
so every tick, the first included, is a replay.  A failed capture raises;
nothing falls back to an eager tick.

On a CPU runner there are no CUDA graphs: the same buffers and the same
warm-up on a clone are used, and each tick runs eagerly.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.device import programmed as prog_mod
from repro_torch.kernels import crossbar_vmm as kvmm
from repro_torch.kernels import slstm_scan as kscan
from repro_torch.models import model as model_lib

# every kernel wrapper's counters and the planned datapaths' call counter,
# in one order
_COUNTERS = (kvmm.LAUNCHES, kvmm.PLAIN_CALLS, kscan.LAUNCHES, kscan.PLAIN_CALLS, prog_mod.PLANNED_CALLS)


def _read_counters() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


def _restore_counters(snapshot: List[Dict[str, int]]) -> None:
    for counter, saved in zip(_COUNTERS, snapshot):
        counter.update(saved)


def credit_launches(captured: List[Dict[str, int]]) -> None:
    """Add one replay's kernel launches to the wrappers' counters (and its
    planned divide-and-conquer calls to ``PLANNED_CALLS``).

    A wrapper counts a launch when its Python body runs.  For a captured
    tick that happens once, at capture, where nothing is launched; a replay
    launches the recorded kernels without running any Python.  So the counts
    a capture recorded (``DecodeGraph.captured``) are taken back after the
    capture and added here once for every replay."""
    for counter, delta in zip(_COUNTERS, captured):
        for k, n in delta.items():
            counter[k] += n


def named_leaves(tree) -> Iterator[Tuple[str, object]]:
    """(joined path, leaf) of a cache-shaped tree — a list of stages of
    ``{b<i>: {leaf name: x}}`` — in a fixed order (stage, block, leaf name);
    the path is the reference's joined pytree path (``"0/b0/k"``)."""
    for si, stage in enumerate(tree):
        for b, entry in stage.items():
            for n, x in entry.items():
                yield f"{si}/{b}/{n}", x


def cache_leaves(cache) -> List[torch.Tensor]:
    """The cache's tensors in ``named_leaves`` order."""
    return [t for _, t in named_leaves(cache)]


def cache_key(cache) -> Tuple:
    """What a captured graph is bound to: each leaf's address, shape, dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in cache_leaves(cache))


def clone_cache(cache):
    return [{b: {n: t.clone() for n, t in entry.items()} for b, entry in stage.items()} for stage in cache]


class DecodeGraph:
    """One slot pool's decode tick, built on its first call and run every
    tick (a graph replay on the card, an eager tick on the CPU).

    ``captured``: the wrappers' counter deltas of one tick (None until
    built); ``replays``: graph replays run; ``capture_seconds``: warm-up
    plus capture (on the CPU the warm-up alone)."""

    def __init__(self, runner, cache):
        # weak: the runner holds this graph, and a strong reference back would
        # keep both, the programmed chip included, alive after the runner is
        # dropped, until the cycle collector happens to run
        self._runner = weakref.ref(runner)
        self.cache = cache  # held: the graph writes into these addresses
        self.key = cache_key(cache)
        batch = cache_leaves(cache)[0].shape[1]  # leaves are (repeats, B, ...)
        dev = runner.device
        self._cuda = dev.type == "cuda"
        self._host_in = torch.zeros((2, batch), dtype=torch.int64, pin_memory=self._cuda)
        self._dev_in = torch.zeros((2, batch), dtype=torch.int64, device=dev)
        self.toks = self._dev_in[0].unsqueeze(1)  # (B, 1)
        self.pos = self._dev_in[1]  # (B,)
        self.graph = None
        self.logits = None
        self.captured = None
        self.replays = 0
        self.capture_seconds = None

    def serves(self, cache) -> bool:
        return cache_key(cache) == self.key

    def _tick(self, cache) -> torch.Tensor:
        r = self._runner()
        logits, _ = r._with_crossbar(
            lambda: model_lib.decode_step(r.params, r.cfg, self.toks, self.pos, cache)
        )
        return logits

    def _build(self) -> None:
        """Warm up on a clone of the cache, then capture against the live one.
        The warm-up's and the capture's counts are taken back: neither is a
        served tick (the capture's counts are credited per replay)."""
        t0 = time.perf_counter()
        before = _read_counters()
        try:
            scratch = clone_cache(self.cache)
            if not self._cuda:
                self._tick(scratch)
                self.captured = [{} for _ in _COUNTERS]
                return
            dev = self._runner().device
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._tick(scratch)
            torch.cuda.synchronize(dev)
            del scratch
            warm = _read_counters()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=stream):
                    logits = self._tick(self.cache)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the decode tick of a {self.pos.shape[0]}-slot pool failed "
                    f"(the tick has no eager fallback): {e}"
                ) from e
            self.captured = [
                {k: a[k] - w[k] for k in a if a[k] != w[k]} for w, a in zip(warm, _read_counters())
            ]
            self.graph, self.logits = graph, logits
        finally:
            _restore_counters(before)
            self.capture_seconds = time.perf_counter() - t0

    def run(self, last_tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One tick over the whole pool: ``last_tok`` and ``pos`` are (B,)
        host arrays; returns host float32 logits (B, V), the tick's one
        device synchronisation."""
        host = self._host_in.numpy()
        host[0] = last_tok
        host[1] = pos
        self._dev_in.copy_(self._host_in, non_blocking=self._cuda)
        if self.captured is None:
            self._build()
        if self.graph is None:
            logits = self._tick(self.cache)
        else:
            self.graph.replay()
            credit_launches(self.captured)
            self.replays += 1
            logits = self.logits
        return logits.to(torch.float32).cpu().numpy()
