"""The compiled decode tick and the compiled prefill: one slot pool's
``decode_step`` captured as one CUDA graph and replayed every tick
(counterpart of the reference's ``jax.jit(decode_step)`` in
``repro.serving.engine.ModelRunner``), and one prefill graph per bucket
(counterpart of its per-bucket ``jax.jit`` prefill, ``_prefill_fn``).

``DecodeGraph`` holds the tick's static buffers: the token and position
inputs (one ``(2, B)`` int64 device tensor, filled each tick by one copy from
a pinned host buffer), the pool's cache (its leaves are written in place by
the blocks) and, after capture, the logits output.  It is built for one
cache, keyed on the data pointers of its leaves.

``PrefillGraph`` holds one bucket's logits output; its static inputs,
``PrefillBuffers``, are one per runner and shared by every bucket: a
``(1, max_seq)`` int64 token buffer (a bucket reads its first ``bucket``
columns, filled before each replay by one copy from a pinned host buffer)
and one one-slot cache, zeroed at the start of every prefill (inside the
graph), so no prompt's keys and values outlive it.

Building either runs it once on a clone of its cache (the warm-up: the
kernels' first-call work — library load, occupancy queries, the TMA encoder
lookup, cuBLAS workspaces — happens there, and the live recurrent state
and attention cache are left as they are), then captures it against the
live cache under the runner's crossbar mode, each graph in a memory pool of
its own.  Capture does not execute, so every run, the first included, is a
replay.  A failed capture raises; nothing falls back to an eager run.

On a CPU runner there are no CUDA graphs: the same buffers and the same
warm-up on a clone are used, and each run is eager.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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


def capture(
    device: torch.device, run: Callable[[object], torch.Tensor], cache, what: str
) -> Tuple[Optional["torch.cuda.CUDAGraph"], Optional[torch.Tensor], List[Dict[str, int]], Optional[int]]:
    """Warm ``run`` up on a clone of ``cache``, then capture ``run(cache)`` as
    one CUDA graph in a memory pool of its own.  Returns ``(graph, output,
    captured, pool_bytes)``: ``captured`` the wrappers' counter deltas of one
    run, ``pool_bytes`` what the graph's pool reserved.  The warm-up's and the
    capture's counts are taken back (neither is a served run; the capture's
    are credited per replay).  On the CPU only the warm-up runs:
    ``(None, None, no counts, None)``.  A failed capture raises, naming
    ``what``."""
    before = _read_counters()
    try:
        scratch = clone_cache(cache)
        if device.type != "cuda":
            run(scratch)
            return None, None, [{} for _ in _COUNTERS], None
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            run(scratch)
        torch.cuda.synchronize(device)
        del scratch
        warm = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            # entering the capture synchronises and empties the allocator's
            # cache, so the pool is what the capture reserves after that
            with torch.cuda.graph(graph, stream=stream):
                reserved = torch.cuda.memory_reserved(device)
                out = run(cache)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {what} failed (it has no eager fallback): {e}") from e
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
        captured = [{k: a[k] - w[k] for k in a if a[k] != w[k]} for w, a in zip(warm, _read_counters())]
        return graph, out, captured, pool_bytes
    finally:
        _restore_counters(before)


class DecodeGraph:
    """One slot pool's decode tick, built on its first call and run every
    tick (a graph replay on the card, an eager tick on the CPU).

    ``captured``: the wrappers' counter deltas of one tick (None until
    built); ``replays``: graph replays run; ``capture_seconds``: warm-up
    plus capture (on the CPU the warm-up alone); ``pool_bytes``: the graph's
    memory pool (None on the CPU)."""

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
        self.pool_bytes = None

    def serves(self, cache) -> bool:
        return cache_key(cache) == self.key

    def _tick(self, cache) -> torch.Tensor:
        r = self._runner()
        logits, _ = r._with_crossbar(
            lambda: model_lib.decode_step(r.params, r.cfg, self.toks, self.pos, cache)
        )
        return logits

    def run(self, last_tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One tick over the whole pool: ``last_tok`` and ``pos`` are (B,)
        host arrays; returns host float32 logits (B, V), the tick's one
        device synchronisation."""
        host = self._host_in.numpy()
        host[0] = last_tok
        host[1] = pos
        self._dev_in.copy_(self._host_in, non_blocking=self._cuda)
        if self.captured is None:
            t0 = time.perf_counter()
            self.graph, self.logits, self.captured, self.pool_bytes = capture(
                self._runner().device, self._tick, self.cache,
                f"the decode tick of a {self.pos.shape[0]}-slot pool",
            )
            self.capture_seconds = time.perf_counter() - t0
        if self.graph is None:
            logits = self._tick(self.cache)
        else:
            self.graph.replay()
            credit_launches(self.captured)
            self.replays += 1
            logits = self.logits
        return logits.to(torch.float32).cpu().numpy()


class PrefillBuffers:
    """The static inputs of one runner's prefill graphs, shared by every
    bucket: a ``(1, max_seq)`` int64 token buffer on the device and its
    pinned host twin, and one one-slot cache (``init_cache(1)`` once).

    Sharing them is exact: every prefill zeroes the cache before it writes,
    the graphs run one at a time on one stream, and ``admit_slot`` copies
    the cache into the pool's slot (on that stream) before the next prefill
    can run."""

    def __init__(self, runner):
        dev = runner.device
        self._cuda = dev.type == "cuda"
        self._host = torch.zeros((1, runner.max_seq), dtype=torch.int64, pin_memory=self._cuda)
        self.tokens = torch.zeros((1, runner.max_seq), dtype=torch.int64, device=dev)
        self.cache = runner.init_cache(1)
        # the copy of the last admission out of the pinned buffer: the
        # admission does not synchronise, so the buffer is only rewritten
        # once that copy has run
        self._copied = None

    def fill(self, prompt: np.ndarray) -> None:
        """Copy ``prompt``, a (1, L) host int array, into the first L
        columns of the token buffer (no synchronisation)."""
        if self._copied is not None:
            self._copied.synchronize()
        length = prompt.shape[1]
        self._host.numpy()[:, :length] = prompt
        self.tokens[:, :length].copy_(self._host[:, :length], non_blocking=self._cuda)
        if self._cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()


class PrefillGraph:
    """One bucket's prefill of an attention model, built on its first
    admission and run at every admission of a prompt in the bucket (a graph
    replay on the card, an eager prefill on the CPU), on the runner's
    ``PrefillBuffers``: ``run`` zeroes their one-slot cache, prefills into it
    and returns it, and the caller copies it into the pool's slot.

    ``captured``, ``replays``, ``capture_seconds`` and ``pool_bytes`` as
    ``DecodeGraph``'s."""

    def __init__(self, runner, bucket: int, buffers: PrefillBuffers):
        self._runner = weakref.ref(runner)  # weak, as DecodeGraph's
        self.bucket = bucket
        self._buffers = buffers
        self.tokens = buffers.tokens[:, :bucket]
        self.cache = buffers.cache
        self.graph = None
        self.logits = None
        self.captured = None
        self.replays = 0
        self.capture_seconds = None
        self.pool_bytes = None

    def _prefill(self, cache) -> torch.Tensor:
        r = self._runner()
        for t in cache_leaves(cache):
            t.zero_()
        logits, _ = r._with_crossbar(lambda: model_lib.prefill(r.params, r.cfg, self.tokens, cache))
        return logits

    def run(self, prompt: np.ndarray):
        """Prefill ``prompt``, a (1, bucket) host int array (a prompt
        zero-padded to the bucket), into the shared one-slot cache.  Returns
        ``(logits, cache)``: the last position's (1, V) logits and the filled
        cache, on the device, with no synchronisation; the logits are the
        graph's own until its next run, the cache is valid until the next
        prefill of any bucket."""
        self._buffers.fill(prompt)
        if self.captured is None:
            t0 = time.perf_counter()
            self.graph, self.logits, self.captured, self.pool_bytes = capture(
                self._runner().device, self._prefill, self.cache, f"the prefill of bucket {self.bucket}",
            )
            self.capture_seconds = time.perf_counter() - t0
        if self.graph is None:
            return self._prefill(self.cache), self.cache
        self.graph.replay()
        credit_launches(self.captured)
        self.replays += 1
        return self.logits, self.cache
