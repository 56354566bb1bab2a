"""Deterministic, restart-safe data pipeline (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, host slice), so a restarted
job resumes mid-epoch by just setting the step counter — no iterator state
to checkpoint.  The draws are numpy ``Philox`` streams keyed as the
reference keys them, so every batch is bit-identical to the reference's.
Batches are numpy arrays; the train loop moves them to the device.  Hosts
read only their slice of the global batch: the slice is this process's
``torch.distributed`` rank and world size when a process group is
initialised, else 0 of 1.  ``prefetch`` overlaps host-side batch assembly
with device compute via a background thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch.distributed as dist


def _process_slice(process_index: Optional[int], process_count: Optional[int]) -> Tuple[int, int]:
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return pi, pc


class SyntheticLMDataset:
    """Deterministic synthetic token stream (counter-based RNG per batch)."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.pi, self.pc = _process_slice(process_index, process_count)
        if global_batch % self.pc:
            raise ValueError(f"global batch {global_batch} does not split over {self.pc} processes")
        self.local_batch = global_batch // self.pc

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Philox(key=self.seed + step * 1000003 + self.pi)
        gen = np.random.Generator(rng)
        toks = gen.integers(
            0, self.vocab, size=(self.local_batch, self.seq + 1), dtype=np.int32
        )
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLMDataset:
    """Token file (np.memmap, int32) chunked into fixed windows.

    Window assignment is a pure function of (step, host, index) so restarts
    are deterministic; wraps around at the end of the file.
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq_len
        self.global_batch = global_batch
        self.pi, self.pc = _process_slice(process_index, process_count)
        self.local_batch = global_batch // self.pc
        self.n_windows = max(1, (len(self.tokens) - 1) // seq_len)
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        base = step * self.global_batch + self.pi * self.local_batch
        idx = (base + np.arange(self.local_batch)) % self.n_windows
        # deterministic shuffle of window order
        rng = np.random.Generator(np.random.Philox(key=self.seed))
        perm = rng.permutation(self.n_windows)
        starts = perm[idx] * self.seq
        rows = np.stack([self.tokens[s : s + self.seq + 1] for s in starts])
        return {"inputs": rows[:, :-1].astype(np.int32), "targets": rows[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class EmbeddingStubDataset:
    """Modality-frontend stub for [audio]/[vlm] archs: precomputed frame/patch
    embeddings + token targets (the reference's batches), which the model's
    ``loss_fn`` takes through its embedding front end."""

    def __init__(self, d_model: int, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.d = d_model
        self.vocab = vocab_size
        self.seq = seq_len
        self.pi, self.pc = _process_slice(process_index, process_count)
        self.local_batch = global_batch // self.pc
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        gen = np.random.Generator(np.random.Philox(key=self.seed + step * 7919 + self.pi))
        emb = gen.standard_normal((self.local_batch, self.seq, self.d)).astype(np.float32)
        tgt = gen.integers(0, self.vocab, size=(self.local_batch, self.seq), dtype=np.int32)
        return {"inputs": emb, "targets": tgt}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(
    cfg, seq_len: int, global_batch: int, seed: int = 0, path: Optional[str] = None,
    process_index: Optional[int] = None, process_count: Optional[int] = None,
):
    """The config's dataset.  ``process_index`` / ``process_count`` pick the
    host slice (default: this process's rank and world size); a rank process
    of a mesh passes 0 / 1 for the whole global batch, of which the mesh
    train step takes the rank's rows."""
    where = dict(process_index=process_index, process_count=process_count)
    if cfg.frontend == "embed":
        return EmbeddingStubDataset(cfg.d_model, cfg.vocab_size, seq_len, global_batch, seed, **where)
    if path:
        return MemmapLMDataset(path, seq_len, global_batch, seed, **where)
    return SyntheticLMDataset(cfg.vocab_size, seq_len, global_batch, seed, **where)


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch: overlaps batch assembly with compute."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
