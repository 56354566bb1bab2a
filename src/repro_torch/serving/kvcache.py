"""Block-allocated KV cache for the continuous-batching traffic tier
(counterpart of ``repro.serving.kvcache``).

The slot-pool engine pins ``max_seq`` worth of cache per slot for every
request, however short.  This module adds block-granular accounting and
exact swap on top of the same dense compute view (the decode tick is a
captured CUDA graph bound to the cache's addresses, so the *compute* cache
stays a dense ``(max_batch, max_seq)`` slot pool — what gets block-managed is
the *budget* and the *paged-out copies*):

  * a pool of ``n_blocks`` fixed-size blocks (``block_size`` tokens each)
    with a deterministic free-list allocator (lowest-numbered block first);
  * per-request block tables: a request holds exactly
    ``ceil(tokens / block_size)`` blocks and extends one block at a time as
    decode crosses a block boundary;
  * recurrent state leaves (no sequence axis: xLSTM ``C`` / ``n`` / ``c`` /
    ``h``, mamba ``h`` / ``conv``) are single-block caches — their size does
    not grow with generated tokens, so one block covers the whole request
    regardless of length; in a hybrid (jamba) they page whole beside the
    attention leaves, which page block by block;
  * ``page_out`` / ``page_in``: exact preemption and resume.  Page-out
    copies the victim's cache prefix into block-size host chunks, frees its
    pool blocks and surrenders the slot; page-in re-allocates blocks and
    writes the chunks back into any free slot, in place (the leaves keep
    their addresses, so the runner's captured tick keeps serving).
    Attention masks by position, so stale slot content beyond ``pos`` is
    irrelevant — a resumed request computes exactly what one never preempted
    would.

Block shapes are derived from ``models.model.cache_axes`` (``"cache_seq"``
names the sequence axis), not hard-coded per family.  Leaves are keyed by
their joined path in the cache (``serving.graphs.named_leaves``: ``"0/b0/k"``),
as the reference keys them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.serving.graphs import named_leaves


@dataclasses.dataclass(frozen=True)
class BlockCacheConfig:
    """Sizing of the block pool.

    ``n_blocks=None`` sizes the pool to the dense slot-pool capacity
    (``max_batch * ceil(max_seq / block_size)``) — same total budget as the
    engine's cache, but fungible across requests of different lengths.
    Smaller pools oversubscribe: admission then depends on the *actual*
    token footprint, and the scheduler preempts when the pool runs dry.
    """

    block_size: int = 16
    n_blocks: Optional[int] = None

    def resolve_n_blocks(self, max_batch: int, max_seq: int) -> int:
        if self.n_blocks is not None:
            return self.n_blocks
        return max_batch * -(-max_seq // self.block_size)


class BlockKVCache:
    """Dense compute view + block-granular accounting and exact swap.

    ``cache`` is the decode-facing dense slot pool (``ModelRunner.init_cache``:
    float32 on ``device``); schedulers read and reassign it around
    ``runner.decode`` / ``runner.admit_slot`` calls, which write it in place.
    Everything else here manages the block pool: allocation (``allocate`` /
    ``ensure`` / ``release``), capacity queries (``can_admit`` /
    ``free_blocks``), and exact page-out / page-in of a slot's cache prefix.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        max_batch: int,
        max_seq: int,
        block: Optional[BlockCacheConfig] = None,
        dtype=torch.float32,
        device="cuda",
    ):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.block = block or BlockCacheConfig()
        self.block_size = self.block.block_size
        self.n_blocks = self.block.resolve_n_blocks(max_batch, max_seq)
        self.cache = model_lib.init_cache(cfg, max_batch, max_seq, dtype=dtype, device=device)
        ax_by_name = dict(named_leaves(model_lib.cache_axes(cfg)))
        # per-leaf layout: index of the sequence axis, None for state leaves
        # (recurrent state — O(1) in tokens, single-block)
        self._seq_axis: Dict[str, Optional[int]] = {}
        for name, leaf in named_leaves(self.cache):
            ax = ax_by_name[name]
            if len(ax) != leaf.ndim:
                raise ValueError(
                    f"cache leaf {name!r}: axes {ax} rank-mismatch shape {tuple(leaf.shape)}"
                )
            if ax[1] != "cache_batch":
                # the paging index math below slices axis 1 as the slot axis
                raise NotImplementedError(
                    f"cache leaf {name!r}: expected cache_batch at axis 1, got {ax}"
                )
            seq = ax.index("cache_seq") if "cache_seq" in ax else None
            if seq is not None and seq != 2:
                raise NotImplementedError(
                    f"cache leaf {name!r}: expected cache_seq at axis 2, got {ax}"
                )
            self._seq_axis[name] = seq
        self.has_seq = any(s is not None for s in self._seq_axis.values())
        # deterministic allocator: lowest-numbered free block first
        self._free: List[int] = list(range(self.n_blocks))
        self._tables: Dict[int, List[int]] = {}
        # swap space for paged-out requests: rid -> (pos, last_tok, {leaf
        # name -> list of block-size host chunks (state leaves: one
        # whole-state chunk)}).  Swapped requests hold no pool blocks.
        self._swap: Dict[int, Tuple[int, int, Dict[str, List[torch.Tensor]]]] = {}

    # -- accounting ----------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` of cache for one request.

        Pure-recurrent configs (no sequence axis anywhere) cost one block
        regardless of length — their state is O(1) in tokens.
        """
        if not self.has_seq:
            return 1
        return max(1, -(-int(n_tokens) // self.block_size))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.free_blocks

    def table(self, rid: int) -> Tuple[int, ...]:
        return tuple(self._tables.get(rid, ()))

    def allocate(self, rid: int, n_tokens: int) -> None:
        if rid in self._tables:
            raise ValueError(f"rid {rid} already holds blocks {self._tables[rid]}")
        need = self.blocks_for(n_tokens)
        if need > self.free_blocks:
            raise ValueError(
                f"block pool exhausted: rid {rid} needs {need} blocks, "
                f"{self.free_blocks}/{self.n_blocks} free"
            )
        self._tables[rid] = [self._free.pop(0) for _ in range(need)]

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow ``rid``'s table to cover ``n_tokens``; False if the pool is
        dry (caller preempts a victim and retries)."""
        tab = self._tables[rid]
        need = self.blocks_for(n_tokens)
        while len(tab) < need:
            if not self._free:
                return False
            tab.append(self._free.pop(0))
        return True

    def release(self, rid: int) -> None:
        """Return all of ``rid``'s blocks to the pool (request finished or
        expired).  Freed blocks re-enter in sorted order so the allocator
        stays deterministic regardless of completion order."""
        tab = self._tables.pop(rid, [])
        self._swap.pop(rid, None)
        self._free = sorted(self._free + tab)

    # -- paging --------------------------------------------------------
    def is_paged(self, rid: int) -> bool:
        return rid in self._swap

    def paged_pos(self, rid: int) -> int:
        return self._swap[rid][0]

    def page_out(self, rid: int, slot: int, pos: int, last_tok: int) -> None:
        """Copy slot ``slot``'s cache prefix (positions < ``pos`` for seq
        leaves; whole state for state leaves) out to block-size host chunks,
        free the request's pool blocks, and record the resume point.  The
        chunks are copies (on a CPU cache too, where ``.cpu()`` would alias
        the slot): the slot is the caller's to reuse, and the freed blocks
        relieve the pool pressure that forced the preemption."""
        n_tok = int(pos)
        chunks: Dict[str, List[torch.Tensor]] = {}
        for name, leaf in named_leaves(self.cache):
            if self._seq_axis[name] is None:
                chunks[name] = [leaf[:, slot].to("cpu", copy=True)]  # (L, ...)
            else:
                host = leaf[:, slot, :n_tok].to("cpu", copy=True)  # (L, pos, ...)
                chunks[name] = [host[:, lo:lo + self.block_size] for lo in range(0, n_tok, self.block_size)]
        self._swap[rid] = (n_tok, int(last_tok), chunks)
        tab = self._tables.pop(rid, [])
        self._free = sorted(self._free + tab)

    def page_in(self, rid: int, slot: int) -> Tuple[int, int]:
        """Re-allocate blocks for ``rid``, write its swapped chunks back into
        slot ``slot`` of the dense cache in place, and return the recorded
        ``(pos, last_tok)`` resume point.  Positions >= pos keep whatever
        stale content the slot held — attention masks by position, so the
        resumed request computes exactly what one never preempted would."""
        pos, last_tok, chunks = self._swap.pop(rid)
        self.allocate(rid, pos)
        for name, leaf in named_leaves(self.cache):
            if self._seq_axis[name] is None:
                leaf[:, slot].copy_(chunks[name][0])
            else:
                for bi, chunk in enumerate(chunks[name]):
                    lo = bi * self.block_size
                    leaf[:, slot, lo:lo + chunk.shape[1]].copy_(chunk)
        return pos, last_tok
