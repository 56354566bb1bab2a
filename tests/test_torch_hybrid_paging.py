"""PyTorch port, the block pool with a hybrid cache (reduced jamba: mamba
state beside an attention KV cache): the state leaves ``h`` / ``conv`` page
as one block each, ``k`` / ``v`` block by block along the sequence, and a
request preempted through ``BlockKVCache.page_out`` / ``page_in`` resumes
to the tokens of a run never preempted, by hand and under the scheduler.
Port only: the reference's block pool is a JAX module of its own."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.serving import (
    BlockCacheConfig, BlockKVCache, ContinuousBatchingScheduler, ModelRunner, Request, ServingEngine,
)
from repro_torch.serving.graphs import cache_leaves, named_leaves

JAMBA = "jamba-v0.1-52b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jamba():
    cfg = reduced(get_config(JAMBA))
    return cfg, TM.init_model(cfg, 0, device="cpu")


def _prompt(n, lo=1):
    return (np.arange(lo, lo + n) % 60 + 1).astype(np.int32)


def _generate(runner, kv, slot, first, pos, ticks):
    """``ticks`` greedy decode ticks of the request in ``slot`` (the other
    slot idle); returns its tokens as a tensor."""
    out, tok = [], first
    for _ in range(ticks):
        last = np.zeros(kv.max_batch, np.int64)
        at = np.zeros(kv.max_batch, np.int64)
        last[slot], at[slot] = tok, pos
        logits, kv.cache = runner.decode(last, at, kv.cache)
        tok, pos = int(np.argmax(logits[slot])), pos + 1
        out.append(tok)
    return torch.tensor(out), pos, tok


def test_state_leaves_page_as_one_block_and_the_resumed_request_is_unchanged(jamba):
    cfg, params = jamba
    runner = ModelRunner(cfg, params, max_seq=32, device="cpu")
    block = BlockCacheConfig(block_size=4)
    kinds = {n.split("/")[-1] for n, _ in named_leaves(TM.init_cache(cfg, 1, 4, device="cpu"))}
    assert kinds == {"h", "conv", "k", "v"}

    def admitted():
        kv = BlockKVCache(cfg, max_batch=2, max_seq=32, block=block, device="cpu")
        kv.allocate(0, 6)
        kv.cache, pos, last, first = runner.admit_slot(kv.cache, 0, Request(0, _prompt(6), max_new_tokens=9))
        assert (pos, last) == (6, first)  # recurrent: the first token comes from the prefill
        return kv, pos, first

    kv, pos, first = admitted()
    assert {n: kv._seq_axis[n] for n in kv._seq_axis} == {
        n: (None if n.split("/")[-1] in ("h", "conv") else 2) for n in kv._seq_axis
    }
    assert kv.has_seq and kv.blocks_for(6) == 2
    whole, _, _ = _generate(runner, kv, 0, first, pos, 8)

    kv, pos, first = admitted()
    head, pos, tok = _generate(runner, kv, 0, first, pos, 3)
    snapshot = {n: t[:, 0].clone() for n, t in named_leaves(kv.cache)}
    kv.page_out(0, 0, pos, tok)
    assert kv.is_paged(0) and kv.free_blocks == kv.n_blocks
    swapped = kv._swap[0][2]
    for n, chunks in swapped.items():
        want = 1 if kv._seq_axis[n] is None else -(-pos // block.block_size)
        assert len(chunks) == want, n
    for t in cache_leaves(kv.cache):  # both slots clobbered: the resume must rewrite every state leaf
        t.fill_(3.0)
    assert kv.page_in(0, 1) == (pos, tok)
    for n, t in named_leaves(kv.cache):
        got = t[:, 1] if kv._seq_axis[n] is None else t[:, 1, :pos]
        want = snapshot[n] if kv._seq_axis[n] is None else snapshot[n][:, :pos]
        assert torch.equal(got, want), n
    tail, _, _ = _generate(runner, kv, 1, tok, pos, 5)
    assert torch.equal(torch.cat([head, tail]), whole)


def test_scheduler_with_a_preemption_serves_the_slot_loops_tokens(jamba):
    cfg, params = jamba
    sched = ContinuousBatchingScheduler(
        ModelRunner(cfg, params, max_seq=48, device="cpu"), max_batch=2,
        block=BlockCacheConfig(block_size=4, n_blocks=4),
    )
    preempted = []
    real = sched._preempt

    def spy(*a, **kw):
        preempted.append(a)
        return real(*a, **kw)

    sched._preempt = spy
    prompts = (_prompt(6), _prompt(8, lo=2))
    for p in prompts:
        sched.submit(p, max_new_tokens=8)
    out = {r.rid: r.generated for r in sched.run()}
    assert preempted
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=48, device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    assert out == {r.rid: r.generated for r in eng.run_until_done()}
