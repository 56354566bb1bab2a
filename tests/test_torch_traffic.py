"""PyTorch port, the serving traffic tier: ``ContinuousBatchingScheduler``,
``BlockKVCache`` and ``models.model.cache_axes``, held to the JAX package.

Mirrors of the reference's scheduler and block-cache tests
(``tests/test_serving_traffic.py``) on a reduced smollm-360m carried across
from the JAX package, then the port against the JAX package on the same
seeded Poisson short/long schedule with deadlines and preemption, digitally
and from one JAX-written ideal chip; the pool's leaves keep their addresses
across page-in (the captured tick survives a run that preempts); page-out's
chunks are copies; the xLSTM scheduler equals its engine.  The farm's tests
are in ``tests/test_torch_farm.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serving_traffic import SHORT_LONG
from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import BlockCacheConfig as JBlockConfig
from repro.serving import BlockKVCache as JBlockKV
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ModelRunner as JRunner
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import _bucket as j_bucket
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import (
    BlockCacheConfig,
    BlockKVCache,
    ContinuousBatchingScheduler,
    ModelRunner,
    Request,
    ServingEngine,
)
from repro_torch.serving.graphs import cache_key, cache_leaves, clone_cache, named_leaves

pytestmark = pytest.mark.serving

# the digital model's values against the JAX package's (tests/test_torch_model.py)
DIGITAL = dict(rtol=1e-4, atol=1e-4)
# the traffic mix's deadlines: a short request gets 4 ticks, a long one none;
# with 4 slots and a 10-block pool of 4-token blocks the schedule preempts
# 6 times and expires 5 of the 12 requests
DEADLINE = {"short": 4, "long": None}
POOL = dict(block_size=4, n_blocks=10)


def _carry(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = reduced(get_config(arch))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def tiny_lm():
    return _carry("smollm-360m")


@pytest.fixture(scope="module")
def tiny_xlstm():
    return _carry("xlstm-350m")


@pytest.fixture(scope="module")
def jax_ideal_store(tiny_lm, tmp_path_factory):
    """An ideal chip programmed and written by the JAX engine."""
    jcfg, _, jparams, _ = tiny_lm
    d = str(tmp_path_factory.mktemp("ideal"))
    JEngine(jcfg, jparams, max_batch=2, max_seq=48, crossbar=JMode(enabled=True, strict=True)).save_artifacts(d)
    return d


def _runner(tiny, max_seq=32, **kw):
    _, tcfg, _, tparams = tiny
    return ModelRunner(tcfg, tparams, max_seq=max_seq, seed=0, device="cpu", **kw)


def _prompt(n, lo=1):
    return (np.arange(lo, lo + n) % 60 + 1).astype(np.int32)


def _mixed_workload():
    return [
        (_prompt(5), 3),
        (_prompt(9, lo=4), 6),
        (_prompt(3, lo=9), 1),
        (_prompt(12, lo=2), 4),
        (_prompt(6, lo=7), 5),
        (_prompt(4, lo=11), 2),
    ]


# ---------------------------------------------------------------------------
# The port's own fields and axes against the reference's
# ---------------------------------------------------------------------------


def test_request_fields_are_the_reference_fields_in_order():
    assert [f.name for f in dataclasses.fields(Request)] == [f.name for f in dataclasses.fields(JRequest)]
    r = Request(3, _prompt(4))
    assert (r.deadline, r.arrival, r.finish, r.expired) == (None, 0, None, False)


@pytest.mark.parametrize(
    "arch", ["smollm-360m", "xlstm-350m", "gemma2-9b", "deepseek-v2-236b", "jamba-v0.1-52b", "musicgen-large",
             "pixtral-12b"],
)
def test_cache_axes_equal_the_reference(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = reduced(get_config(arch))
    assert TM.cache_axes(tcfg) == JM.cache_axes(jcfg)
    # one axes tuple a leaf of init_cache, of the leaf's rank
    axes = dict(named_leaves(TM.cache_axes(tcfg)))
    leaves = dict(named_leaves(TM.init_cache(tcfg, 2, 8, device="cpu")))
    assert sorted(axes) == sorted(leaves)
    assert all(len(axes[n]) == leaves[n].ndim for n in leaves)


@pytest.mark.parametrize("kind", ["unknown_stage_kind"])
def test_cache_axes_refuse_what_init_cache_refuses(kind):
    tcfg = reduced(get_config("smollm-360m"))
    tcfg = dataclasses.replace(tcfg, stages=(dataclasses.replace(tcfg.stages[0], kinds=("conv",)),))
    match = "unknown stage kind"
    with pytest.raises(ValueError, match=match):
        TM.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match=match):
        TM.cache_axes(tcfg)
    with pytest.raises(ValueError, match=match):
        BlockKVCache(tcfg, 1, 8, device="cpu")


def test_block_cache_defaults_to_float32_on_the_card(tiny_lm):
    """The pool is the runner's float32 cache (``init_cache`` alone defaults
    to bfloat16, which would serve other tokens); its device defaults to
    the card and is refused without one."""
    _, tcfg, _, _ = tiny_lm
    kv = BlockKVCache(tcfg, 2, 16, device="cpu")
    assert all(t.dtype == torch.float32 for t in cache_leaves(kv.cache))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockKVCache(tcfg, 2, 16)


# ---------------------------------------------------------------------------
# Scheduler: mirrors of the reference's tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chip", [False, True], ids=["digital", "ideal_chip"])
def test_scheduler_token_identical_to_engine(tiny_lm, chip):
    _, tcfg, _, tparams = tiny_lm
    kw = dict(crossbar=CrossbarMode(enabled=True, strict=True)) if chip else {}
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, seed=0, device="cpu", **kw)
    for p, n in _mixed_workload():
        eng.submit(p, max_new_tokens=n)
    eng_out = {r.rid: r.generated for r in eng.run_until_done()}

    sched = ContinuousBatchingScheduler(_runner(tiny_lm, **kw), max_batch=2)
    for p, n in _mixed_workload():
        sched.submit(p, max_new_tokens=n)
    sched_out = {r.rid: r.generated for r in sched.run()}
    assert sched_out == eng_out


def test_scheduler_deterministic_replay(tiny_lm):
    def run():
        sched = ContinuousBatchingScheduler(_runner(tiny_lm), max_batch=2)
        for p, n in _mixed_workload():
            sched.submit(p, max_new_tokens=n)
        return [(r.rid, tuple(r.generated), r.finish) for r in sched.run()]

    assert run() == run()


def test_scheduler_admits_mid_flight(tiny_lm):
    sched = ContinuousBatchingScheduler(_runner(tiny_lm), max_batch=2)
    sched.submit(_prompt(5), max_new_tokens=8)
    sched.step()
    sched.submit(_prompt(4, lo=3), max_new_tokens=2)
    sched.step()
    assert sched.n_active == 2  # joined the in-flight batch immediately
    res = sched.run()
    assert [len(r.generated) for r in res] == [8, 2]


def test_scheduler_deadline_eviction(tiny_lm):
    sched = ContinuousBatchingScheduler(_runner(tiny_lm, max_seq=48), max_batch=1)
    r0 = sched.submit(_prompt(4), max_new_tokens=30, deadline=3)
    r1 = sched.submit(_prompt(4, lo=2), max_new_tokens=2)
    res = {r.rid: r for r in sched.run()}
    assert res[r0].expired and res[r0].done
    assert len(res[r0].generated) <= 3
    assert not res[r1].expired and len(res[r1].generated) == 2


def test_scheduler_edf_admission_order(tiny_lm):
    sched = ContinuousBatchingScheduler(_runner(tiny_lm, max_seq=48), max_batch=1)
    sched.submit(_prompt(4), max_new_tokens=2)
    r_late = sched.submit(_prompt(4, lo=5), max_new_tokens=2, deadline=8)
    r_free = sched.submit(_prompt(4, lo=3), max_new_tokens=2)
    res = {r.rid: r for r in sched.run()}
    assert not res[r_late].expired
    assert res[r_late].finish < res[r_free].finish


def test_scheduler_streaming_callbacks(tiny_lm):
    seen = []
    sched = ContinuousBatchingScheduler(
        _runner(tiny_lm), max_batch=2, stream=lambda req, tok: seen.append((req.rid, tok)),
    )
    r0 = sched.submit(_prompt(5), max_new_tokens=3)
    per_req = []
    r1 = sched.submit(_prompt(4, lo=2), max_new_tokens=2, on_token=lambda req, tok: per_req.append(tok))
    res = {r.rid: r for r in sched.run()}
    assert [t for rid, t in seen if rid == r0] == res[r0].generated
    assert per_req == res[r1].generated
    assert all(rid != r1 for rid, _ in seen)


def test_scheduler_preemption_is_exact(tiny_lm):
    # a pool too small for both requests forces swap-out / swap-in; digitally
    # the token streams equal the unconstrained engine's
    _, tcfg, _, tparams = tiny_lm
    sched = ContinuousBatchingScheduler(
        _runner(tiny_lm, max_seq=48), max_batch=2, block=BlockCacheConfig(block_size=4, n_blocks=4),
    )
    preempted = _count_preemptions(sched)
    sched.submit(_prompt(6), max_new_tokens=8)
    sched.submit(_prompt(8, lo=2), max_new_tokens=8)
    out = {r.rid: r.generated for r in sched.run()}
    assert preempted

    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=48, seed=0, device="cpu")
    eng.submit(_prompt(6), max_new_tokens=8)
    eng.submit(_prompt(8, lo=2), max_new_tokens=8)
    assert out == {r.rid: r.generated for r in eng.run_until_done()}


def test_scheduler_refuses_impossible_request(tiny_lm):
    sched = ContinuousBatchingScheduler(
        _runner(tiny_lm, max_seq=48), max_batch=2, block=BlockCacheConfig(block_size=4, n_blocks=4),
    )
    with pytest.raises(ValueError, match="never run to completion"):
        sched.submit(_prompt(20), max_new_tokens=20)


# ---------------------------------------------------------------------------
# Block KV cache: mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_block_accounting(tiny_lm):
    _, tcfg, _, _ = tiny_lm
    kv = BlockKVCache(tcfg, max_batch=2, max_seq=32, block=BlockCacheConfig(block_size=8, n_blocks=6), device="cpu")
    assert kv.blocks_for(1) == 1 and kv.blocks_for(8) == 1
    assert kv.blocks_for(9) == 2 and kv.blocks_for(32) == 4
    kv.allocate(0, 9)
    assert kv.table(0) == (0, 1) and kv.free_blocks == 4
    assert kv.ensure(0, 16)
    assert kv.table(0) == (0, 1)
    assert kv.ensure(0, 17)
    assert kv.table(0) == (0, 1, 2) and kv.free_blocks == 3
    kv.allocate(1, 24)
    assert kv.free_blocks == 0
    assert not kv.ensure(0, 25)
    kv.release(1)
    assert kv.free_blocks == 3 and kv.ensure(0, 25)
    kv.release(0)
    assert kv.free_blocks == 6


def test_block_pool_default_matches_dense_capacity(tiny_lm):
    _, tcfg, _, _ = tiny_lm
    kv = BlockKVCache(tcfg, max_batch=4, max_seq=48, device="cpu")
    assert kv.n_blocks == 4 * kv.blocks_for(48)
    for rid in range(4):
        kv.allocate(rid, 48)
    assert kv.free_blocks == 0


def test_page_out_in_round_trip_exact(tiny_lm):
    runner = _runner(tiny_lm)
    kv = BlockKVCache(runner.cfg, max_batch=2, max_seq=32, block=BlockCacheConfig(block_size=4), device="cpu")
    req = Request(0, _prompt(6), max_new_tokens=4)
    kv.allocate(0, 6)
    kv.cache, pos, last, _ = runner.admit_slot(kv.cache, 0, req)
    want = [t[:, 0].clone() for t in cache_leaves(kv.cache)]
    # page out, trash the slot, page back into a *different* slot: the
    # prefix must round-trip exactly
    kv.page_out(0, 0, pos, last)
    for t in cache_leaves(kv.cache):
        t[:, 0] = -1.0
    pos2, last2 = kv.page_in(0, 1)
    assert (pos2, last2) == (pos, last)
    for w, t in zip(want, cache_leaves(kv.cache)):
        assert torch.equal(w[:, :pos], t[:, 1, :pos])


def test_page_out_frees_blocks(tiny_lm):
    runner = _runner(tiny_lm)
    kv = BlockKVCache(runner.cfg, max_batch=1, max_seq=32, block=BlockCacheConfig(block_size=4, n_blocks=4),
                      device="cpu")
    kv.allocate(7, 6)
    kv.cache, pos, last, _ = runner.admit_slot(kv.cache, 0, Request(7, _prompt(6), max_new_tokens=2))
    held = kv.free_blocks
    kv.page_out(7, 0, pos, last)
    assert kv.is_paged(7) and kv.paged_pos(7) == pos
    assert kv.free_blocks > held
    kv.page_in(7, 0)
    assert not kv.is_paged(7) and kv.free_blocks == held


def test_page_out_chunks_are_copies_not_views_of_the_slot(tiny_lm):
    """On a CPU cache ``.cpu()`` returns the slot's own storage: chunks that
    aliased it would change under the next request admitted there."""
    runner = _runner(tiny_lm)
    kv = BlockKVCache(runner.cfg, max_batch=1, max_seq=32, block=BlockCacheConfig(block_size=4), device="cpu")
    kv.allocate(0, 10)
    kv.cache, pos, last, _ = runner.admit_slot(kv.cache, 0, Request(0, _prompt(10), max_new_tokens=2))
    kv.page_out(0, 0, pos, last)
    chunks = kv._swap[0][2]
    before = {n: [c.clone() for c in cs] for n, cs in chunks.items()}
    assert [c.shape[1] for c in chunks["0/b0/k"]] == [4, 4, 1]
    for t in cache_leaves(kv.cache):
        t.fill_(7.0)  # the slot reused
    for n, cs in chunks.items():
        assert all(torch.equal(a, b) for a, b in zip(cs, before[n]))
        assert all(c.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
                   for c in cs for t in cache_leaves(kv.cache))


# ---------------------------------------------------------------------------
# The captured tick survives preemption (page-in writes in place)
# ---------------------------------------------------------------------------


def _count_preemptions(sched):
    """Record every preemption's slot (the scheduler keeps no count)."""
    seen = []
    real = sched._preempt

    def preempt(slot):
        seen.append(slot)
        real(slot)

    sched._preempt = preempt
    return seen


def test_decode_graph_is_kept_across_preemption_and_resume(tiny_lm):
    runner = _runner(tiny_lm, max_seq=48)
    sched = ContinuousBatchingScheduler(runner, max_batch=2, block=BlockCacheConfig(block_size=4, n_blocks=4))
    preempted = _count_preemptions(sched)
    resumed = []
    real_in = sched.kv.page_in
    sched.kv.page_in = lambda rid, slot: resumed.append(rid) or real_in(rid, slot)
    key = cache_key(sched.kv.cache)
    sched.submit(_prompt(6), max_new_tokens=8)
    sched.submit(_prompt(8, lo=2), max_new_tokens=8)
    sched.step()
    graph = runner.decode_graph
    assert graph is not None and graph.key == key
    while sched.waiting or sched.n_active:
        sched.step()
        assert runner.decode_graph is graph
    assert preempted and resumed
    assert cache_key(sched.kv.cache) == key == graph.key


# ---------------------------------------------------------------------------
# Against the JAX package: one Poisson short/long schedule with deadlines
# ---------------------------------------------------------------------------


def _serve_mix(sched, vocab):
    """Submit ``SHORT_LONG``'s requests at their arrival ticks (a short one
    with a deadline) and step until drained.  Returns each request's
    (rid, generated, arrival, finish, expired) and the preemptions."""
    preempted = _count_preemptions(sched)
    queue = list(SHORT_LONG.sample_arrivals(vocab))
    while queue or sched.load:
        while queue and queue[0][0] <= sched.tick:
            _, cls, prompt = queue.pop(0)
            sched.submit(prompt, max_new_tokens=cls.max_new_tokens, deadline=DEADLINE[cls.name])
        sched.step()
    done = sorted({**sched.completed, **sched.expired}.values(), key=lambda r: r.rid)
    return [(r.rid, list(r.generated), r.arrival, r.finish, r.expired) for r in done], len(preempted)


@pytest.mark.parametrize("chip", [False, True], ids=["digital", "ideal_chip"])
def test_scheduler_schedule_and_tokens_equal_the_jax_scheduler(tiny_lm, jax_ideal_store, chip):
    jcfg, tcfg, jparams, tparams = tiny_lm
    jkw, tkw = {}, {}
    if chip:
        jkw = dict(crossbar=JMode(enabled=True, strict=True), restore_artifacts=jax_ideal_store)
        tkw = dict(crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=jax_ideal_store)
    jsched = JScheduler(JRunner(jcfg, jparams, max_seq=48, seed=0, **jkw), max_batch=4,
                        block=JBlockConfig(**POOL))
    tsched = ContinuousBatchingScheduler(_runner(tiny_lm, max_seq=48, **tkw), max_batch=4,
                                         block=BlockCacheConfig(**POOL))
    want, j_preempted = _serve_mix(jsched, jcfg.vocab_size)
    got, t_preempted = _serve_mix(tsched, tcfg.vocab_size)
    assert len(got) == SHORT_LONG.n_requests
    assert t_preempted == j_preempted > 0
    assert any(e for *_, e in got) and not all(e for *_, e in got)
    assert got == want
    # rids follow arrival order: a request expired or got all its tokens
    for (_, gen, _, _, expired), (_, cls, _) in zip(got, SHORT_LONG.sample_arrivals(tcfg.vocab_size)):
        assert expired or len(gen) == cls.max_new_tokens


def test_block_cache_tables_and_chunks_equal_the_jax_cache(tiny_lm):
    """The same allocate / ensure / page_out / page_in / release sequence:
    free lists and block tables equal after every step, chunks of equal
    shapes whose values agree to the digital model's tolerance."""
    jcfg, tcfg, jparams, tparams = tiny_lm
    jrun = JRunner(jcfg, jparams, max_seq=32, seed=0)
    trun = _runner(tiny_lm)
    jkv = JBlockKV(jcfg, max_batch=2, max_seq=32, block=JBlockConfig(block_size=4, n_blocks=9))
    tkv = BlockKVCache(tcfg, max_batch=2, max_seq=32, block=BlockCacheConfig(block_size=4, n_blocks=9),
                       device="cpu")
    resume = {}

    def both(op, *args):
        out = [getattr(kv, op)(*args) for kv in (jkv, tkv)]
        assert jkv._free == tkv._free and jkv._tables == tkv._tables, op
        return out

    for rid, (slot, n) in enumerate(((0, 6), (1, 11))):
        both("allocate", rid, n)
        req = dict(rid=rid, prompt=_prompt(n, lo=3 * rid + 1), max_new_tokens=4)
        jkv.cache, pos, last, _ = jrun.admit_slot(jkv.cache, slot, JRequest(**req))
        tkv.cache, tpos, tlast, _ = trun.admit_slot(tkv.cache, slot, Request(**req))
        assert (pos, last) == (tpos, tlast)
        resume[rid] = (slot, pos, last)
    assert both("ensure", 0, 9) == [True, True]
    assert both("ensure", 1, 28) == [False, False]  # 3 + 7 of 9 blocks: the pool runs dry
    slot, pos, last = resume[1]
    both("page_out", 1, slot, pos, last)
    assert jkv._swap[1][:2] == tkv._swap[1][:2]
    jchunks, tchunks = jkv._swap[1][2], tkv._swap[1][2]
    assert sorted(jchunks) == sorted(tchunks)
    for name in jchunks:
        assert [c.shape for c in jchunks[name]] == [tuple(c.shape) for c in tchunks[name]]
        for a, b in zip(jchunks[name], tchunks[name]):
            np.testing.assert_allclose(b.numpy(), a, **DIGITAL)
    both("release", 0)
    assert both("page_in", 1, 0) == [(pos, last), (pos, last)]
    jleaves = dict(named_leaves(jkv.cache))
    for name, t in named_leaves(tkv.cache):
        np.testing.assert_allclose(t[:, 0, :pos].numpy(), np.asarray(jleaves[name][:, 0, :pos]), **DIGITAL)
    both("release", 1)
    assert tkv.free_blocks == 9 and not tkv.is_paged(1)


# ---------------------------------------------------------------------------
# xLSTM: a pure-recurrent pool
# ---------------------------------------------------------------------------


def test_xlstm_scheduler_token_identical_to_engine(tiny_xlstm):
    _, tcfg, _, tparams = tiny_xlstm
    work = [(_prompt(7), 5), (_prompt(4, lo=3), 3), (_prompt(9, lo=2), 6)]
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, seed=0, device="cpu")
    for p, n in work:
        eng.submit(p, max_new_tokens=n)
    eng_out = {r.rid: r.generated for r in eng.run_until_done()}
    seen = []
    sched = ContinuousBatchingScheduler(_runner(tiny_xlstm), max_batch=2, stream=lambda r, t: seen.append(r.rid))
    for p, n in work:
        sched.submit(p, max_new_tokens=n)
    out = {r.rid: r.generated for r in sched.run()}
    assert out == eng_out
    assert [len(out[r]) for r in sorted(out)] == [n for _, n in work]
    # the first token comes from prefill and is streamed too
    assert len(seen) == sum(n for _, n in work)


def test_xlstm_request_holds_one_block_and_pages_exactly(tiny_xlstm):
    runner = _runner(tiny_xlstm)
    sched = ContinuousBatchingScheduler(runner, max_batch=2, block=BlockCacheConfig(block_size=4, n_blocks=3))
    kv = sched.kv
    assert not kv.has_seq and kv.blocks_for(1) == kv.blocks_for(1000) == 1
    rid = sched.submit(_prompt(9), max_new_tokens=20)  # 29 tokens: 8 blocks of attention cache
    for _ in range(6):
        sched.step()
    assert kv.table(rid) == (0,) and kv.free_blocks == 2
    slot = sched.slots.index(next(r for r in sched.slots if r is not None))
    want = clone_cache(kv.cache)
    kv.page_out(rid, slot, int(sched.pos[slot]), int(sched.last_tok[slot]))
    assert kv.free_blocks == 3
    kv.page_in(rid, 1 - slot)
    for w, t in zip(cache_leaves(want), cache_leaves(kv.cache)):
        assert torch.equal(w[:, slot], t[:, 1 - slot])
    assert kv.table(rid) == (0,)


@pytest.mark.parametrize("fixture", ["tiny_lm", "tiny_xlstm"])
@pytest.mark.parametrize("S", [5, 33, 47])
def test_prefill_len_is_the_length_admit_slot_prefills(fixture, S, request, monkeypatch):
    """``ModelRunner.prefill_len`` (what a timing of admissions by bucket
    reads) is the length of the prefill ``admit_slot`` runs: the reference's
    bucket capped at ``max_seq`` for attention, the exact length for a
    recurrent model.  An attention model's first admission of a bucket runs
    its ``PrefillGraph``'s warm-up (on a clone) and then the prefill, a second
    one the prefill alone; a recurrent model's each run one eager prefill."""
    runner = _runner(request.getfixturevalue(fixture), max_seq=48)
    seen = []
    real = TM.prefill

    def prefill(params, cfg, tokens, cache):
        seen.append(tokens.shape[1])
        return real(params, cfg, tokens, cache)

    monkeypatch.setattr(TM, "prefill", prefill)
    recurrent = runner.cfg.family in ("ssm", "hybrid")
    for n in ((1, 1) if recurrent else (2, 1)):
        before = len(seen)
        runner.admit_slot(runner.init_cache(1), 0, Request(rid=0, prompt=_prompt(S)))
        assert seen[before:] == [runner.prefill_len(S)] * n
    assert runner.prefill_len(S) == (S if recurrent else min(j_bucket(S), runner.max_seq))
