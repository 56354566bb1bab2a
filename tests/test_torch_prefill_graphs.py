"""PyTorch port, the compiled prefill (``serving.graphs.PrefillGraph``) on the
CPU, where each admission runs eagerly through the same static buffers (the
token buffer and the one-slot cache that every bucket shares, the cache
zeroed at every prefill) and the same warm-up on a clone that the card's
captured graph uses.

``ModelRunner.admit_slot`` against the JAX package's at bucket 32 and at
``max_seq`` (reduced smollm-360m and gemma2-9b, digital and from an ideal
chip the JAX package wrote); a long prompt, a dirtied cache, then a short
prompt in one bucket, equal to an eager prefill on a fresh cache; one graph
per bucket, built once; every chip swap (``age``, ``compensate``,
``hot_swap``, ``refresh``) dropping them, the next admission equal to an
eager prefill on the new chip; no graph for xlstm; the scheduler's schedule
and tokens those of eager admissions."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serving_traffic import SHORT_LONG
from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ModelRunner as JRunner
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import BlockCacheConfig, ContinuousBatchingScheduler, ModelRunner, Request, ServingEngine
from repro_torch.serving import graphs
from repro_torch.serving.graphs import cache_leaves, named_leaves

pytestmark = pytest.mark.serving

# the digital model's values against the JAX package's (tests/test_torch_model.py)
DIGITAL = dict(rtol=1e-4, atol=1e-4)
# a chip's against the JAX package's serving the same chip: float ULPs
# between projections move an input code, and a code a few output LSBs, so
# values are held to the rel-L2 bar of test_torch_model /
# test_torch_dense_families (0.02), as the logits there
CHIP_REL_L2 = 0.02
# buckets 32 and 48 (64 capped at max_seq); 20 tokens run past gemma2's
# reduced window of 16
MAX_SEQ = 48
LENGTHS = (20, 40)


def _carry(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, reduced(get_config(arch)), jparams, tparams


@pytest.fixture(scope="module", params=["smollm-360m", "gemma2-9b"])
def family(request, tmp_path_factory):
    """(jcfg, tcfg, jparams, tparams, store): a reduced config carried across
    and an ideal chip the JAX engine programmed and saved."""
    jcfg, tcfg, jparams, tparams = _carry(request.param)
    store = str(tmp_path_factory.mktemp(request.param))
    jeng = JEngine(jcfg, jparams, max_batch=2, max_seq=MAX_SEQ, crossbar=JMode(enabled=True, strict=True))
    jeng.save_artifacts(store)
    return jcfg, tcfg, jparams, tparams, store


@pytest.fixture(scope="module")
def tiny_lm():
    return _carry("smollm-360m")


def _prompt(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(np.int32)


def _padded(runner, prompt):
    out = np.zeros((1, runner.prefill_len(len(prompt))), np.int64)
    out[0, : len(prompt)] = prompt
    return out


def _eager_prefill(runner, prompt):
    """The admission's prefill as the runner ran it before it was compiled:
    the prompt zero-padded to its bucket, on a fresh one-slot cache."""
    tokens = torch.from_numpy(_padded(runner, prompt))
    cache = runner.init_cache(1)
    logits, _ = runner._with_crossbar(lambda: TM.prefill(runner.params, runner.cfg, tokens, cache))
    return logits, cache


def _assert_close(got, want, chip):
    got, want = np.asarray(got), np.asarray(want)
    if chip:
        assert np.linalg.norm(got - want) <= CHIP_REL_L2 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, **DIGITAL)


def _assert_admission_is_eager(runner, prompt, pool, slot=0):
    """Admit ``prompt`` into ``pool``'s ``slot``: the slot, the graph's cache
    and its logits ``torch.equal`` to an eager prefill on a fresh cache."""
    runner.admit_slot(pool, slot, Request(rid=0, prompt=prompt))
    graph = runner.prefill_graphs[runner.prefill_len(len(prompt))]
    logits, fresh = _eager_prefill(runner, prompt)
    for got, own, want in zip(cache_leaves(pool), cache_leaves(graph.cache), cache_leaves(fresh)):
        assert torch.equal(got[:, slot], want[:, 0])
        assert torch.equal(own, want)
    assert torch.equal(graph.run(_padded(runner, prompt))[0], logits)
    return graph


@pytest.mark.parametrize("chip", ["digital", "ideal_chip"])
def test_admit_slot_equals_the_jax_runner(family, chip):
    """Buckets 32 and max_seq: the returned position and token, the filled
    slot's leaves and the prefill's logits against the JAX runner's (to
    ``DIGITAL``, a chip's to ``CHIP_REL_L2``); the slot is the graph's own
    cache, copied."""
    jcfg, tcfg, jparams, tparams, store = family
    jkw, tkw = {}, {}
    if chip == "ideal_chip":
        jkw = dict(crossbar=JMode(enabled=True, strict=True), restore_artifacts=store)
        tkw = dict(crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=store)
    jrun = JRunner(jcfg, jparams, max_seq=MAX_SEQ, seed=0, **jkw)
    trun = ModelRunner(tcfg, tparams, max_seq=MAX_SEQ, seed=0, device="cpu", **tkw)
    jcache, tcache = jrun.init_cache(2), trun.init_cache(2)
    for slot, S in enumerate(LENGTHS):
        prompt = _prompt(S, seed=slot, vocab=jcfg.vocab_size)
        jcache, *jout = jrun.admit_slot(jcache, slot, JRequest(rid=slot, prompt=prompt))
        tcache, *tout = trun.admit_slot(tcache, slot, Request(rid=slot, prompt=prompt))
        assert tout == jout
        bucket = trun.prefill_len(S)
        graph = trun.prefill_graphs[bucket]
        jleaves = dict(named_leaves(jcache))
        for (name, t), own in zip(named_leaves(tcache), cache_leaves(graph.cache)):
            _assert_close(t[:, slot].numpy(), jleaves[name][:, slot], chip == "ideal_chip")
            assert torch.equal(t[:, slot], own[:, 0])
        padded = _padded(trun, prompt)
        jlogits = jrun._prefill_fn(bucket)(jrun.params, jnp.asarray(padded, jnp.int32), jrun.init_cache(1))[0]
        _assert_close(graph.run(padded)[0].numpy(), jlogits, chip == "ideal_chip")
    assert sorted(trun.prefill_graphs) == [32, MAX_SEQ]


def test_long_then_short_prompt_in_one_bucket_leaves_nothing_behind(family):
    """A full-bucket prompt, then every leaf of the bucket's cache dirtied
    (what any earlier state could leave past the bucket), then a 3-token
    prompt in the same bucket: slot, cache and logits equal to an eager
    prefill on a fresh cache, because each prefill zeroes its cache first."""
    runner = ModelRunner(family[1], family[3], max_seq=MAX_SEQ, seed=0, device="cpu")
    pool = runner.init_cache(2)
    graph = _assert_admission_is_eager(runner, _prompt(32, seed=1), pool)
    for t in cache_leaves(graph.cache):
        t.fill_(7.0)
    assert _assert_admission_is_eager(runner, _prompt(3, seed=2), pool, slot=1) is graph


def test_one_graph_per_bucket_built_once(tiny_lm, monkeypatch):
    """Prompts of 3, 20 and 32 tokens share bucket 32's graph, 40 and 48
    bucket 48's (max_seq): two graphs, each warmed up once, on one token
    buffer and one one-slot cache, each admission (in alternating buckets)
    equal to an eager one; the mapping is read-only; dropping the engine
    frees its runner and graphs at once."""
    _, tcfg, _, tparams = tiny_lm
    built = []
    real = graphs.capture

    def capture(device, run, cache, what):
        built.append(what)
        return real(device, run, cache, what)

    monkeypatch.setattr(graphs, "capture", capture)
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=MAX_SEQ, device="cpu")
    runner, seen = eng.runner, {}
    pool = runner.init_cache(1)
    for S in (3, 20, 40, 32, 48):
        g = _assert_admission_is_eager(runner, _prompt(S, seed=S), pool)
        assert seen.setdefault(g.bucket, g) is g
    assert sorted(seen) == [32, MAX_SEQ] == sorted(runner.prefill_graphs)
    short, full = seen[32], seen[MAX_SEQ]
    assert short.cache is full.cache and short.tokens.data_ptr() == full.tokens.data_ptr()
    assert (short.tokens.shape, full.tokens.shape) == ((1, 32), (1, MAX_SEQ))
    assert built == ["the prefill of bucket 32", "the prefill of bucket 48"]
    assert all(g.graph is None and g.replays == 0 and g.captured == [{}] * 5 for g in seen.values())
    with pytest.raises(TypeError):
        runner.prefill_graphs[64] = seen[32]
    refs = [weakref.ref(x) for x in (runner, *seen.values())]
    del runner, seen, g, short, full
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def life_engine(tiny_lm, tmp_path_factory):
    """A reduced smollm-360m engine on an ideal chip, and a store of its chip
    to hot-swap from.  Every verb swaps the chip through ``_rebind`` on an
    ideal chip too; a drifting chip's values after each swap are held on
    the card (``chip_smoke.py`` ``lifecycle``), where a stale graph would
    read the old chip — here every admission runs eagerly."""
    _, tcfg, _, tparams = tiny_lm
    eng = ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=MAX_SEQ, device="cpu", crossbar=CrossbarMode(enabled=True, strict=True),
    )
    store = str(tmp_path_factory.mktemp("life"))
    eng.save_artifacts(store)
    return eng, store


@pytest.mark.parametrize("verb", ["age", "compensate", "hot_swap", "refresh"])
def test_every_chip_swap_drops_the_prefill_graphs(life_engine, verb):
    """After the swap the runner holds no prefill graph and no decode graph;
    the next admission builds a new graph whose prefill is an eager one on
    the new chip."""
    eng, store = life_engine
    runner = eng.runner
    pool = runner.init_cache(1)
    eng.submit(_prompt(5, seed=3), max_new_tokens=2)
    eng.run_until_done()
    old = [_assert_admission_is_eager(runner, _prompt(S, seed=S), pool) for S in LENGTHS]
    assert runner.decode_graph is not None and len(runner.prefill_graphs) == 2
    chip = runner.programmed
    {"age": lambda: eng.age(1e6), "compensate": eng.compensate,
     "hot_swap": lambda: eng.hot_swap(store), "refresh": eng.refresh}[verb]()
    assert runner.programmed is not chip
    assert not runner.prefill_graphs and runner.decode_graph is None
    new = _assert_admission_is_eager(runner, _prompt(LENGTHS[0], seed=4), pool)
    assert all(new is not g for g in old) and list(runner.prefill_graphs) == [32]


def test_xlstm_keeps_no_prefill_graph():
    """A recurrent model prefills each prompt eagerly at its exact length:
    no graph, the slot equal to an eager prefill, the first token sampled
    from its logits."""
    _, tcfg, _, tparams = _carry("xlstm-350m")
    runner = ModelRunner(tcfg, tparams, max_seq=MAX_SEQ, seed=0, device="cpu")
    pool = runner.init_cache(1)
    for S in (5, 20):
        prompt = _prompt(S, seed=S)
        _, pos, last, first = runner.admit_slot(pool, 0, Request(rid=0, prompt=prompt))
        logits, fresh = _eager_prefill(runner, prompt)
        assert (pos, last) == (S, first) and first == int(runner.sample(logits.numpy())[0])
        for got, want in zip(cache_leaves(pool), cache_leaves(fresh)):
            assert torch.equal(got[:, 0], want[:, 0])
        assert not runner.prefill_graphs


def test_scheduler_schedule_and_tokens_equal_eager_admissions(tiny_lm, monkeypatch):
    """``SHORT_LONG`` at arrival with deadlines on a pool that preempts:
    the schedule (admissions, preemptions, expirations, finishes) and every
    token equal to the same run whose admissions prefill eagerly on a fresh
    cache, as the runner did before its prefill was compiled."""
    _, tcfg, _, tparams = tiny_lm

    def eager_admit(runner, cache, slot, req):
        S = runner.check_prompt(req.prompt, req.truncate)
        _, filled = _eager_prefill(runner, np.asarray(req.prompt)[:S])
        for big, one in zip(cache_leaves(cache), cache_leaves(filled)):
            big[:, slot] = one[:, 0]
        return cache, S - 1, int(np.asarray(req.prompt)[S - 1]), None

    def serve(eager):
        runner = ModelRunner(tcfg, tparams, max_seq=MAX_SEQ, seed=0, device="cpu")
        if eager:
            monkeypatch.setattr(runner, "admit_slot", lambda *a: eager_admit(runner, *a))
        sched = ContinuousBatchingScheduler(runner, max_batch=4, block=BlockCacheConfig(block_size=4, n_blocks=10))
        preempted = []
        real = sched._preempt
        sched._preempt = lambda slot: preempted.append(slot) or real(slot)
        queue = list(SHORT_LONG.sample_arrivals(tcfg.vocab_size))
        while queue or sched.load:
            while queue and queue[0][0] <= sched.tick:
                _, cls, prompt = queue.pop(0)
                sched.submit(prompt, max_new_tokens=cls.max_new_tokens, deadline=4 if cls.name == "short" else None)
            sched.step()
        done = sorted({**sched.completed, **sched.expired}.values(), key=lambda r: r.rid)
        return [(r.rid, r.generated, r.arrival, r.finish, r.expired) for r in done], preempted, runner

    got, preempted, runner = serve(eager=False)
    want, want_preempted, _ = serve(eager=True)
    assert sorted(runner.prefill_graphs) == [32]
    assert preempted == want_preempted and preempted
    assert got == want and any(r[4] for r in got)
