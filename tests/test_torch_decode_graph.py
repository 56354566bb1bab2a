"""PyTorch port, the compiled decode tick (``serving.graphs.DecodeGraph``) on
the CPU, where it runs each tick eagerly through the same static buffers and
the same warm-up on a clone that the card's captured graph uses: the tick
against ``decode_step`` on a cloned cache, the warm-up leaving the live pool
alone, re-keying on another cache, the launch counters, and greedy tokens
against the JAX package's engine.  Models: reduced smollm-360m and
xlstm-350m in float32, digital and from chips the JAX package programmed."""
import gc
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import save_programmed as j_save
from repro.device import DeviceConfig as JDev
from repro.device.programmed import program_model as j_program_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig as TDev
from repro_torch.kernels import crossbar_vmm as tk
from repro_torch.kernels import slstm_scan as tscan
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ModelRunner, Request, ServingEngine
from repro_torch.serving import graphs

NOISY = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (jcfg, tcfg, jparams, tparams)} and the JAX-written stores
    {"smollm_ideal", "smollm_noisy", "xlstm_ideal"}."""
    archs = {}
    for arch, name in (("smollm", "smollm-360m"), ("xlstm", "xlstm-350m")):
        jcfg = jconfigs.reduced(jconfigs.get_config(name))
        jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        archs[arch] = (jcfg, reduced(get_config(name)), jparams, tparams)
    stores = {}
    for key, arch, dev in (
        ("smollm_ideal", "smollm", None), ("smollm_noisy", "smollm", JDev(**NOISY)), ("xlstm_ideal", "xlstm", None),
    ):
        d = str(tmp_path_factory.mktemp(key))
        j_save(d, j_program_model(archs[arch][2], device=dev, tie_lm_head=True))
        stores[key] = d
    return archs, stores


# (arch, store, port CrossbarMode kwargs): a case of the served paths
CASES = {
    "digital": ("smollm", None, None),
    "ideal_chip": ("smollm", "smollm_ideal", {}),
    "noisy_chip": ("smollm", "smollm_noisy", dict(device=TDev(**NOISY))),
    "xlstm": ("xlstm", None, None),
    "xlstm_ideal_chip": ("xlstm", "xlstm_ideal", {}),
}


def _engine_kw(models, case):
    archs, stores = models
    arch, store, mode = CASES[case]
    kw = {}
    if store is not None:
        kw = dict(crossbar=CrossbarMode(enabled=True, strict=True, **mode), restore_artifacts=stores[store])
    return archs[arch], kw


def _eager_tick(runner, last_tok, pos, cache):
    """The tick as the runner ran it before it was compiled: decode_step
    under the runner's crossbar mode, on the cache it is given."""
    toks = torch.from_numpy(np.asarray(last_tok, np.int64)[:, None])
    pos_t = torch.from_numpy(np.asarray(pos, np.int64))
    logits, _ = runner._with_crossbar(lambda: TM.decode_step(runner.params, runner.cfg, toks, pos_t, cache))
    return logits.to(torch.float32)


def _assert_caches_equal(got, ref):
    a, b = graphs.cache_leaves(got), graphs.cache_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _admitted_runner(models, case, prompts, batch=2):
    (_, tcfg, _, tparams), kw = _engine_kw(models, case)
    runner = ModelRunner(tcfg, tparams, max_seq=32, device="cpu", **kw)
    cache = runner.init_cache(batch)
    last, pos = np.zeros(batch, np.int64), np.zeros(batch, np.int64)
    for slot, prompt in enumerate(prompts):
        cache, pos[slot], last[slot], _ = runner.admit_slot(cache, slot, Request(slot, prompt))
    return runner, cache, last, pos


@pytest.mark.parametrize("case", list(CASES))
def test_tick_equals_eager_decode_step_on_a_cloned_cache(models, case):
    """Every tick of a served run: logits and the whole cache bit-equal to
    ``decode_step`` run on a clone of the cache the tick started from.  Three
    requests on two slots, so a slot frees and is refilled between ticks."""
    (_, tcfg, _, tparams), kw = _engine_kw(models, case)
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", **kw)
    runner = eng.runner
    real = runner.decode
    graphs_seen = []

    def checked(last_tok, pos, cache):
        ref_cache = graphs.clone_cache(cache)
        ref = _eager_tick(runner, last_tok, pos, ref_cache)
        logits, cache = real(last_tok, pos, cache)
        assert torch.equal(torch.from_numpy(logits), ref)
        _assert_caches_equal(cache, ref_cache)
        graphs_seen.append(runner.decode_graph)
        return logits, cache

    runner.decode = checked
    rng = np.random.default_rng(11)
    for n_new in (4, 7, 5):
        eng.submit(rng.integers(0, 256, size=int(rng.integers(3, 10))), max_new_tokens=n_new)
    done = eng.run_until_done()
    assert [len(r.generated) for r in done] == [4, 7, 5]
    assert len(graphs_seen) >= 6
    # one tick object for the pool, built once; on the CPU nothing replays
    assert all(g is graphs_seen[0] for g in graphs_seen)
    assert graphs_seen[0].cache is eng.cache and graphs_seen[0].replays == 0


@pytest.mark.parametrize("case", ["ideal_chip", "xlstm_ideal_chip"])
def test_warm_up_runs_on_a_clone_and_leaves_the_live_pool_alone(models, case, monkeypatch):
    """The first tick runs decode_step twice — the warm-up on a clone, then
    the tick on the live cache — and the live cache ends exactly one
    reference step on: the xLSTM state advanced once, the attention cache
    written once, at each slot's position and nowhere else."""
    arch = CASES[case][0]
    runner, cache, last, pos = _admitted_runner(models, case, [np.arange(5) + 3, np.arange(8) + 40])
    before = graphs.clone_cache(cache)
    live = graphs.cache_leaves(cache)[0].data_ptr()
    seen = []
    real = TM.decode_step

    def spy(params, cfg, inp, p, c):
        seen.append(graphs.cache_leaves(c)[0].data_ptr())
        return real(params, cfg, inp, p, c)

    monkeypatch.setattr(TM, "decode_step", spy)
    last = (last + 1) % 256  # not the prompt's last token: the write shows
    logits, cache = runner.decode(last, pos, cache)
    assert len(seen) == 2 and seen[0] != live and seen[1] == live
    monkeypatch.setattr(TM, "decode_step", real)
    ref = graphs.clone_cache(before)
    assert torch.equal(torch.from_numpy(logits), _eager_tick(runner, last, pos, ref))
    _assert_caches_equal(cache, ref)
    if arch == "smollm":
        for name in ("k", "v"):
            new, old = cache[0]["b0"][name], before[0]["b0"][name]
            written = torch.zeros(new.shape[1:3], dtype=torch.bool)
            written[torch.arange(2), torch.from_numpy(pos)] = True
            assert torch.equal(new[:, ~written], old[:, ~written])
            assert not torch.equal(new[:, written], old[:, written])
    else:
        for b, names in (("b0", "Cn"), ("b1", "cnh")):
            for n in names:
                assert not torch.equal(cache[0][b][n], before[0][b][n])
    monkeypatch.setattr(TM, "decode_step", spy)
    runner.decode(last, pos + 1, cache)
    assert len(seen) == 3 and seen[2] == live  # built once: no second warm-up


def test_a_second_cache_rekeys_and_stays_correct(models):
    """One graph per runner: a decode with another cache drops it and builds
    one for that cache; going back re-keys again; every tick stays equal to
    the eager tick."""
    runner, cache_a, last_a, pos_a = _admitted_runner(models, "ideal_chip", [np.arange(6), np.arange(4) + 9])
    _, cache_b, last_b, pos_b = _admitted_runner(models, "ideal_chip", [np.arange(9) + 100, np.arange(3) + 7])
    built = []
    for cache, last, pos in ((cache_a, last_a, pos_a), (cache_b, last_b, pos_b), (cache_a, last_a + 1, pos_a + 1)):
        ref_cache = graphs.clone_cache(cache)
        ref = _eager_tick(runner, last, pos, ref_cache)
        logits, cache = runner.decode(last, pos, cache)
        assert torch.equal(torch.from_numpy(logits), ref)
        _assert_caches_equal(cache, ref_cache)
        graph = runner.decode_graph
        assert graph.cache is cache and graph.serves(cache)
        built.append(graph)
    assert built[0] is not built[1] and built[1] is not built[2]
    assert not built[1].serves(cache_a) and built[2].serves(cache_a)


@pytest.mark.parametrize("case,per_tick", [
    ("ideal_chip", {"crossbar": 2 * 6 + 1}), ("noisy_chip", {"noisy": 2 * 6 + 1}),
    ("xlstm_ideal_chip", {"crossbar": 1, "slstm_scan": 1}),
])
def test_counters_count_served_ticks_not_the_warm_up(models, case, per_tick):
    """The warm-up's wrapper calls are taken back: after n ticks the counters
    hold n ticks' worth (2 layers x 6 projections + the head a smollm tick;
    the head and one sLSTM layer an xlstm tick)."""
    runner, cache, last, pos = _admitted_runner(models, case, [np.arange(5), np.arange(7) + 2])
    tk.reset_counters()
    tscan.reset_counters()
    for t in range(3):
        runner.decode(last, pos + t, cache)
    calls = dict(tk.PLAIN_CALLS, **tscan.PLAIN_CALLS)
    assert calls == {k: 3 * per_tick.get(k, 0) for k in calls}
    assert sum(tk.LAUNCHES.values()) + sum(tscan.LAUNCHES.values()) == 0


def test_a_dropped_engine_is_freed_at_once(models):
    """The runner holds its graph and the graph holds the runner weakly, so
    dropping an engine frees the runner and its chip without waiting for the
    cycle collector."""
    (_, tcfg, _, tparams), kw = _engine_kw(models, "ideal_chip")
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", **kw)
    eng.submit(np.arange(5), max_new_tokens=3)
    eng.run_until_done()
    assert eng.runner.decode_graph is not None
    runner, graph = weakref.ref(eng.runner), weakref.ref(eng.runner.decode_graph)
    gc.disable()
    try:
        del eng
        assert runner() is None and graph() is None
    finally:
        gc.enable()


def test_credit_launches_adds_the_captured_counts_per_replay():
    tk.reset_counters()
    tscan.reset_counters()
    captured = [{"fast": 193}, {}, {"slstm_scan": 12}, {}]
    for _ in range(3):
        graphs.credit_launches(captured)
    assert tk.LAUNCHES == {"fast": 579, "planes": 0, "noisy": 0}
    assert tscan.LAUNCHES == {"slstm_scan": 36, "slstm_scan_save": 0, "slstm_scan_bwd": 0}
    assert sum(tk.PLAIN_CALLS.values()) + sum(tscan.PLAIN_CALLS.values()) == 0
    tk.reset_counters()
    tscan.reset_counters()


def _greedy(models, case, prompts, max_new):
    """Tokens of both engines for one admission order, and each engine's
    active-slot logits at every tick."""
    archs, stores = models
    arch, store, _ = CASES[case]
    jcfg, _, jparams, _ = archs[arch]
    jkw = {}
    if store is not None:
        jkw = dict(crossbar=JL.CrossbarMode(enabled=True, strict=True), restore_artifacts=stores[store])
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=32, **jkw)
    (_, tcfg, _, tparams), tkw = _engine_kw(models, case)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", **tkw)
    logits = []
    for eng in (je, te):
        ticks = []
        real = eng.runner.sample

        def sample(out, eng=eng, ticks=ticks, real=real):
            ticks.append(np.array(out[[i for i, s in enumerate(eng.slots) if s is not None]]))
            return real(out)

        eng.runner.sample = sample
        logits.append(ticks)
    for p in prompts:
        assert je.submit(p, max_new_tokens=max_new) == te.submit(p, max_new_tokens=max_new)
    jr, tr = je.run_until_done(), te.run_until_done()
    assert te.runner.decode_graph.cache is te.cache  # the ticks ran through the pool's graph
    return [r.generated for r in jr], [r.generated for r in tr], logits


def test_greedy_tokens_equal_the_jax_engine_on_the_ideal_chip(models):
    """smollm from the JAX-programmed ideal chip (the prompts of
    test_torch_serving's seed 0): tokens identical, where at every tick the
    top-2 margin covers twice the engines' largest logit difference."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=int(rng.integers(3, 12))) for _ in range(3)]
    jtok, ttok, (jt, tt) = _greedy(models, "ideal_chip", prompts, max_new=5)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        top = np.sort(b, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() > 2 * np.abs(a - b).max()
    assert ttok == jtok and all(len(t) == 5 for t in ttok)


def test_greedy_tokens_equal_the_jax_engine_on_xlstm(models):
    """xlstm from the JAX-programmed head: the first 4 tokens of each request
    (late near-ties on random recurrent weights can flip under float
    reorders, as test_torch_xlstm says)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n) for n in (7, 4, 9)]
    jtok, ttok, _ = _greedy(models, "xlstm_ideal_chip", prompts, max_new=6)
    assert all(len(t) == 6 for t in ttok)
    assert [t[:4] for t in ttok] == [t[:4] for t in jtok]
