"""PyTorch port, multi-head latent attention (deepseek-v2) against the JAX
package: the absorbed MLA block with and without its latent cache (a prefill
scored against the whole cache, a chunked 512-token prompt, per-slot decode
positions), the model's tree, cache axes and artifact names, its entry
points, the engine's greedy tokens from an ideal chip the JAX engine
programmed, the block pool's paging of the latents, the scheduler under a
preemption, and the compiled prefill and tick's CPU path.

Every model is the reduced deepseek-v2 (float32, kv_lora_rank 32, rope dim
16, 8 experts, top 2), its params carried from the JAX package by
``params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_serving import carry, fresh_engine, same_tokens
from repro import configs as jconfigs
from repro.device import programmed as jprog
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_to_numpy
from repro_torch.device import programmed as tprog
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import BlockCacheConfig, BlockKVCache, ContinuousBatchingScheduler, ModelRunner, Request
from repro_torch.serving import ServingEngine
from repro_torch.serving.graphs import cache_leaves, named_leaves
from repro_torch.tree import flatten

DEEPSEEK = "deepseek-v2-236b"
BLOCK = 1e-5  # max |d| / max |y| of one block or cache
LOGITS = 1e-4  # of a whole model's logits
# Prompt seeds of the ideal-chip token test.  On a chip the two packages'
# logits part by a few head LSBs (on the CPU, max |d| / max |logit| 0.010 on
# a 2 x 16 forward, against 0.020 for reduced kimi-k2 and 0.013 for reduced
# smollm-360m), and a random reduced model's top-2 margins are often of
# that size: over seeds 0-39 the tokens differed in 6, each where a margin
# was below the discrepancy.  The seeds below have a smallest margin 3.18x /
# 5.09x the discrepancy; same_tokens fails the test if that stops holding.
CHIP_SEEDS = (30, 32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its reduced model's ops are
    tiny, and a pool of threads a test worker spins against the other
    workers' on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    jcfg = jconfigs.reduced(jconfigs.get_config(DEEPSEEK))
    return (jcfg, reduced(get_config(DEEPSEEK))) + carry(jcfg)


@pytest.fixture(scope="module")
def mixers(ds):
    """Layer 0's MLA mixer in both packages."""
    _, _, jparams, tparams = ds
    jm = jax.tree.map(lambda a: a[0], jparams["stage0"]["b0"]["mixer"])
    tm = {k: v[0] for k, v in tparams["stage0"]["b0"]["mixer"].items()}
    return jm, tm


@pytest.fixture(scope="module")
def jax_chip(ds, tmp_path_factory):
    """An ideal chip of the reduced deepseek programmed and saved by the JAX
    engine, and that engine."""
    jcfg, _, jparams, _ = ds
    d = str(tmp_path_factory.mktemp("deepseek-ideal"))
    eng = JEngine(jcfg, jparams, max_batch=2, max_seq=64, crossbar=JMode(enabled=True, strict=True))
    eng.save_artifacts(d)
    return d, eng


# the reference's block as one compiled program (its ops one by one cost more)
_j_block = jax.jit(JA.attention_block, static_argnums=(2, 3))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _x(rng, B, S, D):
    return rng.normal(size=(B, S, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [8, 512])
def test_block_without_a_cache(ds, mixers, S):
    """S = 8 in one query block; S = 512 walks two chunks of ``Q_CHUNK``."""
    jcfg, tcfg, _, _ = ds
    jm, tm = mixers
    x = _x(np.random.default_rng(S), 2, S, tcfg.d_model)
    yj, cj = _j_block(jm, jnp.asarray(x), jcfg, "attn", jnp.arange(S))
    yt, ct = TA.attention_block(tm, torch.from_numpy(x), tcfg, "attn", torch.arange(S))
    assert cj is None and ct is None
    assert yt.shape == yj.shape and _rel(yj, yt.numpy()) <= BLOCK


def test_block_prefill_then_per_slot_decode(ds, mixers):
    """A 5-token prefill into a 16-position cache (scored against the whole
    cache, the rest masked), then one decode step with each slot at its own
    position: outputs and both cache leaves."""
    jcfg, tcfg, _, _ = ds
    jm, tm = mixers
    rng = np.random.default_rng(1)
    cj = JA.init_attention_cache(jcfg, 3, 16, jnp.float32)
    ct = TA.init_attention_cache(tcfg, 3, 16, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in ct.items()} == {k: v.shape for k, v in cj.items()}
    x = _x(rng, 3, 5, tcfg.d_model)
    yj, cj = _j_block(jm, jnp.asarray(x), jcfg, "attn", jnp.arange(5), cj)
    yt, ct = TA.attention_block(tm, torch.from_numpy(x), tcfg, "attn", torch.arange(5), ct)
    assert _rel(yj, yt.numpy()) <= BLOCK
    for n in ("latent", "k_rope"):
        assert _rel(cj[n], ct[n].numpy()) <= BLOCK, n
    pos = np.array([3, 7, 12])
    xd = _x(rng, 3, 1, tcfg.d_model)
    yj, cj = _j_block(jm, jnp.asarray(xd), jcfg, "attn", jnp.asarray(pos)[:, None], cj, jnp.asarray(pos))
    yt, ct = TA.attention_block(
        tm, torch.from_numpy(xd), tcfg, "attn", torch.from_numpy(pos)[:, None], ct, torch.from_numpy(pos)
    )
    assert _rel(yj, yt.numpy()) <= BLOCK
    for n in ("latent", "k_rope"):
        assert _rel(cj[n], ct[n].numpy()) <= BLOCK, n


def test_block_prefill_scores_against_the_whole_cache(ds, mixers):
    """The reference scores a prefill against the whole cache: a stale
    entry past the prompt is masked, so it changes nothing, and the prompt's
    latents land at the front."""
    _, tcfg, _, _ = ds
    _, tm = mixers
    x = torch.from_numpy(_x(np.random.default_rng(2), 1, 4, tcfg.d_model))
    clean = TA.init_attention_cache(tcfg, 1, 16, torch.float32, "cpu")
    stale = {k: torch.full_like(v, 3.0) for k, v in clean.items()}
    y0, c0 = TA.attention_block(tm, x, tcfg, "attn", torch.arange(4), clean)
    y1, c1 = TA.attention_block(tm, x, tcfg, "attn", torch.arange(4), stale)
    assert torch.equal(y0, y1)
    assert torch.equal(c0["latent"][:, :4], c1["latent"][:, :4])
    assert torch.equal(c1["latent"][:, 4:], torch.full_like(c1["latent"][:, 4:], 3.0))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_tree_axes_and_artifact_names_equal_the_reference(ds):
    jcfg, tcfg, jparams, _ = ds
    ours = TM.init_model(tcfg, 0, device="cpu")
    theirs = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: tuple(v.shape) for k, v in flatten(ours).items()} == theirs
    assert TM.cache_axes(tcfg) == JM.cache_axes(jcfg)
    axes = dict(named_leaves(TM.cache_axes(tcfg)))
    leaves = dict(named_leaves(TM.init_cache(tcfg, 2, 8, device="cpu")))
    assert sorted(axes) == sorted(leaves) and all(len(axes[n]) == leaves[n].ndim for n in leaves)
    assert leaves["0/b0/latent"].shape == (1, 2, 8, tcfg.kv_lora_rank)
    names = tprog.expected_artifact_names(ours)
    assert names == {k: tuple(v) for k, v in jprog.expected_artifact_names(jparams).items()}
    assert "stage0/b0/mixer/w_kv_down" in names
    assert not any(n.endswith(("w_uk", "w_uv")) for n in names)


def test_convert_carries_the_reference_tree_both_ways(ds):
    """``params_from_numpy`` carries every leaf of the reference's deepseek
    tree (MLA's ``w_uk`` / ``w_uv`` and the expert banks included) by name,
    bit for bit, and ``tree_to_numpy`` gives it back."""
    _, _, jparams, tparams = ds
    theirs = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    ours = flatten(tparams)
    back = flatten(tree_to_numpy(tparams))
    assert sorted(ours) == sorted(theirs) and "stage1/b0/mixer/w_uk" in ours
    for name, a in theirs.items():
        assert np.array_equal(ours[name].numpy(), a) and np.array_equal(back[name], a), name


def test_forward_prefill_and_decode_logits(ds):
    jcfg, tcfg, jparams, tparams = ds
    # one compiled program each (the reference's ops one by one cost more)
    j_forward, j_prefill, j_decode = (jax.jit(f, static_argnums=1) for f in (JM.forward, JM.prefill, JM.decode_step))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, tcfg.vocab_size, size=(2, 8))
    assert _rel(j_forward(jparams, jcfg, jnp.asarray(tok)), TM.forward(tparams, tcfg, torch.from_numpy(tok)).numpy()) <= LOGITS
    cj = JM.init_cache(jcfg, 2, 16, jnp.float32)
    ct = TM.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    lj, cj = j_prefill(jparams, jcfg, jnp.asarray(tok), cj)
    lt, ct = TM.prefill(tparams, tcfg, torch.from_numpy(tok), ct)
    assert _rel(lj, lt.numpy()) <= LOGITS
    pos = np.array([8, 8])
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab_size, size=(2, 1))
        lj, cj = j_decode(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos + step), cj)
        lt, ct = TM.decode_step(tparams, tcfg, torch.from_numpy(nxt), torch.from_numpy(pos + step), ct)
        assert _rel(lj, lt.numpy()) <= LOGITS, step
    ours = dict(named_leaves(ct))
    for n, a in named_leaves(cj):
        assert _rel(a, ours[n].numpy()) <= LOGITS, n


@pytest.mark.parametrize("seed", CHIP_SEEDS)
def test_greedy_tokens_from_a_jax_programmed_ideal_chip(ds, jax_chip, seed):
    """The port restores the chip the JAX engine programmed (w_kv_down among
    its artifacts) and serves the JAX engine's tokens, with no miss."""
    _, tcfg, _, tparams = ds
    d, jeng = jax_chip
    TL.reset_crossbar_misses()
    te = ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=64, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=d,
    )
    assert "stage1/b0/mixer/w_kv_down" in te.programmed.by_name
    same_tokens(fresh_engine(jeng), te, tcfg.vocab_size, seed)
    assert TL.crossbar_misses() == ()


# ---------------------------------------------------------------------------
# Serving: the block pool, the scheduler, the compiled paths
# ---------------------------------------------------------------------------


def _prompt(n, lo=1):
    return (np.arange(lo, lo + n) % 60 + 1).astype(np.int32)


def test_block_pool_pages_the_latents_exactly(ds):
    _, tcfg, _, tparams = ds
    runner = ModelRunner(tcfg, tparams, max_seq=32, device="cpu")
    kv = BlockKVCache(tcfg, max_batch=2, max_seq=32, block=BlockCacheConfig(block_size=4), device="cpu")
    assert sorted(n.split("/")[-1] for n, _ in named_leaves(kv.cache)) == ["k_rope", "k_rope", "latent", "latent"]
    kv.allocate(0, 6)
    kv.cache, pos, last, _ = runner.admit_slot(kv.cache, 0, Request(0, _prompt(6), max_new_tokens=4))
    want = [t[:, 0].clone() for t in cache_leaves(kv.cache)]
    kv.page_out(0, 0, pos, last)
    for t in cache_leaves(kv.cache):
        t[:, 0] = -1.0
    assert kv.page_in(0, 1) == (pos, last)
    for w, t in zip(want, cache_leaves(kv.cache)):
        assert torch.equal(w[:, :pos], t[:, 1, :pos])


def test_scheduler_with_a_preemption_serves_the_slot_loops_tokens(ds):
    _, tcfg, _, tparams = ds
    sched = ContinuousBatchingScheduler(
        ModelRunner(tcfg, tparams, max_seq=48, device="cpu"), max_batch=2,
        block=BlockCacheConfig(block_size=4, n_blocks=4),
    )
    preempted = []
    real = sched._preempt

    def spy(*a, **kw):
        preempted.append(a)
        return real(*a, **kw)

    sched._preempt = spy
    for p in (_prompt(6), _prompt(8, lo=2)):
        sched.submit(p, max_new_tokens=8)
    out = {r.rid: r.generated for r in sched.run()}
    assert preempted
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=48, device="cpu")
    for p in (_prompt(6), _prompt(8, lo=2)):
        eng.submit(p, max_new_tokens=8)
    assert out == {r.rid: r.generated for r in eng.run_until_done()}


def test_compiled_prefill_and_tick_paths_serve_the_eager_tokens(ds):
    """The engine's admissions go through its bucket's prefill graph and its
    ticks through the pool's decode graph (eager on the CPU, on their shared
    buffers): the tokens, and every tick's logits, of the model's entry
    points run by hand on a zero-padded prompt."""
    _, tcfg, _, tparams = ds
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, size=9)
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=32, device="cpu")
    eng.submit(prompt, max_new_tokens=4)
    got = eng.run_until_done()[0].generated
    assert sorted(eng.runner.prefill_graphs) == [32] and eng.runner.decode_graph is not None
    cache = TM.init_cache(tcfg, 1, 32, dtype=torch.float32, device="cpu")
    padded = np.zeros((1, 32), np.int64)
    padded[0, :9] = prompt
    TM.prefill(tparams, tcfg, torch.from_numpy(padded), cache)
    tok, pos, want = int(prompt[-1]), 8, []
    for _ in range(4):
        logits, _ = TM.decode_step(tparams, tcfg, torch.tensor([[tok]]), torch.tensor([pos]), cache)
        tok, pos = int(torch.argmax(logits[0])), pos + 1
        want.append(tok)
    assert got == want
