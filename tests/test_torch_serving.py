"""PyTorch port, serving: greedy token identity with the JAX package's
``ServingEngine`` for the same admission order, and the engine's request
lifecycle (completion ledger, over-length prompts, artifact restore)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.device import DeviceConfig as JDev
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import _bucket as j_bucket
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import programmed as tprog
from repro_torch.kernels import crossbar_vmm as tk
from repro_torch.models import layers as TL
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ModelRunner, Request, ServingEngine
from repro_torch.serving.engine import _bucket

NOISY = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    tcfg = reduced(get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def jax_stores(tiny_lm, tmp_path_factory):
    """Artifact stores written by the JAX engine: an ideal and a noisy chip."""
    jcfg, _, jparams, _ = tiny_lm
    out = {}
    for name, dev in (("ideal", None), ("noisy", JDev(**NOISY))):
        d = str(tmp_path_factory.mktemp(name))
        JEngine(
            jcfg, jparams, max_batch=2, max_seq=32,
            crossbar=JMode(enabled=True, strict=True, device=dev),
        ).save_artifacts(d)
        out[name] = d
    return out


def _prompts(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 12))) for _ in range(n)]


def _spy(eng):
    """Record the active slots' logits at every decode tick."""
    ticks = []
    real = eng.runner.sample

    def sample(logits):
        active = [i for i, s in enumerate(eng.slots) if s is not None]
        ticks.append(np.array(logits[active]))
        return real(logits)

    eng.runner.sample = sample
    return ticks


def _serve_both(tiny_lm, seed, jkw, tkw, max_new=5):
    jcfg, tcfg, jparams, tparams = tiny_lm
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=32, **jkw)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", **tkw)
    jt, tt = _spy(je), _spy(te)
    for p in _prompts(seed):
        assert je.submit(p, max_new_tokens=max_new) == te.submit(p, max_new_tokens=max_new)
    jr, tr = je.run_until_done(), te.run_until_done()
    return [r.generated for r in jr], [r.generated for r in tr], jt, tt


def _assert_margins_cover_the_discrepancy(jt, tt):
    """Greedy identity is only meaningful where the decision is not a coin
    toss: at every tick the top-2 logit margin (in both engines) must exceed
    twice the largest logit difference between the engines."""
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        gap = np.abs(a - b).max()
        top_a, top_b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        margin = min((top_a[:, -1] - top_a[:, -2]).min(), (top_b[:, -1] - top_b[:, -2]).min())
        assert margin > 2 * gap, (margin, gap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digital_greedy_tokens_identical_to_jax_engine(tiny_lm, seed):
    jtok, ttok, jt, tt = _serve_both(tiny_lm, seed, {}, {})
    _assert_margins_cover_the_discrepancy(jt, tt)
    assert ttok == jtok
    assert all(len(t) == 5 for t in ttok)


@pytest.mark.parametrize("seed", [0, 14, 22])
def test_ideal_chip_greedy_tokens_identical_to_jax_engine(tiny_lm, jax_stores, seed):
    """Both engines restore the chip the JAX engine programmed.  The seeds
    are ones whose smallest top-2 margin is 3.7x, 5.4x and 4.2x the engines'
    largest logit discrepancy (tokens were identical on all of seeds 0..23;
    these are the ones where identity is guaranteed rather than lucky); the
    margin check fails the test if that stops holding."""
    TL.reset_crossbar_misses()
    tk.reset_counters()
    jtok, ttok, jt, tt = _serve_both(
        tiny_lm, seed,
        dict(crossbar=JMode(enabled=True, strict=True), restore_artifacts=jax_stores["ideal"]),
        dict(crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=jax_stores["ideal"]),
    )
    _assert_margins_cover_the_discrepancy(jt, tt)
    assert ttok == jtok
    assert TL.crossbar_misses() == ()
    # on CPU tensors the wrappers take the plain versions and launch nothing
    assert tk.PLAIN_CALLS["crossbar"] > 0 and sum(tk.LAUNCHES.values()) == 0


def test_noisy_chip_serves_from_jax_store_and_first_tokens_agree(tiny_lm, jax_stores):
    """The noisy chip's conversion noise makes later tokens sensitive to
    float ULPs upstream (see test_torch_model); the first decode tick of the
    first wave sees identical prompts, and where its margin covers the
    discrepancy the tokens must agree."""
    kw = dict(strict=True, enabled=True)
    jtok, ttok, jt, tt = _serve_both(
        tiny_lm, 0,
        dict(crossbar=JMode(device=JDev(**NOISY), **kw), restore_artifacts=jax_stores["noisy"]),
        dict(crossbar=CrossbarMode(device=TDev(**NOISY), **kw), restore_artifacts=jax_stores["noisy"]),
    )
    assert all(len(t) == 5 and all(0 <= x < 256 for x in t) for t in ttok)
    gap = np.abs(jt[0] - tt[0]).max()
    top = np.sort(tt[0], axis=-1)
    for slot, margin in enumerate(top[:, -1] - top[:, -2]):
        if margin > 2 * gap:
            assert ttok[slot][0] == jtok[slot][0]
    assert tk.PLAIN_CALLS["noisy"] > 0


def test_engine_programs_its_own_chip_and_restores_it(tiny_lm, tmp_path):
    _, tcfg, _, tparams = tiny_lm
    mode = CrossbarMode(enabled=True, strict=True, device=TDev(**NOISY))

    def serve(**kw):
        eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", crossbar=mode, **kw)
        for p in _prompts(3):
            eng.submit(p, max_new_tokens=4)
        return eng, [r.generated for r in eng.run_until_done()]

    eng, tokens = serve()
    assert eng.programmed.n_compiled == 7 and all(a.noisy for a in eng.programmed.by_name.values())
    eng.save_artifacts(str(tmp_path))
    eng2, tokens2 = serve(restore_artifacts=str(tmp_path))
    assert tokens2 == tokens
    for name, art in eng.programmed.by_name.items():
        assert tprog.artifacts_equal(art, eng2.programmed.by_name[name])
    # the slotted layout needs its ACTIVE pointer; an explicit prebuilt chip works
    eng3 = ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=32, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True, programmed=eng.programmed),
    )
    assert eng3.programmed is eng.programmed


def test_restore_refusals(tiny_lm, jax_stores, tmp_path):
    _, tcfg, _, tparams = tiny_lm
    kw = dict(max_batch=1, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="needs crossbar serving"):
        ServingEngine(tcfg, tparams, restore_artifacts=jax_stores["ideal"], **kw)
    chip = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    with pytest.raises(ValueError, match="one source of truth"):
        ServingEngine(
            tcfg, tparams, restore_artifacts=jax_stores["ideal"],
            crossbar=CrossbarMode(enabled=True, programmed=chip), **kw,
        )
    # a directory without a store fails verification before anything loads
    with pytest.raises(ValueError, match=r"\[store\] no programmed-artifact store"):
        ServingEngine(tcfg, tparams, restore_artifacts=str(tmp_path), crossbar=CrossbarMode(enabled=True), **kw)
    # a store from another model: names or shapes do not match
    import dataclasses
    from repro_torch.models import model as TM

    other_cfg = dataclasses.replace(tcfg, d_ff=64)
    other = TM.init_model(other_cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not match this model"):
        ServingEngine(
            other_cfg, other, restore_artifacts=jax_stores["ideal"],
            crossbar=CrossbarMode(enabled=True), **kw,
        )
    with pytest.raises(ValueError, match="no programmed artifacts"):
        ServingEngine(tcfg, tparams, **kw).save_artifacts(str(tmp_path))


def test_coverage_check_catches_an_orphaned_artifact_and_restores_records(tiny_lm):
    _, tcfg, _, tparams = tiny_lm
    chip = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    stale = tprog.ProgrammedModel({**chip.artifacts, "renamed_head": chip.by_name["embed/tokens"]})
    kw = dict(max_batch=1, max_seq=16, device="cpu")
    with pytest.raises(LookupError, match="never consumed"):
        ServingEngine(tcfg, tparams, crossbar=CrossbarMode(enabled=True, programmed=stale), **kw)
    ServingEngine(  # the opt-out serves a superset store
        tcfg, tparams, crossbar=CrossbarMode(enabled=True, programmed=stale), verify_coverage=False, **kw
    )
    TL.restore_crossbar_misses({"earlier": 1})
    tprog.reset_consumed_artifact_names()
    tprog.record_artifact_consumed("earlier/name")
    ServingEngine(tcfg, tparams, crossbar=CrossbarMode(enabled=True, programmed=chip), **kw)
    assert TL.crossbar_miss_counts() == {"earlier": 1}
    assert tprog.consumed_artifact_names() == ("earlier/name",)
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()


def test_completion_ledger_keeps_one_token_requests(tiny_lm):
    _, tcfg, _, tparams = tiny_lm
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu")
    rids = [eng.submit(np.arange(4) + i, max_new_tokens=n) for i, n in enumerate((1, 6, 1))]
    assert eng.step() == 2  # admits two, the one-token request finishes at once
    assert 0 in eng._completed and eng.slots[0] is None
    done = eng.run_until_done()
    assert [r.rid for r in done] == rids and all(r.done for r in done)
    assert [len(r.generated) for r in done] == [1, 6, 1]
    assert eng.step() == 0


def test_overlength_prompt_refused_or_truncated(tiny_lm):
    jcfg, tcfg, jparams, tparams = tiny_lm
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=16, device="cpu")
    long = np.arange(40) % 256
    with pytest.raises(ValueError, match="exceeds max_seq=16"):
        eng.submit(long)
    assert not eng.pending
    eng.submit(long, max_new_tokens=3, truncate=True)
    got = eng.run_until_done()[0].generated
    ref = ServingEngine(tcfg, tparams, max_batch=1, max_seq=16, device="cpu")
    ref.submit(long[:16], max_new_tokens=3)
    assert got == ref.run_until_done()[0].generated
    je = JEngine(jcfg, jparams, max_batch=1, max_seq=16)
    je.submit(long, max_new_tokens=3, truncate=True)
    assert got == je.run_until_done()[0].generated
    # a prompt of exactly max_seq still admits (and stops at the cache's end)
    eng.submit(long[:16], max_new_tokens=3)
    assert eng.run_until_done()[-1].done


def test_eos_streaming_callback_and_sampling(tiny_lm):
    _, tcfg, _, tparams = tiny_lm
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=32, device="cpu")
    eng.submit(np.arange(5), max_new_tokens=6)
    greedy = eng.run_until_done()[0].generated
    seen = []
    eng.submit(np.arange(5), max_new_tokens=6, eos_id=greedy[2], on_token=lambda r, t: seen.append(t))
    stopped = eng.run_until_done()[-1].generated
    assert stopped == greedy[: greedy.index(greedy[2]) + 1] and seen == stopped

    def sampled(seed):
        e = ServingEngine(tcfg, tparams, max_batch=1, max_seq=32, temperature=1.0, seed=seed, device="cpu")
        e.submit(np.arange(5), max_new_tokens=8)
        return e.run_until_done()[0].generated

    assert sampled(1) == sampled(1) and sampled(1) != sampled(2)


def test_bucket_and_request_defaults_match_reference():
    for n in list(range(1, 70)) + [127, 128, 129, 2048, 2049, 5000]:
        assert _bucket(n) == j_bucket(n)
    r = Request(0, np.arange(3))
    assert (r.max_new_tokens, r.eos_id, r.truncate, r.done, r.generated) == (16, None, False, False, [])


def test_runner_decode_returns_host_float32_and_f32_cache(tiny_lm):
    _, tcfg, _, tparams = tiny_lm
    runner = ModelRunner(tcfg, tparams, max_seq=16, device="cpu")
    cache = runner.init_cache(2)
    assert cache[0]["b0"]["k"].dtype == torch.float32 and cache[0]["b0"]["k"].shape[:3] == (2, 2, 16)
    cache, pos, last, first = runner.admit_slot(cache, 1, Request(0, np.array([5, 6, 7])))
    assert (pos, last, first) == (2, 7, None)
    assert float(cache[0]["b0"]["k"][:, 0].abs().max()) == 0.0  # slot 0 untouched
    assert float(cache[0]["b0"]["k"][:, 1, :3].abs().max()) > 0.0
    logits, _ = runner.decode(np.array([0, 7]), np.array([0, 2]), cache)
    assert isinstance(logits, np.ndarray) and logits.dtype == np.float32 and logits.shape == (2, 256)
