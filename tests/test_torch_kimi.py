"""PyTorch port, MoE serving against the JAX package: the engine's greedy
tokens digital and on a programmed ideal chip (reduced kimi-k2), the spread
and refusals of ``expert_chips`` (the reference's
``test_expert_chips_spread_moe_banks``) and its reprogramming at refresh,
and an engine serving one rank's share of the experts.  The noisy
``expert_chips`` stores are in ``test_torch_moe_store.py``."""
import numpy as np
import jax
import pytest
import torch

from _moe_serving import carry, fresh_engine, port_config, same_tokens, spy_ticks
from benchmarks.noise_sweep import tiny_moe_lm_config
from repro import configs as jconfigs
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import programmed as tprog
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.models.moe import ExpertShare
from repro_torch.serving import ServingEngine

KIMI = "kimi-k2-1t-a32b"
NOISY = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)
# Seeds of the prompts (2 prompts, 6 new tokens each).  On a chip the
# packages' logits differ by a few head LSBs (test_torch_moe,
# test_torch_dense_families), and a random reduced model's top-2 margins are
# often of that size: over seeds 0-59 the reduced kimi's ideal-chip tokens
# differed in 11, each where a margin was below the discrepancy.  The seeds
# below have a smallest margin 7.97x / 8.30x / 4.59x the discrepancy, so
# identity is guaranteed rather than lucky; the margin check fails the test
# if that stops holding.
KIMI_CHIP_SEEDS = (7, 30, 41)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_moe_lm_config()
    return (jcfg, port_config(jcfg)) + carry(jcfg)


@pytest.fixture(scope="module")
def kimi():
    jcfg = jconfigs.reduced(jconfigs.get_config(KIMI))
    return (jcfg, reduced(get_config(KIMI))) + carry(jcfg)


@pytest.fixture(scope="module")
def kimi_chip(kimi, tmp_path_factory):
    """An ideal chip of the reduced kimi programmed and saved by the JAX
    engine, and that engine."""
    jcfg, _, jparams, _ = kimi
    d = str(tmp_path_factory.mktemp("kimi-ideal"))
    eng = JEngine(jcfg, jparams, max_batch=2, max_seq=64, crossbar=JMode(enabled=True, strict=True))
    eng.save_artifacts(d)
    return d, eng


@pytest.mark.parametrize("seed", KIMI_CHIP_SEEDS)
def test_greedy_tokens_identical_to_jax_engine_on_an_ideal_chip(kimi, kimi_chip, seed):
    """Both engines serve the chip the JAX engine programmed (the port
    restores its store): the same greedy tokens, no artifact miss."""
    _, tcfg, _, tparams = kimi
    d, jeng = kimi_chip
    TL.reset_crossbar_misses()
    te = ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=64, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=d,
    )
    assert te.programmed.by_name["stage1/b0/ffn/wg"].w_codes.ndim == 4
    same_tokens(fresh_engine(jeng), te, tcfg.vocab_size, seed)
    assert TL.crossbar_misses() == ()


def test_greedy_tokens_identical_to_jax_engine_digital(kimi):
    jcfg, tcfg, jparams, tparams = kimi
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=64)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=64, device="cpu")
    same_tokens(je, te, tcfg.vocab_size, 0)


def test_port_programmed_expert_chips_spread_the_banks():
    """``program_model(expert_chips=)`` varies the chip identity along the
    expert axis of 4-D banks and leaves 2-D / 3-D leaves on the base chip
    (the reference's test_expert_chips_spread_moe_banks)."""
    rng = np.random.default_rng(14)
    w_e = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    params = {
        "stage0": {"b0": {
            "ffn": {"wi": torch.stack([torch.stack([w_e, w_e])])},  # (1, 2, K, N)
            "mixer": {"wq": torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32))},
        }},
    }
    dev = TDev(sigma=0.05, p_stuck_on=1e-3, p_stuck_off=1e-3)
    plain = tprog.program_model(params, device_cfg=dev, device="cpu")
    spread = tprog.program_model(params, device_cfg=dev, expert_chips=(1, 2), device="cpu")
    wi_p, wi_s = plain.by_name["stage0/b0/ffn/wi"], spread.by_name["stage0/b0/ffn/wi"]
    assert torch.equal(wi_p.g_eff[0, 0], wi_p.g_eff[0, 1])
    assert not torch.equal(wi_s.g_eff[0, 0], wi_s.g_eff[0, 1])
    one = tprog.program_layer(w_e, device_cfg=dev.replace(chip=2))
    assert torch.equal(one.g_eff, wi_s.g_eff[0, 1])
    assert torch.equal(plain.by_name["stage0/b0/mixer/wq"].g_eff, spread.by_name["stage0/b0/mixer/wq"].g_eff)
    assert wi_s.device == dev  # the stacked artifact keeps the base device


def test_expert_chips_refusals(tiny):
    """One identity an expert, and a DeviceConfig to draw with: a wrong
    count or an ideal chip is refused, by program_model and the engine."""
    _, tcfg, _, tparams = tiny
    dev = TDev(**NOISY)
    with pytest.raises(ValueError):
        tprog.program_model(tparams, device_cfg=dev, expert_chips=(1, 2, 3), device="cpu")
    with pytest.raises(ValueError):
        tprog.program_model(tparams, device_cfg=None, expert_chips=(1, 2), device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tparams, device="cpu", crossbar=CrossbarMode(enabled=True), expert_chips=(1, 2))


def test_engine_remembers_expert_chips_for_refresh(tiny):
    """``refresh()`` reprograms the same fleet: the chip identities of the
    deploy-time chip, bit for bit."""
    _, tcfg, _, tparams = tiny
    eng = ServingEngine(
        tcfg, tparams, max_batch=1, max_seq=32, device="cpu", expert_chips=(3, 9),
        crossbar=CrossbarMode(enabled=True, strict=True, device=TDev(**NOISY)),
    )
    assert eng.expert_chips == (3, 9)
    before = eng.programmed.by_name
    eng.refresh()
    after = eng.programmed.by_name
    assert after is not before
    for name in before:
        assert tprog.artifacts_equal(before[name], after[name]), name


@pytest.mark.parametrize("chip", ["digital", "ideal_chip"])
def test_engine_serves_a_share(kimi, chip):
    """An engine on rank 1 of 2's share (its params carry experts 4-7):
    every forward of the runner runs as the share — the padded prefill and
    each decode tick give, bit for bit, what the model's entry points give
    under ``expert_share(share)``; the chip's banks hold 4 experts; without
    the share the params are refused."""
    jcfg, tcfg, jparams, _ = kimi
    share = ExpertShare(1, 2)
    sp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu", share=share)
    kw = dict(crossbar=CrossbarMode(enabled=True, strict=True)) if chip == "ideal_chip" else {}
    eng = ServingEngine(tcfg, sp, max_batch=1, max_seq=32, device="cpu", share=share, **kw)
    assert eng.share == share
    if chip == "ideal_chip":
        assert eng.programmed.by_name["stage1/b0/ffn/wi"].shape == (2, 4, jcfg.d_model, jcfg.moe_d_ff)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, size=7)
    ticks = spy_ticks(eng)
    eng.submit(prompt, max_new_tokens=3)
    got = eng.run_until_done()[0].generated
    # the runner's prefill (zero-padded to its bucket) and ticks, by hand
    cache = TM.init_cache(tcfg, 1, 32, dtype=torch.float32, device="cpu")
    padded = np.zeros((1, 32), np.int64)
    padded[0, :7] = prompt
    run = eng.runner._with_crossbar
    run(lambda: TM.prefill(sp, tcfg, torch.from_numpy(padded), cache))
    tok, pos = int(prompt[-1]), 6
    for t in range(3):
        logits, _ = run(lambda: TM.decode_step(sp, tcfg, torch.tensor([[tok]]), torch.tensor([pos]), cache))
        np.testing.assert_array_equal(logits.to(torch.float32).numpy(), ticks[t])
        tok, pos = int(np.argmax(ticks[t][0])), pos + 1
        assert tok == got[t]
    with pytest.raises(ValueError, match="ExpertShare"):
        TM.forward(sp, tcfg, torch.from_numpy(padded))
