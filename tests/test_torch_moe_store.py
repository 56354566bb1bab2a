"""PyTorch port, MoE chips on a noisy device with one chip identity an
expert (``expert_chips``), carried between the packages through the store:
a chip the JAX package programmed (with write-verify reports) restored by
the port's engine, its expert banks' cells the JAX chip's bit for bit and
its tokens the JAX engine's; and the port's own save of it verified and
restored by the JAX package, artifact for artifact."""
import numpy as np
import pytest

from _moe_serving import carry, fresh_engine, port_config, same_tokens
from benchmarks.noise_sweep import tiny_moe_lm_config
from repro.analysis import verify_store as j_verify_store
from repro.checkpoint import restore_programmed as j_restore
from repro.checkpoint import save_programmed as j_save
from repro.device import DeviceConfig as JDev
from repro.device.programmed import program_model as j_program_model
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.analysis import verify_store
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import programmed as tprog
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine

NOISY = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)
EXPERT_CHIPS = (3, 9)
# Prompt seeds (2 prompts, 6 new tokens each) whose smallest top-2 margin is
# 1.9e4x-1.9e5x the logit difference between the packages on this chip.
TINY_NOISY_SEEDS = (7, 18, 35)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_moe_lm_config()
    return (jcfg, port_config(jcfg)) + carry(jcfg)


@pytest.fixture(scope="module")
def tiny_noisy_chip(tiny, tmp_path_factory):
    """The tiny MoE LM's noisy chip, programmed by the JAX package with
    write-verify reports and ``expert_chips`` and saved; a JAX engine serving
    it from that store; and the chip itself."""
    jcfg, _, jparams, _ = tiny
    chip = j_program_model(
        jparams, device=JDev(**NOISY), with_report=True, expert_chips=EXPERT_CHIPS, tie_lm_head=True,
    )
    d = str(tmp_path_factory.mktemp("tiny-noisy"))
    j_save(d, chip)
    eng = JEngine(
        jcfg, jparams, max_batch=2, max_seq=64, restore_artifacts=d,
        crossbar=JMode(enabled=True, strict=True, device=JDev(**NOISY)),
    )
    return d, eng, chip


def _port_engine(tiny, d):
    _, tcfg, _, tparams = tiny
    return ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=64, device="cpu", restore_artifacts=d,
        crossbar=CrossbarMode(enabled=True, strict=True, device=TDev(**NOISY)),
    )


@pytest.mark.parametrize("seed", TINY_NOISY_SEEDS)
def test_jax_expert_chips_store_serves_jax_tokens_in_the_port(tiny, tiny_noisy_chip, seed):
    """A JAX-programmed noisy chip with ``expert_chips`` restored through the
    port's store: the expert banks' cells are the JAX chip's bit for bit,
    and the port serves the JAX engine's tokens."""
    d, jeng, _ = tiny_noisy_chip
    te = _port_engine(tiny, d)
    jbank = jeng.programmed.by_name["stage0/b0/ffn/wi"]
    tbank = te.programmed.by_name["stage0/b0/ffn/wi"]
    assert tbank.g_eff.shape == tuple(jbank.g_eff.shape) and tbank.g_eff.ndim == 5  # (L, E, S, K, N)
    np.testing.assert_array_equal(tbank.g_eff.numpy(), np.asarray(jbank.g_eff))
    same_tokens(fresh_engine(jeng), te, tiny[1].vocab_size, seed)


def test_port_moe_store_passes_reference_verify_store_and_restores_in_jax(tiny, tiny_noisy_chip, tmp_path):
    """A noisy MoE chip the JAX package programmed with write-verify reports
    and ``expert_chips``, restored by a port engine and saved again by it:
    the JAX package's ``verify_store`` passes the port's store, and the JAX
    package restores every artifact (4-D banks with their per-layer,
    per-expert reports) equal to the one it programmed."""
    d, _, jchip = tiny_noisy_chip
    te = _port_engine(tiny, d)
    tparams = tiny[3]
    out = str(tmp_path / "port")
    te.save_artifacts(out)
    expected = tprog.expected_artifact_names(tparams, tie_lm_head=True)
    assert verify_store(out, expected=expected).ok
    report = j_verify_store(out)
    assert report.ok, report.summary()
    back = j_restore(out)
    assert set(back.by_name) == set(jchip.by_name)
    for name, art in jchip.by_name.items():
        got = back.by_name[name]
        for f in tprog.ARTIFACT_ARRAY_FIELDS:
            a, b = getattr(art, f), getattr(got, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert got.report == art.report and got.repair == art.repair and got.device == art.device
    bank = back.by_name["stage0/b0/ffn/wo"]
    assert np.asarray(bank.w_codes).ndim == 4 and len(bank.report) == 1 and len(bank.report[0]) == 2
