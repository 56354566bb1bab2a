"""PyTorch port, the chip lifecycle: the drift clock equals the JAX
package's bit for bit; aging is a view of the same chip (a drift-free chip
only moves its clock, a drifting one strays further from its digital twin,
time runs forward); the health monitor and the compensation fit agree with
the reference's on the same probes; chip identities decorrelate slabs; the
double-buffered store commits a slot atomically and round-trips every piece
of lifecycle and repair state; and a serving engine ages, probes,
compensates, refreshes and hot-swaps between ticks, dropping its captured
tick at every swap, with in-flight requests served the tokens of an
uninterrupted run."""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import verify_store as j_verify_store
from repro.checkpoint import restore_programmed as j_restore
from repro.device import DeviceConfig as JDev
from repro.device import health as jhealth
from repro.device import models as jdm
from repro.device import programmed as jprog
from repro_torch.analysis import verify_store
from repro_torch.checkpoint import active_slot, restore_programmed, save_programmed, swap_active
from repro_torch.configs import ModelConfig, StageSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import crossbar as tcb
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import GEFF_FRAC_BITS
from repro_torch.device import health as thealth
from repro_torch.device import models as tdm
from repro_torch.device import programmed as tprog
from repro_torch.device.program import ProgramReport
from repro_torch.device.repair import RepairReport
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine

DRIFT = dict(sigma=0.02, drift_nu=0.05, seed=7)
DRIFT_DEV = TDev(**DRIFT)


def _data(rng, B, K, N):
    x = torch.from_numpy(np.abs(rng.normal(size=(B, K))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32) * 0.1)
    return x, w


# ---------------------------------------------------------------------------
# the drift clock
# ---------------------------------------------------------------------------

CLOCKS = {
    "plain": dict(drift_nu=0.05),
    "baked_drift": dict(drift_nu=0.03, t_drift_s=1e4, t0_s=2.0),
    "hot": dict(drift_nu=0.05, drift_ea_ev=0.3, temp_k=360.0),
    "cold": dict(drift_nu=0.05, drift_ea_ev=0.3, temp_k=250.0),
    "no_drift": dict(sigma=0.05),
}


@pytest.mark.parametrize("clock", sorted(CLOCKS))
def test_drift_clock_and_aged_codes_equal_jax_bit_for_bit(clock):
    kw = CLOCKS[clock]
    jcfg, tcfg = JDev(**kw), TDev(**kw)
    assert tdm.effective_drift_nu(tcfg) == jdm.effective_drift_nu(jcfg)
    spec = tcb.DEFAULT_SPEC
    codes = np.round(np.random.default_rng(3).uniform(0, 3, size=(8, 64, 40)) * 256) / 256
    codes = codes.astype(np.float32)
    for t1, t2 in ((0.0, 0.0), (0.0, 1e2), (1e2, 1e6), (3.5e4, 3.5e4 + 1.0), (0.0, 1e8)):
        f = tdm.drift_time_factor(tcfg, t1, t2)
        assert isinstance(f, float) and f == jdm.drift_time_factor(jcfg, t1, t2)
        if t1 == t2 or kw.get("drift_nu", 0.0) == 0.0:
            assert f == 1.0
        else:
            assert f < 1.0
            np.testing.assert_array_equal(
                tdm.age_effective_codes(torch.from_numpy(codes), spec, tcfg, f).numpy(),
                np.asarray(jdm.age_effective_codes(jnp.asarray(codes), spec, jcfg, f)),
            )
    if kw.get("drift_nu", 0.0):
        with pytest.raises(ValueError, match="backwards"):
            tdm.drift_time_factor(tcfg, 10.0, 1.0)


def test_zero_drift_aging_is_bit_identical_noop():
    rng = np.random.default_rng(0)
    x, w = _data(rng, 4, 128, 16)
    for dev in (None, TDev(sigma=0.05, seed=1)):
        art = tprog.program_layer(w, device_cfg=dev)
        aged = art.age(1e7)
        assert aged.t_service_s == 1e7 and art.t_service_s == 0.0
        assert aged.w_codes is art.w_codes and aged.g_eff is art.g_eff  # the same tensors
        assert torch.equal(tprog.programmed_linear(x, art), tprog.programmed_linear(x, aged))


def test_aged_chip_error_grows_monotonically_and_time_runs_forward():
    rng = np.random.default_rng(1)
    x, w = _data(rng, 4, 128, 16)
    art = tprog.program_layer(w, device_cfg=DRIFT_DEV)
    y_ref = tprog.programmed_matmul(x, thealth.digital_twin(art))

    def mse(a):
        return float(torch.mean((tprog.programmed_matmul(x, a) - y_ref) ** 2))

    errs = [mse(art.at_time(t)) for t in (1e2, 1e4, 1e6, 1e8)]
    assert all(a < b for a, b in zip(errs, errs[1:])), errs
    old = art.age(100.0)
    with pytest.raises(ValueError, match="rejuvenate"):
        old.at_time(50.0)
    with pytest.raises(ValueError):
        tprog.age_artifact(old, -1.0)


def test_incremental_aging_matches_absolute_and_stacks_age_whole():
    rng = np.random.default_rng(3)
    _, w = _data(rng, 1, 64, 8)
    art = tprog.program_layer(w, device_cfg=DRIFT_DEV)
    two, one = art.age(1e3).age(9e3), tprog.artifact_at_time(art, 1e4)
    assert two.t_service_s == one.t_service_s == 1e4
    assert float(torch.max(torch.abs(two.g_eff - one.g_eff))) <= 2.0 ** -GEFF_FRAC_BITS + 1e-7
    ws = torch.from_numpy(rng.normal(size=(3, 64, 8)).astype(np.float32))
    stacked = tprog.program_layer(ws, device_cfg=DRIFT_DEV).at_time(1e6)
    for i in range(3):
        direct = tprog.program_layer(ws[i], device_cfg=DRIFT_DEV).at_time(1e6)
        assert torch.equal(stacked.layer(i).g_eff, direct.g_eff)


def test_aging_moves_the_analog_cells_and_never_the_digital_record():
    """A repaired chip ages its primary and spare cells alike; the codes,
    column sums, scales and routing tables are the immortal record."""
    rng = np.random.default_rng(4)
    _, w = _data(rng, 1, 128, 16)
    dev = TDev(sigma=0.02, p_stuck_on=1e-2, p_stuck_off=1e-2, drift_nu=0.05, spare_cols=8, seed=2)
    art = tprog.program_layer(w, device_cfg=dev)
    aged = art.age(1e6)
    f = tdm.drift_time_factor(dev, 0.0, 1e6)
    for leaf in ("g_eff", "g_spare"):
        assert torch.equal(getattr(aged, leaf), tdm.age_effective_codes(getattr(art, leaf), art.spec, dev, f))
        assert not torch.equal(getattr(aged, leaf), getattr(art, leaf))
    for leaf in ("w_codes", "w_colsum", "w_scale", "out_gather"):
        assert getattr(aged, leaf) is getattr(art, leaf)
    assert aged.repair == art.repair and aged.device == art.device


# ---------------------------------------------------------------------------
# health monitor and compensation
# ---------------------------------------------------------------------------

def test_health_and_compensation_equal_jax_on_injected_probes(tmp_path):
    """A chip programmed by the JAX package, carried across through the
    store, aged by both packages: the probe reading and the fitted scales
    agree with the reference's on the reference's own probes."""
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.normal(size=(128, 16)).astype(np.float32) * 0.1)
    j_art = jprog.program_layer(w, device=JDev(**DRIFT, p_stuck_on=2e-3, p_stuck_off=2e-3, spare_cols=4))
    save_dir = str(tmp_path)
    from repro.checkpoint import save_programmed as j_save

    j_save(save_dir, jprog.ProgrammedModel({"wq": j_art}))
    t_art = restore_programmed(save_dir, device="cpu").by_name["wq"]
    j_aged, t_aged = j_art.at_time(1e6), t_art.at_time(1e6)
    for leaf in ("g_eff", "g_spare"):
        np.testing.assert_array_equal(getattr(t_aged, leaf).numpy(), np.asarray(getattr(j_aged, leaf)))
    probes = jhealth.probe_vectors(128, 16, 0)
    jh = jhealth.layer_health("wq", j_aged)
    th = thealth.layer_health("wq", t_aged, probes=torch.from_numpy(np.array(probes)))
    assert th.rel_err == pytest.approx(jh.rel_err, rel=1e-6) and th.mse == pytest.approx(jh.mse, rel=1e-6)
    assert th.t_service_s == jh.t_service_s == 1e6 and th.over_budget == jh.over_budget
    assert thealth.closed_form_scale(t_aged) == jhealth.closed_form_scale(j_aged)
    j_comp = jhealth.fit_compensation(j_aged)
    t_comp = thealth.fit_compensation(t_aged, probes=torch.from_numpy(np.array(probes)))
    np.testing.assert_allclose(t_comp.comp_scale.numpy(), np.asarray(j_comp.comp_scale), rtol=1e-6)
    assert torch.equal(t_comp.g_eff, t_aged.g_eff)  # compensation never touches the cells
    jh2 = jhealth.layer_health("wq", j_comp)
    th2 = thealth.layer_health("wq", t_comp, probes=torch.from_numpy(np.array(probes)))
    assert th2.rel_err == pytest.approx(jh2.rel_err, rel=1e-5) and th2.rel_err < th.rel_err


def test_health_monitor_flags_over_budget_layers_and_leaves_the_chip_alone():
    rng = np.random.default_rng(6)
    _, w = _data(rng, 1, 128, 16)
    prog = tprog.program_model({"wq": w}, device_cfg=DRIFT_DEV, device="cpu")
    fresh = thealth.health_check(prog, budget=1e9)
    assert fresh.healthy and fresh.flagged == ()
    aged = thealth.health_check(prog.at_time(1e8), budget=1e-6)
    assert not aged.healthy and aged.flagged == ("wq",) and aged.worst > fresh.worst
    art = prog.by_name["wq"]
    before = art.g_eff.clone()
    thealth.layer_health("wq", art)
    assert torch.equal(before, art.g_eff)
    h = thealth.layer_health("wq", tprog.program_layer(w))
    assert h.rel_err == 0.0 and h.mse == 0.0
    # the probes are a function of (seed, k) alone, drawn on the CPU
    assert torch.equal(thealth.probe_vectors(128, 4, 3), thealth.probe_vectors(128, 4, 3))
    p = thealth.probe_vectors(128, 16, 0)
    assert p.shape == (16, 128) and float(p.min()) >= 2.0 ** -10 and float(p.max()) < 1.0


def test_compensation_recovers_at_least_half_the_aged_mse():
    rng = np.random.default_rng(8)
    x, w = _data(rng, 8, 128, 16)
    art = tprog.program_layer(w, device_cfg=DRIFT_DEV)
    aged = art.at_time(1e7)
    comp = thealth.fit_compensation(aged)
    assert torch.equal(aged.g_eff, comp.g_eff)
    y_ref = tprog.programmed_matmul(x, thealth.digital_twin(art))

    def mse(a):
        return float(torch.mean((tprog.programmed_matmul(x, a) - y_ref) ** 2))

    assert mse(comp) <= 0.5 * mse(aged)
    unit = dataclasses.replace(art, comp_scale=torch.ones(16))
    assert torch.equal(tprog.programmed_linear(x, art), tprog.programmed_linear(x, unit))
    # a stacked artifact gets one scale row per layer; ideal chips stay as they are
    stacked = tprog.program_model(
        {"s": {"wq": torch.stack([w, 2 * w])}, "head": w}, device_cfg=None, device="cpu"
    )
    noisy = tprog.program_model({"s": {"wq": torch.stack([w, 2 * w])}}, device_cfg=DRIFT_DEV, device="cpu")
    comp_prog = thealth.compensate_model(noisy.at_time(1e6))
    assert comp_prog.by_name["s/wq"].comp_scale.shape == (2, 16)
    assert thealth.compensate_model(stacked).by_name["head"].comp_scale is None


# ---------------------------------------------------------------------------
# chip identities
# ---------------------------------------------------------------------------

def test_chip_identities_zero_compatible_spread_decorrelated_length_checked():
    rng = np.random.default_rng(12)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    ws = torch.from_numpy(np.stack([w, w]))  # identical slabs
    plain = tprog.program_layer(ws, device_cfg=DRIFT_DEV)
    assert torch.equal(plain.g_eff, tprog.program_layer(ws, device_cfg=DRIFT_DEV, chips=(0, 0)).g_eff)
    assert torch.equal(plain.g_eff[0], plain.g_eff[1])
    spread = tprog.program_layer(ws, device_cfg=DRIFT_DEV, chips=(1, 2))
    assert not torch.equal(spread.g_eff[0], spread.g_eff[1])
    for i, c in enumerate((1, 2)):
        direct = tprog.program_layer(torch.from_numpy(w), device_cfg=DRIFT_DEV.replace(chip=c))
        assert torch.equal(spread.g_eff[i], direct.g_eff)
    assert spread.device == DRIFT_DEV
    with pytest.raises(ValueError, match="entries"):
        tprog.program_layer(torch.from_numpy(np.stack([w, w, w])), device_cfg=DRIFT_DEV, chips=(1, 2))
    with pytest.raises(ValueError, match="DeviceConfig"):
        tprog.program_layer(torch.from_numpy(np.stack([w, w, w])), device_cfg=None, chips=(1, 2, 3))


# ---------------------------------------------------------------------------
# the double-buffered store
# ---------------------------------------------------------------------------

def test_store_round_trips_repair_report_and_lifecycle_state(tmp_path):
    """report, repair, g_spare, out_gather, comp_scale, t_service_s and the
    programming DeviceConfig survive save -> restore in the port, the store
    passes both packages' verify_store, and the JAX package restores it with
    the same reports."""
    rng = np.random.default_rng(15)
    dev = TDev(sigma=0.02, p_stuck_on=1e-2, p_stuck_off=1e-2, drift_nu=0.05, spare_cols=4, seed=7)
    ws = torch.from_numpy(rng.normal(size=(2, 128, 16)).astype(np.float32))
    art = tprog.program_layer(ws, device_cfg=dev, with_report=True).at_time(12345.5)
    art = thealth.fit_compensation(art)
    assert isinstance(art.report, tuple) and isinstance(art.report[0], ProgramReport)
    assert isinstance(art.repair, tuple) and isinstance(art.repair[1], RepairReport)
    d = str(tmp_path)
    prog = tprog.ProgrammedModel({"s": {"wq": art}})
    assert prog.reports() == {"s/wq": art.report} and prog.repair_reports() == {"s/wq": art.repair}
    save_programmed(d, prog)
    assert verify_store(d).ok and j_verify_store(d).ok
    back = restore_programmed(d, device="cpu").by_name["s/wq"]
    assert tprog.artifacts_equal(back, art)
    assert back.report == art.report and back.repair == art.repair
    assert back.t_service_s == 12345.5 and back.device == dev
    for leaf in ("g_spare", "out_gather", "comp_scale"):
        assert getattr(back, leaf) is not None
    j_back = j_restore(d).by_name["s/wq"]
    assert [dataclasses.asdict(r) for r in j_back.repair] == [dataclasses.asdict(r) for r in art.repair]
    assert [dataclasses.asdict(r) for r in j_back.report] == [dataclasses.asdict(r) for r in art.report]
    np.testing.assert_array_equal(np.asarray(j_back.g_spare), art.g_spare.numpy())


def test_slot_swap_is_atomic_and_restore_follows_active(tmp_path):
    rng = np.random.default_rng(16)
    _, w = _data(rng, 1, 64, 8)
    a = tprog.program_layer(w, device_cfg=DRIFT_DEV)
    b = a.at_time(1e6)
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):  # the pointer never dangles
        swap_active(d, "B")
    assert active_slot(d) is None
    save_programmed(d, tprog.ProgrammedModel({"wq": a}), slot="A")
    assert swap_active(d, "A") == "A" and active_slot(d) == "A"
    assert tprog.artifacts_equal(restore_programmed(d, device="cpu").by_name["wq"], a)
    save_programmed(d, tprog.ProgrammedModel({"wq": b}), slot="B")
    assert tprog.artifacts_equal(restore_programmed(d, device="cpu").by_name["wq"], a)
    # a pointer write cut before its rename leaves the old pointer in force
    with open(os.path.join(d, "programmed.ACTIVE.tmp"), "w") as f:
        f.write("B")
    assert active_slot(d) == "A"
    swap_active(d, "B")
    assert not os.path.exists(os.path.join(d, "programmed.ACTIVE.tmp"))
    assert tprog.artifacts_equal(restore_programmed(d, device="cpu").by_name["wq"], b)
    assert tprog.artifacts_equal(restore_programmed(d, device="cpu", slot="A").by_name["wq"], a)
    with pytest.raises(ValueError):
        swap_active(d, "C")
    # the reference reads the port's pointer and slots alike
    assert tprog.artifacts_equal(
        restore_programmed(d, device="cpu").by_name["wq"],
        restore_programmed(d, device="cpu", slot="B").by_name["wq"],
    )
    np.testing.assert_array_equal(np.asarray(j_restore(d).by_name["wq"].g_eff), b.g_eff.numpy())


# ---------------------------------------------------------------------------
# the serving engine's lifecycle (tiny LM, end to end)
# ---------------------------------------------------------------------------

LIFE_DEV = TDev(sigma=0.02, p_stuck_on=2e-3, p_stuck_off=2e-3, drift_nu=0.05, spare_cols=4, seed=3)


def _port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["stages"] = tuple(StageSpec(**s) for s in fields["stages"])
    return ModelConfig(**fields)


@pytest.fixture(scope="module")
def tiny_lm():
    from benchmarks.noise_sweep import tiny_lm_config
    from repro.models import model as JM

    jcfg = tiny_lm_config()
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return _port_config(jcfg), params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _engine(tiny_lm, **kw):
    cfg, params = tiny_lm
    return ServingEngine(
        cfg, params, max_batch=2, max_seq=16, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True, device=LIFE_DEV), **kw,
    )


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 64, size=int(n)) for n in (3, 5, 4)]


def _submit(eng, max_new=6):
    for p in _prompts():
        eng.submit(p, max_new_tokens=max_new)


def _same_chip(a, b):
    assert set(a.by_name) == set(b.by_name)
    for n in a.by_name:
        assert tprog.artifacts_equal(a.by_name[n], b.by_name[n]), n


def test_engine_age_health_compensate_refresh_and_graph_drops(tiny_lm, tmp_path):
    eng = _engine(tiny_lm)
    runner = eng.runner
    assert eng.uptime_s == 0.0 and eng.repair_reports()
    _submit(eng)
    eng.step()
    graphs = [runner.decode_graph]
    fresh = eng.health_check()

    def rebound(action):
        action()
        assert runner.decode_graph is None  # dropped by the swap
        eng.step()
        assert runner.decode_graph is not None and all(runner.decode_graph is not g for g in graphs)
        graphs.append(runner.decode_graph)

    rebound(lambda: eng.age(1e7))
    assert eng.uptime_s == 1e7
    aged = eng.health_check()
    assert aged.worst > fresh.worst
    rebound(eng.compensate)
    comp = eng.health_check()
    assert comp.worst < aged.worst and eng.uptime_s == 1e7
    mean_mse = [sum(h.mse for h in r.layers) / len(r.layers) for r in (fresh, aged, comp)]
    assert (mean_mse[1] - mean_mse[2]) >= 0.5 * (mean_mse[1] - mean_mse[0])
    rebound(lambda: eng.refresh(str(tmp_path)))
    assert active_slot(str(tmp_path)) == "A" and eng.uptime_s == 0.0
    _same_chip(eng.programmed, _engine(tiny_lm).programmed)
    rebound(lambda: eng.refresh(str(tmp_path)))
    assert active_slot(str(tmp_path)) == "B"
    rebound(eng.refresh)  # in memory
    _same_chip(eng.programmed, _engine(tiny_lm).programmed)
    assert eng.health_check().worst == fresh.worst
    reqs = eng.run_until_done()
    assert len(reqs) == 3 and all(r.done for r in reqs)


def test_engine_mid_run_refresh_and_hot_swap_yield_uninterrupted_tokens(tiny_lm, tmp_path):
    ref = _engine(tiny_lm)
    _submit(ref)
    want = [r.generated for r in ref.run_until_done()]
    assert all(len(t) == 6 for t in want)
    for swap in ("memory", "store"):
        eng = _engine(tiny_lm)
        _submit(eng)
        eng.step()
        eng.step()
        if swap == "memory":
            eng.refresh()
        else:
            ref.save_artifacts(os.path.join(str(tmp_path), swap))
            eng.hot_swap(os.path.join(str(tmp_path), swap))
        assert eng.runner.decode_graph is None
        assert [r.generated for r in eng.run_until_done()] == want, swap


def test_engine_hot_swap_refuses_a_mismatched_store_and_keeps_serving(tiny_lm, tmp_path):
    eng = _engine(tiny_lm)
    before = eng.programmed
    stranger = tprog.program_layer(torch.from_numpy(np.random.default_rng(17).normal(size=(8, 8)).astype(np.float32)))
    save_programmed(str(tmp_path), tprog.ProgrammedModel({"nope": stranger}))
    with pytest.raises(ValueError, match="verification|does not match"):
        eng.hot_swap(str(tmp_path))
    assert eng.programmed is before
    cfg, params = tiny_lm
    digital = ServingEngine(cfg, params, max_batch=1, max_seq=16, device="cpu")
    for verb in (lambda: digital.age(1.0), digital.health_check, digital.compensate, digital.refresh):
        with pytest.raises(ValueError, match="programmed crossbar"):
            verb()


def test_engine_restart_restores_an_aged_compensated_chip(tiny_lm, tmp_path):
    eng = _engine(tiny_lm)
    eng.age(5e5)
    eng.compensate()
    eng.save_artifacts(str(tmp_path))
    back = _engine(tiny_lm, restore_artifacts=str(tmp_path))
    assert back.uptime_s == 5e5
    _same_chip(eng.programmed, back.programmed)
    assert back.repair_reports() == eng.repair_reports()
