"""PyTorch port, chip-plan compiler: plans, the analytic energy model and
the ADC schedule equal the JAX package's (``ChipPlan.to_json`` string-equal),
and a chip programmed under a plan serves the same output codes as the
unplanned chip, as the reference's planned chip, and, on reduced smollm, the
same greedy tokens as the JAX engine under the same plan."""
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.core import adc as jadc
from repro.core import energy as jenergy
from repro.core import mapper as jmapper
from repro.core import planner as jplanner
from repro.core import workloads as jwl
from repro.core.crossbar import DEFAULT_SPEC as JSPEC
from repro.device import DeviceConfig as JDev
from repro.device import programmed as jprog
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import adc as tadc
from repro_torch.core import energy as tenergy
from repro_torch.core import mapper as tmapper
from repro_torch.core import planner as tplanner
from repro_torch.core import workloads as twl
from repro_torch.core.crossbar import DEFAULT_SPEC as TSPEC
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import programmed as tprog
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine

STUCK = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)


def _nets(wl):
    return wl.benchmark_suite() + [wl.lm_workload(_cfg(wl))]


def _cfg(wl):
    return (jconfigs.get_config if wl is jwl else get_config)("smollm-360m")


# ---------------------------------------------------------------------------
# analytic models: workloads, mapper, energy, ADC schedule
# ---------------------------------------------------------------------------

def test_workloads_equal_jax():
    j, t = _nets(jwl), _nets(twl)
    assert [dataclasses.asdict(n) for n in t] == [dataclasses.asdict(n) for n in j]
    for name in ("alexnet", "vgg-a", "resnet-34"):
        assert dataclasses.asdict(twl.by_name(name)) == dataclasses.asdict(jwl.by_name(name))


@pytest.mark.parametrize("policy", ["isaac", "newton"])
@pytest.mark.parametrize("fault_rate", [0.0, 1e-3])
def test_mapping_equals_jax(policy, fault_rate):
    from repro.core.arch import newton_chip as jchip
    from repro_torch.core.arch import newton_chip as tchip

    for jn, tn in zip(_nets(jwl), _nets(twl)):
        j = jmapper.map_network(jn, jchip(), policy=policy, fault_rate=fault_rate)
        t = tmapper.map_network(tn, tchip(), policy=policy, fault_rate=fault_rate)
        assert repr(t) == repr(j)


def test_energy_suite_and_headline_equal_jax():
    j = jenergy.evaluate_suite(jwl.benchmark_suite())
    t = tenergy.evaluate_suite(twl.benchmark_suite())
    assert list(t) == list(j)
    for net in j:
        assert list(t[net]) == list(j[net])
        for label in j[net]:
            assert repr(t[net][label]) == repr(j[net][label])
    assert tenergy.headline(t) == jenergy.headline(j)
    assert [x[0] for x in tenergy.technique_stack()] == [x[0] for x in jenergy.technique_stack()]
    # the digital baselines of Fig 20 / Fig 24
    for ref in ("DADIANNAO_REF", "ISAAC_REF"):
        assert dataclasses.asdict(getattr(tenergy, ref)) == dataclasses.asdict(getattr(jenergy, ref))
    tpu_t, tpu_j = tenergy.TPUModel(), jenergy.TPUModel()
    for tn, jn in zip(twl.benchmark_suite(), jwl.benchmark_suite()):
        assert tpu_t.best_batch(tn) == tpu_j.best_batch(jn)
        assert tpu_t.throughput(tn, 8) == tpu_j.throughput(jn, 8)


def test_mapper_sweeps_equal_jax():
    from repro.core.arch import newton_chip as jchip
    from repro_torch.core.arch import newton_chip as tchip

    rates = [0.0, 1e-3, 1e-2]
    assert tmapper.fault_provision_sweep(twl.benchmark_suite(), tchip(), rates) == (
        jmapper.fault_provision_sweep(jwl.benchmark_suite(), jchip(), rates)
    )
    sizes = [(128, 128), (64, 64)]
    assert tmapper.underutilization_sweep(twl.benchmark_suite(), sizes, tchip()) == (
        jmapper.underutilization_sweep(jwl.benchmark_suite(), sizes, jchip())
    )


ADC_CFGS = [("full", {"mode": "full"}), ("paper", {}), ("safe", {"guard_bits": 4}), ("exact", {"guard_bits": 20})]


@pytest.mark.parametrize("cfg_kw", [c[1] for c in ADC_CFGS], ids=[c[0] for c in ADC_CFGS])
@pytest.mark.parametrize("signed", [True, False])
def test_adc_schedule_and_error_bound_equal_jax(cfg_kw, signed):
    js = jadc.ADCConfig(**cfg_kw)
    ts = tadc.ADCConfig(**cfg_kw)
    for k in (128, 960, 2560):
        jspec = jax_layer_spec(k, signed)
        tspec = torch_layer_spec(k, signed)
        np.testing.assert_array_equal(tadc.adaptive_schedule(tspec, ts), jadc.adaptive_schedule(jspec, js))
        assert tadc.mean_bits_per_conversion(tspec, ts) == jadc.mean_bits_per_conversion(jspec, js)
        assert tadc.lsb_error_bound(tspec, ts, k) == jadc.lsb_error_bound(jspec, js, k)
        sched = jadc.adaptive_schedule(jspec, js)
        assert tadc.DEFAULT_SAR.mean_energy_pj(sched) == jadc.DEFAULT_SAR.mean_energy_pj(sched)
    assert dataclasses.asdict(tadc.DEFAULT_SAR) == dataclasses.asdict(jadc.DEFAULT_SAR)
    for bits in (0, 1, 4.5, 9):
        assert tadc.DEFAULT_SAR.energy_pj(bits) == jadc.DEFAULT_SAR.energy_pj(bits)


def jax_layer_spec(k, signed):
    from repro.core.crossbar import layer_scaled_spec

    return layer_scaled_spec(JSPEC.replace(signed_weights=signed), k)


def torch_layer_spec(k, signed):
    from repro_torch.core.crossbar import layer_scaled_spec

    return layer_scaled_spec(TSPEC.replace(signed_weights=signed), k)


# ---------------------------------------------------------------------------
# plan parity (to_json string-equal)
# ---------------------------------------------------------------------------

PLAN_KW = [
    ("default", {}),
    ("area1", {"max_crossbar_factor": 1.0}),
    ("provable", {"exactness": "provable"}),
    ("exact_widening", {"widening": "exact"}),
    ("area1_faulty", {"max_crossbar_factor": 1.0, "fault_rate": 2e-3}),
]


@pytest.mark.parametrize("kw", [p[1] for p in PLAN_KW], ids=[p[0] for p in PLAN_KW])
def test_plan_network_json_equals_jax(kw):
    for jn, tn in zip(_nets(jwl), _nets(twl)):
        tp = tplanner.plan_network(tn, **kw)
        assert tp.to_json() == jplanner.plan_network(jn, **kw).to_json()
        assert tplanner.ChipPlan.from_json(tp.to_json()) == tp
    if kw.get("max_crossbar_factor") == 1.0 and "widening" not in kw:
        hist = tplanner.plan_network(twl.alexnet(), **kw).datapath_histogram()
        assert hist.get("strassen", 0) > 0  # the only datapath that frees arrays


def test_homogeneous_network_json_equals_jax():
    for jn, tn in zip(_nets(jwl), _nets(twl)):
        assert tplanner.homogeneous_network(tn).to_json() == jplanner.homogeneous_network(jn).to_json()


def test_planner_helpers_equal_jax():
    for dp in tplanner.DATAPATHS:
        for widening in ("paper", "exact"):
            assert tplanner.datapath_crossbar_factor(dp, TSPEC, widening) == (
                jplanner.datapath_crossbar_factor(dp, JSPEC, widening)
            )
            assert tplanner.predicted_conversions(960, 320, 3, dp, TSPEC, widening) == (
                jplanner.predicted_conversions(960, 320, 3, dp, JSPEC, widening)
            )
    for mode in tplanner.ADC_MODES:
        assert dataclasses.asdict(tplanner.adc_config_for(mode, TSPEC)) == dataclasses.asdict(
            jplanner.adc_config_for(mode, JSPEC)
        )
    with pytest.raises(ValueError, match="unknown datapath"):
        tplanner.LayerPlan(name="x", datapath="winograd")
    with pytest.raises(ValueError, match="unknown ADC mode"):
        tplanner.LayerPlan(name="x", adc_mode="flash")


@pytest.fixture(scope="module")
def tiny_lm():
    """Reduced smollm (float32), JAX params and the port's copy of them."""
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    tcfg = reduced(get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("device", [None, STUCK], ids=["no_device", "stuck_cells"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_plan_model_json_equals_jax(tiny_lm, device, tie):
    _, _, jparams, tparams = tiny_lm
    jp = jplanner.plan_model(jparams, tie_lm_head=tie, device=(JDev(**device) if device else None))
    tp = tplanner.plan_model(tparams, tie_lm_head=tie, device=(TDev(**device) if device else None))
    assert tp.to_json() == jp.to_json()
    assert tp.datapath_histogram() == {"karatsuba2": len(tp.layers)}
    if device:
        assert all(p.spare_cols > 0 for p in tp.layers.values())


# ---------------------------------------------------------------------------
# programming with plans
# ---------------------------------------------------------------------------

def _layer(seed, K=256, N=64, M=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.1
    x = np.abs(rng.normal(size=(M, K))).astype(np.float32)
    return w, x


@pytest.mark.parametrize("datapath", ["direct", "karatsuba1", "karatsuba2", "strassen"])
@pytest.mark.parametrize("adc_mode", ["safe_adaptive", "full"])
def test_planned_ideal_layer_serves_unplanned_and_jax_codes(datapath, adc_mode):
    w, x = _layer(0)
    tplan = tplanner.LayerPlan(name="w", datapath=datapath, adc_mode=adc_mode)
    jplan = jplanner.LayerPlan(name="w", datapath=datapath, adc_mode=adc_mode)
    base = tprog.program_layer(torch.from_numpy(w))
    art = tprog.program_layer(torch.from_numpy(w), plan=tplan)
    assert art.plan == tplan and art.adc_cfg == tadc.ADCConfig(**dataclasses.asdict(
        jplanner.adc_config_for(adc_mode, jax_layer_spec(256, True))))
    tprog.reset_planned_calls()
    y = tprog.programmed_matmul(torch.from_numpy(x), art).numpy()
    assert tprog.PLANNED_CALLS == dict(
        {"karatsuba1": 0, "karatsuba2": 0, "strassen": 0}, **({datapath: 1} if datapath != "direct" else {})
    )
    np.testing.assert_array_equal(y, tprog.programmed_matmul(torch.from_numpy(x), base).numpy())
    jart = jprog.program_layer(jnp.asarray(w), plan=jplan)
    np.testing.assert_array_equal(y, np.asarray(jprog.programmed_matmul(jnp.asarray(x), jart, interpret=True)))


def test_planned_artifact_never_runs_the_fast_kernel(monkeypatch):
    """A planned datapath is served by its own code, not by K1 in its place."""
    w, x = _layer(1)
    art = tprog.program_layer(torch.from_numpy(w), plan=tplanner.LayerPlan(name="w", datapath="karatsuba2"))

    def refuse(*a, **k):
        raise AssertionError("the VMM kernel wrapper ran for a planned datapath")

    monkeypatch.setattr(tprog, "crossbar_vmm_cuda", refuse)
    tprog.programmed_matmul(torch.from_numpy(x), art)


def test_unknown_datapath_raises():
    w, x = _layer(2)
    art = tprog.program_layer(torch.from_numpy(w), plan=tplanner.LayerPlan(name="w", datapath="karatsuba1"))
    bad = dataclasses.replace(art, plan=types.SimpleNamespace(datapath="winograd", karatsuba_levels=0))
    with pytest.raises(ValueError, match="unknown planned datapath 'winograd'"):
        tprog.programmed_matmul(torch.from_numpy(x), bad)


def test_planned_noisy_chip_without_stuck_cells_equals_unplanned():
    """Noisy chips keep the device kernel under a plan; the plan picks its ADC
    schedule (safe_adaptive: the default) and its spare budget is a no-op
    without stuck cells."""
    w, x = _layer(3, N=32)
    dev = TDev(sigma=0.05)
    plan = tplanner.LayerPlan(name="w", datapath="karatsuba2", adc_mode="safe_adaptive", spare_cols=8)
    torch.manual_seed(0)
    base = tprog.program_layer(torch.from_numpy(w), device_cfg=dev)
    torch.manual_seed(0)
    art = tprog.program_layer(torch.from_numpy(w), device_cfg=dev, plan=plan)
    assert art.noisy and torch.equal(art.g_eff, base.g_eff) and art.adc_cfg == base.adc_cfg
    tprog.reset_planned_calls()
    np.testing.assert_array_equal(
        tprog.programmed_matmul(torch.from_numpy(x), art).numpy(),
        tprog.programmed_matmul(torch.from_numpy(x), base).numpy(),
    )
    assert sum(tprog.PLANNED_CALLS.values()) == 0


def test_spares_on_a_device_with_stuck_cells_raise_and_name_repair():
    """A plan's spare budget on a device with stuck cells programs a
    repaired chip (it raised before repair was ported): the plan's budget
    overrides the device's, exactly as the device's own budget would."""
    w, x = _layer(4)
    plan = tplanner.LayerPlan(name="w", datapath="karatsuba2", adc_mode="safe_adaptive", spare_cols=4)
    art = tprog.program_layer(torch.from_numpy(w), device_cfg=TDev(**STUCK), plan=plan)
    assert art.noisy and art.device == TDev(**STUCK, spare_cols=4)
    assert art.g_spare is not None and art.out_gather is not None and art.repair.n_repaired > 0
    own = tprog.program_layer(torch.from_numpy(w), device_cfg=TDev(**STUCK, spare_cols=4))
    assert torch.equal(art.g_eff, own.g_eff) and torch.equal(art.g_spare, own.g_spare)
    assert torch.equal(art.out_gather, own.out_gather)
    tprog.reset_planned_calls()
    y = tprog.programmed_matmul(torch.from_numpy(x), art)
    assert torch.equal(y, tprog.programmed_matmul(torch.from_numpy(x), dataclasses.replace(own, plan=plan)))
    assert sum(tprog.PLANNED_CALLS.values()) == 0  # a noisy chip keeps the device kernel
    # without spares the same device programs under the plan, unrepaired
    art = tprog.program_layer(torch.from_numpy(w), device_cfg=TDev(**STUCK), plan=dataclasses.replace(plan, spare_cols=0))
    assert art.noisy and art.plan.spare_cols == 0 and art.g_spare is None and art.repair is None
    assert not torch.equal(art.g_eff, own.g_eff)


def test_program_model_attaches_plans_by_name(tiny_lm):
    _, _, _, tparams = tiny_lm
    plan = tplanner.plan_model(tparams, tie_lm_head=True)
    prog = tprog.program_model(tparams, tie_lm_head=True, plan=plan, device="cpu")
    assert set(prog.by_name) == set(plan.layers)
    for name, art in prog.by_name.items():
        assert art.plan == plan.layer_for(name)


# ---------------------------------------------------------------------------
# serving under a plan
# ---------------------------------------------------------------------------

def _prompts(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 12))) for _ in range(n)]


def _serve(eng, prompts, max_new=5):
    """Greedy tokens of every request and the active slots' logits at every
    decode tick."""
    ticks = []
    real = eng.runner.sample

    def sample(logits):
        active = [i for i, s in enumerate(eng.slots) if s is not None]
        ticks.append(np.array(logits[active]))
        return real(logits)

    eng.runner.sample = sample
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return [r.generated for r in eng.run_until_done()], ticks


# seeds whose smallest top-2 margin is 3.5x, 3.5x, 4.0x and 4.8x the
# frameworks' largest logit discrepancy (of seeds 0..23, the four where
# greedy identity is guaranteed rather than lucky: the discrepancy of a few
# head-output LSBs is ROADMAP Queue 3's); the margin check fails the test if
# that stops holding
@pytest.mark.parametrize("seed", [0, 16, 21, 22])
def test_planned_engine_tokens_equal_jax_and_the_unplanned_chip(tiny_lm, seed):
    jcfg, tcfg, jparams, tparams = tiny_lm
    jplan = jplanner.plan_model(jparams, tie_lm_head=True)
    tplan = tplanner.plan_model(tparams, tie_lm_head=True)
    mode = CrossbarMode(enabled=True, strict=True)
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=32, crossbar=JMode(enabled=True, strict=True), plan=jplan)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=mode, plan=tplan, device="cpu")
    ue = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=mode, device="cpu")
    assert all(a.plan is not None for a in te.programmed.by_name.values())
    prompts = _prompts(seed)
    tprog.reset_planned_calls()
    t_tok, t_ticks = _serve(te, prompts)
    assert tprog.PLANNED_CALLS["karatsuba2"] > 0
    # the planned chip's output codes are the ideal chip's: logits bit-equal
    u_tok, u_ticks = _serve(ue, prompts)
    assert u_tok == t_tok and all(np.array_equal(a, b) for a, b in zip(t_ticks, u_ticks))
    # against the JAX engine under its plan: greedy identity where the top-2
    # margin covers twice the frameworks' logit discrepancy at every tick
    j_tok, j_ticks = _serve(je, prompts)
    assert len(j_ticks) == len(t_ticks)
    for a, b in zip(j_ticks, t_ticks):
        gap = np.abs(a - b).max()
        top_a, top_b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        margin = min((top_a[:, -1] - top_a[:, -2]).min(), (top_b[:, -1] - top_b[:, -2]).min())
        assert margin > 2 * gap, (margin, gap)
    assert t_tok == j_tok


def test_replays_credit_planned_calls():
    """A captured tick's planned calls are taken back at capture and credited
    per replay, like the kernel launches."""
    from repro_torch.serving import graphs

    tprog.reset_planned_calls()
    captured = [{} for _ in graphs._COUNTERS]
    captured[graphs._COUNTERS.index(tprog.PLANNED_CALLS)] = {"karatsuba2": 193}
    for _ in range(3):
        graphs.credit_launches(captured)
    assert tprog.PLANNED_CALLS == {"karatsuba1": 0, "karatsuba2": 579, "strassen": 0}
