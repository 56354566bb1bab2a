"""PyTorch port, planned stores and the store verifier: a chip planned and
saved by either package restores in the other with equal ``LayerPlan``s and
serves equal codes; the port's ``verify_store`` gives the reference's
findings (rule and leaf) on clean and corrupted stores; the port's engine
refuses a store that fails verification before loading it."""
import dataclasses
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import verify_store as j_verify
from repro.checkpoint import restore_programmed as j_restore, save_programmed as j_save
from repro.core import planner as jplanner
from repro.device import programmed as jprog
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.analysis import verify_store as t_verify
from repro_torch.checkpoint import restore_programmed as t_restore, save_programmed as t_save
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import planner as tplanner
from repro_torch.device import programmed as tprog
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine

# served by the planned datapath in every layer, plus the tied head
NAMES = ["stage0/b0/mixer/wq", "stage0/b0/mixer/wo", "stage0/b0/ffn/wi", "embed/tokens"]


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    tcfg = reduced(get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def jax_planned_store(tiny_lm, tmp_path_factory):
    _, _, jparams, _ = tiny_lm
    plan = jplanner.plan_model(jparams, tie_lm_head=True)
    prog = jprog.program_model(jparams, tie_lm_head=True, plan=plan)
    d = str(tmp_path_factory.mktemp("jax_planned"))
    j_save(d, prog)
    return d, prog, plan


@pytest.fixture(scope="module")
def port_planned_store(tiny_lm, tmp_path_factory):
    _, _, _, tparams = tiny_lm
    plan = tplanner.plan_model(tparams, tie_lm_head=True)
    prog = tprog.program_model(tparams, tie_lm_head=True, plan=plan, device="cpu")
    d = str(tmp_path_factory.mktemp("port_planned"))
    t_save(d, prog)
    return d, prog, plan


def _servable(art, i=1):
    return art.layer(i) if art.stacked else art


def _x(name, K):
    return np.random.default_rng(len(name)).normal(size=(2, 3, K)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_jax_planned_store_restores_in_the_port(jax_planned_store, name):
    d, jprog_model, jplan = jax_planned_store
    restored = t_restore(d, device="cpu")
    assert set(restored.by_name) == set(jprog_model.by_name)
    ta = restored.by_name[name]
    assert isinstance(ta.plan, tplanner.LayerPlan)
    assert dataclasses.asdict(ta.plan) == dataclasses.asdict(jplan.layer_for(name))
    assert ta.plan.datapath == "karatsuba2"
    ja, ts = _servable(jprog_model.by_name[name]), _servable(ta)
    x = _x(name, ja.shape[0])
    y_ref = np.asarray(jprog.programmed_linear(jnp.asarray(x), ja))
    tprog.reset_planned_calls()
    y = tprog.programmed_linear(torch.from_numpy(x), ts).numpy()
    assert tprog.PLANNED_CALLS["karatsuba2"] == 1
    np.testing.assert_array_equal(y, y_ref)


@pytest.mark.parametrize("name", NAMES)
def test_port_planned_store_verifies_and_restores_in_jax(port_planned_store, name):
    d, tprog_model, tplan = port_planned_store
    report = j_verify(d)
    assert report.ok, report.summary()
    restored = j_restore(d)
    ja = restored.by_name[name]
    assert isinstance(ja.plan, jplanner.LayerPlan)
    assert dataclasses.asdict(ja.plan) == dataclasses.asdict(tplan.layer_for(name))
    x = _x(name, tprog_model.by_name[name].shape[-2])
    y = tprog.programmed_linear(torch.from_numpy(x), _servable(tprog_model.by_name[name])).numpy()
    y_ref = np.asarray(jprog.programmed_linear(jnp.asarray(x), _servable(ja)))
    np.testing.assert_array_equal(y, y_ref)


def test_manifests_are_byte_compatible(jax_planned_store, port_planned_store, tmp_path):
    """The port's re-save of a JAX-planned store writes the JAX manifest's
    plan, spec and ADC entries back unchanged."""
    d, _, _ = jax_planned_store
    t_save(str(tmp_path), t_restore(d, device="cpu"))
    with open(os.path.join(d, "programmed", "manifest.json")) as f:
        j_man = json.load(f)
    with open(os.path.join(str(tmp_path), "programmed", "manifest.json")) as f:
        t_man = json.load(f)
    assert set(j_man["artifacts"]) == set(t_man["artifacts"])
    for name, info in j_man["artifacts"].items():
        for key in ("file", "spec", "adc_cfg", "fast", "device", "t_service_s", "plan"):
            assert t_man["artifacts"][name][key] == info[key], (name, key)


def test_expected_artifact_names_equal_jax(tiny_lm):
    _, _, jparams, tparams = tiny_lm
    for tie in (True, False):
        assert tprog.expected_artifact_names(tparams, tie_lm_head=tie) == {
            k: tuple(v) for k, v in jprog.expected_artifact_names(jparams, tie_lm_head=tie).items()
        }


# ---------------------------------------------------------------------------
# verify_store parity: clean and corrupted stores
# ---------------------------------------------------------------------------

def _edit_manifest(d, fn):
    path = os.path.join(d, "programmed", "manifest.json")
    with open(path) as f:
        man = json.load(f)
    fn(man)
    with open(path, "w") as f:
        json.dump(man, f)


def _set(name, key, value):
    def fn(man):
        man["artifacts"][name][key] = value
    return fn


def _set_plan_field(name, field, value):
    def fn(man):
        man["artifacts"][name]["plan"][field] = value
    return fn


def _remove_npz(d):
    os.remove(os.path.join(d, "programmed", "stage0__b0__ffn__wi.npz"))


def _pointer(d, content):
    with open(os.path.join(d, "programmed.ACTIVE"), "w") as f:
        f.write(content)


WQ, WO = "stage0/b0/mixer/wq", "stage0/b0/ffn/wo"
# (id, manifest edit or None, store edit or None, verify kwargs)
CORRUPTIONS = [
    ("clean", None, None, {}),
    ("unknown_datapath", _set_plan_field(WQ, "datapath", "winograd"), None, {}),
    ("adc_cfg_disagrees", _set(WQ, "adc_cfg", {"mode": "full", "guard_bits": 0, "msb_clamp": True}), None, {}),
    ("over_budget", None, None, {"max_crossbar_factor": 1.0}),
    ("unknown_adc_mode", _set_plan_field(WO, "adc_mode", "flash"), None, {}),
    ("provable_contract", None, None, {"exactness": "provable"}),
    ("bad_spec", _set(WQ, "spec", {"rows": 128, "bogus": 1}), None, {}),
    ("bad_service_clock", _set(WQ, "t_service_s", -1.0), None, {}),
    ("bad_report", _set(WO, "report", {"__kind__": "Mystery"}), None, {}),
    ("missing_key", lambda m: m["artifacts"][WQ].pop("fast"), None, {}),
    ("missing_npz", None, _remove_npz, {}),
    ("corrupt_pointer", None, lambda d: _pointer(d, "C"), {}),
    ("dangling_pointer", None, lambda d: _pointer(d, "B"), {}),
    ("unknown_schema", lambda m: m.update(schema=7), None, {}),
]


def _findings(report):
    return [(f.rule, f.name) for f in report.findings]


@pytest.mark.parametrize(
    "manifest_edit,store_edit,kw", [c[1:] for c in CORRUPTIONS], ids=[c[0] for c in CORRUPTIONS]
)
def test_verify_store_findings_equal_jax(port_planned_store, tmp_path, manifest_edit, store_edit, kw):
    src, _, _ = port_planned_store
    d = str(tmp_path / "store")
    shutil.copytree(src, d)
    if manifest_edit is not None:
        _edit_manifest(d, manifest_edit)
    if store_edit is not None:
        store_edit(d)
    j, t = j_verify(d, **kw), t_verify(d, **kw)
    assert _findings(t) == _findings(j)
    assert (t.ok, t.slot, t.n_artifacts) == (j.ok, j.slot, j.n_artifacts)
    if manifest_edit is None and store_edit is None and not kw:
        assert t.ok and t.n_artifacts == 7
    else:
        assert not t.ok


def test_verify_store_name_set_equals_jax(tiny_lm, port_planned_store):
    """Against a model's expected names: a clean store has no findings, a
    model that lacks a leaf makes it an orphan, the same in both."""
    _, _, jparams, tparams = tiny_lm
    d, _, _ = port_planned_store
    for tie in (True, False):
        j = j_verify(d, expected=jprog.expected_artifact_names(jparams, tie_lm_head=tie))
        t = t_verify(d, expected=tprog.expected_artifact_names(tparams, tie_lm_head=tie))
        assert _findings(t) == _findings(j)
        assert t.ok == tie


# ---------------------------------------------------------------------------
# the engine: plan= with a restore, and fail-fast verification
# ---------------------------------------------------------------------------

MODE = CrossbarMode(enabled=True, strict=True)


def test_engine_refuses_plan_with_a_restored_chip(tiny_lm, port_planned_store):
    _, tcfg, _, tparams = tiny_lm
    d, _, plan = port_planned_store
    with pytest.raises(ValueError, match="replan a restored chip"):
        ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=MODE, restore_artifacts=d,
                      plan=plan, device="cpu")


@pytest.mark.parametrize(
    "edit,rule",
    [(_set_plan_field(WQ, "datapath", "winograd"), "plan"), (_set(WQ, "t_service_s", -1.0), "spec")],
    ids=["corrupt_plan", "corrupt_clock"],
)
def test_engine_refuses_a_store_that_fails_verification(tiny_lm, port_planned_store, tmp_path, monkeypatch,
                                                        edit, rule):
    _, tcfg, _, tparams = tiny_lm
    src, _, _ = port_planned_store
    d = str(tmp_path / "store")
    shutil.copytree(src, d)
    _edit_manifest(d, edit)
    from repro_torch.serving import engine as eng_mod

    def no_load(*a, **k):
        raise AssertionError("the store was loaded before it was verified")

    monkeypatch.setattr(eng_mod, "restore_programmed", no_load)
    with pytest.raises(ValueError, match=rf"static verification(.|\n)*\[{rule}\] \[{WQ}\]"):
        ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=MODE, restore_artifacts=d, device="cpu")


def test_engine_serves_a_jax_planned_store_like_the_jax_engine(tiny_lm, jax_planned_store):
    """Both engines restore the chip the JAX package planned.  Prompts of
    seed 22, whose top-2 logit margins cover 4.8x the frameworks' logit
    discrepancy (tests/test_torch_planner.py); the margin is checked too."""
    jcfg, tcfg, jparams, tparams = tiny_lm
    d, _, _ = jax_planned_store
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=MODE, restore_artifacts=d, device="cpu")
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=32, crossbar=JMode(enabled=True, strict=True),
                 restore_artifacts=d)
    assert all(a.plan is not None and a.plan.datapath == "karatsuba2" for a in te.programmed.by_name.values())
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 256, size=int(rng.integers(3, 12))) for _ in range(3)]
    out, ticks = [], []
    for eng in (te, je):
        seen = []
        real = eng.runner.sample

        def sample(logits, real=real, eng=eng, seen=seen):
            seen.append(np.array(logits[[i for i, s in enumerate(eng.slots) if s is not None]]))
            return real(logits)

        eng.runner.sample = sample
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        out.append([r.generated for r in eng.run_until_done()])
        ticks.append(seen)
    assert len(ticks[0]) == len(ticks[1])
    for a, b in zip(*ticks):
        top_a, top_b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        margin = min((top_a[:, -1] - top_a[:, -2]).min(), (top_b[:, -1] - top_b[:, -2]).min())
        assert margin > 2 * np.abs(a - b).max()
    assert out[0] == out[1]


def test_engine_leaves_orphaned_leaves_to_the_coverage_check(tiny_lm, port_planned_store, tmp_path):
    """A store that is a superset of the model passes the fail-fast
    verification (the orphan is not fatal there, as in the reference) and is
    refused by the coverage check, which ``verify_coverage=False`` turns off."""
    _, tcfg, _, tparams = tiny_lm
    src, _, _ = port_planned_store
    d = str(tmp_path / "store")
    shutil.copytree(src, d)
    _edit_manifest(d, lambda m: m["artifacts"].update({"extra/wq": dict(m["artifacts"][WQ])}))
    assert [(f.rule, f.name) for f in t_verify(d, expected=tprog.expected_artifact_names(
        tparams, tie_lm_head=True)).findings] == [("name-set", "extra/wq")]
    with pytest.raises(LookupError, match="never consumed"):
        ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=MODE, restore_artifacts=d, device="cpu")
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, crossbar=MODE, restore_artifacts=d,
                        verify_coverage=False, device="cpu")
    assert "extra/wq" in eng.programmed.by_name
