"""PyTorch port, programmed artifacts: a chip programmed by the JAX package
and carried over through the artifact store serves from the port
bit-for-bit; a store written by the port is certified and restored by the
JAX package; the port's own programming agrees with the reference's."""
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import verify_store
from repro.checkpoint import restore_programmed as j_restore, save_programmed as j_save, swap_active
from repro.core.crossbar import DEFAULT_SPEC as JDEFAULT
from repro.device import DeviceConfig as JDev
from repro.device import models as jdm
from repro.device import programmed as jprog
from repro.models import model as JM
from repro_torch.checkpoint import active_slot, restore_programmed, save_programmed
from repro_torch.convert import artifacts_from_numpy, params_from_numpy
from repro_torch.core.crossbar import DEFAULT_SPEC as TDEFAULT, quantize_input
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import models as tdm
from repro_torch.device import programmed as tprog
from repro_torch.kernels.ops import noisy_vmm_op

NOISY = dict(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ULPs (via the ordered-int view)."""
    def ordered(v):
        i = v.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.fixture(scope="module")
def jax_chip():
    """Reduced smollm (float32) programmed by the JAX package onto a noisy
    chip and an ideal one."""
    cfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    params, _ = JM.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    noisy = jprog.program_model(params, device=JDev(**NOISY), tie_lm_head=True)
    ideal = jprog.program_model(params, tie_lm_head=True)
    return cfg, params, noisy, ideal


@pytest.fixture(scope="module")
def noisy_store(jax_chip, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("noisy_store"))
    j_save(d, jax_chip[2])
    return d


def _servable(art, i=0):
    return art.layer(i) if art.stacked else art


NAMES = [
    "stage0/b0/mixer/wq", "stage0/b0/mixer/wk", "stage0/b0/mixer/wo",
    "stage0/b0/ffn/wi", "stage0/b0/ffn/wo", "embed/tokens",
]


@pytest.mark.parametrize("name", NAMES)
def test_jax_programmed_noisy_chip_serves_from_the_port(jax_chip, noisy_store, name):
    _, _, noisy, _ = jax_chip
    restored = restore_programmed(noisy_store, device="cpu")
    assert set(restored.by_name) == set(noisy.by_name)
    ja, ta = _servable(noisy.by_name[name], 1), _servable(restored.by_name[name], 1)
    assert ta.noisy and ta.device == TDev(**NOISY) and ta.spec.drop_lsb == ja.spec.drop_lsb
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(2, 5, ja.shape[0])).astype(np.float32)
    y_ref = np.asarray(jprog.programmed_linear(jnp.asarray(x), ja))
    y = tprog.programmed_linear(torch.from_numpy(x), ta).numpy()
    assert _ulp_diff(y, y_ref) <= 1
    np.testing.assert_array_equal(y, y_ref)  # the aim: bit-equal
    # the integer codes themselves
    xs = x - x.min()
    x_scale = np.float32(max(xs.max(), 1e-9)) / np.float32(65535)
    xq = quantize_input(torch.from_numpy(xs), ta.spec, torch.tensor(x_scale))
    from repro.core.crossbar import quantize_input as j_quantize_input
    from repro.kernels.ops import noisy_vmm_op as j_noisy_vmm_op

    xq_ref = j_quantize_input(jnp.asarray(xs), ja.spec, jnp.asarray(x_scale))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))
    yq = noisy_vmm_op(xq, ta.g_eff, ta.spec, adc_cfg=ta.adc_cfg)
    yq_ref = j_noisy_vmm_op(xq_ref, ja.g_eff, ja.spec, adc_cfg=ja.adc_cfg, interpret=True)
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_ref))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "paper"])
def test_jax_programmed_ideal_chip_serves_from_the_port(jax_chip, tmp_path, fast):
    _, params, _, ideal = jax_chip
    prog = ideal if fast else jprog.program_model(
        {"stage0": {"b0": {"ffn": params["stage0"]["b0"]["ffn"]}}}, fast=False
    )
    j_save(str(tmp_path), prog)
    restored = restore_programmed(str(tmp_path), device="cpu")
    rng = np.random.default_rng(int(fast))
    for name in ("stage0/b0/ffn/wi", "stage0/b0/ffn/wo"):
        ja, ta = prog.by_name[name].layer(0), restored.by_name[name].layer(0)
        assert ta.fast == fast and not ta.noisy
        x = rng.normal(size=(3, ja.shape[0])).astype(np.float32)
        y_ref = np.asarray(jprog.programmed_linear(jnp.asarray(x), ja))
        np.testing.assert_array_equal(tprog.programmed_linear(torch.from_numpy(x), ta).numpy(), y_ref)
        cs = rng.normal(size=(ja.shape[1],)).astype(np.float32)
        np.testing.assert_array_equal(
            tprog.programmed_linear(torch.from_numpy(x), ta, colsum=torch.from_numpy(cs)).numpy(),
            np.asarray(jprog.programmed_linear(jnp.asarray(x), ja, colsum=jnp.asarray(cs))),
        )


def test_port_written_store_is_certified_and_restored_by_jax(jax_chip, noisy_store, tmp_path):
    _, params, noisy, _ = jax_chip
    restored = restore_programmed(noisy_store, device="cpu")
    out = str(tmp_path / "port_store")
    save_programmed(out, restored, metadata={"written_by": "port"})
    expected = jprog.expected_artifact_names(params, tie_lm_head=True)
    report = verify_store(out, expected=expected)
    assert report.ok, report.summary()
    back = j_restore(out)
    assert set(back.by_name) == set(noisy.by_name)
    for name, art in noisy.by_name.items():
        assert jprog.artifacts_equal(art, back.by_name[name]), name
    # and the port agrees with itself across the round trip
    again = restore_programmed(out, device="cpu")
    for name, art in restored.by_name.items():
        assert tprog.artifacts_equal(art, again.by_name[name]), name


def test_store_slots_pointer_and_crash_fallbacks(noisy_store, tmp_path):
    prog = restore_programmed(noisy_store, device="cpu")
    d = str(tmp_path)
    save_programmed(d, prog, slot="A")
    assert active_slot(d) is None
    with pytest.raises(FileNotFoundError):
        restore_programmed(d, device="cpu")  # no pointer, no unslotted store
    swap_active(d, "A")  # the reference's commit point
    assert active_slot(d) == "A"
    a = restore_programmed(d, device="cpu")
    assert tprog.artifacts_equal(a.by_name["embed/tokens"], prog.by_name["embed/tokens"])
    assert restore_programmed(d, device="cpu", slot="A").n_compiled == prog.n_compiled
    with pytest.raises(ValueError):
        save_programmed(d, prog, slot="C")
    # a crash between the two renames leaves only ".old" (or ".tmp")
    os.rename(os.path.join(d, "programmed.slotA"), os.path.join(d, "programmed.slotA.old"))
    assert restore_programmed(d, device="cpu").n_compiled == prog.n_compiled
    os.rename(os.path.join(d, "programmed.slotA.old"), os.path.join(d, "programmed.slotA.tmp"))
    assert restore_programmed(d, device="cpu").n_compiled == prog.n_compiled
    with open(os.path.join(d, "programmed.ACTIVE"), "w") as f:
        f.write("Z")
    with pytest.raises(ValueError, match="corrupt ACTIVE"):
        restore_programmed(d, device="cpu")


def test_older_manifests_without_lifecycle_and_plan_keys_decode(noisy_store, tmp_path):
    d = str(tmp_path / "old")
    shutil.copytree(noisy_store, d)
    mpath = os.path.join(d, "programmed", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    for info in manifest["artifacts"].values():
        for key in ("device", "t_service_s", "plan", "sharding"):
            info.pop(key, None)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    prog = restore_programmed(d, device="cpu")
    art = prog.by_name["embed/tokens"]
    assert art.device is None and art.t_service_s == 0.0 and art.plan is None and art.noisy


def test_file_name_escaping_matches_reference(noisy_store):
    with open(os.path.join(noisy_store, "programmed", "manifest.json")) as f:
        ref_files = {n: i["file"] for n, i in json.load(f)["artifacts"].items()}
    prog = restore_programmed(noisy_store, device="cpu")
    out = noisy_store + "_escape"
    save_programmed(out, prog)
    with open(os.path.join(out, "programmed", "manifest.json")) as f:
        port_files = {n: i["file"] for n, i in json.load(f)["artifacts"].items()}
    assert port_files == ref_files
    assert ref_files["stage0/b0/mixer/wq"] == "stage0__b0__mixer__wq.npz"


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_program_layer_ideal_matches_reference(stacked):
    rng = np.random.default_rng(4)
    w = rng.normal(size=((3, 96, 40) if stacked else (96, 40))).astype(np.float32)
    ja = jprog.program_layer(jnp.asarray(w))
    ta = tprog.program_layer(torch.from_numpy(w))
    np.testing.assert_array_equal(ta.w_codes.numpy(), np.asarray(ja.w_codes))
    np.testing.assert_array_equal(ta.w_scale.numpy(), np.asarray(ja.w_scale))
    # a float reduction: the two frameworks sum in different orders
    np.testing.assert_allclose(ta.w_colsum.numpy(), np.asarray(ja.w_colsum), rtol=1e-5, atol=1e-5)
    assert ta.w_codes.dtype == torch.int32 and ta.w_scale.dtype == torch.float32
    assert ta.spec.drop_lsb == ja.spec.drop_lsb and ta.fast and ta.g_eff is None
    assert ta.shape == tuple(w.shape) and ta.stacked == stacked
    x_scale = tprog.program_layer(torch.from_numpy(w), x_scale=0.5).x_scale
    assert x_scale is not None and x_scale.dtype == torch.float32


def test_slab_tag_matches_reference():
    rng = np.random.default_rng(8)
    for shape in [(7, 5), (160, 16), (300, 130)]:
        wb = rng.integers(0, 1 << 16, size=shape)
        assert tdm.slab_tag(torch.from_numpy(wb)) == int(jdm._slab_tag(jnp.asarray(wb, jnp.int32)))


DEVICE_CASES = {
    "open_loop": dict(sigma=0.1, p_stuck_on=2e-3, p_stuck_off=2e-3, seed=11),
    "write_verify": dict(sigma=0.2, p_stuck_on=1e-3, p_stuck_off=1e-3, write_verify_iters=3, seed=3),
    "drift_irdrop": dict(sigma=0.05, drift_nu=0.02, t_drift_s=1e4, r_line_ohm=2.0, seed=5),
    "arrhenius": dict(sigma=0.02, drift_nu=0.05, t_drift_s=1e3, drift_ea_ev=0.2, temp_k=350.0),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_pipeline_with_injected_reference_fields(case):
    """The reference draws its random fields from threefry keys that torch
    cannot reproduce; injecting the JAX-drawn fields makes every stage
    deterministic.  The results agree on the 2**-8 grid except where the
    last ULP of exp / the level-map division moves a cell across a rounding
    boundary by one grid step.  Measured fraction of such cells: 0 in all
    four cases (x86-64, torch 2.13 CPU vs jax 0.9 CPU); the bound allows 1e-3
    for other math libraries, never more than one step."""
    jcfg, tcfg = JDev(**DEVICE_CASES[case]), TDev(**DEVICE_CASES[case])
    rng = np.random.default_rng(9)
    wb = rng.integers(0, 1 << 16, size=(200, 48))
    jwb = jnp.asarray(wb, jnp.int32)
    tag = jdm._slab_tag(jwb)
    shape = (JDEFAULT.n_slices,) + wb.shape
    u = jax.random.uniform(jdm._stage_key(jcfg, jdm.STAGE_FAULTS, tag), shape)
    key = jdm._stage_key(jcfg, jdm.STAGE_PROGRAM, tag)
    z = [
        jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32)
        for i in range(max(1, jcfg.write_verify_iters))
    ]
    g_ref = np.asarray(jdm.effective_cell_codes(jwb, JDEFAULT, jcfg))
    g = tdm.effective_cell_codes(
        torch.from_numpy(wb), TDEFAULT, tcfg,
        u=torch.from_numpy(np.array(u)), z_pulses=[torch.from_numpy(np.array(zi)) for zi in z],
    ).numpy()
    assert g.dtype == np.float32 and g.shape == g_ref.shape
    np.testing.assert_array_equal(g * 256, np.round(g * 256))  # on the grid
    assert g.min() >= 0.0 and g.max() <= 3.0
    steps = np.abs(g - g_ref) * 256
    assert steps.max() <= 1.0
    assert (steps > 0).mean() <= 1e-3, (steps > 0).mean()
    # the fault map is a pure comparison against u: exactly equal
    on_ref, off_ref = jdm.fault_masks(jcfg, shape, tag)
    on, off = tdm.fault_masks(tcfg, shape, int(tag), u=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(on.numpy(), np.asarray(on_ref))
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_ref))


def test_own_draws_are_deterministic_decorrelated_and_ideal_is_exact():
    rng = np.random.default_rng(2)
    wb = torch.from_numpy(rng.integers(0, 1 << 16, size=(130, 20)))
    cfg = TDev(**NOISY)
    a = tdm.effective_cell_codes(wb, TDEFAULT, cfg)
    assert torch.equal(a, tdm.effective_cell_codes(wb, TDEFAULT, cfg))
    assert not torch.equal(a, tdm.effective_cell_codes(wb, TDEFAULT, cfg.replace(seed=1)))
    wb2 = wb.clone()
    wb2[0, 0] ^= 1  # another slab: another tag, independent fields
    b = tdm.effective_cell_codes(wb2, TDEFAULT, cfg)
    assert (a != b).float().mean() > 0.5
    target = tdm.target_cell_codes(wb, TDEFAULT)
    assert torch.equal(tdm.effective_cell_codes(wb, TDEFAULT, TDev()), target.float())
    np.testing.assert_array_equal(
        target.numpy(), np.asarray(jdm.target_cell_codes(jnp.asarray(wb.numpy(), jnp.int32), JDEFAULT))
    )
    stuck = float(((a == 0) | (a == 3)).float().mean())
    assert 0.2 < stuck < 0.8  # most cells are perturbed off the integer codes
    assert TDev().is_ideal and not cfg.is_ideal and TDev(drift_nu=0.1).is_ideal


def test_noisy_program_layer_statistics_match_reference():
    """Own draws differ from the reference's, the distribution must not: the
    same weights programmed by both give effective cells with matching
    error moments and stuck fractions."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    dev = dict(sigma=0.05, p_stuck_on=5e-3, p_stuck_off=5e-3)
    ja = jprog.program_layer(jnp.asarray(w), device=JDev(**dev))
    ta = tprog.program_layer(torch.from_numpy(w), device_cfg=TDev(**dev))
    np.testing.assert_array_equal(ta.w_codes.numpy(), np.asarray(ja.w_codes))
    target = tdm.target_cell_codes(ta.w_codes + ta.spec.weight_bias, ta.spec).float().numpy()
    err_t = ta.g_eff.numpy() - target
    err_j = np.asarray(ja.g_eff) - target
    assert abs(err_t.std() - err_j.std()) < 0.05 * err_j.std()
    assert abs(np.abs(err_t).mean() - np.abs(err_j).mean()) < 0.05 * np.abs(err_j).mean()
    assert ta.g_eff.shape == tuple(ja.g_eff.shape) and ta.device == TDev(**dev)


def test_unported_features_raise_instead_of_degrading():
    """``with_report=``, ``chips=``, spare budgets and ``repair=True`` are
    ported (they raised before); what the port still refuses raises."""
    from repro_torch.core.planner import LayerPlan
    from repro_torch.device.program import ProgramReport
    from repro_torch.device.repair import RepairReport

    w = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32))
    assert tprog.program_layer(w, with_report=True).report is None  # an ideal chip writes nothing
    rep = tprog.program_layer(w, device_cfg=TDev(sigma=0.1), with_report=True).report
    assert isinstance(rep, ProgramReport) and rep.iterations == 1
    # chips= spreads the layer axis of a stacked leaf and must match its length
    assert tprog.program_layer(torch.stack([w, w]), device_cfg=TDev(sigma=0.1), chips=(1, 2)).noisy
    with pytest.raises(ValueError, match="chips"):
        tprog.program_layer(torch.stack([w, w]), device_cfg=TDev(sigma=0.1), chips=(0,))
    with pytest.raises(ValueError, match="DeviceConfig"):
        tprog.program_layer(torch.stack([w, w]), chips=(0, 1))
    dev = TDev(p_stuck_on=0.05, spare_cols=2)
    planned = tprog.program_layer(w, device_cfg=TDev(p_stuck_on=0.05), plan=LayerPlan(name="w", spare_cols=2))
    own = tprog.program_layer(w, device_cfg=dev)
    for art in (planned, own):
        assert isinstance(art.repair, RepairReport) and art.g_spare.shape == (8, 8, 2)
    assert torch.equal(planned.g_eff, own.g_eff)
    wb = torch.from_numpy(np.random.default_rng(2).integers(0, 1 << 16, size=(8, 4)))
    assert torch.equal(
        tdm.effective_cell_codes(wb, TDEFAULT, dev, repair=True),
        tdm.effective_cell_codes(wb, TDEFAULT, dev),  # repair is the default, as in the reference
    )
    art = tprog.program_layer(torch.ones((8, 4)))
    import dataclasses
    import types

    # an unknown planned datapath raises; it is never served by the fast kernel
    planned = dataclasses.replace(art, plan=types.SimpleNamespace(datapath="karatsuba", karatsuba_levels=1))
    with pytest.raises(ValueError, match="karatsuba"):
        tprog.programmed_matmul(torch.ones((2, 8)), planned)
    direct = dataclasses.replace(art, plan=LayerPlan(name="w", datapath="direct"))
    assert torch.equal(tprog.programmed_matmul(torch.ones((2, 8)), direct),
                       tprog.programmed_matmul(torch.ones((2, 8)), art))
    with pytest.raises(ValueError, match="stacked"):
        tprog.programmed_matmul(torch.ones((2, 8)), tprog.program_layer(torch.ones((2, 8, 4))))


def test_comp_scale_is_applied_before_the_offset_correction():
    rng = np.random.default_rng(12)
    w = rng.normal(size=(64, 16)).astype(np.float32)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    cs = (1.0 + 0.1 * rng.random(16)).astype(np.float32)
    ja = jprog.program_layer(jnp.asarray(w))
    import dataclasses
    ja = dataclasses.replace(ja, comp_scale=jnp.asarray(cs))
    ta = artifacts_from_numpy(
        {f: (np.array(getattr(ja, f)) if getattr(ja, f) is not None else None)
         for f in tprog.ARTIFACT_ARRAY_FIELDS},
        tprog.program_layer(torch.from_numpy(w)), device="cpu",
    )
    np.testing.assert_array_equal(
        tprog.programmed_linear(torch.from_numpy(x), ta).numpy(),
        np.asarray(jprog.programmed_linear(jnp.asarray(x), ja)),
    )


def test_name_scopes_binding_and_consumption_record():
    a2 = tprog.program_layer(torch.ones((8, 4)))
    a3 = tprog.program_layer(torch.ones((2, 8, 4)))
    with tprog.name_scope("stage0"), tprog.name_scope("b0"):
        assert tprog.scoped_name("wq") == "stage0/b0/wq"
        with tprog.bind_artifacts({"mixer": {"wq": a3}}):
            assert tprog.active_artifact_for("stage0/b0/mixer/wq", (8, 4)) is None  # still stacked
            assert tprog.active_artifact_for("stage0/b0/mixer/wq", (2, 8, 4)) is a3
            with tprog.bind_artifacts({"mixer": {"wq": a2}}):  # innermost wins
                assert tprog.active_artifact_for("stage0/b0/mixer/wq", (8, 4)) is a2
    assert tprog.scoped_name("wq") == "wq" and tprog.active_artifact_for("stage0/b0/mixer/wq") is None
    model = tprog.ProgrammedModel({"stage0": {"b0": {"mixer": {"wq": a3}}}, "embed": {"tokens": a2}})
    assert sorted(model.by_name) == ["embed/tokens", "stage0/b0/mixer/wq"]
    assert model.lookup("embed/tokens", (8, 4)) is a2 and model.lookup("embed/tokens", (4, 8)) is None
    assert model.subtree("stage1") is None and model.stage_layer_maps("stage1") is None
    maps = model.stage_layer_maps("stage0")
    assert len(maps) == 2 and maps[1]["stage0/b0/mixer/wq"].shape == (8, 4)
    assert model.stage_layer_maps("stage0") is maps  # sliced once
    tprog.reset_consumed_artifact_names()
    with pytest.raises(LookupError, match="never consumed"):
        model.verify_consumed()
    tprog.record_artifact_consumed("embed/tokens")
    tprog.record_artifact_consumed("stage0/b0/mixer/wq")
    model.verify_consumed()
    tprog.reset_consumed_artifact_names()


def test_program_model_names_and_tied_head(jax_chip):
    _, params, _, ideal = jax_chip
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    expected = tprog.expected_artifact_names(tparams, tie_lm_head=True)
    assert expected == jprog.expected_artifact_names(params, tie_lm_head=True)
    assert "embed/tokens" not in tprog.expected_artifact_names(tparams)
    model = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    assert {n: a.shape for n, a in model.by_name.items()} == expected
    for name, art in ideal.by_name.items():
        np.testing.assert_array_equal(model.by_name[name].w_codes.numpy(), np.asarray(art.w_codes))
        np.testing.assert_array_equal(model.by_name[name].w_scale.numpy(), np.asarray(art.w_scale))
    only_wi = tprog.program_model(tparams, leaf_filter=lambda p, l: p[-1] == "wi", device="cpu")
    assert sorted(only_wi.by_name) == ["stage0/b0/ffn/wi"]
