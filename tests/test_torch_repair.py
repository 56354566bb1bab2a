"""PyTorch port, spare-column repair and the write side of programming:
with the JAX package's random fields injected, the port's repair plan
(victims, routing tables, spare block) and repaired cells are the
reference's; the repaired layout commutes with the column gather through the
noisy kernel's plain version; a zero-fault budget changes nothing; repair
rides ``program_layer`` / ``program_model`` / ``ServingEngine(spare_cols=)``;
and on a tiny LM it recovers most of the stuck-cell logit error.
``write_verify`` programs the cells ``write_verify_fixed`` does and reports
what the reference reports."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import crossbar as jcb
from repro.device import models as jdm
from repro.device import program as jprogram
from repro.device import repair as jrep
from repro_torch.configs import ModelConfig, StageSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import crossbar as tcb
from repro_torch.device import DeviceConfig as TDev
from repro_torch.device import models as tdm
from repro_torch.device import program as tprogram
from repro_torch.device import programmed as tprog
from repro_torch.device import repair as trep
from repro_torch.kernels.noisy_vmm import noisy_vmm_cuda
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode, crossbar_mode
from repro_torch.serving import ServingEngine

GRID = 256.0  # effective cells sit on a 2**-8 grid

# sigma = 0: no exponential anywhere in the pipeline, so injected fields give
# bit-equal cells; with sigma > 0 the reference's float32 exp (XLA) and the
# port's correctly rounded one differ in the last bit of some pulses, which
# moves a cell across a grid step now and then (models.program_variation)
CASES = {
    "stuck_two_groups": (dict(p_stuck_on=5e-3, p_stuck_off=5e-3, spare_cols=8, seed=0), 256, 200),
    "stuck_irdrop_drift_verify": (
        dict(p_stuck_on=1e-2, p_stuck_off=5e-3, spare_cols=4, r_line_ohm=2.0, drift_nu=0.02,
             t_drift_s=1e3, write_verify_iters=3, seed=3),
        200, 130,
    ),
    "noisy_write_verify": (
        dict(sigma=0.1, p_stuck_on=5e-3, p_stuck_off=5e-3, spare_cols=16, write_verify_iters=2, seed=1),
        256, 128,
    ),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_fields(jcfg, jwb, spec, n_spare):
    """The reference's random fields for one slab: primary and spare fault
    fields, and every write pulse's normal field of both blocks."""
    tag = jdm._slab_tag(jwb)
    S, (K, N) = spec.n_slices, jwb.shape
    iters = max(1, jcfg.write_verify_iters)

    def pulses(stage, shape):
        key = jdm._stage_key(jcfg, stage, tag)
        return [_t(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32)) for i in range(iters)]

    return dict(
        u=_t(jax.random.uniform(jdm._stage_key(jcfg, jdm.STAGE_FAULTS, tag), (S, K, N))),
        z_pulses=pulses(jdm.STAGE_PROGRAM, (S, K, N)),
        u_spare=_t(jax.random.uniform(jdm._stage_key(jcfg, jdm.STAGE_SPARE_FAULTS, tag), (S, K, n_spare))),
        z_spare_pulses=pulses(jdm.STAGE_SPARE_PROGRAM, (S, K, n_spare)),
    )


def _assert_cells(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    steps = np.abs(got - want) * GRID
    assert steps.max() <= 1.0 and (steps > 0).mean() <= 1e-3, ((steps > 0).sum(), steps.size)


@pytest.mark.parametrize("case", sorted(CASES))
def test_repair_with_injected_reference_fields(case):
    kw, K, N = CASES[case]
    jcfg, tcfg = jdm.DeviceConfig(**kw), TDev(**kw)
    jspec = jcb.layer_scaled_spec(jcb.DEFAULT_SPEC, K)
    tspec = tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, K)
    wb = np.random.default_rng(len(case)).integers(0, 1 << 16, size=(K, N))
    jwb = jnp.asarray(wb, jnp.int32)
    fields = _jax_fields(jcfg, jwb, jspec, jrep.spare_budget(N, jspec, jcfg))
    g_j, p_j, _ = jrep.repaired_effective_cells(jwb, jspec, jcfg)
    g_t, p_t, _ = trep.repaired_effective_cells(torch.from_numpy(wb), tspec, tcfg, **fields)
    # the greedy's choices are exact integers: equal whatever the exp
    np.testing.assert_array_equal(p_t.victim.numpy(), np.asarray(p_j.victim))
    np.testing.assert_array_equal(p_t.out_gather.numpy(), np.asarray(p_j.out_gather))
    assert p_t.victim.dtype == p_t.out_gather.dtype == torch.int32 and p_t.rows == p_j.rows
    for f in ("salience_before", "salience_after"):
        np.testing.assert_allclose(getattr(p_t, f).numpy(), np.asarray(getattr(p_j, f)), rtol=1e-6)
    exact = kw.get("sigma", 0.0) == 0.0
    _assert_cells(p_t.g_spare.numpy(), np.asarray(p_j.g_spare), exact)
    _assert_cells(g_t.numpy(), np.asarray(g_j), exact)
    assert (p_t.victim >= 0).any()  # the case repairs something
    rep_t, rep_j = trep.repair_report(p_t), jrep.repair_report(p_j)
    assert (rep_t.budget, rep_t.n_repaired, rep_t.repaired_cols) == (rep_j.budget, rep_j.n_repaired, rep_j.repaired_cols)
    assert rep_t.salience_before == pytest.approx(rep_j.salience_before, rel=1e-6)
    assert rep_t.salience_after == pytest.approx(rep_j.salience_after, rel=1e-6)
    # effective_cell_codes(repair=True) is the same pipeline
    g_e = tdm.effective_cell_codes(torch.from_numpy(wb), tspec, tcfg, **fields)
    assert torch.equal(g_e, g_t)


def test_plan_is_consistent_and_repairs_every_unit_alone():
    """The invariants ``tests/test_repair.py`` pins, on the port's own draws:
    every redirected output points at a spare holding that column, no spare
    is orphaned or shared within an array, spares stay in their group, and
    salience never rises."""
    spec = tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 256)
    cfg = TDev(p_stuck_on=5e-3, p_stuck_off=5e-3, spare_cols=32, seed=0)
    wb = torch.from_numpy(np.random.default_rng(0).integers(0, 1 << 16, size=(256, 160)))
    p1, p2 = trep.plan_repair(wb, spec, cfg), trep.plan_repair(wb, spec, cfg)
    for f in ("victim", "out_gather", "g_spare"):
        assert torch.equal(getattr(p1, f), getattr(p2, f))
    victim, gather = p1.victim.numpy(), p1.out_gather.numpy()
    K, N = wb.shape
    B = trep.spare_budget(N, spec, cfg)
    S, R = spec.n_slices, -(-K // spec.rows)
    assert victim.shape == (S, R, B) and gather.shape == (S, R, N) and p1.g_spare.shape == (S, K, B)
    for s in range(S):
        for r in range(R):
            v_u, g_u = victim[s, r], gather[s, r]
            for j in np.nonzero(g_u >= N)[0]:
                assert v_u[g_u[j] - N] == j
            used = v_u[v_u >= 0]
            assert len(used) == len(set(used.tolist()))
            assert set(used.tolist()) == {int(j) for j in range(N) if g_u[j] >= N}
            for b in np.nonzero(v_u >= 0)[0]:
                assert v_u[b] // spec.cols == b // cfg.spare_cols
    before, after = p1.salience_before.numpy(), p1.salience_after.numpy()
    assert (after <= before + 1e-6).all() and after.sum() < before.sum()
    rep = trep.repair_report(p1)
    assert rep.budget == S * R * B and rep.n_repaired == int((victim >= 0).sum())
    assert set(rep.repaired_cols) == {int(j) for j in range(N) if (gather[:, :, j] >= N).any()}
    assert 0.0 < rep.recovered_frac <= 1.0


def test_gather_commutation_through_the_plain_noisy_kernel():
    """The repaired layout equals the physical (S, K, N + B) layout gathered
    per (slice, row group) array; each array's partial sums commute with its
    column mux; and the noisy kernel's plain version on the repaired cells
    gives the reference's functional datapath's codes."""
    spec = tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 256)
    cfg = TDev(p_stuck_on=5e-3, p_stuck_off=5e-3, spare_cols=32, seed=0)
    rng = np.random.default_rng(1)
    wb = torch.from_numpy(rng.integers(0, 1 << 16, size=(256, 48)))
    x = rng.integers(0, 1 << 16, size=(4, 256))
    plan = trep.plan_repair(wb, spec, cfg)
    g_primary = tdm.effective_cell_codes(wb, spec, cfg, repair=False)
    g_repaired = trep.apply_repair(g_primary, plan)
    assert torch.equal(g_repaired, tdm.effective_cell_codes(wb, spec, cfg))
    g_phys = np.concatenate([g_primary.numpy(), plan.g_spare.numpy()], axis=2)
    gather = plan.out_gather.numpy()
    S, K, N = g_primary.shape
    expected = np.empty((S, K, N), g_phys.dtype)
    for s in range(S):
        for r in range(gather.shape[1]):
            r0, r1 = r * plan.rows, min((r + 1) * plan.rows, K)
            expected[s, r0:r1, :] = g_phys[s, r0:r1, :][:, gather[s, r]]
    np.testing.assert_array_equal(g_repaired.numpy(), expected)
    for s in (0, S - 1):
        for r in range(gather.shape[1]):
            r0, r1 = r * plan.rows, min((r + 1) * plan.rows, K)
            xs = x[:, r0:r1].astype(np.float64)
            np.testing.assert_array_equal(
                (xs @ g_phys[s, r0:r1, :].astype(np.float64))[:, gather[s, r]],
                xs @ g_repaired.numpy()[s, r0:r1, :].astype(np.float64),
            )
    y_port = noisy_vmm_cuda(torch.from_numpy(x), g_repaired, spec).numpy()
    jspec = jcb.layer_scaled_spec(jcb.DEFAULT_SPEC, 256)
    y_ref = np.asarray(jcb.noisy_crossbar_vmm(jnp.asarray(x), jnp.asarray(g_repaired.numpy()), jspec))
    np.testing.assert_array_equal(y_port, y_ref)


def test_zero_fault_budget_is_bit_exact_no_op():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.abs(rng.normal(size=(4, 128))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32))
    dev = TDev(sigma=0.1, spare_cols=16, seed=5)
    assert not tdm.wants_repair(dev)
    wb = torch.from_numpy(rng.integers(0, 1 << 16, size=(128, 16)))
    spec = tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 128)
    assert torch.equal(
        tdm.effective_cell_codes(wb, spec, dev), tdm.effective_cell_codes(wb, spec, dev.replace(spare_cols=0))
    )
    art = tprog.program_layer(w, device_cfg=dev)
    assert art.g_spare is None and art.out_gather is None and art.repair is None
    plain = tprog.program_layer(w, device_cfg=dev.replace(spare_cols=0))
    assert torch.equal(tprog.programmed_matmul(x, art), tprog.programmed_matmul(x, plain))


def test_budget_scaling_and_when_repair_applies():
    spec = tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 256)
    jspec = jcb.layer_scaled_spec(jcb.DEFAULT_SPEC, 256)
    for kw in (dict(p_stuck_on=0.01, spare_cols=8), dict(p_stuck_off=0.02, spare_cols=3)):
        for n in (1, 64, spec.cols, spec.cols + 1, 5 * spec.cols - 7):
            assert trep.spare_budget(n, spec, TDev(**kw)) == jrep.spare_budget(n, jspec, jdm.DeviceConfig(**kw))
    assert trep.spare_budget(64, spec, TDev(p_stuck_on=0.01, spare_cols=8)) == 8
    assert trep.spare_budget(spec.cols + 1, spec, TDev(p_stuck_on=0.01, spare_cols=8)) == 16
    assert trep.plan_repair(torch.zeros((8, 4), dtype=torch.int32), spec, TDev()) is None
    assert not tdm.wants_repair(TDev(p_stuck_on=0.01))
    assert not tdm.wants_repair(TDev(spare_cols=8))
    assert tdm.wants_repair(TDev(p_stuck_on=0.01, spare_cols=8))
    assert tdm._STAGES == jdm._STAGES


def test_program_model_records_repairs():
    rng = np.random.default_rng(6)
    params = {
        "stage0": {"b0": {"wq": torch.from_numpy(rng.normal(size=(2, 64, 16)).astype(np.float32))}},
        "head": torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)),
    }
    cfg = TDev(p_stuck_on=5e-3, p_stuck_off=5e-3, spare_cols=32, seed=0)
    prog = tprog.program_model(params, device_cfg=cfg, device="cpu")
    reps = prog.repair_reports()
    assert prog.n_compiled == 2 and len(reps) == 2
    stacked = reps["stage0/b0/wq"]
    assert isinstance(stacked, tuple) and len(stacked) == 2
    spec = prog.artifacts["stage0"]["b0"]["wq"].spec
    units = spec.n_slices * -(-64 // spec.rows)
    assert all(r.budget == trep.spare_budget(16, spec, cfg) * units for r in stacked)
    wq = prog.by_name["stage0/b0/wq"]
    assert wq.g_spare.shape == (2, spec.n_slices, 64, 32) and wq.out_gather.shape == (2, spec.n_slices, 1, 16)
    # each slab is the slab programmed alone
    alone = tprog.program_layer(params["stage0"]["b0"]["wq"][1], device_cfg=cfg)
    assert torch.equal(wq.layer(1).g_eff, alone.g_eff) and torch.equal(wq.layer(1).g_spare, alone.g_spare)
    assert stacked[1] == alone.repair


@pytest.mark.parametrize("case", ["converges", "stuck"])
def test_write_verify_cells_and_report_with_injected_reference_fields(case):
    kw = dict(sigma=0.2, write_verify_iters=8, seed=11) if case == "converges" else dict(
        sigma=0.1, p_stuck_on=0.05, write_verify_iters=6, seed=2
    )
    jcfg, tcfg = jdm.DeviceConfig(**kw), TDev(**kw)
    wb = np.random.default_rng(4).integers(0, 1 << 16, size=(256, 32))
    jwb = jnp.asarray(wb, jnp.int32)
    spec = tcb.DEFAULT_SPEC
    fields = _jax_fields(jcfg, jwb, jcb.DEFAULT_SPEC, 1)
    g, rep = tprogram.write_verify(torch.from_numpy(wb), spec, tcfg, u=fields["u"], z_pulses=fields["z_pulses"])
    target = tdm.target_cell_codes(torch.from_numpy(wb), spec)
    masks = tdm.fault_masks(tcfg, tuple(target.shape), tdm.slab_tag(torch.from_numpy(wb)), u=fields["u"])
    fixed = tdm.write_verify_fixed(target, masks, spec, tcfg, z_pulses=fields["z_pulses"])
    assert torch.equal(g, fixed)
    g_j, rep_j = jprogram.write_verify(jwb, jcb.DEFAULT_SPEC, jcfg)
    # a pulse lands within two float32 ULPs where the two exps differ
    ulp = np.abs(g.numpy().view(np.int32) - np.asarray(g_j).view(np.int32))
    assert ulp.max() <= 2 and (ulp > 0).mean() < 0.1
    assert rep.iterations == rep_j.iterations and len(rep.per_iter_mean_error) == rep.iterations
    assert rep.stuck_frac == pytest.approx(rep_j.stuck_frac, rel=1e-12)
    assert rep.converged_frac == pytest.approx(rep_j.converged_frac, abs=1.0 / g.numel())
    # the reference's means are float32 sums of 65536 cells, the port's float64
    for f in ("mean_abs_error", "max_abs_error"):
        assert getattr(rep, f) == pytest.approx(getattr(rep_j, f), rel=2e-6)
    np.testing.assert_allclose(rep.per_iter_mean_error, rep_j.per_iter_mean_error, rtol=2e-6)
    errs = rep.per_iter_mean_error
    assert all(b <= a for a, b in zip(errs, errs[1:]))
    if case == "converges":
        assert rep.converged_frac > 0.95
    else:
        assert rep.stuck_frac > 0 and rep.converged_frac < 1.0 and rep.max_abs_error >= 1.0
    # program_layer(with_report=True) programs the same chip and keeps the report
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 8)).astype(np.float32))
    a = tprog.program_layer(w, device_cfg=tcfg, with_report=True)
    b = tprog.program_layer(w, device_cfg=tcfg)
    assert isinstance(a.report, tprogram.ProgramReport) and b.report is None
    assert tprog.artifacts_equal(a, b)


# ---------------------------------------------------------------------------
# serving: the engine's budget knob, and logit recovery on a tiny LM
# ---------------------------------------------------------------------------

def _port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["stages"] = tuple(StageSpec(**s) for s in fields["stages"])
    return ModelConfig(**fields)


@pytest.fixture(scope="module")
def tiny_lm():
    """The reference's repair acceptance model (every projection, the
    untied head included, on the crossbar), carried into the port."""
    from benchmarks.noise_sweep import tiny_lm_config
    from repro.models import model as JM

    jcfg = tiny_lm_config()
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return _port_config(jcfg), params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def test_serving_engine_spare_cols_and_its_refusals(tiny_lm, tmp_path):
    cfg, params = tiny_lm
    dev = TDev(p_stuck_on=5e-3, p_stuck_off=5e-3, seed=1)

    def engine(**kw):
        return ServingEngine(cfg, params, max_batch=1, max_seq=32, device="cpu", **kw)

    eng = engine(crossbar=CrossbarMode(enabled=True, device=dev), spare_cols=16)
    assert eng.crossbar.device.spare_cols == 16
    reps = eng.repair_reports()
    assert len(reps) == 7  # q, k, v, o, mlp wi, wo, head
    flat = [r for v in reps.values() for r in (v if isinstance(v, tuple) else (v,))]
    assert all(r.n_repaired > 0 for r in flat)
    with pytest.raises(ValueError, match="nothing to repair"):
        engine(crossbar=CrossbarMode(enabled=True, device=TDev(sigma=0.1)), spare_cols=16)
    with pytest.raises(ValueError, match="no fault model"):
        engine(crossbar=CrossbarMode(enabled=True), spare_cols=16)
    with pytest.raises(ValueError, match="prebuilt"):
        engine(crossbar=dataclasses.replace(eng.crossbar), spare_cols=4)
    off = engine(crossbar=CrossbarMode(enabled=True, device=dev.replace(spare_cols=16)), spare_cols=0)
    assert off.crossbar.device.spare_cols == 0 and off.repair_reports() == {}
    assert engine(spare_cols=0).crossbar is None
    eng.save_artifacts(str(tmp_path))
    with pytest.raises(ValueError, match="rebudget"):
        engine(crossbar=CrossbarMode(enabled=True, device=dev), restore_artifacts=str(tmp_path), spare_cols=0)
    back = engine(crossbar=CrossbarMode(enabled=True, device=dev), restore_artifacts=str(tmp_path))
    assert back.repair_reports() == reps


def test_logit_recovery_at_1pct_faults_with_64_spares(tiny_lm):
    """At p_stuck_on + p_stuck_off = 1e-2, 64 spares a group recover at least
    70 % of the stuck-cell logit MSE (the reference's floor), every
    projection programmed as in the reference's harness (``fast=False``)."""
    cfg, params = tiny_lm
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 8)))

    def logits(dev):
        prog = tprog.program_model(params, device_cfg=dev, fast=False, device="cpu")
        with crossbar_mode(CrossbarMode(enabled=True, fast=False, strict=True, programmed=prog)), prog.bind():
            return TM.forward(params, cfg, tokens).numpy()

    y_ideal = logits(None)
    dev = TDev(p_stuck_on=5e-3, p_stuck_off=5e-3, seed=0)
    mse_off = float(np.mean((logits(dev) - y_ideal) ** 2))
    mse_on = float(np.mean((logits(dev.replace(spare_cols=64)) - y_ideal) ** 2))
    assert mse_off > 0.0
    assert 1.0 - mse_on / mse_off >= 0.70, (mse_off, mse_on)
