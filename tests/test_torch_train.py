"""PyTorch port, the training path (``models.model.loss_fn``,
``repro_torch.train``, the weight checkpoints, the launcher) against the
JAX package on the same seeded numpy inputs: the loss and every leaf's
gradient against ``jax.value_and_grad(repro.models.model.loss_fn)`` on tiny
smollm (a sequence long enough for two loss chunks), gemma2 (softcaps,
post-norm, a local window), kimi-style MoE and xlstm (sLSTM and mLSTM)
configs; one SGD train step
against the reference's; Adafactor's update on the MoE model's gradients;
checkpoints both ways with bfloat16 leaves; and, on the port, the NaN
skip, microbatches, resume determinism, the straggler monitor and the
launcher's resume.

An AdamW step is not held to the reference's as a whole: Adam divides each
gradient element by its own magnitude, so an element whose gradient is near
0 may flip sign between frameworks and move by 2 lr.  Its update is held to
the reference's on the same grads and state in ``test_torch_optim.py``."""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro.checkpoint import restore_checkpoint as j_restore, save_checkpoint as j_save
from repro.models import model as JM
from repro.train import make_train_step as j_make_train_step
from repro_torch import optim as topt
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as launcher
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode, crossbar_mode
from repro_torch.train import StragglerMonitor, TrainLoop, make_train_step, value_and_grad
from repro_torch.tree import flatten, unflatten

# The loss: float32 sums in another order (XLA-CPU against torch-CPU), over
# up to 2048 positions.  Gradients: each leaf's rel-L2 to the reference's.
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
# one SGD step moves params by lr x (clipped) grads, which differ as above
STEP = dict(rtol=1e-5, atol=1e-6)

# (arch, batch, sequence, masked, reduced() overrides): smollm's 1024
# positions run the loss in two chunks of 512; gemma2's 24 run past its
# reduced window of 16, under a mask; kimi at width 128 so that Adafactor
# factors its (L, E, D, F) banks; xlstm through the sLSTM scan's backward
# (its plain version on the CPU)
CASES = {
    "smollm-360m": (1, 1024, False, {}),
    "gemma2-9b": (2, 24, True, {}),
    "kimi-k2-1t-a32b": (2, 16, False, {"d_model": 128, "moe_d_ff": 128}),
    "xlstm-350m": (2, 16, False, {}),
}


def _batch(vocab, B, S, seed, mask=False):
    rng = np.random.default_rng(seed)
    b = {
        "inputs": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
        "targets": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
    }
    if mask:
        b["mask"] = (rng.uniform(size=(B, S)) < 0.7).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(tcfg, tparams, batch):
    loss, grads = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams, _torch_batch(batch))
    return float(loss), {k: g.numpy() for k, g in flatten(grads).items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One config: the reference's loss and grads (one ``value_and_grad``
    for the file) and the port's on the same params and batch."""
    arch = request.param
    B, S, masked, kw = CASES[arch]
    jcfg = jconfigs.reduced(jconfigs.get_config(arch), **kw)
    tcfg = reduced(get_config(arch), **kw)
    jparams, _ = JM.init_model(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    nparams = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg.vocab_size, B, S, seed=2, mask=masked)
    jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch)
    )
    tparams = params_from_numpy(nparams, device="cpu")
    tl, tg = _port_grads(tcfg, tparams, batch)
    return dict(
        arch=arch, jcfg=jcfg, tcfg=tcfg, nparams=nparams, batch=batch,
        ref=(float(jl), flatten(jax.tree.map(np.asarray, jg))), port=(tl, tg),
    )


def test_loss_matches_reference(case):
    (jl, _), (tl, _) = case["ref"], case["port"]
    assert np.isfinite(tl)
    assert tl == pytest.approx(jl, rel=LOSS_REL)


def test_every_gradient_matches_reference(case):
    (_, jg), (_, tg) = case["ref"], case["port"]
    assert jg.keys() == tg.keys()
    for k, ref in jg.items():
        err = np.linalg.norm(tg[k] - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_REL_L2, f"{case['arch']} {k}: rel-L2 {err}"
        assert np.linalg.norm(ref) > 0, f"{case['arch']} {k}: no gradient"


def test_all_masked_batch_costs_nothing(case):
    """The masked sum over max(sum(mask), 1) (the masked loss itself is held
    to the reference's on gemma2's case): an all-masked batch costs 0."""
    batch = dict(case["batch"], mask=np.zeros(case["batch"]["targets"].shape, np.float32))
    with torch.no_grad():
        zero = TM.loss_fn(params_from_numpy(case["nparams"], device="cpu"), case["tcfg"], _torch_batch(batch))
    assert float(zero) == 0.0


def test_remat_changes_only_the_order_of_the_tied_gradient(case):
    """``cfg.remat`` recomputes each layer in backward: the same loss and
    every gradient bit for bit, except that a tied embedding's gradient sums
    its lookup's and the head chunks' parts in another order (float32
    rounding only).  On a short batch of the case's config."""
    tparams = params_from_numpy(case["nparams"], device="cpu")
    batch = _batch(case["tcfg"].vocab_size, 2, 16, seed=7)
    tl, tg = _port_grads(case["tcfg"], tparams, batch)
    rl, rg = _port_grads(dataclasses.replace(case["tcfg"], remat=True), tparams, batch)
    assert rl == tl
    for k, g in tg.items():
        if k == "embed/tokens" and case["tcfg"].tie_embeddings:
            assert np.linalg.norm(rg[k] - g) <= 1e-6 * np.linalg.norm(g), k
        else:
            np.testing.assert_array_equal(rg[k], g, err_msg=k)


def test_adafactor_update_on_the_models_grads_matches_reference(case):
    """Adafactor on the model's tree (for kimi: the (L, E, D, F) banks
    factored per expert) and the reference's own grads, from the
    reference's initial state, at step 2."""
    grads = unflatten(case["nparams"], case["ref"][1])
    jparams = jax.tree.map(jnp.asarray, case["nparams"])
    jo, to = jopt.adafactor(jopt.constant(1e-2)), topt.adafactor(topt.constant(1e-2))
    jstate = jo.init(jparams)
    jp, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, grads), jstate, jparams, jnp.int32(2))
    tp = params_from_numpy(case["nparams"], device="cpu")
    ts = params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    to.update(params_from_numpy(grads, device="cpu"), ts, tp, 2)
    if case["arch"] == "kimi-k2-1t-a32b":
        assert ts["acc"]["stage1"]["b0"]["ffn"]["wi"]["vr"].shape == (2, 8, 128)
    for got, ref in ((tp, jp), (ts, js)):
        fr, fg = flatten(jax.tree.map(np.asarray, ref)), flatten(tree_to_numpy(got))
        assert fr.keys() == fg.keys()
        for k in fr:
            np.testing.assert_allclose(fg[k], fr[k], rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# One train step against the reference's
# ---------------------------------------------------------------------------

def test_sgd_train_step_matches_reference():
    """SGD is linear in the grads, so a whole step is held to the
    reference's: loss, grad norm, skipped, and the new params and momentum."""
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    tcfg = reduced(get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    nparams = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg.vocab_size, 2, 32, seed=6)
    jo = jopt.sgd(jopt.constant(0.1))
    jp, js, jstep, jm = jax.jit(j_make_train_step(jcfg, jo))(jparams, jo.init(jparams), jnp.int32(3), jax.tree.map(jnp.asarray, batch))
    to = topt.sgd(topt.constant(0.1))
    tp = params_from_numpy(nparams, device="cpu")
    ts = to.init(tp)
    tp, ts, tstep, tm = make_train_step(tcfg, to)(tp, ts, torch.tensor(3, dtype=torch.int32), _torch_batch(batch))
    assert int(tstep) == int(jstep) == 4 and int(tm["skipped"]) == int(jm["skipped"]) == 0
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=GRAD_REL_L2)
    for got, ref in ((tp, jp), (ts, js)):
        fr, fg = flatten(jax.tree.map(np.asarray, ref)), flatten(tree_to_numpy(got))
        for k in fr:
            np.testing.assert_allclose(fg[k], fr[k], **STEP, err_msg=k)
    assert not any(t.requires_grad for t in flatten(tp).values())  # plain tensors after the step


# ---------------------------------------------------------------------------
# The train step and loop on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_config("smollm-360m"))
    batch = _torch_batch(_batch(cfg.vocab_size, 4, 8, seed=3))
    return cfg, batch


def test_nan_step_is_skipped(small):
    cfg, batch = small
    params = TM.init_model(cfg, 0, device="cpu")
    opt = topt.make_optimizer("adamw", topt.constant(1e-3))
    state = opt.init(params)
    before = tree_to_numpy({"p": params, "s": state})

    def poisoned_loss(p, b):
        return TM.loss_fn(p, cfg, b) * float("nan")

    p2, s2, step, metrics = make_train_step(cfg, opt, loss_fn=poisoned_loss)(params, state, 0, batch)
    assert int(metrics["skipped"]) == 1 and not np.isfinite(float(metrics["loss"]))
    assert int(step) == 1
    after = flatten(tree_to_numpy({"p": p2, "s": s2}))
    for k, v in flatten(before).items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)


def test_microbatched_grad_accum_matches_full(small):
    cfg, batch = small
    opt = topt.make_optimizer("sgd", topt.constant(1e-2))
    p1 = TM.init_model(cfg, 0, device="cpu")
    p2 = TM.init_model(cfg, 0, device="cpu")
    p1, _, _, m1 = make_train_step(cfg, opt, microbatches=1)(p1, opt.init(p1), 0, batch)
    p2, _, _, m2 = make_train_step(cfg, opt, microbatches=2)(p2, opt.init(p2), 0, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    d = max(float(torch.max(torch.abs(a - b))) for a, b in zip(flatten(p1).values(), flatten(p2).values()))
    assert d < 1e-5


def test_train_resume_is_deterministic(tmp_path, small):
    """6 uninterrupted steps against 3 + checkpoint + fresh restore + 3:
    every param and state leaf equal."""
    cfg, _ = small
    opt = topt.make_optimizer("adamw", topt.cosine_with_warmup(1e-3, 2, 6))
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=0)

    def fresh():
        p = TM.init_model(cfg, 0, device="cpu")
        return p, opt.init(p)

    p, o = fresh()
    p_ref, o_ref = TrainLoop(cfg, step_fn, ds, ckpt_dir=None, log_every=100).run(p, o, 6)

    p, o = fresh()
    TrainLoop(cfg, step_fn, ds, ckpt_dir=str(tmp_path), ckpt_every=3, log_every=100).run(p, o, 3)
    assert latest_step(str(tmp_path)) == 3
    p2, o2 = fresh()
    loop2 = TrainLoop(cfg, step_fn, ds, ckpt_dir=str(tmp_path), ckpt_every=100, log_every=100)
    p2, o2, start = loop2.maybe_resume(p2, o2)
    assert start == 3
    p_res, o_res = loop2.run(p2, o2, 6, start_step=start)
    assert len(loop2.step_seconds) == 3
    ref, got = flatten({"p": p_ref, "o": o_ref}), flatten({"p": p_res, "o": o_res})
    assert ref.keys() == got.keys()
    for k in ref:
        assert torch.equal(ref[k], got[k]), k


def test_loop_heartbeat_and_history(tmp_path, small):
    cfg, _ = small
    opt = topt.make_optimizer("sgd", topt.constant(1e-2))
    p = TM.init_model(cfg, 0, device="cpu")
    hb = tmp_path / "hb.json"
    loop = TrainLoop(cfg, make_train_step(cfg, opt), SyntheticLMDataset(cfg.vocab_size, 8, 2), log_every=2,
                     heartbeat_path=str(hb))
    loop.run(p, opt.init(p), 5)
    assert [r["step"] for r in loop.history if not r["straggler"]] == [0, 2, 4]
    assert json.loads(hb.read_text())["step"] == 4
    assert all(r["skipped"] == 0 and np.isfinite(r["loss"]) for r in loop.history)


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=3.0)
    for _ in range(10):
        assert not m.observe(0.1)
    assert m.observe(1.0)  # 10x the EMA
    assert m.flagged == 1


def test_launcher_resumes(tmp_path, capsys):
    args = ["--arch", "smollm-360m", "--reduced", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    launcher.main(args + ["--steps", "2"])
    first = capsys.readouterr().out
    assert "resumed" not in first and "[train] done" in first
    assert latest_step(str(tmp_path)) == 2
    launcher.main(args + ["--steps", "4"])
    second = capsys.readouterr().out
    assert "[train] resumed from step 2" in second and "[train] done" in second
    assert latest_step(str(tmp_path)) == 4


def test_launcher_refuses_model_parallel(capsys):
    """Over a mesh an MoE config (and one with ``cfg.fsdp``) is refused,
    naming the roadmap item, and not trained replicated."""
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "deepseek-v2-236b", "--reduced", "--model-parallel", "2", "--ranks", "4",
                       "--device", "cpu"])
    err = capsys.readouterr().err
    assert "MoE" in err and launcher.MESH_REFUSED in err


def test_launcher_trains_and_resumes_over_a_mesh(tmp_path, capfd):
    """``--model-parallel 2 --ranks 4``: a (2, 2) mesh of spawned ranks
    trains, checkpoints the whole tree and resumes it."""
    args = ["--arch", "smollm-360m", "--reduced", "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu", "--model-parallel", "2", "--ranks", "4"]
    launcher.main(args + ["--steps", "2"])
    first = capfd.readouterr().out
    assert "mesh=(data 2, model 2)" in first and "resumed" not in first and "[train] done" in first
    assert latest_step(str(tmp_path)) == 2
    launcher.main(args + ["--steps", "3"])
    second = capfd.readouterr().out
    assert "[train] resumed from step 2" in second and "[train] done" in second
    assert latest_step(str(tmp_path)) == 3


def test_launcher_trains_pure_dp_over_a_mesh(capfd):
    """xlstm's ``pure_dp`` layout over 4 ranks (the batch over both axes),
    reduced: the launcher keeps the config's layout (its sLSTM blocks have
    no tensor-parallel form)."""
    launcher.main(["--arch", "xlstm-350m", "--reduced", "--batch", "4", "--seq", "16", "--device", "cpu",
                   "--model-parallel", "2", "--ranks", "4", "--steps", "1"])
    out = capfd.readouterr().out
    assert "layout=pure_dp" in out and "[train] done" in out


def test_crossbar_mode_trains_nothing(small):
    """Under an enabled crossbar mode the loss runs only without grad (a
    chip's evaluation loss, near the plain model's); a train step is refused."""
    cfg, batch = small
    params = TM.init_model(cfg, 0, device="cpu")
    opt = topt.sgd(topt.constant(1e-2))
    with torch.no_grad():
        plain = float(TM.loss_fn(params, cfg, batch))
    with crossbar_mode(CrossbarMode(enabled=True)):
        with pytest.raises(RuntimeError, match="without grad"):
            TM.loss_fn(params, cfg, batch)
        with pytest.raises(RuntimeError, match="plain matmuls"):
            make_train_step(cfg, opt)
        with torch.no_grad():
            chip = float(TM.loss_fn(params, cfg, batch))
    assert np.isfinite(chip) and chip == pytest.approx(plain, rel=1e-2)
    step_fn = make_train_step(cfg, opt)
    with crossbar_mode(CrossbarMode(enabled=True)), pytest.raises(RuntimeError, match="plain matmuls"):
        step_fn(params, opt.init(params), 0, batch)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _mixed_tree(rng):
    import ml_dtypes

    return {
        "params": {
            "emb": rng.normal(size=(6, 4)).astype(ml_dtypes.bfloat16),
            "stage0": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32)},
        },
        "opt": {"m": {"w": rng.normal(size=(5,)).astype(np.float32)}, "count": np.arange(3, dtype=np.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = params_from_numpy(_mixed_tree(rng), device="cpu")
    save_checkpoint(str(tmp_path), 7, tree, {"note": "x"})
    os.makedirs(tmp_path / "step_000000009.tmp")  # a killed write is never restored
    assert latest_step(str(tmp_path)) == 7
    assert latest_step(str(tmp_path / "none")) is None
    restored, step, meta = restore_checkpoint(str(tmp_path), None, tree)
    assert step == 7 and meta == {"note": "x"}
    for k, v in flatten(tree).items():
        got = flatten(restored)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), None, tree)


def test_checkpoint_manager_async_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
        tree["w"].add_(1)  # an update after the snapshot does not reach it
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]
    got, _, _ = restore_checkpoint(str(tmp_path), 4, tree)
    assert torch.equal(got["w"], torch.full((3,), 3.0))
    assert mgr.snapshot_seconds is not None and mgr.write_seconds is not None


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A JAX-written checkpoint, bf16 leaf included, restores bit-equal by
    its manifest's dtype (the reference's own restore returns such a leaf
    as raw ``|V2`` words)."""
    tree = _mixed_tree(np.random.default_rng(1))
    j_save(str(tmp_path), 5, jax.tree.map(jnp.asarray, tree), {"by": "jax"})
    like = params_from_numpy(tree, device="cpu")
    got, step, meta = restore_checkpoint(str(tmp_path), None, like)
    assert step == 5 and meta == {"by": "jax"}
    assert got["params"]["emb"].dtype == torch.bfloat16
    ref = flatten(tree)
    for k, v in flatten(tree_to_numpy(got)).items():
        want = ref[k].view(np.uint16) if ref[k].dtype.name == "bfloat16" else ref[k]
        assert v.dtype == want.dtype and np.array_equal(v, want), k


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    """The same tree saved by both packages: the same files, byte for byte,
    the same manifest; the reference's restore reads the port's."""
    tree = _mixed_tree(np.random.default_rng(2))
    j_save(str(tmp_path / "jax"), 3, jax.tree.map(jnp.asarray, tree))
    save_checkpoint(str(tmp_path / "port"), 3, params_from_numpy(tree, device="cpu"))
    dj, dp = tmp_path / "jax" / "step_000000003", tmp_path / "port" / "step_000000003"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    for f in os.listdir(dj):
        if f.endswith(".npy"):
            assert (dj / f).read_bytes() == (dp / f).read_bytes(), f
    assert json.loads((dj / "manifest.json").read_text()) == json.loads((dp / "manifest.json").read_text())
    got, step, _ = j_restore(str(tmp_path / "port"), None, jax.tree.map(jnp.asarray, tree))
    assert step == 3
    for k, v in flatten(jax.tree.map(np.asarray, tree)).items():
        assert np.asarray(flatten(got)[k]).tobytes() == v.tobytes(), k


def test_optimizer_state_carries_both_ways(tmp_path):
    """An AdamW state of the reference's layout, carried with
    ``params_from_numpy`` and saved by the port, restores in the reference
    equal leaf for leaf."""
    cfg = jconfigs.reduced(jconfigs.get_config("smollm-360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    jstate = jopt.adamw(jopt.constant(1e-3)).init(jparams)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert flatten(state).keys() == flatten(jax.tree.map(np.asarray, jstate)).keys()
    save_checkpoint(str(tmp_path), 1, {"opt": state})
    got, _, _ = j_restore(str(tmp_path), None, {"opt": jstate})
    for k, v in flatten(jax.tree.map(np.asarray, {"opt": jstate})).items():
        np.testing.assert_array_equal(np.asarray(flatten(got)[k]), v, err_msg=k)
