"""PyTorch port, the embedding front end (musicgen-large's audio frames,
pixtral-12b's image patches: precomputed (B, S, D) embeddings in place of
tokens) against the JAX package: the configs, the init tree (no embedding
table, always an untied head), the digital forward, prefill and decode,
decode against teacher forcing, the loss and its gradients on the stub
dataset's batches, a chip the JAX engine programmed served from the port,
the artifact names, store and plan, the engine (it programs and checks its
chip, and refuses requests where the reference's engine fails on them) and
the launchers.

Every model is the reduced config (float32: 2 layers, d_model 64, 4 heads
of which 2 KV heads, vocab 256), its params drawn by the port's
``init_model`` and handed to both packages (the reference's own eager init
costs seconds; its tree is held to this one's names and shapes in
``test_init_tree_is_the_reference_tree``)."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_serving import fresh_engine
from repro import configs as jconfigs
from repro.analysis import verify_store as j_verify_store
from repro.core import planner as jplanner
from repro.data import EmbeddingStubDataset as JStub
from repro.device import programmed as jprog
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import restore_programmed
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import planner as tplanner
from repro_torch.data import EmbeddingStubDataset, make_dataset
from repro_torch.device import programmed as tprog
from repro_torch.kernels import crossbar_vmm as kvmm
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine
from repro_torch.serving.graphs import named_leaves
from repro_torch.train import value_and_grad
from repro_torch.tree import flatten

ARCHS = ("musicgen-large", "pixtral-12b")
# Digital logits and caches, max |d| / max |a|: the same float32 arithmetic
# in another order (XLA-CPU against torch-CPU) through 2 layers and the head.
DIGITAL = 1e-4
# The loss and each gradient leaf's rel-L2 (test_torch_train's bars).
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
# The reference's test_decode_matches_teacher_forcing.
TEACHER = dict(rtol=2e-3, atol=2e-3)
# A chip both packages serve: inputs are quantized per call, so the logits
# part by a few LSBs of the head's 16-bit output codes (one LSB is x_scale *
# w_scale * 2**drop_lsb), as for the dense models (test_torch_dense_families:
# 8 LSBs and rel-L2 0.02).
CHIP_HEAD_LSBS = 8
CHIP_REL_L2 = 0.02
# (B, S) of the prompt, and the decode steps after it
B, S, STEPS = 2, 8, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its reduced models' ops are
    tiny, and a pool of threads a test worker spins against the other
    workers' on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(name, reference config, port config, the reference's params, the
    port's params): the same arrays in both, drawn by the port's
    ``init_model`` (seed 0)."""
    name = request.param
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    tcfg = reduced(get_config(name))
    arrays = tree_to_numpy(TM.init_model(tcfg, 0, device="cpu"))
    return name, jcfg, tcfg, jax.tree.map(jnp.asarray, arrays), params_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def jax_chip(model, tmp_path_factory):
    """An ideal chip of the reduced model programmed and saved by the JAX
    engine, and that engine."""
    name, jcfg, _, jparams, _ = model
    d = str(tmp_path_factory.mktemp(f"{name}-ideal"))
    eng = JEngine(jcfg, jparams, max_batch=B, max_seq=64, crossbar=JL.CrossbarMode(enabled=True, strict=True))
    eng.save_artifacts(d)
    return d, eng


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


# the reference's entry points, one compiled program each
_j_forward = jax.jit(JM.forward, static_argnums=1)
_j_prefill = jax.jit(JM.prefill, static_argnums=1)
_j_decode = jax.jit(JM.decode_step, static_argnums=1)


def _port_run(tparams, tcfg, x):
    """The port's prefill of ``x[:, :S]`` and a decode step for each of the
    ``STEPS`` frames after it: the logits of each, and the cache."""
    cache = TM.init_cache(tcfg, B, S + 8, torch.float32, "cpu")
    lt, cache = TM.prefill(tparams, tcfg, torch.from_numpy(x[:, :S]), cache)
    out = [lt.numpy()]
    for t in range(STEPS):
        lt, cache = TM.decode_step(tparams, tcfg, torch.from_numpy(x[:, S + t:S + t + 1]), torch.tensor(S + t), cache)
        out.append(lt.numpy())
    return out, cache


# ---------------------------------------------------------------------------
# Configs and the init tree
# ---------------------------------------------------------------------------


def test_config_is_the_reference_config(model):
    name, jcfg, tcfg, _, _ = model
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jconfigs.get_config(name))
    assert tcfg.frontend == "embed" and not tcfg.tie_embeddings
    assert ALL_ARCHS == jconfigs.ALL_ARCHS


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tie_embeddings"])
@pytest.mark.parametrize("name", ARCHS)
def test_init_tree_is_the_reference_tree(name, tie):
    """Names and shapes leaf for leaf: no ``embed`` table for an embedding
    front end, and a ``head`` even where the config ties embeddings."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(name)), tie_embeddings=tie)
    tcfg = dataclasses.replace(reduced(get_config(name)), tie_embeddings=tie)
    shapes, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32, shape_only=True)
    theirs = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
              for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ours = {k: tuple(v.shape) for k, v in flatten(TM.init_model(tcfg, 0, device="cpu")).items()}
    assert ours == theirs
    assert ours["head"] == (tcfg.d_model, tcfg.vocab_size) and not any(k.startswith("embed") for k in ours)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_frames_are_rounded_before_layer_0(name):
    """At the config's bfloat16 the float32 frames are cast to bfloat16 as
    the reference casts them, bit for bit."""
    cfg = get_config(name)
    x = _frames(1, 1, 3, cfg.d_model)
    got = TM._embed_input({}, cfg, torch.from_numpy(x))
    want = np.asarray(JM._embed_input({}, jconfigs.get_config(name), jnp.asarray(x)).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# The digital model
# ---------------------------------------------------------------------------


def test_forward_matches_the_reference(model):
    _, jcfg, tcfg, jparams, tparams = model
    x = _frames(2, B, S, tcfg.d_model)
    got = TM.forward(tparams, tcfg, torch.from_numpy(x))
    assert got.shape == (B, S, tcfg.vocab_size)
    assert _rel(_j_forward(jparams, jcfg, jnp.asarray(x)), got.numpy()) <= DIGITAL


def test_prefill_and_decode_match_the_reference(model):
    """A prefill of S frames, then ``STEPS`` decode steps each fed the next
    frame: every step's logits and the cache at the end."""
    _, jcfg, tcfg, jparams, tparams = model
    x = _frames(3, B, S + STEPS, tcfg.d_model)
    ours, ct = _port_run(tparams, tcfg, x)
    cj = JM.init_cache(jcfg, B, S + 8, jnp.float32)
    lj, cj = _j_prefill(jparams, jcfg, jnp.asarray(x[:, :S]), cj)
    theirs = [lj]
    for t in range(STEPS):
        lj, cj = _j_decode(jparams, jcfg, jnp.asarray(x[:, S + t:S + t + 1]), jnp.int32(S + t), cj)
        theirs.append(lj)
    for t, (a, b) in enumerate(zip(theirs, ours)):
        assert a.shape == b.shape and _rel(a, b) <= DIGITAL, t
    mine = dict(named_leaves(ct))
    for n, a in named_leaves(cj):
        assert _rel(a, mine[n].numpy()) <= DIGITAL, n


def test_decode_matches_teacher_forcing(model):
    """The port's prefill and decode against its own forward over the whole
    sequence (the reference's test_decode_matches_teacher_forcing)."""
    _, _, tcfg, _, tparams = model
    x = _frames(4, B, S + STEPS, tcfg.d_model)
    full = TM.forward(tparams, tcfg, torch.from_numpy(x)).numpy()
    ours, _ = _port_run(tparams, tcfg, x)
    for t, got in enumerate(ours):
        np.testing.assert_allclose(got, full[:, S - 1 + t], **TEACHER)


def test_loss_and_grads_match_the_reference(model):
    """``loss_fn`` and its gradients on the stub dataset's first batch (the
    port's ``make_dataset`` picks the stub, and its batch is the
    reference's) against ``jax.value_and_grad``."""
    _, jcfg, tcfg, jparams, tparams = model
    ds = make_dataset(tcfg, 16, 2, seed=3)
    assert isinstance(ds, EmbeddingStubDataset)
    batch = ds.batch_at(0)
    ref = JStub(jcfg.d_model, jcfg.vocab_size, 16, 2, 3).batch_at(0)
    assert batch.keys() == ref.keys() and all(np.array_equal(batch[k], ref[k]) for k in batch)
    assert batch["inputs"].shape == (2, 16, tcfg.d_model) and batch["inputs"].dtype == np.float32
    jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(jparams, jcfg, jax.tree.map(jnp.asarray, ref))
    tl, tg = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(tl)) and float(tl) == pytest.approx(float(jl), rel=LOSS_REL)
    theirs, ours = flatten(jax.tree.map(np.asarray, jg)), flatten(tg)
    assert sorted(theirs) == sorted(ours)
    for k, g in theirs.items():
        assert np.linalg.norm(ours[k].numpy() - g) <= GRAD_REL_L2 * np.linalg.norm(g), k


# ---------------------------------------------------------------------------
# A chip the JAX engine programmed
# ---------------------------------------------------------------------------


def test_jax_programmed_chip_serves_prefill_and_decode_from_the_port(model, jax_chip):
    """The port restores the JAX engine's chip and serves a prefill and two
    decode steps on frames from it: one K1 call (its plain version here) a
    projection of every forward, no miss, every artifact consumed, and each
    step's logits within ``CHIP_HEAD_LSBS`` of the head's output LSB and
    ``CHIP_REL_L2`` of the JAX chip's."""
    _, jcfg, tcfg, jparams, tparams = model
    d, jeng = jax_chip
    tchip = restore_programmed(d, device="cpu")
    assert sorted(tchip.by_name) == sorted(jeng.programmed.by_name)
    x = _frames(5, B, S + STEPS, tcfg.d_model)
    heads = []
    real = tprog.programmed_matmul

    def spy(xx, art, **kw):
        if art is tchip.by_name["head"]:
            heads.append(float(xx.max()))
        return real(xx, art, **kw)

    tprog.programmed_matmul = spy
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()
    kvmm.reset_counters()
    try:
        with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=tchip, strict=True)), tchip.bind():
            ours, _ = _port_run(tparams, tcfg, x)
    finally:
        tprog.programmed_matmul = real
    assert TL.crossbar_misses() == ()
    tchip.verify_consumed()
    tprog.reset_consumed_artifact_names()
    assert tchip.calls_per_forward == 6 * tcfg.n_layers + 1
    assert kvmm.PLAIN_CALLS["crossbar"] == tchip.calls_per_forward * (1 + STEPS)

    j_prefill = jax.jit(lambda p, xx, c: jeng.runner._with_crossbar(lambda: JM.prefill(p, jcfg, xx, c)))
    j_decode = jax.jit(lambda p, xx, pos, c: jeng.runner._with_crossbar(lambda: JM.decode_step(p, jcfg, xx, pos, c)))
    cj = JM.init_cache(jcfg, B, S + 8, jnp.float32)
    lj, cj = j_prefill(jparams, jnp.asarray(x[:, :S]), cj)
    theirs = [np.asarray(lj)]
    for t in range(STEPS):
        lj, cj = j_decode(jparams, jnp.asarray(x[:, S + t:S + t + 1]), jnp.int32(S + t), cj)
        theirs.append(np.asarray(lj))
    head = tchip.by_name["head"]
    for t, (got, ref) in enumerate(zip(ours, theirs)):
        lsb = (heads[t] / 65535.0) * float(head.w_scale) * 2.0 ** head.spec.drop_lsb
        assert np.abs(got - ref).max() <= CHIP_HEAD_LSBS * lsb, (t, np.abs(got - ref).max() / lsb)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < CHIP_REL_L2, t


def test_artifact_names_store_and_plan_are_the_reference_ones(model, jax_chip, tmp_path):
    """The programmed name set (the head and the stages' projections, no
    ``embed/tokens``), the port's own chip saved and read back by the
    reference's ``verify_store``, and ``plan_model(...).to_json()``
    string-equal to the reference's."""
    _, jcfg, tcfg, jparams, tparams = model
    d, _ = jax_chip
    names = tprog.expected_artifact_names(tparams)
    assert names == {k: tuple(v) for k, v in jprog.expected_artifact_names(jparams).items()}
    assert "head" in names and not any(n.startswith("embed") for n in names)
    assert {n.split("/")[0] for n in names} == {"head", "stage0"}
    eng = ServingEngine(tcfg, tparams, max_batch=B, max_seq=64, crossbar=CrossbarMode(enabled=True, strict=True),
                        device="cpu")
    eng.save_artifacts(str(tmp_path))
    report = j_verify_store(str(tmp_path), expected=jprog.expected_artifact_names(jparams))
    assert report.ok, report.summary()
    assert tplanner.plan_model(tparams).to_json() == jplanner.plan_model(jparams).to_json()


# ---------------------------------------------------------------------------
# The engine and the launchers
# ---------------------------------------------------------------------------


def test_engine_programs_checks_and_refuses_requests(model, jax_chip):
    """The engine restores (and checks the coverage of) the JAX chip, and
    ``submit`` refuses a frame prompt and a token prompt with a
    ``ValueError`` naming the front end, where the reference's engine
    raises ``ValueError`` on the same requests at their admission."""
    _, jcfg, tcfg, jparams, tparams = model
    d, jeng = jax_chip
    eng = ServingEngine(tcfg, tparams, max_batch=B, max_seq=64, device="cpu",
                        crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=d)
    assert sorted(eng.programmed.by_name) == sorted(jeng.programmed.by_name)
    eng.runner.verify_crossbar_coverage()
    digital = JEngine(jcfg, jparams, max_batch=1, max_seq=64)
    for prompt in (_frames(6, 1, 5, tcfg.d_model)[0], np.arange(1, 6)):
        with pytest.raises(ValueError, match="front end 'embed'"):
            eng.submit(prompt)
        assert not eng.pending
        ref = fresh_engine(digital)
        ref.submit(prompt, max_new_tokens=2)
        with pytest.raises(ValueError):
            ref.step()


@pytest.mark.parametrize("name", ARCHS)
def test_serve_launcher_refuses_the_arch(name):
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        serve_launcher.main(["--arch", name, "--reduced", "--device", "cpu"])
    assert "front end" in err.getvalue()


def test_train_launcher_trains_two_reduced_steps(capsys):
    train_launcher.main(["--arch", "musicgen-large", "--reduced", "--steps", "2", "--batch", "2", "--seq", "8",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done" in out and "'loss'" in out and "'skipped': 0" in out
