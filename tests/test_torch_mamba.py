"""PyTorch port, the mamba block and the hybrid family (jamba) against the
JAX package: the causal conv, the selective scan, the block in prefill
(S = 2 under the conv's width, 5 and 16) and decode with both cache leaves,
the model's tree, init scales, cache axes and artifact names, the carried
tree (whole and as a rank's share of the experts), the whole model's
digital logits in forward, prefill and decode, a chip the JAX package
programmed served from the port's store (logits and the JAX engine's greedy
tokens), and the engine's recurrent admission.

Every model is the reduced jamba (float32: 8 layers, d_model 64, 8 experts
top 2 with no shared expert, d_inner 128, d_state 8, dt_rank 8, vocab 256),
its params carried from the JAX package by ``params_from_numpy``.  The
block pool's paging of a hybrid request is in
``test_torch_hybrid_paging.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_serving import fresh_engine, port_config, same_tokens, spy_ticks
from repro import configs as jconfigs
from repro.checkpoint import save_programmed as j_save
from repro.device import programmed as jprog
from repro.device.programmed import program_model as j_program_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import restore_programmed
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.device import programmed as tprog
from repro_torch.kernels import crossbar_vmm as kvmm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.layers import CrossbarMode
from repro_torch.models.moe import ExpertShare
from repro_torch.serving import ServingEngine
from repro_torch.serving.graphs import named_leaves
from repro_torch.tree import flatten

JAMBA = "jamba-v0.1-52b"
# One block and its cache (max |d| / max |y|): the same float32 arithmetic
# with other exp / log1p / sigmoid implementations and another summation
# order in the matmuls and the d_state read-out, and a sequential scan
# against the reference's associative one (other products of the same
# factors); a few float32 ULPs a step, which the scan does not amplify
# (|a| < 1).  Measured <= 3.5e-6 over these tests.
BLOCK = 1e-5
# Whole-model logits: the same ULP differences through 8 layers, 4 routers
# (top 2 of 8; a flip would show as a large error, not a small one), the
# norms and the head.  Measured <= 4e-6.
LOGITS = 1e-4
# A chip both packages serve: the logits part by a few head LSBs (16-bit
# output codes of inputs quantized per call), as for the dense models and
# kimi-k2 (rel-L2 0.02: test_torch_dense_families, test_torch_moe).
CHIP_REL_L2 = 0.02
# Prompt seed of the chip token test.  On a chip the packages' logits part
# by a few head LSBs, and where a router's top-2 of 8 is near a tie that is
# enough to route a token to another expert, whose output dwarfs the
# residual (the reference's bank scale): over the 31 seeds of 0-399 whose
# two prompts have one length (one prefill compile of the reference's
# engine), the ideal-chip tokens differed in 8, each where a margin was
# below the discrepancy (digitally the two engines' logits agree to 1e-5 on
# every tick).  Seed 108 has a smallest margin 11.3x the discrepancy, so
# identity is guaranteed rather than lucky; same_tokens fails the test if
# that stops holding.
CHIP_SEEDS = (108,)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its reduced model's ops are
    tiny, and a pool of threads a test worker spins against the other
    workers' on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jamba():
    """The reduced jamba in both packages on the same arrays: drawn by the
    port's ``init_model`` (seed 0), handed to the reference as they are and
    to the port through ``params_from_numpy`` (the reference's own eager
    init takes ~7 s here; its tree is held to this one's names and shapes
    in ``test_config_tree_axes_and_artifact_names_equal_the_reference``)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(JAMBA))
    tcfg = reduced(get_config(JAMBA))
    arrays = tree_to_numpy(TM.init_model(tcfg, 0, device="cpu"))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, arrays), params_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def mixers(jamba):
    """Layer 0's mamba mixer in both packages, its zero-initialised
    ``conv_b`` / ``dt_bias`` / ``A_log`` moved off zero (the same numpy
    draws in both), so that every leaf acts."""
    _, _, jparams, _ = jamba
    rng = np.random.default_rng(7)
    mix = {k: np.asarray(v)[0] for k, v in jparams["stage0"]["b0"]["mixer"].items()}
    for k in ("conv_b", "dt_bias", "A_log"):
        mix[k] = (0.3 * rng.normal(size=mix[k].shape)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in mix.items()}, params_from_numpy(mix, device="cpu")


@pytest.fixture(scope="module")
def jax_chip(jamba, tmp_path_factory):
    """An ideal chip of the reduced jamba programmed (``program_model``) and
    saved (``save_programmed``) by the JAX package, and a JAX engine
    serving it."""
    jcfg, _, jparams, _ = jamba
    d = str(tmp_path_factory.mktemp("jamba-ideal"))
    jchip = j_program_model(jparams, tie_lm_head=False)
    j_save(d, jchip)
    mode = JL.CrossbarMode(enabled=True, strict=True, programmed=jchip)
    return d, jchip, JEngine(jcfg, jparams, max_batch=2, max_seq=64, crossbar=mode)


# the reference's block as one compiled program (its ops one by one cost more)
_j_block = jax.jit(JS.mamba_block, static_argnums=(2, 4))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _x(rng, B, S, D):
    return rng.normal(size=(B, S, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# The conv, the scan, the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 3, 9])
def test_causal_conv_is_the_reference_conv(jamba, mixers, S):
    _, tcfg, _, _ = jamba
    jm, tm = mixers
    x = _x(np.random.default_rng(S), 2, S, TS.d_inner_of(tcfg))
    want = JS._causal_conv(jnp.asarray(x), jm["conv_w"], jm["conv_b"])
    got = TS._causal_conv(torch.from_numpy(x), tm["conv_w"], tm["conv_b"])
    assert _rel(want, got.numpy()) <= BLOCK


@pytest.mark.parametrize("S", [7, 512])
def test_scan_is_the_reference_scan(S):
    """The sequential recurrence against the chunked associative scan, from
    a non-zero state; S = 512 runs two chunks of ``CHUNK``."""
    rng = np.random.default_rng(S)
    B, din, n = 2, 16, 4
    dt = np.abs(rng.normal(size=(B, S, din))).astype(np.float32)
    A = -np.exp(0.3 * rng.normal(size=(din, n))).astype(np.float32)
    Bs, Cs = (rng.normal(size=(B, S, n)).astype(np.float32) for _ in range(2))
    xc = rng.normal(size=(B, S, din)).astype(np.float32)
    h0 = rng.normal(size=(B, din, n)).astype(np.float32)
    a = np.exp(dt[..., None] * A)
    bx = dt[..., None] * Bs[:, :, None, :] * xc[..., None]
    h_all, h_last = JS._ssm_chunked(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    want = np.einsum("bsdn,bsn->bsd", np.asarray(h_all), Cs)
    t = lambda v: torch.from_numpy(v)  # noqa: E731
    y, h = TS._scan(t(dt), t(A), t(Bs), t(Cs), t(xc), t(h0))
    assert _rel(want, y.numpy()) <= BLOCK and _rel(h_last, h.numpy()) <= BLOCK


def test_scan_refuses_the_lengths_the_reference_refuses():
    """Past one chunk the length must be a multiple of ``CHUNK`` (the
    reference asserts it)."""
    S = TS.CHUNK + 4
    with pytest.raises(AssertionError):
        JS._ssm_chunked(jnp.zeros((1, S, 2, 2)), jnp.zeros((1, S, 2, 2)), jnp.zeros((1, 2, 2)))
    z = torch.zeros((1, S, 2))
    with pytest.raises(ValueError, match="chunk"):
        TS._scan(z, torch.zeros((2, 2)), z, z, z, torch.zeros((1, 2, 2)))


@pytest.mark.parametrize("S", [2, 5, 16])
def test_block_prefill_then_four_decode_steps(jamba, mixers, S):
    """Prefill into a zero cache (S = 2 < d_conv - 1 takes the conv state's
    zero-padded branch), then 4 decode steps: outputs and both cache leaves
    after each."""
    jcfg, tcfg, _, _ = jamba
    jm, tm = mixers
    rng = np.random.default_rng(10 + S)
    cj = JS.init_mamba_cache(jcfg, 2, jnp.float32)
    ct = TS.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in ct.items()} == {
        "h": ((2, TS.d_inner_of(tcfg), tcfg.mamba_d_state), torch.float32),
        "conv": ((2, tcfg.mamba_d_conv - 1, TS.d_inner_of(tcfg)), torch.float32),
    }
    x = _x(rng, 2, S, tcfg.d_model)
    yj, cj = _j_block(jm, jnp.asarray(x), jcfg, cj, False)
    yt, ct = TS.mamba_block(tm, torch.from_numpy(x), tcfg, ct)
    assert _rel(yj, yt.numpy()) <= BLOCK
    for step in range(5):
        if step:
            xd = _x(rng, 2, 1, tcfg.d_model)
            yj, cj = _j_block(jm, jnp.asarray(xd), jcfg, cj, True)
            yt, ct = TS.mamba_block(tm, torch.from_numpy(xd), tcfg, ct, decode=True)
            assert _rel(yj, yt.numpy()) <= BLOCK, step
        for n in ("h", "conv"):
            assert _rel(cj[n], ct[n].numpy()) <= BLOCK, (step, n)


def test_block_without_a_cache_and_the_cache_in_place(jamba, mixers):
    """No cache: the reference's output, nothing returned.  With a cache:
    the state is written into the given tensors (a captured tick reads
    them) and a prefill starts from the cache's ``h`` but not its ``conv``."""
    jcfg, tcfg, _, _ = jamba
    jm, tm = mixers
    rng = np.random.default_rng(3)
    x = _x(rng, 1, 6, tcfg.d_model)
    yj, cj = _j_block(jm, jnp.asarray(x), jcfg, None, False)
    yt, ct = TS.mamba_block(tm, torch.from_numpy(x), tcfg)
    assert cj is None and ct is None and _rel(yj, yt.numpy()) <= BLOCK
    h0 = rng.normal(size=(1, TS.d_inner_of(tcfg), tcfg.mamba_d_state)).astype(np.float32)
    stale = rng.normal(size=(1, tcfg.mamba_d_conv - 1, TS.d_inner_of(tcfg))).astype(np.float32)
    cj = {"h": jnp.asarray(h0), "conv": jnp.asarray(stale)}
    ct = {"h": torch.from_numpy(h0.copy()), "conv": torch.from_numpy(stale.copy())}
    leaves = dict(ct)
    yj, cj = _j_block(jm, jnp.asarray(x), jcfg, cj, False)
    yt, out = TS.mamba_block(tm, torch.from_numpy(x), tcfg, ct)
    assert out is ct and all(out[n] is leaves[n] for n in leaves)
    assert _rel(yj, yt.numpy()) <= BLOCK
    for n in ("h", "conv"):
        assert _rel(cj[n], out[n].numpy()) <= BLOCK, n


def test_softplus_is_the_reference_softplus():
    """No switch to ``x`` past a threshold, as ``F.softplus`` has at 20."""
    x = np.array([-60.0, -20.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(TS._softplus(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_config_tree_axes_and_artifact_names_equal_the_reference(jamba):
    """The registered config is the reference's (its reduced one too); the
    port's tree has the reference's names and shapes; the cache axes are
    the reference's; the chip holds every attention / FFN / MoE / head
    projection and none of the mamba block's."""
    jcfg, tcfg, jparams, _ = jamba
    assert get_config(JAMBA) == port_config(jconfigs.get_config(JAMBA)) and tcfg == port_config(jcfg)
    ours = TM.init_model(tcfg, 0, device="cpu")
    jshapes, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32, shape_only=True)
    theirs = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
              for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {k: tuple(v.shape) for k, v in flatten(ours).items()} == theirs
    assert "head" in ours and not any("shared" in k for k in theirs)
    assert TM.cache_axes(tcfg) == JM.cache_axes(jcfg)
    axes = dict(named_leaves(TM.cache_axes(tcfg)))
    leaves = dict(named_leaves(TM.init_cache(tcfg, 2, 8, device="cpu")))
    assert sorted(axes) == sorted(leaves) and all(len(axes[n]) == leaves[n].ndim for n in leaves)
    assert leaves["0/b0/h"].dtype == torch.float32 and leaves["0/b0/conv"].dtype == torch.bfloat16
    names = tprog.expected_artifact_names(ours)
    assert names == {k: tuple(v) for k, v in jprog.expected_artifact_names(jparams).items()}
    assert not any(n.split("/")[-1] in ("in_proj", "x_proj", "dt_proj", "out_proj") for n in names)
    assert "stage0/b3/mixer/wq" in names and "stage0/b1/ffn/wi" in names


def test_init_draws_the_reference_scales():
    """The mamba leaves at the reference's scales: matrices at fan-in**-0.5
    (``dt_proj`` at dt_rank**-0.5), ``conv_w`` at 0.5, zeros and ones (the
    7 mamba blocks' draws pooled)."""
    cfg = reduced(get_config(JAMBA), d_model=256, mamba_d_inner=512, mamba_dt_rank=64)
    stage = TM.init_model(cfg, 0, device="cpu")["stage0"]
    blocks = [f"b{i}" for i, kind in enumerate(cfg.stages[0].kinds) if kind == "mamba"]
    assert len(blocks) == 7
    mix = {k: torch.cat([stage[b]["mixer"][k].double().flatten() for b in blocks]) for k in stage["b0"]["mixer"]}
    for k, fan_in in (("in_proj", 256), ("x_proj", 512), ("dt_proj", 64), ("out_proj", 512)):
        assert abs(float(mix[k].std()) * fan_in**0.5 - 1) < 0.02, k
    assert abs(float(mix["conv_w"].std()) - 0.5) < 0.02
    for k in ("conv_b", "dt_bias", "A_log"):
        assert torch.equal(mix[k], torch.zeros_like(mix[k])), k
    assert torch.equal(mix["D_skip"], torch.ones_like(mix["D_skip"]))


@pytest.mark.parametrize("rank", [None, 0, 3])
def test_convert_carries_the_reference_tree(jamba, rank):
    """``params_from_numpy`` carries every leaf of a tree in the reference's
    layout (the reference's arrays) by name, bit for bit, and
    ``tree_to_numpy`` gives it back; with ``share=`` over 4 ranks of 16
    experts (the reduced tree's banks doubled along the expert axis) every
    bank keeps its rank's 4 experts and nothing else is cut."""
    _, _, jparams, tparams = jamba
    theirs = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    if rank is None:
        ours, back = flatten(tparams), flatten(tree_to_numpy(tparams))
        assert sorted(ours) == sorted(theirs) and "stage0/b0/mixer/A_log" in ours
        for name, a in theirs.items():
            assert np.array_equal(ours[name].numpy(), a) and np.array_equal(back[name], a), name
        return
    banks = {n for n, a in theirs.items() if a.ndim == 4}
    assert banks and all(n.split("/")[-1] in ("wi", "wg", "wo") for n in banks)
    tree = jax.tree.map(lambda a: np.concatenate([a, a + 1], axis=1) if a.ndim == 4 else np.asarray(a), jparams)
    sixteen = {"/".join(str(getattr(k, "key", k)) for k in p): a
               for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ours = flatten(params_from_numpy(tree, device="cpu", share=ExpertShare(rank, 4)))
    for name, a in sixteen.items():
        want = a[:, 4 * rank:4 * rank + 4] if name in banks else a
        assert np.array_equal(ours[name].numpy(), want), name


def test_forward_prefill_and_decode_logits(jamba):
    jcfg, tcfg, jparams, tparams = jamba
    # one compiled program each (the reference's ops one by one cost more)
    j_forward, j_prefill, j_decode = (jax.jit(f, static_argnums=1) for f in (JM.forward, JM.prefill, JM.decode_step))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, tcfg.vocab_size, size=(2, 8))
    assert _rel(j_forward(jparams, jcfg, jnp.asarray(tok)), TM.forward(tparams, tcfg, torch.from_numpy(tok)).numpy()) <= LOGITS
    cj = JM.init_cache(jcfg, 2, 16, jnp.float32)
    ct = TM.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    lj, cj = j_prefill(jparams, jcfg, jnp.asarray(tok), cj)
    lt, ct = TM.prefill(tparams, tcfg, torch.from_numpy(tok), ct)
    assert _rel(lj, lt.numpy()) <= LOGITS
    pos = np.array([8, 8])
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab_size, size=(2, 1))
        lj, cj = j_decode(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos + step), cj)
        lt, ct = TM.decode_step(tparams, tcfg, torch.from_numpy(nxt), torch.from_numpy(pos + step), ct)
        assert _rel(lj, lt.numpy()) <= LOGITS, step
    ours = dict(named_leaves(ct))
    for n, a in named_leaves(cj):
        assert _rel(a, ours[n].numpy()) <= LOGITS, n


# ---------------------------------------------------------------------------
# A chip the JAX package programmed
# ---------------------------------------------------------------------------


def test_jax_programmed_chip_serves_a_forward_from_the_port_store(jamba, jax_chip):
    """The port restores the JAX package's chip and serves a forward from
    it: the VMM calls a forward are the chip's (attention 4, dense FFN 2,
    MoE router + 3 an expert, the head), every artifact is consumed, none
    is a mamba projection, and no name misses."""
    _, tcfg, _, tparams = jamba
    d, _, _ = jax_chip
    tchip = restore_programmed(d, device="cpu")
    tok = np.random.default_rng(5).integers(0, tcfg.vocab_size, size=(2, 12))
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()
    kvmm.reset_counters()
    with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=tchip, strict=True)), tchip.bind():
        got = TM.forward(tparams, tcfg, torch.from_numpy(tok))
    assert TL.crossbar_misses() == () and bool(torch.isfinite(got).all())
    tchip.verify_consumed()
    consumed = tprog.consumed_artifact_names()
    tprog.reset_consumed_artifact_names()
    want = 4 + 4 * 2 + 4 * (1 + 3 * tcfg.moe_experts) + 1
    assert sum(kvmm.PLAIN_CALLS.values()) == tchip.calls_per_forward == want
    assert consumed and not any(n.split("/")[-1] in ("in_proj", "x_proj", "dt_proj", "out_proj") for n in consumed)


@pytest.mark.parametrize("seed", CHIP_SEEDS)
def test_greedy_tokens_and_logits_from_a_jax_programmed_ideal_chip(jamba, jax_chip, seed):
    """Both engines serve the chip the JAX package programmed, each request
    prefilled at its exact length with its first token from the prefill:
    the same greedy tokens, no artifact miss, and every prefill's and
    tick's logits within ``CHIP_REL_L2`` of the reference's (the same
    inputs at every step, since the tokens agree)."""
    _, tcfg, _, tparams = jamba
    d, _, jeng = jax_chip
    TL.reset_crossbar_misses()
    te = ServingEngine(
        tcfg, tparams, max_batch=2, max_seq=64, device="cpu",
        crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=d,
    )
    assert te.programmed.by_name["stage0/b1/ffn/wi"].w_codes.ndim == 4
    je = fresh_engine(jeng)
    jt, tt = spy_ticks(je), spy_ticks(te)
    same_tokens(je, te, tcfg.vocab_size, seed)
    assert TL.crossbar_misses() == ()
    assert len(jt) == len(tt) > 2
    for a, b in zip(jt, tt):
        assert np.linalg.norm(b - a) / np.linalg.norm(a) < CHIP_REL_L2


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def test_engine_admits_a_jamba_request_recurrently(jamba):
    """A hybrid prompt is prefilled at its exact length (no bucket, no
    prefill graph) and its first token is sampled from the prefill's
    logits; the ticks replay the pool's decode graph (eager on the CPU).
    The tokens are those of the entry points run by hand."""
    _, tcfg, _, tparams = jamba
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, size=9)
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu")
    assert eng.runner.prefill_len(9) == 9
    eng.submit(prompt, max_new_tokens=5)
    got = eng.run_until_done()[0].generated
    assert dict(eng.runner.prefill_graphs) == {} and eng.runner.decode_graph is not None
    cache = TM.init_cache(tcfg, 1, 32, dtype=torch.float32, device="cpu")
    logits, _ = TM.prefill(tparams, tcfg, torch.from_numpy(prompt[None].astype(np.int64)), cache)
    tok, pos, want = int(torch.argmax(logits[0])), 9, []
    want.append(tok)
    for _ in range(4):
        logits, _ = TM.decode_step(tparams, tcfg, torch.tensor([[tok]]), torch.tensor([pos]), cache)
        tok, pos = int(torch.argmax(logits[0])), pos + 1
        want.append(tok)
    assert got == want
