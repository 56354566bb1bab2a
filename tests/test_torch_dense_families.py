"""PyTorch port, three more dense families: gemma2-9b (post-norm blocks,
local/global attention with a sliding window, softcaps, a scaled embedding,
GeGLU), minitron-4b (relu² MLP, GQA kv 8, an untied head) and starcoder2-3b
(GELU MLP, GQA kv 2).  Each reduced config in float32, params carried over
with ``params_from_numpy``, the same seeded tokens through ``repro.models`` /
``repro.serving`` and ``repro_torch.models`` / ``repro_torch.serving`` —
digital, and from an ideal chip the JAX package programmed and saved."""
import copy
import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.device.programmed import program_model as j_program_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.layers import CrossbarMode as JMode
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import restore_programmed
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import programmed as tprog
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import ServingEngine
from repro_torch.tree import flatten

ARCHS = ["gemma2-9b", "minitron-4b", "starcoder2-3b"]
# Digital tolerance, as for smollm (test_torch_model): transcendentals and
# reduction orders differ between XLA-CPU and torch-CPU by float32 ULPs.
DIGITAL = dict(rtol=1e-4, atol=1e-4)


def _flat(tree):
    """{joined name: leaf} of a nested dict of JAX or torch leaves."""
    return flatten(tree)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    name = request.param
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    tcfg = reduced(get_config(name))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    # 20 tokens: past gemma2's reduced window of 16
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 20))
    return name, jcfg, tcfg, jparams, tparams, tokens


@pytest.fixture(scope="module")
def jax_store(family, tmp_path_factory):
    """An ideal chip programmed and saved by the JAX engine."""
    name, jcfg, _, jparams, _, _ = family
    d = str(tmp_path_factory.mktemp(f"{name}-ideal"))
    JEngine(jcfg, jparams, max_batch=2, max_seq=64, crossbar=JMode(enabled=True, strict=True)).save_artifacts(d)
    return d


@pytest.fixture(scope="module")
def jax_engines(family, jax_store):
    """A fresh JAX ``ServingEngine`` per call, digital or serving the JAX
    store's chip, over one runner per kind: the runner's jitted prefill and
    decode compile once for the module (an interpret-mode chip takes ~10 s
    to compile on one core), and a fresh engine's scheduler state — slot
    pool, positions, queue, ledger, request ids — is that of a new
    ``ServingEngine``."""
    _, jcfg, _, jparams, _, _ = family
    built = {}

    def fresh(chip: str):
        if chip not in built:
            kw = {}
            if chip == "ideal_chip":
                kw = dict(crossbar=JMode(enabled=True, strict=True), restore_artifacts=jax_store)
            built[chip] = JEngine(jcfg, jparams, max_batch=2, max_seq=64, **kw)
        eng = copy.copy(built[chip])
        eng.cache = eng.runner.init_cache(eng.max_batch)
        eng.slots = [None] * eng.max_batch
        eng.pos = np.zeros(eng.max_batch, np.int32)
        eng.last_tok = np.zeros(eng.max_batch, np.int32)
        eng.pending, eng._completed, eng._rid = [], {}, itertools.count(0)
        return eng

    return fresh


def test_configs_are_the_reference_configs(family):
    name, jcfg, tcfg, *_ = family
    assert name in ALL_ARCHS
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jconfigs.get_config(name))
    full = get_config(name)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.tie_embeddings) == {
        "gemma2-9b": (42, 3584, 16, 8, 256, 14336, 256000, True),
        "minitron-4b": (32, 3072, 24, 8, 128, 9216, 256000, False),
        "starcoder2-3b": (30, 3072, 24, 2, 128, 12288, 49152, True),
    }[name]


def test_param_tree_names_and_shapes_match_reference(family):
    """The carried tree and the port's own ``init_model`` tree have the
    reference's names, shapes and dtype; a post-norm config carries
    ``norm1_post`` / ``norm2_post`` at zero, after the mixer and the FFN."""
    name, _, tcfg, jparams, tparams, _ = family
    ref = {
        "/".join(str(getattr(k, "key", k)) for k in path): (tuple(v.shape), str(v.dtype))
        for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }
    own = TM.init_model(tcfg, seed=1, device="cpu")
    for tree in (tparams, own):
        got = {n: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for n, v in _flat(tree).items()}
        assert got == ref
    post = sorted(n for n in ref if n.endswith("_post"))
    if tcfg.post_norm:
        assert post == [f"stage0/b{i}/{p}" for i in (0, 1) for p in ("norm1_post", "norm2_post")]
        assert all(float(_flat(own)[n].abs().max()) == 0.0 for n in post)
    else:
        assert post == []
    assert ("head" in ref) == (not tcfg.tie_embeddings)


def test_digital_logits_match_reference(family):
    _, jcfg, tcfg, jparams, tparams, tokens = family
    ref = np.asarray(JM.forward(jparams, jcfg, jnp.asarray(tokens)))
    got = TM.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 20, tcfg.vocab_size)
    np.testing.assert_allclose(got, ref, **DIGITAL)


def test_digital_prefill_and_decode_match_reference_and_forward(family):
    """Prefill 14 tokens, then decode 6 steps to position 19 — past gemma2's
    reduced window of 16, where its local layers drop the oldest keys."""
    _, jcfg, tcfg, jparams, tparams, tokens = family
    full = TM.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    jcache = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    # jitted: the reference's eager ops dispatch one by one (4x slower here)
    jprefill = jax.jit(JM.prefill, static_argnums=1)
    jdecode = jax.jit(JM.decode_step, static_argnums=1)
    jl, jcache = jprefill(jparams, jcfg, jnp.asarray(tokens[:, :14]), jcache)
    tl, tcache = TM.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :14]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DIGITAL)
    np.testing.assert_allclose(tl.numpy(), full[:, 13], **DIGITAL)
    for step in range(14, 20):
        pos = np.array([step, step])
        tok = tokens[:, step:step + 1]
        jl, jcache = jdecode(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache)
        tl, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DIGITAL)
        np.testing.assert_allclose(tl.numpy(), full[:, step], **DIGITAL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[0]["b0"][n].numpy(), np.asarray(jcache[0]["b0"][n]), **DIGITAL)


def test_ideal_chip_logits_match_reference(family, jax_store, jax_engines):
    """Both packages serve the chip the JAX engine programmed.  Bars of
    ``test_torch_model.test_programmed_chip_logits_match_reference``: within
    8 LSBs of the head's 16-bit output (one LSB is x_scale * w_scale *
    2**drop_lsb) and rel-L2 < 0.02; and the chip within rel-L2 0.02 of the
    digital model (W16A16)."""
    name, jcfg, tcfg, jparams, tparams, tokens = family
    jchip = jax_engines("ideal_chip").programmed
    tchip = restore_programmed(jax_store, device="cpu")
    with JL.crossbar_mode(JL.CrossbarMode(enabled=True, programmed=jchip, strict=True)), jchip.bind():
        ref = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, jnp.asarray(tokens)))
    seen = []
    real = tprog.programmed_matmul

    def spy(x, art, **kw):
        seen.append((float(x.max()), art))
        return real(x, art, **kw)

    tprog.programmed_matmul = spy
    try:
        TL.reset_crossbar_misses()
        tprog.reset_consumed_artifact_names()
        with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=tchip, strict=True)), tchip.bind():
            got = TM.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    finally:
        tprog.programmed_matmul = real
    assert TL.crossbar_misses() == ()
    tchip.verify_consumed()
    assert len(seen) == 6 * tcfg.n_layers + 1
    x_max, head = seen[-1]
    # gemma2's logit softcap only shrinks a difference (its slope is <= 1)
    lsb = (x_max / 65535.0) * float(head.w_scale) * 2.0 ** head.spec.drop_lsb
    err = np.abs(got - ref)
    assert err.max() <= 8.0 * lsb, (err.max() / lsb, lsb)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02
    digital = np.asarray(JM.forward(jparams, jcfg, jnp.asarray(tokens)))
    assert np.linalg.norm(got - digital) / np.linalg.norm(digital) < 0.02


def _prompts(seed, n=3):
    """Prompts of 17–24 tokens: each longer than gemma2's reduced window."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(17, 25))) for _ in range(n)]


def _spy(eng):
    """Record the active slots' logits at every decode tick."""
    ticks = []
    real = eng.runner.sample

    def sample(logits):
        active = [i for i, s in enumerate(eng.slots) if s is not None]
        ticks.append(np.array(logits[active]))
        return real(logits)

    eng.runner.sample = sample
    return ticks


# Chip seeds: on a chip the packages' logits differ by a few head LSBs
# (test_ideal_chip_logits_match_reference), and these random reduced models
# have top-2 margins of that size.  Over seeds 0–39 the greedy tokens
# differed in 11 of 120 (arch, seed) pairs, each at a tick whose top-2 margin
# was below 0.15x the logit discrepancy: a coin toss.  The seeds below are
# ones whose smallest margin is 4.74x / 2.53x (gemma2), 7.98x / 3.02x
# (minitron) and 9.85x / 4.94x (starcoder2) the discrepancy, where identity
# is guaranteed rather than lucky; the margin check fails the test if that
# stops holding.  Digital seeds 0 and 1 hold it by 118x or more.
CHIP_SEEDS = {"gemma2-9b": (7, 3), "minitron-4b": (2, 6), "starcoder2-3b": (13, 35)}


@pytest.mark.parametrize("pick", [0, 1])
@pytest.mark.parametrize("chip", ["digital", "ideal_chip"])
def test_greedy_tokens_identical_to_jax_engine(family, jax_store, jax_engines, chip, pick):
    """Both engines at temperature 0, the same admission order, prompts past
    the reduced window and 8 new tokens each (decode to position 31).  On
    the chip both restore the JAX engine's store.  Identity is asserted
    where the decision is not a coin toss: at every tick the top-2 logit
    margin (in both engines) exceeds twice the largest logit difference
    between them."""
    name, jcfg, tcfg, jparams, tparams, _ = family
    seed = CHIP_SEEDS[name][pick] if chip == "ideal_chip" else pick
    tkw = {}
    if chip == "ideal_chip":
        tkw = dict(crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=jax_store)
    je = jax_engines(chip)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=64, device="cpu", **tkw)
    jt, tt = _spy(je), _spy(te)
    for p in _prompts(seed):
        assert je.submit(p, max_new_tokens=8) == te.submit(p, max_new_tokens=8)
    jtok = [r.generated for r in je.run_until_done()]
    ttok = [r.generated for r in te.run_until_done()]
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        gap = np.abs(a - b).max()
        top_a, top_b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        margin = min((top_a[:, -1] - top_a[:, -2]).min(), (top_b[:, -1] - top_b[:, -2]).min())
        assert margin > 2 * gap, (margin, gap)
    assert ttok == jtok
    assert all(len(t) == 8 for t in ttok)
    assert TL.crossbar_misses() == ()


def test_stacked_programming_is_bit_equal_to_whole_stack(family):
    """``program_layer`` programs a stacked leaf one slab at a time into the
    stacked arrays: every artifact of the model equals the stack of its
    layers programmed one by one (the whole-stack result), and its codes and
    scales equal the JAX package's whole-stack programming."""
    _, _, tcfg, jparams, tparams, _ = family
    chip = tprog.program_model(tparams, tie_lm_head=tcfg.tie_embeddings, device="cpu")
    jchip = j_program_model(jparams, tie_lm_head=tcfg.tie_embeddings)
    stacked = 0
    for key, art in chip.by_name.items():
        jart = jchip.by_name[key]
        np.testing.assert_array_equal(art.w_codes.numpy(), np.asarray(jart.w_codes))
        np.testing.assert_array_equal(art.w_scale.numpy(), np.asarray(jart.w_scale))
        if not art.stacked:
            continue
        stacked += 1
        w = _flat(tparams)[key]
        parts = [tprog.program_layer(w[i]) for i in range(w.shape[0])]
        whole = dataclasses.replace(parts[0], **{
            f: torch.stack([getattr(p, f) for p in parts])
            for f in tprog.ARTIFACT_ARRAY_FIELDS if getattr(parts[0], f) is not None
        })
        assert tprog.artifacts_equal(art, whole), key
    assert stacked == 6 * len(tcfg.stages[0].kinds)
    # a noisy chip's effective cells too (the draws are the port's own,
    # keyed per slab)
    from repro_torch.device import DeviceConfig

    w = _flat(tparams)["stage0/b0/ffn/wi"]
    dev = DeviceConfig(sigma=0.02, p_stuck_on=1e-3, p_stuck_off=1e-3)
    art = tprog.program_layer(w, device_cfg=dev)
    parts = [tprog.program_layer(w[i], device_cfg=dev) for i in range(w.shape[0])]
    assert torch.equal(art.g_eff, torch.stack([p.g_eff for p in parts]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scaled_embedding_bit_equal_to_reference_and_builds_no_tensor(dtype, monkeypatch):
    """gemma2's width: the port's ``embed`` multiplies by ``d_model**0.5``
    rounded to the table's dtype (59.75 in bfloat16), bit-equal to the
    reference's ``x * jnp.asarray(d_model**0.5, x.dtype)`` on every product;
    once the scale is known a call builds no tensor from host data (a
    CUDA-graph capture refuses the host-to-device copy that would need)."""
    d_model = 3584
    rng = np.random.default_rng(11)
    table = (rng.normal(size=(512, d_model)) * 0.02).astype(np.float32)
    tok = rng.integers(0, 512, size=(2, 8))
    jtable = jnp.asarray(table, getattr(jnp, dtype))
    ref = np.asarray(JL.embed({"tokens": jtable}, jnp.asarray(tok), True, d_model).astype(jnp.float32))
    ttable = params_from_numpy({"t": np.asarray(jtable)}, device="cpu")["t"]
    assert ttable.dtype == getattr(torch, dtype)
    TL.embed({"tokens": ttable}, torch.from_numpy(tok), True, d_model)  # learns the scale

    def no_tensor(*a, **k):
        raise AssertionError("embed built a tensor from host data")

    monkeypatch.setattr(torch, "tensor", no_tensor)
    got = TL.embed({"tokens": ttable}, torch.from_numpy(tok), True, d_model)
    monkeypatch.undo()
    assert got.dtype == ttable.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert TL._embed_scale(d_model, torch.bfloat16) == 59.75
