"""PyTorch port, xLSTM: reduced xlstm-350m in float32 (2 layers, d_model 64,
4 heads, dh 32, vocab 256), the same numpy-seeded inputs through
``repro.models.xlstm`` / ``repro.kernels.slstm_scan`` and their counterparts in
``repro_torch``: the sLSTM scan's plain version, both blocks in prefill and
decode, the cache, the whole model (digital and from a JAX-programmed chip)
and the engine's recurrent admission."""
import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import save_programmed as j_save
from repro.device.programmed import program_model as j_program_model
from repro.kernels.slstm_scan import slstm_scan_pallas
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import restore_programmed
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.device import programmed as tprog
from repro_torch.kernels import slstm_scan as tscan
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import CrossbarMode
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import flatten

# The scan and the blocks: the same float32 arithmetic in another summation
# order (XLA-CPU dot vs torch einsum) and other exp / tanh / sigmoid
# implementations, a few float32 ULPs per step; the recurrence does not
# amplify them (contractive gates).  The JAX package's own kernel-vs-scan bar
# (tests/test_kernels.py) is atol 1e-5.
SCAN = dict(rtol=0, atol=1e-5)
# Whole-model logits and multi-chunk mLSTM: values up to O(10), the same ULP
# differences carried through 2 layers, a norm and the head.
DIGITAL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.reduced(jconfigs.get_config("xlstm-350m"))
    tcfg = reduced(get_config("xlstm-350m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _mixer(params, kind):
    """Layer 0 of the block ``kind`` ("mlstm" is b0, "slstm" b1)."""
    b = "b0" if kind == "mlstm" else "b1"
    tree = params["stage0"][b]["mixer"]
    if isinstance(next(iter(tree.values())), torch.Tensor):
        return {k: v[0] for k, v in tree.items()}
    return jax.tree.map(lambda a: a[0], tree)


def _state(rng, B, H, dh):
    """A mid-sequence sLSTM state: c of either sign, n >= 1, h in (-1, 1)."""
    c = rng.normal(size=(B, H, dh)) * 2.0
    n = 1.0 + np.abs(rng.normal(size=(B, H, dh))) * 3.0
    h = np.tanh(rng.normal(size=(B, H, dh)))
    return [a.astype(np.float32) for a in (c, n, h)]


def test_configs_are_the_same():
    for j, t in (
        (jconfigs.get_config("xlstm-350m"), get_config("xlstm-350m")),
        (jconfigs.reduced(jconfigs.get_config("xlstm-350m")), reduced(get_config("xlstm-350m"))),
    ):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    full = get_config("xlstm-350m")
    assert (full.n_layers, full.d_model, full.n_heads, TX.d_inner_of(full), full.vocab_size) == (
        24, 1024, 4, 2048, 50304,
    )
    assert full.family == "ssm" and full.tie_embeddings and full.param_dtype == "bfloat16"
    assert (TX.CHUNK, TX.IGATE_CLIP) == (JX.CHUNK, JX.IGATE_CLIP)


def test_slstm_scan_plain_matches_pallas_kernel_and_slstm_block(tiny):
    """Item: the plain version against the JAX kernel in interpret mode and
    against the reference block's lax.scan, B=2, S=24, from a non-zero
    state, final state included (atol 1e-5)."""
    jcfg, _, jparams, _ = tiny
    rng = np.random.default_rng(0)
    B, S, H, dh, D = 2, 24, jcfg.n_heads, JX.d_inner_of(jcfg) // jcfg.n_heads, jcfg.d_model
    mj = _mixer(jparams, "slstm")
    x = (rng.normal(size=(B, S, D)) * 0.5).astype(np.float32)
    pre = np.asarray(jnp.asarray(x) @ mj["w_in"]).reshape(B, S, 4, H, dh)
    c0, n0, h0 = _state(rng, B, H, dh)
    rs = [np.asarray(mj[g]) for g in ("r_z", "r_i", "r_f", "r_o")]
    ref = slstm_scan_pallas(
        jnp.asarray(pre), *map(jnp.asarray, rs), jnp.asarray(c0), jnp.asarray(n0), jnp.asarray(h0),
        interpret=True,
    )
    got = tscan.slstm_scan_plain(
        torch.from_numpy(pre), *map(torch.from_numpy, rs),
        torch.from_numpy(c0), torch.from_numpy(n0), torch.from_numpy(h0),
    )
    for name, g, r in zip(("h_all", "c1", "n1", "h1"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SCAN, err_msg=name)
    cache = {"c": jnp.asarray(c0), "n": jnp.asarray(n0), "h": jnp.asarray(h0)}
    y_ref, new = JX.slstm_block(mj, jnp.asarray(x), jcfg, cache, decode=False)
    y_got = got[0].reshape(B, S, -1) @ torch.from_numpy(np.asarray(mj["out_proj"]))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_ref), **SCAN)
    for name, g in zip("cnh", got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(new[name]), **SCAN, err_msg=name)


def test_slstm_scan_wrapper_takes_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(1)
    B, S, H, dh = 1, 3, 2, 8
    pre = torch.from_numpy(rng.normal(size=(B, S, 4, H, dh)).astype(np.float32))
    rs = [torch.from_numpy(rng.normal(size=(H, dh, dh)).astype(np.float32)) for _ in range(4)]
    st = [torch.from_numpy(a) for a in _state(rng, B, H, dh)]
    tscan.reset_counters()
    out = tscan.slstm_scan_cuda(pre, *rs, *st)
    assert tscan.PLAIN_CALLS == {"slstm_scan": 1, "slstm_scan_save": 0, "slstm_scan_bwd": 0}
    assert sum(tscan.LAUNCHES.values()) == 0
    for a, b in zip(out, tscan.slstm_scan_plain(pre, *rs, *st)):
        assert torch.equal(a, b)
    # bf16 pre: h_all comes back in bf16, rounded once from the f32 state
    h_b, c_b, _, h1 = tscan.slstm_scan_cuda(pre.bfloat16(), *(r.bfloat16() for r in rs), *st)
    assert h_b.dtype == torch.bfloat16 and c_b.dtype == torch.float32
    assert torch.equal(h_b[:, -1], h1.bfloat16())
    assert tscan.PLAIN_CALLS["slstm_scan"] == 2 and tscan.LAUNCHES["slstm_scan"] == 0


@pytest.mark.parametrize("kind,S", [("mlstm", 24), ("mlstm", 512), ("slstm", 24), ("slstm", 512)])
def test_block_prefill_matches_reference(tiny, kind, S):
    """One chunk (S=24) and two mLSTM chunks (S=512, CHUNK 256), from the
    cache's initial state; outputs and the written cache."""
    jcfg, tcfg, jparams, tparams = tiny
    x = (np.random.default_rng(2).normal(size=(2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    jfn, tfn = (JX.mlstm_block, TX.mlstm_block) if kind == "mlstm" else (JX.slstm_block, TX.slstm_block)
    jcache = JX.init_xlstm_cache(jcfg, kind, 2)
    tcache = TX.init_xlstm_cache(tcfg, kind, 2, device="cpu")
    y_ref, jnew = jfn(_mixer(jparams, kind), jnp.asarray(x), jcfg, jcache, decode=False)
    y, tnew = tfn(_mixer(tparams, kind), torch.from_numpy(x), tcfg, tcache, decode=False)
    assert tnew is tcache  # written in place
    tol = SCAN if S <= 256 else DIGITAL
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **tol)
    for name in jnew:
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jnew[name]), **tol, err_msg=name)
    y0, none = tfn(_mixer(tparams, kind), torch.from_numpy(x), tcfg)  # no cache
    assert none is None and torch.equal(y0, y)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_reference_and_ends_in_the_prefill_state(tiny, kind):
    jcfg, tcfg, jparams, tparams = tiny
    S = 12
    x = (np.random.default_rng(3).normal(size=(2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    jfn, tfn = (JX.mlstm_block, TX.mlstm_block) if kind == "mlstm" else (JX.slstm_block, TX.slstm_block)
    mj, mt = _mixer(jparams, kind), _mixer(tparams, kind)
    jcache = JX.init_xlstm_cache(jcfg, kind, 2)
    tcache = TX.init_xlstm_cache(tcfg, kind, 2, device="cpu")
    j_step = jax.jit(lambda p, xt, c: jfn(p, xt, jcfg, c, decode=True))
    for t in range(S):
        y_ref, jcache = j_step(mj, jnp.asarray(x[:, t:t + 1]), jcache)
        y, _ = tfn(mt, torch.from_numpy(x[:, t:t + 1]), tcfg, tcache, decode=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SCAN)
    full = TX.init_xlstm_cache(tcfg, kind, 2, device="cpu")
    tfn(mt, torch.from_numpy(x), tcfg, full, decode=False)
    for name in tcache:
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **SCAN, err_msg=name)
        np.testing.assert_allclose(tcache[name].numpy(), full[name].numpy(), **SCAN, err_msg=name)
    with pytest.raises(ValueError):
        tfn(mt, torch.from_numpy(x[:, :2]), tcfg, tcache, decode=True)


def test_mlstm_prefill_refuses_a_ragged_chunk(tiny):
    _, tcfg, _, tparams = tiny
    x = torch.zeros((1, 300, tcfg.d_model))  # 300 = 256 + 44: the reference asserts S % c == 0
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TX.mlstm_block(_mixer(tparams, "mlstm"), x, tcfg)


def test_init_cache_matches_reference_leaf_by_leaf(tiny):
    jcfg, tcfg, _, _ = tiny
    jc = JM.init_cache(jcfg, 3, 16, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 3, 16, dtype=torch.float32, device="cpu")
    assert len(jc) == len(tc) == 1
    assert sorted(jc[0]) == sorted(tc[0]) == ["b0", "b1"]
    for b in ("b0", "b1"):
        assert sorted(jc[0][b]) == sorted(tc[0][b])
        for name, ja in jc[0][b].items():
            ta = tc[0][b][name]
            assert tuple(ta.shape) == ja.shape and ta.dtype == torch.float32, (b, name)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert float(tc[0]["b1"]["n"].min()) == 1.0 and float(tc[0]["b0"]["n"].abs().max()) == 0.0
    # the stacked layers are separate storage, not broadcast views
    tc[0]["b1"]["n"][0, 0, 0, 0] = 7.0
    assert int((tc[0]["b1"]["n"] == 7.0).sum()) == 1


def test_init_model_has_the_reference_tree_shapes_and_scales(tiny):
    _, tcfg, _, tparams = tiny
    own = TM.init_model(tcfg, seed=1, device="cpu")
    shapes = lambda tree: {k: (tuple(v.shape), v.dtype) for k, v in flatten(tree).items()}
    assert shapes(own) == shapes(tparams)
    assert "ffn" not in own["stage0"]["b0"] and "norm2" not in own["stage0"]["b1"]
    s = own["stage0"]["b1"]["mixer"]
    dh = TX.d_inner_of(tcfg) // tcfg.n_heads
    assert s["r_z"].shape == (1, tcfg.n_heads, dh, dh)
    for g in ("r_z", "r_i", "r_f", "r_o"):
        assert abs(float(s[g].std()) - dh**-0.5) < 0.01, g
    assert abs(float(own["stage0"]["b0"]["mixer"]["w_gates"].std()) - 0.02) < 4e-3
    wqkv = own["stage0"]["b0"]["mixer"]["wqkv"]
    assert abs(float(wqkv.std()) - tcfg.d_model**-0.5) < 0.01
    # the full config, shapes only: 24 layers (12 of each kind), bf16
    full = get_config("xlstm-350m")
    assert getattr(torch, full.param_dtype) == torch.bfloat16
    assert full.stages[0].kinds == ("mlstm", "slstm") and full.stages[0].repeats == 12


def _chip(jcfg, jparams, tmp_path):
    """The tied head programmed by the JAX package, written to its store and
    restored by the port: the only artifact an xLSTM chip holds."""
    prog = j_program_model(jparams, tie_lm_head=True)
    j_save(str(tmp_path), prog)
    tchip = restore_programmed(str(tmp_path), device="cpu")
    assert sorted(tchip.by_name) == ["embed/tokens"]
    assert tchip.stage_layer_maps("stage0") is None
    return prog, tchip


@pytest.mark.parametrize("chip", [False, True], ids=["digital", "ideal_chip"])
def test_whole_model_matches_reference(tiny, tmp_path, chip):
    """forward logits, prefill's last logits and 8 decode steps.  Digital:
    DIGITAL.  From the chip: the head's crossbar turns float ULPs upstream
    into at most a few output LSBs of its 16-bit codes (one LSB is x_scale *
    w_scale * 2**drop_lsb, see test_torch_model) — asserted <= 8 LSB and
    rel-L2 < 0.02, the dense model's bar."""
    jcfg, tcfg, jparams, tparams = tiny
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 20))
    P = 12
    j_modes, t_modes = [], []  # context managers each side runs under
    if chip:
        prog, tchip = _chip(jcfg, jparams, tmp_path)
        head = tchip.by_name["embed/tokens"]
        j_modes = [lambda: JL.crossbar_mode(JL.CrossbarMode(enabled=True, programmed=prog, strict=True)), prog.bind]
        t_modes = [lambda: TL.crossbar_mode(CrossbarMode(enabled=True, programmed=tchip, strict=True)), tchip.bind]

    def under(modes, fn):
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode())
            return fn()

    run_j = lambda fn: under(j_modes, fn)
    run_t = lambda fn: under(t_modes, fn)

    def compare(got, ref, x_max=None):
        got, ref = np.asarray(got), np.asarray(ref)
        if not chip:
            np.testing.assert_allclose(got, ref, **DIGITAL)
            return
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02
        lsb = (x_max / 65535.0) * float(head.w_scale) * 2.0 ** head.spec.drop_lsb
        assert np.abs(got - ref).max() <= 8.0 * lsb, np.abs(got - ref).max() / lsb

    seen = []
    real = tprog.programmed_matmul

    def spy(x, art, **kw):
        seen.append(float(x.max()))
        return real(x, art, **kw)

    tprog.programmed_matmul = spy
    TL.reset_crossbar_misses()
    try:
        # the reference runs jitted (traced once under the active mode)
        j_forward = jax.jit(lambda p, t: JM.forward(p, jcfg, t))
        j_prefill = jax.jit(lambda p, t, c: JM.prefill(p, jcfg, t, c))
        j_decode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
        ref = run_j(lambda: j_forward(jparams, jnp.asarray(tokens)))
        got = run_t(lambda: TM.forward(tparams, tcfg, torch.from_numpy(tokens)))
        assert got.shape == (2, 20, tcfg.vocab_size)
        compare(got.numpy(), ref, seen[-1] if seen else None)
        jcache = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
        tcache = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
        jl, jcache = run_j(lambda: j_prefill(jparams, jnp.asarray(tokens[:, :P]), jcache))
        tl, tcache = run_t(lambda: TM.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :P]), tcache))
        compare(tl.numpy(), jl, seen[-1] if seen else None)
        for step in range(P, P + 8):
            pos = np.array([step, step])
            jl, jcache = run_j(lambda: j_decode(
                jparams, jnp.asarray(tokens[:, step:step + 1]), jnp.asarray(pos), jcache))
            tl, tcache = run_t(lambda: TM.decode_step(
                tparams, tcfg, torch.from_numpy(tokens[:, step:step + 1]), torch.from_numpy(pos), tcache))
            compare(tl.numpy(), jl, seen[-1] if seen else None)
    finally:
        tprog.programmed_matmul = real
    assert TL.crossbar_misses() == ()
    if chip:  # one head projection per forward: 1 + 1 + 8
        assert len(seen) == 10
    for b, names in (("b0", "Cn"), ("b1", "cnh")):
        for n in names:
            np.testing.assert_allclose(
                tcache[0][b][n].numpy(), np.asarray(jcache[0][b][n]), **DIGITAL, err_msg=f"{b}/{n}"
            )


def test_runner_admits_a_recurrent_prompt_at_its_exact_length(tiny):
    """No bucket (padding would enter the state): the prefill sees exactly the
    prompt, the first token is sampled from its logits, pos = S."""
    _, tcfg, _, tparams = tiny
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu")
    prompt = np.array([5, 6, 7, 8, 9])
    seen = []
    real = TM.prefill

    def spy(params, cfg, tokens, cache):
        seen.append(tuple(tokens.shape))
        return real(params, cfg, tokens, cache)

    TM.prefill = spy
    try:
        cache, pos, last, first = eng.runner.admit_slot(eng.cache, 1, Request(0, prompt))
    finally:
        TM.prefill = real
    assert seen == [(1, 5)]
    logits = TM.forward(tparams, tcfg, torch.from_numpy(prompt[None]))[0, -1]
    assert (pos, last, first) == (5, int(torch.argmax(logits)), int(torch.argmax(logits)))
    assert float(cache[0]["b0"]["C"][:, 0].abs().max()) == 0.0  # slot 0 untouched
    assert float(cache[0]["b1"]["n"][:, 0].min()) == 1.0
    assert float(cache[0]["b0"]["C"][:, 1].abs().max()) > 0.0
    rid = eng.submit(prompt, max_new_tokens=3)
    eng.step()
    req = eng.slots[0]
    assert req.rid == rid and req.generated[0] == first and len(req.generated) == 2
    assert eng.pos[0] == 6


@pytest.mark.parametrize("chip", [False, True], ids=["digital", "ideal_chip"])
def test_greedy_tokens_match_the_jax_engine(tiny, tmp_path, chip):
    """Same admission order, greedy.  Recurrent archs on random weights have
    near-tie argmaxes late in a generation that float reorders can flip (as
    tests/test_substrate.py says for the reference), so the first 4 tokens of
    each request are compared."""
    jcfg, tcfg, jparams, tparams = tiny
    jkw, tkw = {}, {}
    if chip:
        prog, _ = _chip(jcfg, jparams, tmp_path)
        jkw = dict(crossbar=JL.CrossbarMode(enabled=True, strict=True), restore_artifacts=str(tmp_path))
        tkw = dict(crossbar=CrossbarMode(enabled=True, strict=True), restore_artifacts=str(tmp_path))
    je = JEngine(jcfg, jparams, max_batch=2, max_seq=32, **jkw)
    te = ServingEngine(tcfg, tparams, max_batch=2, max_seq=32, device="cpu", **tkw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n) for n in (7, 4, 9)]
    for p in prompts:
        assert je.submit(p, max_new_tokens=6) == te.submit(p, max_new_tokens=6)
    jr, tr = je.run_until_done(), te.run_until_done()
    assert all(len(r.generated) == 6 for r in tr)
    for a, b in zip(jr, tr):
        assert b.generated[:4] == a.generated[:4], (a.rid, a.generated, b.generated)
