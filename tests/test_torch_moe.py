"""PyTorch port, the MoE FFN on one device (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe``: capacity and slot tables
exactly, routing (ties included), a rank's share of the experts, the sum of
all shares, the shared expert, and whole reduced models (kimi-k2 and the
tiny tied-head MoE LM) digital and from a programmed chip.  Inputs come from
numpy seeds; parameters are carried with ``params_from_numpy``."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benchmarks.noise_sweep import tiny_moe_lm_config
from repro import configs as jconfigs
from repro.checkpoint import save_programmed as j_save
from repro.device.programmed import program_model as j_program_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.checkpoint import restore_programmed
from repro_torch.configs import ModelConfig, StageSpec, get_config, reduced
from repro_torch.convert import artifacts_from_numpy, params_from_numpy
from repro_torch.device import programmed as tprog
from repro_torch.kernels import crossbar_vmm as kvmm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.tree import flatten

KIMI = "kimi-k2-1t-a32b"
# Digital tolerance, as for the dense models (test_torch_model): exp,
# sigmoid, rsqrt and reduction orders differ between XLA-CPU and torch-CPU by
# float32 ULPs.
DIGITAL = dict(rtol=1e-4, atol=1e-4)
# Gates: the port's probabilities are the float32 softmax computed in float64
# and rounded once, the reference's a float32 softmax; a few float32 ULPs.
GATES = dict(rtol=1e-6, atol=1e-7)


def _port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["stages"] = tuple(StageSpec(**s) for s in fields["stages"])
    return ModelConfig(**fields)


def _carry(jcfg, seed=0):
    jparams, _ = JM.init_model(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def kimi():
    jcfg = jconfigs.reduced(jconfigs.get_config(KIMI))
    jparams, tparams = _carry(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 12))
    return jcfg, reduced(get_config(KIMI)), jparams, tparams, tokens


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_moe_lm_config()
    jparams, tparams = _carry(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(1, 6))
    return jcfg, _port_config(jcfg), jparams, tparams, tokens


def _ffn(params, stage=1, layer=0):
    """One layer's MoE FFN params (JAX arrays or tensors)."""
    return {k: v[layer] for k, v in params[f"stage{stage}"]["b0"]["ffn"].items()}


# ---------------------------------------------------------------------------
# Config and init
# ---------------------------------------------------------------------------

def test_config_is_the_reference_config(kimi):
    jcfg, tcfg = kimi[0], kimi[1]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    full = get_config(KIMI)
    assert dataclasses.asdict(full) == dataclasses.asdict(jconfigs.get_config(KIMI))
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.moe_experts, full.moe_top_k, full.moe_shared_experts, full.moe_d_ff,
            full.tie_embeddings) == (61, 7168, 64, 8, 128, 18432, 163840, 384, 8, 1, 2048, False)
    assert [(s.repeats, s.moe) for s in full.stages] == [(1, (False,)), (60, (True,))]


@pytest.mark.parametrize("which", ["kimi", "tiny"])
def test_init_model_has_the_reference_tree_and_scales(kimi, tiny, which):
    """The port's own tree has the reference's names, shapes and dtype;
    the banks draw at the reference's scale (E**-0.5, its unstacked bank's
    leading dim), the router at 0.02."""
    _, tcfg, jparams, _, _ = kimi if which == "kimi" else tiny
    ref = {
        "/".join(str(getattr(k, "key", k)) for k in path): (tuple(v.shape), str(v.dtype))
        for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }
    own = TM.init_model(tcfg, seed=1, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in flatten(own).items()}
    assert got == ref
    if which == "kimi":
        ffn = own["stage1"]["b0"]["ffn"]
        assert abs(float(ffn["wi"].std()) - tcfg.moe_experts**-0.5) < 0.02
        assert abs(float(ffn["router"].std()) - 0.02) < 3e-3
        assert abs(float(ffn["shared_wo"].std()) - tcfg.moe_d_ff**-0.5) < 0.02


def test_init_model_under_a_share_draws_only_its_experts(kimi):
    tcfg = kimi[1]
    share = TMoE.ExpertShare(rank=1, ranks=4)
    own = TM.init_model(tcfg, seed=1, device="cpu", share=share)
    whole = TM.init_model(tcfg, seed=1, device="cpu")
    ffn, ffn_whole = own["stage1"]["b0"]["ffn"], whole["stage1"]["b0"]["ffn"]
    for n in ("wi", "wg", "wo"):
        assert ffn[n].shape == (2, 2) + ffn_whole[n].shape[2:]
    for n in ("router", "shared_wi", "shared_wg", "shared_wo"):
        assert ffn[n].shape == ffn_whole[n].shape
    assert own["head"].shape == whole["head"].shape


@pytest.mark.parametrize("rank, ranks", [(0, 3), (2, 2), (-1, 2), (0, 0)])
def test_share_refusals(kimi, rank, ranks):
    """A share needs 0 <= rank < ranks, and the experts must split evenly
    over the ranks (8 experts over 3 ranks do not)."""
    tcfg = kimi[1]
    with pytest.raises(ValueError):
        TM.init_model(tcfg, device="cpu", share=TMoE.ExpertShare(rank, ranks))


def test_banks_of_another_share_are_refused(kimi):
    _, tcfg, _, tparams, tokens = kimi
    with pytest.raises(ValueError, match="ExpertShare"):
        with TMoE.expert_share(TMoE.ExpertShare(0, 2)):
            TM.forward(tparams, tcfg, torch.from_numpy(tokens))


# ---------------------------------------------------------------------------
# Capacity, slots, routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tokens", [1, 4, 8, 32, 100, 256, 4096])
def test_capacity_is_the_reference_capacity(kimi, tiny, n_tokens):
    full = get_config(KIMI)
    for cfg in (full, kimi[1], tiny[1]):
        for n_local in (cfg.moe_experts, max(1, cfg.moe_experts // 2)):
            assert TMoE._capacity(n_tokens, cfg, n_local) == JMoE._capacity(n_tokens, cfg, n_local)
    # the card's served sizes: every bucket and the decode pool give 8
    if n_tokens in (4, 32, 256):
        assert TMoE._capacity(n_tokens, full, 48) == 8


def _assignments(seed, N, k, E, hot=None):
    """(N, k) distinct expert ids a row (a few hot experts if ``hot`` to
    overflow their capacity) and positive gates."""
    rng = np.random.default_rng(seed)
    p = None
    if hot is not None:
        p = np.full(E, 1.0)
        p[:hot] = 40.0
        p /= p.sum()
    idx = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(N)]).astype(np.int32)
    gates = rng.random((N, k)).astype(np.float32)
    return idx, gates


@pytest.mark.parametrize("seed, N, k, E, cap, hot", [
    (0, 16, 2, 8, 8, None), (1, 40, 2, 8, 8, 2), (2, 24, 8, 32, 8, 4), (3, 5, 1, 2, 8, None),
])
def test_dispatch_indices_equal_the_reference(seed, N, k, E, cap, hot):
    """Slot tables exactly the reference's, overflow drops included (hot
    experts receive more assignments than they have slots)."""
    idx, gates = _assignments(seed, N, k, E, hot)
    j_tok, j_gate = JMoE._dispatch_indices(jnp.asarray(idx), jnp.asarray(gates), E, cap)
    t_tok, t_gate = TMoE._dispatch_indices(torch.from_numpy(idx), torch.from_numpy(gates), E, cap)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_gate.numpy(), np.asarray(j_gate))
    kept = int((t_gate > 0).sum())
    if hot is not None:
        assert kept < N * k  # something was dropped


def test_slot_tables_list_each_tokens_kept_slots_in_order():
    idx, gates = _assignments(5, 40, 2, 8, hot=2)
    tok_slot, gate_slot, token_slots = TMoE.slot_tables(torch.from_numpy(idx), torch.from_numpy(gates), 4, 8, lo=2)
    n_slots = 32
    ts = token_slots.numpy()
    assert (np.diff(ts, axis=1) >= 0).all()
    for s in range(n_slots):
        if float(gate_slot[s]) > 0:
            assert s in ts[int(tok_slot[s])]
    for t in range(40):
        for s in ts[t]:
            if s < n_slots:  # a kept slot of expert 2 + s // 8 holds token t
                assert int(tok_slot[s]) == t
                assert s // 8 + 2 in idx[t]
    # every assignment to experts 2..5 is kept or dropped past capacity;
    # assignments to other experts never get a slot
    local = ((idx >= 2) & (idx < 6)).sum()
    assert int((ts < n_slots).sum()) <= local


def test_top_k_ties_go_to_the_lower_expert():
    """Planted ties: equal probabilities are taken lower id first, as
    ``jax.lax.top_k`` does; a stable descending sort, not ``torch.topk``."""
    cfg = dataclasses.replace(reduced(get_config(KIMI)), moe_experts=16, moe_top_k=4)
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 16)).astype(np.float32)
    logits[0, [3, 9, 12]] = 5.0  # three-way tie at the top
    logits[1, [1, 2, 14, 15, 7]] = 4.0  # five tied for four places
    logits[2, :] = 1.0  # all equal
    logits[3, [0, 15]] = logits[3].max() + 1.0
    idx, gates, probs = TMoE.route_from_logits(torch.from_numpy(logits), cfg, torch.float32)
    jp = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jg, ji = jax.lax.top_k(jp, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx[0, :3].tolist() == [3, 9, 12] and idx[1].tolist() == [1, 2, 7, 14]
    assert idx[2].tolist() == [0, 1, 2, 3]
    jg = jg / jnp.maximum(jnp.sum(jg, axis=-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **GATES)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), **GATES)


@pytest.fixture(scope="module")
def kimi_chip(kimi, tmp_path_factory):
    """Both packages' crossbar modes on the ideal chip of the reduced kimi
    the JAX package programmed (and saved; the port restores it)."""
    d = str(tmp_path_factory.mktemp("kimi-chip"))
    jchip = j_program_model(kimi[2], tie_lm_head=False)
    j_save(d, jchip)
    tchip = restore_programmed(d, device="cpu")
    return (
        (JL.CrossbarMode(enabled=True, programmed=jchip, strict=True), jchip),
        (TL.CrossbarMode(enabled=True, programmed=tchip, strict=True), tchip),
    )


@pytest.mark.parametrize("chip", ["digital", "ideal_chip"])
def test_route_matches_the_reference(kimi, tmp_path, chip):
    """Top-k ids equal to the reference's and gates within ``GATES``, with
    the crossbar off and with the router served from a programmed ideal
    chip (the router artifact alone, bound by name at layer 0)."""
    jcfg, tcfg, jparams, tparams, _ = kimi
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    jr, tr = _ffn(jparams)["router"], _ffn(tparams)["router"]
    if chip == "digital":
        ji, jg, jp = JMoE._route(jnp.asarray(x), jr, jcfg)
        ti, tg, tp = TMoE._route(torch.from_numpy(x), tr, tcfg)
    else:
        jart = j_program_model({"router": jr})
        j_save(str(tmp_path), jart)
        tart = restore_programmed(str(tmp_path), device="cpu")
        with JL.crossbar_mode(JL.CrossbarMode(enabled=True, programmed=jart, strict=True)), jart.bind():
            ji, jg, jp = JMoE._route(jnp.asarray(x), jr, jcfg)
        with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=tart, strict=True)), tart.bind():
            ti, tg, tp = TMoE._route(torch.from_numpy(x), tr, tcfg)
        assert TL.crossbar_misses() == ()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GATES)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **GATES)


def test_route_ties_from_equal_router_columns(kimi):
    """Router columns 2 and 5 equal: their logits tie exactly in both
    packages, and both take expert 2 first."""
    jcfg, tcfg, _, tparams, _ = kimi
    rng = np.random.default_rng(12)
    w = rng.normal(size=(jcfg.d_model, jcfg.moe_experts)).astype(np.float32)
    w[:, 5] = w[:, 2] = np.abs(w[:, 2]) + 1.0
    x = np.abs(rng.normal(size=(1, 5, jcfg.d_model))).astype(np.float32)
    ji, jg, _ = JMoE._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ti, tg, _ = TMoE._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    assert ti[..., :2].tolist() == [[[2, 5]] * 5]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GATES)


# ---------------------------------------------------------------------------
# Dispatch, shares, the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank, ranks", [(0, 1), (1, 2), (3, 4)])
def test_dispatch_compute_of_a_rank_matches_the_reference(kimi, rank, ranks):
    """The EP body of one rank: its local banks, ``lo = rank * E/ranks``,
    routing over all experts; the reference's ``_dispatch_compute`` called
    the same way."""
    jcfg, tcfg, jparams, tparams, _ = kimi
    rng = np.random.default_rng(20 + rank)
    N, k, E = 24, jcfg.moe_top_k, jcfg.moe_experts
    x = rng.normal(size=(N, jcfg.d_model)).astype(np.float32)
    idx, gates = _assignments(21 + rank, N, k, E, hot=1)
    n_local, lo = E // ranks, rank * (E // ranks)
    jf, tf = _ffn(jparams), _ffn(tparams)
    sl = slice(lo, lo + n_local)
    cap = TMoE._capacity(N, tcfg, n_local)
    ref = JMoE._dispatch_compute(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), jf["wi"][sl], jf["wg"][sl], jf["wo"][sl],
        jnp.int32(lo), cap, jcfg.mlp_kind,
    )
    got = TMoE._dispatch_compute(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates), tf["wi"][sl], tf["wg"][sl],
        tf["wo"][sl], lo, cap, tcfg.mlp_kind,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIGITAL)


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_shares_sum_to_the_single_device_moe_ffn(kimi, ranks):
    """Every rank's share (its banks carried with ``params_from_numpy(share=)``),
    summed over the ranks as the reference's psum would, against the
    single-device ``moe_ffn`` (float32; the shared expert added once)."""
    jcfg, tcfg, jparams, tparams, _ = kimi
    x = torch.from_numpy(np.random.default_rng(30).normal(size=(2, 9, jcfg.d_model)).astype(np.float32))
    whole = TMoE.moe_ffn(_ffn(tparams), x, tcfg)
    no_shared = dataclasses.replace(tcfg, moe_shared_experts=0)
    parts = []
    for rank in range(ranks):
        share = TMoE.ExpertShare(rank, ranks)
        sp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu", share=share)
        assert _ffn(sp)["wi"].shape[0] == jcfg.moe_experts // ranks
        parts.append(TMoE.moe_ffn(_ffn(sp), x, no_shared, share=share))
    ffn = _ffn(tparams)
    shared = TL.crossbar_linear(
        TMoE._act(x @ ffn["shared_wi"], x @ ffn["shared_wg"], tcfg.mlp_kind), ffn["shared_wo"]
    )
    np.testing.assert_allclose((sum(parts) + shared).numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    ref = JMoE.moe_ffn(jax.tree.map(lambda a: a[0], jparams["stage1"]["b0"]["ffn"]), jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), **DIGITAL)


def test_combine_adds_in_slot_order_from_zeros():
    """Bit for bit the reference's scatter-add on float32: zeros, then each
    token's contributions in slot order."""
    rng = np.random.default_rng(40)
    idx, gates = _assignments(41, 30, 3, 6, hot=2)
    tok_slot, gate_slot, token_slots = TMoE.slot_tables(torch.from_numpy(idx), torch.from_numpy(gates), 6, 8)
    contrib = rng.normal(size=(48, 5)).astype(np.float32) * (rng.random((48, 1)) * 1e3)
    contrib = (contrib * gate_slot.numpy()[:, None]).astype(np.float32)
    got = TMoE.combine(torch.from_numpy(contrib), token_slots).numpy()
    ref = jnp.zeros((30, 5), jnp.float32).at[jnp.asarray(tok_slot.numpy())].add(jnp.asarray(contrib))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_moe_ffn_with_the_shared_expert_matches_the_reference(kimi):
    jcfg, tcfg, jparams, tparams, _ = kimi
    x = np.random.default_rng(50).normal(size=(3, 5, jcfg.d_model)).astype(np.float32)
    for layer in (0, 1):
        ref = JMoE.moe_ffn(jax.tree.map(lambda a: a[layer], jparams["stage1"]["b0"]["ffn"]), jnp.asarray(x), jcfg)
        got = TMoE.moe_ffn(_ffn(tparams, layer=layer), torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIGITAL)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["kimi", "tiny"])
def test_digital_logits_prefill_and_decode_match_the_reference(kimi, tiny, which):
    jcfg, tcfg, jparams, tparams, tokens = kimi if which == "kimi" else tiny
    ref = np.asarray(JM.forward(jparams, jcfg, jnp.asarray(tokens)))
    got = TM.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, **DIGITAL)
    B, S = tokens.shape
    n = S - 3
    jcache = JM.init_cache(jcfg, B, S, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    jl, jcache = JM.prefill(jparams, jcfg, jnp.asarray(tokens[:, :n]), jcache)
    tl, tcache = TM.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :n]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DIGITAL)
    for pos in range(n, S):
        tok = tokens[:, pos:pos + 1]
        jl, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.int32(pos), jcache)
        tl, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), torch.tensor(pos), tcache)
        # not against the forward's row: capacity counts the call's rows,
        # so a 24-row forward drops assignments a 2-row decode keeps
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DIGITAL)


def test_programmed_moe_forward_consumes_every_artifact(tiny):
    """The tiny tied-head MoE LM programmed whole (``tie_lm_head=True``):
    attention q/k/v/o, router, expert wi/wg/wo banks (4-D) and the tied
    head — 9 artifacts, every one consumed by a strict forward with no
    miss, each bank counted once; the VMM calls are one a projection of
    every expert; within float tolerance of the per-call path (the
    reference's test_programmed_moe_forward_zero_misses_and_strict).
    Without the tied head's artifact that head is a miss, and strict mode
    raises."""
    _, tcfg, _, tparams, tokens = tiny
    tok = torch.from_numpy(tokens)
    with TL.crossbar_mode(TL.CrossbarMode(enabled=True)):
        y_percall = TM.forward(tparams, tcfg, tok)
    chip = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    assert chip.n_compiled == 9, sorted(chip.by_name)
    assert chip.by_name["stage0/b0/ffn/wi"].w_codes.ndim == 4
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()
    kvmm.reset_counters()
    with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=chip, strict=True)), chip.bind():
        y_prog = TM.forward(tparams, tcfg, tok)
    assert TL.crossbar_misses() == ()
    chip.verify_consumed()
    assert sum(kvmm.PLAIN_CALLS.values()) == chip.calls_per_forward == 4 + 1 + 2 * 3 + 1
    np.testing.assert_allclose(y_prog.numpy(), y_percall.numpy(), rtol=1e-4, atol=1e-4)
    no_tie = tprog.program_model(tparams, tie_lm_head=False, device="cpu")
    TL.reset_crossbar_misses()
    with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=no_tie)), no_tie.bind():
        TM.forward(tparams, tcfg, tok)
    assert "embed/tokens" in TL.crossbar_misses()
    with pytest.raises(LookupError):
        with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=no_tie, strict=True)), no_tie.bind():
            TM.forward(tparams, tcfg, tok)
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()


def test_an_unconsumed_bank_is_caught(tiny):
    """verify_consumed flags a bank no call site serves (a renamed leaf)."""
    _, tcfg, _, tparams, tokens = tiny
    chip = tprog.program_model(tparams, tie_lm_head=True, device="cpu")
    arts = chip.artifacts
    ffn = arts["stage0"]["b0"]["ffn"]
    ffn["wx"] = ffn.pop("wg")
    renamed = tprog.ProgrammedModel(arts)
    tprog.reset_consumed_artifact_names()
    with TL.crossbar_mode(TL.CrossbarMode(enabled=True, programmed=renamed)), renamed.bind():
        TM.forward(tparams, tcfg, torch.from_numpy(tokens))
    with pytest.raises(LookupError, match="wx"):
        renamed.verify_consumed()
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()


def test_ideal_chip_logits_match_the_reference(kimi, kimi_chip):
    """Both packages serve the chip the JAX package programmed: logits
    within rel-L2 0.02 of each other and of the digital model (the bar of
    test_torch_model / test_torch_dense_families); the port makes the VMM
    calls its chip derives, each expert's from its own (K, N) view."""
    jcfg, tcfg, jparams, tparams, tokens = kimi
    (jmode, jchip), (tmode, tchip) = kimi_chip
    with JL.crossbar_mode(jmode), jchip.bind():
        ref = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, jnp.asarray(tokens)))
    TL.reset_crossbar_misses()
    tprog.reset_consumed_artifact_names()
    kvmm.reset_counters()
    with TL.crossbar_mode(tmode), tchip.bind():
        got = TM.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    assert TL.crossbar_misses() == ()
    tchip.verify_consumed()
    want = 3 * 4 + 2 + 2 * (1 + tcfg.moe_experts * 3 + 3) + 1
    assert sum(kvmm.PLAIN_CALLS.values()) == tchip.calls_per_forward == want
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02
    digital = np.asarray(JM.forward(jparams, jcfg, jnp.asarray(tokens)))
    assert np.linalg.norm(got - digital) / np.linalg.norm(digital) < 0.02
    tprog.reset_consumed_artifact_names()


def test_share_of_a_jax_chip_serves_its_experts(kimi, kimi_chip):
    """A rank's slice of the JAX-programmed chip (``artifacts_from_numpy(share=)``)
    and of the params: the share's MoE layer output, summed with the other
    ranks', is the whole chip's (the shared expert once)."""
    jcfg, tcfg, jparams, tparams, _ = kimi
    _, (tmode, tchip) = kimi_chip
    x = torch.from_numpy(np.random.default_rng(60).normal(size=(1, 6, jcfg.d_model)).astype(np.float32))
    layer_map = tchip.stage_layer_maps("stage1")[0]
    bank = layer_map["stage1/b0/ffn/wi"]
    assert bank.shape == (jcfg.moe_experts, jcfg.d_model, jcfg.moe_d_ff)

    def run(params, chip, cfg, share):
        with TL.crossbar_mode(dataclasses.replace(tmode, programmed=chip)), chip.bind():
            with tprog.name_scope("stage1"), tprog._push_bind_map(chip.stage_layer_maps("stage1")[0]):
                with tprog.name_scope("b0"), tprog.name_scope("ffn"):
                    return TMoE.moe_ffn(_ffn(params), x, cfg, share=share)

    whole = run(tparams, tchip, tcfg, TMoE.SINGLE_DEVICE)
    no_shared = dataclasses.replace(tcfg, moe_shared_experts=0)
    total = 0
    for rank in range(2):
        share = TMoE.ExpertShare(rank, 2)

        def carry(art):
            arrays = {f: (getattr(art, f).numpy() if getattr(art, f) is not None else None)
                      for f in tprog.ARTIFACT_ARRAY_FIELDS}
            return artifacts_from_numpy(arrays, art, device="cpu", share=share)

        chip = tchip.map_artifacts(carry)
        assert chip.by_name["stage1/b0/ffn/wo"].w_codes.shape[1] == jcfg.moe_experts // 2
        assert chip.by_name["stage1/b0/mixer/wq"].shape == tchip.by_name["stage1/b0/mixer/wq"].shape
        sp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu", share=share)
        total = total + run(sp, chip, no_shared, share)
    ffn = _ffn(tparams)
    with TL.crossbar_mode(tmode), tchip.bind(), tprog.name_scope("stage1"), \
            tprog._push_bind_map(tchip.stage_layer_maps("stage1")[0]), tprog.name_scope("b0"), \
            tprog.name_scope("ffn"):
        u = TL.crossbar_linear(x, ffn["shared_wi"], name="shared_wi")
        g = TL.crossbar_linear(x, ffn["shared_wg"], name="shared_wg")
        shared = TL.crossbar_linear(TMoE._act(u, g, tcfg.mlp_kind), ffn["shared_wo"], name="shared_wo")
    assert TL.crossbar_misses() == ()
    np.testing.assert_allclose((total + shared).numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
