"""PyTorch port, sLSTM training: the backward of the sLSTM scan
(``kernels.slstm_scan.slstm_scan_bwd_plain``, the plain version of
``slstm_scan_bwd_kernel``, and ``SlstmScan``, the ``torch.autograd.Function``
that ``models.xlstm.slstm_block`` trains through) against autograd through
``slstm_scan_plain`` and against ``jax.vjp`` of the reference's
``slstm_block`` on the same seeded numpy inputs; the reference's rule at the
ties of ``jnp.minimum(., IGATE_CLIP)`` and ``jnp.maximum(n, 1)`` (half the
gradient), planted where a training sequence meets them exactly, in the
sLSTM and in the mLSTM; remat; bf16 dtypes; the backward's launch plan; the
launcher training xlstm on the CPU; and the mLSTM's gradient past 128
positions, finite where the reference's is NaN.  On CPU tensors the
Function runs the plain versions of both kernels, which the card's kernels
are held to in ``chip_smoke.py``."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import xlstm as JX
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.kernels import slstm_scan as tscan
from repro_torch.launch import train as launcher
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.train import value_and_grad
from repro_torch.tree import flatten, unflatten

# float32 throughout: the same arithmetic in another order (einsum against
# the explicit reverse loop; XLA-CPU against torch), a few ULPs a step over
# at most 16 steps of contractive gates
REL_L2 = 1e-5
# an element next to a planted tie: the values of both packages' float32
# gradients, not a rule's factor of two
TIE = dict(rtol=1e-5, atol=1e-6)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _scan_inputs(rng, B, S, H, dh, scale=2.0):
    """pre ~ N(0, scale^2) (some input gates past the clip, some n below 1),
    R at dh**-0.5, a mid-sequence state (c of either sign, n > 0, h in
    (-1, 1)), all float32."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pre = t(rng.normal(size=(B, S, 4, H, dh)) * scale)
    rs = [t(rng.normal(size=(H, dh, dh)) * dh**-0.5) for _ in range(4)]
    c0 = t(rng.normal(size=(B, H, dh)) * 2.0)
    n0 = t(0.5 + np.abs(rng.normal(size=(B, H, dh))) * 2.0)
    h0 = t(np.tanh(rng.normal(size=(B, H, dh))))
    return pre, rs, (c0, n0, h0)


def _cotangents(rng, B, S, H, dh):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return t(rng.normal(size=(B, S, H, dh))), *(t(rng.normal(size=(B, H, dh))) for _ in range(3))


SHAPES = [(1, 5, 2, 8), (2, 16, 4, 32), (2, 9, 3, 16)]


@pytest.mark.parametrize("B,S,H,dh", SHAPES)
def test_plain_backward_matches_autograd_through_the_plain_scan(B, S, H, dh):
    """Away from ties ``torch.clamp``'s gradient is the reference's, so the
    explicit reverse loop equals autograd through ``slstm_scan_plain``: the
    gradient of pre, of the initial state and (through ``SlstmScan``) of
    every R, for a loss on every output."""
    rng = np.random.default_rng(B * 100 + S)
    pre, rs, state = _scan_inputs(rng, B, S, H, dh)
    cots = _cotangents(rng, B, S, H, dh)
    leaves = [x.clone().requires_grad_(True) for x in (pre, *rs, *state)]
    out = tscan.slstm_scan_plain(*leaves)
    ref = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, cots)), leaves)

    _, _, _, _, saved = tscan.slstm_scan_save_plain(pre, *rs, *state)
    assert not bool(((saved[1] == tscan.IGATE_CLIP) | (saved[5] == 1.0)).any())  # no tie
    assert bool((saved[1] > tscan.IGATE_CLIP).any()) and bool((saved[5] < 1.0).any())  # both sides
    g, dc0, dn0, dh0 = tscan.slstm_scan_bwd_plain(cots[0], saved, *rs, state[0], state[1], *cots[1:])
    assert g.shape == pre.shape and g.dtype == torch.float32
    for name, got, want in (("pre", g, ref[0]), ("c0", dc0, ref[5]), ("n0", dn0, ref[6]), ("h0", dh0, ref[7])):
        assert rel_l2(got, want) <= REL_L2, name

    fn_leaves = [x.clone().requires_grad_(True) for x in (pre, *rs, *state)]
    fn_out = tscan.SlstmScan.apply(*fn_leaves)
    for a, b in zip(fn_out, out):
        assert torch.equal(a, b.detach())
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(fn_out, cots)), fn_leaves)
    for k, name in enumerate(("pre", "r_z", "r_i", "r_f", "r_o", "c0", "n0", "h0")):
        assert got[k].dtype == ref[k].dtype and rel_l2(got[k], ref[k]) <= REL_L2, name


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfigs.reduced(jconfigs.get_config("xlstm-350m"))
    tcfg = reduced(get_config("xlstm-350m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    block = jax.tree.map(lambda a: np.asarray(a[0]), jparams["stage0"]["b1"]["mixer"])
    return jcfg, tcfg, block, jax.tree.map(lambda a: np.asarray(a[0]), jparams["stage0"]["b0"]["mixer"])


def _block_grads(jcfg, tcfg, block, x, cot, kind="slstm"):
    """(reference, port): the gradients of <``kind``_block(params, x), cot>
    with respect to x and every leaf of the block's params."""
    jfn, tfn = (JX.slstm_block, TX.slstm_block) if kind == "slstm" else (JX.mlstm_block, TX.mlstm_block)
    _, vjp = jax.vjp(lambda p, xx: jfn(p, xx, jcfg)[0], jax.tree.map(jnp.asarray, block), jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))
    ref = dict(jax.tree.map(np.asarray, jp), x=np.asarray(jx))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in block.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    y, _ = tfn(tp, tx, tcfg)
    names = sorted(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [tp[k] for k in names] + [tx])
    port = dict(zip(names + ["x"], (g.numpy() for g in grads)))
    return ref, port


@pytest.mark.parametrize("B,S", [(2, 16), (1, 7)])
def test_block_gradients_match_the_reference_vjp(tiny, B, S):
    """The port's ``slstm_block`` under autograd (``SlstmScan``, plain
    versions on the CPU) against ``jax.vjp`` of the reference's, for x,
    ``w_in``, ``r_*`` and ``out_proj``."""
    jcfg, tcfg, block, _ = tiny
    rng = np.random.default_rng(S)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    tscan.reset_counters()
    ref, port = _block_grads(jcfg, tcfg, block, x, cot)
    assert tscan.PLAIN_CALLS == {"slstm_scan": 0, "slstm_scan_save": 1, "slstm_scan_bwd": 1}
    assert sum(tscan.LAUNCHES.values()) == 0
    assert ref.keys() == port.keys() == {"x", "w_in", "r_z", "r_i", "r_f", "r_o", "out_proj"}
    for k in ref:
        assert np.linalg.norm(ref[k]) > 0 and rel_l2(port[k], ref[k]) <= REL_L2, k


def _planted(jcfg, block, tie):
    """x one-hot over positions (x[0, t, t] = 1), so pre[0, t] is row t of
    ``w_in`` exactly, and row 0 planted: at t = 0 (h0 = 0, so h R adds
    exactly 0) every input gate pre-activation is exactly IGATE_CLIP
    ("igate_clip"), or the forget gates are -200 and the input gates 0, so
    f = 0, i = 1 and n_1 = 1 exactly ("n_is_one")."""
    H, dh = jcfg.n_heads, JX.d_inner_of(jcfg) // jcfg.n_heads
    S, D = 6, jcfg.d_model
    x = np.zeros((1, S, D), np.float32)
    x[0, np.arange(S), np.arange(S)] = 1.0
    w = np.array(block["w_in"]).reshape(D, 4, H, dh)
    if tie == "igate_clip":
        w[0, 1] = JX.IGATE_CLIP
    else:
        w[0, 2], w[0, 1] = -200.0, 0.0
    return dict(block, w_in=w.reshape(D, 4 * H * dh)), x


@pytest.mark.parametrize("tie", ["igate_clip", "n_is_one"])
def test_planted_ties_take_the_references_gradient_not_clamps(tiny, tie):
    """At a tie ``jax.lax.min`` / ``max`` pass half the gradient to each
    side; ``torch.clamp`` passes all of it.  Planted at t = 0 of a training
    sequence (h0 = 0), the port's gradient of ``w_in``'s planted row and of
    x is the reference's element by element, and autograd through
    ``slstm_scan_plain`` (clamp's rule) is not."""
    jcfg, tcfg, block, _ = tiny
    block, x = _planted(jcfg, block, tie)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    ref, port = _block_grads(jcfg, tcfg, block, x, cot)
    H, dh = jcfg.n_heads, JX.d_inner_of(jcfg) // jcfg.n_heads

    _, _, _, _, saved = tscan.slstm_scan_save_plain(
        torch.from_numpy(x @ block["w_in"]).reshape(1, 6, 4, H, dh),
        *(torch.from_numpy(block[k]) for k in ("r_z", "r_i", "r_f", "r_o")),
        torch.zeros((1, H, dh)), torch.ones((1, H, dh)), torch.zeros((1, H, dh)),
    )
    planted = saved[1, 0, 0] == tscan.IGATE_CLIP if tie == "igate_clip" else saved[5, 0, 0] == 1.0
    assert bool(planted.all())  # the tie holds at every column of step 0
    for k in ("w_in", "x", "r_i", "r_f"):
        np.testing.assert_allclose(port[k], ref[k], **TIE, err_msg=k)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in block.items()}
    pre = (torch.from_numpy(x) @ tp["w_in"]).reshape(1, 6, 4, H, dh)
    state = (torch.zeros((1, H, dh)), torch.ones((1, H, dh)), torch.zeros((1, H, dh)))
    h_all = tscan.slstm_scan_plain(pre, *(tp[k] for k in ("r_z", "r_i", "r_f", "r_o")), *state)[0]
    y = h_all.reshape(1, 6, H * dh) @ tp["out_proj"]
    (clamp_w_in,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [tp["w_in"]])
    cols = slice(H * dh, 2 * H * dh)  # the input gates' columns of row 0 carry the tie
    assert not np.allclose(clamp_w_in.numpy()[0, cols], ref["w_in"][0, cols], **TIE)
    np.testing.assert_allclose(port["w_in"][0, cols], ref["w_in"][0, cols], **TIE)


def test_mlstm_planted_input_gate_tie_takes_the_references_gradient(tiny, monkeypatch):
    """The same rule in the mLSTM, whose log input gate is min(gate, 5) of
    each position's own gate pre-activation (no recurrent term): planted at
    5.0 for every head at t = 0 (x one-hot over positions), the port's
    gradients of ``w_gates`` and x are the reference's, and with
    ``torch.clamp`` in place of the tie-aware clip they are not."""
    jcfg, tcfg, _, block = tiny
    H, S, D = jcfg.n_heads, 6, jcfg.d_model
    x = np.zeros((1, S, D), np.float32)
    x[0, np.arange(S), np.arange(S)] = 1.0
    w = np.array(block["w_gates"])
    w[0, :H] = JX.IGATE_CLIP  # columns (gate 0 = input, head h)
    block = dict(block, w_gates=w)
    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    ref, port = _block_grads(jcfg, tcfg, block, x, cot, kind="mlstm")
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], **TIE, err_msg=k)
    monkeypatch.setattr(TX, "_clip", lambda v, lo=None, hi=None: torch.clamp(v, min=lo, max=hi))
    _, clamped = _block_grads(jcfg, tcfg, block, x, cot, kind="mlstm")
    assert not np.allclose(clamped["w_gates"][0, :H], ref["w_gates"][0, :H], **TIE)


def test_bf16_scan_gives_bf16_gradients_and_float32_state_gradients():
    rng = np.random.default_rng(9)
    pre, rs, state = _scan_inputs(rng, 2, 6, 2, 16, scale=1.0)
    leaves = [pre.bfloat16().requires_grad_(True), *(r.bfloat16().requires_grad_(True) for r in rs),
              *(s.requires_grad_(True) for s in state)]
    tscan.reset_counters()
    h_all, c1, n1, h1 = tscan.SlstmScan.apply(*leaves)
    assert h_all.dtype == torch.bfloat16 and {c1.dtype, n1.dtype, h1.dtype} == {torch.float32}
    grads = torch.autograd.grad(h_all.float().sum() + c1.sum() + n1.sum() + h1.sum(), leaves)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5 + [torch.float32] * 3
    assert all(bool(torch.isfinite(g.float()).all()) and g.float().norm() > 0 for g in grads)
    assert tscan.PLAIN_CALLS == {"slstm_scan": 0, "slstm_scan_save": 1, "slstm_scan_bwd": 1}
    # with only pre needing a gradient, the same gradient of pre
    pre2 = pre.bfloat16().requires_grad_(True)
    out = tscan.SlstmScan.apply(pre2, *(r.bfloat16() for r in rs), *(s.detach() for s in state))
    (g_pre,) = torch.autograd.grad(out[0].float().sum() + out[1].sum() + out[2].sum() + out[3].sum(), [pre2])
    assert torch.equal(g_pre, grads[0])


def test_serving_and_no_grad_take_the_plain_scan_without_saving():
    """Without grad (serving, evaluation) ``slstm_block`` runs the scan as
    before, saving nothing; with grad on params that need none, too."""
    cfg = reduced(get_config("xlstm-350m"))
    params = TM.init_model(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 8)))
    tscan.reset_counters()
    TM.forward(params, cfg, tokens)
    with torch.enable_grad():
        TM.loss_fn(params, cfg, {"inputs": tokens, "targets": tokens})
    assert tscan.PLAIN_CALLS == {"slstm_scan": 2, "slstm_scan_save": 0, "slstm_scan_bwd": 0}


def test_remat_gives_the_same_gradients_bit_for_bit():
    """``cfg.remat`` recomputes each layer, the sLSTM scan's saving forward
    included, in backward: the loss and every gradient equal (the tied
    embedding's to float32 rounding, its two parts summed in another order,
    as in ``test_torch_train.py``), on the reduced config."""
    cfg = reduced(get_config("xlstm-350m"))
    params = TM.init_model(cfg, 3, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 16))) for k in ("inputs", "targets")}
    tscan.reset_counters()
    l0, g0 = value_and_grad(lambda p, b: TM.loss_fn(p, cfg, b), params, batch)
    assert tscan.PLAIN_CALLS == {"slstm_scan": 0, "slstm_scan_save": 1, "slstm_scan_bwd": 1}
    rcfg = dataclasses.replace(cfg, remat=True)
    tscan.reset_counters()
    l1, g1 = value_and_grad(lambda p, b: TM.loss_fn(p, rcfg, b), params, batch)
    assert tscan.PLAIN_CALLS == {"slstm_scan": 0, "slstm_scan_save": 2, "slstm_scan_bwd": 1}
    assert torch.equal(l0, l1)
    f0, f1 = flatten(g0), flatten(g1)
    assert f0.keys() == f1.keys()
    for k in f0:
        if k == "embed/tokens":
            assert float((f1[k] - f0[k]).norm()) <= 1e-6 * float(f0[k].norm()), k
        else:
            assert torch.equal(f0[k], f1[k]), k
    assert all(float(f0[k].norm()) > 0 for k in f0 if "/b1/mixer/" in k)


@pytest.mark.parametrize(
    "B,S,H,dh,esize,cluster",
    [(4, 1024, 4, 512, 2, 16), (4, 1024, 4, 512, 4, 16), (1, 48, 4, 512, 2, 16), (9, 3, 4, 512, 2, 16),
     (2, 16, 4, 32, 4, 16), (2, 3, 1, 2048, 2, 16), (2, 3, 1, 2048, 4, 16), (5, 4, 2, 100, 2, 8),
     (3, 5, 3, 48, 4, 4), (1, 1, 4, 512, 2, 16)],
)
def test_backward_plan_covers_every_cell_once_within_the_kernels_limits(B, S, H, dh, esize, cluster):
    """Every (row, column) cell of a head owned once, one thread a cell, the
    cluster the column blocks, shared bytes within 227 KB, and the resident
    rows of R all of them or a multiple of 32; bf16 at dh = 512 (the train
    shape) holds all of R and runs B = 4 in one batch group."""
    p = tscan.plan_scan_bwd(B, S, H, dh, esize, cluster)
    fwd = tscan.plan_scan(B, S, H, dh, esize, cluster)
    assert (p.cols, p.col_blocks) == (fwd.cols, fwd.col_blocks)
    assert p.cluster == (p.col_blocks if p.col_blocks > 1 else 1) <= cluster
    owned = np.zeros((B, p.col_blocks * p.cols), int)
    for gb in range(p.batch_groups):
        for cb in range(p.col_blocks):
            for cell in range(p.threads):
                b, dl = divmod(cell, p.cols)
                if b < p.rows and gb * p.rows + b < B:
                    owned[gb * p.rows + b, cb * p.cols + dl] += 1
    assert (owned[:, :dh] == 1).all()
    assert p.rows <= p.row_slots <= 4 and p.rows * p.cols <= p.threads == tscan.BWD_THREADS
    assert p.smem <= tscan.SMEM_LIMIT
    assert p.resident == 4 * dh or (p.resident % 32 == 0 and p.resident < 4 * dh)
    if (dh, esize) == (512, 2):
        assert p.resident == 4 * dh and (B > 4 or p.batch_groups == 1)


@pytest.mark.parametrize("bad", [(0, 4, 4, 512, 2), (1, 0, 4, 512, 2), (1, 4, 4, 4096, 2), (1, 4, 4, 512, 8)])
def test_backward_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tscan.plan_scan_bwd(*bad)


def test_launcher_trains_xlstm_and_resumes(tmp_path, capsys):
    args = ["--arch", "xlstm-350m", "--reduced", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    tscan.reset_counters()
    launcher.main(args + ["--steps", "2"])
    first = capsys.readouterr().out
    assert "resumed" not in first and "[train] done" in first
    assert latest_step(str(tmp_path)) == 2
    assert tscan.PLAIN_CALLS["slstm_scan_bwd"] == 2  # one sLSTM layer, two steps
    launcher.main(args + ["--steps", "4"])
    second = capsys.readouterr().out
    assert "[train] resumed from step 2" in second and "[train] done" in second
    assert latest_step(str(tmp_path)) == 4


def test_mlstm_gradients_stay_finite_past_128_positions():
    """From S = 128 the reference's mLSTM chunk overflows exp above the
    diagonal of its decay matrix and its gradient of the gate path is NaN
    (``where(mask, exp(diff), 0)``: 0 x inf); the port masks before exp.  At
    S = 256 (one chunk of 256): the same loss, every port gradient finite,
    equal to the reference's wherever that is finite, and on the leaves
    where it is not (the mLSTM gates, the norm before them, the embedding)
    the port's gradient along a seeded direction equal to the reference's
    forward-mode derivative (``jax.jvp``: the masked tangent is selected
    away, not multiplied, so it stays finite)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("xlstm-350m"))
    cfg = reduced(get_config("xlstm-350m"))
    nparams = tree_to_numpy(TM.init_model(cfg, 1, device="cpu"))  # the port's draw, handed to both
    jparams = jax.tree.map(jnp.asarray, nparams)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, jcfg.vocab_size, size=(1, 256)).astype(np.int32) for k in ("inputs", "targets")}
    jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    ref = {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, jg)).items()}
    tparams = params_from_numpy(nparams, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lambda p, b: TM.loss_fn(p, cfg, b)  # noqa: E731
    tl, tg = value_and_grad(loss, tparams, tbatch)
    got = {k: v.numpy() for k, v in flatten(tg).items()}
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    nan_in_ref = sorted(k for k, v in ref.items() if not np.isfinite(v).all())
    assert nan_in_ref == ["embed/tokens", "stage0/b0/mixer/w_gates", "stage0/b0/norm1"]
    for k, v in got.items():
        assert np.isfinite(v).all(), k
        if k not in nan_in_ref:
            assert rel_l2(v, ref[k]) <= 1e-4, k
    jbatch = jax.tree.map(jnp.asarray, batch)
    jvp_along = jax.jit(lambda t: jax.jvp(lambda p: JM.loss_fn(p, jcfg, jbatch), (jparams,), (t,))[1])
    for k in nan_in_ref:
        u = np.random.default_rng(len(k)).normal(size=got[k].shape).astype(np.float32)
        tangent = unflatten(nparams, {kk: (u if kk == k else np.zeros_like(v)) for kk, v in flatten(nparams).items()})
        jvp = jvp_along(jax.tree.map(jnp.asarray, tangent))
        assert np.isfinite(float(jvp)), k
        assert float(np.sum(got[k].astype(np.float64) * u)) == pytest.approx(float(jvp), rel=1e-4), k
