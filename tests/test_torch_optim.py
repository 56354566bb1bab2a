"""PyTorch port, the optimizer and data side of training
(``repro_torch.optim``, ``repro_torch.data``) against the JAX package's
``repro.optim`` and ``repro.data`` on the same numpy inputs: schedules at
every step, each optimizer's update on the same grads and state (a float32
leaf, a bfloat16 leaf, factored and stacked leaves, and leaves large enough
for the layer-by-layer update), the global norm and its clip, and data
batches bit for bit; plus the reference's own checks of convergence on a
quadratic and of Adafactor's factored state, run on the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro import optim as jopt
from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.tree import flatten

# float32 math in both: the same expressions in the same order, but XLA-CPU
# and torch-CPU round pow / sqrt / rsqrt / cos and order reductions
# differently by a float32 ULP or so
F32 = dict(rtol=1e-6, atol=1e-7)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _bf16_order(bits):
    """bfloat16 bit patterns (uint16) as integers ordered like the values,
    so that adjacent values differ by 1 (one ULP) across zero too."""
    s = bits.astype(np.int32)
    return np.where(s >= 0x8000, 0x8000 - s, s)


def _assert_close_tree(port, ref, what):
    """Every leaf: float32 within F32; a bfloat16 leaf within one bfloat16
    ULP (its rounding of float32 values that differ by an ULP may part)."""
    fp, fr = flatten(tree_to_numpy(port)), flatten(jax.tree.map(np.asarray, ref))
    assert fp.keys() == fr.keys(), what
    for k in fr:
        r = fr[k]
        if r.dtype.name == "bfloat16":
            ulps = np.abs(_bf16_order(fp[k]) - _bf16_order(r.view(np.uint16)))
            assert ulps.max() <= 1, f"{what} {k}: {ulps.max()} bfloat16 ULPs"
        else:
            np.testing.assert_allclose(fp[k], r, **F32, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4)),
    "linear_warmup": (lambda m: m.linear_warmup(1e-3, 7)),
    "cosine_with_warmup": (lambda m: m.cosine_with_warmup(1e-3, 11, 100)),
    "cosine_short": (lambda m: m.cosine_with_warmup(3e-4, 1, 4, min_ratio=0.2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference_at_every_step(name):
    tf, jf = SCHEDULES[name](topt), SCHEDULES[name](jopt)
    steps = np.arange(0, 111, dtype=np.int32)
    port = np.array([float(tf(torch.tensor(s, dtype=torch.int32))) for s in steps], np.float32)
    ref = np.array([float(jf(jnp.int32(s))) for s in steps], np.float32)
    np.testing.assert_allclose(port, ref, **F32)
    assert float(tf(5)) == float(tf(torch.tensor(5)))  # a Python int step


def test_cosine_schedule_shape():
    f = topt.cosine_with_warmup(1.0, 10, 100)
    assert float(f(0)) == 0.0
    assert float(f(10)) == pytest.approx(1.0, rel=1e-3)
    assert float(f(100)) == pytest.approx(0.1, rel=1e-2)


# ---------------------------------------------------------------------------
# Updates on the same grads and state
# ---------------------------------------------------------------------------

def _tree(rng):
    """Params with a float32 matrix, a factored float32 matrix, a bfloat16
    vector and a stacked, factored bfloat16 leaf."""
    import ml_dtypes

    bf16 = ml_dtypes.bfloat16
    return {
        "w": rng.normal(size=(4, 130)).astype(np.float32),
        "big": rng.normal(size=(256, 192)).astype(np.float32),
        "layers": {
            "norm": rng.normal(size=(24,)).astype(bf16),
            "wi": (0.05 * rng.normal(size=(3, 128, 160))).astype(bf16),
        },
    }


def _state(name, params, rng):
    """A non-trivial state of the reference's layout (second moments > 0)."""
    pos = lambda shape: rng.uniform(1e-4, 1e-2, size=shape).astype(np.float32)
    if name == "sgd":
        return {"mu": jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)}
    if name == "adamw":
        return {
            "m": jax.tree.map(lambda p: (0.01 * rng.normal(size=p.shape)).astype(np.float32), params),
            "v": jax.tree.map(lambda p: pos(p.shape), params),
        }

    def one(p):
        if len(p.shape) >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128:
            return {"vr": pos(p.shape[:-1]), "vc": pos(p.shape[:-2] + p.shape[-1:])}
        return {"v": pos(p.shape)}

    return {"acc": jax.tree.map(one, params)}


def _update_both(name, params, grads, state, step, **kw):
    jo = jopt.make_optimizer(name, jopt.cosine_with_warmup(1e-2, 3, 20), **kw)
    to = topt.make_optimizer(name, topt.cosine_with_warmup(1e-2, 3, 20), **kw)
    jp, js = jo.update(_jnp_tree(grads), _jnp_tree(state), _jnp_tree(params), jnp.int32(step))
    tp, ts = params_from_numpy(params, device="cpu"), params_from_numpy(state, device="cpu")
    out_p, out_s = to.update(params_from_numpy(grads, device="cpu"), ts, tp, torch.tensor(step, dtype=torch.int32))
    assert out_p is tp and out_s is ts  # in place
    return (out_p, out_s), (jp, js)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
@pytest.mark.parametrize("step", [0, 6])
def test_update_matches_reference_on_the_same_grads_and_state(name, step):
    rng = np.random.default_rng(11 + step)
    params = _tree(rng)
    grads = jax.tree.map(lambda p: (0.3 * rng.normal(size=p.shape)).astype(p.dtype), params)
    state = _state(name, params, rng)
    (tp, ts), (jp, js) = _update_both(name, params, grads, state, step)
    _assert_close_tree(tp, jp, f"{name} params")
    _assert_close_tree(ts, js, f"{name} state")
    if name == "adafactor":
        assert set(ts["acc"]["layers"]["wi"]) == {"vr", "vc"} and ts["acc"]["layers"]["wi"]["vr"].shape == (3, 128)
        assert set(ts["acc"]["layers"]["norm"]) == {"v"}


@pytest.mark.parametrize("name", ["adafactor"])
def test_layerwise_update_matches_reference(name):
    """A stacked leaf past 2**24 elements takes the layer-by-layer branch in
    both packages; Adafactor, whose update clipping then takes each slice's
    RMS, is the optimizer the branch changes (AdamW's update is elementwise);
    a gradient row scaled up makes the slices' RMS differ."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(2, 2049, 4096)).astype(np.float32)
    g = rng.normal(size=p.shape).astype(np.float32)
    g[1] *= 40.0
    params, grads = {"w": p}, {"w": g}
    state = jax.tree.map(np.asarray, (jopt.adamw if name == "adamw" else jopt.adafactor)(jopt.constant(0.1)).init(params))
    (tp, ts), (jp, js) = _update_both(name, params, grads, state, 0)
    _assert_close_tree(tp, jp, f"{name} params")
    _assert_close_tree(ts, js, f"{name} state")


def test_kept_where_not_ok():
    """``update(..., ok=False)``: every leaf keeps its old value, even with
    non-finite grads (the train step zeroes them before)."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    for name in ("sgd", "adamw", "adafactor"):
        opt = topt.make_optimizer(name, topt.constant(1e-2))
        tp = params_from_numpy(params, device="cpu")
        st = opt.init(tp)
        before = tree_to_numpy({"p": tp, "s": st})
        grads = params_from_numpy(jax.tree.map(lambda p: np.ones(p.shape, p.dtype), params), device="cpu")
        opt.update(grads, st, tp, 0, ok=torch.tensor(False))
        after = tree_to_numpy({"p": tp, "s": st})
        for k, v in flatten(before).items():
            np.testing.assert_array_equal(flatten(after)[k], v, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_row_blocked_update_is_the_whole_update(name, monkeypatch):
    """SGD's and AdamW's update of a leaf past ``ELEMENTWISE_BLOCK``
    elements runs in blocks of rows (a vocabulary table's float32
    temporaries would take GBs): the same values as in one piece, for a
    step that applies and one that is kept."""
    from repro_torch.optim import optimizers as oo

    rng = np.random.default_rng(6)
    table = rng.normal(size=(37, 24)).astype(np.float32)
    grads = {"t": torch.from_numpy(rng.normal(size=(37, 24)).astype(np.float32))}
    runs = []
    for block in (1 << 30, 100):  # one piece; blocks of 4 rows (100 // 24)
        monkeypatch.setattr(oo, "ELEMENTWISE_BLOCK", block)
        opt = topt.make_optimizer(name, topt.constant(1e-2))
        p = {"t": torch.from_numpy(table.copy())}
        st = opt.init(p)
        for ok in (True, False, True):
            opt.update(grads, st, p, 0, ok=torch.tensor(ok))
        runs.append(tree_to_numpy({"p": p, "s": st}))
    for k, v in flatten(runs[0]).items():
        np.testing.assert_array_equal(flatten(runs[1])[k], v, err_msg=f"{name} {k}")


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    tt = params_from_numpy(tree, device="cpu")
    np.testing.assert_allclose(float(topt.global_norm(tt)), float(jopt.global_norm(_jnp_tree(tree))), rtol=1e-6)
    clipped, norm = topt.clip_by_global_norm(tt, 0.5)
    jclipped, jnorm = jopt.clip_by_global_norm(_jnp_tree(tree), 0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _assert_close_tree(clipped, jclipped, "clipped")
    assert clipped["layers"]["wi"].dtype == torch.bfloat16  # cast back to its own dtype


# ---------------------------------------------------------------------------
# The reference's own optimizer checks, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_converges_quadratic(name):
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 130)).astype(np.float32))
    params = {"w": torch.zeros((4, 130))}
    lr = {"sgd": 0.02, "adamw": 0.05, "adafactor": 0.3}[name]
    opt = topt.make_optimizer(name, topt.constant(lr))
    state = opt.init(params)
    for i in range(300):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state = opt.update({"w": g}, state, params, i)
    assert float(torch.mean((params["w"] - target) ** 2)) < 0.05


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros((512, 256)), "small": torch.zeros((8,))}
    st = topt.adafactor(topt.constant(1e-2)).init(params)
    assert "vr" in st["acc"]["big"] and st["acc"]["big"]["vr"].shape == (512,)
    assert st["acc"]["big"]["vc"].shape == (256,)
    assert "v" in st["acc"]["small"]
    assert 512 + 256 < 2 * 512 * 256 / 100  # factored state is ~(r+c)/(r*c) of adam's


def test_smollm_mlp_leaves_take_the_layerwise_branch():
    """The stacked (32, 960, 2560)-sized MLP leaves of smollm-360m are
    updated one layer at a time, as the reference's ``_maybe_layerwise``."""
    from repro_torch.optim.optimizers import _layerwise

    cfg = get_config("smollm-360m")
    assert _layerwise(torch.empty((cfg.n_layers, cfg.d_model, 2 * cfg.d_ff), device="meta"))
    assert _layerwise(torch.empty((cfg.n_layers, cfg.d_ff, cfg.d_model), device="meta"))
    assert not _layerwise(torch.empty((cfg.n_layers, cfg.d_model, cfg.n_kv_heads * cfg.head_dim), device="meta"))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pi,pc", [(0, 1), (1, 2)])
def test_synthetic_batches_bit_equal(pi, pc):
    for step in (0, 1, 5, 977):
        a = tdata.SyntheticLMDataset(49152, 33, 4, seed=7, process_index=pi, process_count=pc).batch_at(step)
        b = jdata.SyntheticLMDataset(49152, 33, 4, seed=7, process_index=pi, process_count=pc).batch_at(step)
        for k in ("inputs", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(
        tdata.SyntheticLMDataset(1000, 32, 4, seed=7).batch_at(6)["inputs"],
        tdata.SyntheticLMDataset(1000, 32, 4, seed=7).batch_at(5)["inputs"],
    )


def test_memmap_and_embedding_batches_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 5000, size=10000, dtype=np.int32).tofile(path)
    for step in (0, 3, 400):
        a = tdata.MemmapLMDataset(str(path), 16, 4, seed=3, process_index=1, process_count=2).batch_at(step)
        b = jdata.MemmapLMDataset(str(path), 16, 4, seed=3, process_index=1, process_count=2).batch_at(step)
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["targets"][:, :-1], a["inputs"][:, 1:])
        a = tdata.EmbeddingStubDataset(16, 100, 8, 2, seed=1, process_index=0, process_count=1).batch_at(step)
        b = jdata.EmbeddingStubDataset(16, 100, 8, 2, seed=1, process_index=0, process_count=1).batch_at(step)
        for k in ("inputs", "targets"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_make_dataset_and_process_slice_default():
    """Without a process group the slice is 0 of 1 (the reference's one
    process); make_dataset picks the same dataset kind."""
    cfg = get_config("smollm-360m")
    ds = tdata.make_dataset(cfg, 16, 4, seed=2)
    assert isinstance(ds, tdata.SyntheticLMDataset) and (ds.pi, ds.pc, ds.local_batch) == (0, 1, 4)
    ref = jdata.make_dataset(cfg, 16, 4, seed=2)
    np.testing.assert_array_equal(ds.batch_at(3)["inputs"], ref.batch_at(3)["inputs"])
    with pytest.raises(ValueError):
        tdata.SyntheticLMDataset(100, 8, 3, process_index=0, process_count=2)


def test_prefetch_preserves_order():
    assert list(tdata.prefetch(iter(range(10)), size=3)) == list(range(10))
    ds = tdata.SyntheticLMDataset(100, 8, 2, seed=1)
    it = iter(ds)
    got = [next(it) for _ in range(3)]
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["inputs"], ds.batch_at(i)["inputs"])
