"""PyTorch port, training over a mesh (``launch.sharding``,
``models.parallel``, ``train.make_train_step(mesh=)``, ``TrainLoop(mesh=)``)
against the JAX package on the CPU.

Reduced smollm (at its own 15 / 5 heads of 8, so that the model axis splits
``wq`` and ``wk`` / ``wv`` mid-head), gemma2 (softcaps, post-norms, a local
window) and starcoder2 (a plain GELU FFN) train on a (data 2, model 2) mesh
under the ``tp`` layout, and xlstm on the same 4 ranks under ``pure_dp``,
in float32, with a mask whose density differs row by row (so by rank).
smollm and gemma2 recompute each layer in backward (remat), and the ranks
cut the loss into chunks of 8 positions: both rerun the forward's
collectives.  One spawn of 4 gloo ranks (``tests/_mesh_train.py``) runs
every case; params come from the port's ``init_model``.

Held: the loss (1e-6 relative) and every gathered gradient leaf (rel-L2
1e-5) against the reference's one-device ``jax.value_and_grad(loss_fn)``
and against the port's one-device step (with two microbatches too); the
loss against the reference's own sharded ``jax.jit(loss_fn)`` on a (2, 2)
mesh of 4 host devices (the one JAX subprocess); the grad-norm metric and
one SGD step's params against one device; each rank's resident params and
moments at its specs' share; a resumed mesh run ``torch.equal`` to an
uninterrupted one, its checkpoint restored on one device, and a one-device
checkpoint resumed on the mesh.  Three planted faults each break the
assertion named beside it in ``test_planted_faults_fail``."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_train import FAULTS, LR, STEPS, rank_main
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import model as TM
from repro_torch.optim import constant, make_optimizer
from repro_torch.train import TrainLoop, make_train_step
from repro_torch.tree import flatten, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 1e-6
GRAD_REL_L2 = 1e-5
B, S = 4, 24
ROW_KEEP = (0.9, 0.6, 0.3, 0.8)  # each row's share of unmasked positions

# name: (arch, reduced() overrides, mesh shape); the layout is the config's
CASES = {
    "smollm": ("smollm-360m", dict(n_heads=15, n_kv_heads=5, head_dim=8, remat=True), (2, 2)),
    "gemma2": ("gemma2-9b", dict(remat=True), (2, 2)),
    "starcoder2": ("starcoder2-3b", {}, (2, 2)),
    "xlstm": ("xlstm-350m", dict(layout="pure_dp"), (2, 2)),
}
TP_CASES = ("smollm", "gemma2", "starcoder2")

# The reference's sharded loss: its param and batch shardings on a (2, 2)
# mesh of host devices under the config's layout, jax.jit of loss_fn.
_JAX_SHARDED_LOSS = """
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.launch import sharding as shlib
from repro.models import model as M
from repro.models.layers import layout_overrides, use_mesh

d, cases = sys.argv[1], json.loads(sys.argv[2])
out = {}
for name, (arch, kw) in cases.items():
    cfg = configs.reduced(configs.get_config(arch), **kw)
    with np.load(f"{d}/{name}.npz") as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, v in flat.items():
        if key.startswith("p/"):
            node = params
            *path, last = key[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = v
    batch = {k[2:]: v for k, v in flat.items() if k.startswith("b/")}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with use_mesh(mesh, layout_overrides(cfg)), mesh:
        shapes, axes = M.init_model(jax.random.PRNGKey(0), cfg, shape_only=True)
        p = jax.tree.map(jax.device_put, params, shlib.param_shardings(shapes, axes, mesh))
        b = jax.tree.map(jax.device_put, batch, shlib.batch_shardings(
            jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch), mesh))
        out[name] = float(jax.jit(lambda p, b: M.loss_fn(p, cfg, b))(p, b))
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {
        "inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": (rng.uniform(size=(B, S)) < np.array(ROW_KEEP)[:, None]).astype(np.float32),
    }


def _one_device(cfg, params, batch, microbatches=1):
    """The port's one-device step: loss, grads, grad-norm metric, and the
    params after one SGD step (the ranks' ``mesh_step`` on one device)."""
    seen = {}
    opt = make_optimizer("sgd", constant(LR))

    def spy(grads, st, p, step, ok=None, norm=None):
        seen.update({k: g.clone() for k, g in flatten(grads).items()})
        return opt.update(grads, st, p, step, ok=ok, norm=norm)

    p = tree_map(torch.clone, params)
    step_fn = make_train_step(cfg, opt._replace(update=spy), microbatches=microbatches)
    p, _, _, m = step_fn(p, opt.init(p), torch.tensor(0), {k: torch.from_numpy(v) for k, v in batch.items()})
    return {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "grads": {k: g.numpy() for k, g in seen.items()}, "stepped": {k: v.numpy() for k, v in flatten(p).items()},
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's params and batch written; the JAX subprocess started;
    the reference's one-device loss and grads and the port's one-device
    steps here; the one-device checkpoint for the mesh to resume; then the
    ranks."""
    d = tmp_path_factory.mktemp("mesh_train")
    cases, tcfgs, data = {}, {}, {}
    for i, (name, (arch, kw, shape)) in enumerate(CASES.items()):
        tcfg = reduced(get_config(arch), **kw)
        params = TM.init_model(tcfg, 10 + i, device="cpu")
        batch = _batch(tcfg, 20 + i)
        np.savez(d / f"{name}.npz", **{f"p/{k}": v.numpy() for k, v in flatten(params).items()},
                 **{f"b/{k}": v for k, v in batch.items()})
        cases[name], tcfgs[name], data[name] = (tcfg, shape), tcfg, (params, batch)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false")
    sub = subprocess.Popen(
        [sys.executable, "-c", _JAX_SHARDED_LOSS, str(d),
         json.dumps({n: (CASES[n][0], CASES[n][1]) for n in TP_CASES})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        ref, one = {}, {}
        for name, (arch, kw, _) in CASES.items():
            jcfg = jconfigs.reduced(jconfigs.get_config(arch), **kw)
            params, batch = data[name]
            jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
            jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(
                jp, jcfg, jax.tree.map(jnp.asarray, batch)
            )
            ref[name] = (float(jl), {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, jg)).items()})
            one[name] = _one_device(tcfgs[name], params, batch)
            one[name]["microbatched"] = _one_device(tcfgs[name], params, batch, microbatches=2)["grads"]
        # the one-device run the mesh resumes: STEPS // 2 steps, checkpointed
        cfg = tcfgs["smollm"]
        opt = make_optimizer("adamw", constant(1e-3))
        p = tree_map(torch.clone, data["smollm"][0])
        one_loop = TrainLoop(cfg, make_train_step(cfg, opt), SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=3),
                             ckpt_dir=str(d / "one_device"), ckpt_every=STEPS // 2, log_every=1)
        one_loop.run(p, opt.init(p), STEPS // 2)
        one["loop_losses"] = [r["loss"] for r in one_loop.history]
        ranks = run_ranks(rank_main, 4, (str(d), cases, "smollm", "smollm", str(d / "mesh"), str(d / "one_device")),
                          timeout_s=300)
        out, err = sub.communicate(timeout=300)
    finally:
        sub.kill()
    assert sub.returncode == 0, err[-4000:]
    return dict(dir=d, cfgs=tcfgs, ref=ref, one=one, mesh=ranks[0], jax_sharded=json.loads(out.strip().splitlines()[-1]))


def _rel_l2(a, ref):
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def _worst(grads, ref):
    assert grads.keys() == ref.keys()
    errs = {k: _rel_l2(grads[k], v) for k, v in ref.items()}
    assert all(np.linalg.norm(v) > 0 for v in ref.values())
    return max(errs.values()), max(errs, key=errs.get)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_loss_and_grads_match_reference(run, name):
    got, (jl, jg) = run["mesh"][name], run["ref"][name]
    assert got["skipped"] == 0
    assert abs(got["loss"] - jl) <= LOSS_REL * abs(jl)
    worst, leaf = _worst(got["grads"], jg)
    assert worst <= GRAD_REL_L2, (name, leaf, worst)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_matches_the_one_device_port(run, name):
    """Loss, grads, the grad-norm metric and one SGD step's params against
    the port on one device; two microbatches' grads too."""
    got, one = run["mesh"][name], run["one"][name]
    assert abs(got["loss"] - one["loss"]) <= LOSS_REL * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= LOSS_REL * one["grad_norm"]
    assert _worst(got["grads"], one["grads"])[0] <= GRAD_REL_L2
    assert _worst(got["microbatched"], one["microbatched"])[0] <= GRAD_REL_L2
    for k, v in one["stepped"].items():
        np.testing.assert_allclose(got["stepped"][k], v, rtol=0, atol=1e-6 + LR * 1e-5 * np.abs(v).max())


@pytest.mark.parametrize("name", TP_CASES)
def test_mesh_loss_matches_the_reference_sharded_jit(run, name):
    want = run["jax_sharded"][name]
    assert abs(run["mesh"][name]["loss"] - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_specs_share(run, name):
    """Every param and moment leaf of rank 0 has its spec's block shape;
    under ``tp`` the params are under the whole tree's bytes, under
    ``pure_dp`` every leaf is whole."""
    shapes = run["mesh"][name]["shapes"]
    for kind in ("params", "adam"):
        for k, (held, share) in shapes[kind].items():
            assert held == share, (kind, k)
    held = sum(np.prod(h) for h, _ in shapes["params"].values())
    whole = sum(v.size for v in run["ref"][name][1].values())
    assert (held < 0.75 * whole) if name in TP_CASES else (held == whole)


def test_mesh_loop_trains_on_the_global_batch(run):
    """The mesh's TrainLoop reads the dataset's whole global batch on every
    rank and the step takes the rank's rows: its losses are the one-device
    loop's on the same dataset."""
    want = run["one"]["loop_losses"]
    got = run["mesh"]["resume"]["losses"][:len(want)]
    assert len(want) == STEPS // 2
    np.testing.assert_allclose(got, want, rtol=LOSS_REL * 10, atol=0)


def test_resumed_mesh_run_equals_the_uninterrupted_one(run):
    res = run["mesh"]["resume"]
    assert res["start"] == STEPS // 2 and res["latest"] == STEPS
    assert res["ref"].keys() == res["resumed"].keys()
    for k, v in res["ref"].items():
        assert np.array_equal(res["resumed"][k], v), k


def test_mesh_checkpoint_restores_on_one_device(run):
    """The mesh's checkpoint is the whole tree: one device restores it, leaf
    for leaf the gathered mesh state."""
    res = run["mesh"]["resume"]
    like = {k: torch.empty(0) for k in res["resumed"]}
    tree, step, _ = restore_checkpoint(str(run["dir"] / "mesh"), None, _nest(like))
    assert step == STEPS
    for k, v in flatten(tree).items():
        assert np.array_equal(v.numpy(), res["resumed"][k]), k


def test_one_device_checkpoint_resumes_on_the_mesh(run):
    """Each rank restores its blocks of a one-device checkpoint (rank 0's
    held to the checkpoint's slices) and trains on from its step."""
    res = run["mesh"]["resume"]
    assert res["one_device_start"] == STEPS // 2
    cfg = run["cfgs"]["smollm"]
    whole, _, _ = restore_checkpoint(str(run["dir"] / "one_device"), STEPS // 2,
                                     _nest({k: torch.empty(0) for k in res["restored_blocks"]}))
    mesh = Mesh((2, 2), ("data", "model"), rank=0)
    specs = sharding.train_specs(cfg, whole["params"], "adamw", mesh)
    blocks = flatten(sharding.local_slice(whole, specs, mesh))
    for k, v in res["restored_blocks"].items():
        assert np.array_equal(v, blocks[k].numpy()), k
    assert all(np.isfinite(v).all() for v in res["one_device_continued"].values())


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def test_planted_faults_fail(run):
    """Each fault must break the check named beside it (smollm on (2, 2)):
    * ``mean_of_means`` — the loss as the mean of the data ranks' masked
      means, under a mask that differs by rank: the loss against the
      reference's (and the gradients);
    * ``rank_norm`` — each rank's grad norm over its own blocks: the
      grad-norm metric against one device's (and so the clipped SGD step);
    * ``norm1_partial`` — no model-axis sum of ``norm1``'s gradient: that
      leaf's gradient against the reference's."""
    jl, jg = run["ref"]["smollm"]
    one = run["one"]["smollm"]
    faults = run["mesh"]["faults"]
    assert set(faults) == set(FAULTS)
    assert abs(faults["mean_of_means"]["loss"] - jl) > LOSS_REL * abs(jl)
    assert abs(faults["rank_norm"]["grad_norm"] - one["grad_norm"]) > LOSS_REL * one["grad_norm"]
    assert any(
        np.abs(faults["rank_norm"]["stepped"][k] - v).max() > 1e-6 + LR * 1e-5 * np.abs(v).max()
        for k, v in one["stepped"].items()
    )
    norm1 = [k for k in jg if k.endswith("/norm1")]
    assert norm1 and all(_rel_l2(faults["norm1_partial"]["grads"][k], jg[k]) > GRAD_REL_L2 for k in norm1)
    # the other leaves' gradients are still right: the fault is norm1's alone
    rest = {k: v for k, v in jg.items() if k not in norm1}
    assert _worst({k: faults["norm1_partial"]["grads"][k] for k in rest}, rest)[0] <= GRAD_REL_L2


def test_mailbox_collectives_equal_gloo(run):
    """The one-card transport's exchange (``Mesh._card_exchange``: rounds
    through each rank's mailbox, read in member order, the shared-memory
    barrier around the reads) on shared files in place of the card's
    mailboxes, 1 KB each so that every operand takes several rounds: every
    collective equal to gloo's."""
    got = run["mesh"]["mailboxes"]
    assert len(got) == 5 * 3 * 2 and all(got.values()), [k for k, v in got.items() if not v]


def test_traffic_runs_over_the_axes_of_the_layout(run):
    """Under ``tp`` the collectives run over "model" (the blocks) and
    "data" (the gradients); under ``pure_dp`` over both axes at once."""
    for name in TP_CASES:
        assert {"data", "model"} <= set(run["mesh"][name]["traffic_by_axis"])
    assert "data+model" in run["mesh"]["xlstm"]["traffic_by_axis"]
    assert "model" not in run["mesh"]["xlstm"]["traffic_by_axis"]


def test_ranks_on_the_cpu_exchange_through_gloo(run):
    """A rank that has not initialised CUDA has no card, so ``make_mesh``
    gives the mesh no mailboxes; both views of the one record of
    collectives (by op and dtype, by axes) count the same calls and bytes,
    none of them staged."""
    for name in (*TP_CASES, "xlstm"):
        got = run["mesh"][name]
        assert not got["mailboxes"]
        by_op = [r for by_dtype in got["traffic"].values() for r in by_dtype.values()]
        for key in ("calls", "bytes"):
            assert sum(r[key] for r in by_op) == sum(r[key] for r in got["traffic_by_axis"].values()) > 0
        assert sum(r["staged"] for r in by_op) == 0
