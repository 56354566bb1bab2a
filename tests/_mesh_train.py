"""Rank bodies of ``test_torch_mesh_train.py`` (free of JAX: spawned rank
processes import this module).  Each rank rebuilds a case's params from its
``.npz``, keeps its blocks and runs the mesh train step's pieces."""
import os

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.optim import constant, make_optimizer, optimizers
from repro_torch.train import TrainLoop, loop as loop_mod, make_train_step
from repro_torch.tree import flatten, unflatten

LR = 0.05
LOSS_CHUNK = 8  # the ranks' loss chunks: several a sequence, each recomputed in backward
STEPS = 4  # the resume runs: uninterrupted, and checkpointed at half
FAULTS = ("mean_of_means", "rank_norm", "norm1_partial")


def load(directory, name):
    with np.load(os.path.join(directory, f"{name}.npz")) as z:
        flat = {k: torch.from_numpy(z[k]) for k in z.files}
    params = unflatten_paths({k[2:]: v for k, v in flat.items() if k.startswith("p/")})
    batch = {k[2:]: v for k, v in flat.items() if k.startswith("b/")}
    return params, batch


def unflatten_paths(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def plant(fault):
    """Install one planted fault in this rank process (see the test)."""
    if fault == "mean_of_means":
        def mean_of_means(total, mask):
            plan = parallel.current()
            local = total / torch.clamp(torch.sum(mask), min=1.0)
            n = 1
            for a in plan.batch_axes:
                n *= plan.mesh.shape[a]
            return parallel.batch_sum(local) / n
        TM._masked_mean = mean_of_means
    elif fault == "rank_norm":
        loop_mod.global_norm = lambda tree, specs=None, mesh=None: optimizers.global_norm(tree)
    elif fault == "norm1_partial":
        real = TM._pre_norm

        def pre_norm(params, key, x, cfg):
            if key == "norm1":
                return layers.rms_norm(parallel.enter(x), params[key], cfg.norm_eps)  # the scale not entered
            return real(params, key, x, cfg)
        TM._pre_norm = pre_norm
    elif fault is not None:
        raise ValueError(fault)


def held_shapes(tree, whole, specs, mesh):
    """{leaf: (the rank's shape, its spec's share of the whole leaf)}."""
    whole, specs = flatten(whole), flatten(specs)
    return {k: (tuple(v.shape), sharding.local_shape(whole[k].shape, specs[k], mesh)) for k, v in flatten(tree).items()}


def mesh_step(cfg, mesh, params, batch, microbatches=1):
    """The mesh's loss, whole gradients (gathered) and one SGD step's
    grad-norm metric and whole updated params, from whole ``params``; the
    rank's params and AdamW moments beside the specs' shares."""
    opt = make_optimizer("sgd", constant(LR))
    specs = sharding.train_specs(cfg, params, "sgd", mesh)
    local = sharding.local_slice(params, specs["params"], mesh)
    state = opt.init(local)
    adam = make_optimizer("adamw", constant(1e-3))
    shapes = {
        "params": held_shapes(local, params, specs["params"], mesh),
        "adam": held_shapes(adam.init(local), adam.init(sharding.abstract(params)),
                            sharding.train_specs(cfg, params, "adamw", mesh)["opt"], mesh),
    }
    grads_seen = {}
    real_update = opt.update

    def spy(grads, st, p, step, ok=None, norm=None):
        grads_seen.update({k: g.clone() for k, g in flatten(grads).items()})
        return real_update(grads, st, p, step, ok=ok, norm=norm)

    step_fn = make_train_step(cfg, optimizers.Optimizer(opt.init, spy), microbatches=microbatches, mesh=mesh,
                              specs=specs["params"])
    local, state, _, metrics = step_fn(local, state, torch.tensor(0), batch)
    whole_grads = sharding.gather(unflatten(local, grads_seen), specs["params"], mesh)
    whole = sharding.gather(local, specs["params"], mesh)
    return {
        "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
        "skipped": int(metrics["skipped"]),
        "grads": {k: v.numpy() for k, v in flatten(whole_grads).items()},
        "stepped": {k: v.numpy() for k, v in flatten(whole).items()},
        "shapes": shapes,
    }


def resume(cfg, mesh, params, directory, ckpt_dir, one_device_dir):
    """``STEPS`` steps of a TrainLoop uninterrupted, against half of them
    with a checkpoint there and a fresh loop resuming; then a fresh loop
    resuming the one-device checkpoint in ``one_device_dir``: the rank's
    restored blocks against that checkpoint's slices, and its next steps."""
    opt = make_optimizer("adamw", constant(1e-3))
    specs = sharding.train_specs(cfg, params, "adamw", mesh)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=3, process_index=0, process_count=1)
    step_fn = make_train_step(cfg, opt, mesh=mesh, specs=specs["params"])

    def fresh():
        p = sharding.local_slice(params, specs["params"], mesh)
        return p, opt.init(p)

    def whole(p, o):
        return {k: v.numpy() for k, v in flatten(sharding.gather({"params": p, "opt": o}, specs, mesh)).items()}

    whole_run = TrainLoop(cfg, step_fn, ds, log_every=1, mesh=mesh, specs=specs)
    p, o = whole_run.run(*fresh(), STEPS)
    ref = whole(p, o)
    TrainLoop(cfg, step_fn, ds, ckpt_dir=ckpt_dir, ckpt_every=STEPS // 2, mesh=mesh, specs=specs).run(*fresh(), STEPS // 2)
    loop = TrainLoop(cfg, step_fn, ds, ckpt_dir=ckpt_dir, mesh=mesh, specs=specs)
    p, o, start = loop.maybe_resume(*fresh())
    p, o = loop.run(p, o, STEPS, start_step=start)
    resumed = whole(p, o)

    other = TrainLoop(cfg, step_fn, ds, ckpt_dir=one_device_dir, mesh=mesh, specs=specs)
    p, o, other_start = other.maybe_resume(*fresh())
    restored = {k: v.clone() for k, v in flatten({"params": p, "opt": o}).items()}
    p, o = other.run(p, o, STEPS, start_step=other_start)
    return {
        "start": start, "ref": ref, "resumed": resumed, "latest": latest_step(ckpt_dir),
        "losses": [r["loss"] for r in whole_run.history],
        "one_device_start": other_start, "restored_blocks": {k: v.numpy() for k, v in restored.items()},
        "one_device_continued": whole(p, o),
    }


class FileMailboxes(mesh_mod._Mailboxes):
    """The card's mailboxes with the card left out: every rank's mailbox a
    shared file mapped into every process; the same shared-memory barrier
    (CPU tensors need no device synchronisation)."""

    def __init__(self, directory, nbytes, groups):
        self.device, self.nbytes = torch.device("cpu"), nbytes
        self.rank = torch.distributed.get_rank()
        self.boxes = [
            torch.from_file(os.path.join(directory, f"box{r}"), shared=True, size=nbytes, dtype=torch.uint8)
            for r in range(torch.distributed.get_world_size())
        ]
        self._share_slots(groups)

    def _sync(self):
        pass


def mailbox_collectives(mesh, directory):
    """Each mailbox collective against the same gloo collective, over every
    axis and both, on integer-valued float32 (exact sums in any order) and
    bfloat16 operands several mailboxes long: {case: equal}."""
    mesh._card = FileMailboxes(directory, 1 << 10, 3)
    gen = torch.Generator().manual_seed(mesh.rank)
    out = {}
    for axis in ("data", "model", ("data", "model")):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randint(-8, 8, (4, 300), generator=gen).to(dtype)
            cases = {
                "psum": (mesh._card_reduce(x, axis, "sum"), mesh.psum(x, axis)),
                "pmax": (mesh._card_reduce(x, axis, "max"), mesh.pmax(x, axis)),
                "all_gather": (mesh._card_gather(x, axis), mesh.all_gather(x, axis, 0)),
                "psum_scatter": (mesh._card_scatter(x, axis, "sum"), mesh.psum_scatter(x, axis, 0)),
                "all_to_all": (mesh._card_scatter(x, axis, "swap"), mesh.all_to_all(x, axis)),
            }
            out.update({f"{k} {axis} {dtype}": torch.equal(a, b) for k, (a, b) in cases.items()})
    mesh._card = None
    return out


def rank_main(rank, directory, cases, faults_case, resume_case, ckpt_dir, one_device_dir):
    """Every case on its mesh, the planted faults on ``faults_case``, the
    resume runs on ``resume_case``; rank 0 returns the results."""
    torch.set_num_threads(1)
    TM.LOSS_CHUNK = LOSS_CHUNK
    out = {}
    for name, (cfg, shape) in cases.items():
        mesh = make_local_mesh(*shape)
        params, batch = load(directory, name)
        out[name] = mesh_step(cfg, mesh, params, batch)
        out[name]["microbatched"] = mesh_step(cfg, mesh, params, batch, microbatches=2)["grads"]
        out[name]["traffic_by_axis"] = mesh.traffic_by_axis
        out[name]["traffic"] = mesh.traffic
        out[name]["mailboxes"] = mesh._card is not None
    cfg, shape = cases[faults_case]
    mesh = make_local_mesh(*shape)
    params, batch = load(directory, faults_case)
    saved = (TM._masked_mean, loop_mod.global_norm, TM._pre_norm)
    out["faults"] = {}
    for fault in FAULTS:
        plant(fault)
        try:
            out["faults"][fault] = mesh_step(cfg, mesh, params, batch)
        finally:
            TM._masked_mean, loop_mod.global_norm, TM._pre_norm = saved
    cfg, shape = cases[resume_case]
    params, _ = load(directory, resume_case)
    out["resume"] = resume(cfg, make_local_mesh(*shape), params, directory, ckpt_dir, one_device_dir)
    out["mailboxes"] = mailbox_collectives(make_local_mesh(2, 2), directory)
    return out if rank == 0 else None
