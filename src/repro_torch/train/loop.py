"""Training step + fault-tolerant loop (counterpart of ``repro.train.loop``).

``make_train_step`` builds the step: (optionally microbatched) loss and
gradients by autograd -> NaN/Inf guard (a bad step is *skipped*, not
applied: its gradients are zeroed and every param and state leaf keeps its
old value, selected on the device, so the step never reads back to the
host) -> optimizer update, in place.

``TrainLoop`` adds the operational layer: deterministic resume (data is a
pure function of step), async checkpoints, heartbeat + straggler monitor
(step-time EMA; outliers logged), and metric logging.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import _host_leaf
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import batch_shardings, gather_leaf, local_block, local_slice
from repro_torch.models import model as model_lib
from repro_torch.models import parallel
from repro_torch.models.layers import current_crossbar, layout_overrides, use_mesh
from repro_torch.optim import Optimizer, global_norm
from repro_torch.tree import leaves, named_leaves, tree_map, unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` on detached aliases of the
    params that require grad, so the caller's tensors stay plain; grads in
    the params' dtypes and structure."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    names = [name for name, _ in named_leaves(live)]
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves(live))
    return loss.detach(), unflatten(live, dict(zip(names, grads)))


def make_train_step(
    cfg: ModelConfig,
    opt: Optimizer,
    microbatches: int = 1,
    loss_fn: Optional[Callable] = None,
    mesh=None,
    specs=None,
):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``; params and state are updated in place.  ``batch``
    holds tensors on the params' device; ``metrics`` are 0-d device tensors
    (``loss``, ``grad_norm``, ``skipped``).  With ``microbatches`` the
    leading batch dim is split and loss and grads accumulate in float32,
    then are divided, as the reference's scan does.

    Over a ``mesh`` (a rank process; ``specs`` the param specs of
    ``launch.sharding.train_specs``) the params and state are the rank's
    blocks and ``batch`` is the *global* batch: each microbatch's rows are
    split by ``batch_shardings``, the loss runs under a ``parallel.Plan``
    (the global masked mean; tensor parallelism under the ``tp`` layout),
    the gradients are summed over the batch axes, and the norm, the NaN
    guard and the clipping see the whole tree, so every rank takes the same
    skip decision.  The metrics are the global ones on every rank."""
    if current_crossbar().enabled:
        raise RuntimeError("make_train_step under an enabled crossbar mode: training runs on the plain matmuls")
    loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b))
    if mesh is not None and specs is None:
        raise ValueError("make_train_step over a mesh needs the params' specs")

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(loss_fn, params, batch)
        with use_mesh(mesh, layout_overrides(cfg)):
            plan = parallel.make_plan(cfg, mesh, int(batch["targets"].shape[0]))
            rows = batch_shardings({k: tuple(v.shape) for k, v in batch.items()}, mesh)
        local = {k: local_block(v, rows[k], mesh) for k, v in batch.items()}
        with parallel.use_plan(plan):
            loss, grads = value_and_grad(loss_fn, params, local)
        if plan.batch_axes:
            grads = tree_map(lambda g: mesh.psum(g, plan.batch_axes), grads)
        return loss, grads

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                l, g = grads_of(params, {k: v[i] for k, v in mbatch.items()})
                loss = loss + l
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)

        gnorm = global_norm(grads, specs, mesh)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        for g in leaves(grads):
            g.masked_fill_(~ok, 0)
        opt.update(grads, opt_state, params, step, ok=ok, norm=gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm, "skipped": (~ok).to(torch.int32)}
        return params, opt_state, step + 1, metrics

    return train_step


@dataclasses.dataclass
class StragglerMonitor:
    """Step-time tracker: EMA + outlier flagging (straggler mitigation hook).

    On a real fleet the flag feeds preemption/replacement; here it logs and
    counts, and the count is surfaced in metrics so tests can poke it.
    """

    ema: float = 0.0
    beta: float = 0.9
    threshold: float = 3.0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        if self.ema == 0.0:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        self.ema = self.beta * self.ema + (1 - self.beta) * dt
        if is_straggler:
            self.flagged += 1
        return is_straggler


def _wait(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (``block_until_ready``)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class TrainLoop:
    """The train loop over ``dataset.batch_at(step)``.  ``step_seconds``
    holds every step's host-clock seconds (to the end of its device work).

    Over a ``mesh`` (``specs``: ``launch.sharding.train_specs``) the params
    and state are the rank's blocks and the step is a mesh step.  A
    checkpoint is the whole tree in the one-device format: every rank
    gathers it leaf by leaf on this thread at the same step, and rank 0
    writes it (asynchronously, as on one device); a resume reads the whole
    tree on every rank and keeps the rank's blocks.  So a mesh run resumes
    from a one-device checkpoint and the other way round.  Only rank 0
    prints and writes the heartbeat."""

    def __init__(
        self,
        cfg: ModelConfig,
        train_step,
        dataset,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        log_every: int = 10,
        heartbeat_path: Optional[str] = None,
        mesh=None,
        specs=None,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.dataset = dataset
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.heartbeat_path = heartbeat_path
        self.mesh, self.specs = mesh, specs
        self.main = mesh is None or mesh.rank == 0
        self.monitor = StragglerMonitor()
        self.history: List[dict] = []
        self.step_seconds: List[float] = []

    def maybe_resume(self, params, opt_state):
        """(params, opt_state, step) from the newest checkpoint, restored
        onto the devices of the given trees; the given ones and step 0
        where there is none."""
        step = 0
        if self.ckpt is not None:
            try:
                state = {"params": params, "opt": opt_state}
                if self.mesh is None:
                    state, step, _ = self.ckpt.restore_latest(state)
                else:
                    whole, step, _ = self.ckpt.restore_latest(tree_map(lambda t: torch.empty(0), state))
                    blocks = local_slice(whole, self.specs, self.mesh)
                    state = tree_map(lambda b, t: b.to(t.device), blocks, state)
                params, opt_state = state["params"], state["opt"]
                if self.main:
                    print(f"[train] resumed from step {step}", flush=True)
            except FileNotFoundError:
                pass
        return params, opt_state, step

    def _save(self, step: int, state) -> None:
        if self.mesh is None:
            self.ckpt.save_async(step, state)
            return
        self.ckpt.wait()
        t0 = time.perf_counter()
        host = {}
        for (key, leaf), spec in zip(named_leaves(state), leaves(self.specs)):
            whole = gather_leaf(leaf, spec, self.mesh)
            if self.main:
                host[key] = _host_leaf(whole)
            del whole
        self.ckpt.snapshot_seconds = time.perf_counter() - t0
        if self.main:
            self.ckpt.write_async(step, host)

    def run(self, params, opt_state, num_steps: int, start_step: int = 0):
        device = leaves(params)[0].device
        step = torch.tensor(start_step, dtype=torch.int32, device=device)
        for i in range(start_step, num_steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in self.dataset.batch_at(i).items()}
            t0 = time.perf_counter()
            params, opt_state, step, metrics = self.train_step(params, opt_state, step, batch)
            _wait(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_seconds.append(dt)
            straggler = self.monitor.observe(dt)
            if self.heartbeat_path and self.main:
                with open(self.heartbeat_path, "w") as f:
                    json.dump({"step": i, "time": time.time(), "dt": dt}, f)
            if i % self.log_every == 0 or straggler:
                rec = {
                    "step": i,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "skipped": int(metrics["skipped"]),
                    "dt_s": dt,
                    "straggler": straggler,
                }
                self.history.append(rec)
                if self.main:
                    print(f"[train] {rec}", flush=True)
            if self.ckpt is not None and (i + 1) % self.ckpt_every == 0:
                self._save(i + 1, {"params": params, "opt": opt_state})
        if self.ckpt is not None:
            self._save(num_steps, {"params": params, "opt": opt_state})
            self.ckpt.wait()
            if self.mesh is not None:
                self.mesh.barrier()  # the checkpoint is on disk for every rank
        return params, opt_state
