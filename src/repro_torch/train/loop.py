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
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.layers import current_crossbar
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
):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``; params and state are updated in place.  ``batch``
    holds tensors on the params' device; ``metrics`` are 0-d device tensors
    (``loss``, ``grad_norm``, ``skipped``).  With ``microbatches`` the
    leading batch dim is split and loss and grads accumulate in float32,
    then are divided, as the reference's scan does."""
    if current_crossbar().enabled:
        raise RuntimeError("make_train_step under an enabled crossbar mode: training runs on the plain matmuls")
    loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b))

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in mbatch.items()})
                loss = loss + l
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)

        gnorm = global_norm(grads)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        for g in leaves(grads):
            g.masked_fill_(~ok, 0)
        opt.update(grads, opt_state, params, step, ok=ok)
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
    holds every step's host-clock seconds (to the end of its device work)."""

    def __init__(
        self,
        cfg: ModelConfig,
        train_step,
        dataset,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        log_every: int = 10,
        heartbeat_path: Optional[str] = None,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.dataset = dataset
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.heartbeat_path = heartbeat_path
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
                state, step, _ = self.ckpt.restore_latest(state)
                params, opt_state = state["params"], state["opt"]
                print(f"[train] resumed from step {step}", flush=True)
            except FileNotFoundError:
                pass
        return params, opt_state, step

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
            if self.heartbeat_path:
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
                print(f"[train] {rec}", flush=True)
            if self.ckpt is not None and (i + 1) % self.ckpt_every == 0:
                self.ckpt.save_async(i + 1, {"params": params, "opt": opt_state})
        if self.ckpt is not None:
            self.ckpt.save_async(num_steps, {"params": params, "opt": opt_state})
            self.ckpt.wait()
        return params, opt_state
