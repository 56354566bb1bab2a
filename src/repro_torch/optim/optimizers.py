"""Optimizers (counterpart of ``repro.optim.optimizers``): SGD-momentum,
AdamW and Adafactor over nested dicts of tensors.

States keep the reference's layout — ``{"mu"}``, ``{"m", "v"}``, ``{"acc":
{leaf: {"vr", "vc"} | {"v"}}}``, float32 — so that a checkpoint written by
either package restores in the other.  The math is the reference's, step
for step in float32, and each new value is cast back to its leaf's dtype.

``update(grads, state, params, step, ok=None, norm=None)`` writes the new
params and state **in place** (under ``torch.no_grad``) and returns them;
``norm`` is the grads' global norm where the caller has it (over a mesh
only the caller can take it, ``global_norm(grads, specs, mesh)``).  Given
``ok`` (a 0-d bool tensor), every leaf keeps its old value where ``ok`` is
false, selected by ``torch.where`` on the device leaf by leaf: no host
read, and never a second copy of the whole state.  Layer-stacked leaves
large enough for the reference's ``_maybe_layerwise`` are updated one
leading-axis slice at a time, as its ``lax.map`` does (Adafactor's update
clipping then takes each slice's RMS, as there); SGD's and AdamW's
elementwise updates of other large leaves run in blocks of rows (the same
values, in less memory).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import flatten, leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]
    # update(grads, state, params, step, ok=None, norm=None) -> (params, state), in place


LAYERWISE_MIN_DIM = 3  # leaves stacked over layers get chunked updates


def _layerwise(p: torch.Tensor) -> bool:
    return p.ndim >= LAYERWISE_MIN_DIM and p.shape[0] <= 128 and p.numel() > (1 << 24)


ELEMENTWISE_BLOCK = 1 << 24  # elements an elementwise update of a large leaf takes at a time


def _apply(fn, ok: Optional[torch.Tensor], outs, *args, elementwise: bool = False) -> None:
    """``fn(*args)`` -> new values, written into ``outs`` (kept where not
    ``ok``); per leading-axis slice when the first arg is layerwise.  An
    ``elementwise`` ``fn`` (SGD's, AdamW's) runs over a large leaf in blocks
    of rows, the same values with a block's float32 temporaries in memory
    rather than the leaf's (a vocabulary table's would be GBs)."""
    if _layerwise(args[0]):
        for i in range(args[0].shape[0]):
            _apply_one(fn, ok, [o[i] for o in outs], *(a[i] for a in args))
    elif elementwise and args[0].ndim and args[0].numel() > ELEMENTWISE_BLOCK:
        rows = max(1, ELEMENTWISE_BLOCK * args[0].shape[0] // args[0].numel())
        for i in range(0, args[0].shape[0], rows):
            _apply_one(fn, ok, [o[i:i + rows] for o in outs], *(a[i:i + rows] for a in args))
    else:
        _apply_one(fn, ok, outs, *args)


def _apply_one(fn, ok, outs, *args) -> None:
    new = fn(*args)
    for o, n in zip(outs, new):
        o.copy_(n if ok is None else torch.where(ok, n, o))


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  Over a ``mesh`` each rank holds
    its block of a leaf split by its spec (``specs``, a tree of
    ``launch.sharding`` specs): the squares are summed over the axes each
    leaf is split over, so a split leaf counts each block once and a
    replicated leaf once, and every rank gets the same norm."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves(tree)))
    by_axes = {}
    for leaf, spec in zip(leaves(tree), leaves(specs)):
        axes = tuple(a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,)))
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    return torch.sqrt(sum(mesh.psum(sq, axes) if axes else sq for axes, sq in by_axes.items()))


def clip_by_global_norm(tree, max_norm: float, norm: Optional[torch.Tensor] = None):
    """The tree scaled to at most ``max_norm``; ``norm`` is its global norm
    where the caller has it (over a mesh, ``global_norm(tree, specs, mesh)``)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


def _step_tensor(step, params) -> torch.Tensor:
    device = leaves(params)[0].device
    return torch.as_tensor(step, device=device)


def sgd(lr_fn, momentum: float = 0.9, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params, step, ok=None, norm=None):
        grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        lr = lr_fn(_step_tensor(step, params))

        def upd(p, g, m):
            m1 = momentum * m + g.to(torch.float32)
            return (p - lr * m1).to(p.dtype), m1

        for p, g, m in zip(leaves(params), leaves(grads), leaves(state["mu"])):
            _apply(upd, ok, (p, m), p, g, m, elementwise=True)
        return params, state

    return Optimizer(init, update)


def adamw(
    lr_fn,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step, ok=None, norm=None):
        grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        step = _step_tensor(step, params)
        lr = lr_fn(step)
        t = step.to(torch.float32) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            m1 = b1 * m + (1 - b1) * gf
            v1 = b2 * v + (1 - b2) * gf * gf
            u = (m1 / c1) / (torch.sqrt(v1 / c2) + eps)
            pf = p.to(torch.float32)
            p1 = pf - lr * (u + weight_decay * pf)
            return p1.to(p.dtype), m1, v1

        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
            _apply(upd, ok, (p, m, v), p, g, m, v, elementwise=True)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def _is_factored(shape, min_size: int) -> bool:
    """Factor over the last two dims (handles (E, D, F) MoE stacks per-expert)."""
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def adafactor(
    lr_fn,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    def init(params):
        def one(p):
            if _is_factored(p.shape, min_dim_size_to_factor):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device),
                }
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return {"acc": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, ok=None, norm=None):  # no global clipping: ``norm`` unused
        step = _step_tensor(step, params)
        lr = lr_fn(step)
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)

        def finish(p, u):
            # update clipping by RMS
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            p1 = pf - lr * u
            if weight_decay:
                p1 = p1 - lr * weight_decay * pf
            return p1.to(p.dtype)

        def factored(p, g, vr, vc):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            vr1 = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
            vc1 = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
            # v_hat = outer(vr, vc) / mean(vr) (Shazeer & Stern eq. 4)
            vr_n = vr1 / torch.clamp(torch.mean(vr1, dim=-1, keepdim=True), min=1e-30)
            v_hat = vr_n[..., :, None] * vc1[..., None, :]
            u = gf * torch.rsqrt(torch.clamp(v_hat, min=eps))
            return finish(p, u), vr1, vc1

        def full(p, g, v):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            v1 = beta * v + (1 - beta) * g2
            u = gf * torch.rsqrt(torch.clamp(v1, min=eps))
            return finish(p, u), v1

        acc = flatten(state["acc"])
        for (path, p), g in zip(flatten(params).items(), leaves(grads)):
            if f"{path}/vr" in acc:
                vr, vc = acc[f"{path}/vr"], acc[f"{path}/vc"]
                _apply(factored, ok, (p, vr, vc), p, g, vr, vc)
            else:
                v = acc[f"{path}/v"]
                _apply(full, ok, (p, v), p, g, v)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    if name == "sgd":
        return sgd(lr_fn, **kw)
    raise ValueError(name)
