"""Sharding layout for params, optimizer state, batches and caches, and a
rank's slices of them (counterpart of ``repro.launch.sharding``).

A spec is a tuple of entries, one per dim, each None, an axis name or a
tuple of names: the reference's ``PartitionSpec`` (``layers.pspec``,
``device.programmed.dividing_pspec``).  Specs come from the logical axes
(``models.model.param_axes``, ``cache_axes``) under the active layout, so
these functions run under ``layers.use_mesh(mesh, layout_overrides(cfg))``.
A leaf of a "shapes" tree is a tensor (a ``meta`` one costs nothing, see
``abstract``) or a shape tuple.

Where the reference hands ``jax.jit`` the ``NamedSharding``s, a rank process
of the port holds ``local_slice(tree, specs, mesh)``, its block of each leaf;
``gather`` puts whole leaves back together (every rank takes part).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.device.programmed import dividing_pspec
from repro_torch.models.layers import _resolve_axis, dividing_entry, pspec


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _map(fn, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure; dicts and lists are
    containers (a cache is a list of stages), tuples are leaves (shapes and
    specs)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits its leaf over."""
    return tuple(a for e in spec for a in entry_axes(e))


def _one_name(entry):
    """A one-axis tuple entry as the bare name (``PartitionSpec``'s form)."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _entry_size(entry, mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in entry_axes(entry))


def abstract(tree):
    """The tree's leaves as ``meta`` tensors of the same shapes and dtypes
    (shapes for the functions below, and an optimizer's ``init`` of them,
    without memory)."""
    return _map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"), tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch axes under the active logical overrides (layers.use_mesh)."""
    resolved = _resolve_axis("batch", mesh)
    if resolved is None:
        return ()
    return resolved if isinstance(resolved, tuple) else (resolved,)


def dp_size(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in dp_axes(mesh))


def model_size(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def param_shardings(params_shapes, axes_tree, mesh, fsdp: bool = False):
    """Specs from the logical axes, non-dividing entries replicated; with
    ``fsdp`` each leaf of at least 4M elements also shards its largest
    unsharded dim that divides over "data" (ZeRO-3)."""
    dsize = int(mesh.shape["data"]) if "data" in mesh.axis_names else 0

    def one(leaf, axes):
        shape = _shape(leaf)
        spec = dividing_pspec(pspec(axes, mesh), shape, mesh.shape)
        if not fsdp or not dsize or math.prod(shape) < (1 << 22):
            return spec
        spec = list(spec)
        cands = sorted(
            (d for d in range(len(shape)) if spec[d] is None and shape[d] % dsize == 0), key=lambda d: -shape[d]
        )
        if cands:
            spec[cands[0]] = "data"
        return tuple(spec)

    return _map(one, params_shapes, axes_tree)


def _like(leaf, pspec_, mesh):
    """A state leaf's spec from its parameter's: the same where the shapes
    have one rank, the spec less its last entry where the leaf has one dim
    fewer (the reference takes that for Adafactor's ``vr`` and ``vc``
    alike), else replicated; entries that do not divide are dropped."""
    shape = _shape(leaf)
    if len(shape) == len(pspec_):
        take = list(pspec_)
    elif len(shape) == len(pspec_) - 1:
        take = list(pspec_)[:-1]
    else:
        take = [None] * len(shape)
    return tuple(
        None if ax is None or dim % _entry_size(ax, mesh) else ax for dim, ax in zip(shape, take)
    )


def opt_state_shardings(opt_name: str, state_shapes, param_specs, mesh):
    """Optimizer state mirrors its parameter's spec (``_like``)."""
    like = lambda leaf, p: _like(leaf, p, mesh)  # noqa: E731
    if opt_name == "adamw":
        return {"m": _map(like, state_shapes["m"], param_specs), "v": _map(like, state_shapes["v"], param_specs)}
    if opt_name == "adafactor":
        # param_specs leads: its leaf (a spec) meets the state's {"vr", "vc"} | {"v"} node
        return {"acc": _map(lambda p, acc: {k: like(v, p) for k, v in acc.items()}, param_specs, state_shapes["acc"])}
    if opt_name == "sgd":
        return {"mu": _map(like, state_shapes["mu"], param_specs)}
    raise ValueError(opt_name)


def batch_shardings(batch_shapes, mesh):
    """Input batches: the leading dim over the batch axes (the largest
    dividing prefix: a global batch of 2 on 4 pure-DP ranks shards over
    "data" and is replicated over "model")."""
    axes = dp_axes(mesh)

    def one(leaf):
        shape = _shape(leaf)
        if axes and shape:
            entry = dividing_entry(shape[0], axes, mesh)
            if entry is not None:
                return (_one_name(entry),) + (None,) * (len(shape) - 1)
        return ()

    return _map(one, batch_shapes)


def cache_shardings(cache_shapes, cache_axes_tree, mesh):
    """Resolve the cache's logical axes (``models.model.cache_axes``):
    cache_batch over the batch axes where the batch divides; cache_seq over
    them where it did not (long context); kv_heads / heads / d_inner over
    "model" where divisible."""
    dpx = dp_axes(mesh)
    dp = dp_size(mesh)

    def one(leaf, axes):
        shape = _shape(leaf)
        spec: list = [None] * len(shape)
        batch_sharded = False
        for d, (dim, ax) in enumerate(zip(shape, axes)):
            if ax == "cache_batch" and dp > 1 and dim > 1:
                entry = dividing_entry(dim, dpx, mesh)
                if entry is not None:
                    spec[d] = entry
                    batch_sharded = True
        for d, (dim, ax) in enumerate(zip(shape, axes)):
            if ax == "cache_seq" and not batch_sharded and dp > 1 and dim % dp == 0:
                spec[d] = dpx
            elif ax in ("kv_heads", "heads", "d_inner"):
                resolved = _resolve_axis(ax, mesh)
                if resolved is not None:
                    size = _entry_size(resolved, mesh)
                    if size > 1 and dim % size == 0:
                        spec[d] = resolved
        return tuple(_one_name(e) for e in spec)

    return _map(one, cache_shapes, cache_axes_tree)


def train_specs(cfg, params, opt_name: str, mesh) -> Dict[str, Any]:
    """{"params": ..., "opt": ...}: the specs of a training state on
    ``mesh`` under ``cfg``'s layout (``params`` whole, or their
    ``abstract`` shapes).  Adafactor's factored moments and its update's RMS
    need whole leaves: it is refused on a sharded tree."""
    from repro_torch.models.layers import layout_overrides, use_mesh
    from repro_torch.models.model import param_axes
    from repro_torch.optim import make_optimizer

    shapes = abstract(params)
    with use_mesh(mesh, layout_overrides(cfg)):
        p = param_shardings(shapes, param_axes(cfg), mesh, fsdp=cfg.fsdp)
        state = make_optimizer(opt_name, lambda step: 0.0).init(shapes)
        o = opt_state_shardings(opt_name, state, p, mesh)
    if opt_name == "adafactor" and any(spec_axes(s) for s in _leaves(p)):
        raise NotImplementedError(
            "Adafactor over sharded leaves: its factored moments and update RMS span whole leaves "
            "(ROADMAP.md Queue 1: MoE and FSDP training over a mesh)"
        )
    return {"params": p, "opt": o}


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape``."""
    return tuple(d // _entry_size(e, mesh) if e is not None else d for d, e in zip(_shape(shape), spec))


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of one leaf, a contiguous copy (the whole leaf may
    go, and an update in place reaches no other tree)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            n = x.shape[d] // _entry_size(entry, mesh)
            x = x.narrow(d, mesh.axis_index(entry) * n, n)
    return x.clone(memory_format=torch.contiguous_format)


def local_slice(tree, specs, mesh):
    """This rank's block of every leaf (copies)."""
    return _map(lambda x, s: local_block(x, s, mesh), tree, specs)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (a collective: every rank of
    the mesh calls it with its block, in the same order)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            x = mesh.all_gather(x, entry_axes(entry), d)
    return x


def gather(tree, specs, mesh):
    """Whole leaves on every rank."""
    return _map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)
