"""Device meshes over rank processes (counterpart of ``repro.launch.mesh``).

The reference lays one process's devices out as a ``jax.sharding.Mesh`` and
runs ``shard_map`` bodies over it.  The port runs one process per rank under
``torch.distributed``: a ``Mesh`` names the axes, their sizes, this rank's
coordinate on each (the rank numbered row-major over the shape, as the
reference reshapes its device list) and one process subgroup per axis and
per tuple of axes, and carries the collectives the MoE bodies need with the
reference's ``jax.lax`` semantics:

* ``psum(x, axis)`` — sum over the ranks that share every other coordinate;
* ``all_to_all(x, axis)`` — tiled, split on dim 0 and concatenated on dim 0
  in source-rank order (``jax.lax.all_to_all(..., 0, 0, tiled=True)``);
* ``psum_scatter(x, axis, dim)`` — tiled: the sum, this rank's block of
  ``dim``;
* ``all_gather(x, axis, dim)`` — tiled: the blocks of ``dim`` in rank order
  (the port's bodies return whole tensors on every rank, where a
  ``shard_map`` returns them sharded by its ``out_specs``).

Results are contiguous (the kernels' wrappers take no strided operand).  A
collective over a size-1 axis returns its input.  Operands cross the wire
in their own dtype; ``traffic`` counts each collective's calls, bytes and
host-staged calls by dtype.  The backend is whatever the process group was
made with (``gloo`` on the CPU, and for ranks that share one card, where
NCCL refuses two ranks on one GPU).  Under ``gloo`` every CUDA operand is
staged through host memory here, explicitly: the collective runs on a host
copy and its result is copied back to the card (gloo's own CUDA paths
accept the operands but are not relied on).

``run_ranks`` spawns the rank processes (``spawn``, never ``fork``: the
parent may hold a CUDA context) in one group over a ``FileStore``.  Nothing
degrades: a mesh whose shape does not fill the world is refused, and a rank
that fails fails the run.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


class Mesh:
    """A ``shape`` of ranks with named axes.  ``rank`` None is a layout
    without a rank (what a placement record needs); a mesh from
    ``make_mesh`` also holds the process groups its collectives run in."""

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Sequence[str],
        rank: Optional[int] = None,
        groups: Optional[Dict[Tuple[str, ...], Any]] = None,
        backend: Optional[str] = None,
    ):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ in length")
        self.devices_shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = math.prod(self.devices_shape)
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        self._groups = groups
        self.backend = backend
        self.traffic: Dict[str, Dict[str, Dict[str, int]]] = {}

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def coords(self) -> Dict[str, int]:
        """{axis: this rank's index}: the rank read row-major over the shape."""
        if self.rank is None:
            raise ValueError("a mesh without a rank has no coordinates")
        out, r = {}, self.rank
        for name, size in reversed(list(zip(self.axis_names, self.devices_shape))):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)  # mesh order

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along ``axis`` (a tuple linearised row-major)."""
        idx, coords = 0, self.coords
        for a in self._axes(axis):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axis: Axes):
        """The process group of the ranks that share this rank's coordinate
        on every axis outside ``axis``."""
        if self._groups is None:
            raise RuntimeError("this mesh has no process groups: build it with make_mesh")
        return self._groups[self._axes(axis)]

    def _collective(self, name: str, axis: Axes, inp: torch.Tensor, out_shape, op) -> torch.Tensor:
        """``op(out, inp, group)`` into a fresh ``out``; under gloo a CUDA
        operand is staged through host memory and the result copied back."""
        inp = inp.contiguous()
        stage = inp.is_cuda and self.backend == "gloo"
        src = inp.cpu() if stage else inp
        out = torch.empty(tuple(out_shape), dtype=src.dtype, device=src.device)
        op(out, src, self.group(axis))
        rec = self.traffic.setdefault(name, {}).setdefault(
            str(inp.dtype).replace("torch.", ""), {"calls": 0, "bytes": 0, "staged": 0}
        )
        rec["calls"] += 1
        rec["bytes"] += inp.numel() * inp.element_size()
        rec["staged"] += int(stage)
        return out.to(inp.device) if stage else out

    # -- collectives --------------------------------------------------------

    def psum(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x

        def op(out, src, group):
            out.copy_(src)
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)

        return self._collective("psum", axis, x, x.shape, op)

    def all_to_all(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split over {n} ranks")
        return self._collective(
            "all_to_all", axis, x, x.shape, lambda out, src, group: dist.all_to_all_single(out, src, group=group)
        )

    def psum_scatter(self, x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        inp = x.movedim(dim, 0)
        out = self._collective(
            "psum_scatter", axis, inp, (inp.shape[0] // n,) + tuple(inp.shape[1:]),
            lambda out, src, group: dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group),
        )
        return out.movedim(0, dim).contiguous()

    def all_gather(self, x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return x
        inp = x.movedim(dim, 0)
        out = self._collective(
            "all_gather", axis, inp, (inp.shape[0] * n,) + tuple(inp.shape[1:]),
            lambda out, src, group: dist.all_gather_into_tensor(out, src, group=group),
        )
        return out.movedim(0, dim).contiguous()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """This rank's view of a mesh over the whole initialised world.  Every
    rank must call it with the same arguments, in the same order as its
    other ``make_mesh`` calls: it makes one process group per tuple of axes
    (in mesh order) and per coordinate of the axes outside it, collectively.
    A shape that does not fill the world is refused."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks, the world has {world}")
    layout = Mesh(shape, axis_names)
    names = layout.axis_names
    groups: Dict[Tuple[str, ...], Any] = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if layout.axis_size(axes) == 1:
                continue  # a collective over a size-1 axis needs no group
            others = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(layout.shape[a]) for a in others)):
                members = [
                    r for r in range(world)
                    if all(Mesh(shape, names, r).coords[a] == v for a, v in zip(others, fixed))
                ]
                g = dist.new_group(members)
                if rank in members:
                    groups[axes] = g
    return Mesh(shape, names, rank, groups, dist.get_backend())


def make_local_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A ("data", "model") mesh over the world (tests, the card's rank
    phase); ``data`` defaults to ``world // model``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    return make_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The deployment topology: a 16x16 ("data", "model") pod, or 2x16x16
    ("pod", "data", "model") for two pods.  A world of another size is
    refused."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(f"production mesh needs {math.prod(shape)} ranks, have {world}")
    return make_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank: int, world: int, init_method: str, backend: str, args, results) -> None:
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent raises it; a rank never exits quietly
        results.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn: Callable[..., Any], world: int, args: Tuple = (), *, backend: str = "gloo", timeout_s: float = 600.0,
) -> List[Any]:
    """``fn(rank, *args)`` in ``world`` spawned processes joined in one
    ``backend`` process group (a ``FileStore`` in a fresh temporary
    directory); returns the values in rank order.  ``fn`` and ``args`` must
    pickle (``fn`` importable at module level).  A rank that raises, dies or
    outlives ``timeout_s`` fails the run, and every rank process is stopped
    before this returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [
        ctx.Process(target=_rank_entry, args=(fn, r, world, init_method, backend, args, results), daemon=True)
        for r in range(world)
    ]
    got: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} still running after {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
