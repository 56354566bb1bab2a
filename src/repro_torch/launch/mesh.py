"""Device meshes over rank processes (counterpart of ``repro.launch.mesh``).

The reference lays one process's devices out as a ``jax.sharding.Mesh`` and
runs ``shard_map`` bodies over it.  The port runs one process per rank under
``torch.distributed``: a ``Mesh`` names the axes, their sizes, this rank's
coordinate on each (the rank numbered row-major over the shape, as the
reference reshapes its device list) and one process subgroup per axis and
per tuple of axes, and carries the collectives the MoE bodies need with the
reference's ``jax.lax`` semantics:

* ``psum(x, axis)`` — sum over the ranks that share every other coordinate
  (``pmax`` the same with the maximum);
* ``all_to_all(x, axis)`` — tiled, split on dim 0 and concatenated on dim 0
  in source-rank order (``jax.lax.all_to_all(..., 0, 0, tiled=True)``);
* ``psum_scatter(x, axis, dim)`` — tiled: the sum, this rank's block of
  ``dim``;
* ``all_gather(x, axis, dim)`` — tiled: the blocks of ``dim`` in rank order
  (the port's bodies return whole tensors on every rank, where a
  ``shard_map`` returns them sharded by its ``out_specs``).

Results are contiguous (the kernels' wrappers take no strided operand).  A
collective over a size-1 axis returns its input.  Operands cross the wire
in their own dtype; ``collectives`` records each collective's calls, bytes,
host-staged calls and host-clock seconds (staging included) by op, axes
and dtype, and ``traffic`` (by op and dtype) and ``traffic_by_axis`` (by
the axes, ``"data"``, ``"model"``, ``"data+model"``) are its two views.
The backend is whatever the process group was made with (``gloo`` on the
CPU, and for ranks that share one card, where NCCL refuses two ranks on one
GPU).  Where every rank works on the same card (its current CUDA device,
once it has initialised CUDA: ``make_mesh`` gathers the cards' UUIDs), the
ranks exchange CUDA operands on it: every rank's mailbox on the card is
mapped into every process through CUDA IPC, and a collective is device
copies and sums in rounds, with a barrier in host shared memory around each
round's reads (gloo carries no operand bytes then).  Otherwise, under
``gloo``, every CUDA operand is staged through host memory here,
explicitly: the collective runs on a host copy and its result is copied
back to the card (gloo's own CUDA paths accept the operands but are not
relied on); the host buffers are kept and reused, one a dtype for the
operands and one for the results.

``run_ranks`` spawns the rank processes (``spawn``, never ``fork``: the
parent may hold a CUDA context) in one group over a ``FileStore``.  Nothing
degrades: a mesh whose shape does not fill the world is refused, and a rank
that fails fails the run.
"""
from __future__ import annotations

import gc
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
        # (op, axes, dtype) -> calls, bytes, staged calls, seconds
        self.collectives: Dict[Tuple[str, str, str], Dict[str, float]] = {}
        self._host: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self._card: Optional[_Mailboxes] = None
        self._members: Dict[Tuple[str, ...], List[int]] = {}

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def traffic(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{op: {dtype: {calls, bytes, staged}}} of ``collectives``."""
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for (op, _, dtype), rec in self.collectives.items():
            acc = out.setdefault(op, {}).setdefault(dtype, {"calls": 0, "bytes": 0, "staged": 0})
            for k in acc:
                acc[k] += rec[k]
        return out

    @property
    def traffic_by_axis(self) -> Dict[str, Dict[str, float]]:
        """{axes: {calls, bytes, seconds}} of ``collectives``."""
        out: Dict[str, Dict[str, float]] = {}
        for (_, axes, _), rec in self.collectives.items():
            acc = out.setdefault(axes, {"calls": 0, "bytes": 0, "seconds": 0.0})
            for k in acc:
                acc[k] += rec[k]
        return out

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

    def _host_buffer(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host staging buffer of ``shape``, kept for the next collective:
        its pages are touched once, not at every call (a fresh buffer's page
        faults cost more than the copy)."""
        numel = math.prod(shape)
        buf = self._host.get((role, dtype))
        if buf is None or buf.numel() < numel:
            buf = self._host[(role, dtype)] = torch.empty(numel, dtype=dtype)
        return buf[:numel].view(tuple(shape))

    def _collective(self, name: str, axis: Axes, inp: torch.Tensor, out_shape, op, card) -> torch.Tensor:
        """``op(out, inp, group)`` into a fresh ``out``.  A CUDA operand on
        the card of a mesh with mailboxes runs ``card(inp)`` through them;
        under gloo it is otherwise staged through host memory (reused
        buffers) and the result copied back to a fresh tensor on its card."""
        t0 = time.perf_counter()
        inp = inp.contiguous()
        on_card = inp.is_cuda and self._card is not None and inp.device == self._card.device
        stage = inp.is_cuda and self.backend == "gloo" and not on_card
        if on_card:
            out = card(inp)
        elif stage:
            src = self._host_buffer("in", inp.shape, inp.dtype)
            src.copy_(inp)
            out = self._host_buffer("out", out_shape, inp.dtype)
            op(out, src, self.group(axis))
            out = out.to(inp.device)
        else:
            out = torch.empty(tuple(out_shape), dtype=inp.dtype, device=inp.device)
            op(out, inp, self.group(axis))
        key = (name, "+".join(self._axes(axis)), str(inp.dtype).replace("torch.", ""))
        rec = self.collectives.setdefault(key, {"calls": 0, "bytes": 0, "staged": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += inp.numel() * inp.element_size()
        rec["staged"] += int(stage)
        rec["seconds"] += time.perf_counter() - t0
        return out

    # -- the ranks' mailboxes on one card ------------------------------------

    def group_ranks(self, axis: Axes) -> List[int]:
        """The global ranks of this rank's group over ``axis``, in group
        order (the axes' coordinates row-major, as the collectives order
        their blocks)."""
        axes = self._axes(axis)
        if axes not in self._members:
            mine = self.coords
            self._members[axes] = [
                r for r in range(self.size)
                if all(Mesh(self.devices_shape, self.axis_names, r).coords[a] == mine[a]
                       for a in self.axis_names if a not in axes)
            ]
        return self._members[axes]

    def _card_exchange(self, axis: Axes, n: int, parts: int, dtype: torch.dtype, write, read) -> None:
        """Mailbox rounds over ``axis``: ``n`` elements a part, as many a round
        as ``parts`` rows fit the mailbox.  A round: ``write(own, off, k)``
        fills this rank's mailbox as ``parts`` rows of ``k``; the device is
        synchronised and the group meets, so every write has landed;
        ``read(peer, off, k)`` reads member ``j``'s rows as ``peer(j)``; the
        device is synchronised and the group meets again, so no mailbox is
        overwritten while a peer still reads it."""
        box, members = self._card, self.group_ranks(axis)
        group = _all_axes(self.axis_names).index(self._axes(axis))
        per = max(1, box.nbytes // (torch.empty((), dtype=dtype).element_size() * parts))
        for off in range(0, n, per):
            k = min(per, n - off)
            write(box.view(self.rank, dtype, parts * k).view(parts, k), off, k)
            box.meet(group, members)
            read(lambda j: box.view(members[j], dtype, parts * k).view(parts, k), off, k)
            box.meet(group, members)

    def _card_reduce(self, x: torch.Tensor, axis: Axes, op: str) -> torch.Tensor:
        flat, out = x.reshape(-1), torch.empty(x.numel(), dtype=x.dtype, device=x.device)
        M = len(self.group_ranks(axis))

        def read(peer, off, k):
            acc = out[off:off + k]
            acc.copy_(peer(0)[0])
            for j in range(1, M):  # in member order: the same result on every rank
                acc.add_(peer(j)[0]) if op == "sum" else torch.maximum(acc, peer(j)[0], out=acc)

        self._card_exchange(axis, flat.numel(), 1, x.dtype, lambda own, off, k: own[0].copy_(flat[off:off + k]), read)
        return out.view(x.shape)

    def _card_gather(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The members' ``x`` one after another along dim 0."""
        flat, n = x.reshape(-1), x.numel()
        M = len(self.group_ranks(axis))
        out = torch.empty((M, n), dtype=x.dtype, device=x.device)

        def read(peer, off, k):
            for j in range(M):
                out[j, off:off + k].copy_(peer(j)[0])

        self._card_exchange(axis, n, 1, x.dtype, lambda own, off, k: own[0].copy_(flat[off:off + k]), read)
        return out.view((M * x.shape[0],) + tuple(x.shape[1:]))

    def _card_scatter(self, x: torch.Tensor, axis: Axes, op: str) -> torch.Tensor:
        """Dim 0 of ``x`` in one block a member: ``op`` "sum" gives the sum
        of every member's block of this rank (``psum_scatter``), "swap" the
        members' blocks of this rank one after another (``all_to_all``)."""
        members = self.group_ranks(axis)
        M, me = len(members), members.index(self.rank)
        rows = x.reshape(M, -1)
        out = torch.empty((1 if op == "sum" else M, rows.shape[1]), dtype=x.dtype, device=x.device)

        def read(peer, off, k):
            if op == "sum":
                acc = out[0, off:off + k]
                acc.copy_(peer(0)[me])
                for j in range(1, M):
                    acc.add_(peer(j)[me])
            else:
                for j in range(M):
                    out[j, off:off + k].copy_(peer(j)[me])

        self._card_exchange(
            axis, rows.shape[1], M, x.dtype, lambda own, off, k: own.copy_(rows[:, off:off + k]), read
        )
        return out.view((x.shape[0] // M if op == "sum" else x.shape[0],) + tuple(x.shape[1:]))

    # -- collectives --------------------------------------------------------

    def psum(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x

        def op(out, src, group):
            out.copy_(src)
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)

        return self._collective("psum", axis, x, x.shape, op, lambda t: self._card_reduce(t, axis, "sum"))

    def pmax(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x

        def op(out, src, group):
            out.copy_(src)
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)

        return self._collective("pmax", axis, x, x.shape, op, lambda t: self._card_reduce(t, axis, "max"))

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.size > 1:
            dist.barrier(group=self.group(self.axis_names))

    def all_to_all(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split over {n} ranks")
        return self._collective(
            "all_to_all", axis, x, x.shape, lambda out, src, group: dist.all_to_all_single(out, src, group=group),
            lambda t: self._card_scatter(t, axis, "swap"),
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
            lambda t: self._card_scatter(t, axis, "sum"),
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
            lambda t: self._card_gather(t, axis),
        )
        return out.movedim(0, dim).contiguous()


class _Mailboxes:
    """One mailbox a rank on the card the ranks share (``nbytes`` of device
    memory each), every rank's mapped into every process through CUDA IPC,
    so a collective between ranks of one card is device copies and sums,
    not a trip through host memory and sockets.  Around each round of reads
    (``Mesh._card_exchange``) the group meets at a barrier in host shared
    memory: a rank synchronises its device, writes how many times it has
    met this group into its slot of a shared file, and waits until every
    member's slot has got as far (microseconds, where a gloo barrier takes
    milliseconds)."""

    def __init__(self, device, nbytes: int, groups: int):
        from torch.multiprocessing.reductions import reduce_tensor

        self.device, self.nbytes = torch.device(device), nbytes
        self.rank, world = dist.get_rank(), dist.get_world_size()
        own = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        # one share a peer: CUDA IPC counts a shared block's consumers by its shares
        shares = [None if r == self.rank else reduce_tensor(own) for r in range(world)]
        got: List[Any] = [None] * world
        dist.all_gather_object(got, shares)
        self.boxes = []
        for r, theirs in enumerate(got):
            fn, args = (None, None) if r == self.rank else theirs[self.rank]
            self.boxes.append(own if r == self.rank else fn(*args))
        self._share_slots(groups)

    def _share_slots(self, groups: int) -> None:
        """The barrier's slots: one int64 a rank a group, in a file rank 0
        makes, every rank maps and rank 0 then unlinks (the mappings stay)."""
        world = dist.get_world_size()
        path = [None]
        if self.rank == 0:
            fd, path[0] = tempfile.mkstemp(prefix="mailbox_slots_")
            os.write(fd, bytes(8 * groups * world))
            os.close(fd)
        dist.broadcast_object_list(path, src=0)
        self.met = torch.from_file(path[0], shared=True, size=groups * world, dtype=torch.int64).numpy()
        self.met = self.met.reshape(groups, world)
        self.times = [0] * groups
        dist.barrier()
        if self.rank == 0:
            os.unlink(path[0])

    def view(self, rank: int, dtype: torch.dtype, numel: int) -> torch.Tensor:
        return self.boxes[rank].view(dtype)[:numel]

    def _sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def meet(self, group: int, members: List[int], timeout_s: float = 600.0) -> None:
        """Every member of ``group`` (its index among the mesh's groups) has
        finished its device work up to here."""
        self._sync()
        self.times[group] += 1
        self.met[group, self.rank] = self.times[group]
        deadline = time.monotonic() + timeout_s
        spins = 0
        while (self.met[group, members] < self.times[group]).any():
            spins += 1
            if spins > SPINS_BEFORE_YIELD:
                os.sched_yield()  # a core to a rank that has yet to get here
            if time.monotonic() > deadline:
                raise TimeoutError(f"mailbox barrier: ranks {members} not all arrived in {timeout_s} s")


MAILBOX_BYTES = 64 << 20  # a rank's mailbox on a shared card
SPINS_BEFORE_YIELD = 1000  # barrier polls before a waiting rank yields its core


def _card_uuid() -> Optional[str]:
    """The UUID of this rank's card: its current CUDA device, where it has
    initialised CUDA (``torch.cuda.set_device``); None for a rank on the
    CPU."""
    if not torch.cuda.is_initialized():
        return None
    return str(torch.cuda.get_device_properties(torch.cuda.current_device()).uuid)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """This rank's view of a mesh over the whole initialised world.  Every
    rank must call it with the same arguments, in the same order as its
    other ``make_mesh`` calls: it makes one process group per tuple of axes
    (in mesh order) and per coordinate of the axes outside it, collectively.
    A shape that does not fill the world is refused.  Where every rank's
    card is the same one, the mesh gets mailboxes there: its collectives of
    CUDA operands on that card then run on it (``_Mailboxes``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks, the world has {world}")
    layout = Mesh(shape, axis_names)
    names = layout.axis_names
    groups: Dict[Tuple[str, ...], Any] = {}
    for axes in _all_axes(names):
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
    mesh = Mesh(shape, names, rank, groups, dist.get_backend())
    cards: List[Optional[str]] = [None] * world
    dist.all_gather_object(cards, _card_uuid())
    if world > 1 and cards[0] is not None and len(set(cards)) == 1:
        mesh._card = _Mailboxes(torch.device("cuda", torch.cuda.current_device()), MAILBOX_BYTES, len(_all_axes(names)))
    return mesh


def _all_axes(names: Sequence[str]) -> List[Tuple[str, ...]]:
    """Every tuple of a mesh's axes, in mesh order: the mesh's groups."""
    return [axes for k in range(1, len(names) + 1) for axes in itertools.combinations(names, k)]


def make_local_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A ("data", "model") mesh over the world (tests, the card's rank
    phases); ``data`` defaults to ``world // model``."""
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
            gc.collect()  # a mesh in a reference cycle still maps the others' mailboxes
            dist.barrier()  # every rank has let go of them before any exits
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
