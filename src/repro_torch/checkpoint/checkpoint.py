"""Weight checkpoints and the programmed-crossbar artifact store
(counterpart of ``repro.checkpoint.checkpoint``).

Weight checkpoints (``save_checkpoint`` / ``restore_checkpoint`` /
``CheckpointManager``), in the reference's layout: ``<dir>/step_<n>/``
holds one ``.npy`` a leaf, named by its ``a__b__c`` path, and
``manifest.json`` (step, metadata, each leaf's file, shape and dtype).  A
write goes to ``step_<n>.tmp`` and is renamed into place, so a killed job
never leaves a half checkpoint that restore would pick up.  A bfloat16 leaf
is written as the reference writes one (numpy has no bfloat16: a 2-byte
void ``'<V2'`` array of the raw words, manifest dtype ``bfloat16``) and is
restored **by the manifest's dtype**, its words viewed as
``torch.bfloat16``; so checkpoints interchange both ways.

The store is the interchange format between the two packages: one ``.npz``
per artifact (every non-None array leaf, exact dtypes) plus ``manifest.json``
holding the name-keyed static data (``CrossbarSpec``, ``ADCConfig``, the
kernel-path flag, reports, the programming ``DeviceConfig``, the service
clock, the ``LayerPlan`` as its field dict).  It is read and written with
numpy and json alone; a chip programmed and saved by either package restores
bit-for-bit in the other, plans included.

A placed chip (``device.programmed.shard_artifacts``) records each
artifact's placement in the manifest's ``sharding`` entry, in the
reference's encoding (``{field: [entry, ...]}``, a tuple entry as a list);
a restore without a mesh keeps the record on the artifact, so a store passes
through and is written back with it.  ``restore_programmed(mesh=)`` gives
the calling rank its slice by the recorded spec (``local_fields``), reading
only the slice's bytes of each ``.npz`` member, one artifact at a time.

Layout: ``<dir>/programmed/`` (unslotted), or the double-buffered
``<dir>/programmed.slotA`` / ``.slotB`` with the ``<dir>/programmed.ACTIVE``
pointer naming the live slot (``swap_active`` commits a slot).
"""
from __future__ import annotations

import dataclasses as dc
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.core.planner import LayerPlan
from repro_torch.device.models import DeviceConfig
from repro_torch.device.program import ProgramReport
from repro_torch.device.programmed import (
    ARTIFACT_ARRAY_FIELDS,
    ProgrammedLinear,
    ProgrammedModel,
    local_fields,
)
from repro_torch.device.repair import RepairReport
from repro_torch.convert import tensor_to_numpy
from repro_torch.tree import flatten, unflatten

PROGRAMMED_SLOTS = ("A", "B")

# the report kinds a manifest may carry, by the name it records
_AUX_KINDS = {"ProgramReport": ProgramReport, "RepairReport": RepairReport}


def _encode_aux(obj):
    """JSON-encode a report / repair value: None, a report dataclass, or the
    (nested) per-slab tuple of a stacked artifact, in the reference's form."""
    if obj is None:
        return None
    if isinstance(obj, tuple):
        return {"__kind__": "tuple", "items": [_encode_aux(o) for o in obj]}
    if dc.is_dataclass(obj) and type(obj).__name__ in _AUX_KINDS:
        return {"__kind__": type(obj).__name__, **dc.asdict(obj)}
    raise TypeError(f"unserializable artifact aux: {type(obj)!r}")


def _decode_aux(obj):
    """Decode a report / repair value: None, a ``tuple`` of values, or a
    ``ProgramReport`` / ``RepairReport``.  An unknown kind or a wrong field
    set raises ``KeyError`` / ``TypeError`` / ``ValueError``, as the
    reference's decode does."""
    if obj is None:
        return None
    kind = obj["__kind__"]
    if kind == "tuple":
        return tuple(_decode_aux(o) for o in obj["items"])
    if kind not in _AUX_KINDS:
        raise ValueError(f"unknown artifact aux kind: {kind!r}")
    fields = {k: v for k, v in obj.items() if k != "__kind__"}
    for k in ("per_iter_mean_error", "repaired_cols"):
        if k in fields:
            fields[k] = tuple(fields[k])
    return _AUX_KINDS[kind](**fields)


def _decode_plan(obj: dict) -> LayerPlan:
    """Rebuild a ``core.planner.LayerPlan`` from its manifest dict (an
    unknown datapath or ADC mode raises ``ValueError``)."""
    return LayerPlan(**obj)


def _encode_pspec(spec) -> list:
    """JSON-encode a spec's entries (None / str / tuple of str)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _decode_pspec(entries) -> Tuple[Any, ...]:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _artifact_shardings(art: ProgrammedLinear) -> Optional[Dict[str, list]]:
    """The manifest's ``sharding`` entry: {field: encoded spec} of the
    artifact's placement record, None for an unplaced chip."""
    if not art.sharding:
        return None
    return {f: _encode_pspec(spec) for f, spec in art.sharding.items()}


def _npz_members(path: str) -> Dict[str, np.ndarray]:
    """{member: array} of a store's ``.npz``.  ``np.savez`` stores members
    uncompressed, so each is opened as a read-only memory map at its
    ``.npy`` payload (the zip local header, then the array header): slicing
    it reads only the slice's bytes.  A compressed member is read whole."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as m:
                    out[name] = np.lib.format.read_array(m)
                continue
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: bad zip local header for {info.filename}")
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            out[name] = np.memmap(path, dtype=dtype, mode="r", shape=shape, offset=f.tell(), order="F" if fortran else "C")
    return out


def _active_pointer(directory: str) -> str:
    return os.path.join(directory, "programmed.ACTIVE")


def _programmed_dir(directory: str, slot: Optional[str] = None) -> str:
    if slot is None:
        return os.path.join(directory, "programmed")
    if slot not in PROGRAMMED_SLOTS:
        raise ValueError(f"slot must be one of {PROGRAMMED_SLOTS}, got {slot!r}")
    return os.path.join(directory, f"programmed.slot{slot}")


def active_slot(directory: str) -> Optional[str]:
    """The slot the ACTIVE pointer names, or None (unslotted store)."""
    try:
        with open(_active_pointer(directory)) as f:
            slot = f.read().strip()
    except FileNotFoundError:
        return None
    if slot not in PROGRAMMED_SLOTS:
        raise ValueError(f"corrupt ACTIVE pointer: {slot!r}")
    return slot


def swap_active(directory: str, slot: str) -> str:
    """Point the store at ``slot`` (the hot-swap commit point): the pointer
    is written to a temporary file and moved into place with
    ``os.replace``, so a reader sees the old slot or the new one, never a
    torn pointer.  A slot without a manifest is refused."""
    if slot not in PROGRAMMED_SLOTS:
        raise ValueError(f"slot must be one of {PROGRAMMED_SLOTS}, got {slot!r}")
    if not os.path.isfile(os.path.join(_programmed_dir(directory, slot), "manifest.json")):
        raise FileNotFoundError(
            f"slot {slot} has no programmed store in {directory} — "
            "save_programmed(..., slot=...) first"
        )
    ptr = _active_pointer(directory)
    tmp = ptr + ".tmp"
    with open(tmp, "w") as f:
        f.write(slot)
    os.replace(tmp, ptr)
    return slot


def save_programmed(
    directory: str,
    prog: ProgrammedModel,
    metadata: Optional[dict] = None,
    slot: Optional[str] = None,
) -> str:
    """Atomically persist a ``ProgrammedModel`` under ``<dir>/programmed/``
    (or the named double-buffer slot).  Written to ``.tmp`` and swapped in by
    rename, the previous store kept aside as ``.old`` until the swap is done,
    so a crash never leaves the directory without a complete chip."""
    os.makedirs(directory, exist_ok=True)
    final = _programmed_dir(directory, slot)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"schema": 1, "metadata": metadata or {}, "artifacts": {}}
    for name, art in prog.by_name.items():
        # injective escaping ("_" first, then "/"): "a/b" -> "a__b" but
        # "a__b" -> "a_u_ub", so distinct names never collide onto one file
        fname = name.replace("_", "_u").replace("/", "__") + ".npz"
        arrays = {
            f: getattr(art, f).detach().cpu().numpy()
            for f in ARTIFACT_ARRAY_FIELDS
            if getattr(art, f) is not None
        }
        np.savez(os.path.join(tmp, fname), **arrays)
        manifest["artifacts"][name] = {
            "file": fname,
            "spec": dc.asdict(art.spec),
            "adc_cfg": dc.asdict(art.adc_cfg) if art.adc_cfg is not None else None,
            "fast": bool(art.fast),
            "report": _encode_aux(art.report),
            "repair": _encode_aux(art.repair),
            "sharding": _artifact_shardings(art),
            "device": (dc.asdict(art.device) if art.device is not None else None),
            "t_service_s": float(art.t_service_s),
            "plan": (dc.asdict(art.plan) if art.plan is not None else None),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)
    return final


def restore_programmed(
    directory: str, device="cuda", slot: Optional[str] = None, mesh=None, specs: Optional[Dict[str, Any]] = None,
) -> ProgrammedModel:
    """Load a ``save_programmed`` store into a ``ProgrammedModel`` on
    ``device``.  The artifact tree is rebuilt as nested dicts from the
    canonical names; no parameter tree is needed.

    ``mesh`` (a ``launch.mesh.Mesh`` with a rank): each artifact is this
    rank's slice (``device.programmed.local_fields``) by the weight spec its
    record holds (the record's ``w_codes`` entry), or by ``specs[name]``
    where ``specs`` names it: the same chip laid out anew, as a deployment
    that serves it in another layout does.  Entries whose axes the mesh
    lacks or whose dims they do not divide are replicated
    (``dividing_pspec``).  A slice carries no placement record; without a
    mesh every artifact keeps the record the store holds.

    ``slot``: read a specific double-buffer slot.  Default (None) follows the
    ``ACTIVE`` pointer when one exists and falls back to the unslotted layout
    otherwise.  A crash inside ``save_programmed``'s two-rename swap can leave
    the store under ``.tmp`` or only under ``.old``; those are tried in
    completeness order.  Manifests written before the lifecycle and planner
    fields existed (no ``device`` / ``t_service_s`` / ``plan`` keys) decode.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("restore_programmed(device='cuda') needs a CUDA device; pass device='cpu'")
    if slot is None:
        slot = active_slot(directory)
    if slot is not None:
        base = _programmed_dir(directory, slot)
        candidates = [base, base + ".tmp", base + ".old"]
    else:
        base = os.path.join(directory, "programmed")
        candidates = [base, base + ".tmp", base + ".old", directory]
    d = next(
        (c for c in candidates if os.path.isfile(os.path.join(c, "manifest.json"))),
        None,
    )
    if d is None:
        raise FileNotFoundError(f"no programmed-artifact store in {directory}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for name, info in manifest["artifacts"].items():
        record = {f: _decode_pspec(e) for f, e in (info.get("sharding") or {}).items()}
        arrays = _npz_members(os.path.join(d, info["file"]))
        if mesh is not None:
            wspec = specs[name] if specs is not None and name in specs else record.get("w_codes")
            if wspec is not None:
                arrays = local_fields(arrays, wspec, mesh.shape, mesh.coords)
            record = {}
        arrays = {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}
        art = ProgrammedLinear(
            w_codes=arrays["w_codes"],
            g_eff=arrays.get("g_eff"),
            w_colsum=arrays["w_colsum"],
            w_scale=arrays["w_scale"],
            x_scale=arrays.get("x_scale"),
            spec=CrossbarSpec(**info["spec"]),
            adc_cfg=(ADCConfig(**info["adc_cfg"]) if info["adc_cfg"] is not None else None),
            fast=bool(info["fast"]),
            report=_decode_aux(info.get("report")),
            g_spare=arrays.get("g_spare"),
            out_gather=arrays.get("out_gather"),
            repair=_decode_aux(info.get("repair")),
            comp_scale=arrays.get("comp_scale"),
            device=(DeviceConfig(**info["device"]) if info.get("device") is not None else None),
            t_service_s=float(info.get("t_service_s", 0.0)),
            plan=(_decode_plan(info["plan"]) if info.get("plan") is not None else None),
            sharding=(record or None),
        )
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = art
    return ProgrammedModel(tree)


# ---------------------------------------------------------------------------
# Weight checkpoints (params, optimizer state)
# ---------------------------------------------------------------------------

_BF16_DESCR = "<V2"  # the descr numpy writes for the reference's bfloat16 leaves


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(host copy as numpy, manifest dtype) of a tensor or numpy leaf; a
    bfloat16 leaf as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf), str(leaf.dtype).replace("torch.", "")
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape}
        )
        f.write(np.ascontiguousarray(arr).tobytes())


def _write_checkpoint(directory: str, step: int, flat: Dict[str, Tuple[np.ndarray, str]], metadata) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, (arr, dtype) in flat.items():
        fname = key.replace("/", "__") + ".npy"
        _write_npy(os.path.join(tmp, fname), arr, dtype)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, metadata: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint write of a tree of tensors (or numpy
    arrays)."""
    return _write_checkpoint(
        directory, step, {k: _host_leaf(v) for k, v in flatten(tree).items()}, metadata
    )


def _checkpoint_steps(directory: str):
    return [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _checkpoint_steps(directory)
    return max(steps) if steps else None


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(directory: str, step: Optional[int], tree_like):
    """(tree, step, metadata) of checkpoint ``step`` (None: the newest).

    ``tree_like`` gives the structure; each leaf is restored in the dtype
    its manifest records, onto the device of ``tree_like``'s leaf where that
    is a tensor, else the CPU (the counterpart of the reference's elastic
    re-placement)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {
        key: _read_leaf(os.path.join(d, info["file"]), info["dtype"])
        for key, info in manifest["leaves"].items()
    }
    targets = flatten(tree_like)
    for key, t in flat.items():
        if isinstance(targets.get(key), torch.Tensor):
            flat[key] = t.to(targets[key].device)
    return unflatten(tree_like, flat), manifest["step"], manifest["metadata"]


class CheckpointManager:
    """Asynchronous checkpoints: ``save_async`` snapshots every leaf to host
    memory (a copy, so that later in-place updates cannot reach it), then
    writes on a background thread; ``keep`` bounds how many are kept.
    ``snapshot_seconds`` / ``write_seconds`` time the last save's two
    halves."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()
        self.snapshot_seconds: Optional[float] = None
        self.write_seconds: Optional[float] = None

    def save_async(self, step: int, tree, metadata: Optional[dict] = None):
        """Snapshot to host memory now; write files in the background."""
        self.wait()
        t0 = time.perf_counter()
        host = {key: _host_leaf(leaf) for key, leaf in flatten(tree).items()}
        self.snapshot_seconds = time.perf_counter() - t0
        self.write_async(step, host, metadata)

    def write_async(self, step: int, host: Dict[str, Tuple[np.ndarray, str]], metadata: Optional[dict] = None):
        """Write a snapshot taken already ({path: ``_host_leaf``}) in the
        background."""
        self.wait()
        self._pending = self._pool.submit(self._write, step, host, metadata)

    def _write(self, step, host, metadata):
        t0 = time.perf_counter()
        _write_checkpoint(self.directory, step, host, metadata)
        self._gc()
        self.write_seconds = time.perf_counter() - t0

    def wait(self):
        with self._lock:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                pending.result()

    def _gc(self):
        for s in sorted(_checkpoint_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    def restore_latest(self, tree_like):
        return restore_checkpoint(self.directory, None, tree_like)
