"""Programmed-crossbar artifact store (counterpart of the
``save_programmed`` / ``restore_programmed`` half of
``repro.checkpoint.checkpoint``).

The store is the interchange format between the two packages: one ``.npz``
per artifact (every non-None array leaf, exact dtypes) plus ``manifest.json``
holding the name-keyed static data (``CrossbarSpec``, ``ADCConfig``, the
kernel-path flag, reports, the programming ``DeviceConfig``, the service
clock, the ``LayerPlan`` as its field dict).  It is read and written with
numpy and json alone; a chip programmed and saved by either package restores
bit-for-bit in the other, plans included.

Layout: ``<dir>/programmed/`` (unslotted), or the double-buffered
``<dir>/programmed.slotA`` / ``.slotB`` with the ``<dir>/programmed.ACTIVE``
pointer naming the live slot.
"""
from __future__ import annotations

import dataclasses as dc
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.core.planner import LayerPlan
from repro_torch.device.models import DeviceConfig
from repro_torch.device.programmed import (
    ARTIFACT_ARRAY_FIELDS,
    ProgrammedLinear,
    ProgrammedModel,
)

PROGRAMMED_SLOTS = ("A", "B")

# the report kinds a manifest may carry, with their fields (the reference's
# ProgramReport and RepairReport); the port keeps reports as their JSON
_AUX_FIELDS = {
    "ProgramReport": (
        "iterations", "converged_frac", "mean_abs_error", "max_abs_error", "stuck_frac",
        "per_iter_mean_error",
    ),
    "RepairReport": ("budget", "n_repaired", "repaired_cols", "salience_before", "salience_after"),
}


def _decode_aux(obj):
    """Check an encoded report / repair value and return it as stored: None,
    a ``tuple`` of values, or a report of a known kind with exactly its
    fields.  Raises ``KeyError`` / ``TypeError`` / ``ValueError`` where the
    reference's decode would."""
    if obj is None:
        return None
    kind = obj["__kind__"]
    if kind == "tuple":
        return tuple(_decode_aux(o) for o in obj["items"])
    if kind not in _AUX_FIELDS:
        raise ValueError(f"unknown artifact aux kind: {kind!r}")
    got = sorted(k for k in obj if k != "__kind__")
    if got != sorted(_AUX_FIELDS[kind]):
        raise TypeError(f"{kind} fields {got} != {sorted(_AUX_FIELDS[kind])}")
    return obj


def _decode_plan(obj: dict) -> LayerPlan:
    """Rebuild a ``core.planner.LayerPlan`` from its manifest dict (an
    unknown datapath or ADC mode raises ``ValueError``)."""
    return LayerPlan(**obj)


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
            "report": art.report,
            "repair": art.repair,
            "sharding": None,
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


def restore_programmed(directory: str, device="cuda", slot: Optional[str] = None) -> ProgrammedModel:
    """Load a ``save_programmed`` store into a ``ProgrammedModel`` on
    ``device``.  The artifact tree is rebuilt as nested dicts from the
    canonical names; no parameter tree is needed.

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
        with np.load(os.path.join(d, info["file"])) as z:
            arrays = {k: torch.from_numpy(np.array(z[k])).to(device) for k in z.files}
        art = ProgrammedLinear(
            w_codes=arrays["w_codes"],
            g_eff=arrays.get("g_eff"),
            w_colsum=arrays["w_colsum"],
            w_scale=arrays["w_scale"],
            x_scale=arrays.get("x_scale"),
            spec=CrossbarSpec(**info["spec"]),
            adc_cfg=(ADCConfig(**info["adc_cfg"]) if info["adc_cfg"] is not None else None),
            fast=bool(info["fast"]),
            report=info.get("report"),
            g_spare=arrays.get("g_spare"),
            out_gather=arrays.get("out_gather"),
            repair=info.get("repair"),
            comp_scale=arrays.get("comp_scale"),
            device=(DeviceConfig(**info["device"]) if info.get("device") is not None else None),
            t_service_s=float(info.get("t_service_s", 0.0)),
            plan=(_decode_plan(info["plan"]) if info.get("plan") is not None else None),
        )
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = art
    return ProgrammedModel(tree)
