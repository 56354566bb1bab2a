"""Carry parameters, optimizer states and artifacts across from numpy, and
back (port-only module).

The JAX package's params pytree (or an optimizer state), pulled to the host
as nested dicts of numpy arrays, becomes the port's params — same names, so
programmed artifacts bind unchanged.  bfloat16 arrives as an ``ml_dtypes``
numpy dtype that ``torch.from_numpy`` refuses; it is widened exactly through
its bit pattern.  ``tree_to_numpy`` goes the other way, a bfloat16 tensor as
its 16-bit pattern (``uint16``), since numpy has no bfloat16 of its own.

An MoE model's expert banks — ``wi`` / ``wg`` / ``wo`` leaves of shape (L, E,
K, N), and the artifacts programmed from them — can be carried as one
``models.moe.ExpertShare``'s slice of the expert axis, so that a device
receives only the experts it holds: the rank's slice under the EP layout
(``moe.BANK_SPEC``), cut by ``device.programmed.local_slice`` /
``local_fields`` as any rank-local artifact is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device.programmed import ARTIFACT_ARRAY_FIELDS, ProgrammedLinear, local_fields, local_slice
from repro_torch.models.moe import BANK_SPEC, ExpertShare
from repro_torch.tree import tree_map

_BANKS = ("wi", "wg", "wo")


def tensor_from_numpy(arr, device="cuda", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        f32 = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        t = torch.from_numpy(f32).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor on the host as numpy (later in-place updates of
    the tensor do not reach it); bfloat16 as its bits in ``uint16``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> nested dicts of numpy arrays
    (``tensor_to_numpy`` leaf by leaf)."""
    return tree_map(tensor_to_numpy, tree)


def _require_split(n_experts: int, share: ExpertShare) -> None:
    # local_slice would keep a bank whole where the experts do not divide
    if n_experts % share.ranks:
        raise ValueError(f"{n_experts} experts do not split over {share.ranks} ranks")


def params_from_numpy(
    tree: Any, device="cuda", dtype: Optional[torch.dtype] = None, share: Optional[ExpertShare] = None,
) -> Any:
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``
    (floating leaves cast to ``dtype`` when given).  With ``share`` every
    expert bank keeps only the share's experts (sliced before the copy)."""

    def carry(node, name: str):
        if isinstance(node, dict):
            return {str(k): carry(v, str(k)) for k, v in node.items()}
        arr = np.asarray(node)
        if share is not None and name in _BANKS and arr.ndim == 4:
            _require_split(arr.shape[1], share)
            arr = local_slice(arr, BANK_SPEC, *share.layout())
        floating = arr.dtype.kind == "f" or arr.dtype.name == "bfloat16"
        return tensor_from_numpy(arr, device, dtype if floating else None)

    return carry(tree, "")


def artifacts_from_numpy(
    arrays: dict, template: ProgrammedLinear, device="cuda", share: Optional[ExpertShare] = None,
) -> ProgrammedLinear:
    """One artifact from ``{field: numpy array}`` plus a template's static
    data (fields absent from ``arrays`` become None).  With ``share`` an
    expert bank's artifact (a 4-D ``w_codes``, every array field led by its
    (L, E) axes) keeps the share's experts, its per-layer tuples of
    per-expert reports likewise."""
    arrays = {f: np.asarray(arrays[f]) for f in ARTIFACT_ARRAY_FIELDS if arrays.get(f) is not None}
    aux = {}
    if share is not None and arrays["w_codes"].ndim == 4:
        n_experts = arrays["w_codes"].shape[1]
        _require_split(n_experts, share)
        arrays = local_fields(arrays, BANK_SPEC, *share.layout())
        n = n_experts // share.ranks
        aux = {
            k: tuple(per_layer[share.rank * n:(share.rank + 1) * n] for per_layer in getattr(template, k))
            for k in ("report", "repair") if getattr(template, k) is not None
        }
    fields = {f: (tensor_from_numpy(arrays[f], device) if f in arrays else None) for f in ARTIFACT_ARRAY_FIELDS}
    return dataclasses.replace(template, **fields, **aux)
