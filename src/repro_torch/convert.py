"""Carry parameters and artifacts across from numpy (port-only module).

The JAX package's params pytree, pulled to the host as nested dicts of numpy
arrays, becomes the port's params — same names, so programmed artifacts bind
unchanged.  bfloat16 arrives as an ``ml_dtypes`` numpy dtype that
``torch.from_numpy`` refuses; it is widened exactly through its bit pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device.programmed import ARTIFACT_ARRAY_FIELDS, ProgrammedLinear


def tensor_from_numpy(arr, device="cuda", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        f32 = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        t = torch.from_numpy(f32).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def params_from_numpy(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``
    (floating leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {str(k): params_from_numpy(v, device, dtype) for k, v in tree.items()}
    floating = np.asarray(tree).dtype.kind == "f" or np.asarray(tree).dtype.name == "bfloat16"
    return tensor_from_numpy(tree, device, dtype if floating else None)


def artifacts_from_numpy(arrays: dict, template: ProgrammedLinear, device="cuda") -> ProgrammedLinear:
    """One artifact from ``{field: numpy array}`` plus a template's static
    data (fields absent from ``arrays`` become None)."""
    fields = {
        f: (tensor_from_numpy(arrays[f], device) if arrays.get(f) is not None else None)
        for f in ARTIFACT_ARRAY_FIELDS
    }
    return dataclasses.replace(template, **fields)
