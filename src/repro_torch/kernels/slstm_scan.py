"""Fused sLSTM recurrence: CUDA kernel + plain version.

``slstm_scan_cuda`` is the counterpart of ``repro.kernels.slstm_scan.
slstm_scan_pallas`` and replaces the TPU kernel ``_kernel`` with
``slstm_scan_kernel`` of ``csrc/slstm_scan.cu`` (the source holds the design
note).  One launch computes the whole (B, S) scan: one block per (batch row,
head), the sequence loop inside the block, float32 state and arithmetic.
Bound by the bytes of the four recurrent matrices at decode and by float32
operations in prefill; the S sequential steps, each streaming the head's
matrices from L2 into one SM, keep v1 far from either bound.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version ``slstm_scan_plain`` (the
reference's per-step update as a Python loop).  Each launch adds one to
``LAUNCHES["slstm_scan"]``; each plain-version call adds one to
``PLAIN_CALLS["slstm_scan"]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

IGATE_CLIP = 5.0
MAX_DH = 4 * 512  # MAX_COLS * MAX_THREADS in the kernel source

LAUNCHES = {"slstm_scan": 0}
PLAIN_CALLS = {"slstm_scan": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def slstm_scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0):
    """Plain PyTorch version: the reference's ``step`` (``models/xlstm.py``
    ``slstm_block``) as a loop over S, all in float32; ``h_all`` is rounded
    once to ``pre.dtype``."""
    rz, ri, rf, ro = (r.to(torch.float32) for r in (r_z, r_i, r_f, r_o))
    c, n, h = c0.to(torch.float32), n0.to(torch.float32), h0.to(torch.float32)
    hs = []
    for t in range(pre.shape[1]):
        pf = pre[:, t].to(torch.float32)  # (B, 4, H, dh)
        hz = torch.einsum("bhd,hde->bhe", h, rz)
        hi = torch.einsum("bhd,hde->bhe", h, ri)
        hf = torch.einsum("bhd,hde->bhe", h, rf)
        ho = torch.einsum("bhd,hde->bhe", h, ro)
        z = torch.tanh(pf[:, 0] + hz)
        i = torch.exp(torch.clamp(pf[:, 1] + hi, max=IGATE_CLIP))
        f = torch.sigmoid(pf[:, 2] + hf)
        o = torch.sigmoid(pf[:, 3] + ho)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1.0)
        hs.append(h)
    return torch.stack(hs, dim=1).to(pre.dtype), c, n, h


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load_library().slstm_scan
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(t: torch.Tensor, what: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} lies on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def slstm_scan_cuda(
    pre: torch.Tensor,
    r_z: torch.Tensor,
    r_i: torch.Tensor,
    r_f: torch.Tensor,
    r_o: torch.Tensor,
    c0: torch.Tensor,
    n0: torch.Tensor,
    h0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """pre: (B, S, 4, H, dh) gate pre-activations (z, i, f, o); r_*: (H, dh,
    dh); c0 / n0 / h0: (B, H, dh) float32.  Returns ``(h_all (B, S, H, dh) in
    pre.dtype, c1, n1, h1)`` with the final state in float32.  The outputs
    are new tensors; the initial state is only read."""
    if pre.device.type != "cuda":
        PLAIN_CALLS["slstm_scan"] += 1
        return slstm_scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0)
    if pre.ndim != 5 or pre.shape[2] != 4:
        raise ValueError(f"pre must be (B, S, 4, H, dh), got {tuple(pre.shape)}")
    B, S, _, H, dh = pre.shape
    if B < 1 or S < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"the kernel takes B, S >= 1 and 1 <= dh <= {MAX_DH}, got {tuple(pre.shape)}")
    if pre.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {pre.dtype}")
    dev = pre.device
    _check(pre, "pre", pre.shape, pre.dtype, dev)  # contiguity
    for name, r in (("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o)):
        _check(r, name, (H, dh, dh), pre.dtype, dev)
    for name, s in (("c0", c0), ("n0", n0), ("h0", h0)):
        _check(s, name, (B, H, dh), torch.float32, dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"operands lie on {dev} but the current CUDA device is "
            f"{torch.cuda.current_device()}: enter torch.cuda.device(...) first"
        )
    h_all = torch.empty((B, S, H, dh), dtype=pre.dtype, device=dev)
    c1, n1, h1 = (torch.empty((B, H, dh), dtype=torch.float32, device=dev) for _ in range(3))
    err = _kernel_fn()(
        *(t.data_ptr() for t in (pre, r_z, r_i, r_f, r_o, c0, n0, h0, h_all, c1, n1, h1)),
        B, S, H, dh, int(pre.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA kernel slstm_scan was refused at launch: cudaError {err}")
    LAUNCHES["slstm_scan"] += 1
    return h_all, c1, n1, h1
