"""Fused sLSTM recurrence: CUDA kernel + plain version.

``slstm_scan_cuda`` is the counterpart of ``repro.kernels.slstm_scan.
slstm_scan_pallas`` and replaces the TPU kernel ``_kernel`` with
``slstm_cluster_kernel`` of ``csrc/slstm_scan.cu`` (the source holds the
design note).  One launch computes the whole (B, S) scan, float32 state and
arithmetic.  Each head's output columns are split over the CTAs of a
thread-block cluster; each CTA keeps its slice of the four recurrent matrices
in shared memory across the steps (S > 1; read straight from global memory at
S = 1) and the new h of every step goes to all CTAs of the cluster through
distributed shared memory.  Bound by the bytes of the recurrent matrices at
decode and by float32 operations in prefill; the S sequential steps, each
ending at a cluster barrier, are what the bound does not see.

``plan_scan`` makes the launch plan (cluster size, columns and batch rows a
CTA takes, resident rows of R, threads, dynamic shared bytes) from the shapes
and the largest cluster the card schedules; it is plain Python, so the tiling
is tested on the CPU, and the C entry checks it again.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version ``slstm_scan_plain`` (the
reference's per-step update as a Python loop).  Each launch adds one to
``LAUNCHES["slstm_scan"]``; each plain-version call adds one to
``PLAIN_CALLS["slstm_scan"]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

IGATE_CLIP = 5.0
MAX_DH = 2048  # SCAN_MAX_DH in the kernel source
SMEM_LIMIT = 232448  # shared bytes a block may use on sm_90 (227 KB)
MAX_WARPS = 16  # threads = 32 * min(MAX_WARPS, output units of a CTA)
MAX_ITEMS = 2  # (row, column) cells a thread owns: rows * cols <= MAX_ITEMS * threads
MAX_ROWS = 8  # batch rows a CTA takes; more go to further clusters
ROW_SLOTS = (1, 2, 4, 8)  # compiled batch-row counts
CLUSTER_SIZES = (16, 8, 4, 2)  # tried in turn on the card

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


class ScanPlan(NamedTuple):
    """How one call is cut: grid (col_blocks, H, batch_groups), the column
    blocks of one (head, batch group) forming a cluster where S > 1."""

    cluster: int  # CTAs of a cluster: col_blocks where S > 1 and there are several, else 1
    col_blocks: int  # CTAs a head's output columns are split over
    cols: int  # output columns a CTA takes, of all four gates (a multiple of 16 bytes)
    rows: int  # batch rows a CTA takes
    row_slots: int  # the compiled row count >= rows (the kernel's SLOTS)
    batch_groups: int  # clusters along the batch axis
    resident: int  # input rows of the CTA's R slice held in shared memory (0 at S = 1)
    threads: int
    unit_lanes: int  # 16-byte units of one input row a warp reads side by side (UL)
    smem: int  # dynamic shared bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan_scan(B: int, S: int, H: int, dh: int, esize: int, max_cluster: int = 16) -> ScanPlan:
    """The launch plan of ``slstm_cluster_kernel`` for ``pre`` of shape
    (B, S, 4, H, dh) with ``esize``-byte values (4 float32, 2 bf16), where the
    card schedules clusters of up to ``max_cluster`` CTAs.  Columns go in
    16-byte units over at most ``max_cluster`` CTAs; batch rows in balanced
    groups of at most ``MAX_ROWS``; R's rows are resident as far as shared
    memory holds them (all of them, or a multiple of 32)."""
    if B < 1 or S < 1 or H < 1 or not 1 <= dh <= MAX_DH or esize not in (2, 4):
        raise ValueError(f"no plan for B={B} S={S} H={H} dh={dh} esize={esize}")
    vec = 16 // esize
    cols = _cdiv(_cdiv(dh, max_cluster), vec) * vec
    col_blocks = _cdiv(dh, cols)
    units = 4 * cols // vec
    threads = 32 * min(MAX_WARPS, units)
    # a warp reads UL adjacent units of one gate (UL x 16 contiguous bytes of
    # a row) for 32 / UL rows at a time; UL warp slots split a group's rows,
    # so each slot's partial gate sums are added in the gate step
    unit_lanes = next(k for k in (4, 2, 1) if (units // 4) % k == 0)
    row_cap = min(MAX_ROWS, MAX_ITEMS * threads // cols)
    if row_cap < 1:
        raise ValueError(f"dh={dh} needs clusters of more than {max_cluster} CTAs")
    batch_groups = _cdiv(B, row_cap)
    rows = _cdiv(B, batch_groups)
    slots = next(s for s in ROW_SLOTS if s >= rows)
    # two h buffers, the slots' partial gate sums, the CTA's block of h
    fixed = 4 * slots * (2 * col_blocks * cols + (4 * unit_lanes + 1) * cols)
    per_row = 16 * units
    resident = 0
    if S > 1:
        fit = (SMEM_LIMIT - fixed) // per_row
        resident = dh if fit >= dh else fit // 32 * 32
    return ScanPlan(
        cluster=col_blocks if S > 1 and col_blocks > 1 else 1, col_blocks=col_blocks, cols=cols,
        rows=rows, row_slots=slots, batch_groups=batch_groups, resident=resident, threads=threads,
        unit_lanes=unit_lanes, smem=fixed + per_row * resident,
    )


_FN = None
_MAX_CLUSTER = {}


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load_library().slstm_scan
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def card_max_cluster(dtype: torch.dtype) -> int:
    """The largest cluster of ``CLUSTER_SIZES`` that the current card
    schedules for the kernel at its widest (512 threads, all shared memory)."""
    key = (torch.cuda.current_device(), dtype)
    if key not in _MAX_CLUSTER:
        fn = _build.load_library().slstm_scan_max_clusters
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        for size in CLUSTER_SIZES:
            n = fn(int(dtype == torch.bfloat16), size, 32 * MAX_WARPS, SMEM_LIMIT)
            if n < 0:
                raise RuntimeError(f"slstm_scan: setting the kernel's attributes failed: cudaError {-n}")
            if n > 0:
                _MAX_CLUSTER[key] = size
                break
        else:
            raise RuntimeError(f"the card schedules no cluster of {CLUSTER_SIZES} CTAs for slstm_scan")
    return _MAX_CLUSTER[key]


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
    plan = plan_scan(B, S, H, dh, pre.element_size(), card_max_cluster(pre.dtype))
    h_all = torch.empty((B, S, H, dh), dtype=pre.dtype, device=dev)
    c1, n1, h1 = (torch.empty((B, H, dh), dtype=torch.float32, device=dev) for _ in range(3))
    err = _kernel_fn()(
        *(t.data_ptr() for t in (pre, r_z, r_i, r_f, r_o, c0, n0, h0, h_all, c1, n1, h1)),
        B, S, H, dh, int(pre.dtype == torch.bfloat16),
        plan.cluster, plan.cols, plan.rows, plan.row_slots, plan.resident, plan.threads, plan.smem,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA kernel slstm_scan was refused at launch: cudaError {err} (plan {plan})")
    LAUNCHES["slstm_scan"] += 1
    return h_all, c1, n1, h1
