"""Fused sLSTM recurrence: CUDA kernel + plain version.

``slstm_scan_cuda`` is the counterpart of ``repro.kernels.slstm_scan.
slstm_scan_pallas`` and replaces the TPU kernel ``_kernel`` with
``slstm_cluster_kernel`` of ``csrc/slstm_scan.cuh`` (the source holds the
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

Training runs through ``SlstmScan`` (a ``torch.autograd.Function``): its
forward is ``slstm_scan_save_cuda``, the same kernel instantiated to also
write, per step and in float32, the planes z, ai (the input gate's
pre-activation), f, o, c and n; its backward is ``slstm_scan_bwd_cuda``,
``slstm_scan_bwd_kernel`` of the same source (the card's counterpart of
JAX's autodiff through the reference's ``jax.lax.scan``: the reverse-time
scan, launched on the plan of ``plan_scan_bwd``), then the gradient of R as
a float32 product over B S.  The backward follows the JVP of
``jax.lax.min`` / ``max`` at ties (half the gradient at ``ai == IGATE_CLIP``
and at ``n == 1``), where ``torch.clamp`` would give all of it.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version (``slstm_scan_plain``, the
reference's per-step update as a Python loop; ``slstm_scan_save_plain``;
``slstm_scan_bwd_plain``, the explicit reverse loop).  Each launch adds one to
``LAUNCHES[name]``; each plain-version call adds one to ``PLAIN_CALLS[name]``,
name ``slstm_scan``, ``slstm_scan_save`` or ``slstm_scan_bwd``.
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
BWD_THREADS = 512  # SCAN_BWD_THREADS: threads of a backward CTA
BWD_ROW_SLOTS = (1, 2, 4)  # the backward's compiled batch-row counts
SAVED_PLANES = ("z", "ai", "f", "o", "c", "n")  # the saving forward's planes, in order

LAUNCHES = {"slstm_scan": 0, "slstm_scan_save": 0, "slstm_scan_bwd": 0}
PLAIN_CALLS = {"slstm_scan": 0, "slstm_scan_save": 0, "slstm_scan_bwd": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0, save: bool):
    rz, ri, rf, ro = (r.to(torch.float32) for r in (r_z, r_i, r_f, r_o))
    c, n, h = c0.to(torch.float32), n0.to(torch.float32), h0.to(torch.float32)
    hs, planes = [], []
    for t in range(pre.shape[1]):
        pf = pre[:, t].to(torch.float32)  # (B, 4, H, dh)
        hz = torch.einsum("bhd,hde->bhe", h, rz)
        hi = torch.einsum("bhd,hde->bhe", h, ri)
        hf = torch.einsum("bhd,hde->bhe", h, rf)
        ho = torch.einsum("bhd,hde->bhe", h, ro)
        z = torch.tanh(pf[:, 0] + hz)
        ai = pf[:, 1] + hi
        i = torch.exp(torch.clamp(ai, max=IGATE_CLIP))
        f = torch.sigmoid(pf[:, 2] + hf)
        o = torch.sigmoid(pf[:, 3] + ho)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1.0)
        hs.append(h)
        if save:
            planes.append(torch.stack((z, ai, f, o, c, n)))
    out = (torch.stack(hs, dim=1).to(pre.dtype), c, n, h)
    return out + (torch.stack(planes, dim=2),) if save else out


def slstm_scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0):
    """Plain PyTorch version: the reference's ``step`` (``models/xlstm.py``
    ``slstm_block``) as a loop over S, all in float32; ``h_all`` is rounded
    once to ``pre.dtype``."""
    return _scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0, save=False)


def slstm_scan_save_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0):
    """``slstm_scan_plain`` that also returns ``saved`` (6, B, S, H, dh)
    float32: the planes ``SAVED_PLANES`` (z, ai = pre_i + h R_i before the
    clip, f, o, c_t, n_t) of every step."""
    return _scan_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0, save=True)


def _tie_weight(x: torch.Tensor, at: float, below: float) -> torch.Tensor:
    """The JVP weight of ``jax.lax.min(x, at)`` (``below`` = 1) or
    ``jax.lax.max(x, at)`` (``below`` = 0) with respect to ``x``: 1 where
    ``x`` is the result alone, 1/2 at a tie, 0 where it is not the result."""
    return torch.where(x == at, 0.5, torch.where(x < at, below, 1.0 - below))


def slstm_scan_bwd_plain(dh_all, saved, r_z, r_i, r_f, r_o, c0, n0, dc1, dn1, dh1):
    """Plain PyTorch version of the backward: the reverse-time loop over S
    of ``slstm_scan_bwd_kernel`` (its formulas are in the kernel's note),
    float32, with the reference's rule at ties.  ``dh_all`` (B, S, H, dh),
    the gradient of ``h_all``; ``saved`` (6, B, S, H, dh) float32;
    ``dc1`` / ``dn1`` / ``dh1`` (B, H, dh), the gradients of the final
    state.  Returns ``(g (B, S, 4, H, dh), dc0, dn0, dh0)``, float32: ``g``
    is the gradient of ``pre`` before its cast, the rest of the initial
    state."""
    rz, ri, rf, ro = (r.to(torch.float32) for r in (r_z, r_i, r_f, r_o))
    z, ai, f, o, c, n = saved.unbind(0)
    B, S, H, dh = z.shape
    dc, dn, dhr = (t.to(torch.float32) for t in (dc1, dn1, dh1))
    g = torch.empty((B, S, 4, H, dh), dtype=torch.float32, device=saved.device)
    for t in reversed(range(S)):
        c_prev = c[:, t - 1] if t else c0.to(torch.float32)
        n_prev = n[:, t - 1] if t else n0.to(torch.float32)
        dht = dh_all[:, t].to(torch.float32) + dhr
        zt, at, ft, ot, ct, nt = z[:, t], ai[:, t], f[:, t], o[:, t], c[:, t], n[:, t]
        m = torch.clamp(nt, min=1.0)
        i = torch.exp(torch.clamp(at, max=IGATE_CLIP))
        d_o = dht * ct / m
        dc = dc + dht * ot / m
        dn = dn - _tie_weight(nt, 1.0, 0.0) * (dht * ot * ct / (m * m))
        gz = dc * i * (1.0 - zt * zt)
        gi = (dc * zt + dn) * i * _tie_weight(at, IGATE_CLIP, 1.0)
        gf = (dc * c_prev + dn * n_prev) * ft * (1.0 - ft)
        go = d_o * ot * (1.0 - ot)
        g[:, t] = torch.stack((gz, gi, gf, go), dim=1)
        dhr = (
            torch.einsum("bhe,hde->bhd", gz, rz) + torch.einsum("bhe,hde->bhd", gi, ri)
            + torch.einsum("bhe,hde->bhd", gf, rf) + torch.einsum("bhe,hde->bhd", go, ro)
        )
        dc = dc * ft
        dn = dn * ft
    return g, dc, dn, dhr


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


def _col_tiling(dh: int, esize: int, max_cluster: int) -> Tuple[int, int]:
    """(cols, col_blocks): a head's columns in 16-byte units over at most
    ``max_cluster`` CTAs."""
    vec = 16 // esize
    cols = _cdiv(_cdiv(dh, max_cluster), vec) * vec
    return cols, _cdiv(dh, cols)


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
    cols, col_blocks = _col_tiling(dh, esize, max_cluster)
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


class BwdPlan(NamedTuple):
    """How a backward call is cut: the forward's grid (col_blocks, H,
    batch_groups) and column tiling, a cluster whenever there are several
    column blocks (every step exchanges g), at most 4 batch rows a CTA."""

    cluster: int
    col_blocks: int
    cols: int  # columns d a CTA owns: its cells and its rows of R
    rows: int
    row_slots: int  # the compiled row count >= rows (the kernel's SLOTS)
    batch_groups: int
    resident: int  # rows k = g dh + e of the CTA's R slice held in shared memory
    threads: int
    smem: int


def _bwd_fixed_bytes(hrows: int, slots: int, cols: int) -> int:
    """Shared bytes of a backward CTA besides R: two buffers of the head's g
    (4 gates x hrows x slots), the partial sums of its thread groups, its
    block of g (the formula of ``bwd_smem`` in the kernel source)."""
    return 4 * slots * (8 * hrows + (BWD_THREADS // cols) * cols + 4 * cols)


@functools.lru_cache(maxsize=1024)
def plan_scan_bwd(B: int, S: int, H: int, dh: int, esize: int, max_cluster: int = 16) -> BwdPlan:
    """The launch plan of ``slstm_scan_bwd_kernel`` for a scan of ``pre``
    (B, S, 4, H, dh) with ``esize``-byte values.  Columns as ``plan_scan``'s;
    batch rows in balanced groups of at most 4, fewer where the exchange
    buffers of a wide head would not leave room; the 4 dh rows of the CTA's
    R slice resident as far as shared memory holds them (all of them, or a
    multiple of 32)."""
    if B < 1 or S < 1 or H < 1 or not 1 <= dh <= MAX_DH or esize not in (2, 4):
        raise ValueError(f"no backward plan for B={B} S={S} H={H} dh={dh} esize={esize}")
    cols, col_blocks = _col_tiling(dh, esize, max_cluster)
    hrows = col_blocks * cols
    fits = [s for s in BWD_ROW_SLOTS if _bwd_fixed_bytes(hrows, s, cols) <= SMEM_LIMIT]
    if not fits or cols > BWD_THREADS:
        raise ValueError(f"dh={dh} needs clusters of more than {max_cluster} CTAs for the backward")
    row_cap = min(max(fits), BWD_THREADS // cols)
    batch_groups = _cdiv(B, row_cap)
    rows = _cdiv(B, batch_groups)
    slots = next(s for s in BWD_ROW_SLOTS if s >= rows)
    fixed = _bwd_fixed_bytes(hrows, slots, cols)
    fit = (SMEM_LIMIT - fixed) // (cols * esize)
    resident = 4 * dh if fit >= 4 * dh else fit // 32 * 32
    return BwdPlan(
        cluster=col_blocks if col_blocks > 1 else 1, col_blocks=col_blocks, cols=cols, rows=rows,
        row_slots=slots, batch_groups=batch_groups, resident=resident, threads=BWD_THREADS,
        smem=fixed + resident * cols * esize,
    )


_FN = {}
_MAX_CLUSTER = {}


def _kernel_fn(name: str):
    """The C entry ``name`` of the built library: ``slstm_scan`` and
    ``slstm_scan_save`` (the forward, without and with ``saved``) or
    ``slstm_scan_bwd``."""
    if name not in _FN:
        fn = getattr(_build.load_library(), name)
        pointers = {"slstm_scan": 12, "slstm_scan_save": 13, "slstm_scan_bwd": 12}[name]
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return _FN[name]


def card_max_cluster(dtype: torch.dtype, backward: bool = False) -> int:
    """The largest cluster of ``CLUSTER_SIZES`` that the current card
    schedules for the kernel (the forward, or with ``backward`` the
    backward) at its widest (512 threads, all shared memory)."""
    key = (torch.cuda.current_device(), dtype, backward)
    if key not in _MAX_CLUSTER:
        fn = getattr(_build.load_library(), "slstm_scan_bwd_max_clusters" if backward else "slstm_scan_max_clusters")
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


def _check_scan(pre, r_z, r_i, r_f, r_o, c0, n0, h0) -> None:
    """The operands a forward launch takes (raises on any other)."""
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
    _check_current(dev)


def _check_current(dev: torch.device) -> None:
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"operands lie on {dev} but the current CUDA device is "
            f"{torch.cuda.current_device()}: enter torch.cuda.device(...) first"
        )


def _launch_forward(name, pre, r_z, r_i, r_f, r_o, c0, n0, h0, saved=None):
    B, S, _, H, dh = pre.shape
    dev = pre.device
    plan = plan_scan(B, S, H, dh, pre.element_size(), card_max_cluster(pre.dtype))
    h_all = torch.empty((B, S, H, dh), dtype=pre.dtype, device=dev)
    c1, n1, h1 = (torch.empty((B, H, dh), dtype=torch.float32, device=dev) for _ in range(3))
    outs = (h_all, c1, n1, h1) + ((saved,) if saved is not None else ())
    err = _kernel_fn(name)(
        *(t.data_ptr() for t in (pre, r_z, r_i, r_f, r_o, c0, n0, h0, *outs)),
        B, S, H, dh, int(pre.dtype == torch.bfloat16),
        plan.cluster, plan.cols, plan.rows, plan.row_slots, plan.resident, plan.threads, plan.smem,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} was refused at launch: cudaError {err} (plan {plan})")
    LAUNCHES[name] += 1
    return outs


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
    _check_scan(pre, r_z, r_i, r_f, r_o, c0, n0, h0)
    return _launch_forward("slstm_scan", pre, r_z, r_i, r_f, r_o, c0, n0, h0)


def slstm_scan_save_cuda(pre, r_z, r_i, r_f, r_o, c0, n0, h0):
    """``slstm_scan_cuda`` for training: also returns ``saved`` (6, B, S, H,
    dh) float32, the planes ``SAVED_PLANES`` of every step, which
    ``slstm_scan_bwd_cuda`` reads.  The same kernel and plan, instantiated
    to write them; the other outputs are those of ``slstm_scan_cuda``."""
    if pre.device.type != "cuda":
        PLAIN_CALLS["slstm_scan_save"] += 1
        return slstm_scan_save_plain(pre, r_z, r_i, r_f, r_o, c0, n0, h0)
    _check_scan(pre, r_z, r_i, r_f, r_o, c0, n0, h0)
    B, S, _, H, dh = pre.shape
    saved = torch.empty((len(SAVED_PLANES), B, S, H, dh), dtype=torch.float32, device=pre.device)
    return _launch_forward("slstm_scan_save", pre, r_z, r_i, r_f, r_o, c0, n0, h0, saved)


def slstm_scan_bwd_cuda(dh_all, saved, r_z, r_i, r_f, r_o, c0, n0, dc1, dn1, dh1):
    """The backward of the scan (``slstm_scan_bwd_plain`` gives its
    arguments and results).  ``dh_all`` is in R's dtype (float32 or
    bfloat16), everything else float32; the wrapper hands the kernel R as
    ``rt`` (H, 4, dh, dh), ``rt[h, g, e, d] = R_g[h, d, e]``.  Returns
    ``(g, dc0, dn0, dh0)``, float32."""
    if dh_all.device.type != "cuda":
        PLAIN_CALLS["slstm_scan_bwd"] += 1
        return slstm_scan_bwd_plain(dh_all, saved, r_z, r_i, r_f, r_o, c0, n0, dc1, dn1, dh1)
    if dh_all.ndim != 4:
        raise ValueError(f"dh_all must be (B, S, H, dh), got {tuple(dh_all.shape)}")
    B, S, H, dh = dh_all.shape
    if B < 1 or S < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"the kernel takes B, S >= 1 and 1 <= dh <= {MAX_DH}, got {tuple(dh_all.shape)}")
    if dh_all.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dh_all.dtype}")
    dev = dh_all.device
    _check(dh_all, "dh_all", (B, S, H, dh), dh_all.dtype, dev)
    _check(saved, "saved", (len(SAVED_PLANES), B, S, H, dh), torch.float32, dev)
    for name, r in (("r_z", r_z), ("r_i", r_i), ("r_f", r_f), ("r_o", r_o)):
        _check(r, name, (H, dh, dh), dh_all.dtype, dev)
    for name, t in (("c0", c0), ("n0", n0), ("dc1", dc1), ("dn1", dn1), ("dh1", dh1)):
        _check(t, name, (B, H, dh), torch.float32, dev)
    _check_current(dev)
    plan = plan_scan_bwd(B, S, H, dh, dh_all.element_size(), card_max_cluster(dh_all.dtype, backward=True))
    rt = torch.stack((r_z, r_i, r_f, r_o), dim=1).transpose(2, 3).contiguous()
    g = torch.empty((B, S, 4, H, dh), dtype=torch.float32, device=dev)
    dc0, dn0, dh0 = (torch.empty((B, H, dh), dtype=torch.float32, device=dev) for _ in range(3))
    err = _kernel_fn("slstm_scan_bwd")(
        *(t.data_ptr() for t in (dh_all, saved, rt, c0, n0, dc1, dn1, dh1, g, dc0, dn0, dh0)),
        B, S, H, dh, int(dh_all.dtype == torch.bfloat16),
        plan.cluster, plan.cols, plan.rows, plan.row_slots, plan.resident, plan.threads, plan.smem,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA kernel slstm_scan_bwd was refused at launch: cudaError {err} (plan {plan})")
    LAUNCHES["slstm_scan_bwd"] += 1
    return g, dc0, dn0, dh0


def h_before_each_step(saved: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) float32: the h each step started from (h0, then h_t =
    o c / max(n, 1) rebuilt from the saved planes by the forward's own
    operations, so equal to the float32 h the forward used)."""
    _, _, _, o, c, n = saved.unbind(0)
    h = o * c / torch.clamp(n, min=1.0)
    return torch.cat((h0.to(torch.float32)[:, None], h[:, :-1]), dim=1)


class SlstmScan(torch.autograd.Function):
    """The scan with its backward: ``SlstmScan.apply(pre, r_z, r_i, r_f,
    r_o, c0, n0, h0)`` returns what ``slstm_scan_cuda`` does.  Forward:
    ``slstm_scan_save_cuda``; backward: ``slstm_scan_bwd_cuda``, then the
    gradient of each R_g, the float32 sum over B S of h_{t-1} g_t (a plain
    product, as in the reference's autodiff), cast to R's dtype; ``pre``'s
    gradient is ``g`` cast to its dtype, the initial state's float32.  Each
    call runs the kernels on CUDA tensors and their plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, pre, r_z, r_i, r_f, r_o, c0, n0, h0):
        h_all, c1, n1, h1, saved = slstm_scan_save_cuda(pre, r_z, r_i, r_f, r_o, c0, n0, h0)
        ctx.save_for_backward(r_z, r_i, r_f, r_o, c0, n0, h0, saved)
        ctx.pre_dtype = pre.dtype
        return h_all, c1, n1, h1

    @staticmethod
    def backward(ctx, dh_all, dc1, dn1, dh1):
        r_z, r_i, r_f, r_o, c0, n0, h0, saved = ctx.saved_tensors
        rs = (r_z, r_i, r_f, r_o)
        carries = (t.to(torch.float32).contiguous() for t in (dc1, dn1, dh1))
        g, dc0, dn0, dh0 = slstm_scan_bwd_cuda(dh_all.contiguous(), saved, *rs, c0, n0, *carries)
        need = ctx.needs_input_grad
        d_rs = [None] * 4
        if any(need[1:5]):
            d_r = torch.einsum("bshd,bsghe->ghde", h_before_each_step(saved, h0), g)
            d_rs = [d_r[k].to(r.dtype) if need[1 + k] else None for k, r in enumerate(rs)]
        return (
            g.to(ctx.pre_dtype) if need[0] else None, *d_rs,
            dc0 if need[5] else None, dn0 if need[6] else None, dh0 if need[7] else None,
        )
