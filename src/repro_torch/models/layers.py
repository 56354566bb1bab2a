"""Core layers: the mesh context and logical axis rules, norms, MLP, RoPE,
embedding, LM head and the crossbar linear (counterpart of
``repro.models.layers``).  Plain functions on tensors; params are nested
dicts of tensors.

Logical axes map to mesh axes through ``LOGICAL_RULES`` and a config's
``layout_overrides``; the active mesh (a ``launch.mesh.Mesh``: anything with
``axis_names`` and a ``shape`` mapping) is held in a context (``use_mesh``).
A spec is a tuple of entries, each None, an axis name or a tuple of names
(the reference's ``PartitionSpec``).  The reference's ``shard`` constraints
have no counterpart: a rank process holds its slices explicitly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import programmed as prog
from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# Mesh context + logical axis rules
# ---------------------------------------------------------------------------

_CTX = threading.local()

LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "d_inner": "model",
    "seq_shard": ("pod", "data"),  # long-context cache sequence sharding
    "act_seq": "model",  # sequence-parallel residual stream between blocks
    # expert-TP decode layout (weights-stationary serving; see moe.py):
    "moe_dm": None,  # wi contraction dim; "model" under expert_tp
    "moe_ff": None,  # wo contraction dim; "model" under expert_tp
}


def current_mesh():
    return getattr(_CTX, "mesh", None)


def current_overrides() -> Dict[str, Any]:
    return getattr(_CTX, "overrides", {})


@contextlib.contextmanager
def use_mesh(mesh, overrides: Optional[Dict[str, Any]] = None):
    """Install the active mesh and optional per-config logical-rule
    overrides (``layout_overrides``) for the dynamic scope."""
    prev = getattr(_CTX, "mesh", None)
    prev_ov = getattr(_CTX, "overrides", {})
    _CTX.mesh = mesh
    _CTX.overrides = dict(overrides or {})
    try:
        yield
    finally:
        _CTX.mesh = prev
        _CTX.overrides = prev_ov


def layout_overrides(cfg) -> Dict[str, Any]:
    """Per-config logical-rule overrides (``ModelConfig.layout``): ``pure_dp``
    treats the model axis as more data parallelism; ``ep_only`` shards only
    the expert banks (everything else replicated, so a programmed chip
    serves bit-identically to one device); ``expert_tp`` is weights-
    stationary MoE serving, experts over "data" and the expert FFN's
    contraction dims over "model"."""
    if getattr(cfg, "layout", "") == "pure_dp":
        return {
            "batch": ("pod", "data", "model"),
            "seq_shard": ("pod", "data", "model"),
            "vocab": None,
            "heads": None,
            "kv_heads": None,
            "mlp": None,
            "d_inner": None,
            "experts": None,
            "act_seq": None,
        }
    if getattr(cfg, "layout", "") == "ep_only":
        return {
            "batch": None,
            "seq_shard": None,
            "vocab": None,
            "heads": None,
            "kv_heads": None,
            "mlp": None,
            "d_inner": None,
            "act_seq": None,
        }
    if getattr(cfg, "layout", "") == "expert_tp":
        return {"experts": "data", "moe_dm": "model", "moe_ff": "model"}
    return {}


def _resolve_axis(logical: Optional[str], mesh):
    if logical is None:
        return None
    ov = current_overrides()
    rule = ov[logical] if logical in ov else LOGICAL_RULES.get(logical)
    if rule is None:
        return None
    if isinstance(rule, tuple):
        present = tuple(a for a in rule if a in mesh.axis_names)
        return present if present else None
    return rule if rule in mesh.axis_names else None


def pspec(axes, mesh=None) -> Tuple[Any, ...]:
    """The spec of a leaf with logical ``axes`` on ``mesh`` (default: the
    active one; no mesh: the empty spec, replicated)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    return tuple(_resolve_axis(a, mesh) for a in axes)


def dividing_entry(dim: int, ax, mesh):
    """Largest usable sharding for one dim: the full entry when it divides,
    else the longest *prefix* of a tuple entry that divides (e.g. batch 32
    on ("pod","data","model") -> ("pod","data")), else None."""
    if ax is None:
        return None
    axes = ax if isinstance(ax, tuple) else (ax,)
    for end in range(len(axes), 0, -1):
        size = 1
        for a in axes[:end]:
            size *= int(mesh.shape[a])
        if size > 1 and dim % size == 0:
            prefix = axes[:end]
            return prefix if isinstance(ax, tuple) else prefix[0]
    return None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def mlp_act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN's activation of ``x @ wi`` (a GLU's ``[u | g]`` halves)."""
    if kind in ("swiglu", "geglu"):
        u, g = torch.chunk(h, 2, dim=-1)
        act = g * torch.sigmoid(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        return u * act
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        return torch.square(torch.relu(h))
    raise ValueError(kind)


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    # wi/wo route through crossbar_linear so an enabled CrossbarMode covers
    # the FFN; with the mode disabled this is a plain matmul
    h = mlp_act(crossbar_linear(x, params["wi"], name="wi"), kind)
    return crossbar_linear(h, params["wo"], name="wo")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) or (S,).  Split-half
    rotation (first half paired with second half), not interleaved."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """``d_model**0.5`` rounded to ``dtype``, as a Python float: the
    reference multiplies by the scale cast to the embedding's dtype (59.75 in
    bfloat16 at d_model 3584, where the unrounded float would change the
    products).  Worked out once per dtype, so a call builds no tensor and
    copies nothing from the host (a CUDA-graph capture refuses such a copy)."""
    return float(torch.tensor(d_model**0.5, dtype=dtype))


def embed(params, tokens: torch.Tensor, scale: bool, d_model: int) -> torch.Tensor:
    x = params["tokens"][tokens]
    if scale:
        x = x * _embed_scale(d_model, x.dtype)
    return x


def lm_head(
    table_or_w: torch.Tensor,
    x: torch.Tensor,
    tied: bool,
    cap: float = 0.0,
    name: Optional[str] = None,
) -> torch.Tensor:
    # a tied head multiplies the transpose of the embedding table;
    # program_model(tie_lm_head=True) compiles that transpose once under the
    # embedding's name and the shape-checked lookup serves it here
    w = table_or_w.T if tied else table_or_w
    logits = crossbar_linear(x, w, name=name)
    if cap:
        logits = softcap(logits.to(torch.float32), cap)
    return logits


# ---------------------------------------------------------------------------
# CrossbarLinear — the paper's technique as a first-class serving feature
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CrossbarMode:
    """When enabled, every weight-bearing matmul — attention projections,
    MLP wi/wo and the LM head — runs through the crossbar datapath instead of
    a plain matmul; activation-activation products stay digital.

    ``device`` is a ``repro_torch.device.DeviceConfig`` (the memristor
    non-ideality model, not a torch device).  ``programmed`` (a
    ``ProgrammedModel``) is the program-once steady-state path: projections
    whose name resolves a compiled artifact serve from the fixed programmed
    chip; names without one fall back to per-call programming, and every such
    miss is counted (``crossbar_misses()``) — ``strict=True`` raises instead."""

    enabled: bool = False
    fast: bool = True  # fused exact kernel (full-resolution ADC)
    device: Optional[Any] = None  # repro_torch.device.DeviceConfig
    programmed: Optional[Any] = None  # repro_torch.device.programmed.ProgrammedModel
    strict: bool = False  # raise on artifact miss when ``programmed`` is set


_CROSSBAR = CrossbarMode()

_MISSES = threading.local()  # .counts: dict[str, int], insertion-ordered


def _record_crossbar_miss(name: str) -> None:
    counts = getattr(_MISSES, "counts", None)
    if counts is None:
        counts = _MISSES.counts = {}
    counts[name] = counts.get(name, 0) + 1


def crossbar_misses() -> Tuple[str, ...]:
    """Distinct names that resolved no artifact under an active
    ProgrammedModel, in first-miss order."""
    return tuple(getattr(_MISSES, "counts", {}))


def crossbar_miss_counts() -> Dict[str, int]:
    """{name: times missed} under an active ProgrammedModel."""
    return dict(getattr(_MISSES, "counts", {}))


def reset_crossbar_misses() -> None:
    _MISSES.counts = {}


def restore_crossbar_misses(counts: Dict[str, int]) -> None:
    """Overwrite the miss record with a ``crossbar_miss_counts`` snapshot."""
    _MISSES.counts = dict(counts)


def note_crossbar_gap(name: str) -> None:
    """Record that a weight-bearing computation stayed digital under an
    active ProgrammedModel (a rank body found no artifact for ``name``): a
    miss like any other, raised under strict mode.  No-op without a
    ProgrammedModel (digital and per-call runs are not gaps)."""
    if not _CROSSBAR.enabled or _CROSSBAR.programmed is None:
        return
    key = prog.scoped_name(name)
    _record_crossbar_miss(key)
    if _CROSSBAR.strict:
        raise LookupError(
            f"crossbar coverage gap: {key!r} runs digitally inside a rank body — no "
            "programmed artifact is bound for it (a partially programmed model or a "
            "stale store)"
        )


def current_crossbar() -> CrossbarMode:
    """The active CrossbarMode (the all-default disabled mode when unset)."""
    return _CROSSBAR


@contextlib.contextmanager
def crossbar_mode(mode: CrossbarMode):
    global _CROSSBAR
    prev = _CROSSBAR
    _CROSSBAR = mode
    try:
        yield
    finally:
        _CROSSBAR = prev


def _resolve_crossbar_artifact(name: str, shape) -> Tuple[str, Optional[Any]]:
    """(canonical key, artifact-or-None) for a scoped name + exact shape.
    Resolution order: the dynamic ``bind_artifacts`` stack (innermost wins —
    per-layer slices live there), then the active mode's ``by_name`` table."""
    key = prog.scoped_name(name)
    art = prog.active_artifact_for(key, tuple(shape))
    if art is None and _CROSSBAR.programmed is not None:
        art = _CROSSBAR.programmed.lookup(key, tuple(shape))
    return key, art


def crossbar_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    name: Optional[str] = None,
    *,
    strict: Optional[bool] = None,
) -> torch.Tensor:
    """y = x @ w, optionally through the crossbar datapath (W16A16).

    Activations are offset-encoded (crossbar inputs are unsigned; the offset
    is corrected digitally).  ``name`` is the call site's local parameter
    name; joined with the ambient ``name_scope`` it is the artifact key.  If
    an artifact resolves, the program-once path serves the call.  Otherwise
    the weight is programmed on the fly — and if a ProgrammedModel *is*
    active that fallback is a miss: counted, and an error under ``strict``."""
    if not _CROSSBAR.enabled:
        return x @ w
    key = art = None
    if name is not None:
        key, art = _resolve_crossbar_artifact(name, w.shape)
    if art is not None:
        prog.record_artifact_consumed(key)
        # x passed as-is: programmed_linear offset-encodes in x.dtype before
        # casting to float32, exactly as the fallback below does
        return prog.programmed_linear(x, art).to(x.dtype)

    if _CROSSBAR.programmed is not None:
        if key is None:
            key = f"<unnamed {tuple(int(d) for d in w.shape)}>"
        _record_crossbar_miss(key)
        strict_now = _CROSSBAR.strict if strict is None else strict
        if strict_now:
            raise LookupError(
                f"crossbar artifact miss: {key!r} (shape "
                f"{tuple(int(d) for d in w.shape)}) resolves no programmed "
                "artifact — the call would silently fall back to per-call "
                "programming.  Program the leaf (program_model leaf_filter / "
                "tie_lm_head), fix the call-site name, or drop strict mode."
            )

    shift = torch.min(x)
    xs = (x - shift).to(torch.float32)  # non-negative
    wf = w.to(torch.float32)
    y = kops.crossbar_matmul(xs, wf, device=_CROSSBAR.device, fast=_CROSSBAR.fast)
    corr = shift.to(torch.float32) * torch.sum(wf, dim=0)
    return (y + corr).to(x.dtype)
