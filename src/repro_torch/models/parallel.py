"""Data- and tensor-parallel training over rank processes (port-only module:
the reference gets both from GSPMD, ``jax.jit`` of the one-device
``loss_fn`` over sharded params and batch).

A rank holds its ``launch.sharding.param_shardings`` block of every
parameter and its rows of the batch.  ``loss_fn`` runs under a ``Plan``
(``use_plan``): the mesh, the axes the batch rows are split over and the
tensor-parallel axis ("model" under the ``tp`` layout; none under
``pure_dp`` or on a size-1 axis).  Without a plan every path is the
one-device one.

Tensor parallelism is Megatron's, in ``torch.autograd.Function``s over the
mesh's collectives (each sum in its operand's dtype):

* ``enter`` — identity forward, model-axis sum backward: where a region
  starts, on the residual stream *before* the pre-norm, and on the norm's
  scale (in float32), whose gradient inside the region is partial
  (``pre_norm``);
* ``reduce`` — sum forward, identity backward: after a row-parallel
  projection (attention's ``wo``, the MLP's ``wo``; its partial product in
  float32, rounded once after the sum, ``_row_parallel``), the
  vocab-parallel embedding lookup, and the vocab-parallel ``logsumexp``
  and target logit;
* the batch axes: ``batch_sum`` of the per-rank loss (the global masked
  mean: the NLL sums over the *global* mask count), whose backward leaves
  each rank its rows' gradients, summed by the train step afterwards.

What a rank computes on is not always what it stores:

* attention computes whole heads: the KV groups split over the model axis
  (``head_ranges``; where there are fewer groups than ranks, each group's
  query heads split among its ranks).  smollm's 15 / 5 heads split its
  stored ``wq`` mid-head (960 columns, 480 a rank); such a leaf is gathered
  for the computation and its gradient reduce-scattered back (GSPMD's
  resharding, ``_Gather``); a leaf stored where it computes is used as is;
* the packed GLU ``wi`` ``[u | g]`` is stored in contiguous blocks (at 2
  ranks one holds all of ``u``, the other all of ``g``); each rank computes
  its block of the FFN from ``[u_r | g_r]``, cut from the gathered leaf;
* a leaf stored whole (a dim that does not divide) is cut to the rank's
  block through ``enter``, so its partial gradient is summed.

Every rank issues the same collectives in the same order, also where a
checkpointed layer or loss chunk reruns its forward in backward.  The plan
is process-wide, not thread-local: autograd runs a CUDA backward, and with
it those reruns, on a thread of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import _resolve_axis, dividing_entry

Ranges = List[Tuple[int, int]]

_TP_AXES = ("vocab", "heads", "kv_heads", "mlp")


@dataclasses.dataclass(frozen=True)
class Plan:
    """``batch_axes``: the axes this rank's batch rows are split over (the
    entry of ``launch.sharding.batch_shardings``); ``tp_axis``: the
    tensor-parallel axis, or None."""

    mesh: Any
    batch_axes: Tuple[str, ...]
    tp_axis: Optional[str]

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp_axis) if self.tp_axis else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.axis_index(self.tp_axis) if self.tp_axis else 0


def make_plan(cfg: ModelConfig, mesh, rows: int) -> Plan:
    """The plan for a global batch of ``rows`` under the active layout
    (``layers.use_mesh(mesh, layout_overrides(cfg))``).  Tensor parallelism
    covers attention (not MLA), dense FFNs, the embedding and the head; a
    config with another block is refused on a tensor-parallel axis."""
    resolved = _resolve_axis("batch", mesh)
    dp = () if resolved is None else (resolved if isinstance(resolved, tuple) else (resolved,))
    entry = dividing_entry(rows, dp, mesh) if dp else None
    batch_axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    tp = {_resolve_axis(a, mesh) for a in _TP_AXES}
    if len(tp) != 1 or isinstance(next(iter(tp)), tuple):
        raise ValueError(f"tensor parallelism needs {_TP_AXES} on one mesh axis; the layout gives {tp}")
    tp_axis = tp.pop()
    if tp_axis is not None and mesh.axis_size(tp_axis) == 1:
        tp_axis = None
    if tp_axis is not None:
        for spec in cfg.stages:
            for i, kind in enumerate(spec.kinds):
                if not kind.startswith("attn") or cfg.kv_lora_rank or (spec.moe[i] and cfg.moe_experts):
                    raise NotImplementedError(
                        f"{cfg.name}: no tensor-parallel {kind}{' MoE' if spec.moe[i] else ''} block "
                        "(ROADMAP.md Queue 1: MoE and FSDP training over a mesh)"
                    )
        head_ranges(cfg.n_heads, cfg.n_kv_heads, mesh.axis_size(tp_axis))  # refuses a split it cannot make
    return Plan(mesh, batch_axes, tp_axis)


_PLAN: Optional[Plan] = None


def current() -> Optional[Plan]:
    return _PLAN


def tp_plan() -> Optional[Plan]:
    """The active plan where it has a tensor-parallel axis, else None."""
    return _PLAN if _PLAN is not None and _PLAN.tp_axis is not None else None


@contextlib.contextmanager
def use_plan(plan: Optional[Plan]):
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield
    finally:
        _PLAN = prev


# ---------------------------------------------------------------------------
# Collectives under autograd
# ---------------------------------------------------------------------------

class _Sum(torch.autograd.Function):
    """Sum over ``axes`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward, sum over ``axes`` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """The whole leaf along ``dim`` forward; the sum of every rank's
    gradient, this rank's block, backward: in the gradient's dtype where the
    ranks use disjoint parts of the leaf (``disjoint``: every element of the
    sum but one is zero, so it is exact), else in float32."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, disjoint):
        ctx.mesh, ctx.axes, ctx.dim, ctx.disjoint = mesh, axes, dim, disjoint
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        wire = g.dtype if ctx.disjoint else torch.float32
        return ctx.mesh.psum_scatter(g.to(wire), ctx.axes, ctx.dim).to(g.dtype), None, None, None, None


def pre_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``layers.rms_norm(x, scale, eps)`` at a region's start, where the
    stream and the scale enter it; the scale in float32 (the value
    ``rms_norm`` computes with anyway), so the ranks' partial gradients of a
    16-bit scale are summed in float32 and rounded once, as one device
    rounds them.  The same values as ``rms_norm`` forward."""
    return layers.rms_norm(enter(x), enter(scale.to(torch.float32)), eps)


def enter(x: torch.Tensor) -> torch.Tensor:
    """A tensor-parallel region's input (identity; its gradient summed over
    the model axis).  The input itself without a tensor-parallel plan."""
    plan = tp_plan()
    return x if plan is None else _SumGrad.apply(x, plan.mesh, plan.tp_axis)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial results over the model axis."""
    plan = tp_plan()
    return x if plan is None else _Sum.apply(x, plan.mesh, plan.tp_axis)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the batch axes (identity backward: each rank keeps the
    gradient of its own rows)."""
    plan = current()
    return x if plan is None or not plan.batch_axes else _Sum.apply(x, plan.mesh, plan.batch_axes)


# ---------------------------------------------------------------------------
# Partitions
# ---------------------------------------------------------------------------

def split(n: int, parts: int) -> Ranges:
    """``n`` in ``parts`` contiguous ranges, the first ``n % parts`` one
    longer (``numpy.array_split``)."""
    q, r = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + q + (i < r))
    return list(zip(bounds[:-1], bounds[1:]))


def head_ranges(H: int, KV: int, M: int) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """For each of ``M`` ranks, (query heads, KV heads) it computes: whole
    KV groups where there are at least ``M``; else each group's query heads
    split among ``M // KV`` ranks (KV dividing ``M``, the ranks dividing
    the group)."""
    R = H // KV
    if KV >= M:
        return [((a * R, b * R), (a, b)) for a, b in split(KV, M)]
    per = M // KV
    if M % KV or R % per:
        raise NotImplementedError(f"{H} query / {KV} KV heads do not split over {M} ranks")
    n = R // per
    return [((g * R + j * n, g * R + (j + 1) * n), (g, g + 1)) for g in range(KV) for j in range(per)]


def _take(w: torch.Tensor, plan: Plan, dim: int, whole: int, blocks: Sequence[Ranges]) -> torch.Tensor:
    """This rank's computing block of a leaf (``whole`` long along ``dim``):
    ``blocks[r]``'s ranges of the whole leaf, concatenated, for rank ``r``.
    A stored block that equals it on every rank is used as is; a sharded
    leaf is otherwise gathered (its gradient reduce-scattered), a whole one
    entered (its partial gradient summed)."""
    M = plan.tp_size
    if w.shape[dim] == whole:
        src = _SumGrad.apply(w, plan.mesh, plan.tp_axis)
    else:
        n = whole // M
        if w.shape[dim] * M != whole:
            raise ValueError(f"a leaf of {w.shape[dim]} along dim {dim} is no block of {whole} over {M} ranks")
        if all(list(b) == [(q * n, (q + 1) * n)] for q, b in enumerate(blocks)):
            return w
        ranges = sorted(r for b in blocks for r in b)
        disjoint = all(a1 <= b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        src = _Gather.apply(w, plan.mesh, plan.tp_axis, dim, disjoint)
    parts = [src.narrow(dim, a, b - a) for a, b in blocks[plan.tp_index]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection: this rank's partial ``h @ w`` in float32
    (the products of 16-bit operands are exact there, and one device's GEMM
    accumulates in float32 too), summed over the model axis, then rounded
    to ``h``'s dtype once, as one device rounds its whole product."""
    return reduce(h.to(torch.float32) @ w.to(torch.float32)).to(h.dtype)


def attention(params, x: torch.Tensor, cfg: ModelConfig, kind: str, positions: torch.Tensor) -> torch.Tensor:
    """Head-parallel attention (training: no cache): the rank's heads'
    columns of ``wq`` / ``wk`` / ``wv``, their attention, and the same rows
    of ``wo`` (``_row_parallel``)."""
    plan = tp_plan()
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ranges = head_ranges(H, KV, plan.tp_size)
    q_blocks = [[(a * dh, b * dh)] for (a, b), _ in ranges]
    kv_blocks = [[(a * dh, b * dh)] for _, (a, b) in ranges]
    (h0, h1), (k0, k1) = ranges[plan.tp_index]
    B, S, _ = x.shape
    q = (x @ _take(params["wq"], plan, 1, H * dh, q_blocks)).reshape(B, S, h1 - h0, dh)
    k = (x @ _take(params["wk"], plan, 1, KV * dh, kv_blocks)).reshape(B, S, k1 - k0, dh)
    v = (x @ _take(params["wv"], plan, 1, KV * dh, kv_blocks)).reshape(B, S, k1 - k0, dh)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = attn_mod.gqa_attention(
        q, k, v, scale=cfg.attn_scale if cfg.attn_scale else dh**-0.5,
        window=cfg.sliding_window if kind == "attn_local" else 0, attn_cap=cfg.attn_softcap,
    )
    return _row_parallel(out.reshape(B, S, (h1 - h0) * dh), _take(params["wo"], plan, 0, H * dh, q_blocks))


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN's hidden units split over the model axis: ``[u_r | g_r]`` of
    a GLU's packed ``wi``, the same rows of ``wo`` (``_row_parallel``)."""
    plan = tp_plan()
    F = cfg.d_ff
    ranges = split(F, plan.tp_size)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        wi = _take(params["wi"], plan, 1, 2 * F, [[(a, b), (F + a, F + b)] for a, b in ranges])
    else:
        wi = _take(params["wi"], plan, 1, F, [[r] for r in ranges])
    h = layers.mlp_act(x @ wi, cfg.mlp_kind)
    return _row_parallel(h, _take(params["wo"], plan, 0, F, [[r] for r in ranges]))


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Vocab-parallel lookup: each rank looks up the tokens of its rows of
    the table (zeros elsewhere), then the sum.  A table stored whole is
    looked up whole."""
    table = params["tokens"]
    if table.shape[0] == cfg.vocab_size:
        return layers.embed(params, tokens, cfg.embed_scale, cfg.d_model)
    n = table.shape[0]
    local = tokens.to(torch.int64) - tp_plan().tp_index * n
    inside = (local >= 0) & (local < n)
    x = reduce(table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype))
    if cfg.embed_scale:
        x = x * layers._embed_scale(cfg.d_model, x.dtype)
    return x


def chunk_nll(params, cfg: ModelConfig, xc: torch.Tensor, tc: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """``model._chunk_nll`` with a vocab-parallel head: the rank's vocab
    block of the logits, the ``logsumexp`` from the global max and the sum
    of the ranks' exponent sums, the target's logit from the rank that
    holds it."""
    plan = tp_plan()
    V = cfg.vocab_size
    ranges = split(V, plan.tp_size)
    v0, v1 = ranges[plan.tp_index]
    h = pre_norm(xc, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and cfg.frontend == "token":
        w = _take(params["embed"]["tokens"], plan, 0, V, [[r] for r in ranges])
        logits = layers.lm_head(w, h, tied=True, cap=cfg.logit_softcap)
    else:
        w = _take(params["head"], plan, 1, V, [[r] for r in ranges])
        logits = layers.lm_head(w, h, tied=False, cap=cfg.logit_softcap)
    logits = logits.to(torch.float32)
    m = plan.mesh.pmax(torch.amax(logits.detach(), dim=-1), plan.tp_axis)
    lse = m + torch.log(reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    t = tc.to(torch.int64) - v0
    inside = (t >= 0) & (t < v1 - v0)
    lab = reduce(torch.gather(logits, -1, t.clamp(0, v1 - v0 - 1)[..., None])[..., 0] * inside)
    return torch.sum((lse - lab) * mc)
