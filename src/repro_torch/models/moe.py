"""Mixture-of-Experts FFN on one device (counterpart of the single-device
path of ``repro.models.moe``: its ``mesh is None`` branch, and one rank of
its expert-parallel body without the collectives).

Routing is the reference's: the router is a crossbar projection like any
other, a softmax over all experts, the top ``k`` (ties to the lower expert
id), gates renormalised.  Dispatch is sort-based and capacity-bounded: every
expert owns ``capacity`` slots, an assignment past them is dropped, and the
slot tables are built without reading anything back to the host (stable
sorts, ``searchsorted``, ``scatter_``), so a forward with MoE layers can be
captured in a CUDA graph.  The combine adds each token's slot contributions
in slot order (the reference's scatter-add order) as ``k`` gathers, without
atomics, so a replay is bit-identical to an eager run and the card to the
CPU.

Each expert's ``(D, F)`` / ``(F, D)`` slab is its own crossbar: on the
crossbar datapath the expert FFN is a loop over experts, one
``crossbar_linear`` a projection, each binding its expert's view of the
layer's ``(E, K, N)`` artifact by name (the counterpart of the reference's
``lax.scan`` over experts, one ``pallas_call`` a step).

An ``ExpertShare`` is the part of an expert-parallel deployment one device
holds: rank ``rank`` of ``ranks`` owns experts ``[rank * E/ranks, (rank +
1) * E/ranks)``; the router, attention, shared expert and head are
replicated.  A share routes over all ``E`` experts, computes its own
experts' slots and returns its partial sum, as the reference's EP body
(``repro/models/moe.py`` ``moe_ffn``, the shard_map branch) does before its
``psum`` over ranks; the other ranks' experts and the ``psum`` are not part
of the share.  The default share (one rank) is the single-device path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device.programmed import bind_artifacts
from repro_torch.models.layers import _resolve_crossbar_artifact, crossbar_linear, current_crossbar


@dataclasses.dataclass(frozen=True)
class ExpertShare:
    """Rank ``rank`` of an ``ranks``-way expert-parallel deployment."""

    rank: int = 0
    ranks: int = 1

    def __post_init__(self):
        if self.ranks < 1 or not 0 <= self.rank < self.ranks:
            raise ValueError(f"ExpertShare(rank={self.rank}, ranks={self.ranks}): need 0 <= rank < ranks")

    def local_experts(self, cfg: ModelConfig) -> int:
        """Experts this share holds; the experts must split evenly over the
        ranks, as the reference's EP body requires."""
        if cfg.moe_experts % self.ranks:
            raise ValueError(
                f"{cfg.name}: {cfg.moe_experts} experts do not split over {self.ranks} ranks"
            )
        return cfg.moe_experts // self.ranks

    def first_expert(self, cfg: ModelConfig) -> int:
        """Global id of the share's first expert (the EP body's ``lo``)."""
        return self.rank * self.local_experts(cfg)


SINGLE_DEVICE = ExpertShare()
_SHARE = SINGLE_DEVICE


def current_expert_share() -> ExpertShare:
    """The ambient share (``SINGLE_DEVICE`` unless ``expert_share`` set one)."""
    return _SHARE


@contextlib.contextmanager
def expert_share(share: Optional[ExpertShare]):
    """Run MoE layers as ``share`` for the dynamic scope (None: unchanged)."""
    global _SHARE
    prev = _SHARE
    _SHARE = prev if share is None else share
    try:
        yield
    finally:
        _SHARE = prev


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_moe(
    cfg: ModelConfig, repeats: int, draw: Callable[[Tuple[int, ...], float], torch.Tensor],
    share: ExpertShare = SINGLE_DEVICE,
) -> Dict[str, torch.Tensor]:
    """One MoE FFN position of a stage, its ``repeats`` layers stacked:
    ``router`` (L, D, E), separate ``wi`` / ``wg`` (L, E_loc, D, F) and
    ``wo`` (L, E_loc, F, D) banks of the share's experts, and the shared
    expert's ``shared_wi`` / ``shared_wg`` / ``shared_wo``.  Scales are the
    reference's: 0.02 for the router, ``E**-0.5`` (the leading dim of the
    reference's unstacked bank, the whole model's expert count) for the
    banks, fan-in for the shared expert.  ``draw(shape, scale)`` returns one
    normal tensor; a bank is drawn one layer at a time."""
    d, f, L = cfg.d_model, cfg.moe_d_ff, repeats
    e_loc = share.local_experts(cfg)
    glu = cfg.mlp_kind in ("swiglu", "geglu")
    bank_scale = cfg.moe_experts**-0.5

    def bank(k: int, n: int) -> torch.Tensor:
        return torch.stack([draw((e_loc, k, n), bank_scale) for _ in range(L)])

    p = {"router": draw((L, d, cfg.moe_experts), 0.02), "wi": bank(d, f)}
    if glu:
        p["wg"] = bank(d, f)
    p["wo"] = bank(f, d)
    if cfg.moe_shared_experts:
        fs = cfg.moe_d_ff * cfg.moe_shared_experts
        p["shared_wi"] = draw((L, d, fs), d**-0.5)
        if glu:
            p["shared_wg"] = draw((L, d, fs), d**-0.5)
        p["shared_wo"] = draw((L, fs, d), fs**-0.5)
    return p


# ---------------------------------------------------------------------------
# Expert FFN
# ---------------------------------------------------------------------------

def _act(u: torch.Tensor, g: Optional[torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return u * (g * torch.sigmoid(g))
    if kind == "geglu":
        return u * F.gelu(g, approximate="tanh")
    if kind == "gelu":
        return F.gelu(u, approximate="tanh")
    return torch.square(torch.relu(u))


def _expert_ffn(h: torch.Tensor, wi, wg, wo, kind: str) -> torch.Tensor:
    """h: (E, C, D); wi / wg: (E, D, F); wo: (E, F, D) -> (E, C, D)."""
    if not current_crossbar().enabled:
        u = torch.einsum("ecd,edf->ecf", h, wi)
        g = torch.einsum("ecd,edf->ecf", h, wg) if wg is not None else None
        return torch.einsum("ecf,efd->ecd", _act(u, g, kind), wo)
    return _expert_ffn_crossbar(h, wi, wg, wo, kind)


def _expert_ffn_crossbar(h: torch.Tensor, wi, wg, wo, kind: str) -> torch.Tensor:
    """The expert FFN on the crossbar datapath: a loop over experts, three
    (or two) ``crossbar_linear`` calls each.  Where the layer's ``(E, K,
    N)`` artifacts are bound (``_run_stage`` binds layer ``r``'s views of the
    ``(L, E, K, N)`` banks), expert ``e`` binds its own ``(K, N)`` view of
    each under the projection's name and serves from it; otherwise each
    call programs its expert's slab on the fly, as any unprogrammed
    projection does."""
    arts = {}
    for n, w in (("wi", wi), ("wg", wg), ("wo", wo)):
        if w is not None:
            art = _resolve_crossbar_artifact(n, w.shape)[1]
            if art is not None:
                arts[n] = art
    out = []
    for e in range(h.shape[0]):
        with bind_artifacts({n: a.layer(e) for n, a in arts.items()}):
            u = crossbar_linear(h[e], wi[e], name="wi")
            g = crossbar_linear(h[e], wg[e], name="wg") if wg is not None else None
            out.append(crossbar_linear(_act(u, g, kind), wo[e], name="wo"))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------

def route_from_logits(logits: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype):
    """(top-k expert ids, renormalised gates in ``dtype``, probabilities)
    from float32 router logits.

    The probabilities are the float32 softmax, computed in float64 and
    rounded once, so that the card and the CPU give the same bits (their
    float32 ``exp`` and reduction orders differ by ULPs); the gates are
    renormalised the same way, by ``max(sum, 1e-9)``.  The top ``k`` are the
    first ``k`` of a stable descending sort: equal probabilities go to the
    lower expert id first, as ``jax.lax.top_k`` breaks ties."""
    l64 = logits.to(torch.float64)
    e = torch.exp(l64 - torch.amax(l64, dim=-1, keepdim=True))
    probs = (e / torch.sum(e, dim=-1, keepdim=True)).to(torch.float32)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., : cfg.moe_top_k], order[..., : cfg.moe_top_k]
    g64 = gates.to(torch.float64)
    gates = (g64 / torch.clamp(torch.sum(g64, dim=-1, keepdim=True), min=1e-9)).to(torch.float32)
    return idx, gates.to(dtype), probs


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """The router on the crossbar datapath (programmed or per call, like any
    projection), then ``route_from_logits``: routing is decided from the
    logits the chip produces."""
    logits = crossbar_linear(x, router_w.to(x.dtype), name="router").to(torch.float32)
    return route_from_logits(logits, cfg, x.dtype)


def _capacity(n_tokens: int, cfg: ModelConfig, n_local_experts: int) -> int:
    """Slots an expert owns: ``n_tokens * k / E * capacity_factor`` rounded
    up to a multiple of 8, at least 8 (``E`` is the whole model's count and
    ``n_tokens`` counts every row, padding and idle slots included)."""
    c = n_tokens * cfg.moe_top_k / max(1, cfg.moe_experts) * cfg.moe_capacity_factor
    return max(8, int(math.ceil(c / 8) * 8))


def slot_tables(top_idx: torch.Tensor, gates: torch.Tensor, n_local: int, capacity: int, lo: int = 0):
    """Capacity-bounded slots of the experts ``[lo, lo + n_local)``.

    ``top_idx`` / ``gates``: (N, k) global expert ids and gates.  Returns
    ``(tok_slot, gate_slot, token_slots)``: the source token and gate of
    each of the ``n_local * capacity`` slots (an empty slot reads token 0
    at gate 0, as in the reference), and each token's ``k`` slots in
    ascending order, ``n_local * capacity`` standing for an assignment that
    was dropped or belongs to another rank.  An expert's slots go to its
    assignments in token order (a stable sort of the flat assignments);
    those past ``capacity`` drop.  Nothing is read back to the host."""
    N, k = top_idx.shape
    n_slots = n_local * capacity
    flat_e = top_idx.reshape(-1).to(torch.int64) - lo
    flat_gate = gates.reshape(-1)
    local = (flat_e >= 0) & (flat_e < n_local)
    e_key = torch.where(local, flat_e, n_local)  # another rank's -> the overflow bucket
    sorted_e, order = torch.sort(e_key, stable=True)
    # position within the expert's run of the sorted keys
    pos = torch.arange(N * k, device=top_idx.device) - torch.searchsorted(sorted_e, sorted_e)
    keep = (sorted_e < n_local) & (pos < capacity)
    slot = torch.where(keep, sorted_e * capacity + pos, n_slots)
    # every dropped assignment writes the overflow slot n_slots, which is cut
    tok_slot = torch.zeros(n_slots + 1, dtype=torch.int64, device=top_idx.device).scatter_(
        0, slot, order // k
    )
    gate_slot = torch.zeros(n_slots + 1, dtype=flat_gate.dtype, device=gates.device).scatter_(
        0, slot, flat_gate[order] * keep.to(flat_gate.dtype)
    )
    by_assignment = torch.empty_like(slot).scatter_(0, order, slot)
    token_slots = torch.sort(by_assignment.reshape(N, k), dim=1).values
    return tok_slot[:n_slots], gate_slot[:n_slots], token_slots


def _dispatch_indices(top_idx: torch.Tensor, gates: torch.Tensor, n_experts: int, capacity: int):
    """(tok_slot, gate_slot) over ``n_experts * capacity`` slots of every
    expert (the reference's slot assignment shared by its EP dispatches)."""
    tok_slot, gate_slot, _ = slot_tables(top_idx, gates, n_experts, capacity)
    return tok_slot, gate_slot


def combine(contrib: torch.Tensor, token_slots: torch.Tensor) -> torch.Tensor:
    """Sum each token's slot contributions: ``contrib`` (n_slots, D), one row
    a slot; ``token_slots`` (N, k) from ``slot_tables``.  Starting from
    zeros in ``contrib``'s dtype, the ``k`` contributions are added in slot
    order — the order of the reference's scatter-add — by ``k`` gathers (an
    empty slot's row, gated 0, adds nothing), with no atomics."""
    padded = torch.cat([contrib, torch.zeros_like(contrib[:1])])  # row n_slots: nothing
    y = torch.zeros((token_slots.shape[0], contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    for j in range(token_slots.shape[1]):
        y = y + padded[token_slots[:, j]]
    return y


def _dispatch_compute(
    xf: torch.Tensor,  # (N, D) tokens
    top_idx: torch.Tensor,  # (N, k) global expert ids
    gates: torch.Tensor,  # (N, k)
    wi: torch.Tensor,  # (E_loc, D, F)
    wg: Optional[torch.Tensor],  # (E_loc, D, F) or None
    wo: torch.Tensor,  # (E_loc, F, D)
    lo: int,  # first global expert id held locally
    capacity: int,
    mlp_kind: str,
) -> torch.Tensor:
    """Capacity-bounded dispatch -> expert FFN -> gated combine; assignments
    to experts outside ``[lo, lo + E_loc)`` are left to their ranks."""
    n_local = wi.shape[0]
    tok_slot, gate_slot, token_slots = slot_tables(top_idx, gates, n_local, capacity, lo)
    buf = xf[tok_slot].reshape(n_local, capacity, -1)
    out = _expert_ffn(buf, wi, wg, wo, mlp_kind)
    contrib = out.reshape(n_local * capacity, -1) * gate_slot[:, None].to(out.dtype)
    return combine(contrib.to(xf.dtype), token_slots)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, share: Optional[ExpertShare] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts of ``share`` (default:
    the ambient ``current_expert_share()``) plus the shared expert.  The
    banks must hold the share's experts."""
    share = current_expert_share() if share is None else share
    B, S, D = x.shape
    k = cfg.moe_top_k
    n_local = share.local_experts(cfg)
    if params["wi"].shape[0] != n_local:
        raise ValueError(
            f"{cfg.name}: the expert banks hold {params['wi'].shape[0]} experts, the share "
            f"{share} {n_local}: run the params under the ExpertShare they were made for"
        )
    idx, gates, _ = _route(x, params["router"], cfg)
    y = _dispatch_compute(
        x.reshape(-1, D), idx.reshape(-1, k), gates.reshape(-1, k),
        params["wi"], params.get("wg"), params["wo"],
        share.first_expert(cfg), _capacity(B * S, cfg, n_local), cfg.mlp_kind,
    ).reshape(B, S, D)
    if cfg.moe_shared_experts:
        u = crossbar_linear(x, params["shared_wi"], name="shared_wi")
        g = crossbar_linear(x, params["shared_wg"], name="shared_wg") if "shared_wg" in params else None
        y = y + crossbar_linear(_act(u, g, cfg.mlp_kind), params["shared_wo"], name="shared_wo")
    return y
