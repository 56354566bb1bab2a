"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): on one
device, and over the ranks of a mesh through the reference's three bodies.

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

Over a mesh (``layers.use_mesh``; one process per rank, ``launch.mesh``)
``moe_ffn`` selects the reference's body as its ``moe_ffn`` does:

* ``_moe_expert_tp`` (``layout="expert_tp"``): experts over "data", the
  expert FFN's contraction dims over "model"; each rank holds rows of the
  global chip and serves partial sums (``programmed_linear(colsum=)``) that
  ``psum`` / ``psum_scatter`` add up, and the routed rows cross "data" by
  all-to-all;
* ``_moe_alltoall`` (``moe_dispatch="alltoall"``, S splitting over
  "model"): tokens sequence-sharded, routed copies exchanged by all-to-all;
* the expert-parallel body (``_moe_ep``): every rank routes its tokens,
  computes its experts' slots, and the partial outputs are ``psum``-ed.

Each rank quantizes its own input shard, as the reference's ranks do (the
dynamic ``x_scale`` is per rank), so the all-to-all and expert-TP results
are the reference's mesh results, not its one-device ones.  A body's
output is sharded as its ``out_specs`` say; ``moe_ffn`` gathers it, so every
rank returns the whole ``(B, S, D)``.  The shared expert runs whole on every
rank.  The params are the rank's slices (``rank_params``: the banks and the
router by ``param_specs``); the bound artifacts must be the rank's slices
too (``checkpoint.restore_programmed(mesh=)``, or ``device.programmed.
local_artifact`` of a whole chip): a rank never holds the whole chip.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import programmed as prog
from repro_torch.device.programmed import bind_artifacts
from repro_torch.models.layers import (
    _resolve_axis,
    _resolve_crossbar_artifact,
    crossbar_linear,
    current_crossbar,
    current_mesh,
    layout_overrides,
    note_crossbar_gap,
    pspec,
    use_mesh,
)

# An (L, E, K, N) expert bank under expert parallelism: the experts over the
# "model" axis (an ExpertShare is rank ``rank`` of ``ranks`` on it).
BANK_SPEC = (None, "model", None, None)


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

    def layout(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(axis sizes, coordinates) of the share on the "model" axis, for
        ``device.programmed.local_slice`` under ``BANK_SPEC``."""
        return {"model": self.ranks}, {"model": self.rank}


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


# ---------------------------------------------------------------------------
# Rank slices
# ---------------------------------------------------------------------------

# The reference's logical axes of the routed leaves (its ``init_moe``),
# without the stacking axis.  The shared expert runs whole on every rank.
_LOGICAL_AXES = {
    "router": ("moe_dm", None),
    "wi": ("experts", "moe_dm", None),
    "wg": ("experts", "moe_dm", None),
    "wo": ("experts", "moe_ff", "embed"),
}


def _ffn_specs(ffn: Dict[str, torch.Tensor], mesh) -> Dict[str, Tuple]:
    """{leaf: spec} of one FFN's routed leaves under the active overrides,
    ``None`` entries for the leading stacking axes."""
    return {
        k: (None,) * (ffn[k].ndim - len(ax)) + pspec(ax, mesh)
        for k, ax in _LOGICAL_AXES.items() if k in ffn
    }


def param_specs(params, cfg: ModelConfig, mesh) -> Dict[str, Tuple]:
    """{joined path: spec} of every MoE FFN's router and banks in a params
    tree (an FFN is a dict holding a ``router``) under ``cfg``'s layout on
    ``mesh``: the specs the rank slices and the chip's placement follow."""
    out = {}

    def visit(node, path):
        if not isinstance(node, dict):
            return
        if "router" in node:
            out.update({"/".join(path + (k,)): v for k, v in _ffn_specs(node, mesh).items()})
            return
        for k, v in node.items():
            visit(v, path + (str(k),))

    with use_mesh(mesh, layout_overrides(cfg)):
        visit(params, ())
    return out


def rank_params(params, cfg: ModelConfig, mesh):
    """This rank's copy of a params tree: every MoE FFN's router and banks
    sliced by ``param_specs`` (contiguous copies), every other leaf as
    given.  The counterpart of what ``shard_map``'s ``in_specs`` hand the
    reference's bodies."""
    specs = param_specs(params, cfg, mesh)

    def carry(node, path):
        if isinstance(node, dict):
            return {k: carry(v, path + (str(k),)) for k, v in node.items()}
        spec = specs.get("/".join(path))
        if spec is None:
            return node
        return prog.local_slice(node, spec, mesh.shape, mesh.coords).contiguous()

    return carry(params, ())


def _artifact_shard_inputs(params) -> Dict[str, prog.ProgrammedLinear]:
    """This rank's artifacts for the body's projections (the router and the
    banks of ``params``, this rank's slices): a name resolves only to an
    artifact of the local weight's shape, a rank slice.  Names that do
    not resolve are absent; the body notes the gap (a miss, an error under
    strict mode).  (The reference stages the arrays for ``shard_map`` and
    rebinds them inside its body, ``_rebind_rank_artifacts``; a rank
    process holds its slices, so the body binds them under the same
    names.)"""
    out = {}
    for name in ("router", "wi", "wg", "wo"):
        w = params.get(name)
        if w is None:
            continue
        art = _resolve_crossbar_artifact(name, w.shape)[1]
        if art is not None:
            out[name] = art
    return out


def _body(cfg: ModelConfig, mesh, S: int, D: int) -> str:
    """Which of the reference's bodies serves ``cfg`` on ``mesh``:
    "expert_tp", "alltoall", "ep", or "single" (no expert parallelism: every
    rank computes the whole layer).  The expert-TP layout on a mesh it
    cannot split is refused, as its rank slices would not serve any other
    body."""
    E = cfg.moe_experts
    model_size = int(mesh.shape.get("model", 1))
    if _resolve_axis("experts", mesh) is None and cfg.layout != "expert_tp":
        model_size = 1  # layout override: no EP
    if cfg.layout == "expert_tp" and mesh.size > 1:
        if not (
            "data" in mesh.axis_names and model_size > 1 and E % int(mesh.shape["data"]) == 0
            and D % model_size == 0 and cfg.moe_d_ff % model_size == 0
        ):
            raise ValueError(f"{cfg.name}: the expert_tp layout does not split on a mesh of {mesh.shape}")
        return "expert_tp"
    if cfg.moe_dispatch == "alltoall" and model_size > 1 and E % model_size == 0 and S % model_size == 0:
        return "alltoall"
    if model_size == 1 or E % model_size != 0:
        return "single"
    return "ep"


def _batch_split(x: torch.Tensor, mesh):
    """(batch axes, this rank's batch block of x or x whole): the bodies'
    ``x_spec`` puts the batch over ("pod", "data") where it divides."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = mesh.axis_size(batch_axes) if batch_axes else 1
    if dp == 1 or x.shape[0] % dp:
        return (), x
    n = x.shape[0] // dp
    i = mesh.axis_index(batch_axes)
    return batch_axes, x[i * n:(i + 1) * n]


def _block_of(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = x.shape[dim] // mesh.axis_size(axis)
    return x.narrow(dim, mesh.axis_index(axis) * n, n).contiguous()


def _require_local_banks(params, cfg: ModelConfig, n_experts: int, body: str) -> None:
    if params["wi"].shape[0] != n_experts:
        raise ValueError(
            f"{cfg.name}: the {body} body takes this rank's slices ({n_experts} experts), the banks "
            f"hold {params['wi'].shape[0]}: pass rank_params(params, cfg, mesh)"
        )


def _moe_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """Expert parallelism with replicated tokens (the reference's shard_map
    branch of ``moe_ffn``): every rank routes its tokens over all experts,
    computes its own experts' slots, and the partial outputs are ``psum``-ed
    over "model"."""
    B, S, D = x.shape
    k = cfg.moe_top_k
    n_model = int(mesh.shape["model"])
    E_loc = cfg.moe_experts // n_model
    _require_local_banks(params, cfg, E_loc, "ep")
    batch_axes, xl = _batch_split(x, mesh)
    cap = _capacity(xl.shape[0] * S, cfg, E_loc)
    local = _artifact_shard_inputs(params)
    with bind_artifacts(local):
        idx, gates, _ = _route(xl, params["router"], cfg)
        y = _dispatch_compute(
            xl.reshape(-1, D), idx.reshape(-1, k), gates.reshape(-1, k),
            params["wi"], params.get("wg"), params["wo"],
            mesh.coords["model"] * E_loc, cap, cfg.mlp_kind,
        ).reshape(xl.shape)
    y = mesh.psum(y, "model")
    return mesh.all_gather(y, batch_axes, 0) if batch_axes else y


def _moe_alltoall(params, x: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """GShard-style EP: tokens sequence-sharded over "model"; the dispatch
    all-to-all moves only the routed rows (E * cap of them a rank), the
    combine all-to-all brings the expert outputs back."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    n_ranks = int(mesh.shape["model"])
    E_loc = E // n_ranks
    _require_local_banks(params, cfg, E_loc, "alltoall")
    batch_axes, xb = _batch_split(x, mesh)
    xl = _block_of(xb, 1, mesh, "model")
    Bl, Sl, _ = xl.shape
    cap = _capacity(Bl * Sl, cfg, E_loc)
    local = _artifact_shard_inputs(params)
    xf = xl.reshape(-1, D)
    with bind_artifacts(local):
        idx, gates, _ = _route(xl, params["router"], cfg)
        tok_slot, gate_slot, token_slots = slot_tables(idx.reshape(-1, k), gates.reshape(-1, k), E, cap)
        buf = mesh.all_to_all(xf[tok_slot], "model")  # this rank's experts' rows, from every source
        h = buf.reshape(n_ranks, E_loc, cap, D).transpose(0, 1).reshape(E_loc, n_ranks * cap, D)
        out = _expert_ffn(h, params["wi"], params.get("wg"), params["wo"], cfg.mlp_kind)
    out = out.reshape(E_loc, n_ranks, cap, D).transpose(0, 1).reshape(n_ranks * E_loc * cap, D)
    out = mesh.all_to_all(out, "model")
    contrib = out * gate_slot[:, None].to(out.dtype)
    y = combine(contrib.to(xf.dtype), token_slots).reshape(Bl, Sl, D)
    y = mesh.all_gather(y, "model", 1)
    return mesh.all_gather(y, batch_axes, 0) if batch_axes else y


def _moe_expert_tp(params, x: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """Weights-stationary EP (``layout="expert_tp"``): experts over "data",
    the expert FFN's contraction dims over "model".  No weight moves; the
    routed rows cross "data" by all-to-all, and the partial sums of each
    rank's rows of the global chip are added by ``psum`` (router) and
    ``psum_scatter`` (banks) over "model", the paper's inter-tile digital
    reduction at cluster scale."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    n_dr, n_mr = int(mesh.shape["data"]), int(mesh.shape["model"])
    E_dp = E // n_dr
    _require_local_banks(params, cfg, E_dp, "expert_tp")
    batch_axes, xb = _batch_split(x, mesh)
    xl = _block_of(xb, 2, mesh, "model")  # (B_loc, S, D / mr)
    Bl, Sl, Dl = xl.shape
    cap = _capacity(Bl * Sl, cfg, E_dp)
    router = params["router"].to(xl.dtype)
    local = _artifact_shard_inputs(params)
    for n in local:
        # the partial path serves through programmed_linear directly
        # (crossbar_linear cannot pass the colsum), so record consumption here
        prog.record_artifact_consumed(prog.scoped_name(n))

    def partial(xe, we, art):
        # the slice's rows are the rows the global chip programmed; the
        # offset correction takes the *local* rows' column sums, so the sum
        # over ranks of shift_r * colsum_r is the whole correction
        return prog.programmed_linear(xe, art, colsum=torch.sum(we.to(torch.float32), dim=0))

    def bank(h, w_l, name):
        art = local.get(name)
        if art is None:
            note_crossbar_gap(name)
            return torch.einsum("ecd,edf->ecf", h, w_l)
        return torch.stack([partial(h[e], w_l[e], art.layer(e)).to(h.dtype) for e in range(h.shape[0])])

    xf = xl.reshape(-1, Dl)
    if "router" in local:
        part = partial(xf, router, local["router"])
    else:
        note_crossbar_gap("router")
        part = (xf @ router).to(torch.float32)
    logits = mesh.psum(part.to(torch.float32), "model")
    idx, gates, _ = route_from_logits(logits, cfg, xf.dtype)
    tok_slot, gate_slot, token_slots = slot_tables(idx, gates, E, cap)
    buf = mesh.all_to_all(xf[tok_slot], "data")
    h = buf.reshape(n_dr, E_dp, cap, Dl).transpose(0, 1).reshape(E_dp, n_dr * cap, Dl)
    # contraction over the model-sharded D, then psum-scatter onto the
    # model-sharded F: weights never move
    u = mesh.psum_scatter(bank(h, params["wi"], "wi"), "model", 2)
    g = mesh.psum_scatter(bank(h, params["wg"], "wg"), "model", 2) if params.get("wg") is not None else None
    out = bank(_act(u, g, cfg.mlp_kind), params["wo"], "wo")  # partial over F -> full D
    out = mesh.psum_scatter(out, "model", 2)  # (E_dp, slots, D / mr)
    out = out.reshape(E_dp, n_dr, cap, Dl).transpose(0, 1).reshape(n_dr * E_dp * cap, Dl)
    out = mesh.all_to_all(out, "data")
    contrib = out * gate_slot[:, None].to(out.dtype)
    y = combine(contrib.to(xf.dtype), token_slots).reshape(Bl, Sl, Dl)
    y = mesh.all_gather(y, "model", 2)
    return mesh.all_gather(y, batch_axes, 0) if batch_axes else y


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, share: Optional[ExpertShare] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts plus the shared expert.

    Without a mesh: the experts of ``share`` (default: the ambient
    ``current_expert_share()``), whose banks the params must hold.  Under a
    mesh (``layers.use_mesh``): the body ``_body`` selects, on this rank's
    slices (``rank_params``), gathered whole on every rank; a share other
    than the single device is refused there."""
    mesh = current_mesh()
    B, S, D = x.shape
    k = cfg.moe_top_k
    share = current_expert_share() if share is None else share
    body = "single" if mesh is None else _body(cfg, mesh, S, D)
    if mesh is not None and share != SINGLE_DEVICE:
        raise ValueError(f"an ExpertShare ({share}) and a mesh do not combine: the mesh's ranks hold the experts")
    if body == "expert_tp":
        y = _moe_expert_tp(params, x, cfg, mesh)
    elif body == "alltoall":
        y = _moe_alltoall(params, x, cfg, mesh)
    elif body == "ep":
        y = _moe_ep(params, x, cfg, mesh)
    else:
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
