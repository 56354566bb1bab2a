"""Fault-aware spare-column repair of programmed crossbar slabs (counterpart
of ``repro.device.repair``).

Stuck-at cells, not programming variation, dominate a real array's accuracy
loss.  The datapath is column-separable (one bitline = one output), so each
128-column group is provisioned ``DeviceConfig.spare_cols`` redundant
columns, and at programming time the worst fault-afflicted columns are
remapped into them:

* ``column_salience`` — each column's stuck-cell code error weighted by
  bit-slice significance ``2**(s * cell_bits)``.
* ``plan_repair`` — a greedy (victim, spare) assignment per physical
  crossbar: every (bit-slice, row group) of a slab is its own 128-row array
  whose output mux picks primary or spare independently, so each such
  *unit* is matched on its own, and a spare serves only columns of its own
  group.  Each of ``spare_cols`` steps moves the pair with the largest
  strict gain.  Spares draw their own fault field (``STAGE_SPARE_FAULTS``),
  so a faulty spare is never trusted blindly.  The reference runs one
  ``fori_loop`` per group, vmapped over the units; here the units of every
  group of equal width form one batch (chunked to bound memory) and the
  loop steps the whole batch at once — a Python loop over the 384 groups of
  a 49152-wide head would be launch-bound on the card.  The choices are
  exact: per-unit errors and gains are integers below 2**24, and
  ``torch.argmax`` takes the first maximum of the flattened (spare, column)
  gain, as ``jnp.argmax`` does.
* spare programming — the victims' targets are written into the spare block
  through the same write-verify pulses as primary cells (stage
  ``STAGE_SPARE_PROGRAM``) and read back at each group's wordline position.
* ``apply_repair`` — scatter the spare cells into the victim positions: the
  repaired ``(S, K, N)`` layout every kernel consumes unchanged.

Primary columns are programmed exactly as without repair, so a zero-fault
config with a budget is bit-identical to the unrepaired chip.  Random fields
are injectable (``u_spare=``, ``z_spare_pulses=``) as the primary stages'
are (``u=``, ``z_pulses=``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.device import models as dm

# most elements of one batch's (units, spares, columns) gain tensor: the
# batch of units is cut into chunks of at most this many
_GAIN_ELEMS = 1 << 26


def spare_budget(n_cols: int, spec: CrossbarSpec, cfg: dm.DeviceConfig) -> int:
    """Spare columns available to one (K, N) slab: ``cfg.spare_cols`` per
    ``spec.cols``-wide column group it spans (each budget group-local)."""
    return int(cfg.spare_cols) * max(1, -(-n_cols // spec.cols))


def _slice_weights(spec: CrossbarSpec, device=None) -> torch.Tensor:
    """(S,) bit-slice significance: slice s carries 2**(s * cell_bits)."""
    return torch.tensor(
        [float(1 << (spec.cell_bits * s)) for s in range(spec.n_slices)], dtype=torch.float32, device=device
    )


def column_salience(
    target: torch.Tensor,
    masks: Tuple[torch.Tensor, torch.Tensor],
    spec: CrossbarSpec,
) -> torch.Tensor:
    """(N,) float32 significance-weighted |stuck value - target| each
    column's hard faults inflict (stuck-on installs ``cell_max``, stuck-off
    0).  ``target``: (S, K, N) ideal cell codes."""
    stuck_on, stuck_off = masks
    cell_max = float((1 << spec.cell_bits) - 1)
    target = target.to(torch.float32)
    w = _slice_weights(spec, target.device)[:, None, None]
    err = torch.where(stuck_on, (cell_max - target) * w, 0.0)
    err = err + torch.where(stuck_off, target * w, 0.0)
    return torch.sum(err, dim=(0, 1))


def _unit_view(a: torch.Tensor, rows: int) -> torch.Tensor:
    """(S, K, X) -> (S, R, rows, X) physical-crossbar units; a partial last
    row group is zero-padded (target 0, no faults: no salience)."""
    S, K, X = a.shape
    R = -(-K // rows)
    pad = R * rows - K
    if pad:
        a = torch.cat([a, torch.zeros((S, pad, X), dtype=a.dtype, device=a.device)], dim=1)
    return a.reshape(S, R, rows, X)


def _unit_fault_error(
    target_u: torch.Tensor,
    masks_u: Tuple[torch.Tensor, torch.Tensor],
    spec: CrossbarSpec,
) -> torch.Tensor:
    """(S, R, N) unweighted per-unit fault error: the total |stuck - target|
    each physical column's hard faults inflict."""
    cell_max = float((1 << spec.cell_bits) - 1)
    err = torch.where(masks_u[0], cell_max - target_u, 0.0)
    err = err + torch.where(masks_u[1], target_u, 0.0)
    return torch.sum(err, dim=2)


@dataclasses.dataclass
class RepairPlan:
    """One slab's spare-column repair, per physical crossbar.

    ``victim``: (S, R, B) int32, the logical column whose (s, r) unit each
    spare holds, -1 unused.  ``out_gather``: (S, R, N) int32, the physical
    column serving each logical output of that array (j, or N + b).
    ``g_spare``: (S, K, B) float32 effective cells of the programmed spare
    block (unused slots read back their own faults: detect them by
    ``victim == -1``).  ``rows``: the unit height.  Saliences: (N,)
    ``column_salience`` units before and after."""

    victim: torch.Tensor
    out_gather: torch.Tensor
    g_spare: torch.Tensor
    salience_before: torch.Tensor
    salience_after: torch.Tensor
    rows: int = 128


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """Host-side summary of a ``RepairPlan``: ``budget`` and ``n_repaired``
    count (slice, row group, spare) unit slots; ``repaired_cols`` the sorted
    logical columns with at least one repaired unit."""

    budget: int
    n_repaired: int
    repaired_cols: Tuple[int, ...]
    salience_before: float
    salience_after: float

    @property
    def recovered_frac(self) -> float:
        """Fraction of planner-model salience removed by the repair."""
        if self.salience_before <= 0.0:
            return 0.0
        return 1.0 - self.salience_after / self.salience_before


def _greedy_assign(sal0: torch.Tensor, err_sp: torch.Tensor):
    """Greedy (victim, spare) assignment of a batch of units, each within one
    column group.  ``sal0``: (U, n) per-unit fault error of each column;
    ``err_sp``: (U, B, n) error of spare b holding column v's targets.

    Each of the ``B`` steps moves, in every unit, the pair with the largest
    gain if it strictly improves; a repaired column is never displaced to a
    second spare (the reference's argument: the available set only
    shrinks).  Once no unit improves, no later step can, and the loop ends.
    Returns (salience after (U, n), victim (U, B), gather (U, n)) with local
    indices, gather >= n meaning spare ``gather - n``."""
    U, B, n = err_sp.shape
    dev = err_sp.device
    sal = sal0.clone()
    victim = torch.full((U, B), -1, dtype=torch.int32, device=dev)
    gather = torch.arange(n, dtype=torch.int32, device=dev).expand(U, n).clone()
    avail = torch.ones((U, B), dtype=torch.bool, device=dev)
    rows = torch.arange(U, device=dev)
    for _ in range(B):
        gain = torch.where(avail[:, :, None], sal[:, None, :] - err_sp, float("-inf")).reshape(U, B * n)
        flat = torch.argmax(gain, dim=1)  # the first maximum, as jnp.argmax
        do = gain[rows, flat] > 0.0
        if not bool(do.any()):
            break
        b, j = flat // n, flat % n
        victim[rows, b] = torch.where(do, j.to(torch.int32), victim[rows, b])
        gather[rows, j] = torch.where(do, (n + b).to(torch.int32), gather[rows, j])
        sal[rows, j] = torch.where(do, err_sp[rows, b, j], sal[rows, j])
        avail[rows, b] = avail[rows, b] & ~do
    return sal, victim, gather


def _assign_groups(t_u, on_sp, off_sp, units0, spec, n0, n_g, n_grp, b0, B_per, out):
    """Run the greedy for ``n_grp`` consecutive groups of width ``n_g``
    starting at column ``n0`` (spares from ``b0``), writing the victim /
    gather / salience tables of ``out`` in place."""
    S, R, rows, N = t_u.shape
    victim, gather, units = out
    cell_max = float((1 << spec.cell_bits) - 1)
    per_group = S * R * B_per * n_g
    step = max(1, _GAIN_ELEMS // max(1, per_group))
    for g0 in range(0, n_grp, step):
        g1 = min(n_grp, g0 + step)
        gs = g1 - g0
        c0, c1 = n0 + g0 * n_g, n0 + g1 * n_g
        s0, s1 = b0 + g0 * B_per, b0 + g1 * B_per
        t_g = t_u[..., c0:c1].reshape(S, R, rows, gs, n_g)
        on_g = on_sp[..., s0:s1].reshape(S, R, rows, gs, B_per)
        off_g = off_sp[..., s0:s1].reshape(S, R, rows, gs, B_per)
        # err_sp[s, r, g, b, v]: fault error of spare b's (s, r) unit holding
        # column v's targets (integers <= 3 * rows: exact in float32)
        err_sp = torch.einsum("srkgb,srkgv->srgbv", on_g, cell_max - t_g) + torch.einsum(
            "srkgb,srkgv->srgbv", off_g, t_g
        )
        sal0 = units0[..., c0:c1].reshape(S, R, gs, n_g)
        sal_u, victim_u, gather_u = _greedy_assign(
            sal0.reshape(-1, n_g), err_sp.reshape(-1, B_per, n_g)
        )
        col0 = (
            n0 + torch.arange(g0, g1, device=t_u.device, dtype=torch.int32) * n_g
        ).reshape(1, 1, gs, 1)
        spare0 = (
            b0 + torch.arange(g0, g1, device=t_u.device, dtype=torch.int32) * B_per
        ).reshape(1, 1, gs, 1)
        victim_u = victim_u.reshape(S, R, gs, B_per)
        gather_u = gather_u.reshape(S, R, gs, n_g)
        victim[..., s0:s1] = torch.where(victim_u >= 0, victim_u + col0, -1).reshape(S, R, gs * B_per)
        gather[..., c0:c1] = torch.where(
            gather_u >= n_g, gather_u - n_g + N + spare0, gather_u + col0
        ).reshape(S, R, gs * n_g)
        units[..., c0:c1] = sal_u.reshape(S, R, gs * n_g)


def plan_repair(
    w_codes_biased: torch.Tensor,
    spec: CrossbarSpec,
    cfg: dm.DeviceConfig,
    *,
    target: Optional[torch.Tensor] = None,
    tag: Optional[int] = None,
    primary_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    u_spare: Optional[torch.Tensor] = None,
    z_spare_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> Optional[RepairPlan]:
    """Plan and program one slab's spare-column repair; None when the config
    provisions none (``models.wants_repair``).

    ``target`` / ``tag`` / ``primary_masks`` hand over the programming
    pipeline's intermediates (they must be what it derives from
    ``w_codes_biased``); ``u_spare`` / ``z_spare_pulses`` inject the spare
    block's fault field and write pulses.
    """
    if not dm.wants_repair(cfg):
        return None
    if target is None:
        target = dm.target_cell_codes(w_codes_biased, spec)
    target = target.to(torch.float32)
    S, K, N = target.shape
    dev = target.device
    R = -(-K // spec.rows)
    B_per = int(cfg.spare_cols)
    B = spare_budget(N, spec, cfg)
    n_groups = B // B_per
    if tag is None:
        tag = dm.slab_tag(w_codes_biased)
    if primary_masks is None:
        primary_masks = dm.fault_masks(cfg, (S, K, N), tag, device=dev)
    spare_masks = dm.fault_masks(cfg, (S, K, B), tag, stage=dm.STAGE_SPARE_FAULTS, u=u_spare, device=dev)

    t_u = _unit_view(target, spec.rows)  # (S, R, rows, N)
    units0 = _unit_fault_error(
        t_u, (_unit_view(primary_masks[0], spec.rows), _unit_view(primary_masks[1], spec.rows)), spec
    )  # (S, R, N)
    on_sp = _unit_view(spare_masks[0].to(torch.float32), spec.rows)  # (S, R, rows, B)
    off_sp = _unit_view(spare_masks[1].to(torch.float32), spec.rows)

    sal0 = column_salience(target, primary_masks, spec)
    victim = torch.full((S, R, B), -1, dtype=torch.int32, device=dev)
    gather = torch.arange(N, dtype=torch.int32, device=dev).expand(S, R, N).clone()
    units = units0.clone()
    out = (victim, gather, units)
    full = N // spec.cols  # groups of the full width; the last may be partial
    if full:
        _assign_groups(t_u, on_sp, off_sp, units0, spec, 0, spec.cols, full, 0, B_per, out)
    if full < n_groups:
        _assign_groups(
            t_u, on_sp, off_sp, units0, spec, full * spec.cols, N - full * spec.cols, 1,
            full * B_per, B_per, out,
        )

    # program each spare's (s, r) unit with its victim's targets through the
    # write-verify pulses of its own stage, then read the block back at each
    # group's wordline position (just past the group's data columns)
    idx = torch.clamp(victim, 0, N - 1).to(torch.int64)[:, :, None, :].expand(S, R, spec.rows, B)
    vt = torch.gather(t_u, 3, idx)
    vt = torch.where((victim >= 0)[:, :, None, :], vt, 0.0)
    spare_target = vt.reshape(S, R * spec.rows, B)[:, :K, :]
    g = dm.write_verify_fixed(
        spare_target, spare_masks, spec, cfg, tag, stage=dm.STAGE_SPARE_PROGRAM, z_pulses=z_spare_pulses
    )
    if cfg.r_line_ohm == 0.0:
        # the read path is column-independent without line resistance
        g_spare = dm.read_effective_codes(g, spec, cfg)
    else:
        g_spare = torch.cat([
            dm.read_effective_codes(
                g[:, :, gi * B_per:(gi + 1) * B_per], spec, cfg, col_offset=min((gi + 1) * spec.cols, N)
            )
            for gi in range(n_groups)
        ], dim=2)

    w = _slice_weights(spec, dev)
    return RepairPlan(
        victim=victim,
        out_gather=gather,
        g_spare=g_spare,
        salience_before=sal0,
        salience_after=torch.sum(units * w[:, None, None], dim=(0, 1)),
        rows=int(spec.rows),
    )


def apply_repair(g_eff_primary: torch.Tensor, plan: Optional[RepairPlan]) -> torch.Tensor:
    """Scatter programmed spare cells into victim positions: the repaired
    (S, K, N) layout, equal to running the physical (S, K, N + B) layout and
    gathering each unit's outputs through ``plan.out_gather`` before the
    digital merge (column separability per physical crossbar)."""
    if plan is None:
        return g_eff_primary
    S, K, N = g_eff_primary.shape
    R = plan.out_gather.shape[1]
    g_full = torch.cat([g_eff_primary, plan.g_spare], dim=2)
    rg = torch.clamp(torch.arange(K, device=g_full.device) // plan.rows, max=R - 1)
    idx = plan.out_gather[:, rg, :].to(torch.int64)  # (S, K, N): per row of cells
    return torch.gather(g_full, 2, idx)


def repaired_effective_cells(
    w_codes_biased: torch.Tensor,
    spec: CrossbarSpec,
    cfg: dm.DeviceConfig,
    *,
    with_report: bool = False,
    u: Optional[torch.Tensor] = None,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
    u_spare: Optional[torch.Tensor] = None,
    z_spare_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[RepairPlan], Optional[Any]]:
    """Program + repair in one pass: (repaired g_eff, plan, report).

    The single site that derives the programming intermediates (target
    slices, slab tag, primary fault draw) and hands them to the repair
    planner.  ``with_report=True`` programs through ``program.write_verify``
    (the same pulses, bit-identical cells) and returns its
    ``ProgramReport``; otherwise the report is None."""
    if with_report:
        from repro_torch.device.program import write_verify  # program imports this package

        target = dm.target_cell_codes(w_codes_biased, spec)
        tag = dm.slab_tag(w_codes_biased)
        masks = dm.fault_masks(cfg, tuple(target.shape), tag, u=u, device=target.device)
        g, report = write_verify(
            w_codes_biased, spec, cfg, target=target, tag=tag, masks=masks, z_pulses=z_pulses
        )
        g_eff = dm.read_effective_codes(g, spec, cfg)
    else:
        g_eff, target, tag, masks = dm.programmed_effective(w_codes_biased, spec, cfg, u=u, z_pulses=z_pulses)
        report = None
    rplan = plan_repair(
        w_codes_biased, spec, cfg, target=target, tag=tag, primary_masks=masks,
        u_spare=u_spare, z_spare_pulses=z_spare_pulses,
    )
    return apply_repair(g_eff, rplan), rplan, report


def repair_report(plan: Optional[RepairPlan]) -> Optional[RepairReport]:
    """The host-side summary (programming time: the plan's tensors are
    copied to the host)."""
    if plan is None:
        return None
    victim = plan.victim.cpu().numpy()
    return RepairReport(
        budget=int(victim.size),
        n_repaired=int((victim >= 0).sum()),
        repaired_cols=tuple(int(v) for v in np.unique(victim[victim >= 0])),
        salience_before=float(plan.salience_before.cpu().numpy().sum()),
        salience_after=float(plan.salience_after.cpu().numpy().sum()),
    )
