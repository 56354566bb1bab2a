"""Workload -> tile/IMA/crossbar mapping (paper §III.B, Figs 6, 7, 10, 15).

Two policies:

* ``"isaac"`` — the baseline: no constraints; IMAs may be shared by layers
  (dense packing, high crossbar utilization) but the HTree and eDRAM are
  provisioned for the worst case (64 KB buffers, wide private links).
* ``"newton"`` — constrained mapping: an IMA serves exactly one layer with at
  most 128 inputs; replicas are co-located so input buffers are shared
  (Fig 6d); every layer is finely spread across many tiles so each tile
  inherits the buffering efficiency of early layers (Fig 7b).

Replication (both policies, ISAAC §"pipeline balancing"): early conv layers
produce more pixels than later ones; layer ``l`` is replicated
``ceil(pixels_l / pixels_min)`` times so the inter-tile pipeline is balanced
and throughput is set by the least-replicated layer.

Fault-aware provisioning: both policies accept a per-crossbar spare-column
budget (``spare_cols``, or derived from a stuck-cell ``fault_rate`` via
``provision_spare_cols``).  The spare-placement model is **shared with
``device.repair``**: every 128-column group keeps its full data width and
a block of ``spare_cols`` redundant columns is appended past it (the
classic memory-redundancy layout — extra physical bitlines beyond the
addressable array, reachable only through the column mux).  Spares are
allocated-but-unmappable cells: layer columns never land in them, so the
group fan-out is spare-independent, but every allocated crossbar grows by
``rows x spare_cols`` cells per slice — deflating ``used_cells_frac`` /
the Fig-10 underutilization accounting, which is exactly the provisioning
cost the repair capability is bought with.

A copy of ``repro.core.mapper`` (which imports no JAX) on the port's own
core modules; its results equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.arch import ChipConfig, IMAConfig, TileConfig
from repro_torch.core.crossbar import CrossbarSpec
from repro_torch.core.workloads import Layer, Network

BYTES_PER_VAL = 2  # 16-bit fixed point


def provision_spare_cols(
    fault_rate: float, spec: CrossbarSpec, coverage: float = 1.0
) -> int:
    """Spare columns per crossbar for a stuck-cell rate (provisioning rule).

    Repair operates per physical column unit (one bit-slice x row-group
    crossbar column of ``spec.rows`` cells — ``device.repair``); the
    expected fraction of afflicted units is ``frac = 1 - (1 - p)**rows``.
    Spares draw faults at the same rate, so only ``1 - frac`` of the pool
    is clean: the budget that covers the victims is ``cols * frac``
    *discounted by the usable-spare fraction*, ``cols * frac / (1 - frac)``
    — at p = 1e-2 that self-fault correction is the difference between a
    pool that structurally cannot reach the >= 97% recovery bar and one
    that does (BENCH kernel_repaired).  ``coverage`` scales the budget
    (< 1 repairs only the worst offenders, > 1 over-provisions further).
    Capped at twice the crossbar width (the widest per-group output mux we
    model).

    The budget is provisioned per column group in the same layout
    ``device.repair.spare_budget`` consumes: ``spare_cols`` redundant
    columns appended past each group's ``spec.cols`` data columns, so a
    slab spanning ``ceil(N / spec.cols)`` groups owns exactly the spares
    the repair planner will assign (pinned cross-module in
    tests/test_repair.py).
    """
    if fault_rate <= 0.0 or coverage <= 0.0:
        return 0
    frac = 1.0 - (1.0 - fault_rate) ** spec.rows
    usable = max(1.0 - frac, 1.0 / (2.0 * spec.cols))  # cap binds anyway
    return min(2 * spec.cols, math.ceil(spec.cols * frac / usable * coverage))


@dataclasses.dataclass
class LayerMapping:
    layer: Layer
    replication: int
    row_groups: int  # ceil(rows / ima.rows)
    col_groups: int  # ceil(cols / ima.out_cols)
    imas: int  # total IMA instances allocated (grid x replication)
    crossbars: int  # physical crossbars allocated
    used_cells_frac: float  # crossbar utilization (Fig 10)
    tiles: int  # distinct tiles this layer spans
    buffer_bytes_per_tile: float  # input-buffer share per tile (Fig 15)

    @property
    def wasted_frac(self) -> float:
        return 1.0 - self.used_cells_frac


@dataclasses.dataclass
class MappingReport:
    network: str
    policy: str
    layers: List[LayerMapping]
    conv_tiles: int
    fc_tiles: int
    chips: int
    throughput_samples_s: float
    worst_tile_buffer_bytes: float
    mean_tile_buffer_bytes: float
    crossbar_underutilization: float  # weighted average (Fig 10)
    inter_tile_bytes_per_sample: float
    spare_cols: int = 0  # repair columns provisioned per crossbar
    spare_cells_frac: float = 0.0  # fraction of allocated cells held spare

    @property
    def total_tiles(self) -> int:
        return self.conv_tiles + self.fc_tiles


def _layer_grid(layer: Layer, ima: IMAConfig, policy: str):
    rg = -(-layer.rows // ima.rows)
    cg = -(-layer.cols // ima.out_cols)
    return rg, cg


def map_network(
    net: Network,
    chip: ChipConfig,
    policy: str = "newton",
    pixels_ref: Optional[int] = None,
    max_replication: int = 1 << 30,
    spare_cols: int = 0,
    fault_rate: Optional[float] = None,
) -> MappingReport:
    """Map ``net`` onto ``chip`` under the given policy.

    ``spare_cols`` appends repair columns past every crossbar column group
    (the ``device.repair`` layout: data width stays ``spec.cols``, spares
    are extra unmappable cells); alternatively pass a stuck-cell
    ``fault_rate`` and the budget is derived via ``provision_spare_cols``.
    Spares grow every allocated crossbar by ``rows x spare_cols`` cells per
    slice and count as allocated-but-unused in ``used_cells_frac`` — the
    Fig-10 accounting then shows the fault-tolerance provisioning cost
    directly, while group fan-out (hence ``crossbars`` and IMA counts)
    matches the unprovisioned mapping and the repair planner's
    ``spare_budget`` group arithmetic.
    """
    ima = chip.conv_tile.ima
    if fault_rate is not None and spare_cols == 0:
        spare_cols = provision_spare_cols(fault_rate, ima.xbar_spec)
    # physical column-group width: cols data + spare_cols appended repair
    # columns (shared layout with device.repair.spare_budget — deliberately
    # uncapped here so an explicit budget is accounted exactly as the
    # repair planner will program it; provision_spare_cols caps its own
    # derived budgets at the crossbar width)
    group_width = ima.xbar_spec.cols + spare_cols
    conv = net.conv_layers()
    fc = net.fc_layers()

    # --- replication for pipeline balance (throughput set by pixels_ref) ---
    if pixels_ref is None:
        pixels_ref = min((l.pixels for l in conv), default=1)
    # FC tiles run their ADCs `slowdown` x slower (T5); to keep the FC layer
    # off the critical path (paper: "none of these configurations lower the
    # throughput"), FC IMAs are replicated when one slowed VMM would exceed
    # the image period.
    fc_cfg_tile = chip.fc_tile or chip.conv_tile
    fc_repl = max(1, -(-int(fc_cfg_tile.adc_slowdown) // max(1, pixels_ref)))
    mapped: List[LayerMapping] = []
    for layer in net.layers:
        rg, cg = _layer_grid(layer, ima, policy)
        if layer.kind == "conv":
            repl = min(max_replication, max(1, -(-layer.pixels // pixels_ref)))
        else:
            repl = fc_repl
        grid_imas = rg * cg
        imas = grid_imas * repl

        if policy == "isaac":
            # Unconstrained: partial row/col groups of different layers can
            # share an IMA; utilization ~ full but account fragmentation at
            # crossbar granularity.  Layer columns map into each group's
            # full ``cols`` data width; the appended spare block is bought
            # physical cells that are never mappable.
            used = layer.rows * layer.cols
            alloc_xbars = (
                math.ceil(used / (ima.rows * ima.xbar_spec.cols))
                * ima.xbar_spec.n_slices
            )
            alloc_cells = alloc_xbars / ima.xbar_spec.n_slices * ima.rows * group_width
            util = used / alloc_cells
            crossbars = alloc_xbars * repl
            tiles_span = max(1, math.ceil(imas / chip.conv_tile.imas))
        else:
            # Constrained: an IMA belongs to one layer, but the embedded
            # HTree shift-and-add lets multiple *row groups of the same
            # layer* occupy its column slots (partials reduced in-tree), so
            # allocation granularity is a 128x128 crossbar-column slot —
            # each slot's physical array is ``group_width`` wide when repair
            # spares are provisioned (data columns + appended spare block).
            slots_per_ima = max(1, ima.out_cols // ima.xbar_spec.cols)
            slots = rg * -(-layer.cols // ima.xbar_spec.cols) * repl
            imas = -(-slots // slots_per_ima)
            grid_imas = -(-slots // (repl * slots_per_ima))
            used = layer.rows * layer.cols
            alloc_cells = (slots // repl) * ima.rows * group_width
            util = min(1.0, used / alloc_cells)
            crossbars = slots * ima.xbar_spec.n_slices
            tiles_span = max(1, math.ceil(imas / chip.conv_tile.imas))

        # --- input buffering (Figs 6, 7) ---
        if layer.kind == "conv":
            # steady-state sliding window: ky rows of the input feature map
            row_bytes = layer.ky * layer.in_hw * layer.cin * BYTES_PER_VAL
            if policy == "newton":
                # replicas co-located => buffer NOT multiplied by replication;
                # layer spread across its distinct tiles shares the buffer.
                distinct = max(1, math.ceil(grid_imas / chip.conv_tile.imas))
                # replication spreads ADDITIONAL tiles but shares inputs
                span = max(distinct, math.ceil(imas / chip.conv_tile.imas))
                buf_per_tile = row_bytes / span
            else:
                # ISAAC: replicas may land on different tiles with private
                # buffers; per-tile need is the full window of its layer.
                buf_per_tile = row_bytes / max(1, math.ceil(grid_imas / chip.conv_tile.imas))
        else:
            buf_per_tile = layer.rows * BYTES_PER_VAL / max(
                1, math.ceil(imas / chip.conv_tile.imas)
            )
        mapped.append(
            LayerMapping(
                layer=layer,
                replication=repl,
                row_groups=rg,
                col_groups=cg,
                imas=imas,
                crossbars=crossbars,
                used_cells_frac=util,
                tiles=tiles_span,
                buffer_bytes_per_tile=buf_per_tile,
            )
        )

    conv_imas = sum(m.imas for m in mapped if m.layer.kind == "conv")
    fc_imas = sum(m.imas for m in mapped if m.layer.kind == "fc")
    conv_tiles = max(1, math.ceil(conv_imas / chip.conv_tile.imas))
    fc_tile_cfg = chip.fc_tile or chip.conv_tile
    fc_tiles = max(0, math.ceil(fc_imas / fc_tile_cfg.imas)) if fc_imas else 0

    n_conv_cap, n_fc_cap = chip.tile_counts()
    if n_fc_cap == 0:
        chips = math.ceil((conv_tiles + fc_tiles) / max(1, chip.tiles))
    else:
        chips = max(
            math.ceil(conv_tiles / max(1, n_conv_cap)),
            math.ceil(fc_tiles / max(1, n_fc_cap)),
        )

    # --- throughput (deterministic pipeline, §IV) ---
    # FC replication above keeps the slowed FC VMMs off the critical path.
    vmm_t = ima.vmm_time_s
    throughput = 1.0 / (pixels_ref * vmm_t)

    # --- buffers ---
    per_layer_buf = [m.buffer_bytes_per_tile for m in mapped if m.layer.kind == "conv"]
    if policy == "newton":
        # Fig 7b: layers are striped across tiles; each tile hosts slices of
        # adjacent layers, so the requirement approaches the mean.
        total_buf = sum(
            m.buffer_bytes_per_tile * m.tiles for m in mapped if m.layer.kind == "conv"
        )
        mean_buf = total_buf / max(1, conv_tiles)
        worst_buf = max(per_layer_buf, default=0.0)
        worst_buf = min(worst_buf, 2 * mean_buf) if per_layer_buf else 0.0
    else:
        mean_buf = sum(per_layer_buf) / max(1, len(per_layer_buf))
        worst_buf = max(per_layer_buf, default=0.0)

    # --- inter-tile traffic: every layer's outputs travel to the next ---
    traffic = sum(l.pixels * l.cols * BYTES_PER_VAL for l in net.layers)
    under = 1.0 - (
        sum(m.used_cells_frac * m.crossbars for m in mapped)
        / max(1, sum(m.crossbars for m in mapped))
    )

    return MappingReport(
        network=net.name,
        policy=policy,
        layers=mapped,
        conv_tiles=conv_tiles,
        fc_tiles=fc_tiles,
        chips=chips,
        throughput_samples_s=throughput,
        worst_tile_buffer_bytes=worst_buf,
        mean_tile_buffer_bytes=mean_buf,
        crossbar_underutilization=under,
        inter_tile_bytes_per_sample=traffic,
        spare_cols=spare_cols,
        spare_cells_frac=spare_cols / group_width,
    )


def fault_provision_sweep(
    nets: List[Network], chip: ChipConfig, fault_rates: List[float], policy: str = "newton"
):
    """Fig-10 accounting extended with repair provisioning: average crossbar
    under-utilization vs stuck-cell fault rate (spares via
    ``provision_spare_cols``)."""
    out: Dict[str, float] = {}
    for p in fault_rates:
        vals = [
            map_network(n, chip, policy=policy, fault_rate=p).crossbar_underutilization
            for n in nets
        ]
        out[f"{p:g}"] = sum(vals) / len(vals)
    return out


def underutilization_sweep(nets: List[Network], ima_sizes: List[tuple], chip: ChipConfig):
    """Fig 10: average crossbar under-utilization vs IMA (rows x out_cols)."""
    import dataclasses as dc

    out: Dict[str, float] = {}
    for rows, cols in ima_sizes:
        ima = dc.replace(chip.conv_tile.ima, rows=rows, out_cols=cols)
        tile = dc.replace(chip.conv_tile, ima=ima)
        c = dc.replace(chip, conv_tile=tile)
        vals = [map_network(n, c, policy="newton").crossbar_underutilization for n in nets]
        out[f"{rows}x{cols}"] = sum(vals) / len(vals)
    return out
