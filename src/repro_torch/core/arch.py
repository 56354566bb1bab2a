"""Machine description for ISAAC/Newton accelerators (paper Table I + §IV).

The hierarchy is chip -> tile -> IMA -> crossbar.  Component unit costs come
from Newton's Table I; components Newton does not re-list (eDRAM, buses,
registers, shift-and-add, sigmoid/pool) use the ISAAC ISCA'16 table at the
same 32 nm node, which Newton's methodology section says it shares.

Anchors used for validation (see tests/test_energy_model.py):
  * ISAAC peak computational efficiency ~ 479 GOPS/(s mm^2), power
    efficiency ~ 644 GOPS/W (ISAAC paper, reproduced in Newton Fig 20).
  * ADC ~ 49% of ISAAC chip power (Newton §V).
  * Average ISAAC op ~ 1.8 pJ; Newton op ~ 0.85 pJ; ideal neuron 0.33 pJ.

A copy of ``repro.core.arch`` (which imports no JAX) on the port's own
core modules; its results equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.adc import ADCConfig, SARModel, adaptive_schedule, DEFAULT_SAR
from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC


@dataclasses.dataclass(frozen=True)
class Component:
    """A leaf hardware component with peak power and area."""

    name: str
    power_w: float
    area_mm2: float


# --- Table I (Newton) ------------------------------------------------------
ROUTER = Component("router", 168e-3, 0.604)  # 32 flits, 8 ports; shared by 4 tiles
ADC_8B = Component("adc", 3.1e-3, 0.0015)  # 8-bit @ 1.28 GS/s (Kull [18])
HYPER_TRANSPORT = Component("hyper_transport", 10.4, 22.88)  # 4 links, 6.4 GB/s
DAC_ARRAY_128 = Component("dac_array", 0.5e-3, 0.00002)  # 128 x 1-bit
CROSSBAR_128 = Component("crossbar", 0.3e-3, 0.0001)  # 128x128 memristor array

# --- ISAAC ISCA'16 tile components (same 32 nm CACTI/Orion methodology) ----
EDRAM_64KB = Component("edram_64k", 20.7e-3, 0.083)
EDRAM_BUS = Component("edram_bus", 7e-3, 0.090)
SIGMOID = Component("sigmoid", 0.52e-3, 0.0006)
SHIFT_ADD_TILE = Component("s+a_tile", 0.05e-3, 0.00006)
MAXPOOL = Component("maxpool", 0.4e-3, 0.00024)
TILE_OR = Component("tile_or", 1.68e-3, 0.0032)
IMA_IR = Component("ima_ir", 1.24e-3, 0.0021)  # 2 KB input register
IMA_OR = Component("ima_or", 0.23e-3, 0.00077)
IMA_SA = Component("ima_s+a", 0.2e-3, 0.00024)
SAMPLE_HOLD = Component("s+h", 0.01e-3, 0.00004)


def edram_component(kb: float) -> Component:
    """eDRAM buffer scaled from the 64 KB CACTI point.

    Small buffers keep a fixed periphery overhead; we use a 15% floor plus
    linear banking, which reproduces ISAAC's 64 KB point exactly and gives
    16 KB ~ 0.33x power/area (consistent with Newton Fig 16's ~6.5% area
    efficiency gain at chip level).
    """
    f = kb / 64.0
    scale = 0.15 + 0.85 * f
    return Component(f"edram_{kb:g}k", EDRAM_64KB.power_w * scale, EDRAM_64KB.area_mm2 * scale)


def htree_component(n_leaves: int, out_width_bits: int, shared_inputs: bool) -> Component:
    """Input/output HTree of an IMA.

    Parametric wire model: area/power scale with (leaf count) x (link width).
    The paper's central T1 observation is that ISAAC's HTree is provisioned
    for the *worst case* — every crossbar may serve a different layer, so
    input wiring cannot be shared along the tree (2x input links), and every
    output link carries full 39-bit partials privately to the IMA output
    register.  Newton constrains an IMA to one layer / <=128 shared inputs
    and embeds shift-and-add units at HTree junctions, so input links are
    shared and output links carry reduced partials (~23 bits mean; 16 bits
    once the adaptive ADC clamps the window).

    Unit costs are calibrated once against the paper's own T1 measurement
    (+37% area efficiency, +18% power/energy efficiency — Fig 11) and held
    fixed for every other configuration; see tests/test_energy_model.py.
    """
    unit_area = 2.65e-5  # mm^2 per leaf-bit (calibrated, see above)
    unit_power = 9.0e-6  # W per leaf-bit
    in_bits = 16 * (2.0 if not shared_inputs else 1.0)  # input stream links
    leaf_bits = n_leaves * (out_width_bits + in_bits)
    return Component("htree", unit_power * leaf_bits, unit_area * leaf_bits)


@dataclasses.dataclass(frozen=True)
class IMAConfig:
    """An In-situ Multiply-Accumulate unit."""

    name: str
    crossbars: int = 8  # physical 128x128 arrays
    rows: int = 128  # inputs processed per VMM
    out_cols: int = 128  # output neurons per VMM
    adcs: int = 8
    adc_rate: float = 1.28e9  # samples/s
    adc_cfg: ADCConfig = ADCConfig(mode="full")
    xbar_spec: CrossbarSpec = DEFAULT_SPEC
    compact_htree: bool = False  # Newton T1
    karatsuba_levels: int = 0  # Newton T3 (crossbar count grows per Fig 9)
    sar: SARModel = DEFAULT_SAR

    @property
    def weights_per_ima(self) -> int:
        return self.rows * self.out_cols

    @property
    def n_slices(self) -> int:
        return self.xbar_spec.n_slices

    @property
    def iters_per_vmm(self) -> int:
        if self.karatsuba_levels == 0:
            return self.xbar_spec.n_iters
        from repro_torch.core.karatsuba import karatsuba_cost

        return karatsuba_cost(self.karatsuba_levels, self.xbar_spec).iterations

    @property
    def vmm_time_s(self) -> float:
        return self.iters_per_vmm * 100e-9

    @property
    def macs_per_vmm(self) -> int:
        return self.rows * self.out_cols

    def adc_mean_power_w(self) -> float:
        """Mean ADC power across a VMM under the configured schedule.

        The energy schedule follows the paper's Fig-5 (unsigned) example;
        see adc.window for the signed-datapath discussion.
        """
        sched = adaptive_schedule(
            self.xbar_spec.replace(signed_weights=False), self.adc_cfg
        )
        mean_bits = float(sched.mean())
        full = ADC_8B.power_w * (self.adc_rate / 1.28e9)
        # SAR energy ~ cdac_frac + rest * bits/full_bits (adc.SARModel)
        s = self.sar
        frac = s.cdac_frac + (s.digital_frac + s.analog_frac) * (
            mean_bits / s.full_bits
        )
        if self.karatsuba_levels > 0:
            from repro_torch.core.karatsuba import karatsuba_cost

            c = karatsuba_cost(self.karatsuba_levels, self.xbar_spec)
            base = self.xbar_spec.n_iters * self.xbar_spec.n_slices
            frac *= (c.adc_slots / base) * (self.xbar_spec.n_iters / c.iterations)
        return full * frac

    def power_area(self) -> Dict[str, Component]:
        comps: Dict[str, Component] = {}
        # Karatsuba adds crossbars per mat, but DAC/ADC/HTree ports are
        # *shared within a mat* (Fig 9: "each mat now has two crossbars that
        # share the DAC and ADC"), so only the array count grows.
        n_mats = self.crossbars
        n_xbar = self.crossbars
        if self.karatsuba_levels == 1:
            n_xbar = max(n_xbar, 13)  # Fig 9: 8 mats x 2 xbars, 3 unused
        elif self.karatsuba_levels == 2:
            n_xbar = max(n_xbar, 20)
        col_groups = self.out_cols // self.xbar_spec.cols
        n_xbar = n_xbar * col_groups
        n_mats = n_mats * col_groups
        comps["crossbar"] = Component(
            "crossbar", CROSSBAR_128.power_w * n_xbar, CROSSBAR_128.area_mm2 * n_xbar
        )
        comps["dac"] = Component(
            "dac", DAC_ARRAY_128.power_w * n_mats, DAC_ARRAY_128.area_mm2 * n_mats
        )
        n_adc = self.adcs * col_groups
        comps["adc"] = Component(
            "adc", self.adc_mean_power_w() * n_adc, ADC_8B.area_mm2 * n_adc
        )
        comps["s+h"] = Component(
            "s+h", SAMPLE_HOLD.power_w * n_mats, SAMPLE_HOLD.area_mm2 * n_mats
        )
        # Input/output registers: ISAAC provisions a 2 KB IR (worst-case
        # multi-layer inputs) and a 39-bit-wide OR; Newton's constraint
        # (single layer, <=128 inputs) shrinks the IR 4x, and the embedded
        # shift-and-add (+ adaptive ADC) narrows the OR to 16 bits.
        if self.compact_htree:
            comps["ir"] = Component("ir", IMA_IR.power_w / 4, IMA_IR.area_mm2 / 4)
        else:
            comps["ir"] = IMA_IR
        out_bits = 23 if self.compact_htree else self.xbar_spec.acc_bits
        if self.adc_cfg.mode == "adaptive":
            out_bits = 16
        or_scale = out_bits / self.xbar_spec.acc_bits
        comps["or"] = Component(
            "or", IMA_OR.power_w * or_scale, IMA_OR.area_mm2 * or_scale
        )
        comps["s+a"] = IMA_SA
        comps["htree"] = htree_component(
            n_leaves=n_mats + col_groups,
            out_width_bits=out_bits,
            shared_inputs=self.compact_htree,
        )
        return comps

    def total_power_w(self) -> float:
        return sum(c.power_w for c in self.power_area().values())

    def total_area_mm2(self) -> float:
        return sum(c.area_mm2 for c in self.power_area().values())


@dataclasses.dataclass(frozen=True)
class TileConfig:
    name: str
    ima: IMAConfig
    imas: int = 12
    edram_kb: float = 64.0
    kind: str = "conv"  # "conv" | "fc"
    adc_slowdown: float = 1.0  # FC tiles run ADCs N x slower (T5)
    xbars_per_adc: int = 1  # FC tiles share one ADC across 4 crossbars (T5)

    def power_area(self) -> Dict[str, Component]:
        comps: Dict[str, Component] = {}
        ima_pa = self.ima.power_area()
        for k, c in ima_pa.items():
            p, a = c.power_w, c.area_mm2
            if k == "adc":
                p = p / self.adc_slowdown / self.xbars_per_adc
                a = a / self.xbars_per_adc
            elif k in ("crossbar", "dac", "s+h"):
                # FC tiles fire a crossbar read every ADC window, so the
                # whole analog read path slows with the ADC (T5).
                p = p / self.adc_slowdown
            comps[f"ima_{k}"] = Component(k, p * self.imas, a * self.imas)
        comps["edram"] = edram_component(self.edram_kb)
        comps["edram_bus"] = EDRAM_BUS
        comps["router"] = Component("router", ROUTER.power_w / 4, ROUTER.area_mm2 / 4)
        comps["sigmoid"] = SIGMOID
        comps["s+a"] = SHIFT_ADD_TILE
        comps["maxpool"] = MAXPOOL
        comps["or"] = TILE_OR
        return comps

    def total_power_w(self) -> float:
        return sum(c.power_w for c in self.power_area().values())

    def total_area_mm2(self) -> float:
        return sum(c.area_mm2 for c in self.power_area().values())

    @property
    def weights_per_tile(self) -> int:
        return self.imas * self.ima.weights_per_ima

    def peak_gops(self) -> float:
        """Peak 16-bit fixed point GOPS (MAC = 2 ops), iso with the paper."""
        ops = 2 * self.imas * self.ima.macs_per_vmm / self.ima.vmm_time_s
        return ops / self.adc_slowdown / 1e9


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    name: str
    conv_tile: TileConfig
    fc_tile: Optional[TileConfig] = None
    tiles: int = 168
    fc_tile_frac: float = 0.0  # fraction of tiles that are FC tiles

    def tile_counts(self):
        n_fc = int(round(self.tiles * self.fc_tile_frac))
        return self.tiles - n_fc, n_fc

    def total_power_w(self) -> float:
        n_conv, n_fc = self.tile_counts()
        p = n_conv * self.conv_tile.total_power_w()
        if n_fc and self.fc_tile:
            p += n_fc * self.fc_tile.total_power_w()
        return p + HYPER_TRANSPORT.power_w

    def total_area_mm2(self) -> float:
        n_conv, n_fc = self.tile_counts()
        a = n_conv * self.conv_tile.total_area_mm2()
        if n_fc and self.fc_tile:
            a += n_fc * self.fc_tile.total_area_mm2()
        return a + HYPER_TRANSPORT.area_mm2

    def peak_gops(self) -> float:
        n_conv, n_fc = self.tile_counts()
        g = n_conv * self.conv_tile.peak_gops()
        if n_fc and self.fc_tile:
            g += n_fc * self.fc_tile.peak_gops()
        return g

    def ce(self) -> float:
        """Computational efficiency GOPS/(s mm^2)."""
        return self.peak_gops() / self.total_area_mm2()

    def pe(self) -> float:
        """Power efficiency GOPS/W."""
        return self.peak_gops() / self.total_power_w()


# ---------------------------------------------------------------------------
# Presets: ISAAC baseline and the Newton technique stack (for Figs 11-23)
# ---------------------------------------------------------------------------

ISAAC_IMA = IMAConfig(name="isaac_ima", crossbars=8, rows=128, out_cols=128, adcs=8)
ISAAC_TILE = TileConfig(name="isaac_tile", ima=ISAAC_IMA, imas=12, edram_kb=64)
ISAAC_CHIP = ChipConfig(name="isaac", conv_tile=ISAAC_TILE, tiles=168)


def newton_ima(
    compact: bool = True,
    adaptive: bool = True,
    karatsuba: int = 0,
) -> IMAConfig:
    return IMAConfig(
        name="newton_ima",
        crossbars=8,
        rows=128,
        out_cols=256,  # Newton's chosen IMA: 128 inputs x 256 neurons (§IV)
        adcs=8,
        adc_cfg=ADCConfig(mode="adaptive") if adaptive else ADCConfig(mode="full"),
        compact_htree=compact,
        karatsuba_levels=karatsuba,
    )


def newton_conv_tile(ima: IMAConfig, edram_kb: float = 16.0) -> TileConfig:
    return TileConfig(name="newton_conv", ima=ima, imas=16, edram_kb=edram_kb)


def newton_fc_tile(ima: IMAConfig, slowdown: float = 128.0) -> TileConfig:
    return TileConfig(
        name="newton_fc",
        ima=ima,
        imas=16,
        edram_kb=4.0,
        kind="fc",
        adc_slowdown=slowdown,
        xbars_per_adc=4,
    )


def newton_chip(
    compact: bool = True,
    adaptive: bool = True,
    karatsuba: int = 1,
    small_buffers: bool = True,
    fc_tiles: bool = True,
    tiles: int = 168,
) -> ChipConfig:
    ima = newton_ima(compact=compact, adaptive=adaptive, karatsuba=karatsuba)
    conv = newton_conv_tile(ima, edram_kb=16.0 if small_buffers else 64.0)
    fc = newton_fc_tile(ima) if fc_tiles else None
    return ChipConfig(
        name="newton",
        conv_tile=conv,
        fc_tile=fc,
        tiles=tiles,
        fc_tile_frac=0.5 if fc_tiles else 0.0,  # §III.B.2: 1:1 fits most workloads
    )


NEWTON_CHIP = newton_chip()


def newton_chip_8bit(**kw) -> ChipConfig:
    """8-bit Newton used for the TPU-1 comparison (Fig 24): 8-bit weights
    (4 slices) and inputs (8 iterations) double the pipeline rate and halve
    the crossbars per weight."""
    spec8 = CrossbarSpec(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7)
    chip = newton_chip(**kw)
    ima8 = dataclasses.replace(chip.conv_tile.ima, xbar_spec=spec8)
    conv8 = dataclasses.replace(chip.conv_tile, ima=ima8)
    fc8 = dataclasses.replace(chip.fc_tile, ima=ima8) if chip.fc_tile else None
    return dataclasses.replace(chip, name="newton-8b", conv_tile=conv8, fc_tile=fc8)

# Reference per-op energies from the paper's introduction (validation anchors)
IDEAL_NEURON_PJ = 0.33
DADIANNAO_PJ = 3.5
EYERISS_PJ = 1.67
ISAAC_PJ = 1.8
NEWTON_PJ = 0.85
