"""Chip-plan compiler: per-layer heterogeneous datapath selection (§III;
counterpart of ``repro.core.planner``, whose plans it reproduces to the
byte: ``ChipPlan.to_json`` of either package is the other's).

The paper's techniques — Karatsuba bit-level divide & conquer (§III.A.1),
Strassen matrix blocking (§III.A.2), the adaptive SAR ADC schedule
(§III.A.3), and fault-aware spare-column provisioning — are all *per-layer*
choices: an fc projection with one output pixel cannot use Strassen, a
shallow layer gains nothing from two Karatsuba levels' extra crossbars, and
the spare budget a layer deserves scales with how salient its weights are
to the network output.  The modules implementing each technique price their
own choice (``karatsuba_cost``, ``strassen_cost``, ``adc.adaptive_schedule``
+ ``SARModel``, ``mapper.provision_spare_cols``); this pass composes them:
enumerate the candidate datapaths per layer, price each under the same
accounting ``core.energy.evaluate`` uses (conversions x per-conversion SAR
energy from the schedule histogram), and pick the minimum — emitting a
serializable ``LayerPlan`` per layer and a ``ChipPlan`` for the model.

Execution is wired through the programming pipeline: ``program_layer`` /
``program_model(plan=...)`` attach each layer's ``LayerPlan`` to the
compiled ``ProgrammedLinear`` and materialize its choices (ADC config;
on a device with stuck cells the spare-column budget, which
``device.repair`` programs);
``programmed_matmul`` then routes ideal-device artifacts through
``karatsuba_vmm`` / ``strassen_matmul``, which are bit-identical to the
direct datapath by exact integer arithmetic — a planned chip must produce
the same bits as the homogeneous compile.
Noisy chips keep the device kernel for the analog stage (the effective-cell
read models physical arrays, which divide-and-conquer re-tiles rather than
re-reads); their plan still selects the ADC schedule the kernel applies and
the spare budget the repair planner programs.

Two accounting modes mirror ``strassen_cost``: ``widening="paper"``
reproduces the paper's 7/8-per-level Strassen claim (combined operands
reuse the 16-bit datapath); ``"exact"`` charges the extra slice + iteration
the bit-exact implementation actually pays — under which Strassen is a net
conversion *loss* and the planner correctly refuses it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.core import adc as adc_mod
from repro_torch.core.adc import ADCConfig, DEFAULT_SAR, SARModel
from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC, layer_scaled_spec
from repro_torch.core.karatsuba import karatsuba_cost
from repro_torch.core.mapper import provision_spare_cols
from repro_torch.core.strassen import strassen_cost
from repro_torch.core.workloads import Network

DATAPATHS = ("direct", "karatsuba1", "karatsuba2", "strassen")
ADC_MODES = ("full", "safe_adaptive", "exact_adaptive")


def adc_config_for(mode: str, spec: CrossbarSpec) -> ADCConfig:
    """Materialize a plan's ADC-mode name against a (layer-scaled) spec.

    ``exact_adaptive`` keeps every guard bit below the layer's own
    ``drop_lsb`` (provably lossless for *this* layer's scaling), so it must
    be resolved per layer — the module-level ``EXACT_ADAPTIVE`` constant is
    pinned to the default spec and would under-guard a deep layer.
    """
    if mode == "full":
        return ADCConfig(mode="full")
    if mode == "safe_adaptive":
        return ADCConfig(mode="adaptive", guard_bits=4)
    if mode == "exact_adaptive":
        return ADCConfig(mode="adaptive", guard_bits=spec.drop_lsb)
    raise ValueError(f"unknown ADC mode {mode!r} (one of {ADC_MODES})")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's compiled datapath choice — hashable, serializable.

    Rides a ``ProgrammedLinear`` and its store manifest, so every field is
    a primitive.  ``predicted_conversions`` / ``predicted_energy_pj`` are
    per-sample ADC figures under the planner's accounting — recorded so a
    served chip carries the numbers it was admitted on.
    """

    name: str
    datapath: str = "direct"  # one of DATAPATHS
    adc_mode: str = "full"  # one of ADC_MODES
    spare_cols: int = 0  # per-crossbar repair budget (provision_spare_cols)
    replication: int = 1  # pipeline-balance copies (mapper's rule)
    predicted_conversions: float = 0.0
    predicted_energy_pj: float = 0.0

    def __post_init__(self):
        if self.datapath not in DATAPATHS:
            raise ValueError(f"unknown datapath {self.datapath!r}")
        if self.adc_mode not in ADC_MODES:
            raise ValueError(f"unknown ADC mode {self.adc_mode!r}")

    @property
    def karatsuba_levels(self) -> int:
        return {"karatsuba1": 1, "karatsuba2": 2}.get(self.datapath, 0)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LayerPlan":
        return cls(**dict(d))


@dataclasses.dataclass
class ChipPlan:
    """Every layer's ``LayerPlan``, keyed by the layer/artifact name."""

    network: str
    layers: Dict[str, LayerPlan]
    fault_rate: float = 0.0
    widening: str = "paper"
    exactness: str = "empirical"

    def layer_for(self, name: str) -> Optional[LayerPlan]:
        return self.layers.get(name)

    @property
    def total_conversions(self) -> float:
        return sum(p.predicted_conversions for p in self.layers.values())

    @property
    def total_energy_pj(self) -> float:
        return sum(p.predicted_energy_pj for p in self.layers.values())

    def datapath_histogram(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for p in self.layers.values():
            out[p.datapath] = out.get(p.datapath, 0) + 1
        return out

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": 1,
                "network": self.network,
                "fault_rate": self.fault_rate,
                "widening": self.widening,
                "exactness": self.exactness,
                # insertion order is the plan order — keep it
                "layers": {n: p.to_dict() for n, p in self.layers.items()},
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "ChipPlan":
        d = json.loads(s)
        return cls(
            network=d["network"],
            layers={n: LayerPlan.from_dict(p) for n, p in d["layers"].items()},
            fault_rate=float(d.get("fault_rate", 0.0)),
            widening=d.get("widening", "paper"),
            exactness=d.get("exactness", "empirical"),
        )


# ---------------------------------------------------------------------------
# Candidate pricing (the same currency as core.energy.evaluate)
# ---------------------------------------------------------------------------


def predicted_conversions(
    rows: int,
    cols: int,
    pixels: int,
    datapath: str,
    spec: CrossbarSpec,
    widening: str = "paper",
) -> float:
    """Per-sample ADC conversions of one layer under one datapath.

    Direct / Karatsuba follow ``energy.evaluate``'s formula — pixels x cols
    x row-groups x conversion slots per column group; Strassen prices the
    whole (pixels, rows) x (rows, cols) matmul through ``strassen_cost``
    under the requested ``widening`` accounting.
    """
    groups = -(-rows // spec.rows)
    if datapath == "strassen":
        return float(
            strassen_cost(pixels, rows, cols, spec, levels=1, widening=widening)
            .adc_conversions
        )
    levels = {"direct": 0, "karatsuba1": 1, "karatsuba2": 2}[datapath]
    slots = karatsuba_cost(levels, spec).adc_slots
    return float(pixels * cols * groups * slots)


def _energy_per_conversion_pj(spec: CrossbarSpec, mode: str, sar: SARModel) -> float:
    """Mean SAR energy of one conversion under the mode's schedule histogram
    (``energy.evaluate``'s ``bits_frac`` without the normalization detour)."""
    sched = adc_mod.adaptive_schedule(
        spec.replace(signed_weights=False), adc_config_for(mode, spec)
    )
    return sar.mean_energy_pj(sched)


def _admissible_adc_modes(spec: CrossbarSpec, rows: int, exactness: str) -> List[str]:
    """ADC modes the layer may use, per the requested exactness contract.

    ``empirical``: every mode — ``safe_adaptive``'s 4 guard bits are the
    property-tested empirically-bit-exact regime (its *analytic* worst-case
    bound is loose: simultaneous worst-case carries in every truncated
    conversion never materialize).  ``provable``: only schedules whose
    analytic LSB error bound is exactly zero (``full`` /
    ``exact_adaptive``).
    """
    if exactness != "provable":
        return list(ADC_MODES)
    return [
        mode
        for mode in ADC_MODES
        if adc_mod.lsb_error_bound(spec, adc_config_for(mode, spec), rows) == 0.0
    ]


def datapath_crossbar_factor(datapath: str, spec: CrossbarSpec, widening: str = "paper") -> float:
    """Crossbars per 128x128 weight tile, relative to the direct datapath.

    The area price of each conversion saving: Karatsuba re-tiles one column
    group across 13 (level 1) or 20 (level 2) crossbars where direct uses
    ``n_slices``; Strassen *frees* arrays (7 products replace 8) but its
    precombined weight operands widen by one slice per level under the
    ``exact`` accounting.
    """
    if datapath == "strassen":
        c = strassen_cost(2, 2 * spec.rows, 2, spec, levels=1, widening=widening)
        return (c.imas_used / 8.0) * (
            (spec.n_slices + c.extra_weight_slices) / spec.n_slices
        )
    levels = {"direct": 0, "karatsuba1": 1, "karatsuba2": 2}[datapath]
    return karatsuba_cost(levels, spec).crossbars / float(spec.n_slices)


def plan_layer(
    name: str,
    rows: int,
    cols: int,
    *,
    pixels: int = 1,
    kind: str = "fc",
    spec: CrossbarSpec = DEFAULT_SPEC,
    sar: SARModel = DEFAULT_SAR,
    fault_rate: float = 0.0,
    salience: float = 1.0,
    pixels_ref: int = 1,
    widening: str = "paper",
    exactness: str = "empirical",
    datapaths: Optional[Iterable[str]] = None,
    max_crossbar_factor: Optional[float] = None,
) -> LayerPlan:
    """Compile one layer's plan by minimizing predicted ADC energy.

    Candidates: every datapath in ``datapaths`` (default: direct, both
    Karatsuba levels, and Strassen for conv-shaped layers with >= 2 output
    pixels) x every admissible ADC mode; the objective is (energy,
    conversions, iterations) lexicographic — energy decides, conversion
    count breaks ties, pipeline latency breaks those.

    ``max_crossbar_factor`` is the area constraint the paper's mapping
    lives under: candidates whose ``datapath_crossbar_factor`` exceeds it
    are inadmissible.  Unconstrained, Karatsuba level 2 wins everywhere (92
    of 128 conversion slots, at 2.5x the crossbars); at a factor of 1.0 —
    a chip with no slack arrays, e.g. a heavily replicated early conv
    layer — Strassen is the only datapath that still cuts conversions,
    because it *frees* arrays instead of consuming them.  Spare budget and
    replication are constraints, not choices: the budget comes from
    ``provision_spare_cols`` scaled by this layer's fault ``salience``, and
    replication from the mapper's pipeline-balance rule
    (``ceil(pixels / pixels_ref)`` for conv, 1 for fc).
    """
    spec_l = layer_scaled_spec(spec, max(2, rows))
    cands = list(datapaths) if datapaths is not None else [
        "direct", "karatsuba1", "karatsuba2",
    ]
    if datapaths is None and kind == "conv" and pixels >= 2:
        cands.append("strassen")
    modes = _admissible_adc_modes(spec_l, rows, exactness)
    if not modes:
        modes = ["full"]

    best: Optional[Tuple[Tuple[float, float, int], str, str, float, float]] = None
    for dp in cands:
        if (
            max_crossbar_factor is not None
            and dp != "direct"
            and datapath_crossbar_factor(dp, spec_l, widening) > max_crossbar_factor
        ):
            continue
        convs = predicted_conversions(rows, cols, pixels, dp, spec_l, widening)
        if dp == "strassen":
            iters = spec_l.n_iters + (1 if widening == "exact" else 0)
        else:
            iters = karatsuba_cost(
                {"direct": 0, "karatsuba1": 1, "karatsuba2": 2}[dp], spec_l
            ).iterations
        for mode in modes:
            e_pj = convs * _energy_per_conversion_pj(spec_l, mode, sar)
            key = (e_pj, convs, iters)
            if best is None or key < best[0]:
                best = (key, dp, mode, convs, e_pj)
    assert best is not None
    _, datapath, adc_mode, convs, e_pj = best

    spare = provision_spare_cols(fault_rate, spec_l, coverage=salience)
    repl = max(1, -(-pixels // max(1, pixels_ref))) if kind == "conv" else 1
    return LayerPlan(
        name=name,
        datapath=datapath,
        adc_mode=adc_mode,
        spare_cols=spare,
        replication=repl,
        predicted_conversions=convs,
        predicted_energy_pj=e_pj,
    )


# ---------------------------------------------------------------------------
# Whole-model planning
# ---------------------------------------------------------------------------


def plan_network(
    net: Network,
    spec: CrossbarSpec = DEFAULT_SPEC,
    sar: SARModel = DEFAULT_SAR,
    *,
    fault_rate: float = 0.0,
    salience: Optional[Mapping[str, float]] = None,
    widening: str = "paper",
    exactness: str = "empirical",
    datapaths: Optional[Iterable[str]] = None,
    max_crossbar_factor: Optional[float] = None,
) -> ChipPlan:
    """Plan every layer of a ``workloads.Network`` (Table II CNNs, or a
    ``configs/`` model through ``workloads.lm_workload``)."""
    conv_pixels = [l.pixels for l in net.conv_layers()]
    pixels_ref = min(conv_pixels, default=1)
    layers: Dict[str, LayerPlan] = {}
    for layer in net.layers:
        layers[layer.name] = plan_layer(
            layer.name,
            layer.rows,
            layer.cols,
            pixels=layer.pixels,
            kind=layer.kind,
            spec=spec,
            sar=sar,
            fault_rate=fault_rate,
            salience=(salience or {}).get(layer.name, 1.0),
            pixels_ref=pixels_ref,
            widening=widening,
            exactness=exactness,
            datapaths=datapaths,
            max_crossbar_factor=max_crossbar_factor,
        )
    return ChipPlan(
        network=net.name,
        layers=layers,
        fault_rate=fault_rate,
        widening=widening,
        exactness=exactness,
    )


def homogeneous_network(
    net: Network,
    spec: CrossbarSpec = DEFAULT_SPEC,
    sar: SARModel = DEFAULT_SAR,
    *,
    fault_rate: float = 0.0,
) -> ChipPlan:
    """The homogeneous compile the planner is judged against: every layer on
    the direct datapath with a full-resolution ADC — exactly what
    ``program_layer``'s default ``fast=True`` kernel executes."""
    plan = plan_network(
        net, spec, sar, fault_rate=fault_rate, datapaths=("direct",)
    )
    # full-mode conversion energy is scaling-independent (every conversion
    # resolves all adc_bits), so one per-conversion figure prices every layer
    e_full = _energy_per_conversion_pj(spec, "full", sar)
    forced = {
        n: dataclasses.replace(
            p,
            adc_mode="full",
            predicted_energy_pj=p.predicted_conversions * e_full,
        )
        for n, p in plan.layers.items()
    }
    return dataclasses.replace(plan, layers=forced, exactness="provable")


def plan_model(
    params: Any,
    spec: CrossbarSpec = DEFAULT_SPEC,
    sar: SARModel = DEFAULT_SAR,
    *,
    device: Optional[Any] = None,
    tie_lm_head: bool = False,
    leaf_filter: Optional[Any] = None,
    widening: str = "paper",
    exactness: str = "empirical",
    name: str = "model",
) -> ChipPlan:
    """Plan a nested params dict, keyed by the **canonical artifact names**
    ``program_model`` will emit (the same names and order as the reference's
    pytree walk, so a plan built by either package keys the other's
    artifacts) — the plan then threads straight through
    ``program_model(plan=...)`` / ``ServingEngine(plan=...)``.

    Per-layer fault salience comes from the weights themselves: a layer
    whose mean |w| (in the leaf's own dtype, as the reference's ``jnp.mean``)
    is above the model mean carries more output weight per stuck cell, so
    its spare budget scales up (clamped to [0.5, 2]x).  ``device`` (a
    ``DeviceConfig``) supplies the stuck-cell rate; without one the plan
    provisions no spares.
    """
    import torch

    from repro_torch.device.programmed import expected_artifact_names
    from repro_torch.tree import walk

    shapes = expected_artifact_names(
        params, tie_lm_head=tie_lm_head, leaf_filter=leaf_filter
    )
    fault_rate = 0.0
    if device is not None:
        fault_rate = float(
            getattr(device, "p_stuck_on", 0.0) + getattr(device, "p_stuck_off", 0.0)
        )

    # mean |w| per planned leaf, in the walk's (sorted-key) order — the tied
    # head's transposed artifact shares the embedding's name and leaf
    mags: Dict[str, float] = {}
    for path, leaf in walk(params):
        key = "/".join(path)
        if isinstance(leaf, torch.Tensor) and key in shapes:
            mags[key] = float(torch.mean(torch.abs(leaf)))
    overall = sum(mags.values()) / max(1, len(mags))

    layers: Dict[str, LayerPlan] = {}
    for art_name, shape in shapes.items():
        rows, cols = int(shape[-2]), int(shape[-1])
        sal = 1.0
        if art_name in mags and overall > 0:
            sal = min(2.0, max(0.5, mags[art_name] / overall))
        layers[art_name] = plan_layer(
            art_name,
            rows,
            cols,
            spec=spec,
            sar=sar,
            fault_rate=fault_rate,
            salience=sal,
            widening=widening,
            exactness=exactness,
        )
    return ChipPlan(
        network=name,
        layers=layers,
        fault_rate=fault_rate,
        widening=widening,
        exactness=exactness,
    )
