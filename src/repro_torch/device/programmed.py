"""Program-once crossbar compilation: frozen programmed-weight artifacts
(counterpart of ``repro.device.programmed``).

* ``program_layer(w, spec, device_cfg, adc_cfg) -> ProgrammedLinear`` — the
  programming-time entry point: quantized cell codes, device-perturbed
  effective cells (``g_eff``, repaired where the device provisions spares),
  frozen scales, correction column sums.
* ``artifact_at_time`` / ``age_artifact`` — the service clock: a drifted
  view of the same chip, no reprogramming.
* ``programmed_matmul`` / ``programmed_linear`` — the steady-state forward:
  quantize input -> crossbar VMM kernel -> dequantize -> offset correction.
  An artifact compiled under a ``core.planner.LayerPlan`` whose datapath is
  Karatsuba or Strassen serves through ``core.karatsuba`` /
  ``core.strassen`` instead of a kernel (``PLANNED_CALLS`` counts them).
* ``artifact_shard_specs`` / ``dividing_pspec`` / ``shard_artifacts`` /
  ``local_artifact`` — sharding: a placed chip is the global artifacts with
  a per-artifact ``sharding`` record (what the store writes), and a rank's
  slice is ``local_artifact``'s (repair tables re-indexed to local columns).
* ``program_model(params, ...) -> ProgrammedModel`` — walk a nested dict of
  parameters and compile every projection.  Artifacts are keyed by the joined
  parameter path ("stage0/b0/mixer/wq"); ``models.layers.crossbar_linear``
  joins its call-site name with the active ``name_scope`` stack and looks the
  key up in the ``bind_artifacts`` stack first and the model's ``by_name``
  table second.

Naming: a ``ProgrammedLinear``'s ``device`` field is the ``DeviceConfig`` the
chip was programmed with (it is stored under that key in artifact manifests);
the torch device is always the explicit ``device=`` *argument* of the entry
points, and the ``DeviceConfig`` argument is called ``device_cfg``.

Every scale is a 0-d float32 tensor on the artifact's device and the
elementwise chain keeps the reference's literal order, so the float result
matches the reference's rounding points.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adc import ADCConfig, SAFE_ADAPTIVE
from repro_torch.core.crossbar import (
    CrossbarSpec,
    DEFAULT_SPEC,
    layer_scaled_spec,
    quantize_input,
    quantize_weight,
)
from repro_torch.core.karatsuba import karatsuba_vmm
from repro_torch.core.planner import ChipPlan, LayerPlan, adc_config_for
from repro_torch.core.strassen import strassen_matmul
from repro_torch.device import models as dm
from repro_torch.device import repair as repair_mod
from repro_torch.kernels.crossbar_vmm import crossbar_vmm_cuda
from repro_torch.kernels.noisy_vmm import noisy_vmm_cuda
from repro_torch.tree import walk

# Every array leaf a ProgrammedLinear carries — the single source of truth
# for serialization (checkpoint.save_programmed) and equality checks.
ARTIFACT_ARRAY_FIELDS = (
    "w_codes", "g_eff", "w_colsum", "w_scale", "x_scale", "g_spare", "out_gather",
    "comp_scale",
)

# Calls served by a planned divide-and-conquer datapath, by datapath: these
# run no kernel of ours (PyTorch tensor code around float64 matmuls), so
# they are counted apart from the kernel wrappers' ``LAUNCHES``.
PLANNED_CALLS = {"karatsuba1": 0, "karatsuba2": 0, "strassen": 0}


def reset_planned_calls() -> None:
    for k in PLANNED_CALLS:
        PLANNED_CALLS[k] = 0


@dataclasses.dataclass(frozen=True)
class ProgrammedLinear:
    """One weight matrix compiled onto (possibly noisy) crossbars.

    Array leaves:
      * ``w_codes``: (K, N) int32 signed quantized weight codes.
      * ``g_eff``: (S, K, N) float32 device-perturbed effective cell codes,
        or None for ideal devices.
      * ``w_colsum``: (N,) float32 column sums of the float weights (the
        digital offset-correction term).
      * ``w_scale``: 0-d float32 frozen weight quantization scale.
      * ``x_scale``: 0-d float32 or None (None: dynamic per-call ``max(x)``).
      * ``g_spare`` / ``out_gather``: spare-column block and routing tables
        of a repaired chip (``g_eff`` already holds the repaired layout;
        these are the hardware record), ``comp_scale``: (N,) digital
        drift-compensation output scales (``device.health``), applied when
        present.

    A *stacked* artifact carries leading layer axes on every array;
    ``layer(i)`` peels one.  Static data: ``spec`` (layer-scaled),
    ``adc_cfg`` / ``fast`` (which kernel serves it), ``device`` (the
    ``DeviceConfig`` it was programmed with), ``t_service_s``, ``plan``
    (the ``core.planner.LayerPlan`` it was compiled under, or None: its
    datapath picks the route), ``report`` (a ``program.ProgramReport``) and
    ``repair`` (a ``repair.RepairReport``), per-slab tuples on a stacked
    artifact.  ``age`` / ``at_time`` give the drift-evolved chip.
    ``sharding`` is the placement record of a deployed chip (``{field:
    spec}`` for every field that is not replicated, from
    ``shard_artifacts`` or a store); it is not part of chip equality.
    """

    w_codes: torch.Tensor
    g_eff: Optional[torch.Tensor]
    w_colsum: torch.Tensor
    w_scale: torch.Tensor
    x_scale: Optional[torch.Tensor]
    spec: CrossbarSpec
    adc_cfg: Optional[ADCConfig] = None
    fast: bool = True
    report: Optional[Any] = None
    g_spare: Optional[torch.Tensor] = None
    out_gather: Optional[torch.Tensor] = None
    repair: Optional[Any] = None
    comp_scale: Optional[torch.Tensor] = None
    device: Optional[dm.DeviceConfig] = None
    t_service_s: float = 0.0
    plan: Optional[LayerPlan] = None
    sharding: Optional[Dict[str, Tuple[Any, ...]]] = dataclasses.field(default=None, compare=False)

    @property
    def noisy(self) -> bool:
        return self.g_eff is not None

    @property
    def stacked(self) -> bool:
        return self.w_codes.ndim >= 3

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.w_codes.shape)

    def map_arrays(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ProgrammedLinear":
        """A copy with ``fn`` applied to every non-None array leaf."""
        return dataclasses.replace(
            self,
            **{
                f: fn(getattr(self, f))
                for f in ARTIFACT_ARRAY_FIELDS
                if getattr(self, f) is not None
            },
        )

    def layer(self, i: int) -> "ProgrammedLinear":
        """Slice one layer out of a stacked artifact (views, no copies)."""
        assert self.stacked, "layer() only applies to stacked artifacts"
        return self.map_arrays(lambda a: a[i])

    def age(self, dt_s: float) -> "ProgrammedLinear":
        """Advance the chip ``dt_s`` seconds of service (drift-evolved view)."""
        return age_artifact(self, dt_s)

    def at_time(self, t_s: float) -> "ProgrammedLinear":
        """The chip at absolute service time ``t_s >= t_service_s``."""
        return artifact_at_time(self, t_s)


def artifacts_equal(a: ProgrammedLinear, b: ProgrammedLinear) -> bool:
    """Bit-exact artifact equality: every array field (None-ness included),
    the static datapath data (spec / adc_cfg / fast) and the lifecycle state
    (device / t_service_s / plan).  Reports are not part of chip equality."""
    for f in ARTIFACT_ARRAY_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if (va is None) != (vb is None):
            return False
        if va is not None and not (
            va.shape == vb.shape and va.dtype == vb.dtype and torch.equal(va, vb.to(va.device))
        ):
            return False
    return (
        a.spec == b.spec
        and a.adc_cfg == b.adc_cfg
        and a.fast == b.fast
        and a.device == b.device
        and a.t_service_s == b.t_service_s
        and a.plan == b.plan
    )


def program_layer(
    w: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    device_cfg: Optional[dm.DeviceConfig] = None,
    adc_cfg: Optional[ADCConfig] = SAFE_ADAPTIVE,
    *,
    x_scale: Optional[float] = None,
    w_scale: Optional[float] = None,
    fast: bool = True,
    with_report: bool = False,
    chips: Optional[Tuple[int, ...]] = None,
    plan: Optional[LayerPlan] = None,
) -> ProgrammedLinear:
    """Compile one (K, N) — or stacked (L, K, N) / (L, E, K, N) — weight on
    the device ``w`` lies on.

    Runs every weight-only stage exactly once: the ``max |w|`` scale
    reduction, weight quantization, the device fault draw + write-verify +
    read path, spare-column repair where the device provisions spares and
    has stuck cells (``device.repair``: ``g_eff`` holds the repaired layout,
    ``g_spare`` / ``out_gather`` / ``repair`` the hardware record), and the
    correction column sums; deterministic in (w, spec, device_cfg).  Stacked
    leaves are compiled slab by slab into the stacked arrays, so the
    programming temporaries of one slab are freed before the next and no
    whole-stack copy is made; their reports and repairs become per-slab
    tuples.

    ``with_report=True`` programs through ``program.write_verify`` (the same
    cells) and keeps its ``ProgramReport``.  ``chips`` gives one
    ``DeviceConfig.chip`` identity per slab of the innermost stacking axis
    (the layer axis of a 3-D leaf; a 4-D leaf passes it to its expert axis):
    the same weights on two chips draw different perturbations.  The stacked
    artifact keeps the base ``device_cfg``.

    ``plan`` (a ``core.planner.LayerPlan``) compiles the layer under the
    plan compiler's choices: the ADC config is the plan's mode against the
    layer-scaled spec, a positive planned spare budget overrides the
    device's where the device has stuck cells to repair (elsewhere it is a
    no-op), and the plan rides the artifact so ``programmed_matmul`` runs
    its datapath.
    """
    if w.ndim >= 3:
        if chips is not None and w.ndim == 3:
            if device_cfg is None:
                raise ValueError("chips= requires a DeviceConfig")
            if len(chips) != w.shape[0]:
                raise ValueError(f"chips has {len(chips)} entries for stacking axis of {w.shape[0]}")
            devices = [dataclasses.replace(device_cfg, chip=int(c)) for c in chips]
        else:  # 4-D: chips go to the inner (expert) axis
            devices = [device_cfg] * w.shape[0]
        # one slab at a time, each written into its place in the stacked
        # arrays: the float32 copy and the temporaries are one slab's, never
        # the whole stack's (gemma2-9b's ``wi`` stack is 2.2 B weights)
        stacked: Dict[str, torch.Tensor] = {}
        first = None
        reports, repairs = [], []
        for i in range(w.shape[0]):
            part = program_layer(
                w[i], spec, devices[i], adc_cfg, x_scale=x_scale, w_scale=w_scale, fast=fast,
                with_report=with_report, chips=(chips if w.ndim > 3 else None), plan=plan,
            )
            reports.append(part.report)
            repairs.append(part.repair)
            for f in ARTIFACT_ARRAY_FIELDS:
                a = getattr(part, f)
                if a is None:
                    continue
                if f not in stacked:
                    stacked[f] = torch.empty((w.shape[0],) + tuple(a.shape), dtype=a.dtype, device=a.device)
                stacked[f][i] = a
            if first is None:
                first = part
        return dataclasses.replace(
            first, **stacked, device=device_cfg,
            report=(tuple(reports) if any(r is not None for r in reports) else None),
            repair=(tuple(repairs) if any(r is not None for r in repairs) else None),
        )
    w = w.to(torch.float32)
    spec = layer_scaled_spec(spec, w.shape[0])
    if plan is not None:
        adc_cfg = adc_config_for(plan.adc_mode, spec)
        if (
            plan.spare_cols > 0
            and device_cfg is not None
            and not device_cfg.is_ideal
            and (device_cfg.p_stuck_on > 0 or device_cfg.p_stuck_off > 0)
        ):
            device_cfg = dataclasses.replace(device_cfg, spare_cols=plan.spare_cols)
    if w_scale is None:
        w_scale_t = torch.clamp(torch.max(torch.abs(w)), min=1e-9) / (
            (1 << (spec.weight_bits - 1)) - 1
        )
    else:
        w_scale_t = torch.tensor(w_scale, dtype=torch.float32, device=w.device)
    wq = quantize_weight(w, spec, w_scale_t)
    g_eff = g_spare = out_gather = report = repair_rep = None
    if device_cfg is not None and not device_cfg.is_ideal:
        g_eff, rplan, report = repair_mod.repaired_effective_cells(
            wq + spec.weight_bias, spec, device_cfg, with_report=with_report
        )
        if rplan is not None:
            g_spare, out_gather = rplan.g_spare, rplan.out_gather
            repair_rep = repair_mod.repair_report(rplan)
    return ProgrammedLinear(
        w_codes=wq, g_eff=g_eff, w_colsum=torch.sum(w, dim=0), w_scale=w_scale_t,
        x_scale=(
            torch.tensor(x_scale, dtype=torch.float32, device=w.device)
            if x_scale is not None else None
        ),
        g_spare=g_spare, out_gather=out_gather,
        spec=spec, adc_cfg=adc_cfg, fast=fast, report=report, repair=repair_rep,
        device=device_cfg, t_service_s=0.0, plan=plan,
    )


# ---------------------------------------------------------------------------
# Service-time aging (the chip lifecycle's clock)
# ---------------------------------------------------------------------------

def artifact_at_time(art: ProgrammedLinear, t_s: float) -> ProgrammedLinear:
    """The chip as it reads at absolute service time ``t_s >=
    art.t_service_s``: ``g_eff`` and ``g_spare`` decayed by the device's
    power law between the two times (``models.drift_time_factor``, pushed
    through the level map by ``models.age_effective_codes``, elementwise, so
    stacked artifacts age whole).  The digital record (``w_codes``,
    ``w_colsum``, scales) never ages.  A drift-free chip only advances the
    clock: its arrays are the same tensors (a factor of exactly 1.0 is not
    pushed through the round trip, which is no bit-exact identity)."""
    t_s = float(t_s)
    if t_s < art.t_service_s:
        raise ValueError(
            f"cannot rejuvenate a chip: at_time({t_s}) < current service "
            f"time {art.t_service_s} (reprogram instead)"
        )
    if art.g_eff is None or art.device is None:
        return dataclasses.replace(art, t_service_s=t_s)
    factor = dm.drift_time_factor(art.device, art.t_service_s, t_s)
    if factor == 1.0:
        return dataclasses.replace(art, t_service_s=t_s)
    g_eff = dm.age_effective_codes(art.g_eff, art.spec, art.device, factor)
    g_spare = (
        dm.age_effective_codes(art.g_spare, art.spec, art.device, factor)
        if art.g_spare is not None
        else None
    )
    return dataclasses.replace(art, g_eff=g_eff, g_spare=g_spare, t_service_s=t_s)


def age_artifact(art: ProgrammedLinear, dt_s: float) -> ProgrammedLinear:
    """Advance a chip ``dt_s >= 0`` seconds of service (``artifact_at_time``)."""
    if dt_s < 0:
        raise ValueError(f"dt_s must be non-negative, got {dt_s}")
    return artifact_at_time(art, art.t_service_s + float(dt_s))


def programmed_matmul(
    x: torch.Tensor, art: ProgrammedLinear, skip_zero_planes: bool = True
) -> torch.Tensor:
    """Steady-state float crossbar matmul against a programmed artifact:
    input quantization -> kernel -> dequantize.  ``x`` must be non-negative
    (see ``programmed_linear`` for the offset-encoded form).

    The dynamic input scale is ``max(x)`` over the *whole* tensor, as in the
    reference: every row's codes depend on every other row of the call.

    The route, in the reference's order: a noisy chip (``g_eff``) serves
    through the noisy kernel under its (planned) ADC config; a planned
    Karatsuba / Strassen datapath through ``core.karatsuba`` /
    ``core.strassen`` (exact, whatever ``fast`` says); else ``fast`` picks
    the fast kernel, and the paper-datapath kernel serves the rest.  On
    CUDA tensors the hand-written kernels serve; on CPU tensors their plain
    versions do.
    """
    if art.stacked:
        raise ValueError(
            "stacked artifact: slice one layer first (art.layer(i), or let "
            "models.model._run_stage walk it)"
        )
    spec = art.spec
    if art.x_scale is not None:
        x_scale = art.x_scale
    else:
        x_scale = torch.clamp(torch.max(x), min=1e-9) / ((1 << spec.input_bits) - 1)
    xq = quantize_input(x, spec, x_scale)
    if art.g_eff is not None:
        # noisy chips always serve through the device kernel
        yq = noisy_vmm_cuda(
            xq, art.g_eff, spec, adc_cfg=art.adc_cfg, skip_zero_planes=skip_zero_planes
        )
    elif art.plan is not None and art.plan.datapath != "direct":
        yq = _planned_vmm(xq, art)
    else:
        yq = crossbar_vmm_cuda(
            xq, art.w_codes, spec, adc_cfg=(None if art.fast else art.adc_cfg),
            fast=art.fast, skip_zero_planes=skip_zero_planes,
        )
    # dequantize in the reference's association order, all in float32
    scale = x_scale * art.w_scale
    y = yq.to(torch.float32) * (scale * (2.0 ** spec.drop_lsb))
    if art.comp_scale is not None:
        y = y * art.comp_scale
    return y


def _planned_vmm(xq: torch.Tensor, art: ProgrammedLinear) -> torch.Tensor:
    """Output codes of a planned divide-and-conquer datapath: exact, so
    bit-identical to the direct datapath's.  An unknown datapath raises."""
    datapath = art.plan.datapath
    x2 = xq.reshape(-1, xq.shape[-1])
    if datapath == "strassen":
        y = strassen_matmul(x2, art.w_codes, art.spec, levels=1)
    elif datapath in ("karatsuba1", "karatsuba2"):
        y = karatsuba_vmm(x2, art.w_codes, art.spec, levels=art.plan.karatsuba_levels)
    else:
        raise ValueError(f"unknown planned datapath {datapath!r}")
    PLANNED_CALLS[datapath] += 1
    return y.reshape(xq.shape[:-1] + y.shape[-1:])


def programmed_linear(
    x: torch.Tensor, art: ProgrammedLinear, colsum: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Signed-activation ``x @ w`` against a programmed artifact: shift the
    activations non-negative (``min(x)`` over the whole tensor, subtracted in
    ``x.dtype`` before the cast to float32), run the unsigned datapath,
    correct digitally with the precomputed weight column sums (``colsum``
    overrides ``art.w_colsum``).  Returns float32."""
    shift = torch.min(x)
    xs = (x - shift).to(torch.float32)
    y = programmed_matmul(xs, art)
    cs = art.w_colsum if colsum is None else colsum
    return y + shift.to(torch.float32) * cs


# ---------------------------------------------------------------------------
# Sharding: placement records and rank-local slices
# ---------------------------------------------------------------------------
#
# A spec is a tuple of entries (None, an axis name or a tuple of names), one
# a dim, shorter than the array meaning replicated trailing dims.  Axis
# semantics per artifact field (w_codes is the weight, (…stack, K, N)):
#   * stacking axes (L layers / E experts) — slice every leaf; each (K, N)
#     slab stays intact, so expert-parallel serving is bit-identical;
#   * N (output columns) — column-separable: cells, colsums and gather
#     tables slice cleanly (``local_artifact`` re-indexes repair tables to
#     local column coordinates);
#   * K (contraction rows) — rank-local *rows of the global chip*: servable
#     as partial sums, but ``w_colsum`` is a full-K reduction and cannot be
#     sliced — the caller supplies local column sums
#     (``programmed_linear(colsum=...)``).


def _pspec_entries(wspec, ndim: int) -> Tuple[Any, ...]:
    """Normalize a spec (possibly shorter than ndim) to ``ndim`` entries."""
    entries = tuple(wspec) if wspec is not None else ()
    if len(entries) > ndim:
        raise ValueError(f"spec {wspec} longer than weight rank {ndim}")
    return entries + (None,) * (ndim - len(entries))


def _field_specs(fields, ndim: int, wspec) -> Dict[str, Tuple[Any, ...]]:
    entries = _pspec_entries(wspec, ndim)
    stack, kspec, nspec = entries[:-2], entries[-2], entries[-1]
    specs = {
        "w_codes": (*stack, kspec, nspec),
        "g_eff": (*stack, None, kspec, nspec),  # the bit-plane axis stays whole
        # no K axis: under K-sharding it stays the *global* correction term
        "w_colsum": (*stack, nspec),
        "w_scale": (*stack,),
        "x_scale": (*stack,),
        # the spare block is a per-group column budget, not output columns
        "g_spare": (*stack, None, kspec, None),
        # (S, R, N) routing tables: slice / row-group axes are physical
        "out_gather": (*stack, None, None, nspec),
        "comp_scale": (*stack, nspec),
    }
    return {f: specs[f] for f in ARTIFACT_ARRAY_FIELDS if f in fields}


def artifact_shard_specs(art: ProgrammedLinear, wspec) -> Dict[str, Tuple[Any, ...]]:
    """{array field: spec} matching the shadowed weight's spec ``wspec``
    ((…stack, K, N) axes): stacking axes map one-to-one, ``g_eff`` /
    ``g_spare`` keep their bit-plane axis replicated, column-shaped leaves
    follow N."""
    fields = [f for f in ARTIFACT_ARRAY_FIELDS if getattr(art, f) is not None]
    return _field_specs(fields, art.w_codes.ndim, wspec)


def _axes_size(entry, axis_sizes) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(axis_sizes[a]) for a in axes)


def dividing_pspec(spec, shape, axis_sizes) -> Tuple[Any, ...]:
    """Degrade non-dividing spec entries to replicated: an entry is kept
    only if every named axis is in ``axis_sizes`` (a mesh's ``shape``) and
    their total size divides the dim.  Placement (``shard_artifacts``), the
    store's restore and ``local_artifact`` all go through this one rule."""
    fixed = []
    for dim, ax in zip(shape, _pspec_entries(spec, len(shape))):
        axes = ax if isinstance(ax, tuple) else (ax,)
        if ax is None or any(a not in axis_sizes for a in axes):
            fixed.append(None)
        else:
            fixed.append(ax if dim % _axes_size(ax, axis_sizes) == 0 else None)
    return tuple(fixed)


def artifact_arrays(art: ProgrammedLinear) -> Dict[str, torch.Tensor]:
    """{field: array} for every non-None array leaf."""
    return {f: getattr(art, f) for f in ARTIFACT_ARRAY_FIELDS if getattr(art, f) is not None}


def with_arrays(template: ProgrammedLinear, arrays: Dict[str, torch.Tensor]) -> ProgrammedLinear:
    """Rebuild an artifact from (rank-local) arrays and a template's static
    data; fields absent from ``arrays`` become None.  Reports and the
    placement record describe the *global* chip and are dropped."""
    missing = {f: None for f in ARTIFACT_ARRAY_FIELDS if f not in arrays}
    return dataclasses.replace(template, report=None, repair=None, sharding=None, **arrays, **missing)


def shard_artifacts(prog: "ProgrammedModel", mesh, specs: Dict[str, Any]) -> "ProgrammedModel":
    """Record where a deployment on ``mesh`` places every artifact: ``specs``
    maps canonical names to the shadowed weight's spec (names it lacks stay
    replicated); each field's spec is degraded per entry by
    ``dividing_pspec`` against ``mesh.shape``.  Returns a new
    ProgrammedModel of the same global arrays, each artifact carrying its
    ``sharding`` record (None where every field is replicated)."""

    def place(name: str, art: ProgrammedLinear) -> ProgrammedLinear:
        wspec = specs.get(name)
        if wspec is None:
            return art
        record = {}
        for f, spec in artifact_shard_specs(art, wspec).items():
            fixed = dividing_pspec(spec, getattr(art, f).shape, mesh.shape)
            if any(e is not None for e in fixed):
                record[f] = fixed
        return dataclasses.replace(art, sharding=record or None)

    def remap(tree, path):
        if isinstance(tree, ProgrammedLinear):
            return place("/".join(path), tree)
        if isinstance(tree, dict):
            return {k: remap(v, path + (str(k),)) for k, v in tree.items()}
        return tree

    return ProgrammedModel(remap(prog.artifacts, ()))


def _block(entry, dim: int, axis_sizes, coords) -> slice:
    """This rank's block of one dim under a (dividing) spec entry: the axes
    of a tuple entry linearised row-major, like the mesh's rank order."""
    if entry is None:
        return slice(None)
    idx = 0
    for a in entry if isinstance(entry, tuple) else (entry,):
        idx = idx * int(axis_sizes[a]) + int(coords[a])
    step = dim // _axes_size(entry, axis_sizes)
    return slice(idx * step, (idx + 1) * step)


def local_slice(a, spec, axis_sizes, coords):
    """This rank's block of array ``a`` (a tensor or a numpy array, a view
    where it can be) under ``spec``; non-dividing entries keep the dim."""
    fixed = dividing_pspec(spec, tuple(a.shape), axis_sizes)
    return a[tuple(_block(e, d, axis_sizes, coords) for e, d in zip(fixed, a.shape))]


def _reindex_repair(gather: np.ndarray, spare: np.ndarray, n_cols: int, n_loc: int):
    """Re-index a rank's column slice of the routing tables (stack + (S, R,
    n_loc), global coordinates) to local columns, and compact its spare
    block (stack + (S, K, B)) to the spares those columns use, one local
    numbering shared by every table of a chip (a spare is one physical
    column of every array of its group)."""
    lead = gather.shape[:-3]
    gather = gather.reshape((-1,) + gather.shape[-3:]).copy()
    spare2 = spare.reshape((-1,) + spare.shape[-3:])
    new_spares = []
    for i in range(gather.shape[0]):
        flat = gather[i].reshape(-1, gather.shape[-1])
        used: list = []
        for u in range(flat.shape[0]):
            for j in range(n_loc):
                g = int(flat[u, j])
                if g < n_cols:
                    # repair only ever redirects a column to a spare, so a
                    # data column's global value is its own position: j
                    flat[u, j] = j
                else:
                    b = g - n_cols
                    if b not in used:
                        used.append(b)
                    flat[u, j] = n_loc + used.index(b)
        new_spares.append(spare2[i][..., used] if used else spare2[i][..., :0])
    width = max((s.shape[-1] for s in new_spares), default=0)
    padded = [np.pad(s, [(0, 0)] * (s.ndim - 1) + [(0, width - s.shape[-1])]) for s in new_spares]
    spare_out = np.stack(padded).reshape(lead + padded[0].shape) if lead else padded[0]
    return gather.reshape(lead + gather.shape[-3:]), spare_out


def local_fields(arrays: Dict[str, Any], wspec, axis_sizes, coords) -> Dict[str, Any]:
    """One rank's slice of an artifact's ``{field: array}`` (tensors or
    numpy arrays, e.g. the members of a store's ``.npz``) under the weight
    spec ``wspec``; where N is sharded and the chip carries repair tables,
    ``out_gather`` is re-indexed to local columns and ``g_spare`` compacted
    (``_reindex_repair``)."""
    w_shape = tuple(arrays["w_codes"].shape)
    specs = _field_specs(tuple(arrays), len(w_shape), wspec)
    out = {f: local_slice(a, specs[f], axis_sizes, coords) for f, a in arrays.items()}
    nspec = dividing_pspec(wspec, w_shape, axis_sizes)[-1]
    if nspec is not None and "out_gather" in out:
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        gather, spare = _reindex_repair(
            host(out["out_gather"]), host(out["g_spare"]), w_shape[-1], w_shape[-1] // _axes_size(nspec, axis_sizes)
        )
        for f, new in (("out_gather", gather), ("g_spare", spare)):
            out[f] = torch.from_numpy(new).to(out[f].device) if isinstance(out[f], torch.Tensor) else new
    return out


def local_artifact(
    art: ProgrammedLinear, wspec, axis_sizes: Dict[str, int], coords: Dict[str, int]
) -> ProgrammedLinear:
    """One rank's slice of an artifact: ``axis_sizes`` gives the mesh extent
    of every named axis in ``wspec``, ``coords`` the rank's coordinate on
    each.  Every array leaf is sliced along the weight's sharded axes (a
    contiguous copy on the artifact's device); repair tables are re-indexed
    to local columns (``local_fields``).  Serving never reads the repair
    tables (``g_eff`` holds the repaired layout); they are the rank's
    hardware record."""
    arrays = local_fields(artifact_arrays(art), wspec, axis_sizes, coords)
    return with_arrays(art, {f: a.contiguous() for f, a in arrays.items()})


# ---------------------------------------------------------------------------
# Name-keyed artifact binding
# ---------------------------------------------------------------------------

_SCOPE = threading.local()  # .stack: list[str] — the active module path


@contextlib.contextmanager
def name_scope(name: str):
    """Push one path component onto the ambient parameter-name scope."""
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    stack.append(str(name))
    try:
        yield
    finally:
        stack.pop()


def scoped_name(name: str) -> str:
    """Join ``name`` onto the active scope: the canonical artifact key."""
    return "/".join(getattr(_SCOPE, "stack", []) + [str(name)])


def artifact_names(artifacts: Any, prefix: str = "") -> Dict[str, ProgrammedLinear]:
    """Flatten an artifact (sub)tree into {joined path: artifact}."""
    out: Dict[str, ProgrammedLinear] = {}
    for path, art in walk(artifacts):
        if isinstance(art, ProgrammedLinear):
            out["/".join(p for p in (prefix, "/".join(path)) if p)] = art
    return out


_CONSUMED = threading.local()  # .names: dict[str, None] (insertion-ordered set)


def record_artifact_consumed(name: str) -> None:
    names = getattr(_CONSUMED, "names", None)
    if names is None:
        names = _CONSUMED.names = {}
    names[name] = None


def consumed_artifact_names() -> Tuple[str, ...]:
    """Canonical names served from artifacts since the last reset."""
    return tuple(getattr(_CONSUMED, "names", {}))


def reset_consumed_artifact_names() -> None:
    _CONSUMED.names = {}


_BIND = threading.local()  # .maps: list of {name -> ProgrammedLinear}


@contextlib.contextmanager
def _push_bind_map(m: Dict[str, ProgrammedLinear]):
    stack = getattr(_BIND, "maps", None)
    if stack is None:
        stack = _BIND.maps = []
    stack.append(m)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def bind_artifacts(artifacts: Any):
    """Bind a (sub)tree of artifacts by name for the dynamic scope; keys are
    the subtree's own paths joined under the current ``name_scope``.  Later
    binds shadow earlier ones."""
    if artifacts is None:
        yield
        return
    m = artifact_names(artifacts, prefix="/".join(getattr(_SCOPE, "stack", [])))
    with _push_bind_map(m):
        yield


def active_artifact_for(
    name: str, shape: Optional[Tuple[int, ...]] = None
) -> Optional[ProgrammedLinear]:
    """Artifact bound to this canonical name in the dynamic scope, if any.
    The shape guard rejects a still-stacked artifact when a 2-D weight asks,
    and keeps apart two tensors that share a name (the embedding table vs its
    transposed LM-head artifact)."""
    for m in reversed(getattr(_BIND, "maps", [])):
        art = m.get(name)
        if art is not None and (shape is None or art.shape == tuple(shape)):
            return art
    return None


# Projection leaves routed through models.layers.crossbar_linear.
_CROSSBAR_CONSUMERS = (
    "wq", "wk", "wv", "wo", "w_kv_down", "wi", "head",
    "wg", "router", "shared_wi", "shared_wg", "shared_wo",
)


def _matmul_leaf(path: Tuple[str, ...], leaf: Any) -> bool:
    """Default predicate: which param leaves go onto crossbars (an allowlist
    of projection names, as 2-D, layer-stacked 3-D or 4-D expert banks)."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim not in (2, 3, 4):
        return False
    if not leaf.is_floating_point():
        return False
    return bool(path) and path[-1] in _CROSSBAR_CONSUMERS


class ProgrammedModel:
    """A nested dict of ProgrammedLinear artifacts mirroring a params dict;
    ``by_name`` is the canonical path-keyed table every lookup resolves
    through.  Nothing references parameter objects: a ProgrammedModel built
    once serves any congruent params tree."""

    def __init__(self, artifacts: Any):
        self.artifacts = artifacts
        self.by_name: Dict[str, ProgrammedLinear] = artifact_names(artifacts)
        self._layer_maps: Dict[str, Optional[List[Dict[str, ProgrammedLinear]]]] = {}

    def bind(self):
        """Bind every artifact by name for the dynamic scope."""
        return _push_bind_map(self.by_name)

    def subtree(self, key: str) -> Any:
        """Artifact subtree for one top-level params key (e.g. "stage0")."""
        try:
            return self.artifacts[key]
        except (KeyError, TypeError, IndexError):
            return None

    def stage_layer_maps(self, key: str) -> Optional[List[Dict[str, ProgrammedLinear]]]:
        """Per-layer bind maps of a layer-stacked stage: entry ``r`` maps the
        canonical names under ``key`` to layer ``r``'s artifact views
        (``(K, N)``, or ``(E, K, N)`` for an expert bank, which the MoE
        FFN slices per expert).  Built
        once and kept, so a forward binds a dict instead of re-slicing every
        artifact at every step.  Non-stacked artifacts under the stage are
        left out (they cannot be sliced per layer)."""
        if key not in self._layer_maps:
            sub = {
                n: a for n, a in artifact_names(self.subtree(key), prefix=key).items() if a.stacked
            }
            maps = None
            if sub:
                depth = {a.shape[0] for a in sub.values()}
                if len(depth) != 1:
                    raise ValueError(f"artifacts under {key!r} disagree on the layer count: {depth}")
                maps = [{n: a.layer(r) for n, a in sub.items()} for r in range(depth.pop())]
            self._layer_maps[key] = maps
        return self._layer_maps[key]

    def lookup(
        self, name: str, shape: Optional[Tuple[int, ...]] = None
    ) -> Optional[ProgrammedLinear]:
        """Artifact for a canonical name, optionally shape-checked."""
        art = self.by_name.get(name)
        if art is not None and (shape is None or art.shape == tuple(shape)):
            return art
        return None

    @property
    def n_compiled(self) -> int:
        return len(self.by_name)

    @property
    def calls_per_forward(self) -> int:
        """Projections a forward serves from this chip: an expert bank (L, E,
        K, N) once an expert a layer, a layer-stacked artifact once a layer,
        a 2-D one (a head) once."""
        return sum(
            a.shape[0] * a.shape[1] if a.w_codes.ndim == 4 else a.shape[0] if a.stacked else 1
            for a in self.by_name.values()
        )

    @property
    def emitted_names(self) -> frozenset:
        return frozenset(self.by_name)

    def verify_consumed(self, consumed: Optional[Any] = None) -> None:
        """Assert a forward consumed exactly the emitted name set; raises
        ``LookupError`` on any emitted artifact no call site served (a
        renamed layer produces an orphaned artifact and zero misses)."""
        got = frozenset(consumed_artifact_names() if consumed is None else consumed)
        unconsumed = self.emitted_names - got
        unexpected = got - self.emitted_names
        if unconsumed:
            raise LookupError(
                "programmed-artifact name-set drift: "
                f"{len(unconsumed)}/{len(self.by_name)} emitted artifacts were "
                f"never consumed by the forward ({', '.join(sorted(unconsumed)[:5])}"
                + (", ..." if len(unconsumed) > 5 else "")
                + ")"
                + (
                    f"; consumed-but-not-emitted: {', '.join(sorted(unexpected)[:5])}"
                    if unexpected
                    else ""
                )
                + " — a layer was renamed, or program_model compiled a leaf "
                "no call site serves."
            )


    def reports(self) -> Dict[str, Any]:
        """Name -> write-verify ``ProgramReport`` (a per-layer tuple for a
        stacked leaf) of every compiled leaf that has one."""
        return {name: art.report for name, art in self.by_name.items() if art.report is not None}

    def repair_reports(self) -> Dict[str, Any]:
        """Name -> ``RepairReport`` (a per-layer tuple for a stacked leaf) of
        every repaired leaf."""
        return {name: art.repair for name, art in self.by_name.items() if art.repair is not None}

    def map_artifacts(self, fn: Callable[[ProgrammedLinear], ProgrammedLinear]) -> "ProgrammedModel":
        """A new ProgrammedModel with ``fn`` applied to every artifact."""

        def remap(tree):
            if isinstance(tree, ProgrammedLinear):
                return fn(tree)
            if isinstance(tree, dict):
                return {k: remap(v) for k, v in tree.items()}
            return tree

        return ProgrammedModel(remap(self.artifacts))

    @property
    def t_service_s(self) -> float:
        """Fleet service time: the oldest chip's clock."""
        return max((a.t_service_s for a in self.by_name.values()), default=0.0)

    def age(self, dt_s: float) -> "ProgrammedModel":
        """Every chip advanced ``dt_s`` seconds of service (no reprogramming)."""
        return self.map_artifacts(lambda a: age_artifact(a, dt_s))

    def at_time(self, t_s: float) -> "ProgrammedModel":
        """Every chip at absolute service time ``t_s``."""
        return self.map_artifacts(lambda a: artifact_at_time(a, t_s))


def _program_action(path, leaf, pred, tie_lm_head: bool) -> Optional[str]:
    """"program" the leaf, "transpose" it first (tied-head ``tokens``
    embeddings), or None when it stays digital."""
    if (
        tie_lm_head
        and path
        and path[-1] == "tokens"
        and isinstance(leaf, torch.Tensor)
        and leaf.ndim == 2
        and leaf.is_floating_point()
    ):
        return "transpose"
    if pred(path, leaf):
        return "program"
    return None


def program_model(
    params: Any,
    spec: CrossbarSpec = DEFAULT_SPEC,
    device_cfg: Optional[dm.DeviceConfig] = None,
    adc_cfg: Optional[ADCConfig] = SAFE_ADAPTIVE,
    *,
    fast: bool = True,
    tie_lm_head: bool = False,
    leaf_filter: Optional[Callable[[Tuple[str, ...], Any], bool]] = None,
    expert_chips: Optional[Tuple[int, ...]] = None,
    plan: Optional[ChipPlan] = None,
    device="cuda",
) -> ProgrammedModel:
    """Walk a nested params dict and compile every matmul-shaped leaf on
    ``device`` (each leaf is moved there for programming; the artifacts stay
    there).  ``tie_lm_head=True`` additionally compiles the transpose of every
    2-D ``tokens`` embedding under the embedding's own name — the (D, V)
    artifact shares the key with the (V, D) leaf and shape-checked lookup keeps
    the two apart.  ``expert_chips`` gives every 4-D expert bank one chip
    identity per expert (``program_layer(chips=)`` on its expert axis), so
    each expert's slab draws its own device perturbations; 2-D and 3-D
    leaves keep the base device.  ``plan`` (a ``core.planner.ChipPlan``,
    e.g. from ``planner.plan_model`` on the same params) compiles each leaf
    under the ``LayerPlan`` of its canonical name; leaves it does not cover
    compile homogeneous."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("program_model(device='cuda') needs a CUDA device; pass device='cpu'")
    pred = leaf_filter if leaf_filter is not None else _matmul_leaf
    artifacts: Dict[str, Any] = {}
    for path, leaf in walk(params):
        action = _program_action(path, leaf, pred, tie_lm_head)
        if action is None:
            continue
        w = leaf.to(device)
        art = program_layer(
            w.T.contiguous() if action == "transpose" else w, spec, device_cfg, adc_cfg, fast=fast,
            chips=(tuple(expert_chips) if expert_chips is not None and leaf.ndim == 4 else None),
            plan=(plan.layer_for("/".join(path)) if plan is not None else None),
        )
        node = artifacts
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = art
    return ProgrammedModel(artifacts)


def expected_artifact_names(
    params: Any,
    *,
    tie_lm_head: bool = False,
    leaf_filter: Optional[Callable[[Tuple[str, ...], Any], bool]] = None,
) -> Dict[str, Tuple[int, ...]]:
    """{canonical name: servable shape} ``program_model`` would compile —
    without programming anything."""
    pred = leaf_filter if leaf_filter is not None else _matmul_leaf
    out: Dict[str, Tuple[int, ...]] = {}
    for path, leaf in walk(params):
        action = _program_action(path, leaf, pred, tie_lm_head)
        if action is not None:
            shape = tuple(leaf.shape)
            out["/".join(path)] = tuple(reversed(shape)) if action == "transpose" else shape
    return out
