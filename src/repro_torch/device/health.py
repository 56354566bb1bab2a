"""Drift health monitoring and free digital compensation (counterpart of
``repro.device.health``).

A programmed chip decays in service (``models.drift_time_factor``) while its
digital record — ``w_codes``, ``w_colsum``, the scales — never ages:

* **Monitor** (``probe_artifact`` / ``health_check``): push a seeded batch of
  non-negative probes through the served (possibly aged) artifact and
  through its *digital twin* (every analog leaf stripped, so
  ``programmed_matmul`` serves the ideal ``w_codes`` path); the relative
  probe error is the layer's drift health, held against a budget.
* **Compensate** (``fit_compensation``): retention drift is nearly a common
  conductance scale, so a digital per-column output rescale
  (``ProgrammedLinear.comp_scale``, outside the chip: no reprogramming)
  recovers most of it — the closed-form ``1/f`` refined by a per-column
  least-squares fit of the probe responses.
* **Refresh** (``checkpoint.swap_active`` + ``ServingEngine.hot_swap``):
  reprogram into the inactive store slot and swap.

The probes come from a CPU ``torch.Generator`` seeded from ``(seed, k)`` and
are moved to the artifact's device, so a reading is the same on any host
(they are not the reference's ``jax.random`` draws).  Nothing here touches
the programmed cells.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.device import models as dm
from repro_torch.device.programmed import ProgrammedLinear, ProgrammedModel, programmed_matmul

DEFAULT_PROBES = 16
DEFAULT_BUDGET = 0.05  # relative RMS probe error a healthy layer stays under


def digital_twin(art: ProgrammedLinear) -> ProgrammedLinear:
    """The artifact's frozen digital reference: no ``g_eff`` / ``g_spare`` /
    ``out_gather``, no compensation, no reports — ``programmed_matmul``
    serves the ideal ``w_codes`` datapath with the chip's own scales."""
    return dataclasses.replace(
        art, g_eff=None, g_spare=None, out_gather=None, comp_scale=None, report=None, repair=None,
    )


def probe_vectors(k: int, n_probes: int = DEFAULT_PROBES, seed: int = 0, device="cpu") -> torch.Tensor:
    """Seeded probe batch (n_probes, k), uniform on [2**-10, 1): non-negative
    (``programmed_matmul``'s input domain) and strictly positive, so every
    row of the chip is exercised.  Drawn on the CPU from ``(seed, k)``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(k)) % (1 << 63))
    lo = 1.0 / (1 << 10)
    u = torch.rand((n_probes, k), generator=gen, dtype=torch.float32)
    return (lo + u * (1.0 - lo)).to(device)


def _leading_slices(art: ProgrammedLinear) -> Iterator[ProgrammedLinear]:
    """Every servable (K, N) slice of a (possibly stacked) artifact."""
    if not art.stacked:
        yield art
        return
    for i in range(art.shape[0]):
        yield from _leading_slices(art.layer(i))


def probe_artifact(
    art: ProgrammedLinear,
    n_probes: int = DEFAULT_PROBES,
    seed: int = 0,
    *,
    probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(served, reference) probe responses, (n_slices, n_probes, N) each:
    the artifact as bound (aged cells, repair layout, compensation) and its
    digital twin.  ``probes`` injects the batch."""
    xs = probe_vectors(int(art.shape[-2]), n_probes, seed) if probes is None else probes
    xs = xs.to(art.w_codes.device)
    served, ref = [], []
    for sl in _leading_slices(art):
        served.append(programmed_matmul(xs, sl))
        ref.append(programmed_matmul(xs, digital_twin(sl)))
    return torch.stack(served), torch.stack(ref)


@dataclasses.dataclass(frozen=True)
class LayerHealth:
    """One bound artifact's drift reading."""

    name: str
    rel_err: float  # ||served - reference|| / ||reference|| over the probes
    mse: float
    t_service_s: float
    budget: float

    @property
    def over_budget(self) -> bool:
        return self.rel_err > self.budget


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Per-layer drift health for a whole programmed model."""

    layers: Tuple[LayerHealth, ...]
    budget: float

    @property
    def flagged(self) -> Tuple[str, ...]:
        """Names whose probe error crossed the budget: refresh candidates."""
        return tuple(h.name for h in self.layers if h.over_budget)

    @property
    def worst(self) -> float:
        return max((h.rel_err for h in self.layers), default=0.0)

    @property
    def healthy(self) -> bool:
        return not self.flagged

    def __repr__(self) -> str:
        return (
            f"HealthReport(worst={self.worst:.4g}, budget={self.budget:g}, "
            f"flagged={len(self.flagged)}/{len(self.layers)})"
        )


def layer_health(
    name: str,
    art: ProgrammedLinear,
    n_probes: int = DEFAULT_PROBES,
    seed: int = 0,
    budget: float = DEFAULT_BUDGET,
    *,
    probes: Optional[torch.Tensor] = None,
) -> LayerHealth:
    """Probe one artifact against its digital twin."""
    served, ref = probe_artifact(art, n_probes, seed, probes=probes)
    diff = served - ref
    mse = float(torch.mean(diff**2))
    rel = float(torch.sqrt(torch.sum(diff**2)) / torch.clamp(torch.sqrt(torch.sum(ref**2)), min=1e-12))
    return LayerHealth(name=name, rel_err=rel, mse=mse, t_service_s=art.t_service_s, budget=budget)


def health_check(
    prog: ProgrammedModel,
    n_probes: int = DEFAULT_PROBES,
    seed: int = 0,
    budget: float = DEFAULT_BUDGET,
) -> HealthReport:
    """Probe every bound artifact (the serving engine's monitor)."""
    layers = tuple(
        layer_health(name, art, n_probes, seed, budget) for name, art in sorted(prog.by_name.items())
    )
    return HealthReport(layers=layers, budget=budget)


def closed_form_scale(art: ProgrammedLinear) -> float:
    """The zero-probe compensation ``1 / drift_time_factor(device, 0,
    t_service_s)``: undoes the common-mode decay since programming."""
    if art.device is None or art.g_eff is None or art.t_service_s == 0.0:
        return 1.0
    return 1.0 / dm.drift_time_factor(art.device, 0.0, art.t_service_s)


def fit_compensation(
    art: ProgrammedLinear,
    n_probes: int = DEFAULT_PROBES,
    seed: int = 0,
    *,
    probes: Optional[torch.Tensor] = None,
) -> ProgrammedLinear:
    """Refit the artifact's digital compensation scales, no reprogramming:
    per output column ``s_j = sum_i ref_ij served_ij / sum_i served_ij^2``
    on the ``1/f``-rescaled response of the chip *without* its current
    compensation (a refit replaces, never compounds), times ``1/f``.
    Degenerate columns keep the closed-form scale.  A stacked artifact gets
    one scale row per slice."""
    base = closed_form_scale(art)
    xs = probe_vectors(int(art.shape[-2]), n_probes, seed) if probes is None else probes
    xs = xs.to(art.w_codes.device)
    lead = art.shape[:-2]

    def fit(sl: ProgrammedLinear) -> torch.Tensor:
        served = programmed_matmul(xs, dataclasses.replace(sl, comp_scale=None)) * base
        ref = programmed_matmul(xs, digital_twin(sl))
        num = torch.sum(ref * served, dim=0)
        den = torch.sum(served * served, dim=0)
        resid = torch.where(den > 0.0, num / torch.clamp(den, min=1e-30), 1.0)
        return torch.tensor(base, dtype=torch.float32, device=xs.device) * resid

    scales = torch.stack([fit(sl) for sl in _leading_slices(art)])
    return dataclasses.replace(art, comp_scale=scales.reshape(lead + (int(art.shape[-1]),)))


def compensate_model(prog: ProgrammedModel, n_probes: int = DEFAULT_PROBES, seed: int = 0) -> ProgrammedModel:
    """``fit_compensation`` over every noisy artifact; ideal chips keep
    ``comp_scale=None``."""
    return prog.map_artifacts(
        lambda a: fit_compensation(a, n_probes, seed) if a.g_eff is not None else a
    )
