"""Adaptive (heterogeneous-resolution) SAR ADC model (counterpart of
``repro.core.adc``, paper §III.A.3, Fig 5).

The partial produced at (iteration ``t``, slice ``s``) occupies accumulator
bits ``[base, base + adc_bits)`` with ``base = t*dac_bits + s*cell_bits``; the
scaling stage keeps only ``[drop_lsb, drop_lsb + out_bits)``.  An ADC therefore
resolves only the bits of each conversion overlapping the window: below it the
conversion is rounded half-up at the unresolved granularity, above it one
comparison detects overflow and clamps (unsigned datapath only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    mode: str = "adaptive"  # "full" | "adaptive"
    guard_bits: int = 0  # LSBs kept below drop_lsb
    msb_clamp: bool = True  # resolve MSBs above window with 1 compare + clamp

    def replace(self, **kw) -> "ADCConfig":
        return dataclasses.replace(self, **kw)


FULL_ADC = ADCConfig(mode="full")
SAFE_ADAPTIVE = ADCConfig(mode="adaptive", guard_bits=4)  # < 1 ULP worst case
EXACT_ADAPTIVE = ADCConfig(mode="adaptive", guard_bits=DEFAULT_SPEC.drop_lsb)


def window(spec: CrossbarSpec, cfg: ADCConfig) -> Tuple[int, int]:
    """Absolute accumulator bit window [lo, hi) the ADCs must resolve (one
    extra MSB for biased signed weights)."""
    lo = max(0, spec.drop_lsb - cfg.guard_bits)
    hi = spec.drop_lsb + spec.out_bits + (1 if spec.signed_weights else 0)
    return lo, hi


def adaptive_schedule(spec: CrossbarSpec = DEFAULT_SPEC, cfg: ADCConfig = ADCConfig()) -> np.ndarray:
    """Fig-5 table: SAR bit decisions for conversion (t, s) -> (T, S) int64.

    ``full`` mode: every conversion resolves ``adc_bits`` bits.
    ``adaptive``: the bits of [base, base + adc_bits) overlapping [lo, hi),
    plus one comparison when the partial extends above the window (overflow
    detect)."""
    T, S = spec.n_iters, spec.n_slices
    table = np.zeros((T, S), dtype=np.int64)
    if cfg.mode == "full":
        table[:] = spec.adc_bits
        return table
    lo, hi = window(spec, cfg)
    for t in range(T):
        for s in range(S):
            base = spec.base_shift(t, s)
            top = base + spec.adc_bits
            kept = max(0, min(top, hi) - max(base, lo))
            extra = 1 if (cfg.msb_clamp and top > hi and kept > 0) else 0
            if top > hi and kept == 0:
                extra = 1 if cfg.msb_clamp else 0  # pure overflow detector
            table[t, s] = min(kept + extra, spec.adc_bits)
    return table


def mean_bits_per_conversion(spec: CrossbarSpec = DEFAULT_SPEC, cfg: ADCConfig = ADCConfig()) -> float:
    return float(adaptive_schedule(spec, cfg).mean())


def lsb_error_bound(spec: CrossbarSpec, cfg: ADCConfig, k: int) -> float:
    """Worst-case |error| in output ULPs from LSB-side rounding of a
    ``k``-row dot product: each truncated conversion errs by at most half
    its granule."""
    if cfg.mode == "full":
        return 0.0
    lo, _ = window(spec, cfg)
    groups = -(-k // spec.rows)
    err = 0.0
    for t in range(spec.n_iters):
        for s in range(spec.n_slices):
            base = spec.base_shift(t, s)
            g = max(0, lo - base)
            if g > 0:
                err += groups * (2 ** (g - 1)) * (2 ** base)
    return err / (2 ** spec.drop_lsb)


def schedule_tables(spec: CrossbarSpec, cfg: Optional[ADCConfig]):
    """Static per-(t, s) tables: LSB shift ``g`` (round-half-up to a multiple
    of ``2**g``) and MSB detect position ``d`` (None: no detect).  Detects
    exist only on the unsigned datapath — on biased weights the bias moves
    the window, so clamp detection there is unsound."""
    T, S = spec.n_iters, spec.n_slices
    if cfg is None or cfg.mode == "full":
        return [[0] * S for _ in range(T)], [[None] * S for _ in range(T)]
    lo, hi = window(spec, cfg)
    shifts, detects = [], []
    for t in range(T):
        srow, drow = [], []
        for s in range(S):
            base = spec.base_shift(t, s)
            srow.append(min(max(lo - base, 0), spec.adc_bits))
            hi_rel = hi - base
            detect = cfg.msb_clamp and hi_rel < spec.adc_bits and not spec.signed_weights
            drow.append(int(hi_rel) if detect else None)
        shifts.append(srow)
        detects.append(drow)
    return shifts, detects


def make_partial_transform(spec: CrossbarSpec, cfg: Optional[ADCConfig]):
    """``partial_transform`` hook for ``core.crossbar``: per (t, s) conversion,
    LSB rounding at granularity ``2**g`` and — unsigned datapath only — MSB
    overflow detection.  None for full-resolution ADCs."""
    if cfg is None or cfg.mode == "full":
        return None
    shifts, detects = schedule_tables(spec, cfg)
    T, S = spec.n_iters, spec.n_slices
    has_detect = any(d is not None for row in detects for d in row)
    g_np = np.asarray(shifts, np.int64).reshape(T, S, 1, 1, 1)
    half_np = np.where(g_np > 0, 1 << np.maximum(g_np - 1, 0), 0)
    # a detect position below 0 means every nonzero partial overflows
    d_np = np.asarray(
        [[max(d, 0) if d is not None else 62 for d in row] for row in detects], np.int64
    ).reshape(T, S, 1, 1, 1)

    def transform(partials: torch.Tensor, spec_: CrossbarSpec):
        dev = partials.device
        g = torch.as_tensor(g_np, device=dev)
        p = ((partials + torch.as_tensor(half_np, device=dev)) >> g) << g
        if not has_detect:
            return p, None
        return p, (p >> torch.as_tensor(d_np, device=dev)) > 0

    return transform


# ---------------------------------------------------------------------------
# SAR ADC energy model (Kull et al. [18]; Murmann survey [23])
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SARModel:
    """Power split of a SAR ADC at full resolution and rate (Table I): a
    CDAC share charged per sample, comparator and digital shares scaling
    linearly in the bits resolved (the modern split of §III.A.3)."""

    power_w: float = 3.1e-3  # 8-bit @ 1.28 GS/s (Kull) — Table I
    sample_rate: float = 1.28e9
    full_bits: int = 8
    cdac_frac: float = 0.10
    digital_frac: float = 0.45
    analog_frac: float = 0.45

    @property
    def energy_per_sample_j(self) -> float:
        return self.power_w / self.sample_rate

    def energy_pj(self, bits: float) -> float:
        """Energy (pJ) of one conversion resolving ``bits`` bits."""
        e_full = self.energy_per_sample_j * 1e12
        if bits <= 0:
            return 0.0
        frac = bits / self.full_bits
        return e_full * (self.cdac_frac + (self.digital_frac + self.analog_frac) * frac)

    def mean_energy_pj(self, schedule: np.ndarray) -> float:
        return float(np.mean([self.energy_pj(b) for b in schedule.ravel()]))


DEFAULT_SAR = SARModel()
