"""Memristor device non-ideality models (counterpart of
``repro.device.models``).

Composable, seeded models of everything between "the mapper assigns cell code
``c``" and "the column ADC samples a current": conductance level quantization
over the rails ``[g_off_s, g_on_s]``, lognormal programming variation,
power-law drift, stuck-at faults, first-order IR drop; the service-time
drift clock (``drift_time_factor`` / ``age_effective_codes``); and the entry
to spare-column repair (``effective_cell_codes(repair=True)`` routes through
``device.repair``).

Randomness: each stochastic stage takes its random field as an optional
argument (``u`` uniform in [0, 1) for the fault map, ``z`` standard normal per
write pulse) and otherwise draws it from a ``torch.Generator`` seeded from
``(seed, chip, stage index, slab tag[, pulse])``.  The draws are a
deterministic function of (config, weights) but are *not* the draws the JAX
package makes from the same seed — a chip programmed there is carried over
through the artifact store, not re-derived.

Effective cell values are returned in code units on a ``2**-GEFF_FRAC_BITS``
grid, which is what lets the noisy kernel be held bit-identical to its plain
version (``repro_torch.kernels.noisy_vmm``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.crossbar import CrossbarSpec

GEFF_FRAC_BITS = 8

# one independent randomness stream per stage, each with its own index; the
# repair planner's spare block draws its faults and pulses from the last two
STAGE_FAULTS = "faults"
STAGE_PROGRAM = "program"
STAGE_SPARE_FAULTS = "spare_faults"
STAGE_SPARE_PROGRAM = "spare_program"

_STAGES = {
    STAGE_FAULTS: 0,
    STAGE_PROGRAM: 1,
    STAGE_SPARE_FAULTS: 2,
    STAGE_SPARE_PROGRAM: 3,
}


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Programmed-conductance non-ideality knobs (all default to ideal).

    ``spare_cols`` provisions redundant spare columns per 128-column group
    for the repair planner (``device.repair``); ``temp_k`` / ``drift_ea_ev``
    scale the drift exponent Arrhenius-style; ``chip`` is a physical chip
    identity mixed into every seeded draw (``chip=0`` is the single die).
    """

    sigma: float = 0.0  # lognormal programming variation of ln(G)
    p_stuck_on: float = 0.0  # fraction of cells pinned at g_on_s
    p_stuck_off: float = 0.0  # fraction of cells pinned at g_off_s
    drift_nu: float = 0.0  # power-law drift exponent
    t_drift_s: float = 0.0  # time since programming (seconds)
    t0_s: float = 1.0  # drift reference time
    r_line_ohm: float = 0.0  # wire resistance per cell segment
    g_on_s: float = 316e-6  # device rails (siemens)
    g_off_s: float = 3.16e-6
    write_verify_iters: int = 1  # programming pulses (1 = open-loop write)
    write_verify_tol: float = 0.25  # verify tolerance, cell-code units
    spare_cols: int = 0  # spare columns per crossbar column group (repair)
    temp_k: float = 300.0  # operating temperature (drift Arrhenius scaling)
    drift_ea_ev: float = 0.0  # drift activation energy (eV); 0 = T-independent
    chip: int = 0  # physical chip identity (decorrelates fleet draws)
    seed: int = 0

    def replace(self, **kw) -> "DeviceConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_ideal(self) -> bool:
        return (
            self.sigma == 0.0
            and self.p_stuck_on == 0.0
            and self.p_stuck_off == 0.0
            and (self.drift_nu == 0.0 or self.t_drift_s == 0.0)
            and self.r_line_ohm == 0.0
        )


IDEAL_DEVICE = DeviceConfig()

_MASK32 = 0xFFFFFFFF


def slab_tag(w_codes_biased: torch.Tensor) -> int:
    """Content-derived uint32 tag mixed into the stage seeds per weight slab
    (the reference's position-weighted wrapping sum: uint32 arithmetic done
    in int64 and masked), so same-shape slabs draw independent fields."""
    w = w_codes_biased.reshape(-1).to(torch.int64) & _MASK32
    idx = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
    mix = (idx * 2654435761 + 1) & _MASK32
    return int((((w * mix) & _MASK32).sum() & _MASK32).item())


def stage_generator(
    cfg: DeviceConfig, stage: str, tag: int = 0, pulse: int = 0, device="cpu"
) -> torch.Generator:
    """Generator for one independent randomness stream of the pipeline."""
    seed = 0
    for part in (cfg.seed, cfg.chip, _STAGES[stage], tag, pulse):
        seed = (seed * 0x9E3779B97F4A7C15 + int(part) + 0x632BE59BD9B4E019) % (1 << 63)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# Conductance <-> cell-code mapping (level quantization)
# ---------------------------------------------------------------------------

def code_step_siemens(spec: CrossbarSpec, cfg: DeviceConfig) -> float:
    """Conductance per cell-code LSB: rails split into 2**cell_bits levels."""
    return (cfg.g_on_s - cfg.g_off_s) / ((1 << spec.cell_bits) - 1)


def conductance_of_codes(codes: torch.Tensor, spec: CrossbarSpec, cfg: DeviceConfig) -> torch.Tensor:
    return cfg.g_off_s + codes.to(torch.float32) * code_step_siemens(spec, cfg)


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by IEEE division on any device.  PyTorch's CUDA kernel
    multiplies by the reciprocal of a divisor given as a Python number (or
    any CPU scalar), which rounds differently now and then; a 0-d divisor on
    ``x``'s own device is divided by truly, as on the CPU and in the
    reference."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def codes_of_conductance(g: torch.Tensor, spec: CrossbarSpec, cfg: DeviceConfig) -> torch.Tensor:
    return _divide(g - cfg.g_off_s, code_step_siemens(spec, cfg))


def quantize_code_grid(codes: torch.Tensor) -> torch.Tensor:
    """Snap effective codes to the 2**-GEFF_FRAC_BITS grid."""
    scale = float(1 << GEFF_FRAC_BITS)
    return torch.round(codes * scale) / scale


# ---------------------------------------------------------------------------
# Stochastic / deterministic perturbation stages
# ---------------------------------------------------------------------------

def fault_masks(
    cfg: DeviceConfig,
    shape: Tuple[int, ...],
    tag: int = 0,
    stage: str = STAGE_FAULTS,
    *,
    u: Optional[torch.Tensor] = None,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disjoint (stuck_on, stuck_off) bool maps from a uniform field ``u``
    (drawn from the stage generator when not given)."""
    if u is None:
        u = torch.rand(
            shape, generator=stage_generator(cfg, stage, tag, device=device),
            dtype=torch.float32, device=device,
        )
    stuck_off = u < cfg.p_stuck_off
    stuck_on = (u >= cfg.p_stuck_off) & (u < cfg.p_stuck_off + cfg.p_stuck_on)
    return stuck_on, stuck_off


def apply_faults(
    g: torch.Tensor, masks: Tuple[torch.Tensor, torch.Tensor], cfg: DeviceConfig
) -> torch.Tensor:
    stuck_on, stuck_off = masks
    return torch.where(stuck_on, cfg.g_on_s, torch.where(stuck_off, cfg.g_off_s, g))


def program_variation(g: torch.Tensor, cfg: DeviceConfig, z: torch.Tensor) -> torch.Tensor:
    """One write pulse: lands lognormally around the target (median-
    preserving); ``z`` is the pulse's standard-normal field.

    The exponential is taken in float64 and rounded to float32: that is the
    correctly rounded float32 ``exp`` on the CPU and on the card alike, so a
    slab programmed from the same fields is the same chip on either (a
    float32 ``exp`` differs between them in the last bit, which moves a cell
    across a grid step now and then)."""
    if cfg.sigma == 0.0:
        return g
    return g * torch.exp((cfg.sigma * z).to(torch.float64)).to(torch.float32)


BOLTZMANN_EV_K = 8.617333262e-5
DRIFT_T_REF_K = 300.0


def effective_drift_nu(cfg: DeviceConfig) -> float:
    """Temperature-scaled drift exponent (Arrhenius in 1/T); exactly
    ``drift_nu`` at the 300 K reference or with ``drift_ea_ev == 0``."""
    if cfg.drift_ea_ev == 0.0 or cfg.temp_k == DRIFT_T_REF_K:
        return cfg.drift_nu
    arg = (cfg.drift_ea_ev / BOLTZMANN_EV_K) * (1.0 / DRIFT_T_REF_K - 1.0 / cfg.temp_k)
    # the reference evaluates this one exponential in float32
    return cfg.drift_nu * float(torch.exp(torch.tensor(arg, dtype=torch.float32)))


def apply_drift(g: torch.Tensor, cfg: DeviceConfig) -> torch.Tensor:
    """Power-law retention loss; identity at t=0 or nu=0."""
    nu = effective_drift_nu(cfg)
    if nu == 0.0 or cfg.t_drift_s == 0.0:
        return g
    return g * ((1.0 + cfg.t_drift_s / cfg.t0_s) ** (-nu))


def drift_time_factor(cfg: DeviceConfig, t_from_s: float, t_to_s: float) -> float:
    """Conductance decay between two *service* times, anchored at
    programming: ``((1 + (t_drift_s + t2)/t0) / (1 + (t_drift_s + t1)/t0))
    ** -nu`` as a Python float, exactly 1.0 when nothing drifts (``nu == 0``
    or ``t1 == t2``).  Time only runs forward."""
    nu = effective_drift_nu(cfg)
    if nu == 0.0 or t_to_s == t_from_s:
        return 1.0
    if t_to_s < t_from_s:
        raise ValueError(
            f"cannot run service time backwards: {t_to_s} < {t_from_s} "
            "(the fresh chip is gone; reprogram to rejuvenate)"
        )
    base = cfg.t_drift_s
    return float(
        ((1.0 + (base + t_to_s) / cfg.t0_s) / (1.0 + (base + t_from_s) / cfg.t0_s))
        ** (-nu)
    )


def age_effective_codes(
    codes: torch.Tensor, spec: CrossbarSpec, cfg: DeviceConfig, factor: float
) -> torch.Tensor:
    """Drift-evolve stored effective cell codes by a conductance decay
    ``factor``: back through the level map (``g = g_off + c * step``),
    decay, re-read through clip + grid quantization.  The caller
    short-circuits ``factor == 1.0``: the round trip is not a bit-exact
    identity."""
    step = code_step_siemens(spec, cfg)
    g = cfg.g_off_s + codes.to(torch.float32) * step
    aged = _divide(g * factor - cfg.g_off_s, step)
    aged = torch.clamp(aged, 0.0, float((1 << spec.cell_bits) - 1))
    return quantize_code_grid(aged)


def ir_drop_conductance(
    g: torch.Tensor, spec: CrossbarSpec, cfg: DeviceConfig, col_offset: int = 0
) -> torch.Tensor:
    """First-order line-resistance attenuation: a cell at (row ``i`` of its
    row group, column ``j``) sees ``(j + 1) * r`` along the wordline plus
    ``(rows - i) * r`` along the bitline; ``g / (1 + g * R_series)``.
    ``g``: (S, K, N) conductances."""
    if cfg.r_line_ohm == 0.0:
        return g
    S, K, N = g.shape
    i = (torch.arange(K, device=g.device) % spec.rows).to(torch.float32)
    j = torch.arange(N, dtype=torch.float32, device=g.device) + float(col_offset)
    r_series = ((j[None, :] + 1.0) + (spec.rows - i[:, None])) * cfg.r_line_ohm
    return g / (1.0 + g * r_series[None, :, :])


# ---------------------------------------------------------------------------
# Programming + read pipeline
# ---------------------------------------------------------------------------

def target_cell_codes(w_codes_biased: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """(K, N) biased weight codes -> (S, K, N) int32 ideal per-slice codes."""
    w = w_codes_biased.to(torch.int32)
    mask = (1 << spec.cell_bits) - 1
    return torch.stack([(w >> (s * spec.cell_bits)) & mask for s in range(spec.n_slices)])


def program_attempt(
    target_g: torch.Tensor,
    masks: Tuple[torch.Tensor, torch.Tensor],
    cfg: DeviceConfig,
    i: int,
    tag: int = 0,
    stage: str = STAGE_PROGRAM,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Write pulse ``i`` of a verify sequence: one noisy open-loop write with
    stuck cells pinned.  Its normal field is ``z_pulses[i]`` when given, else
    drawn from the (stage, tag, pulse) generator — the shared currency of
    ``write_verify_fixed``, ``program.write_verify`` and the spare block of
    ``device.repair``, which land the same conductances for the same pulse."""
    z = None
    if cfg.sigma != 0.0:
        if z_pulses is not None:
            z = z_pulses[i]
        else:
            z = torch.randn(
                target_g.shape,
                generator=stage_generator(cfg, stage, tag, pulse=i, device=target_g.device),
                dtype=torch.float32, device=target_g.device,
            )
    return apply_faults(program_variation(target_g, cfg, z), masks, cfg)


def write_verify_fixed(
    target: torch.Tensor,
    masks: Tuple[torch.Tensor, torch.Tensor],
    spec: CrossbarSpec,
    cfg: DeviceConfig,
    tag: int = 0,
    *,
    stage: str = STAGE_PROGRAM,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Fixed-iteration write-verify of target cell codes.

    With ``write_verify_iters <= 1`` an open-loop write (one noisy pulse);
    otherwise cells whose read-back code is more than ``write_verify_tol``
    from target are re-pulsed.  Stuck cells ignore every pulse.  ``stage``
    names the pulse stream (the spare block writes under its own);
    ``z_pulses`` supplies the per-pulse normal fields.
    """
    target_g = conductance_of_codes(target, spec, cfg)
    iters = max(1, cfg.write_verify_iters)

    def verified(g: torch.Tensor) -> torch.Tensor:
        return torch.abs(codes_of_conductance(g, spec, cfg) - target) <= cfg.write_verify_tol

    g = program_attempt(target_g, masks, cfg, 0, tag, stage, z_pulses)
    if iters > 1:
        done = verified(g)
        for i in range(1, iters):
            g = torch.where(done, g, program_attempt(target_g, masks, cfg, i, tag, stage, z_pulses))
            done = verified(g)
    return g


def read_effective_codes(
    g: torch.Tensor, spec: CrossbarSpec, cfg: DeviceConfig, col_offset: int = 0
) -> torch.Tensor:
    """Read-time view of programmed conductances: drift, IR drop, back
    through the level map, clip to the rails ``[0, 2**cell_bits - 1]``, snap
    to the grid.  (S, K, N) in, (S, K, N) float32 out."""
    g = apply_drift(g, cfg)
    g = ir_drop_conductance(g, spec, cfg, col_offset=col_offset)
    codes = codes_of_conductance(g, spec, cfg)
    codes = torch.clamp(codes, 0.0, float((1 << spec.cell_bits) - 1))
    return quantize_code_grid(codes)


def wants_repair(cfg: DeviceConfig) -> bool:
    """Spare-column repair would be active for this config."""
    return cfg.spare_cols > 0 and (cfg.p_stuck_on > 0.0 or cfg.p_stuck_off > 0.0)


def effective_cell_codes(
    w_codes_biased: torch.Tensor,
    spec: CrossbarSpec,
    cfg: DeviceConfig,
    repair: bool = True,
    *,
    u: Optional[torch.Tensor] = None,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
    u_spare: Optional[torch.Tensor] = None,
    z_spare_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full program+read pipeline: (K, N) biased codes -> (S, K, N) effective
    cell codes on the device of ``w_codes_biased``.  The ideal config returns
    the exact integer slices.  With a spare budget and stuck cells the
    layout is the *repaired* one (``device.repair``); ``repair=False``
    returns the primary columns only.  ``u`` / ``z_pulses`` (and the spare
    block's ``u_spare`` / ``z_spare_pulses``) inject the random fields."""
    if cfg.is_ideal:
        return target_cell_codes(w_codes_biased, spec).to(torch.float32)
    g_eff, target, tag, masks = programmed_effective(w_codes_biased, spec, cfg, u=u, z_pulses=z_pulses)
    if repair and wants_repair(cfg):
        from repro_torch.device import repair as repair_mod  # repair imports this module

        rplan = repair_mod.plan_repair(
            w_codes_biased, spec, cfg, target=target, tag=tag, primary_masks=masks,
            u_spare=u_spare, z_spare_pulses=z_spare_pulses,
        )
        g_eff = repair_mod.apply_repair(g_eff, rplan)
    return g_eff


def programmed_effective(
    w_codes_biased: torch.Tensor,
    spec: CrossbarSpec,
    cfg: DeviceConfig,
    *,
    u: Optional[torch.Tensor] = None,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
):
    """The programming pipeline with its intermediates exposed: (g_eff,
    target, tag, masks), so the repair planner reuses the slab's target
    slices, tag and primary fault draw instead of deriving them again."""
    target = target_cell_codes(w_codes_biased, spec)
    tag = slab_tag(w_codes_biased)
    masks = fault_masks(cfg, tuple(target.shape), tag, u=u, device=target.device)
    g = write_verify_fixed(target, masks, spec, cfg, tag, z_pulses=z_pulses)
    return read_effective_codes(g, spec, cfg), target, tag, masks
