"""Write-verify programming with host-side convergence reporting
(counterpart of ``repro.device.program``).

``models.write_verify_fixed`` is the fixed-iteration loop the programming
pipeline runs; ``write_verify`` drives the same pulses (``models.
program_attempt``: the same stage generator or injected fields per pulse
index), so its cells are bit-identical, and records what the programmer
saw: the mean error after each pulse, the converged and stuck fractions and
the residual error (means taken in float64).  It stops once every non-stuck
cell verifies — one host synchronisation a pulse, at programming time only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC
from repro_torch.device import models as dm


@dataclasses.dataclass(frozen=True)
class ProgramReport:
    """One write-verify run, errors in cell-code units (1.0 = one level)."""

    iterations: int
    converged_frac: float
    mean_abs_error: float
    max_abs_error: float
    stuck_frac: float
    per_iter_mean_error: Tuple[float, ...]


def write_verify(
    w_codes_biased: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    cfg: dm.DeviceConfig = dm.IDEAL_DEVICE,
    *,
    target: Optional[torch.Tensor] = None,
    tag: Optional[int] = None,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    u: Optional[torch.Tensor] = None,
    z_pulses: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ProgramReport]:
    """Program ``(K, N)`` biased weight codes; return (conductances, report).

    ``target`` / ``tag`` / ``masks`` take the pipeline's intermediates when
    the caller already derived them (they must match); ``u`` / ``z_pulses``
    inject the fault field and the pulses' normal fields.
    """
    if target is None:
        target = dm.target_cell_codes(w_codes_biased, spec)
    target_g = dm.conductance_of_codes(target, spec, cfg)
    if tag is None:
        tag = dm.slab_tag(w_codes_biased)
    if masks is None:
        masks = dm.fault_masks(cfg, tuple(target.shape), tag, u=u, device=target.device)
    stuck = masks[0] | masks[1]
    iters = max(1, cfg.write_verify_iters)

    g = dm.program_attempt(target_g, masks, cfg, 0, tag, z_pulses=z_pulses)
    per_iter = []
    done = None
    used = iters
    for i in range(iters):
        if i > 0:
            g = torch.where(done, g, dm.program_attempt(target_g, masks, cfg, i, tag, z_pulses=z_pulses))
        err = torch.abs(dm.codes_of_conductance(g, spec, cfg) - target)
        done = err <= cfg.write_verify_tol
        per_iter.append(float(err.to(torch.float64).mean()))
        if bool(torch.all(done | stuck)):
            used = i + 1
            break

    err = torch.abs(dm.codes_of_conductance(g, spec, cfg) - target)
    report = ProgramReport(
        iterations=used,
        converged_frac=float(done.to(torch.float64).mean()),
        mean_abs_error=float(err.to(torch.float64).mean()),
        max_abs_error=float(err.max()),
        stuck_frac=float(stuck.to(torch.float64).mean()),
        per_iter_mean_error=tuple(per_iter),
    )
    return g, report
