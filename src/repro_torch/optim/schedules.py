"""Learning-rate schedules (counterpart of ``repro.optim.schedules``): pure
functions of the step (an int or an integer tensor) returning a float32 0-d
tensor on the step's device, computed in float32 as the reference's
``jnp`` code is, so that a step's rate matches it."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return f


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = _step_f32(step)
        frac = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        return torch.full((), lr, dtype=torch.float32, device=s.device) * frac

    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def f(step):
        s = _step_f32(step)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.full((), lr, dtype=torch.float32, device=s.device) * warm * cos

    return f
