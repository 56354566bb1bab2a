"""Bit decompositions for the crossbar datapath (counterpart of
``repro.core.fixedpoint``).

A 16-bit weight is eight 2-bit cells ("slices") and a 16-bit input streams one
bit per cycle through a 1-bit DAC ("planes").  Everything is exact integer
arithmetic on int64 tensors; recomposition round-trips are the identity.
"""
from __future__ import annotations

import torch


def _shifts(n: int, step: int, ndim: int, device) -> torch.Tensor:
    s = step * torch.arange(n, dtype=torch.int64, device=device)
    return s.reshape((n,) + (1,) * ndim)


def bit_planes(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unsigned integers -> ``(n_bits,) + x.shape`` bit planes, LSB first."""
    x = x.to(torch.int64)
    return (x[None] >> _shifts(n_bits, 1, x.ndim, x.device)) & 1


def from_bit_planes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bit_planes`."""
    planes = planes.to(torch.int64)
    return (planes << _shifts(planes.shape[0], 1, planes.ndim - 1, planes.device)).sum(0)


def cell_slices(w: torch.Tensor, n_bits: int, cell_bits: int) -> torch.Tensor:
    """Unsigned integers -> ``(ceil(n_bits/cell_bits),) + w.shape`` slices;
    slice ``s`` holds bits ``[s*cell_bits, (s+1)*cell_bits)``."""
    n_slices = -(-n_bits // cell_bits)
    w = w.to(torch.int64)
    return (w[None] >> _shifts(n_slices, cell_bits, w.ndim, w.device)) & ((1 << cell_bits) - 1)


def from_cell_slices(slices: torch.Tensor, cell_bits: int) -> torch.Tensor:
    """Inverse of :func:`cell_slices`."""
    slices = slices.to(torch.int64)
    return (slices << _shifts(slices.shape[0], cell_bits, slices.ndim - 1, slices.device)).sum(0)
