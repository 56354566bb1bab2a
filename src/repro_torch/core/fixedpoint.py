"""Bit decompositions for the crossbar datapath (counterpart of
``repro.core.fixedpoint``).

A 16-bit weight is eight 2-bit cells ("slices") and a 16-bit input streams one
bit per cycle through a 1-bit DAC ("planes").  Everything is exact integer
arithmetic on int64 tensors; recomposition round-trips are the identity.
"""
from __future__ import annotations

import dataclasses

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


def split_halves(v: torch.Tensor, n_bits: int):
    """Unsigned ``n_bits`` integers -> (low, high) halves with
    ``v = high * 2**(n_bits // 2) + low`` (Karatsuba's split)."""
    half = n_bits // 2
    v = v.to(torch.int64)
    return v & ((1 << half) - 1), v >> half


def round_shift_right(v: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right shift with round-half-up (the rounding "to generate
    carries" the paper adopts from Gupta et al. [11]); signed int tensors."""
    if shift <= 0:
        return v
    return (v + (1 << (shift - 1))) >> shift


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Unsigned fixed-point format: ``bits`` total bits, ``frac`` fractional."""

    bits: int = 16
    frac: int = 0

    @property
    def max_int(self) -> int:
        return (1 << self.bits) - 1

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Real -> integer code (round-to-nearest, saturating)."""
        scaled = torch.round(x * (1 << self.frac))
        return torch.clamp(scaled, 0, self.max_int).to(torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(torch.float32) / (1 << self.frac)


@dataclasses.dataclass(frozen=True)
class SignedQFormat:
    """Signed two's-complement fixed point, stored biased for crossbar cells."""

    bits: int = 16
    frac: int = 0

    @property
    def bias(self) -> int:
        return 1 << (self.bits - 1)

    @property
    def min_int(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def max_int(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        scaled = torch.round(x * (1 << self.frac))
        return torch.clamp(scaled, self.min_int, self.max_int).to(torch.int32)

    def to_biased(self, q: torch.Tensor) -> torch.Tensor:
        """Signed integer code -> biased unsigned cell code in [0, 2**bits)."""
        return (q + self.bias).to(torch.int32)

    def from_biased(self, b: torch.Tensor) -> torch.Tensor:
        return (b - self.bias).to(torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(torch.float32) / (1 << self.frac)
