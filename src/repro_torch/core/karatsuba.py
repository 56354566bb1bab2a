"""Karatsuba bit-level divide & conquer on the crossbar datapath (§III.A.1;
counterpart of ``repro.core.karatsuba``).

The 16b x 16b product is decomposed into three narrower products that run on
separate crossbars (Fig 3 / Fig 9):

    W = 2^h W1 + W0,  X = 2^h X1 + X0        (h = 8)
    WX = 2^2h W1X1 + 2^h [(W1+W0)(X1+X0) - W1X1 - W0X0] + W0X0

``A = W1 X1`` and ``B = W0 X0`` are 8b x 8b products (4 slices x 8
iterations each, in parallel); ``C = (W1+W0)(X1+X0)`` is 9b x 9b (5 slices x
9 iterations).  ADC work drops from 128 conversion slots to 109 (-15%) at +1
iteration of latency; ``levels=2`` splits A, B and C again (92 slots, 14
iterations).

Every sub-product is the exact integer product of its operands (its
conversions are lossless), so the recombination gives the exact accumulator
and ``karatsuba_vmm`` is bit-identical to the direct datapath.  The reference
recombines in two int32 limbs; here the accumulators are int64 and each
sub-product is ``core.crossbar.crossbar_accumulate`` (one float64 matmul).
The sub-operands are derived one at a time as the recursion reaches them,
so a wide layer holds at most one derived operand per level.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.crossbar import (
    ConversionStats,
    CrossbarSpec,
    DEFAULT_SPEC,
    crossbar_accumulate,
    requantize,
)


def _sub_spec(spec: CrossbarSpec, in_bits: int, w_bits: int) -> CrossbarSpec:
    return spec.replace(input_bits=in_bits, weight_bits=w_bits, signed_weights=False)


def _accumulate_unsigned(
    x: torch.Tensor, w: torch.Tensor, spec: CrossbarSpec, in_bits: int, w_bits: int, levels: int
) -> torch.Tensor:
    """Exact int64 accumulator of unsigned ``x @ w`` with ``levels`` of
    Karatsuba (the reference's split: ``h = min(in_bits, w_bits) // 2``)."""
    if levels == 0 or in_bits <= 2 or w_bits <= 2:
        return crossbar_accumulate(x, w, _sub_spec(spec, in_bits, w_bits))
    h = min(in_bits // 2, w_bits // 2)
    mask = (1 << h) - 1
    in_hi, w_hi = in_bits - h, w_bits - h
    a = _accumulate_unsigned(x >> h, w >> h, spec, in_hi, w_hi, levels - 1)
    b = _accumulate_unsigned(x & mask, w & mask, spec, h, h, levels - 1)
    c = _accumulate_unsigned(
        (x & mask) + (x >> h), (w & mask) + (w >> h), spec,
        max(h, in_hi) + 1, max(h, w_hi) + 1, levels - 1,
    )
    # WX = 2^2h A + 2^h (C - A - B) + B
    return (a << (2 * h)) + ((c - a - b) << h) + b


def karatsuba_vmm(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    levels: int = 1,
) -> torch.Tensor:
    """Karatsuba crossbar VMM, bit-identical to ``crossbar.crossbar_vmm``.

    x_codes: (..., K) unsigned input codes; w_codes: (K, N) signed codes if
    ``spec.signed_weights``.  The biased weight code is split (the halves of
    a biased code are unsigned) and the bias is removed digitally at the
    end, as in the direct datapath.  Sub-operands are int32 (weights up to
    30 bits)."""
    batch_shape = x_codes.shape[:-1]
    K = x_codes.shape[-1]
    x = x_codes.reshape(-1, K).to(torch.int32)
    w = w_codes.to(torch.int32) + spec.weight_bias  # biased unsigned
    acc = _accumulate_unsigned(x, w, spec, spec.input_bits, spec.weight_bits, levels)
    x_sum = x.to(torch.int64).sum(dim=-1) if spec.signed_weights else None
    y = requantize(acc, spec, x_sum)
    return y.reshape(batch_shape + (w_codes.shape[-1],))


# ---------------------------------------------------------------------------
# ADC-work accounting (paper Fig 9 mapping / Fig 13 comparison)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KaratsubaCost:
    """Conversion-slot accounting for one 128-wide column group:
    ``adc_slots`` (the paper's "ADC use"), ``iterations`` (latency in 100 ns
    crossbar cycles), ``crossbars`` per 128x128 weight tile."""

    adc_slots: int
    iterations: int
    crossbars: int

    @property
    def adc_reduction_vs_baseline(self) -> float:
        base = DEFAULT_SPEC.n_iters * DEFAULT_SPEC.n_slices
        return 1.0 - self.adc_slots / base


def karatsuba_cost(levels: int, spec: CrossbarSpec = DEFAULT_SPEC) -> KaratsubaCost:
    """Analytic ADC-slot cost of ``levels`` of divide & conquer.

    level 0: 8 slices x 16 iters = 128 slots, 16 iters, 8 crossbars.
    level 1: A, B (parallel) + C = 64 + 45 = 109 slots, 17 iters, 13
             crossbars (Fig 9).
    level 2: the paper's §III.C schedule, 8 ADCs x 4 iters + 6 ADCs x 10
             iters = 92 slots, 14 iters, 20 crossbars.
    """
    if levels == 0:
        return KaratsubaCost(spec.n_iters * spec.n_slices, spec.n_iters, spec.n_slices)
    if levels == 1:
        # the split of _accumulate_unsigned: A is (in-h) x (w-h) bits, B h x h,
        # C one carry bit wider than the wider half on each side
        h = min(spec.input_bits // 2, spec.weight_bits // 2)
        in_hi, w_hi = spec.input_bits - h, spec.weight_bits - h
        a = _cost_unsigned(in_hi, w_hi, spec)
        b = _cost_unsigned(h, h, spec)
        c = _cost_unsigned(max(h, in_hi) + 1, max(h, w_hi) + 1, spec)
        return KaratsubaCost(a[0] + b[0] + c[0], max(a[1], b[1]) + c[1], 13)
    if levels == 2:
        return KaratsubaCost(92, 14, 20)
    raise ValueError("levels must be 0, 1, or 2")


def _cost_unsigned(in_bits: int, w_bits: int, spec: CrossbarSpec = DEFAULT_SPEC) -> Tuple[int, int]:
    slices = -(-w_bits // spec.cell_bits)
    iters = -(-in_bits // spec.dac_bits)
    return slices * iters, iters


def karatsuba_stats(
    batch: int, k: int, n: int, spec: CrossbarSpec = DEFAULT_SPEC, levels: int = 1
) -> ConversionStats:
    """ADC work for one (batch, k) x (k, n) VMM under Karatsuba."""
    cost = karatsuba_cost(levels, spec)
    groups = -(-k // spec.rows)
    convs = batch * n * groups * cost.adc_slots
    return ConversionStats(
        conversions=convs,
        bit_decisions=convs * spec.adc_bits,
        iterations=cost.iterations,
    )
