"""Strassen's divide & conquer for crossbar matrix-matrix multiply (§III.A.2;
counterpart of ``repro.core.strassen``).

A 2x2 blocking lets 7 sub-products replace 8 (Fig 4); Newton maps P1..P7
onto 7 of a tile's 8 IMAs (Fig 8).  Weight-side combinations (W11 + W22, ...)
are precomputed at programming time and widen the cell codes by one bit;
input-side combinations are formed digitally on the fly, and negative sums
are handled by offset encoding with digital correction
(``crossbar.signed_vmm_acc``).  The Winograd form used, with X the input and
W the weight matrix:

    P1 = (X11 + X22)(W11 + W22)   P5 = (X11 + X12) W22
    P2 = (X21 + X22) W11          P6 = (X21 - X11)(W11 + W12)
    P3 = X11 (W12 - W22)          P7 = (X12 - X22)(W21 + W22)
    P4 = X22 (W21 - W11)
    Y11 = P1 + P4 - P5 + P7       Y12 = P3 + P5
    Y21 = P2 + P4                 Y22 = P1 - P2 + P3 + P6

The recombination is exact int64 arithmetic (the reference uses two int32
limbs), so ``strassen_matmul`` is bit-identical to the direct datapath.
Odd sizes are zero-padded to even per level and the padding is sliced away.
``strassen_cost`` prices both accountings: the paper's 7/8 per level, and
the exact one that pays a wider operand per level.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.crossbar import (
    ConversionStats,
    CrossbarSpec,
    DEFAULT_SPEC,
    requantize,
    signed_vmm_acc,
)


def _pad_even(a: torch.Tensor) -> torch.Tensor:
    pr, pc = a.shape[0] % 2, a.shape[1] % 2
    return F.pad(a, (0, pc, 0, pr)) if (pr or pc) else a


def _blocks(a: torch.Tensor):
    m, n = a.shape
    return a[: m // 2, : n // 2], a[: m // 2, n // 2:], a[m // 2:, : n // 2], a[m // 2:, n // 2:]


def strassen_matmul(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    levels: int = 1,
) -> torch.Tensor:
    """Strassen crossbar matmul, bit-identical to the direct datapath.

    x_codes: (M, K) unsigned input codes; w_codes: (K, N) signed weight
    codes.  Returns (M, N) int32 output codes with the scaling stage applied.
    """
    M, N = x_codes.shape[0], w_codes.shape[1]
    acc = _strassen_acc(
        x_codes.to(torch.int64), w_codes.to(torch.int64), spec, levels,
        in_bits=spec.input_bits, in_signed=False, w_bits=spec.weight_bits,
    )
    return requantize(acc, spec)[:M, :N]


def _strassen_acc(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: CrossbarSpec,
    levels: int,
    in_bits: int,
    in_signed: bool,
    w_bits: int,
) -> torch.Tensor:
    """Exact int64 accumulator of ``x @ w`` with ``levels`` of Strassen."""
    if levels == 0 or min(x.shape + w.shape) < 2:
        sub = spec.replace(input_bits=in_bits, weight_bits=w_bits, signed_weights=True)
        return signed_vmm_acc(x, w, sub, signed_inputs=in_signed)

    m_orig, n_orig = x.shape[0], w.shape[1]
    x = _pad_even(x)
    w = _pad_even(w)
    if x.shape[1] != w.shape[0]:  # K padded on one side only
        k = max(x.shape[1], w.shape[0])
        x = F.pad(x, (0, k - x.shape[1]))
        w = F.pad(w, (0, 0, 0, k - w.shape[0]))
    X11, X12, X21, X22 = _blocks(x)
    W11, W12, W21, W22 = _blocks(w)

    ib, wb = in_bits + 1, w_bits + 1  # combined operands are one bit wider

    def rec(xs, ws, xs_signed):
        return _strassen_acc(xs, ws, spec, levels - 1, ib, xs_signed, wb)

    # each combined operand is formed as its product is reached, and freed
    # with it
    P1 = rec(X11 + X22, W11 + W22, in_signed)
    P2 = rec(X21 + X22, W11, in_signed)
    P3 = rec(X11, W12 - W22, in_signed)
    P4 = rec(X22, W21 - W11, in_signed)
    P5 = rec(X11 + X12, W22, in_signed)
    P6 = rec(X21 - X11, W11 + W12, True)
    P7 = rec(X12 - X22, W21 + W22, True)

    top = torch.cat([P1 + P4 - P5 + P7, P3 + P5], dim=1)
    bottom = torch.cat([P2 + P4, P1 - P2 + P3 + P6], dim=1)
    # slice the padding away so a recursive caller reassembles clean blocks
    return torch.cat([top, bottom], dim=0)[:m_orig, :n_orig]


# ---------------------------------------------------------------------------
# ADC-work accounting (Fig 8 / Fig 19)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StrassenCost:
    adc_conversions: int  # per output tile, summed over the 7 products
    imas_used: int  # of 8 in a tile (paper: frees 1 in 8)
    extra_weight_slices: int  # widened combined operands


def strassen_cost(
    m: int,
    k: int,
    n: int,
    spec: CrossbarSpec = DEFAULT_SPEC,
    levels: int = 1,
    widening: str = "paper",
) -> StrassenCost:
    """ADC conversions for an (m, k) x (k, n) matmul under Strassen.

    ``widening="paper"``: sub-products run at the original 16b x 16b width
    (the paper's accounting, 7/8 of the conversions per level).  ``"exact"``:
    combined operands widen by one bit per level (one extra slice and one
    extra iteration), which the bit-exact implementation needs; Strassen is
    then a net conversion loss."""
    T, S = spec.n_iters, spec.n_slices
    if levels == 0:
        groups = -(-k // spec.rows)
        return StrassenCost(m * n * groups * T * S, 8, 0)
    mh, kh, nh = -(-m // 2), -(-k // 2), -(-n // 2)
    groups = -(-kh // spec.rows)
    if widening == "paper":
        per_product = mh * nh * groups * T * S
        extra = 0
    else:
        per_product = mh * nh * groups * (T + levels) * (S + levels)
        extra = levels
    return StrassenCost(7 * per_product, 7, extra)


def strassen_stats(
    m: int,
    k: int,
    n: int,
    spec: CrossbarSpec = DEFAULT_SPEC,
    levels: int = 1,
    widening: str = "paper",
) -> ConversionStats:
    """Conversion stats under ``strassen_cost``'s ``widening`` accounting;
    only the "exact" mode pays +1 iteration per level."""
    cost = strassen_cost(m, k, n, spec, levels, widening=widening)
    return ConversionStats(
        conversions=cost.adc_conversions,
        bit_decisions=cost.adc_conversions * spec.adc_bits,
        iterations=spec.n_iters + (levels if widening == "exact" else 0),
    )
