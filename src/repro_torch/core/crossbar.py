"""Bit-exact functional model of the ISAAC/Newton analog crossbar datapath
(counterpart of ``repro.core.crossbar``).

The modeled pipeline: a ``rows x cols`` crossbar holds one ``cell_bits``-bit
slice of each weight; inputs stream ``dac_bits`` bits per iteration; per
(iteration ``t``, slice ``s``, row group ``g``) each bitline yields a partial
dot product which an ADC digitizes; shift-and-add over slices and iterations
builds the exact accumulator; the scaling stage drops ``drop_lsb`` LSBs
(round-half-up) and clamps to ``out_bits``.  Signed weights are stored biased
(cell codes ``w + 2**(weight_bits-1)``) and the bias ``2**(weight_bits-1) *
sum(x)`` is removed digitally after accumulation.

The reference keeps a two-limb int32 accumulator; here the accumulator is a
single int64 — the contract is the int32 output code, which is identical.
``crossbar_vmm`` and ``noisy_crossbar_vmm`` are the plain versions the CUDA
kernels in ``repro_torch.kernels`` are held against.  ``crossbar_accumulate``
/ ``signed_vmm_acc`` give the exact accumulator of a sub-product of the
divide-and-conquer datapaths (``core.karatsuba``, ``core.strassen``) and
``requantize`` its scaling stage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp

# Upper bound on the (T, S, B, G, n) partial tensor one column chunk of the
# dense datapath materializes; wide layers are processed chunk by chunk.
_MAX_PARTIAL_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    """Static description of one crossbar datapath (paper Table I defaults)."""

    rows: int = 128  # wordlines simultaneously active
    cols: int = 128  # bitlines per crossbar
    cell_bits: int = 2
    dac_bits: int = 1
    weight_bits: int = 16
    input_bits: int = 16
    out_bits: int = 16
    drop_lsb: int = 10  # LSBs dropped by the output scaling stage
    signed_weights: bool = True

    @property
    def n_slices(self) -> int:
        return -(-self.weight_bits // self.cell_bits)

    @property
    def n_iters(self) -> int:
        return -(-self.input_bits // self.dac_bits)

    @property
    def partial_max(self) -> int:
        """Max value of one column partial: rows * (2^cell-1) * (2^dac-1)."""
        return self.rows * ((1 << self.cell_bits) - 1) * ((1 << self.dac_bits) - 1)

    @property
    def adc_bits(self) -> int:
        """Bits of one lossless column conversion (9 for the default spec)."""
        return max(1, math.ceil(math.log2(self.partial_max + 1)))

    @property
    def acc_bits(self) -> int:
        """Exact accumulator width of one row group (39 for the default)."""
        total_max = self.partial_max * sum(
            1 << self.base_shift(t, s)
            for t in range(self.n_iters)
            for s in range(self.n_slices)
        )
        return max(1, math.ceil(math.log2(total_max + 1)))

    @property
    def weight_bias(self) -> int:
        return (1 << (self.weight_bits - 1)) if self.signed_weights else 0

    @property
    def out_range(self) -> Tuple[int, int]:
        """(out_min, out_max) of the clamp window."""
        if self.signed_weights:
            return -(1 << (self.out_bits - 1)), (1 << (self.out_bits - 1)) - 1
        return 0, (1 << self.out_bits) - 1

    def base_shift(self, t: int, s: int) -> int:
        """Accumulator bit position of partial (iteration t, slice s)."""
        return t * self.dac_bits + s * self.cell_bits

    def replace(self, **kw) -> "CrossbarSpec":
        return dataclasses.replace(self, **kw)


DEFAULT_SPEC = CrossbarSpec()


@dataclasses.dataclass
class ConversionStats:
    """ADC work accounting, the paper's currency for energy (python ints).

    ``conversions``: ADC samples taken; ``bit_decisions``: SAR bit tests;
    ``skipped_conversions``: samples a zero-plane-aware ADC never takes;
    ``iterations``: 100 ns crossbar cycles.  ``a + b`` is *sequential*
    composition (two VMMs back to back on one datapath): every field adds,
    ``iterations`` included.
    """

    conversions: int = 0
    bit_decisions: int = 0
    iterations: int = 0
    skipped_conversions: int = 0

    def __add__(self, other: "ConversionStats") -> "ConversionStats":
        return ConversionStats(
            conversions=self.conversions + other.conversions,
            bit_decisions=self.bit_decisions + other.bit_decisions,
            iterations=self.iterations + other.iterations,
            skipped_conversions=self.skipped_conversions + other.skipped_conversions,
        )


# partial_transform(partials (T,S,B,G,N) int64, spec) -> (partials, flags|None)
PartialTransform = Callable[[torch.Tensor, CrossbarSpec], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _grouped_planes(x_codes: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """DAC view of a padded (B, Kp) input block: (T, B, G, R) levels."""
    B, Kp = x_codes.shape
    planes = fxp.bit_planes(x_codes, spec.input_bits)  # (input_bits, B, Kp)
    if spec.dac_bits != 1:
        T = spec.n_iters
        pad = T * spec.dac_bits - planes.shape[0]
        if pad:
            planes = torch.cat([planes, planes.new_zeros((pad, B, Kp))])
        planes = fxp.from_bit_planes(planes.reshape(T, spec.dac_bits, B, Kp).transpose(0, 1))
    return planes.reshape(planes.shape[0], B, Kp // spec.rows, spec.rows)


def _pad_rows(a: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    pad = (-a.shape[dim]) % rows
    if not pad:
        return a
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=dim)


def _accumulate(
    planes: torch.Tensor,
    cells: torch.Tensor,
    spec: CrossbarSpec,
    partial_transform: Optional[PartialTransform],
    noisy: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Column conversions + shift-add for one column chunk.

    planes (T, B, G, R) int64 levels; cells (S, G, R, n) — integer slices, or
    float32 effective cell codes when ``noisy``.  Returns the (B, n) int64
    accumulator and the (B, n) clamp flags (or None).
    """
    T, S = planes.shape[0], cells.shape[0]
    # every sum is a multiple of the cell grid step bounded by partial_max,
    # exactly representable in float32, so any summation order is exact
    raw = torch.einsum("tbgr,sgrn->tsbgn", planes.to(torch.float32), cells.to(torch.float32))
    if noisy:
        # ADC sampling of the analog column current: round-half-up, saturating
        raw = torch.clamp(torch.floor(raw + 0.5), 0, spec.partial_max)
    partials = raw.to(torch.int64)
    flags = None
    if partial_transform is not None:
        partials, flags = partial_transform(partials, spec)
        if flags is not None:
            flags = flags.any(dim=3).any(dim=1).any(dim=0)  # (B, n)
    base = torch.tensor(
        [[spec.base_shift(t, s) for s in range(S)] for t in range(T)],
        dtype=torch.int64, device=partials.device,
    ).reshape(T, S, 1, 1, 1)
    return (partials << base).sum(dim=(0, 1, 3)), flags


def requantize(
    acc: torch.Tensor,
    spec: CrossbarSpec,
    x_sum: Optional[torch.Tensor] = None,
    flags: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaling stage of a (B, N) int64 accumulator: remove the signed-weight
    bias ``x_sum << (weight_bits - 1)`` when ``x_sum`` (B,) is given, drop
    ``drop_lsb`` LSBs (round-half-up), clamp to ``out_bits`` (signed or not
    per ``spec.signed_weights``), force ``out_max`` where flagged.  An
    accumulator that already holds the exact signed ``x @ w`` passes no
    ``x_sum`` (the reference's ``requantize_exact_limbs``)."""
    if x_sum is not None:
        acc = acc - (x_sum[:, None] << (spec.weight_bits - 1))
    out_min, out_max = spec.out_range
    d = spec.drop_lsb
    assert d > 0
    y = torch.clamp((acc + (1 << (d - 1))) >> d, out_min, out_max)
    if flags is not None:
        y = torch.where(flags, torch.full_like(y, out_max), y)
    return y.to(torch.int32)


def _datapath(
    x_codes: torch.Tensor,
    cells_kn: torch.Tensor,
    spec: CrossbarSpec,
    partial_transform: Optional[PartialTransform],
    noisy: bool,
) -> torch.Tensor:
    """Shared body of the ideal and device-perturbed datapaths.

    ``cells_kn``: (K, N) biased integer codes, or (S, K, N) float32 effective
    cell codes when ``noisy``.
    """
    batch_shape = x_codes.shape[:-1]
    K = x_codes.shape[-1]
    N = cells_kn.shape[-1]
    xb = x_codes.reshape(-1, K).to(torch.int64)
    x_sum = xb.sum(dim=-1) if spec.signed_weights else None
    planes = _grouped_planes(_pad_rows(xb, 1, spec.rows), spec)  # (T,B,G,R)
    T, B, G, _ = planes.shape
    S = spec.n_slices
    chunk = max(1, _MAX_PARTIAL_ELEMS // (T * S * B * G))
    outs = []
    for n0 in range(0, N, chunk):
        if noisy:
            cells = _pad_rows(cells_kn[:, :, n0:n0 + chunk].to(torch.float32), 1, spec.rows)
        else:
            cells = fxp.cell_slices(
                _pad_rows(cells_kn[:, n0:n0 + chunk], 0, spec.rows),
                spec.weight_bits, spec.cell_bits,
            )
        cells = cells.reshape(S, G, spec.rows, cells.shape[-1])
        acc, flags = _accumulate(planes, cells, spec, partial_transform, noisy)
        outs.append(requantize(acc, spec, x_sum, flags))
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return y.reshape(batch_shape + (N,))


def crossbar_vmm(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    partial_transform: Optional[PartialTransform] = None,
) -> torch.Tensor:
    """End-to-end crossbar VMM on integer codes.

    x_codes: (..., K) unsigned input codes.  w_codes: (K, N) **signed** codes
    if ``spec.signed_weights`` else unsigned.  Returns (..., N) int32 output
    codes (``out_bits`` wide, signed per spec).
    """
    wb = w_codes.to(torch.int64) + spec.weight_bias
    return _datapath(x_codes, wb, spec, partial_transform, noisy=False)


def noisy_crossbar_vmm(
    x_codes: torch.Tensor,
    g_eff: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    partial_transform: Optional[PartialTransform] = None,
) -> torch.Tensor:
    """Crossbar VMM against precomputed effective cell codes.

    ``g_eff`` is the (S, K, N) float32 effective-cell-code array (biased
    representation, on the 2**-8 grid): each column conversion rounds the
    analog sum half-up to an integer code and saturates at ``partial_max``;
    from there the digital shift-add is that of ``crossbar_vmm``.
    """
    return _datapath(x_codes, g_eff, spec, partial_transform, noisy=True)


# float64 holds every integer below 2**53 exactly, so a product of integer
# operands whose absolute sum stays below it is exact in any summation order
_F64_EXACT_BITS = 53


def crossbar_accumulate(
    x_codes: torch.Tensor, w_codes_biased: torch.Tensor, spec: CrossbarSpec
) -> torch.Tensor:
    """Exact (B, N) int64 accumulator of unsigned ``x @ w`` on the datapath.

    The counterpart of the reference's ``crossbar_accumulate`` with no
    partial transform: there every column conversion is lossless, so the
    shift-added accumulator is the exact integer product of the operands,
    computed here as one float64 ``torch.matmul`` (float64 because CUDA has
    no int64 matmul and float32 holds integers only to 2**24).  The operands
    must lie in ``[0, 2**input_bits)`` and ``[0, 2**weight_bits)``; the
    product is refused when ``K * 2**(input_bits + weight_bits)`` reaches
    2**53, a bound taken from shapes and widths alone (no device read).
    """
    K = x_codes.shape[-1]
    if K << (spec.input_bits + spec.weight_bits) >= 1 << _F64_EXACT_BITS:
        raise ValueError(
            f"exact product of K={K} rows of {spec.input_bits}-bit x {spec.weight_bits}-bit "
            f"operands can pass 2**{_F64_EXACT_BITS}: float64 would round it"
        )
    prod = torch.matmul(x_codes.to(torch.float64), w_codes_biased.to(torch.float64))
    return prod.to(torch.int64)


def signed_vmm_acc(
    x: torch.Tensor, w: torch.Tensor, spec: CrossbarSpec, signed_inputs: bool = False
) -> torch.Tensor:
    """Exact (B, N) int64 ``x @ w`` through the unsigned datapath by offset
    encoding with digital correction (the reference's ``signed_vmm_limbs``):
    with ``ox = 2**(input_bits-1)`` (signed inputs only) and ``ow`` the
    weight bias,

        sum (x+ox)(w+ow) = sum x w + ox colsum(w+ow) + ow rowsum(x+ox) - K ox ow

    Used by Strassen, whose sub-products take signed operands."""
    K = x.shape[-1]
    ox = (1 << (spec.input_bits - 1)) if signed_inputs else 0
    ow = spec.weight_bias
    xu = x.to(torch.int64) + ox
    wu = w.to(torch.int64) + ow
    acc = crossbar_accumulate(xu, wu, spec)
    if ox:
        acc = acc - (wu.sum(dim=0) << (spec.input_bits - 1))
    if ow:
        acc = acc - (xu.sum(dim=-1, keepdim=True) << (spec.weight_bits - 1))
    if ox and ow:
        acc = acc + K * ox * ow
    return acc


def layer_scaled_spec(spec: CrossbarSpec, k: int) -> CrossbarSpec:
    """Per-layer output scaling: raise ``drop_lsb`` so the worst-case
    accumulator of a K-row dot product fits the ``out_bits`` window."""
    need = (
        spec.input_bits
        + spec.weight_bits
        - 1
        + max(0, math.ceil(math.log2(max(2, k))))
        - (spec.out_bits - 1)
    )
    return spec.replace(drop_lsb=max(spec.drop_lsb, need))


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Symmetric-ish affine quantization of a float matmul onto the datapath."""

    x_scale: float  # x_code = round(x / x_scale), unsigned
    w_scale: float  # w_code = round(w / w_scale), signed
    out_frac_shift: int = 0


def quantize_input(x: torch.Tensor, spec: CrossbarSpec, x_scale) -> torch.Tensor:
    q = torch.round(x / x_scale)
    return torch.clamp(q, 0, (1 << spec.input_bits) - 1).to(torch.int32)


def quantize_weight(w: torch.Tensor, spec: CrossbarSpec, w_scale) -> torch.Tensor:
    q = torch.round(w / w_scale)
    lim = 1 << (spec.weight_bits - 1)
    return torch.clamp(q, -lim, lim - 1).to(torch.int32)


def exact_vmm_reference(x_codes: np.ndarray, w_codes: np.ndarray, spec: CrossbarSpec) -> np.ndarray:
    """Numpy int64 oracle for the full-resolution datapath (tests only)."""
    total = x_codes.astype(np.int64) @ w_codes.astype(np.int64)
    d = spec.drop_lsb
    y = (total + (1 << (d - 1))) >> d
    out_min, out_max = spec.out_range
    return np.clip(y, out_min, out_max)
