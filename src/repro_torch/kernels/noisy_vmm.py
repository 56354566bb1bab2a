"""Device-perturbed crossbar VMM: CUDA kernel + plain version.

``noisy_vmm_cuda`` is the counterpart of ``repro.kernels.noisy_vmm.
noisy_vmm_pallas`` and replaces the TPU kernel ``_noisy_kernel`` with
``noisy_mma_kernel`` of ``csrc/crossbar_vmm.cu`` (the design note is there;
it shares its pipeline with the paper-datapath kernel of ``crossbar_vmm``):
the weight operand is the (S, K, N) float32 effective-cell-code array of
``repro_torch.device``; each column partial is ``clip(floor(digit . g_eff[s]
+ 0.5), 0, partial_max)``, then the ADC tables, shift-add and epilogue of the
ideal kernel.

Exactness: effective codes lie on the ``2**-GEFF_FRAC_BITS`` grid, so the
kernel holds them as integers ``G = rint(256 g) = 256 Gh + Gl`` (two byte
planes) and samples ``(256 (A . Gh) + A . Gl + 128) >> 8`` from two
u8 x u8 -> s32 tensor-core products of the stacked input digits ``A`` — the
same value as the float expression in any summation order.  The guard below
(``partial_max << GEFF_FRAC_BITS < 2**24``) is what keeps the plain float32
version exact too.  Bound by the bytes of the float32 cells, 4 * S a weight,
read once per call at decode: a loading warp streams them by TMA through a
ring of shared-memory stages while eight warps multiply; narrow layers split
K over a thread-block cluster.  The cells must lie in ``[0, 2**cell_bits -
1]``, as ``read_effective_codes`` leaves them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.adc import ADCConfig, make_partial_transform
from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC, noisy_crossbar_vmm
from repro_torch.kernels.crossbar_vmm import (
    LAUNCHES,
    PLAIN_CALLS,
    check_operand,
    launch,
    make_params,
)

GEFF_FRAC_BITS = 8  # the kernel source hard-codes the same grid


def noisy_vmm_plain(
    x_codes: torch.Tensor,
    g_eff: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the noisy kernel (dense perturbed datapath)."""
    return noisy_crossbar_vmm(
        x_codes, g_eff, spec, partial_transform=make_partial_transform(spec, adc_cfg)
    )


def noisy_vmm_cuda(
    x_codes: torch.Tensor,
    g_eff: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
    skip_zero_planes: bool = True,
) -> torch.Tensor:
    """Device-perturbed crossbar VMM.

    x_codes: (..., K) int32 unsigned input codes; g_eff: (S, K, N) float32
    effective cell codes on the 2**-8 grid.  Returns (..., N) int32 output
    codes identical to ``repro_torch.core.crossbar.noisy_crossbar_vmm``.
    """
    if spec.partial_max << GEFF_FRAC_BITS >= 1 << 24:
        raise ValueError(
            f"partial_max {spec.partial_max} too wide for exact f32 sums at "
            f"{GEFF_FRAC_BITS} fractional bits"
        )
    K = x_codes.shape[-1]
    if g_eff.ndim != 3 or g_eff.shape[1] != K or g_eff.shape[0] != spec.n_slices:
        raise ValueError(f"g_eff shape {tuple(g_eff.shape)} != ({spec.n_slices}, {K}, N)")
    if x_codes.device.type != "cuda":
        PLAIN_CALLS["noisy"] += 1
        return noisy_vmm_plain(x_codes, g_eff, spec, adc_cfg)
    N = g_eff.shape[2]
    x2 = x_codes.reshape(-1, K)
    check_operand(x2, "x_codes", torch.int32, x_codes.device)
    check_operand(g_eff, "g_eff", torch.float32, x_codes.device)
    params = make_params(x2.shape[0], K, N, spec, adc_cfg, skip_zero_planes)
    out = launch("noisy_vmm_planes", x2, g_eff, N, params)
    LAUNCHES["noisy"] += 1
    return out.reshape(x_codes.shape[:-1] + (N,))
