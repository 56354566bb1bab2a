"""Public wrappers over the crossbar kernels (counterpart of
``repro.kernels.ops``).  Dispatch is by the tensor's device: CUDA tensors run
the hand-written kernels (or raise), CPU tensors run the plain versions."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.adc import ADCConfig, SAFE_ADAPTIVE
from repro_torch.core.crossbar import (
    CrossbarSpec,
    DEFAULT_SPEC,
    QuantParams,
    layer_scaled_spec,
    quantize_input,
    quantize_weight,
)
from repro_torch.kernels.crossbar_vmm import crossbar_vmm_cuda
from repro_torch.kernels.noisy_vmm import noisy_vmm_cuda


def crossbar_vmm_op(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
    fast: bool = False,
    skip_zero_planes: bool = True,
) -> torch.Tensor:
    """Bit-exact crossbar VMM on integer codes."""
    return crossbar_vmm_cuda(
        x_codes.to(torch.int32), w_codes.to(torch.int32), spec, adc_cfg=adc_cfg, fast=fast,
        skip_zero_planes=skip_zero_planes,
    )


def noisy_vmm_op(
    x_codes: torch.Tensor,
    g_eff: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
    skip_zero_planes: bool = True,
) -> torch.Tensor:
    """Device-perturbed crossbar VMM on integer codes + effective cells."""
    return noisy_vmm_cuda(
        x_codes.to(torch.int32), g_eff.to(torch.float32), spec, adc_cfg=adc_cfg,
        skip_zero_planes=skip_zero_planes,
    )


def crossbar_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    qp: Optional[QuantParams] = None,
    adc_cfg: ADCConfig = SAFE_ADAPTIVE,
    device=None,
    fast: bool = False,
) -> torch.Tensor:
    """Float-in / float-out crossbar matmul with ISAAC W16A16 semantics.

    Quantizes operands, runs the datapath, dequantizes.  ``x`` must be
    non-negative.  ``device``: optional ``repro_torch.device.DeviceConfig``;
    when set and not ideal, the quantized weights are programmed through the
    non-ideality pipeline on every call and the VMM runs on the noisy kernel
    (``fast`` does not apply there).  ``fast``: the fused exact kernel
    (full-resolution ADCs; ``adc_cfg`` is ignored).
    """
    spec = layer_scaled_spec(spec, x.shape[-1])
    if qp is None:
        x_scale = torch.clamp(torch.max(x), min=1e-9) / ((1 << spec.input_bits) - 1)
        w_scale = torch.clamp(torch.max(torch.abs(w)), min=1e-9) / (
            (1 << (spec.weight_bits - 1)) - 1
        )
    else:
        x_scale, w_scale = qp.x_scale, qp.w_scale
    xq = quantize_input(x, spec, x_scale)
    wq = quantize_weight(w, spec, w_scale)
    if device is not None and not device.is_ideal:
        from repro_torch.device import models as dev_models

        g_eff = dev_models.effective_cell_codes(wq + spec.weight_bias, spec, device)
        yq = noisy_vmm_op(xq, g_eff, spec, adc_cfg=adc_cfg)
    elif fast:
        yq = crossbar_vmm_op(xq, wq, spec, adc_cfg=None, fast=True)
    else:
        yq = crossbar_vmm_op(xq, wq, spec, adc_cfg=adc_cfg)
    return yq.to(torch.float32) * (x_scale * w_scale * (2.0 ** spec.drop_lsb))
