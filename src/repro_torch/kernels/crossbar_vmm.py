"""Ideal-chip crossbar VMM: CUDA kernels + plain version.

``crossbar_vmm_cuda`` is the counterpart of ``repro.kernels.crossbar_vmm.
crossbar_vmm_pallas``.  It replaces two TPU kernel bodies and their shared
epilogue (``csrc/crossbar_vmm.cu`` holds the sources and the design note):

* ``fast=True``  -> ``fast_kernel``  replaces ``_fast_kernel`` (exact,
  full-resolution ADC).  Bound by bytes: the (K, N) int32 weight codes are
  read once, by one block per column tile for all the rows of the call (up
  to 8 at decode, 32 in prefill).  Chunks of K are staged in shared memory
  with ``cp.async``, split into unsigned byte planes and multiplied on the
  int8 tensor cores (``nvcuda::wmma``, u8 x u8 -> s32); the int32 sums are
  folded into int64 every ``FOLD_ROWS`` rows of K, before they could
  overflow.  A narrow decode call splits K over the blocks of a cluster.
* ``fast=False`` -> ``paper_mma_kernel`` replaces ``_vmm_kernel`` with the
  ``schedule_tables`` ADC transform (the paper datapath).  Bound by the bytes
  of the int32 codes, read once per call at decode.  It is
  ``noisy_mma_kernel``'s pipeline with the codes as the cell source: a
  loading warp streams each row group's codes by TMA and builds the stacked
  input digits (matrix A), eight warps cut each ``cell_bits`` slice of
  ``w + bias`` into u8 B fragments in registers and issue one
  ``mma.m16n8k32`` u8 a slice; the exact s32 partials go through the (t, s)
  tables and the shift-add in registers.  Narrow layers split K over a
  cluster.
* both end in ``requantize``, which replaces ``_requantize_block``.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version ``crossbar_vmm_plain`` (the dense
datapath of ``repro_torch.core.crossbar``).  Each launch adds one to
``LAUNCHES[...]``; each plain-version call adds one to ``PLAIN_CALLS``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.adc import ADCConfig, make_partial_transform, schedule_tables
from repro_torch.core.crossbar import CrossbarSpec, DEFAULT_SPEC, crossbar_vmm
from repro_torch.kernels import _build

MAX_TS = 256  # table entries in the kernel's parameter struct
NO_DETECT = -128
TILE_N = 32  # output columns of the narrowest column tile of any kernel
_MAX_N = 65535 * TILE_N  # grid.y walks the column tiles
# rows of K an int32 byte-plane sum of the fast kernel may take (FOLD_ROWS in
# the .cu): 255 * 255 * FOLD_ROWS < 2**31
FOLD_ROWS = 32768

# launches of each kernel (the shared epilogue runs once per launch of any)
LAUNCHES = {"fast": 0, "planes": 0, "noisy": 0}
PLAIN_CALLS = {"crossbar": 0, "noisy": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


class VmmParams(ctypes.Structure):
    """Mirror of ``struct VmmParams`` in ``csrc/crossbar_vmm.cu``."""

    _fields_ = [
        (name, ctypes.c_int)
        for name in (
            "M", "K", "N", "rows", "cell_bits", "dac_bits", "weight_bits",
            "input_bits", "out_bits", "drop_lsb", "signed_weights", "n_iters",
            "n_slices", "partial_max", "skip_zero_planes",
        )
    ] + [("shift", ctypes.c_byte * MAX_TS), ("detect", ctypes.c_byte * MAX_TS)]


@functools.lru_cache(maxsize=None)
def _param_template(spec: CrossbarSpec, adc_cfg: Optional[ADCConfig]) -> bytes:
    """Validate the spec against what the kernels take and fill everything
    of the struct that does not depend on the call (built once per
    (spec, ADC config): the tables are a Python loop over n_iters * n_slices)."""
    T, S = spec.n_iters, spec.n_slices
    if not (1 <= spec.input_bits <= 16 and 1 <= spec.weight_bits <= 16):
        raise ValueError(f"kernels take input_bits, weight_bits <= 16, got {spec}")
    if not (1 <= spec.cell_bits <= 8 and 1 <= spec.dac_bits <= 8):
        raise ValueError(f"kernels take cell_bits, dac_bits in 1..8, got {spec}")
    if T * S > MAX_TS:
        raise ValueError(f"n_iters * n_slices = {T * S} exceeds the kernel's {MAX_TS} table entries")
    if not (1 <= spec.rows <= 128):
        raise ValueError(f"kernels take rows in 1..128 (a stage of 128 rows), got {spec.rows}")
    if T * spec.dac_bits > 24:
        raise ValueError(f"kernels take digits of at most 24 bits in all, got {T * spec.dac_bits}")
    if not (0 < spec.drop_lsb < 48 and 1 <= spec.out_bits <= 31):
        raise ValueError(f"kernels take 0 < drop_lsb < 48 and out_bits <= 31, got {spec}")
    p = VmmParams(
        rows=spec.rows, cell_bits=spec.cell_bits, dac_bits=spec.dac_bits,
        weight_bits=spec.weight_bits, input_bits=spec.input_bits, out_bits=spec.out_bits,
        drop_lsb=spec.drop_lsb, signed_weights=int(spec.signed_weights), n_iters=T,
        n_slices=S, partial_max=spec.partial_max,
    )
    shifts, detects = schedule_tables(spec, adc_cfg)
    for t in range(T):
        for s in range(S):
            p.shift[t * S + s] = shifts[t][s]
            d = detects[t][s]
            p.detect[t * S + s] = NO_DETECT if d is None else max(d, -127)
    return bytes(p)


def make_params(
    M: int, K: int, N: int, spec: CrossbarSpec, adc_cfg: Optional[ADCConfig],
    skip_zero_planes: bool,
) -> VmmParams:
    """The kernel's parameter struct for one call."""
    if M < 1 or K < 1 or N < 1 or N > _MAX_N:
        raise ValueError(f"unsupported VMM shape M={M} K={K} N={N}")
    p = VmmParams.from_buffer_copy(_param_template(spec, adc_cfg))
    p.M, p.K, p.N, p.skip_zero_planes = M, K, N, int(skip_zero_planes)
    return p


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(VmmParams), ctypes.c_void_p]
_FNS = {}


def kernel_fn(name: str):
    """The C launcher ``name`` of the built library, argtypes set."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load_library(), name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check_operand(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def launch(name: str, x2: torch.Tensor, cells: torch.Tensor, N: int, params: VmmParams) -> torch.Tensor:
    """Allocate the output, launch on the current stream, raise on refusal."""
    out = torch.empty((x2.shape[0], N), dtype=torch.int32, device=x2.device)
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(
            f"operands lie on {x2.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}: enter torch.cuda.device(...) first"
        )
    err = kernel_fn(name)(
        x2.data_ptr(), cells.data_ptr(), out.data_ptr(), ctypes.byref(params),
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} was refused at launch: cudaError {err}")
    return out


def crossbar_vmm_plain(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of both ideal-chip kernels (dense datapath)."""
    if fast and adc_cfg is not None and adc_cfg.mode != "full":
        raise ValueError("fast path models full-resolution ADCs only")
    transform = None if fast else make_partial_transform(spec, adc_cfg)
    return crossbar_vmm(x_codes, w_codes, spec, partial_transform=transform)


def crossbar_vmm_cuda(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CrossbarSpec = DEFAULT_SPEC,
    adc_cfg: Optional[ADCConfig] = None,
    fast: bool = False,
    skip_zero_planes: bool = True,
) -> torch.Tensor:
    """Crossbar VMM on integer codes.

    x_codes: (..., K) int32 unsigned input codes; w_codes: (K, N) int32 signed
    codes when ``spec.signed_weights``.  Returns (..., N) int32 output codes
    identical to ``repro_torch.core.crossbar.crossbar_vmm``.
    ``skip_zero_planes`` is bit-identical either way (the fast kernel skips
    a high byte plane by the spec, where its bits are <= 8, not by the data).
    """
    if x_codes.device.type != "cuda":
        PLAIN_CALLS["crossbar"] += 1
        return crossbar_vmm_plain(x_codes, w_codes, spec, adc_cfg, fast)
    if fast and adc_cfg is not None and adc_cfg.mode != "full":
        raise ValueError("fast path models full-resolution ADCs only")
    K = x_codes.shape[-1]
    if w_codes.ndim != 2 or w_codes.shape[0] != K:
        raise ValueError(f"w_codes shape {tuple(w_codes.shape)} does not match K={K}")
    N = w_codes.shape[1]
    x2 = x_codes.reshape(-1, K)
    check_operand(x2, "x_codes", torch.int32, x_codes.device)
    check_operand(w_codes, "w_codes", torch.int32, x_codes.device)
    params = make_params(x2.shape[0], K, N, spec, None if fast else adc_cfg, skip_zero_planes)
    name = "fast" if fast else "planes"
    out = launch("crossbar_vmm_fast" if fast else "crossbar_vmm_planes", x2, w_codes, N, params)
    LAUNCHES[name] += 1
    return out.reshape(x_codes.shape[:-1] + (N,))
