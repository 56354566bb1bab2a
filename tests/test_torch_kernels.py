"""PyTorch port, kernel wrappers on the CPU: the plain versions (what a CPU
tensor is served by, and what the CUDA kernels are held against on the card)
against the ``repro.kernels.ref`` oracles over the reference's bit-identity
matrix, and against the Pallas kernels in interpret mode for two shapes."""
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import adc as jadc
from repro.core.crossbar import CrossbarSpec as JSpec, DEFAULT_SPEC as JDEFAULT
from repro.device import DeviceConfig as JDeviceConfig, effective_cell_codes as j_effective
from repro.kernels import ops as jops, ref as jref
from repro.kernels.crossbar_vmm import _schedule_tables
from repro_torch.core import adc as tadc
from repro_torch.core.crossbar import CrossbarSpec as TSpec, DEFAULT_SPEC as TDEFAULT
from repro_torch.kernels import crossbar_vmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels.noisy_vmm import noisy_vmm_cuda

_MB, _MK, _MN = 2, 160, 16  # K=160 is 1.25 row groups
_MDEV = JDeviceConfig(sigma=0.1, p_stuck_on=2e-3, p_stuck_off=2e-3, seed=11)


def _matrix_inputs(case_id: str, sparse: bool):
    rng = np.random.default_rng(zlib.crc32(case_id.encode()))
    if sparse:  # post-ReLU style: mostly zero, codes confined to low planes
        x = rng.integers(0, 1 << 9, size=(_MB, _MK)) * (rng.random((_MB, _MK)) < 0.3)
    else:
        x = rng.integers(0, 1 << 16, size=(_MB, _MK))
    w = rng.integers(-(1 << 15), 1 << 15, size=(_MK, _MN))
    return x, w


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_x", "sparse_x"])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "dense_loop"])
@pytest.mark.parametrize("kernel", ["paper", "fast", "noisy"])
def test_wrapper_bit_identity_matrix(kernel, skip, sparse):
    x, w = _matrix_inputs(f"{kernel}-{sparse}", sparse)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if kernel == "noisy":
        g = j_effective(jnp.asarray(w, jnp.int32) + JDEFAULT.weight_bias, JDEFAULT, _MDEV)
        y = tops.noisy_vmm_op(xt, torch.from_numpy(np.array(g)), TDEFAULT, skip_zero_planes=skip)
        y_ref = jref.noisy_vmm_ref(jnp.asarray(x), g, JDEFAULT)
    else:
        y = tops.crossbar_vmm_op(xt, wt, TDEFAULT, fast=(kernel == "fast"), skip_zero_planes=skip)
        y_ref = jref.crossbar_vmm_ref(jnp.asarray(x), jnp.asarray(w), JDEFAULT)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize("cfg_name", ["SAFE_ADAPTIVE", "EXACT_ADAPTIVE"])
@pytest.mark.parametrize("signed", [True, False])
def test_wrapper_adaptive_adc(cfg_name, signed):
    rng = np.random.default_rng(13 + signed)
    js, ts = JDEFAULT.replace(signed_weights=signed), TDEFAULT.replace(signed_weights=signed)
    x = rng.integers(0, 1 << 16, size=(8, 384)) >> (0 if signed else 7)
    lo = -(1 << 15) if signed else 0
    w = rng.integers(lo, lo + (1 << 16), size=(384, 32))
    y = tops.crossbar_vmm_op(
        torch.from_numpy(x), torch.from_numpy(w), ts, adc_cfg=getattr(tadc, cfg_name)
    )
    y_ref = jref.crossbar_vmm_ref(jnp.asarray(x), jnp.asarray(w), js, adc_cfg=getattr(jadc, cfg_name))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize(
    "kw",
    [
        dict(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7),
        dict(cell_bits=4, dac_bits=2),
        dict(rows=64),
    ],
    ids=["w8a8", "cell4dac2", "rows64"],
)
def test_wrapper_spec_variants(kw):
    js, ts = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(ts.rows + ts.cell_bits)
    x = rng.integers(0, 1 << ts.input_bits, size=(4, 200))
    w = rng.integers(-(1 << (ts.weight_bits - 1)), 1 << (ts.weight_bits - 1), size=(200, 24))
    for fast in (False, True):
        y = tops.crossbar_vmm_op(torch.from_numpy(x), torch.from_numpy(w), ts, fast=fast)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jref.crossbar_vmm_ref(jnp.asarray(x), jnp.asarray(w), js))
        )


@pytest.mark.parametrize("kernel", ["paper", "fast", "noisy"])
def test_wrapper_matches_pallas_interpret(kernel):
    """The same inputs through the Pallas kernel (interpret mode, as the
    reference's own tests run it) and through the port's wrapper."""
    rng = np.random.default_rng(zlib.crc32(kernel.encode()))
    x = rng.integers(0, 1 << 16, size=(3, 300))
    w = rng.integers(-(1 << 15), 1 << 15, size=(300, 40))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if kernel == "noisy":
        g = j_effective(jnp.asarray(w, jnp.int32) + JDEFAULT.weight_bias, JDEFAULT, _MDEV)
        y_ref = jops.noisy_vmm_op(jnp.asarray(x), g, JDEFAULT, adc_cfg=jadc.SAFE_ADAPTIVE, interpret=True)
        y = tops.noisy_vmm_op(xt, torch.from_numpy(np.array(g)), TDEFAULT, adc_cfg=tadc.SAFE_ADAPTIVE)
    else:
        fast = kernel == "fast"
        cfg_j, cfg_t = (None, None) if fast else (jadc.SAFE_ADAPTIVE, tadc.SAFE_ADAPTIVE)
        y_ref = jops.crossbar_vmm_op(
            jnp.asarray(x), jnp.asarray(w), JDEFAULT, adc_cfg=cfg_j, fast=fast, interpret=True
        )
        y = tops.crossbar_vmm_op(xt, wt, TDEFAULT, adc_cfg=cfg_t, fast=fast)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize("cfg", [None, "full", 0, 4], ids=["none", "full", "guard0", "guard4"])
@pytest.mark.parametrize(
    "kw", [{}, dict(signed_weights=False), dict(cell_bits=4, dac_bits=2), dict(rows=64, signed_weights=False)],
    ids=["default", "unsigned", "cell4dac2", "rows64u"],
)
def test_schedule_tables_equal_reference(kw, cfg):
    def mk(mod):
        if cfg is None:
            return None
        return mod.FULL_ADC if cfg == "full" else mod.ADCConfig(guard_bits=cfg)

    assert tadc.schedule_tables(TSpec(**kw), mk(tadc)) == _schedule_tables(JSpec(**kw), mk(jadc))


def test_kernel_params_struct_mirrors_the_tables():
    spec = TDEFAULT.replace(signed_weights=False)
    p = tk.make_params(4, 960, 320, spec, tadc.SAFE_ADAPTIVE, True)
    shifts, detects = tadc.schedule_tables(spec, tadc.SAFE_ADAPTIVE)
    S = spec.n_slices
    for t in range(spec.n_iters):
        for s in range(S):
            assert p.shift[t * S + s] == shifts[t][s]
            want = tk.NO_DETECT if detects[t][s] is None else detects[t][s]
            assert p.detect[t * S + s] == want
    assert (p.M, p.K, p.N, p.partial_max, p.skip_zero_planes) == (4, 960, 320, 384, 1)
    assert any(d is not None for row in detects for d in row)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="fast path"):
        tk.crossbar_vmm_cuda(x, torch.zeros((8, 4), dtype=torch.int32), adc_cfg=tadc.SAFE_ADAPTIVE, fast=True)
    with pytest.raises(ValueError, match="g_eff shape"):
        noisy_vmm_cuda(x, torch.zeros((8, 9, 4)))
    with pytest.raises(ValueError, match="too wide"):
        noisy_vmm_cuda(x, torch.zeros((4, 8, 4)), TSpec(rows=1024, cell_bits=4, dac_bits=4))
    with pytest.raises(ValueError, match="input_bits"):
        tk.make_params(1, 8, 4, TSpec(input_bits=24), None, True)
    with pytest.raises(TypeError, match="dtype"):
        tk.check_operand(torch.zeros(3), "x_codes", torch.int32, torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        tk.check_operand(torch.zeros((4, 4), dtype=torch.int32).T, "w_codes", torch.int32, torch.device("cpu"))


def test_cpu_tensors_count_as_plain_calls_not_launches():
    tk.reset_counters()
    x, w = _matrix_inputs("count", True)
    tops.crossbar_vmm_op(torch.from_numpy(x), torch.from_numpy(w), TDEFAULT, fast=True)
    assert tk.PLAIN_CALLS == {"crossbar": 1, "noisy": 0}
    assert tk.LAUNCHES == {"fast": 0, "planes": 0, "noisy": 0}


def test_float_crossbar_matmul_matches_reference():
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(16, 256))).astype(np.float32)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    for fast in (True, False):
        y = tops.crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w), fast=fast).numpy()
        y_ref = np.asarray(jops.crossbar_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True, fast=fast))
        np.testing.assert_array_equal(y, y_ref)
    rel = np.linalg.norm(y - x @ w) / np.linalg.norm(x @ w)
    assert rel < 5e-3
