"""PyTorch port, core datapath: ``repro_torch.core`` against ``repro.core``
and the int64 numpy oracle on the same seeded inputs — output codes equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import adc as jadc
from repro.core import crossbar as jcb
from repro.core import fixedpoint as jfxp
from repro_torch.core import adc as tadc
from repro_torch.core import crossbar as tcb
from repro_torch.core import fixedpoint as tfxp

SPECS = {
    "default": {},
    "unsigned": dict(signed_weights=False),
    "w8a8": dict(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7),
    "cell4dac2": dict(cell_bits=4, dac_bits=2),
    "rows64": dict(rows=64),
}


def _pair(name):
    return jcb.CrossbarSpec(**SPECS[name]), tcb.CrossbarSpec(**SPECS[name])


def _rand(rng, B, K, N, spec):
    x = rng.integers(0, 1 << spec.input_bits, size=(B, K))
    lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
    w = rng.integers(lo, lo + (1 << spec.weight_bits), size=(K, N))
    return x, w


def test_spec_properties_match_reference():
    for name in SPECS:
        js, ts = _pair(name)
        for prop in ("n_slices", "n_iters", "partial_max", "adc_bits", "weight_bias"):
            assert getattr(js, prop) == getattr(ts, prop), (name, prop)
        for k in (1, 17, 160, 960, 2560, 49152):
            assert jcb.layer_scaled_spec(js, k).drop_lsb == tcb.layer_scaled_spec(ts, k).drop_lsb
    assert tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 960).drop_lsb == 26
    assert tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 2560).drop_lsb == 28


def test_fixedpoint_round_trips_and_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 16, size=(5, 7))
    planes = tfxp.bit_planes(torch.from_numpy(v), 16)
    slices = tfxp.cell_slices(torch.from_numpy(v), 16, 2)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jfxp.bit_planes(jnp.asarray(v), 16)))
    np.testing.assert_array_equal(slices.numpy(), np.asarray(jfxp.cell_slices(jnp.asarray(v), 16, 2)))
    np.testing.assert_array_equal(tfxp.from_bit_planes(planes).numpy(), v)
    np.testing.assert_array_equal(tfxp.from_cell_slices(slices, 2).numpy(), v)


@pytest.mark.parametrize("shape", [(3, 128, 16), (2, 300, 8), (5, 17, 5), (1, 1024, 32)])
@pytest.mark.parametrize("name", ["default", "unsigned"])
def test_crossbar_vmm_matches_reference_and_oracle(shape, name):
    js, ts = _pair(name)
    rng = np.random.default_rng(sum(shape) + len(name))
    x, w = _rand(rng, *shape, ts)
    y = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts).numpy()
    np.testing.assert_array_equal(y, np.asarray(jcb.crossbar_vmm(jnp.asarray(x), jnp.asarray(w), js)))
    np.testing.assert_array_equal(y, tcb.exact_vmm_reference(x, w, ts))
    np.testing.assert_array_equal(y, jcb.exact_vmm_reference(x, w, js))


@pytest.mark.parametrize("name", ["w8a8", "cell4dac2", "rows64"])
def test_crossbar_vmm_spec_variants(name):
    js, ts = _pair(name)
    rng = np.random.default_rng(ts.rows + ts.cell_bits)
    x, w = _rand(rng, 4, 200, 24, ts)
    y = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts).numpy()
    np.testing.assert_array_equal(y, np.asarray(jcb.crossbar_vmm(jnp.asarray(x), jnp.asarray(w), js)))
    np.testing.assert_array_equal(y, tcb.exact_vmm_reference(x, w, ts))


def test_layer_scaled_spec_takes_the_wide_drop_branch():
    """K=960 gives drop_lsb 26 (>= 20, the reference's second rounding
    branch); unsaturated full-range data must still match the oracle."""
    js, ts = jcb.layer_scaled_spec(jcb.DEFAULT_SPEC, 960), tcb.layer_scaled_spec(tcb.DEFAULT_SPEC, 960)
    rng = np.random.default_rng(960)
    x, w = _rand(rng, 3, 960, 12, ts)
    y = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts).numpy()
    assert np.abs(y).max() < (1 << 15) - 1  # nothing saturates
    np.testing.assert_array_equal(y, np.asarray(jcb.crossbar_vmm(jnp.asarray(x), jnp.asarray(w), js)))
    np.testing.assert_array_equal(y, tcb.exact_vmm_reference(x, w, ts))


@pytest.mark.parametrize("guard", [0, 4, 10])
@pytest.mark.parametrize("name", ["default", "unsigned", "cell4dac2"])
def test_adaptive_adc_transform_matches_reference(name, guard):
    js, ts = _pair(name)
    rng = np.random.default_rng(guard + len(name))
    # small codes keep part of the unsigned outputs below the clamp so both
    # the rounded and the flagged paths are compared
    x, w = _rand(rng, 4, 300, 16, ts)
    x = x >> 6
    jt = jadc.make_partial_transform(js, jadc.ADCConfig(guard_bits=guard))
    tt = tadc.make_partial_transform(ts, tadc.ADCConfig(guard_bits=guard))
    y = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts, tt).numpy()
    y_ref = np.asarray(jcb.crossbar_vmm(jnp.asarray(x), jnp.asarray(w), js, partial_transform=jt))
    np.testing.assert_array_equal(y, y_ref)


def test_exact_guard_is_bit_exact_unsigned():
    _, ts = _pair("unsigned")
    rng = np.random.default_rng(7)
    for shape in [(4, 128, 16), (2, 384, 8)]:
        x, w = _rand(rng, *shape, ts)
        tt = tadc.make_partial_transform(ts, tadc.EXACT_ADAPTIVE)
        y = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts, tt).numpy()
        np.testing.assert_array_equal(y, tcb.exact_vmm_reference(x, w, ts))


def test_full_adc_has_no_transform_and_window_matches():
    assert tadc.make_partial_transform(tcb.DEFAULT_SPEC, tadc.FULL_ADC) is None
    assert tadc.make_partial_transform(tcb.DEFAULT_SPEC, None) is None
    for name in SPECS:
        js, ts = _pair(name)
        for guard in (0, 4):
            assert tadc.window(ts, tadc.ADCConfig(guard_bits=guard)) == jadc.window(
                js, jadc.ADCConfig(guard_bits=guard)
            )


@pytest.mark.parametrize("name", ["default", "unsigned"])
def test_noisy_vmm_matches_reference_on_reference_cells(name):
    """Effective cells drawn by the reference's device pipeline, fed to both
    dense noisy datapaths."""
    from repro.device import DeviceConfig, effective_cell_codes

    js, ts = _pair(name)
    rng = np.random.default_rng(11)
    x, w = _rand(rng, 3, 160, 16, ts)
    x = x >> 4
    g = effective_cell_codes(
        jnp.asarray(w, jnp.int32) + js.weight_bias, js,
        DeviceConfig(sigma=0.1, p_stuck_on=2e-3, p_stuck_off=2e-3, seed=11),
    )
    for guard in (None, 4):
        jt = jadc.make_partial_transform(js, jadc.ADCConfig(guard_bits=guard)) if guard is not None else None
        tt = tadc.make_partial_transform(ts, tadc.ADCConfig(guard_bits=guard)) if guard is not None else None
        y = tcb.noisy_crossbar_vmm(torch.from_numpy(x), torch.from_numpy(np.array(g)), ts, tt).numpy()
        y_ref = np.asarray(jcb.noisy_crossbar_vmm(jnp.asarray(x), g, js, partial_transform=jt))
        np.testing.assert_array_equal(y, y_ref)


def test_dense_datapath_column_chunking_is_invisible(monkeypatch):
    ts = tcb.DEFAULT_SPEC
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 160, 40, ts)
    whole = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts)
    monkeypatch.setattr(tcb, "_MAX_PARTIAL_ELEMS", 16 * 8 * 2 * 2 * 7)  # 7 columns a chunk
    np.testing.assert_array_equal(
        tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), ts).numpy(), whole.numpy()
    )


def test_quantizers_match_reference():
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(4, 33))).astype(np.float32)
    w = rng.normal(size=(33, 9)).astype(np.float32)
    xs = np.float32(x.max() / 65535)
    ws = np.float32(np.abs(w).max() / 32767)
    np.testing.assert_array_equal(
        tcb.quantize_input(torch.from_numpy(x), tcb.DEFAULT_SPEC, torch.tensor(xs)).numpy(),
        np.asarray(jcb.quantize_input(jnp.asarray(x), jcb.DEFAULT_SPEC, jnp.asarray(xs))),
    )
    np.testing.assert_array_equal(
        tcb.quantize_weight(torch.from_numpy(w), tcb.DEFAULT_SPEC, torch.tensor(ws)).numpy(),
        np.asarray(jcb.quantize_weight(jnp.asarray(w), jcb.DEFAULT_SPEC, jnp.asarray(ws))),
    )
