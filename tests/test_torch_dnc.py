"""PyTorch port, divide-and-conquer datapaths: Karatsuba (levels 0-2) and
Strassen (levels 1-2) give the same output codes as the JAX package's and
as the exact int64 oracle, their cost accounting equals the reference's,
and the fixed-point helpers they come with agree with the reference's."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import crossbar as jcb
from repro.core import fixedpoint as jfxp
from repro.core import karatsuba as jka
from repro.core import strassen as jstn
from repro_torch.core import crossbar as tcb
from repro_torch.core import fixedpoint as tfxp
from repro_torch.core import karatsuba as tka
from repro_torch.core import strassen as tstn

SPEC_S = tcb.DEFAULT_SPEC


def _codes(rng, M, K, N):
    x = rng.integers(0, 1 << 16, size=(M, K))
    w = rng.integers(-(1 << 15), 1 << 15, size=(K, N))
    return x, w


def _both(fn_j, fn_t, x, w, spec, levels):
    """(JAX codes, port codes) of one divide-and-conquer VMM."""
    y_j = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(w), jcb.CrossbarSpec(**dataclasses.asdict(spec)), levels=levels))
    y_t = fn_t(torch.from_numpy(x), torch.from_numpy(w), spec, levels=levels).numpy()
    return y_j, y_t


# the reference's own cases (tests/test_crossbar_core.py), at its spec
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("shape", [(3, 128, 16), (2, 300, 8)])
def test_karatsuba_equals_jax_and_exact_at_reference_cases(levels, shape):
    rng = np.random.default_rng(levels * 100 + sum(shape))
    x, w = _codes(rng, *shape)
    y_j, y_t = _both(jka.karatsuba_vmm, tka.karatsuba_vmm, x, w, SPEC_S, levels)
    np.testing.assert_array_equal(y_t, tcb.exact_vmm_reference(x, w, SPEC_S))
    np.testing.assert_array_equal(y_t, y_j)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("shape", [(6, 128, 10), (5, 130, 9), (7, 63, 3)])
def test_strassen_equals_jax_and_exact_at_reference_cases(levels, shape):
    rng = np.random.default_rng(levels * 10 + sum(shape))
    x, w = _codes(rng, *shape)
    y_j, y_t = _both(jstn.strassen_matmul, tstn.strassen_matmul, x, w, SPEC_S, levels)
    np.testing.assert_array_equal(y_t, tcb.exact_vmm_reference(x, w, SPEC_S))
    np.testing.assert_array_equal(y_t, y_j)


# the main path's layer-scaled spec: a decode tick of a 960x320 projection,
# and an odd-sized case (odd M, K and N at every Strassen level)
LAYER_CASES = [(4, 960, 320), (5, 259, 37)]
DNC = [("karatsuba", 0), ("karatsuba", 1), ("karatsuba", 2), ("strassen", 1), ("strassen", 2)]


@pytest.mark.parametrize("method,levels", DNC, ids=[f"{m}{lv}" for m, lv in DNC])
@pytest.mark.parametrize("shape", LAYER_CASES, ids=["960x320", "odd"])
def test_layer_scaled_spec_codes_equal_jax_and_exact(method, levels, shape):
    M, K, N = shape
    spec = tcb.layer_scaled_spec(SPEC_S, K)
    rng = np.random.default_rng(K + levels)
    x, w = _codes(rng, M, K, N)
    fns = (jka.karatsuba_vmm, tka.karatsuba_vmm) if method == "karatsuba" else (
        jstn.strassen_matmul, tstn.strassen_matmul)
    y_j, y_t = _both(*fns, x, w, spec, levels)
    np.testing.assert_array_equal(y_t, tcb.exact_vmm_reference(x, w, spec))
    np.testing.assert_array_equal(y_t, y_j)
    # and equal to the direct datapath's plain version
    y_d = tcb.crossbar_vmm(torch.from_numpy(x), torch.from_numpy(w), spec).numpy()
    np.testing.assert_array_equal(y_t, y_d)


def test_karatsuba_keeps_leading_batch_axes():
    rng = np.random.default_rng(3)
    x, w = _codes(rng, 6, 200, 12)
    spec = tcb.layer_scaled_spec(SPEC_S, 200)
    y = tka.karatsuba_vmm(torch.from_numpy(x).reshape(2, 3, 200), torch.from_numpy(w), spec, levels=2)
    assert y.shape == (2, 3, 12) and y.dtype == torch.int32
    np.testing.assert_array_equal(y.reshape(6, 12).numpy(), tcb.exact_vmm_reference(x, w, spec))


def test_unsigned_spec_karatsuba_equals_jax():
    spec = tcb.layer_scaled_spec(SPEC_S.replace(signed_weights=False), 256)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 16, size=(3, 256))
    w = rng.integers(0, 1 << 16, size=(256, 20))
    for levels in (1, 2):
        y_j, y_t = _both(jka.karatsuba_vmm, tka.karatsuba_vmm, x, w, spec, levels)
        np.testing.assert_array_equal(y_t, y_j)


def test_exact_products_run_in_float64():
    """CUDA has no int64 matmul and float32 holds integers only to 2**24:
    every sub-product must be a float64 matmul on every device (a CPU-only
    int64 matmul would pass here and fail on the card)."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return real(a, b)

    rng = np.random.default_rng(4)
    x, w = _codes(rng, 2, 128, 8)
    torch.matmul = spy
    try:
        tka.karatsuba_vmm(torch.from_numpy(x), torch.from_numpy(w), SPEC_S, levels=2)
        tstn.strassen_matmul(torch.from_numpy(x), torch.from_numpy(w), SPEC_S, levels=1)
    finally:
        torch.matmul = real
    assert len(seen) == 9 + 7
    assert set(seen) == {(torch.float64, torch.float64)}


def test_exact_product_refuses_past_float64():
    """The bound comes from shapes and widths alone: K * 2**(in + w) < 2**53."""
    spec = SPEC_S.replace(signed_weights=False)  # 16 x 16 bits
    ok = torch.zeros((1, 1 << 20), dtype=torch.int32)
    assert tcb.crossbar_accumulate(ok, torch.zeros((1 << 20, 1), dtype=torch.int32), spec).item() == 0
    big = torch.zeros((1, 1 << 21), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        tcb.crossbar_accumulate(big, torch.zeros((1 << 21, 1), dtype=torch.int32), spec)


@pytest.mark.parametrize("signed_inputs", [False, True])
def test_signed_vmm_acc_is_the_exact_product(signed_inputs):
    rng = np.random.default_rng(5 + signed_inputs)
    spec = SPEC_S.replace(input_bits=17, weight_bits=17)
    lo = -(1 << 16) if signed_inputs else 0
    x = rng.integers(lo, 1 << 16, size=(4, 300))
    w = rng.integers(-(1 << 16), 1 << 16, size=(300, 7))
    acc = tcb.signed_vmm_acc(torch.from_numpy(x), torch.from_numpy(w), spec, signed_inputs=signed_inputs)
    np.testing.assert_array_equal(acc.numpy(), x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize(
    "spec_kw", [{}, {"input_bits": 16, "weight_bits": 8}, {"cell_bits": 4, "dac_bits": 2}],
    ids=["default", "16x8", "cell4dac2"],
)
def test_karatsuba_cost_and_stats_equal_jax(levels, spec_kw):
    ts = SPEC_S.replace(**spec_kw)
    js = jcb.DEFAULT_SPEC.replace(**spec_kw)
    assert dataclasses.asdict(tka.karatsuba_cost(levels, ts)) == dataclasses.asdict(jka.karatsuba_cost(levels, js))
    assert tka.karatsuba_cost(levels, ts).adc_reduction_vs_baseline == jka.karatsuba_cost(levels, js).adc_reduction_vs_baseline
    assert dataclasses.asdict(tka.karatsuba_stats(4, 960, 320, ts, levels)) == dataclasses.asdict(
        jka.karatsuba_stats(4, 960, 320, js, levels)
    )


@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("widening", ["paper", "exact"])
def test_strassen_cost_and_stats_equal_jax(levels, widening):
    for m, k, n in ((256, 256, 256), (64, 256, 64), (7, 963, 321)):
        assert dataclasses.asdict(tstn.strassen_cost(m, k, n, levels=levels, widening=widening)) == (
            dataclasses.asdict(jstn.strassen_cost(m, k, n, levels=levels, widening=widening))
        )
        assert dataclasses.asdict(tstn.strassen_stats(m, k, n, levels=levels, widening=widening)) == (
            dataclasses.asdict(jstn.strassen_stats(m, k, n, levels=levels, widening=widening))
        )


def test_conversion_stats_add_like_the_reference():
    a = dict(conversions=3, bit_decisions=27, iterations=16, skipped_conversions=1)
    b = dict(conversions=5, bit_decisions=40, iterations=17, skipped_conversions=0)
    got = tcb.ConversionStats(**a) + tcb.ConversionStats(**b)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcb.ConversionStats(**a) + jcb.ConversionStats(**b))


@pytest.mark.parametrize("spec_kw", [{}, {"cell_bits": 4, "dac_bits": 2}, {"rows": 64}])
def test_acc_bits_equal_jax(spec_kw):
    assert SPEC_S.replace(**spec_kw).acc_bits == jcb.DEFAULT_SPEC.replace(**spec_kw).acc_bits


def test_fixedpoint_helpers_equal_jax():
    rng = np.random.default_rng(6)
    v = rng.integers(0, 1 << 16, size=(50,))
    lo_j, hi_j = jfxp.split_halves(jnp.asarray(v), 16)
    lo_t, hi_t = tfxp.split_halves(torch.from_numpy(v), 16)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    s = rng.integers(-(1 << 20), 1 << 20, size=(50,)).astype(np.int32)
    for shift in (0, 1, 7):
        np.testing.assert_array_equal(
            tfxp.round_shift_right(torch.from_numpy(s), shift).numpy(),
            np.asarray(jfxp.round_shift_right(jnp.asarray(s), shift)),
        )
    r = (rng.normal(size=(40,)) * 300).astype(np.float32)
    for fmt in ((16, 4), (8, 0)):
        qj, qt = jfxp.QFormat(*fmt), tfxp.QFormat(*fmt)
        np.testing.assert_array_equal(qt.quantize(torch.from_numpy(r)).numpy(), np.asarray(qj.quantize(jnp.asarray(r))))
        sj, st = jfxp.SignedQFormat(*fmt), tfxp.SignedQFormat(*fmt)
        q_t = st.quantize(torch.from_numpy(r))
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(sj.quantize(jnp.asarray(r))))
        np.testing.assert_array_equal(st.from_biased(st.to_biased(q_t)).numpy(), q_t.numpy())
        np.testing.assert_array_equal(st.dequantize(q_t).numpy(), np.asarray(sj.dequantize(jnp.asarray(q_t.numpy()))))
        assert (st.bias, st.min_int, st.max_int, qt.max_int) == (sj.bias, sj.min_int, sj.max_int, qj.max_int)
