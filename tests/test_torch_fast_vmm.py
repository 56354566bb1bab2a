"""PyTorch port, the exact fast VMM (K1) on the CPU: the byte-plane identity
its tensor-core kernel relies on, its int32 fold limit, the wrapper against
the JAX package's oracle at codes past that limit, and the wrapper's limits.
The kernel itself runs only on the card (``chip_smoke.py`` holds it
bit-identical to the plain version there)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.crossbar import (
    CrossbarSpec as JSpec,
    exact_vmm_reference as j_exact,
    layer_scaled_spec as j_layer_scaled,
)
from repro.kernels import ref as jref
from repro_torch.core.crossbar import CrossbarSpec as TSpec, layer_scaled_spec
from repro_torch.kernels import crossbar_vmm as tk
from repro_torch.kernels import ops as tops

_INT32_MAX = (1 << 31) - 1


def _codes(kind, M, K, N, spec, seed=0):
    """(x, w) int64 codes: random over the spec's ranges, or extreme (x at
    its maximum, w at both ends of its range in alternating columns)."""
    lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
    hi = lo + (1 << spec.weight_bits) - 1
    if kind == "extreme":
        x = torch.full((M, K), (1 << spec.input_bits) - 1, dtype=torch.int64)
        w = torch.where(torch.arange(N) % 2 == 0, lo, hi).to(torch.int64).expand(K, N)
        return x, w
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1 << spec.input_bits, size=(M, K)))
    w = torch.from_numpy(rng.integers(lo, hi + 1, size=(K, N)))
    return x, w


def _byte_plane_sum(x, w, spec):
    """The kernel's accumulator in int64: u8 x u8 products of the byte planes
    of x and of wb = w + bias, combined as (hh << 16) + ((hl + lh) << 8) + ll,
    minus bias * sum(x)."""
    wb = w + spec.weight_bias
    xh, xl, wh, wl = x >> 8, x & 255, wb >> 8, wb & 255
    for plane in (xh, xl, wh, wl):
        assert int(plane.min()) >= 0 and int(plane.max()) <= 255
    hh, hl, lh, ll = xh @ wh, xh @ wl, xl @ wh, xl @ wl
    return (hh << 16) + ((hl + lh) << 8) + ll - spec.weight_bias * x.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("weight_bits", [8, 16])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_byte_plane_identity(kind, signed, weight_bits):
    spec = TSpec(weight_bits=weight_bits, signed_weights=signed)
    x, w = _codes(kind, 5, 300, 12, spec, seed=weight_bits + signed)
    assert torch.equal(_byte_plane_sum(x, w, spec), x @ w)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_fold_rows_keep_each_int32_partial_exact(signed):
    """Each of the four byte-plane sums over FOLD_ROWS rows at extreme codes
    stays below 2**31, and FOLD_ROWS is the largest power of two for which
    that holds (exact up to 33025 rows, not 65536)."""
    spec = TSpec(signed_weights=signed)
    x, w = _codes("extreme", 1, tk.FOLD_ROWS, 2, spec)
    wb = w + spec.weight_bias
    planes_x, planes_w = (x >> 8, x & 255), (wb >> 8, wb & 255)
    partials = [px @ pw for px in planes_x for pw in planes_w]
    assert max(int(p.max()) for p in partials) == 255 * 255 * tk.FOLD_ROWS <= _INT32_MAX
    assert tk.FOLD_ROWS <= _INT32_MAX // (255 * 255) < 2 * tk.FOLD_ROWS


@pytest.mark.parametrize(
    "signed,K,oracle",
    [
        (True, 33024, "exact"),
        (False, 33024, "exact"),
        (False, 33024, "datapath"),
        (True, 32768, "datapath"),
    ],
    ids=["signed-exact", "unsigned-exact", "unsigned-datapath", "signed-datapath-k32768"],
)
def test_fast_wrapper_matches_reference_at_extreme_codes(signed, K, oracle):
    """M=2, N=8 at extreme codes, layer-scaled spec: the port's wrapper (its
    plain version on the CPU) against the JAX package's oracles.  K=33024 lies
    past FOLD_ROWS.  ``exact`` is its int64 numpy oracle; ``datapath`` its
    crossbar datapath (``crossbar_vmm_ref``), which sums x in int32: with a
    signed spec that sum wraps once K * 65535 >= 2**31, so the signed datapath
    case stops at K=32768, the largest K where it holds at these codes."""
    M, N = 2, 8
    tspec = layer_scaled_spec(TSpec(signed_weights=signed), K)
    jspec = j_layer_scaled(JSpec(signed_weights=signed), K)
    assert tspec.drop_lsb == jspec.drop_lsb
    x, w = _codes("extreme", M, K, N, tspec)
    y = tops.crossbar_vmm_op(x.to(torch.int32), w.contiguous().to(torch.int32), tspec, fast=True)
    assert y.dtype == torch.int32
    if oracle == "exact":
        y_ref = j_exact(x.numpy(), w.numpy(), jspec)
    else:
        y_ref = jref.crossbar_vmm_ref(jnp.asarray(x.numpy(), jnp.int32), jnp.asarray(w.numpy(), jnp.int32), jspec)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_fast_wrapper_limits():
    spec = TSpec()
    assert tk._MAX_N == 65535 * tk.TILE_N
    tk.make_params(4, 960, tk._MAX_N, spec, None, True)
    with pytest.raises(ValueError, match="unsupported VMM shape"):
        tk.make_params(4, 960, tk._MAX_N + 1, spec, None, True)
    with pytest.raises(TypeError, match="dtype"):
        tk.check_operand(torch.zeros((8, 4), dtype=torch.int64), "w_codes", torch.int32, torch.device("cpu"))
    w = torch.zeros((4, 8), dtype=torch.int32).T
    with pytest.raises(ValueError, match="contiguous"):
        tk.check_operand(w, "w_codes", torch.int32, torch.device("cpu"))
    with pytest.raises(ValueError, match="lies on"):
        tk.check_operand(torch.zeros((8, 4), dtype=torch.int32), "w_codes", torch.int32, torch.device("cuda", 0))
