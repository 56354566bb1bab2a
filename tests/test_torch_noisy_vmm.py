"""PyTorch port, the noisy-chip VMM (K4) on the CPU: the two-byte-plane
identity its tensor-core kernel relies on, an int64 emulation of the
kernel's algorithm held against the JAX package's oracle and Pallas kernel,
and the wrapper's limits.  The kernel itself runs only on the card
(``chip_smoke.py`` holds it bit-identical to the plain version there)."""
import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core.crossbar import CrossbarSpec as JSpec
from repro.device import DeviceConfig as JDeviceConfig, effective_cell_codes as j_effective
from repro.kernels import ref as jref
from repro.kernels.noisy_vmm import noisy_vmm_pallas
from repro_torch.core import adc as tadc
from repro_torch.core.crossbar import CrossbarSpec as TSpec
from repro_torch.kernels import crossbar_vmm as tk
from repro_torch.kernels import noisy_vmm as tn

CSRC = os.path.join(os.path.dirname(tn.__file__), "csrc", "crossbar_vmm.cu")
A_ROWS = 64  # rows of the kernel's digit matrix a block (NM_RA): n_iters of them per input row
_DEV = JDeviceConfig(sigma=0.1, p_stuck_on=2e-3, p_stuck_off=2e-3, seed=5)
SPECS = {
    "default": {},
    "unsigned": dict(signed_weights=False),
    "cell4dac2": dict(cell_bits=4, dac_bits=2),
    "w8a8": dict(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7),
    "rows64": dict(rows=64),
}


def _inputs(name, M, K, N, kw, cells="noisy", x_kind="random"):
    """(x, g) numpy: x int64 codes, g float32 (S, K, N) on the 1/256 grid,
    from the JAX package's device model (or every cell at its maximum / 0)."""
    spec = JSpec(**kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if x_kind == "max":
        x = np.full((M, K), (1 << spec.input_bits) - 1, np.int64)
    elif x_kind == "sparse":  # post-ReLU style: mostly zero, codes confined to low planes
        x = rng.integers(0, 1 << min(9, spec.input_bits), size=(M, K)) * (rng.random((M, K)) < 0.3)
    else:
        x = rng.integers(0, 1 << spec.input_bits, size=(M, K))
    if cells == "noisy":
        lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
        w = rng.integers(lo, lo + (1 << spec.weight_bits), size=(K, N))
        g = np.asarray(j_effective(jnp.asarray(w, jnp.int32) + spec.weight_bias, spec, _DEV))
    else:
        level = (1 << spec.cell_bits) - 1 if cells == "max" else 0
        g = np.full((spec.n_slices, K, N), level, np.float32)
    return x.astype(np.int64), g.astype(np.float32)


def _digits(x, spec):
    """(M, T, K) input digits, the rows of the kernel's matrix A."""
    x = torch.as_tensor(x) & ((1 << spec.input_bits) - 1)
    sh = torch.arange(spec.n_iters) * spec.dac_bits
    return (x[:, None, :] >> sh[None, :, None]) & ((1 << spec.dac_bits) - 1)


def _byte_planes(g, spec):
    """G = rint(256 g), clipped to the kernel's range, and its two byte planes."""
    gmax = (1 << (spec.cell_bits + tn.GEFF_FRAC_BITS)) - 1
    G = torch.clamp(torch.round(torch.as_tensor(g, dtype=torch.float64) * 256), 0, gmax).long()
    return G, G >> 8, G & 255


@pytest.mark.parametrize("cells", ["noisy", "max", "zero"])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_two_byte_plane_identity(spec_name, cells):
    """Per row group: (256 (A Gh) + A Gl + 128) >> 8 == A Gh + ((A Gl + 128)
    >> 8) == floor(sum digit * g + 0.5), in int64, and each byte-plane sum
    stays below 2**31."""
    spec = JSpec(**SPECS[spec_name])
    name = f"identity-{spec_name}-{cells}"
    x, g = _inputs(name, 3, 2 * spec.rows, 24, SPECS[spec_name], cells, "max" if cells == "max" else "random")
    A = _digits(x, spec)
    G, Gh, Gl = _byte_planes(g, spec)
    assert int(Gh.max()) <= 255 and int(Gl.max()) <= 255
    for k0 in range(0, x.shape[1], spec.rows):
        a = A[:, :, k0:k0 + spec.rows]
        for s in range(spec.n_slices):
            hi = torch.einsum("mtk,kn->mtn", a, Gh[s, k0:k0 + spec.rows])
            lo = torch.einsum("mtk,kn->mtn", a, Gl[s, k0:k0 + spec.rows])
            assert int(hi.max()) < 1 << 31 and int(lo.max()) < 1 << 31
            exact = torch.einsum("mtk,kn->mtn", a.double(), torch.as_tensor(g[s, k0:k0 + spec.rows], dtype=torch.float64))
            want = torch.floor(exact + 0.5).long()
            assert torch.equal((256 * hi + lo + 128) >> 8, want)
            assert torch.equal(hi + ((lo + 128) >> 8), want)
    if cells == "max":  # every input code and cell at its maximum: a full partial
        assert int(want.min()) == spec.partial_max


def _emulate(x, g, spec, adc_cfg, skip_zero_planes=True):
    """The kernel's algorithm in int64: blocks of MB input rows (A rows m * T +
    t, 64 a block), per (row group, slice) two byte-plane products, the ADC
    sample and saturation, the (t, s) tables, the shift-add over the slices
    and row groups (in int32 where the kernel's bound admits it, checked
    here; K not split over a cluster), the digit shift, then the sum over the
    T digit rows and the requantization.  A warp's 32 A rows skip a row group
    in which all of them are zero."""
    T, S = spec.n_iters, spec.n_slices
    MB = min(16, A_ROWS // T)
    shifts, detects = tadc.schedule_tables(spec, adc_cfg)
    x = torch.as_tensor(x)
    M, K = x.shape
    N = g.shape[2]
    _, Gh, Gl = _byte_planes(g, spec)
    A = _digits(x, spec)
    out = torch.empty((M, N), dtype=torch.int32)
    t_of_row = torch.arange(A_ROWS) % T
    # the kernel's int32 bound: a rounded partial is below 2 * partial_max
    groups = -(-K // spec.rows)
    narrow = sum((2 * spec.partial_max) << (s * spec.cell_bits) for s in range(S)) < (1 << 31) // groups
    for m0 in range(0, M, MB):
        mr = min(MB, M - m0)
        a_blk = torch.zeros((A_ROWS, K), dtype=torch.int64)
        a_blk[: mr * T] = A[m0:m0 + mr].reshape(mr * T, K)
        part = torch.zeros((A_ROWS, N), dtype=torch.int64)
        flag = torch.zeros((A_ROWS, N), dtype=torch.bool)
        for k0 in range(0, K, spec.rows):
            a = a_blk[:, k0:k0 + spec.rows]
            live = torch.ones((A_ROWS, 1), dtype=torch.bool)
            if skip_zero_planes:
                live = (a != 0).any(dim=1).reshape(-1, 32).any(dim=1).repeat_interleave(32)[:, None]
            for s in range(S):
                hi = a @ Gh[s, k0:k0 + spec.rows]
                lo = a @ Gl[s, k0:k0 + spec.rows]
                q = torch.clamp(hi + ((lo + 128) >> 8), max=spec.partial_max)  # (A rows, N)
                gsh = torch.tensor([shifts[t][s] for t in t_of_row.tolist()])[:, None]
                half = torch.where(gsh > 0, 1 << torch.clamp(gsh - 1, min=0), 0)
                q = ((q + half) >> gsh) << gsh
                det = [detects[t][s] for t in t_of_row.tolist()]
                on = torch.tensor([d is not None for d in det])[:, None]
                dpos = torch.tensor([max(d, 0) if d is not None else 0 for d in det])[:, None]
                flag |= live & on & ((q >> dpos) > 0)
                part += torch.where(live, q << (s * spec.cell_bits), 0)
        if narrow:
            assert int(part.max()) < 1 << 31
        acc = part << (t_of_row * spec.dac_bits)[:, None]
        total = acc[: mr * T].reshape(mr, T, N).sum(dim=1)
        fl = flag[: mr * T].reshape(mr, T, N).any(dim=1)
        if spec.signed_weights:
            total = total - (x[m0:m0 + mr].sum(dim=1, keepdim=True) << (spec.weight_bits - 1))
        out_min, out_max = spec.out_range
        d = spec.drop_lsb
        y = torch.clamp((total + (1 << (d - 1))) >> d, out_min, out_max)
        out[m0:m0 + mr] = torch.where(fl, torch.full_like(y, out_max), y).int()
    return out


EMULATION_CASES = {
    # name: (M, K, N, spec kwargs, ADC config name, x kind, skip)
    "signed_adaptive": (5, 300, 40, {}, "SAFE_ADAPTIVE", "random", True),
    "unsigned_full": (3, 160, 24, dict(signed_weights=False), None, "random", True),
    "unsigned_adaptive": (9, 256, 16, dict(signed_weights=False), "SAFE_ADAPTIVE", "random", True),
    "sparse_skip": (4, 300, 16, {}, "SAFE_ADAPTIVE", "sparse", True),
    "sparse_no_skip": (4, 300, 16, {}, None, "sparse", False),
    "cell4dac2": (10, 200, 24, dict(cell_bits=4, dac_bits=2), "guard2", "random", True),
    "w8a8": (9, 200, 24, dict(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7), "guard2", "random", True),
    "rows64": (4, 200, 24, dict(rows=64, signed_weights=False), "guard2", "random", True),
}


def _cfg(mod, name):
    if name is None:
        return None
    return mod.ADCConfig(guard_bits=2) if name == "guard2" else getattr(mod, name)


def _layer_scaled(kw, K):
    """The layer-scaled drop_lsb of ``layer_scaled_spec``, so that the
    outputs are not all saturated."""
    from repro_torch.core.crossbar import layer_scaled_spec

    if "drop_lsb" in kw:
        return kw
    return dict(kw, drop_lsb=layer_scaled_spec(TSpec(**kw), K).drop_lsb)


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_emulation_matches_reference(case):
    M, K, N, kw, cfg_name, x_kind, skip = EMULATION_CASES[case]
    kw = _layer_scaled(kw, K)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    x, g = _inputs(f"emulation-{case}", M, K, N, kw, x_kind=x_kind)
    y = _emulate(x, g, tspec, _cfg(tadc, cfg_name), skip)
    y_ref = np.asarray(jref.noisy_vmm_ref(jnp.asarray(x, jnp.int32), jnp.asarray(g), jspec, _cfg(jadc, cfg_name)))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    # the wrapper's plain version (what a CPU tensor is served by) agrees too
    plain = tn.noisy_vmm_cuda(torch.from_numpy(x).int(), torch.from_numpy(g), tspec, _cfg(tadc, cfg_name))
    np.testing.assert_array_equal(plain.numpy(), y_ref)
    out_min, out_max = tspec.out_range
    assert 0 < float(((y_ref > out_min) & (y_ref < out_max)).mean())


@pytest.mark.parametrize("case", ["signed_adaptive", "unsigned_adaptive", "cell4dac2"])
def test_kernel_emulation_matches_pallas_interpret(case):
    M, K, N, kw, cfg_name, x_kind, skip = EMULATION_CASES[case]
    kw = _layer_scaled(kw, K)
    x, g = _inputs(f"pallas-{case}", M, K, N, kw, x_kind=x_kind)
    y = _emulate(x, g, TSpec(**kw), _cfg(tadc, cfg_name), skip)
    y_ref = noisy_vmm_pallas(
        jnp.asarray(x, jnp.int32), jnp.asarray(g), JSpec(**kw), _cfg(jadc, cfg_name), interpret=True
    )
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize("cells,x_kind", [("max", "max"), ("zero", "random")], ids=["all_max", "all_zero"])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_kernel_emulation_at_extreme_cells(cells, x_kind, signed):
    """Every partial saturated at partial_max (every cell and input code at
    its maximum), or every cell at 0, through the unsigned adaptive ADC (its
    detect flags) and the signed full one."""
    kw = dict(signed_weights=signed)
    cfg_name = None if signed else "SAFE_ADAPTIVE"
    x, g = _inputs(f"extreme-{cells}-{signed}", 3, 256, 16, kw, cells, x_kind)
    y = _emulate(x, g, TSpec(**kw), _cfg(tadc, cfg_name))
    y_ref = np.asarray(jref.noisy_vmm_ref(jnp.asarray(x, jnp.int32), jnp.asarray(g), JSpec(**kw), _cfg(jadc, cfg_name)))
    np.testing.assert_array_equal(y.numpy(), y_ref)


@pytest.mark.parametrize("cfg_name", [None, "guard2"])
def test_kernel_emulation_int64_path_matches_plain(cfg_name):
    """One-bit cells under 8-bit digits: a row group's shift-add overflows
    int32, so the kernel takes its int64 path.  Held against the port's
    plain version (int64 throughout), not the JAX package's oracle: that
    one's two-limb int32 shift-add assumes a partial of base + adc_bits <= 31
    bits (src/repro/core/crossbar.py:242-244), and adc_bits is 15 here."""
    kw = _layer_scaled(dict(cell_bits=1, dac_bits=8), 300)
    spec = TSpec(**kw)
    assert spec.adc_bits == 15
    x, g = _inputs("emulation-cell1dac8", 9, 300, 40, kw)
    y = _emulate(x, g, spec, _cfg(tadc, cfg_name))
    plain = tn.noisy_vmm_plain(torch.from_numpy(x).int(), torch.from_numpy(g), spec, _cfg(tadc, cfg_name))
    assert torch.equal(y, plain)
    out_min, out_max = spec.out_range
    assert 0 < float(((plain > out_min) & (plain < out_max)).float().mean())


@pytest.mark.parametrize("spec_name,narrow", [("default", True), ("cell4dac2", True), ("w8a8", True), ("cell1dac8", False)])
def test_int32_shift_add_bound(spec_name, narrow):
    """The kernel shift-adds the slices of a block's G row groups in int32
    where G * sum_s 2 partial_max << (s cell_bits) < 2**31 (a rounded partial
    stays below 2 partial_max), and in int64 otherwise; ``narrow``: one row
    group fits."""
    kw = dict(SPECS, cell1dac8=dict(cell_bits=1, dac_bits=8))[spec_name]
    spec = TSpec(**kw)
    bound = sum((2 * spec.partial_max) << (s * spec.cell_bits) for s in range(spec.n_slices))
    assert (bound < 1 << 31) == narrow
    rounded = [((spec.partial_max + (1 << (g - 1))) >> g) << g for g in range(1, 12)]
    assert max(rounded) < 2 * spec.partial_max


def test_noisy_wrapper_limits():
    """What the kernel takes is what ``make_params`` admits: cells of at most
    8 bits (two byte planes of G), digits of at most 8 bits and row groups of
    at most 128 rows, so a byte-plane sum of a group stays below 2**31, and at
    most 16 digits, so a block holds 64 / n_iters >= 4 input rows."""
    src = open(CSRC).read()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert define("NM_RA") == A_ROWS and define("GEFF_FRAC_BITS") == tn.GEFF_FRAC_BITS
    assert define("NM_KR") == 128
    widest = TSpec(rows=128, cell_bits=8, dac_bits=8, weight_bits=16, input_bits=16)
    tk.make_params(4, 960, 320, widest, None, True)
    assert widest.rows * ((1 << widest.dac_bits) - 1) * 255 < 1 << 31
    assert max(TSpec(dac_bits=1, input_bits=16).n_iters, widest.n_iters) <= A_ROWS // 4
    for kw, match in [
        (dict(cell_bits=9, weight_bits=18), "cell_bits"),
        (dict(dac_bits=9), "dac_bits"),
        (dict(rows=256), "rows in 1..128"),
        (dict(input_bits=17), "input_bits"),
    ]:
        with pytest.raises(ValueError, match=match):
            tk.make_params(4, 960, 320, TSpec(**kw), None, True)
    with pytest.raises(ValueError, match="too wide"):
        tn.noisy_vmm_cuda(torch.zeros((2, 8), dtype=torch.int32), torch.zeros((4, 8, 4)), TSpec(rows=1024, cell_bits=4, dac_bits=4))
    tk.reset_counters()
    x = torch.zeros((2, 128), dtype=torch.int32)
    tn.noisy_vmm_cuda(x, torch.zeros((8, 128, 4)))
    assert tk.PLAIN_CALLS["noisy"] == 1 and tk.LAUNCHES["noisy"] == 0
