"""PyTorch port, the paper-datapath VMM (K3) on the CPU: the byte-lane cuts
its tensor-core kernel takes its input digits and cell slices with, an int64
emulation of the kernel's algorithm held against the JAX package's oracle,
its Pallas kernel and the port's plain version, and the wrapper's limits.
The kernel itself runs only on the card (``chip_smoke.py`` holds it
bit-identical to the plain version there)."""
import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core.crossbar import CrossbarSpec as JSpec
from repro.kernels import ref as jref
from repro.kernels.crossbar_vmm import crossbar_vmm_pallas
from repro_torch.core import adc as tadc
from repro_torch.core.crossbar import CrossbarSpec as TSpec, layer_scaled_spec
from repro_torch.kernels import crossbar_vmm as tk

CSRC = os.path.join(os.path.dirname(tk.__file__), "csrc", "crossbar_vmm.cu")
A_ROWS = 64  # rows of the kernel's digit matrix A a block (NM_RA): n_iters of them per input row
MAX_CUTS = 16  # digits or slices of a code of at most 16 bits (NM_MAX_CUTS)
REP = 0x01010101


def _planes(v):
    """Four 16-bit values a word (last axis) as the kernel's two byte
    planes: bits 0-7 of value i in byte i of lo, bits 8-15 in byte i of hi."""
    v = torch.as_tensor(v, dtype=torch.int64)
    assert int(v.min()) >= 0 and int(v.max()) < 1 << 16
    sh = torch.arange(4) * 8
    return ((v & 255) << sh).sum(-1), (((v >> 8) & 255) << sh).sum(-1)


def _unpack(word):
    return (word[..., None] >> (torch.arange(4) * 8)) & 255


def _cut_of(sh, mask):
    """``cut_of`` of the kernel: the field (v >> sh) & mask as {sh, the mask
    of its bits from lo, of those from hi}, each repeated in four lanes."""
    if sh >= 16:
        return 0, 0, 0
    mask &= (1 << (16 - sh)) - 1
    from_lo = mask & ((1 << (8 - sh)) - 1) if sh < 8 else 0
    return sh, from_lo * REP, (mask ^ from_lo) * REP


def _cut_bytes(lo, hi, cut):
    """``cut_bytes`` of the kernel on 32-bit words held in int64."""
    sh, m_lo, m_hi = cut
    if m_hi == 0:
        return (lo >> sh) & m_lo
    if m_lo == 0:
        return (hi >> (sh - 8)) & m_hi
    return ((lo >> sh) & m_lo) | (((hi << (8 - sh)) & 0xFFFFFFFF) & m_hi)


def _field(v, sh, mask, byte_digits=False):
    """(v >> sh) & mask of values v (..., 4) through the kernel's byte-lane
    arithmetic: the generic cut, or (dac_bits of 1, 2, 4, 8) the loader's
    one-plane shift."""
    lo, hi = _planes(v)
    if byte_digits:
        word = ((lo if sh < 8 else hi) >> (sh & 7)) & (mask * REP)
    else:
        word = _cut_bytes(lo, hi, _cut_of(sh, mask))
    return _unpack(word)


@pytest.mark.parametrize("width", range(1, 9))
def test_byte_lane_cut_is_the_field(width):
    """Every field a spec can ask for, a digit of ``width`` bits at any shift
    up to the 24 bits of digits the wrapper admits, or a cell slice: the cut
    of the two byte planes equals (v >> sh) & mask for 16-bit values, incl.
    fields that straddle the planes or reach past bit 15, and the loader's
    one-plane shift equals it wherever a digit never straddles."""
    rng = np.random.default_rng(width)
    v = torch.from_numpy(rng.integers(0, 1 << 16, size=(64, 4)))
    v[0] = 0
    v[1] = (1 << 16) - 1
    mask = (1 << width) - 1
    for sh in range(0, 24):
        want = (v >> sh) & mask
        assert torch.equal(_field(v, sh, mask), want), (width, sh)
        if 8 % width == 0 and sh % width == 0 and sh < 16:
            assert torch.equal(_field(v, sh, mask, byte_digits=True), want), (width, sh)


def _digits(x, spec):
    """(M, T, K) input digits through the loader's cut: four codes a word in
    the fragment order of the kernel (rows 2q, 2q + 1, 2q + 8, 2q + 9 of a
    16-row unit; the order does not change a digit)."""
    x = torch.as_tensor(x, dtype=torch.int64) & ((1 << spec.input_bits) - 1)
    M, K = x.shape
    xp = torch.nn.functional.pad(x, (0, (-K) % 4)).reshape(M, -1, 4)
    byte_digits = 8 % spec.dac_bits == 0
    mask = (1 << spec.dac_bits) - 1
    d = [_field(xp, t * spec.dac_bits, mask, byte_digits).reshape(M, -1)[:, :K] for t in range(spec.n_iters)]
    return torch.stack(d, dim=1)


def _slices(w, spec):
    """(S, K, N) cell slices of wb = w + bias through the consumers' cut."""
    wb = torch.as_tensor(w, dtype=torch.int64) + spec.weight_bias
    K, N = wb.shape
    wt = torch.nn.functional.pad(wb.T, (0, (-K) % 4)).reshape(N, -1, 4)
    mask = (1 << spec.cell_bits) - 1
    s = [_field(wt, q * spec.cell_bits, mask).reshape(N, -1)[:, :K].T for q in range(spec.n_slices)]
    return torch.stack(s)


def _emulate(x, w, spec, adc_cfg, skip_zero_planes=True):
    """The kernel's algorithm in int64: blocks of MB input rows (A rows m * T
    + t, 64 a block); per row group the digits A and the slices B_s of
    w + bias, one exact product A B_s a slice, the (t, s) tables, the
    shift-add over the slices and row groups (in int32 where the kernel's
    bound admits it, checked here; K not split over a cluster), the digit
    shift, then the sum over the T digit rows and the requantization.  A
    warp's 32 A rows skip a row group in which all of them are zero."""
    T, S = spec.n_iters, spec.n_slices
    MB = min(16, A_ROWS // T)
    shifts, detects = tadc.schedule_tables(spec, adc_cfg)
    x = torch.as_tensor(x, dtype=torch.int64)
    M, K = x.shape
    N = w.shape[1]
    A, B = _digits(x, spec), _slices(w, spec)
    assert int(B.max()) < 1 << spec.cell_bits and int(A.max()) < 1 << spec.dac_bits
    t_of_row = torch.arange(A_ROWS) % T
    gsh = torch.tensor([[shifts[t][s] for s in range(S)] for t in t_of_row.tolist()])  # (A rows, S)
    half = torch.where(gsh > 0, 1 << torch.clamp(gsh - 1, min=0), 0)
    det = [[detects[t][s] for s in range(S)] for t in t_of_row.tolist()]
    on = torch.tensor([[d is not None for d in row] for row in det])
    dpos = torch.tensor([[max(d, 0) if d is not None else 0 for d in row] for row in det])
    groups = -(-K // spec.rows)
    narrow = sum((2 * spec.partial_max) << (s * spec.cell_bits) for s in range(S)) < (1 << 31) // groups
    out = torch.empty((M, N), dtype=torch.int32)
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
                q = a @ B[s, k0:k0 + spec.rows]  # exact: at most partial_max
                assert int(q.max()) <= spec.partial_max
                q = ((q + half[:, s:s + 1]) >> gsh[:, s:s + 1]) << gsh[:, s:s + 1]
                flag |= live & on[:, s:s + 1] & ((q >> dpos[:, s:s + 1]) > 0)
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


SPECS = {
    "default": {},
    "unsigned": dict(signed_weights=False),
    "cell4dac2": dict(cell_bits=4, dac_bits=2),
    "w8a8": dict(weight_bits=8, input_bits=8, out_bits=8, drop_lsb=7),
    "rows64": dict(rows=64),
    "cell3dac3": dict(cell_bits=3, dac_bits=3),
}

EMULATION_CASES = {
    # name: (M, K, N, spec kwargs, ADC config name, x kind, skip, layer-scaled)
    "signed_safe": (5, 300, 40, {}, "SAFE_ADAPTIVE", "random", True, True),
    "signed_exact": (5, 300, 40, {}, "EXACT_ADAPTIVE", "random", True, True),
    "signed_safe_m1": (1, 256, 24, {}, "SAFE_ADAPTIVE", "random", True, True),
    "unsigned_detect": (5, 1000, 24, dict(signed_weights=False), "SAFE_ADAPTIVE", "random", True, False),
    "unsigned_detect_sparse": (5, 300, 24, dict(signed_weights=False), "SAFE_ADAPTIVE", "sparse", True, False),
    "ragged_k160": (5, 160, 16, {}, "SAFE_ADAPTIVE", "random", True, True),
    "ragged_k1001": (5, 1001, 16, {}, "SAFE_ADAPTIVE", "random", True, True),
    "sparse_skip": (4, 300, 16, {}, "SAFE_ADAPTIVE", "sparse", True, True),
    "sparse_no_skip": (4, 300, 16, {}, "SAFE_ADAPTIVE", "sparse", False, True),
    "full_adc_no_skip": (3, 160, 24, dict(signed_weights=False), None, "random", False, True),
    "cell4dac2": (10, 200, 24, SPECS["cell4dac2"], "guard2", "random", True, True),
    "w8a8": (9, 200, 24, SPECS["w8a8"], "guard2", "random", True, False),
    "rows64": (4, 200, 24, dict(rows=64, signed_weights=False), "guard2", "random", True, True),
    "cell3dac3": (7, 200, 24, SPECS["cell3dac3"], "guard2", "random", True, True),
}


def _cfg(mod, name):
    if name is None:
        return None
    return mod.ADCConfig(guard_bits=2) if name == "guard2" else getattr(mod, name)


def _inputs(name, M, K, N, spec, x_kind="random"):
    """(x, w) int64 codes from a seed of the case's name: x random, sparse
    (post-ReLU style) or every code at its maximum; w over the spec's range."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if x_kind == "max":
        x = np.full((M, K), (1 << spec.input_bits) - 1, np.int64)
    elif x_kind == "sparse":
        x = rng.integers(0, 1 << min(9, spec.input_bits), size=(M, K)) * (rng.random((M, K)) < 0.3)
    else:
        x = rng.integers(0, 1 << spec.input_bits, size=(M, K))
    lo = -(1 << (spec.weight_bits - 1)) if spec.signed_weights else 0
    w = rng.integers(lo, lo + (1 << spec.weight_bits), size=(K, N))
    return x.astype(np.int64), w.astype(np.int64)


def _case(case):
    M, K, N, kw, cfg_name, x_kind, skip, scaled = EMULATION_CASES[case]
    if scaled and "drop_lsb" not in kw:
        kw = dict(kw, drop_lsb=layer_scaled_spec(TSpec(**kw), K).drop_lsb)
    return M, K, N, kw, cfg_name, x_kind, skip


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_emulation_matches_reference(case):
    """The emulation against the JAX package's oracle (``crossbar_vmm_ref``)
    and the port's plain version, bit-identical; the unsigned cases at
    DEFAULT_SPEC's drop_lsb of 10 are where the adaptive ADC's detect fires."""
    M, K, N, kw, cfg_name, x_kind, skip = _case(case)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    x, w = _inputs(f"emulation-{case}", M, K, N, tspec, x_kind)
    y = _emulate(x, w, tspec, _cfg(tadc, cfg_name), skip)
    y_ref = np.asarray(jref.crossbar_vmm_ref(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32), jspec, _cfg(jadc, cfg_name)
    ))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    # the wrapper (its plain version on a CPU tensor) agrees too
    plain = tk.crossbar_vmm_cuda(
        torch.from_numpy(x).int(), torch.from_numpy(w).int(), tspec, _cfg(tadc, cfg_name),
        skip_zero_planes=skip,
    )
    np.testing.assert_array_equal(plain.numpy(), y_ref)
    out_min, out_max = tspec.out_range
    if case.startswith("unsigned_detect"):
        assert float((y_ref == out_max).mean()) > 0  # a detect fired
    else:
        assert 0 < float(((y_ref > out_min) & (y_ref < out_max)).mean())


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_emulation_matches_pallas_interpret(case):
    """The emulation against the JAX package's Pallas kernel ``_vmm_kernel``
    in interpret mode (``crossbar_vmm_pallas(fast=False)``)."""
    M, K, N, kw, cfg_name, x_kind, skip = _case(case)
    tspec = TSpec(**kw)
    x, w = _inputs(f"pallas-{case}", M, K, N, tspec, x_kind)
    y = _emulate(x, w, tspec, _cfg(tadc, cfg_name), skip)
    y_ref = crossbar_vmm_pallas(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32), JSpec(**kw), _cfg(jadc, cfg_name),
        fast=False, interpret=True, skip_zero_planes=skip,
    )
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_kernel_emulation_at_extreme_codes(signed):
    """Every input code at its maximum, the weight codes at both ends of
    their range in alternating columns (every partial of a slice at 0 or
    partial_max), through the adaptive ADC at DEFAULT_SPEC's drop_lsb."""
    kw = dict(signed_weights=signed)
    tspec = TSpec(**kw)
    M, K, N = 3, 256, 16
    x = np.full((M, K), (1 << tspec.input_bits) - 1, np.int64)
    lo = -(1 << (tspec.weight_bits - 1)) if signed else 0
    w = np.where(np.arange(N) % 2 == 0, lo, lo + (1 << tspec.weight_bits) - 1)[None, :].repeat(K, 0)
    y = _emulate(x, w, tspec, tadc.SAFE_ADAPTIVE)
    y_ref = np.asarray(jref.crossbar_vmm_ref(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32), JSpec(**kw), jadc.SAFE_ADAPTIVE
    ))
    np.testing.assert_array_equal(y.numpy(), y_ref)


@pytest.mark.parametrize("cfg_name", [None, "guard2", "SAFE_ADAPTIVE"])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_kernel_emulation_int64_path_matches_plain(cfg_name, signed):
    """One-bit cells under 8-bit digits: a row group's shift-add overflows
    int32, so the kernel takes its int64 path.  Held against the port's
    plain version (int64 throughout), not the JAX package's oracle: that
    one's two-limb int32 shift-add assumes a partial of base + adc_bits <= 31
    bits (src/repro/core/crossbar.py:242-244), and adc_bits is 15 here."""
    kw = dict(cell_bits=1, dac_bits=8, signed_weights=signed)
    kw = dict(kw, drop_lsb=layer_scaled_spec(TSpec(**kw), 300).drop_lsb) if signed else kw
    spec = TSpec(**kw)
    assert spec.adc_bits == 15
    x, w = _inputs(f"int64-{signed}-{cfg_name}", 9, 300, 40, spec)
    y = _emulate(x, w, spec, _cfg(tadc, cfg_name))
    plain = tk.crossbar_vmm_plain(torch.from_numpy(x).int(), torch.from_numpy(w).int(), spec, _cfg(tadc, cfg_name))
    assert torch.equal(y, plain)


@pytest.mark.parametrize(
    "spec_name,groups",
    [("default", 128), ("unsigned", 128), ("cell4dac2", 42), ("w8a8", 32895), ("rows64", 256),
     ("cell3dac3", 4), ("cell1dac8", 0)],
)
def test_int32_shift_add_bound(spec_name, groups):
    """The kernel shift-adds the slices of a block's row groups in int32
    where G * sum_s 2 partial_max << (s cell_bits) < 2**31 for its G row
    groups (a rounded partial stays below 2 partial_max: the round-half-up
    adds less than 2**(g-1) and a shift g > adc_bits never occurs), and in
    int64 otherwise.  ``groups`` is the largest G: at the default spec 128
    row groups, so every main-path layer (K = 960, 2560) stays in int32, and
    one-bit cells under 8-bit digits never do."""
    kw = dict(SPECS, cell1dac8=dict(cell_bits=1, dac_bits=8))[spec_name]
    spec = TSpec(**kw)
    bound = sum((2 * spec.partial_max) << (s * spec.cell_bits) for s in range(spec.n_slices))
    fits = lambda G: bound < (1 << 31) // G  # noqa: E731 (the kernel's test)
    assert all(fits(G) for G in range(1, groups + 1)) and not fits(groups + 1)
    assert all(G * bound < 1 << 31 for G in range(1, groups + 1))
    for cfg in (tadc.SAFE_ADAPTIVE, tadc.EXACT_ADAPTIVE, tadc.ADCConfig(guard_bits=2)):
        shifts, _ = tadc.schedule_tables(spec, cfg)
        for g in {g for row in shifts for g in row}:
            assert 0 <= g <= spec.adc_bits
            rounded = ((spec.partial_max + (1 << (g - 1))) >> g) << g if g else spec.partial_max
            assert rounded < 2 * spec.partial_max


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", open(CSRC).read()).group(1))


@pytest.mark.parametrize("dac_bits", range(1, 9))
def test_every_admitted_spec_fits_the_kernel(dac_bits):
    """Every spec ``make_params`` admits fits the paper kernel: at most 16
    digits (A has 64 rows, so a block takes 64 // n_iters >= 4 input rows),
    at most 16 slices (its cut tables), n_iters * n_slices <= 256 (its (t, s)
    table), digits within the 16 bits of an input code wherever the loader
    takes them from one byte plane, and a row group of at most 128 rows (a
    stage), so every u8 x u8 -> s32 sum of a group stays below 2**31."""
    assert _define("NM_RA") == A_ROWS and _define("NM_MAX_CUTS") == MAX_CUTS and _define("NM_KR") == 128
    assert _define("MAX_TS") == tk.MAX_TS
    admitted = 0
    for cell_bits in range(1, 9):
        for input_bits in (1, 2, 3, 7, 8, 9, 15, 16):
            for weight_bits in (1, 3, 8, 13, 16):
                for rows in (1, 37, 128):
                    spec = TSpec(rows=rows, cell_bits=cell_bits, dac_bits=dac_bits, weight_bits=weight_bits,
                                 input_bits=input_bits, out_bits=16, drop_lsb=10)
                    try:
                        tk.make_params(4, 960, 320, spec, tadc.SAFE_ADAPTIVE, True)
                    except ValueError:
                        continue
                    admitted += 1
                    T, S = spec.n_iters, spec.n_slices
                    assert T <= MAX_CUTS and A_ROWS // T >= 4 and S <= MAX_CUTS and T * S <= tk.MAX_TS
                    if 8 % dac_bits == 0:
                        assert T * dac_bits <= 16
                    assert rows * ((1 << dac_bits) - 1) * ((1 << cell_bits) - 1) < 1 << 31
    assert admitted > 0
    for kw, match in [(dict(rows=129), "rows in 1..128"), (dict(cell_bits=9, weight_bits=18), "cell_bits")]:
        with pytest.raises(ValueError, match=match):
            tk.make_params(4, 960, 320, TSpec(**kw), tadc.SAFE_ADAPTIVE, True)


def test_paper_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor is served by the plain version and counted as such; no
    launch is counted."""
    tk.reset_counters()
    x = torch.zeros((2, 128), dtype=torch.int32)
    w = torch.zeros((128, 4), dtype=torch.int32)
    y = tk.crossbar_vmm_cuda(x, w, TSpec(), tadc.SAFE_ADAPTIVE)
    assert y.shape == (2, 4) and y.dtype == torch.int32
    assert tk.PLAIN_CALLS["crossbar"] == 1 and tk.LAUNCHES["planes"] == 0


def test_safe_adaptive_error_is_one_sided_on_signed_weights():
    """Why the paper-datapath chip's logits stay far from the plain-matmul
    model's (ROADMAP Queue 3): on signed weights SAFE_ADAPTIVE rounds the low
    (t, s) conversions of the biased cells away, so the output codes carry a
    one-sided mean error of a fraction of an LSB against the exact datapath,
    the same in the JAX package as in the port (bit-equal codes); with
    EXACT_ADAPTIVE the mean error is near 0."""
    spec = layer_scaled_spec(TSpec(), 960)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 16, size=(8, 960))
    w = np.clip(np.round(rng.normal(size=(960, 256)) * 8000), -32768, 32767).astype(np.int64)
    xt, wt = torch.from_numpy(x).int(), torch.from_numpy(w).int()
    exact = tk.crossbar_vmm_plain(xt, wt, spec, None, fast=True).long()
    mean = {}
    for name in ("SAFE_ADAPTIVE", "EXACT_ADAPTIVE"):
        y = tk.crossbar_vmm_plain(xt, wt, spec, getattr(tadc, name)).long()
        y_ref = np.asarray(jref.crossbar_vmm_ref(
            jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32), JSpec(drop_lsb=spec.drop_lsb), getattr(jadc, name)
        ))
        np.testing.assert_array_equal(y.numpy(), y_ref)
        d = (y - exact).double()
        mean[name] = float(d.mean())
        assert float(d.abs().max()) <= 2
    assert -0.6 < mean["SAFE_ADAPTIVE"] < -0.2
    assert abs(mean["EXACT_ADAPTIVE"]) < 0.1
