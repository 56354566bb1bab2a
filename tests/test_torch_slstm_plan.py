"""PyTorch port, K5's launch plan: ``repro_torch.kernels.slstm_scan.plan_scan``
(how ``slstm_cluster_kernel`` cuts a call over thread-block clusters) and a
CPU emulation of the kernel's partitioned arithmetic, held against the plain
version and the JAX Pallas kernel in interpret mode.

The emulation follows the kernel's order of work: per CTA its column slice of
the four gates; per row lane r of a group of ``unit_lanes`` (UL) units (UL
warp slots of 32 / UL row lanes) the float32 partial sums over the input rows
d = r, r + 32, ... (fused multiply-adds, emulated in float64 and rounded
once); the xor butterfly over the row lanes of a slot; the slots' partials
added in order; the gates; and h_t written into the other of two h buffers,
which the next step reads."""
import collections

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.slstm_scan import slstm_scan_pallas
from repro_torch.kernels import slstm_scan as tscan

# (B, S, H, dh): the xlstm-350m scans of the serving path (a decode tick of
# the slot pool, one decode row, prefills of 32 / 48 / 256 tokens), then the
# edges: dh not a multiple of the cluster (48, 100, 33, 1), dh = 2048, more
# batch rows than a CTA takes (9) or than a power of two (5), one head
PLAN_SHAPES = [
    (4, 1, 4, 512), (1, 1, 4, 512), (1, 32, 4, 512), (1, 48, 4, 512), (1, 256, 4, 512),
    (2, 5, 3, 48), (5, 4, 2, 100), (9, 3, 2, 100), (5, 1, 4, 512), (9, 2, 4, 512),
    (1, 8, 1, 512), (2, 3, 1, 2048), (9, 2, 1, 2048), (3, 4, 2, 1), (3, 4, 2, 33),
]


def _ids(shape):
    return "B{}-S{}-H{}-dh{}".format(*shape)


def _cells(plan, B, H, dh):
    """(b, h, e) of every output cell each CTA of the grid computes."""
    out = collections.Counter()
    for z in range(plan.batch_groups):
        rows = range(z * plan.rows, min(B, (z + 1) * plan.rows))
        for h in range(H):
            for x in range(plan.col_blocks):
                for e in range(x * plan.cols, min(dh, (x + 1) * plan.cols)):
                    out.update((b, h, e) for b in rows)
    return out


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids)
def test_plan_covers_every_cell_once_within_the_kernels_limits(shape, esize, max_cluster):
    B, S, H, dh = shape
    p = tscan.plan_scan(B, S, H, dh, esize, max_cluster)
    cells = _cells(p, B, H, dh)
    assert len(cells) == B * H * dh and set(cells.values()) == {1}
    vec = 16 // esize
    units = 4 * p.cols // vec
    # what the C entry checks before it launches
    assert p.cols % vec == 0 and (p.col_blocks - 1) * p.cols < dh <= p.col_blocks * p.cols
    assert p.col_blocks <= max_cluster
    assert p.cluster == (p.col_blocks if S > 1 and p.col_blocks > 1 else 1)
    assert p.threads == 32 * min(tscan.MAX_WARPS, units) <= 512
    assert 1 <= p.rows <= p.row_slots <= tscan.MAX_ROWS and p.row_slots in tscan.ROW_SLOTS
    assert p.rows * p.cols <= tscan.MAX_ITEMS * p.threads
    assert (p.batch_groups - 1) * p.rows < B <= p.batch_groups * p.rows
    assert 0 <= p.resident <= dh and (p.resident == dh or p.resident % 32 == 0)
    # a warp's unit lanes stay inside one gate
    assert p.unit_lanes in (1, 2, 4) and (units // 4) % p.unit_lanes == 0
    hrows = p.col_blocks * p.cols
    assert p.smem == 16 * units * p.resident + 4 * p.row_slots * (2 * hrows + (4 * p.unit_lanes + 1) * p.cols)
    assert p.smem <= tscan.SMEM_LIMIT == 232448


@pytest.mark.parametrize("dh", [1, 7, 32, 48, 100, 256, 512, 1000, 2048])
def test_shared_bytes_stay_within_227_kb(dh):
    for esize in (2, 4):
        for max_cluster in (16, 8, 4):
            for B in (1, 2, 3, 4, 5, 8, 9, 16, 33):
                for S in (1, 2, 256):
                    p = tscan.plan_scan(B, S, 4, dh, esize, max_cluster)
                    assert p.smem <= tscan.SMEM_LIMIT, (dh, esize, max_cluster, B, S, p)
                    if S > 1 and p.resident < dh:  # as many rows as fit, in steps of 32
                        assert p.smem + 16 * (4 * p.cols * esize // 16) * 32 > tscan.SMEM_LIMIT


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [2, 48, 256])
def test_bf16_dh512_is_fully_resident_at_cluster_16(B, S):
    p = tscan.plan_scan(B, S, 4, 512, 2, 16)
    assert (p.cluster, p.col_blocks, p.cols, p.resident) == (16, 16, 32, 512)
    assert p.batch_groups == 1 and p.rows == B
    # a warp reads the 64 contiguous bytes of a gate's row slice, 8 rows at
    # a time; 4 warps split the 512 rows
    assert (p.unit_lanes, p.threads) == (4, 512)
    # 32 columns x 4 gates x 512 rows of bf16: 128 KB of R a CTA
    assert 16 * (4 * 32 // 8) * 512 == 128 * 1024 <= p.smem <= tscan.SMEM_LIMIT


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,dh", [(4, 512), (1, 512), (9, 2048), (5, 100)])
def test_decode_stages_nothing_and_needs_no_cluster(B, dh, esize):
    p = tscan.plan_scan(B, 1, 4, dh, esize, 16)
    assert p.resident == 0 and p.cluster == 1
    assert p.smem == 4 * p.row_slots * (2 * p.col_blocks * p.cols + (4 * p.unit_lanes + 1) * p.cols)


@pytest.mark.parametrize("esize,dh,B", [(4, 512, 1), (4, 512, 4), (2, 2048, 1), (4, 2048, 1), (4, 2048, 9)])
def test_float32_dh512_and_dh2048_are_partly_resident(esize, dh, B):
    p = tscan.plan_scan(B, 256, 1, dh, esize, 16)
    assert 0 <= p.resident < dh and p.resident % 32 == 0
    assert p.resident > 0 or dh == 2048  # dh 2048 at 9 rows keeps only its h buffers


def test_batch_rows_beyond_a_cta_go_to_further_clusters():
    assert tscan.plan_scan(5, 1, 4, 512, 2).batch_groups == 1
    p9 = tscan.plan_scan(9, 1, 4, 512, 2)
    assert (p9.batch_groups, p9.rows, p9.row_slots) == (2, 5, 8)
    p3 = tscan.plan_scan(3, 1, 4, 512, 2)
    assert (p3.rows, p3.row_slots) == (3, 4)


@pytest.mark.parametrize("bad", [(0, 1, 4, 512, 2), (1, 0, 4, 512, 2), (1, 1, 4, 2049, 2), (1, 1, 4, 0, 2), (1, 1, 4, 64, 8)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tscan.plan_scan(*bad)


# ---------------------------------------------------------------------------
# the kernel's partitioned arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def emulate_scan(plan, pre, r_z, r_i, r_f, r_o, c0, n0, h0):
    """The kernel's work order on the CPU (float32 state; see the module
    docstring).  The CTAs of a cluster hold the same two h buffers, so one
    copy of them stands for all."""
    B, S, _, H, dh = pre.shape
    R = torch.stack([r.float() for r in (r_z, r_i, r_f, r_o)], dim=1).double()  # (H, 4, d, e)
    pre32 = pre.float()
    h_all = torch.zeros(B, S, H, dh)
    c1, n1, h1 = (torch.zeros(B, H, dh) for _ in range(3))
    hrows, slots = plan.col_blocks * plan.cols, plan.row_slots
    W, RL = plan.unit_lanes, 32 // plan.unit_lanes
    row_lanes = torch.arange(RL)
    for grp in range(plan.batch_groups):
        b0 = grp * plan.rows
        nb = min(plan.rows, B - b0)
        bs = slice(b0, b0 + nb)
        for hd in range(H):
            hbuf = torch.zeros(2, hrows, slots)
            hbuf[0, :dh, :nb] = h0[bs, hd].T
            c, n, h = c0[bs, hd].clone(), n0[bs, hd].clone(), h0[bs, hd].clone()
            for t in range(S):
                cur = hbuf[t & 1]
                h_t = torch.zeros(nb, dh)
                for x in range(plan.col_blocks):
                    e0, e1 = x * plan.cols, min(dh, (x + 1) * plan.cols)
                    part = torch.zeros(32, 4, slots, e1 - e0)  # per row lane, float32
                    for d0 in range(0, dh, 32):
                        d = d0 + torch.arange(32)
                        ok = d < dh
                        d = d[ok]
                        prod = cur[d].double()[:, None, :, None] * R[hd][:, d, e0:e1].permute(1, 0, 2)[:, :, None, :]
                        part[ok] = (prod + part[ok].double()).float()
                    part = part.reshape(W, RL, 4, slots, e1 - e0)
                    o = RL // 2
                    while o:  # the butterfly over a slot's row lanes
                        part = part + part[:, row_lanes ^ o]
                        o //= 2
                    gsum = part[0, 0]
                    for q in range(1, W):  # the slots' partials, in order
                        gsum = gsum + part[q, 0]
                    gz, gi, gf, go = (gsum[g, :nb] + pre32[bs, t, g, hd, e0:e1] for g in range(4))
                    z, i = torch.tanh(gz), torch.exp(torch.clamp(gi, max=tscan.IGATE_CLIP))
                    f, o = torch.sigmoid(gf), torch.sigmoid(go)
                    c[:, e0:e1] = f * c[:, e0:e1] + i * z
                    n[:, e0:e1] = f * n[:, e0:e1] + i
                    h_t[:, e0:e1] = o * c[:, e0:e1] / torch.clamp(n[:, e0:e1], min=1.0)
                nxt = hbuf[(t + 1) & 1]  # every CTA's block of h_t, rows past nb stay 0
                nxt[:dh, :nb] = h_t.T
                h = h_t
                h_all[bs, t, hd] = h_t
            c1[bs, hd], n1[bs, hd], h1[bs, hd] = c, n, h
    return h_all.to(pre.dtype), c1, n1, h1


def _inputs(seed, B, S, H, dh, dtype):
    """chip_smoke.py's scan inputs: normal pre, R scaled by dh^-1/2, a
    mid-sequence state."""
    rng = np.random.default_rng(seed)
    pre = torch.from_numpy(rng.normal(size=(B, S, 4, H, dh)).astype(np.float32)).to(dtype)
    rs = [torch.from_numpy((rng.normal(size=(H, dh, dh)) * dh**-0.5).astype(np.float32)).to(dtype) for _ in range(4)]
    c0 = torch.from_numpy((rng.normal(size=(B, H, dh)) * 2.0).astype(np.float32))
    n0 = torch.from_numpy((1.0 + np.abs(rng.normal(size=(B, H, dh))) * 3.0).astype(np.float32))
    h0 = torch.from_numpy(np.tanh(rng.normal(size=(B, H, dh))).astype(np.float32))
    return pre, rs, (c0, n0, h0)


def _bf16_ulps(a, b):
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _assert_within_scan_tolerance(got, ref):
    """chip_smoke.py's SCAN_TOLERANCE: float32 |a - b| <= 1e-5 + 1e-5 |b|; a
    bf16 h_all within one bf16 ULP (or 1e-5)."""
    for name, g, r in zip(("h_all", "c1", "n1", "h1"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = (g.float() - r.float()).abs()
        ok = err <= 1e-5 + 1e-5 * r.float().abs()
        if g.dtype == torch.bfloat16:
            ok = (_bf16_ulps(g, r) <= 1) | (err <= 1e-5)
        assert bool(ok.all()), f"{name}: max err {float(err.max())}"


EMULATED = [  # (B, S, H, dh, dtype, max_cluster)
    (2, 5, 3, 48, torch.float32, 16),
    (5, 4, 2, 100, torch.float32, 16),
    (9, 3, 2, 40, torch.float32, 8),
    (3, 6, 1, 64, torch.bfloat16, 16),
    (5, 3, 2, 100, torch.bfloat16, 16),
    (4, 1, 2, 96, torch.bfloat16, 16),
    (1, 4, 1, 2048, torch.bfloat16, 16),
    (2, 3, 1, 512, torch.bfloat16, 16),  # 4 units side by side, 4 slots a group
    (3, 4, 2, 256, torch.float32, 16),
    (2, 3, 1, 256, torch.bfloat16, 16),  # 2 units side by side, 2 slots a group
]


@pytest.mark.parametrize("B,S,H,dh,dtype,max_cluster", EMULATED)
def test_emulated_kernel_matches_the_plain_version(B, S, H, dh, dtype, max_cluster):
    pre, rs, st = _inputs(B * 1000 + dh, B, S, H, dh, dtype)
    plan = tscan.plan_scan(B, S, H, dh, pre.element_size(), max_cluster)
    got = emulate_scan(plan, pre, *rs, *st)
    _assert_within_scan_tolerance(got, tscan.slstm_scan_plain(pre, *rs, *st))


@pytest.mark.parametrize("B,S,H,dh", [(2, 5, 3, 48), (9, 3, 2, 100), (2, 3, 1, 256)])
def test_emulated_kernel_matches_the_pallas_kernel(B, S, H, dh):
    pre, rs, st = _inputs(7 + dh, B, S, H, dh, torch.float32)
    plan = tscan.plan_scan(B, S, H, dh, 4, 16)
    assert plan.cluster > 1 and plan.batch_groups == (2 if B == 9 else 1)
    assert plan.unit_lanes == {48: 1, 100: 2, 256: 4}[dh]
    got = emulate_scan(plan, pre, *rs, *st)
    ref = slstm_scan_pallas(*(jnp.asarray(t.numpy()) for t in (pre, *rs, *st)), interpret=True)
    _assert_within_scan_tolerance(got, tuple(torch.from_numpy(np.array(r)) for r in ref))
