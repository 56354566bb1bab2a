"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, strictly recurrent) — counterpart of
``repro.models.xlstm``.

mLSTM recurrence (per head):
    C_t = f_t C_{t-1} + i_t k_t v_t^T      (dk x dv matrix memory)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)

Prefill uses the chunkwise form (a causal decay matrix within a chunk, the
(B, H, dk, dv) state carried across chunks by a Python loop); decode is the
one-step update.  Both are plain torch, as the reference leaves them to XLA.
The sLSTM recurrence runs on ``kernels.slstm_scan.slstm_scan_cuda`` — the
hand-written scan kernel on the card — in prefill and in decode (S = 1);
under autograd (grad mode on and ``pre`` or a recurrent matrix requiring
grad) on ``SlstmScan``, the same kernel saving its gates for the
hand-written backward.

Recurrent state is float32.  With a cache, the new state is written into the
cache tensors in place (they are views into the stacked slot-pool cache) and
the same dict is returned.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.slstm_scan import IGATE_CLIP, SlstmScan, slstm_scan_cuda

CHUNK = 256


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.xlstm_d_inner or 2 * cfg.d_model


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` (one bound) with the gradient of the
    reference's ``jnp.maximum(x, lo)`` / ``jnp.minimum(x, hi)``: half of it
    where ``x`` equals the bound (``torch.clamp`` passes all of it).  A bf16
    gate pre-activation can be exactly ``IGATE_CLIP``."""
    y = torch.clamp(x, min=lo, max=hi)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return y
    bound = hi if lo is None else lo
    inside = x < bound if lo is None else x > bound
    w = torch.where(x == bound, 0.5, inside.to(x.dtype))
    return y.detach() + w * (x - x.detach())  # the value of y, the gradient w


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_chunk(q, k, v, log_f, log_i, C0, n0):
    """One chunk. q,k,v: (B, c, H, dh); log_f, log_i: (B, c, H) f32.

    Returns (y, C1, n1).
    """
    B, c, H, dh = q.shape
    L = torch.cumsum(log_f, dim=1)  # (B, c, H) cumulative log forget from chunk start
    qf = q.to(torch.float32)
    kf = k.to(torch.float32) * (dh**-0.5)
    vf = v.to(torch.float32)
    decay_t = torch.exp(L)  # (B, c, H)
    y_inter = torch.einsum("bchd,bhde->bche", qf, C0) * decay_t[..., None]

    # intra-chunk causal decay matrix: D_ts = exp(L_t - L_s + log_i_s), s <= t.
    # Above the diagonal diff grows with t - s (past 88 in a chunk of 256 at
    # forget gates near 1/2) and exp overflows; masked before exp, so that
    # backward passes 0 there and not 0 x inf = NaN, as the reference's
    # where(mask, exp(diff), 0) does past about 128 positions.  The same D.
    diff = L[:, :, None, :] - L[:, None, :, :] + log_i[:, None, :, :]  # (B,t,s,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))[None, :, :, None]
    D = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * D
    y_intra = torch.einsum("btsh,bshe->bthe", scores, vf)
    # normalizer accumulates decay-weighted keys (no q): n_t = sum_s D_ts k_s
    n_intra = torch.einsum("btsh,bshd->bthd", D, kf)

    # denominator: max(|n_t . q_t|, 1)
    n_tot = n_intra + torch.einsum("bhd,bth->bthd", n0, decay_t)
    denom = _clip(torch.abs(torch.einsum("bthd,bthd->bth", n_tot, qf)), lo=1.0)
    y = (y_inter + y_intra) / denom[..., None]

    # state update to end of chunk
    total_decay = torch.exp(L[:, -1])  # (B, H)
    w_s = torch.exp(L[:, -1:, :] - L + log_i)  # (B, c, H): decay from s to end
    C1 = total_decay[..., None, None] * C0 + torch.einsum("bchd,bche->bhde", w_s[..., None] * kf, vf)
    n1 = total_decay[..., None] * n0 + torch.einsum("bch,bchd->bhd", w_s, kf)
    return y, C1, n1


def mlstm_block(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, _ = x.shape
    din, H = d_inner_of(cfg), cfg.n_heads
    dh = din // H

    q, k, v = (t.reshape(B, S, H, dh) for t in torch.chunk(x @ params["wqkv"], 3, dim=-1))
    gates = (x @ params["w_gates"]).to(torch.float32).reshape(B, S, 2, H)
    log_i = _clip(gates[:, :, 0], hi=IGATE_CLIP)  # log input gate
    log_f = F.logsigmoid(gates[:, :, 1])  # log forget gate
    o = torch.sigmoid(x @ params["w_ogate"])

    if decode:
        if cache is None or S != 1:
            raise ValueError(f"mLSTM decode takes one token with a cache, got S={S}")
        C0, n0 = cache["C"], cache["n"]
        f_t = torch.exp(log_f[:, 0])[..., None, None]  # (B,H,1,1)
        i_t = torch.exp(log_i[:, 0])[..., None, None]
        kf = k.to(torch.float32)[:, 0] * (dh**-0.5)
        vf = v.to(torch.float32)[:, 0]
        C1 = f_t * C0 + i_t * torch.einsum("bhd,bhe->bhde", kf, vf)
        n1 = f_t[..., 0] * n0 + i_t[..., 0] * kf
        qf = q.to(torch.float32)[:, 0]
        num = torch.einsum("bhde,bhd->bhe", C1, qf)
        den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n1, qf)), min=1.0)
        y = (num / den[..., None])[:, None]  # (B,1,H,dh)
    else:
        c = min(CHUNK, S)
        if S % c != 0:
            raise ValueError(f"mLSTM prefill length {S} is not a multiple of the chunk {c}")
        if cache is not None:
            C1, n1 = cache["C"], cache["n"]
        else:
            C1 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
            n1 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        ys = []
        for s0 in range(0, S, c):
            sl = slice(s0, s0 + c)
            y_c, C1, n1 = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], log_i[:, sl], C1, n1)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    if cache is not None:
        cache["C"].copy_(C1)
        cache["n"].copy_(n1)

    y = y.reshape(B, S, din).to(x.dtype) * o
    return y @ params["out_proj"], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, _ = x.shape
    din, H = d_inner_of(cfg), cfg.n_heads
    dh = din // H
    if decode and S != 1:
        raise ValueError(f"sLSTM decode takes one token, got S={S}")

    pre = (x @ params["w_in"]).reshape(B, S, 4, H, dh)  # z, i, f, o pre-activations
    if cache is not None:
        c0, n0, h0 = cache["c"], cache["n"], cache["h"]
    else:
        c0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        n0 = torch.ones((B, H, dh), dtype=torch.float32, device=x.device)
        h0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)

    rs = (params["r_z"], params["r_i"], params["r_f"], params["r_o"])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (pre, *rs)):
        h_all, c1, n1, h1 = SlstmScan.apply(pre, *rs, c0, n0, h0)
    else:
        h_all, c1, n1, h1 = slstm_scan_cuda(pre, *rs, c0, n0, h0)
    if cache is not None:
        cache["c"].copy_(c1)
        cache["n"].copy_(n1)
        cache["h"].copy_(h1)
    y = h_all.reshape(B, S, din).to(x.dtype)
    return y @ params["out_proj"], cache


def init_xlstm_cache(cfg: ModelConfig, kind: str, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    din, H = d_inner_of(cfg), cfg.n_heads
    dh = din // H
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        return {"C": torch.zeros((batch, H, dh, dh), **f32), "n": torch.zeros((batch, H, dh), **f32)}
    return {
        "c": torch.zeros((batch, H, dh), **f32),
        "n": torch.ones((batch, H, dh), **f32),
        "h": torch.zeros((batch, H, dh), **f32),
    }
