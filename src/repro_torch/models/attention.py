"""Grouped-query attention and absorbed multi-head latent attention (MLA,
deepseek-v2) with caches for prefill/decode serving (counterpart of
``repro.models.attention``).

Plain ``torch.einsum`` — the reference leaves attention to the compiler, so
no kernel is owed here — with scores and softmax in float32.  GQA grouping
stays inside the einsum so KV heads are never materialized repeated; prefill
attention walks query chunks of ``Q_CHUNK`` to bound the live score tensor.
MLA scores the queries against the latent cache directly (``w_uk`` absorbed
into the query, ``w_uv`` applied after the context), so per-head keys and
values are never materialized; its cache is ``latent`` (B, S, kv_lora_rank)
and ``k_rope`` (B, S, qk_rope_dim).

Caches are updated **in place** (the reference returns fresh arrays): the
blocks write into the tensors they are handed and return them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, crossbar_linear, softcap

Q_CHUNK = 256  # bounds live scores at (B, 256, H, S)
NEG_INF = -2.3819763e38  # most-negative bf16-representable-ish


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, qc, G, R, dh); k: (B, S, G, dh) -> (B, qc, G, R, S) float32."""
    return torch.einsum("bqgrd,bsgd->bqgrs", q.to(torch.float32), k.to(torch.float32))


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, qc, G, R, S); v: (B, S, G, dh) -> (B, qc, G, R, dh)."""
    return torch.einsum("bqgrs,bsgd->bqgrd", p, v.to(p.dtype))


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, window: int) -> torch.Tensor:
    m = pos_k[None, :] <= pos_q[:, None]
    if window:
        m &= pos_k[None, :] > (pos_q[:, None] - window)
    return m


def _masked_softmax(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    s = torch.where(m, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    return torch.softmax(s, dim=-1)


def gqa_attention(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, Sk, KV, dh)
    v: torch.Tensor,
    *,
    scale: float,
    window: int = 0,
    attn_cap: float = 0.0,
    q_offset: int = 0,
    chunk: int = Q_CHUNK,
) -> torch.Tensor:
    B, S, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, R = KV, H // KV
    qg = q.reshape(B, S, G, R, dh)
    pos_k = torch.arange(Sk, device=q.device)

    def block(q_blk: torch.Tensor, start: int) -> torch.Tensor:
        pos_q = q_offset + start + torch.arange(q_blk.shape[1], device=q.device)
        s = _gqa_scores(q_blk, k) * scale
        if attn_cap:
            s = softcap(s, attn_cap)
        p = _masked_softmax(s, _mask(pos_q, pos_k, window)[None, :, None, None, :])
        return _gqa_out(p, v)

    if S <= chunk:
        out = block(qg, 0)
    else:
        assert S % chunk == 0, (S, chunk)
        out = torch.cat([block(qg[:, c:c + chunk], c) for c in range(0, S, chunk)], dim=1)
    return out.reshape(B, S, H, dh).to(q.dtype)


def decode_attention(q, k, v, pos, *, scale, window=0, attn_cap=0.0):
    """Single-position decode: q (B, 1, H, dh) against the full cache
    (B, S, KV, dh).  ``pos`` is the index of the newest token — 0-d, or (B,)
    per-slot positions; cache entries beyond a slot's position are masked."""
    B, _, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, R = KV, H // KV
    s = _gqa_scores(q.reshape(B, 1, G, R, dh), k) * scale  # (B,1,G,R,S)
    if attn_cap:
        s = softcap(s, attn_cap)
    pos_k = torch.arange(Sk, device=q.device)
    pos_b = torch.broadcast_to(pos, (B,))
    m = pos_k[None, :] <= pos_b[:, None]
    if window:
        m &= pos_k[None, :] > (pos_b[:, None] - window)
    p = _masked_softmax(s, m[:, None, None, None, :])
    return _gqa_out(p, v).reshape(B, 1, H, dh).to(q.dtype)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one decode step into the cache at ``pos`` (0-d, or (B,) per-slot
    positions), in place.  The position stays on the device (no host read),
    so the write can be captured in a CUDA graph."""
    new = new.to(cache.dtype)
    if pos.ndim == 0:
        cache.index_copy_(1, pos.reshape(1).to(torch.int64), new)
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = new[:, 0]
    return cache


def attention_block(
    params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    kind: str,  # attn | attn_local | attn_global
    positions: torch.Tensor,  # (S,) absolute positions, or (B, 1) at decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if cfg.kv_lora_rank:
        return _mla_block(params, x, cfg, positions, cache, decode_pos)
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "attn_local" else 0
    scale = cfg.attn_scale if cfg.attn_scale else dh**-0.5

    q = crossbar_linear(x, params["wq"], name="wq").reshape(B, S, H, dh)
    k = crossbar_linear(x, params["wk"], name="wk").reshape(B, S, KV, dh)
    v = crossbar_linear(x, params["wv"], name="wv").reshape(B, S, KV, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None or decode_pos is None:
        out = gqa_attention(q, k, v, scale=scale, window=window, attn_cap=cfg.attn_softcap)
        if cache is not None:
            # prefill: attend within the prompt and fill the cache
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            new_cache = cache
    else:
        kc = _cache_write(cache["k"], k, decode_pos)
        vc = _cache_write(cache["v"], v, decode_pos)
        out = decode_attention(
            q, kc, vc, decode_pos, scale=scale, window=window, attn_cap=cfg.attn_softcap
        )
        new_cache = {"k": kc, "v": vc}

    y = crossbar_linear(out.reshape(B, S, H * dh), params["wo"], name="wo")
    return y, new_cache


def init_attention_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16, device="cuda"):
    if cfg.kv_lora_rank:
        return {
            "latent": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype, device=device),
        }
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MLA (deepseek-v2), the absorbed form
# ---------------------------------------------------------------------------

def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of two operands in float32 (the reference's
    ``preferred_element_type=float32``: a bfloat16 operand widens exactly,
    and the result is not rounded back to it)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _mla_block(params, x, cfg: ModelConfig, positions, cache, decode_pos):
    """The reference's ``_mla_block``: the query's no-rope part absorbs
    ``w_uk`` (its einsum in the operands' promoted dtype, as the reference
    computes it); scores are the latent scores plus the decoupled-rope
    scores, both with the query cast to the key's dtype (the cache's, where
    there is a cache) and summed in float32; the float32 softmax's weights,
    cast to the latent's dtype, attend over the latent, and ``w_uv`` lifts
    the context per head in float32, cast to ``x``'s dtype before ``wo``.

    With a cache, a prefill writes the prompt's latents at the front of the
    cache and scores against the whole cache, its positions past the prompt
    masked (the reference's ``Sk = max_seq``); a decode writes its step at
    ``decode_pos`` (0-d or (B,)) and masks each slot's positions past it."""
    B, S, D = x.shape
    H, dh, rope_d, lora = cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = (dh + rope_d) ** -0.5

    q = crossbar_linear(x, params["wq"], name="wq").reshape(B, S, H, dh + rope_d)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kvd = crossbar_linear(x, params["w_kv_down"], name="w_kv_down")  # (B, S, lora + rope)
    latent, k_rope = kvd[..., :lora], kvd[..., lora:]
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]

    new_cache = None
    if cache is not None:
        if decode_pos is None:
            cache["latent"][:, :S] = latent.to(cache["latent"].dtype)
            cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
        else:
            _cache_write(cache["latent"], latent, decode_pos)
            _cache_write(cache["k_rope"], k_rope, decode_pos)
        new_cache = cache
        latent_k, rope_k = cache["latent"], cache["k_rope"]
    else:
        latent_k, rope_k = latent, k_rope
    Sk = latent_k.shape[1]

    # absorb w_uk into the query: q_abs (B, S, H, lora)
    w_uk = params["w_uk"]
    q_abs = _contract("bshd,lhd->bshl", q_nope, w_uk).to(torch.promote_types(q_nope.dtype, w_uk.dtype))
    w_uv = params["w_uv"].to(torch.float32)
    pos_k = torch.arange(Sk, device=x.device)

    def block(qa: torch.Tensor, qr: torch.Tensor, start: int) -> torch.Tensor:
        s = _contract("bqhl,bsl->bqhs", qa.to(latent_k.dtype), latent_k)
        s = s + _contract("bqhr,bsr->bqhs", qr.to(rope_k.dtype), rope_k)
        s = s * scale
        if decode_pos is None:
            pos_q = start + torch.arange(qa.shape[1], device=x.device)
            m = (pos_k[None, :] <= pos_q[:, None])[None, :, None, :]
        else:
            pos_b = torch.broadcast_to(decode_pos, (B,))
            m = (pos_k[None, :] <= pos_b[:, None])[:, None, None, :]
        p = _masked_softmax(s, m)
        # attend over the latent, then lift the context per head
        ctx = _contract("bqhs,bsl->bqhl", p.to(latent_k.dtype), latent_k)
        return torch.einsum("bqhl,lhd->bqhd", ctx, w_uv)

    if decode_pos is not None or S <= Q_CHUNK:
        out = block(q_abs, q_rope, 0)
    else:
        assert S % Q_CHUNK == 0, (S, Q_CHUNK)
        out = torch.cat(
            [block(q_abs[:, c:c + Q_CHUNK], q_rope[:, c:c + Q_CHUNK], c) for c in range(0, S, Q_CHUNK)], dim=1
        )

    y = crossbar_linear(out.reshape(B, S, H * dh).to(x.dtype), params["wo"], name="wo")
    return y, new_cache
