"""Mamba (S6) block for the jamba hybrid — counterpart of
``repro.models.ssm``.

The selective scan is the linear recurrence h_t = a_t * h_{t-1} + b_t over
the sequence, with a_t = exp(dt_t A) and b_t = dt_t B_t x_t, read out as
y_t = h_t . C_t.  The reference evaluates it as a chunked associative scan
(``lax.scan`` over chunks of ``CHUNK``, ``lax.associative_scan`` inside);
here it is the plain sequential float32 recurrence over each chunk, which
differs from the associative products by float32 rounding only.  Per chunk
the port keeps ``a`` and ``b`` alive as (B, c, d_inner, d_state) float32
(c <= ``CHUNK``: 134 MB each at jamba's width for B = 1 and c = 256), one
(B, d_inner, d_state) state and the (B, S, d_inner) read-out; no
(B, S, d_inner, d_state) history.  Decode is the same recurrence for one
step.

The projections (``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``) are
plain matmuls, as in the reference: they are not crossbar consumers, so a
programmed chip never holds them.  Where the decode path mixes a float32
cache with lower-precision parameters, operands are promoted to the wider
type first, as JAX promotes them.

With a cache, the new state is written into the cache tensors in place
(views into the stacked slot-pool cache, which a captured decode tick
reads and writes) and the same dict is returned.  Recurrent state ``h`` is
float32 whatever the cache dtype; ``conv`` holds the last ``d_conv - 1``
inputs of the conv in the cache's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

CHUNK = 256


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.mamba_d_inner or 2 * cfg.d_model


def dt_rank_of(cfg: ModelConfig) -> int:
    return cfg.mamba_dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(cfg: ModelConfig, layers: int, normal, dtype, device) -> Dict[str, torch.Tensor]:
    """The mixer's leaves for ``layers`` stacked layers.  ``normal(shape,
    scale)`` draws one normal tensor; matrices at fan-in**-0.5 (``dt_proj``'s
    fan-in is ``dt_rank``), ``conv_w`` at 0.5, ``conv_b`` / ``dt_bias`` /
    ``A_log`` zeros and ``D_skip`` ones, as in the reference."""
    d, L = cfg.d_model, layers
    din, n, dtr = d_inner_of(cfg), cfg.mamba_d_state, dt_rank_of(cfg)

    def const(shape, value: float) -> torch.Tensor:
        return torch.full((L,) + shape, value, dtype=dtype, device=device)

    return {
        "in_proj": normal((L, d, 2 * din), d**-0.5),
        "conv_w": normal((L, cfg.mamba_d_conv, din), 0.5),
        "conv_b": const((din,), 0.0),
        "x_proj": normal((L, din, dtr + 2 * n), din**-0.5),
        "dt_proj": normal((L, dtr, din), dtr**-0.5),
        "dt_bias": const((din,), 0.0),
        "A_log": const((din, n), 0.0),
        "D_skip": const((din,), 1.0),
        "out_proj": normal((L, din, d), din**-0.5),
    }


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the wider of the two dtypes (JAX's promotion)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0), with no switch to
    ``x`` past a threshold (``F.softplus`` has one)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, in the reference's order.
    x: (B, S, din); w: (K, din)."""
    K, S = w.shape[0], x.shape[1]
    y = x * w[K - 1]
    for j in range(1, K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :S]
        y = y + shifted * w[K - 1 - j]
    return y + b


def _scan(dt, A, B_ssm, C_ssm, xc, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from state ``h`` (B, din, n) float32 over S steps.
    dt, xc: (B, S, din); A: (din, n) float32; B_ssm, C_ssm: (B, S, n).
    Returns (y (B, S, din) float32, the last state).  Runs in chunks of
    ``CHUNK`` (the reference's contract: S <= CHUNK or a multiple of it)."""
    S = dt.shape[1]
    c = min(CHUNK, S)
    if S % c:
        raise ValueError(f"mamba scan length {S} is not a multiple of the chunk {c}")
    dt, B_ssm, C_ssm, xc = (t.to(torch.float32) for t in (dt, B_ssm, C_ssm, xc))
    y = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        a = torch.exp(dt[:, sl, :, None] * A)  # (B, c, din, n)
        bx = dt[:, sl, :, None] * B_ssm[:, sl, None, :] * xc[:, sl, :, None]
        for t in range(c):
            h = a[:, t] * h + bx[:, t]
            y[:, s0 + t] = torch.einsum("bdn,bn->bd", h, C_ssm[:, s0 + t])
    return y, h


def mamba_block(
    params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, _ = x.shape
    din, n, dtr = d_inner_of(cfg), cfg.mamba_d_state, dt_rank_of(cfg)
    K = cfg.mamba_d_conv

    x_in, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    conv_w = params["conv_w"]
    if decode:
        if cache is None or S != 1:
            raise ValueError(f"mamba decode takes one token with a cache, got S={S}")
        wide = torch.promote_types(cache["conv"].dtype, x_in.dtype)
        window = torch.cat([cache["conv"].to(wide), x_in.to(wide)], dim=1)  # (B, K, din)
        w = conv_w.to(wide)
        xc = window[:, 0] * w[0]
        for k in range(1, K):  # the contraction over K in a fixed order
            xc = xc + window[:, k] * w[k]
        xc = xc[:, None] + params["conv_b"]
        new_conv = window[:, 1:]
    else:
        xc = _causal_conv(x_in, conv_w, params["conv_b"])
        new_conv = None
        if cache is not None:
            pad = torch.zeros((B, max(0, K - 1 - S), din), dtype=x_in.dtype, device=x.device)
            new_conv = torch.cat([pad, x_in[:, -(K - 1):]], dim=1)
    xc = F.silu(xc)

    x_db = _mm(xc, params["x_proj"])
    dt, B_ssm, C_ssm = torch.split(x_db, [dtr, n, n], dim=-1)
    dt = _softplus(_mm(dt, params["dt_proj"]) + params["dt_bias"])  # (B, S, din)
    A = -torch.exp(params["A_log"].to(torch.float32))  # (din, n)
    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = torch.zeros((B, din, n), dtype=torch.float32, device=x.device)
    y, h_last = _scan(dt, A, B_ssm, C_ssm, xc, h0)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)

    y = (y + params["D_skip"].to(torch.float32) * xc.to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["out_proj"], cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device="cuda"):
    din, n, K = d_inner_of(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "h": torch.zeros((batch, din, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, din), dtype=dtype, device=device),
    }
