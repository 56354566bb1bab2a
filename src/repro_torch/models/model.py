"""Model assembly: embed -> stages (loop over stacked layers) -> norm ->
logits (counterpart of ``repro.models.model`` for attention, mamba and
xLSTM stages, with dense or MoE FFNs, behind a token or an embedding front
end).

Entry points:
  * ``init_model(cfg, seed, device, dtype, share)`` -> params (nested dicts)
  * ``param_axes(cfg)`` -> the params' logical axes, leaf by leaf
  * ``forward(params, cfg, inp)`` -> logits (B, S, V)
  * ``loss_fn(params, cfg, batch)`` -> next-token cross entropy (training)
  * ``init_cache(cfg, B, S, dtype, device)`` -> cache
  * ``cache_axes(cfg)`` -> the cache's logical axes, leaf by leaf
  * ``prefill(params, cfg, inp, cache)`` -> (last_logits, cache)
  * ``decode_step(params, cfg, inp, pos, cache)`` -> (logits, cache)

``inp`` is (B, S) token ids for ``cfg.frontend == "token"``, and (B, S, D)
precomputed frame or patch embeddings for ``"embed"`` (the audio / vision
stubs of musicgen-large and pixtral-12b), cast to ``cfg.param_dtype``
before layer 0 (``_embed_input``).  An embedding front end has no
``embed`` table and always an untied ``head``.

Layers are stacked per stage on a leading axis (the names are the artifact
keys); a stage runs as a Python loop over that axis.  Caches are updated in
place and returned.  ``forward``, ``prefill`` and ``decode_step`` serve and
run under ``torch.no_grad``.  ``loss_fn`` is the training path: it runs
under autograd when grad mode is on (each layer recomputed in backward under
``cfg.remat``, each loss chunk always), and without grad it is a chip's
evaluation loss under an enabled crossbar mode too (sLSTM stages train
through the scan kernel's hand-written backward, ``kernels.slstm_scan.
SlstmScan``).  Under a ``parallel.Plan`` (the mesh train step) the
params are a rank's blocks: the loss is the global masked mean, and under
the ``tp`` layout attention, the dense FFN, the embedding and the head run
tensor-parallel (``models.parallel``).  The expert banks of an MoE config may hold one
rank's share of the experts (``init_model(share=)``); its MoE layers then
run under ``moe.expert_share(share)``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, StageSpec
from repro_torch.device.programmed import _push_bind_map, name_scope
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import current_crossbar, embed, lm_head, mlp, rms_norm

LOSS_CHUNK = 512  # sequence chunking bounds the live (B, c, V) logits buffer


def require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA device; pass device='cpu'")
    return device


def _stage_layer_maps(si: int):
    """Per-layer artifact bind maps of stage ``si`` (None unless serving from
    a programmed chip)."""
    mode = current_crossbar()
    if not mode.enabled or mode.programmed is None:
        return None
    return mode.programmed.stage_layer_maps(f"stage{si}")


_XLSTM_KINDS = ("mlstm", "slstm")


def _check_kind(kind: str) -> None:
    """Refuse a stage kind that is no block of the model (the reference's
    ``_init_block`` raises ``ValueError`` for it)."""
    if not (kind.startswith("attn") or kind in _XLSTM_KINDS or kind == "mamba"):
        raise ValueError(f"unknown stage kind {kind!r}")


def _require_ported_config(cfg: ModelConfig) -> None:
    """Refuse a stage kind the blocks would otherwise run wrong or fail on
    (a parameter tree carried across from the reference never passes
    through ``init_model``, so every entry point checks)."""
    for spec in cfg.stages:
        for kind in spec.kinds:
            _check_kind(kind)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _init_block(
    cfg: ModelConfig, kind: str, use_moe: bool, repeats: int, gen, dtype, device,
    share: moe_mod.ExpertShare = moe_mod.SINGLE_DEVICE,
) -> Dict[str, Any]:
    """One block position of a stage, its ``repeats`` layers stacked on a
    leading axis.  Matrices draw normal(0, fan_in**-0.5) except the xLSTM
    gate projection (0.02) and recurrent matrices (dh**-0.5), as in the
    reference (MLA's ``w_uk`` / ``w_uv``, (kv_lora_rank, H, dh), at
    kv_lora_rank**-0.5, the reference's leading-dim rule; mamba's leaves as
    ``ssm.init_mamba`` draws them); norm scales are zero (``rms_norm``
    multiplies by ``1 + scale``).  xLSTM blocks carry their own projections
    and have no FFN; a mamba block has one.  A
    post-norm config (gemma2) adds ``norm1_post`` after the mixer and
    ``norm2_post`` after the FFN.  ``use_moe`` makes the FFN an MoE FFN
    (``moe.init_moe``: the experts of ``share``)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = repeats

    def mat(k: int, n: int, scale=None) -> torch.Tensor:
        return _normal(gen, (L, k, n), k**-0.5 if scale is None else scale, dtype, device)

    if kind == "mlstm":
        din = xlstm_mod.d_inner_of(cfg)
        mixer = {
            "wqkv": mat(d, 3 * din), "w_gates": mat(d, 2 * h, scale=0.02),
            "w_ogate": mat(d, din), "out_proj": mat(din, d),
        }
    elif kind == "slstm":
        din = xlstm_mod.d_inner_of(cfg)
        xdh = din // h
        mixer = {"w_in": mat(d, 4 * din)}
        for g in ("r_z", "r_i", "r_f", "r_o"):
            mixer[g] = _normal(gen, (L, h, xdh, xdh), xdh**-0.5, dtype, device)
        mixer["out_proj"] = mat(din, d)
    elif kind == "mamba":
        mixer = ssm_mod.init_mamba(
            cfg, L, lambda shape, scale: _normal(gen, shape, scale, dtype, device), dtype, device
        )
    elif cfg.kv_lora_rank:
        lora, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
        mixer = {
            "wq": mat(d, h * (dh + rope)), "w_kv_down": mat(d, lora + rope),
            "w_uk": _normal(gen, (L, lora, h, dh), lora**-0.5, dtype, device),
            "w_uv": _normal(gen, (L, lora, h, dh), lora**-0.5, dtype, device),
            "wo": mat(h * dh, d),
        }
    else:
        mixer = {"wq": mat(d, h * dh), "wk": mat(d, kv * dh), "wv": mat(d, kv * dh), "wo": mat(h * dh, d)}

    def zeros() -> torch.Tensor:
        return torch.zeros((L, d), dtype=dtype, device=device)

    block: Dict[str, Any] = {"norm1": zeros(), "mixer": mixer}
    if cfg.post_norm:
        block["norm1_post"] = zeros()
    if (cfg.d_ff or use_moe) and kind not in _XLSTM_KINDS:
        block["norm2"] = zeros()
        if use_moe:
            block["ffn"] = moe_mod.init_moe(
                cfg, L, lambda shape, scale: _normal(gen, shape, scale, dtype, device), share
            )
        else:
            wide = 2 * cfg.d_ff if cfg.mlp_kind in ("swiglu", "geglu") else cfg.d_ff
            block["ffn"] = {"wi": mat(d, wide), "wo": mat(cfg.d_ff, d)}
        if cfg.post_norm:
            block["norm2_post"] = zeros()
    return block


def init_model(
    cfg: ModelConfig, seed: int = 0, device="cuda", dtype=None, share: Optional[moe_mod.ExpertShare] = None,
) -> Dict[str, Any]:
    """Random parameters from ``seed`` (own generator on ``device``), in
    ``cfg.param_dtype`` unless ``dtype`` is given.  Same tree, names and init
    scales as the reference (an ``embed`` table for a token front end only,
    a ``head`` unless a token front end ties it); the draws themselves
    differ.  Under ``share`` (a ``moe.ExpertShare``) the expert banks hold
    that share's experts only; everything else is the whole model's."""
    _require_ported_config(cfg)
    device = require_device(device)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {}
    if cfg.frontend == "token":
        params["embed"] = {"tokens": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, device)}
    for si, spec in enumerate(cfg.stages):
        params[f"stage{si}"] = {
            f"b{i}": _init_block(
                cfg, kind, bool(spec.moe[i]) and cfg.moe_experts > 0, spec.repeats, gen, dtype, device,
                share or moe_mod.SINGLE_DEVICE,
            )
            for i, kind in enumerate(spec.kinds)
        }
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings or cfg.frontend != "token":
        params["head"] = _normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dtype, device
        )
    return params


def _mixer_axes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple]:
    """One layer's mixer leaves and their logical axes (the reference's
    ``init_attention``, ``init_mamba``, ``init_mlstm``, ``init_slstm``)."""
    if kind == "mlstm":
        return {"wqkv": ("embed", "d_inner"), "w_gates": ("embed", None), "w_ogate": ("embed", "d_inner"),
                "out_proj": ("d_inner", "embed")}
    if kind == "slstm":
        out = {"w_in": ("embed", "d_inner"), "out_proj": ("d_inner", "embed")}
        out.update({g: (None, None, None) for g in ("r_z", "r_i", "r_f", "r_o")})
        return out
    if kind == "mamba":
        return {"in_proj": ("embed", "d_inner"), "conv_w": (None, "d_inner"), "conv_b": ("d_inner",),
                "x_proj": ("d_inner", None), "dt_proj": (None, "d_inner"), "dt_bias": ("d_inner",),
                "A_log": ("d_inner", None), "D_skip": ("d_inner",), "out_proj": ("d_inner", "embed")}
    if cfg.kv_lora_rank:
        return {"wq": ("embed", "heads"), "w_kv_down": ("embed", None), "w_uk": (None, "heads", None),
                "w_uv": (None, "heads", None), "wo": ("heads", "embed")}
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"), "wv": ("embed", "kv_heads"),
            "wo": ("heads", "embed")}


def _ffn_axes(cfg: ModelConfig, use_moe: bool) -> Dict[str, Tuple]:
    """One layer's FFN leaves and their logical axes (the reference's
    ``init_mlp`` and ``init_moe``: the shared expert's F dim is "mlp" under
    all-reduce dispatch, replicated under all-to-all)."""
    if not use_moe:
        return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    glu = cfg.mlp_kind in ("swiglu", "geglu")
    out = {k: ax for k, ax in moe_mod._LOGICAL_AXES.items() if k != "wg" or glu}
    if cfg.moe_shared_experts:
        ax = None if cfg.moe_dispatch == "alltoall" else "mlp"
        out.update(shared_wi=("embed", ax), shared_wo=(ax, "embed"))
        if glu:
            out["shared_wg"] = ("embed", ax)
    return out


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf of ``init_model(cfg)``'s tree, a tuple
    of names (None: replicated) one per dim, with the leading "layers" axis
    of the stacked stages: the reference's ``init_model(...)[1]``.  The
    specs of ``launch.sharding`` are derived from it."""
    _require_ported_config(cfg)
    layered = lambda tree: {k: ("layers",) + ax for k, ax in tree.items()}  # noqa: E731
    axes: Dict[str, Any] = {}
    if cfg.frontend == "token":
        axes["embed"] = {"tokens": ("vocab", "embed")}
    for si, spec in enumerate(cfg.stages):
        stage = {}
        for i, kind in enumerate(spec.kinds):
            use_moe = bool(spec.moe[i]) and cfg.moe_experts > 0
            block: Dict[str, Any] = {"norm1": (None,), "mixer": _mixer_axes(cfg, kind)}
            if cfg.post_norm:
                block["norm1_post"] = (None,)
            if (cfg.d_ff or use_moe) and kind not in _XLSTM_KINDS:
                block["norm2"] = (None,)
                block["ffn"] = _ffn_axes(cfg, use_moe)
                if cfg.post_norm:
                    block["norm2_post"] = (None,)
            stage[f"b{i}"] = {k: layered(v) if isinstance(v, dict) else ("layers",) + v for k, v in block.items()}
        axes[f"stage{si}"] = stage
    axes["final_norm"] = (None,)
    if not cfg.tie_embeddings or cfg.frontend != "token":
        axes["head"] = ("embed", "vocab")
    return axes


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16, device="cuda"):
    """Cache: list per stage of {b<i>: leaves stacked (repeats, ...)}:
    attention {k, v} (repeats, B, S, KV, dh) in ``dtype`` (MLA {latent,
    k_rope}: (repeats, B, S, kv_lora_rank) and (repeats, B, S,
    qk_rope_dim)); xLSTM recurrent
    state in float32 (mLSTM {C, n}, sLSTM {c, n, h} with ``n`` at ones);
    mamba {h (repeats, B, d_inner, d_state) float32, conv (repeats, B,
    d_conv - 1, d_inner) in ``dtype``}."""
    _require_ported_config(cfg)
    device = require_device(device)
    stages = []
    for spec in cfg.stages:
        entry = {}
        for i, kind in enumerate(spec.kinds):
            if kind in _XLSTM_KINDS:
                one = xlstm_mod.init_xlstm_cache(cfg, kind, batch, device)
            elif kind == "mamba":
                one = ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
            else:
                one = attn_mod.init_attention_cache(cfg, batch, seq, dtype, device)
            entry[f"b{i}"] = {
                n: a.unsqueeze(0).repeat((spec.repeats,) + (1,) * a.ndim) for n, a in one.items()
            }
        stages.append(entry)
    return stages


def cache_axes(cfg: ModelConfig):
    """Logical-axis tree parallel to ``init_cache``: cache_batch, cache_seq
    (``serving.kvcache`` pages along it), kv_heads / heads / d_inner.
    Refuses what ``init_cache`` refuses (an unknown stage kind)."""
    _require_ported_config(cfg)

    def block_axes(kind: str):
        if kind == "mamba":
            return {
                "h": ("layers", "cache_batch", "d_inner", None),
                "conv": ("layers", "cache_batch", None, "d_inner"),
            }
        if kind == "mlstm":
            return {
                "C": ("layers", "cache_batch", "heads", None, None),
                "n": ("layers", "cache_batch", "heads", None),
            }
        if kind == "slstm":
            return {
                "c": ("layers", "cache_batch", "heads", None),
                "n": ("layers", "cache_batch", "heads", None),
                "h": ("layers", "cache_batch", "heads", None),
            }
        if cfg.kv_lora_rank:
            return {
                "latent": ("layers", "cache_batch", "cache_seq", None),
                "k_rope": ("layers", "cache_batch", "cache_seq", None),
            }
        return {
            "k": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
            "v": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
        }

    return [
        {f"b{i}": block_axes(kind) for i, kind in enumerate(spec.kinds)}
        for spec in cfg.stages
    ]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _unbind_layers(tree: Any, repeats: int) -> List[Any]:
    """The ``repeats`` per-layer views of a stacked tree, one ``unbind`` a
    leaf: under autograd the layers' gradients then meet in one stacked
    gradient (a select per layer would build a zero-padded full-size
    gradient for every layer)."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, repeats) for k, v in tree.items()}
        return [{k: per[k][r] for k in per} for r in range(repeats)]
    return list(torch.unbind(tree, 0))


def _pre_norm(params, key: str, x, cfg: ModelConfig):
    """The pre-norm ``params[key]`` of a sub-block: under a tensor-parallel
    plan the start of its region, where the residual stream and the norm's
    scale enter it (``parallel.pre_norm``: their gradients from the region
    are partial, summed over the model axis)."""
    if parallel.tp_plan() is None:
        return rms_norm(x, params[key], cfg.norm_eps)
    return parallel.pre_norm(x, params[key], cfg.norm_eps)


def _apply_block(
    params, x, cfg: ModelConfig, kind: str, use_moe: bool, positions, cache_entry=None, decode_pos=None
):
    tp = parallel.tp_plan() is not None
    h = _pre_norm(params, "norm1", x, cfg)
    new_entry = None
    with name_scope("mixer"):
        if tp:
            h = parallel.attention(params["mixer"], h, cfg, kind, positions)
        elif kind == "mlstm":
            h, new_entry = xlstm_mod.mlstm_block(
                params["mixer"], h, cfg, cache_entry, decode=decode_pos is not None
            )
        elif kind == "slstm":
            h, new_entry = xlstm_mod.slstm_block(
                params["mixer"], h, cfg, cache_entry, decode=decode_pos is not None
            )
        elif kind == "mamba":
            h, new_entry = ssm_mod.mamba_block(
                params["mixer"], h, cfg, cache_entry, decode=decode_pos is not None
            )
        else:
            h, new_entry = attn_mod.attention_block(
                params["mixer"], h, cfg, kind, positions, cache_entry, decode_pos
            )
    if cfg.post_norm:
        h = rms_norm(h, params["norm1_post"], cfg.norm_eps)
    x = x + h
    if "norm2" in params:
        h = _pre_norm(params, "norm2", x, cfg)
        with name_scope("ffn"):
            if use_moe:
                h = moe_mod.moe_ffn(params["ffn"], h, cfg)
            elif tp:
                h = parallel.mlp(params["ffn"], h, cfg)
            else:
                h = mlp(params["ffn"], h, cfg.mlp_kind)
        if cfg.post_norm:
            h = rms_norm(h, params["norm2_post"], cfg.norm_eps)
        x = x + h
    return x, new_entry


def _run_stage(
    params_stage,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: StageSpec,
    positions: torch.Tensor,
    cache_stage=None,
    decode_pos: Optional[torch.Tensor] = None,
    layer_maps: Optional[List[Dict[str, Any]]] = None,
    remat: bool = False,
):
    """Walk the stacked layer axis.  Must run under ``name_scope("stage{i}")``;
    layer ``r``'s artifact views (``layer_maps[r]``, sliced once when the chip
    was bound) are pushed for its blocks.  ``cache_stage`` is written in place
    through per-layer views.  ``remat`` (training, no cache): each layer is
    recomputed in backward and saves only its input, the counterpart of the
    reference's ``jax.checkpoint(body, policy=nothing_saveable)``."""
    layers = _unbind_layers(params_stage, spec.repeats)
    caches = _unbind_layers(cache_stage, spec.repeats) if cache_stage is not None else [None] * spec.repeats
    share = moe_mod.current_expert_share()
    for r in range(spec.repeats):

        def layer(x, lp=layers[r], cl=caches[r]):
            # the share is entered again here: a recompute in backward runs
            # outside the caller's context
            with moe_mod.expert_share(share):
                for i, kind in enumerate(spec.kinds):
                    entry = cl[f"b{i}"] if cl is not None else None
                    with name_scope(f"b{i}"):
                        x, _ = _apply_block(
                            lp[f"b{i}"], x, cfg, kind, bool(spec.moe[i]) and cfg.moe_experts > 0,
                            positions, entry, decode_pos,
                        )
            return x

        with _push_bind_map(layer_maps[r] if layer_maps is not None else {}):
            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return x, cache_stage


def _embed_input(params, cfg: ModelConfig, inp: torch.Tensor) -> torch.Tensor:
    """Layer 0's input: token ids through the embedding table, or
    precomputed frame / patch embeddings (B, S, D) cast to
    ``cfg.param_dtype`` (in bf16 the stub's float32 frames are rounded
    here, as in the reference)."""
    if cfg.frontend == "token":
        if parallel.tp_plan() is not None:
            return parallel.embed(params["embed"], inp, cfg)
        return embed(params["embed"], inp, cfg.embed_scale, cfg.d_model)
    return inp.to(getattr(torch, cfg.param_dtype))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and cfg.frontend == "token":
        # the tied head serves from the transposed artifact that
        # program_model(tie_lm_head=True) binds under the embedding's name
        return lm_head(
            params["embed"]["tokens"], x, tied=True, cap=cfg.logit_softcap, name="embed/tokens"
        )
    return lm_head(params["head"], x, tied=False, cap=cfg.logit_softcap, name="head")


def _stages(params, cfg: ModelConfig, x, positions, cache=None, decode_pos=None, remat=False):
    for si, spec in enumerate(cfg.stages):
        with name_scope(f"stage{si}"):
            x, _ = _run_stage(
                params[f"stage{si}"], x, cfg, spec, positions,
                cache_stage=(cache[si] if cache is not None else None),
                decode_pos=decode_pos, layer_maps=_stage_layer_maps(si), remat=remat,
            )
    return x


@torch.no_grad()
def forward(params, cfg: ModelConfig, inp: torch.Tensor, positions=None) -> torch.Tensor:
    """Full-sequence forward. Returns logits (B, S, V)."""
    _require_ported_config(cfg)
    x = _embed_input(params, cfg, inp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _logits(params, cfg, _stages(params, cfg, x, positions))


def loss_chunk(S: int) -> int:
    """Positions a loss chunk covers: ``LOSS_CHUNK``, or the whole sequence
    where ``S`` is not a multiple of it (the reference's rule)."""
    c = min(LOSS_CHUNK, S)
    return c if S % c == 0 else S


def _chunk_nll(params, cfg: ModelConfig, xc, tc, mc) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk: the head, a float32
    logsumexp and a gather of the target logit (exact, where the reference
    contracts with a one-hot to keep the vocab dim sharded); vocab-parallel
    under a tensor-parallel plan (``parallel.chunk_nll``)."""
    if parallel.tp_plan() is not None:
        return parallel.chunk_nll(params, cfg, xc, tc, mc)
    logits = _logits(params, cfg, xc).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, tc.to(torch.int64)[..., None])[..., 0]
    return torch.sum((lse - lab) * mc)


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token cross entropy.  ``batch``: {"inputs": (B, S) tokens or
    (B, S, D) embeddings, "targets": (B, S), optional "mask": (B, S)}; the
    masked sum over ``max(sum(mask), 1)``.

    The head and logsumexp run in chunks of ``LOSS_CHUNK`` positions (the
    whole sequence where ``S`` is not a multiple), each recomputed in
    backward, so the live logits stay at (B, c, V).  Grad mode decides the
    path: with grad (training) layers are recomputed under ``cfg.remat`` and
    an enabled crossbar mode is refused; without grad it runs under the
    active crossbar mode, for a chip's evaluation loss."""
    _require_ported_config(cfg)
    grad = torch.is_grad_enabled()
    if grad and current_crossbar().enabled:
        raise RuntimeError(
            "loss_fn under an enabled crossbar mode runs without grad only (a chip's "
            "evaluation loss); training runs on the plain matmuls"
        )
    x = _embed_input(params, cfg, batch["inputs"])
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x = _stages(params, cfg, x, positions, remat=cfg.remat and grad)
    targets = batch["targets"]
    mask = batch.get("mask")
    mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device) if mask is None else mask.to(torch.float32)

    c = loss_chunk(S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, S, c):
        part = (params, cfg, x[:, j:j + c], targets[:, j:j + c], mask[:, j:j + c])
        total = total + (checkpoint(_chunk_nll, *part, use_reentrant=False) if grad else _chunk_nll(*part))
    return _masked_mean(total, mask)


def _masked_mean(total: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The NLL sum over ``max(sum(mask), 1)``; under a plan whose batch is
    split over ranks, the rank's sum over the *global* mask count, summed
    over the batch axes (``parallel.batch_sum``): the global masked mean on
    every rank."""
    plan = parallel.current()
    den = torch.sum(mask)
    if plan is None or not plan.batch_axes:
        return total / torch.clamp(den, min=1.0)
    den = plan.mesh.psum(den, plan.batch_axes)
    return parallel.batch_sum(total / torch.clamp(den, min=1.0))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, inp: torch.Tensor, cache):
    """Process the prompt, fill the cache; returns (last_logits, cache)."""
    _require_ported_config(cfg)
    x = _embed_input(params, cfg, inp)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _stages(params, cfg, x, positions, cache=cache)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, inp: torch.Tensor, pos: torch.Tensor, cache):
    """One decode step at position ``pos`` — 0-d, or (B,) per-slot positions
    for continuous batching.  Returns (logits, cache)."""
    _require_ported_config(cfg)
    x = _embed_input(params, cfg, inp)  # (B, 1) tokens or (B, 1, D) embeddings
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    x = _stages(params, cfg, x, positions, cache=cache, decode_pos=pos)
    return _logits(params, cfg, x)[:, 0], cache
