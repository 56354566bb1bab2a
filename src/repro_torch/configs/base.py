"""Model configuration system.

A ``ModelConfig`` fully describes one architecture: dimensions, the per-layer
block pattern (attention variants / Mamba / xLSTM), MoE routing, and
parallelism/training preferences.  Configs are registered by id and selected
with ``--arch <id>`` throughout the launchers.

The layer stack is organized into **stages**: a stage is a repeating
super-block (e.g. gemma2's [local, global] pair; jamba's 8-layer period) whose
parameters are stacked on a leading axis (the names of the stacked leaves are
the programmed-artifact keys) and executed as a loop over that axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """A repeated super-block: ``kinds`` executed in order, ``repeats`` times.

    ``moe`` marks which positions within the super-block use the MoE FFN
    (True) vs the dense FFN / no FFN.
    """

    kinds: Tuple[str, ...]
    repeats: int
    moe: Tuple[bool, ...] = ()

    def __post_init__(self):
        if not self.moe:
            object.__setattr__(self, "moe", tuple(False for _ in self.kinds))

    @property
    def n_layers(self) -> int:
        return len(self.kinds) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[StageSpec, ...] = ()
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10000.0
    sliding_window: int = 0  # window for attn_local layers
    attn_softcap: float = 0.0  # gemma2 attention logit soft-capping
    logit_softcap: float = 0.0  # gemma2 final logit soft-capping
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # EP dispatch: "allreduce" (model-replicated tokens, local experts, psum
    # combine — no a2a) or "alltoall" (sequence-sharded tokens, GShard-style
    # all-to-all dispatch/combine — moves only routed tokens).  §Perf
    # hillclimb measures both; alltoall wins for large-E MoE.
    moe_dispatch: str = "allreduce"

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_d_inner: int = 0
    mamba_dt_rank: int = 0

    # xLSTM
    xlstm_d_inner: int = 0

    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu | relu2
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2: extra norm after each sub-block
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    frontend: str = "token"  # token | embed (audio/vlm stubs feed embeddings)

    # substrate preferences
    optimizer: str = "adamw"  # adamw | adafactor
    remat: bool = True
    param_dtype: str = "bfloat16"
    # FSDP (ZeRO-3): additionally shard large params + optimizer state over
    # the "data" axis (per-pod; replicated across pods — inter-pod per-layer
    # all-gathers would swamp the pod links).  Needed when params do not fit
    # under tensor parallelism alone.
    fsdp: bool = False
    # carried for parity with the reference config (its layer-scan switch);
    # the port always walks the stacked layer axis in a Python loop
    scan_layers: bool = True
    # Parallel layout: "tp" (default: TP/SP/EP over the model axis),
    # "pure_dp" (model axis as extra data parallelism — fastest for small
    # models on the fixed production mesh), "expert_tp" (weights-
    # stationary MoE serving), or "ep_only" (experts sharded over the model
    # axis, everything else replicated — programmed crossbar serving on a
    # mesh is bit-identical to the single-device chip).  See §Perf.
    layout: str = "tp"
    # Layout override for decode/serving cells (e.g. "expert_tp": training
    # moves weights (FSDP) because tokens >> weights; decode moves
    # activations because weights >> tokens).
    layout_decode: str = ""

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.stages:
            object.__setattr__(
                self, "stages", (StageSpec(kinds=("attn",), repeats=self.n_layers),)
            )
        total = sum(s.n_layers for s in self.stages)
        assert total == self.n_layers, f"{self.name}: stages cover {total} != {self.n_layers}"

    # --- helpers used across the framework --------------------------------
    def block_pattern_summary(self) -> List[str]:
        out: List[str] = []
        for s in self.stages:
            out.extend(list(s.kinds) * s.repeats)
        return out

    def moe_layer(self, i: int) -> bool:
        flat: List[bool] = []
        for s in self.stages:
            flat.extend(list(s.moe) * s.repeats)
        return flat[i] if self.moe_experts else False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Exact parameter count from the block pattern (used for 6ND)."""
        d = self.d_model
        total = 0
        if self.frontend == "token":
            total += self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for i, kind in enumerate(self.block_pattern_summary()):
            total += 2 * d  # norms (approx: pre-norm per sub-block)
            if kind.startswith("attn"):
                if self.kv_lora_rank:
                    total += d * self.q_dim  # q proj
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * 2 * self.q_dim
                    total += self.q_dim * d
                else:
                    total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif kind == "mamba":
                din = self.mamba_d_inner or 2 * d
                dt = self.mamba_dt_rank or max(1, math.ceil(d / 16))
                total += d * 2 * din  # in_proj
                total += din * (dt + 2 * self.mamba_d_state)  # x_proj
                total += dt * din + din * d  # dt_proj + out_proj
                total += din * self.mamba_d_conv + din * self.mamba_d_state  # conv + A
            elif kind in ("mlstm", "slstm"):
                din = self.xlstm_d_inner or 2 * d
                total += d * 3 * din + d * 2 * din + din * d
            if self.moe_layer(i):
                e_params = 3 * self.moe_d_ff * d if self.mlp_kind in ("swiglu", "geglu") else 2 * self.moe_d_ff * d
                total += (self.moe_experts + self.moe_shared_experts) * e_params
                total += d * self.moe_experts  # router
            elif self.d_ff and not kind in ("mlstm", "slstm"):
                if self.mlp_kind in ("swiglu", "geglu"):
                    total += 3 * self.d_ff * d
                else:
                    total += 2 * self.d_ff * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        e_params = (
            3 * self.moe_d_ff * d
            if self.mlp_kind in ("swiglu", "geglu")
            else 2 * self.moe_d_ff * d
        )
        inactive = 0
        for i, _ in enumerate(self.block_pattern_summary()):
            if self.moe_layer(i):
                inactive += (self.moe_experts - self.moe_top_k) * e_params
        return self.param_count() - inactive


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _  # ensure registry population

    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a smoke-test-sized config of the same family.

    Shrinks width/depth/experts/vocab while preserving the block pattern
    structure (every stage keeps its kinds, with 1-2 repeats).
    """
    d_model = overrides.pop("d_model", 64)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    head_dim = d_model // n_heads
    stages = tuple(
        StageSpec(kinds=s.kinds, repeats=min(s.repeats, 1 if len(s.kinds) > 1 else 2), moe=s.moe)
        for s in cfg.stages
    )
    n_layers = sum(s.n_layers for s in stages)
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        stages=stages,
        rope_theta=cfg.rope_theta,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        attn_softcap=cfg.attn_softcap,
        logit_softcap=cfg.logit_softcap,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_rope_dim=16 if cfg.qk_rope_dim else 0,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_experts else 0,
        moe_shared_experts=min(cfg.moe_shared_experts, 1),
        moe_d_ff=64 if cfg.moe_experts else 0,
        mamba_d_state=min(cfg.mamba_d_state, 8),
        mamba_d_conv=cfg.mamba_d_conv,
        mamba_d_inner=2 * d_model if cfg.mamba_d_inner else 0,
        mamba_dt_rank=8 if cfg.mamba_dt_rank else 0,
        xlstm_d_inner=2 * d_model if cfg.xlstm_d_inner else 0,
        mlp_kind=cfg.mlp_kind,
        post_norm=cfg.post_norm,
        tie_embeddings=cfg.tie_embeddings,
        embed_scale=cfg.embed_scale,
        frontend=cfg.frontend,
        optimizer="adamw",
        remat=False,
        param_dtype="float32",
    )
    kw.update(overrides)
    return ModelConfig(**kw)
