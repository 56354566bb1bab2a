"""jamba-v0.1-52b — Mamba + attention 1:7 interleave with MoE
[arXiv:2403.19887].

32L in four 8-layer periods: one attention layer (position 4) per 7 Mamba
layers; MoE (16 experts, top-2) on every other layer, dense d_ff=14336 on
the rest.  d_model=4096, 32 heads (GQA kv=8), Mamba d_inner=8192, d_state=16,
conv=4, dt_rank=256, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

_PERIOD = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")
_MOE = (False, True, False, True, False, True, False, True)

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        stages=(StageSpec(kinds=_PERIOD, repeats=4, moe=_MOE),),
        moe_experts=16,
        moe_top_k=2,
        moe_shared_experts=0,
        moe_d_ff=14336,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_d_inner=8192,
        mamba_dt_rank=256,
        mlp_kind="swiglu",
        tie_embeddings=False,
        optimizer="adamw",
        fsdp=True,
        source="arXiv:2403.19887 (hf)",
    )
)
