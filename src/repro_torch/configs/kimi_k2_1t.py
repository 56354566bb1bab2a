"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config)
[arXiv:2501.kimi2, unverified].

61L, d_model=7168, 64 heads (GQA kv=8 per the assignment table), vocab
163840.  MoE: 384 routed experts top-8 + 1 shared, expert d_ff=2048; first
layer dense (d_ff=18432).  Adafactor is mandatory at this scale.
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18432,  # the single dense layer
        vocab_size=163840,
        stages=(
            StageSpec(kinds=("attn",), repeats=1, moe=(False,)),
            StageSpec(kinds=("attn",), repeats=60, moe=(True,)),
        ),
        moe_experts=384,
        moe_top_k=8,
        moe_shared_experts=1,
        moe_d_ff=2048,
        moe_dispatch="alltoall",
        mlp_kind="swiglu",
        tie_embeddings=False,
        optimizer="adafactor",
        fsdp=True,
        layout_decode="expert_tp",
        source="arXiv:2501.kimi2 (paper-table, unverified)",
    )
)
