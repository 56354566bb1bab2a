"""deepseek-v2-236b — MLA + fine-grained MoE [arXiv:2405.04434].

60L, d_model=5120, 128 heads with Multi-head Latent Attention (kv_lora=512,
decoupled RoPE dim 64, head_dim 128), vocab 102400.  MoE: 2 shared + 160
routed experts, top-6, expert d_ff=1536; the first layer uses a dense FFN
(d_ff=12288).  Adafactor states (1T-scale MoE training memory).

The port serves it whole: MLA in the absorbed form
(``models.attention``), the MoE FFN on one device or over ranks
(``models.moe``; ``serving.engine.ServingEngine(mesh=)``, whose decode layout
here is ``expert_tp``).
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # the single dense layer
        vocab_size=102400,
        stages=(
            StageSpec(kinds=("attn",), repeats=1, moe=(False,)),
            StageSpec(kinds=("attn",), repeats=59, moe=(True,)),
        ),
        kv_lora_rank=512,
        qk_rope_dim=64,
        moe_experts=160,
        moe_top_k=6,
        moe_shared_experts=2,
        moe_d_ff=1536,
        mlp_kind="swiglu",
        tie_embeddings=False,
        optimizer="adafactor",
        fsdp=True,
        layout_decode="expert_tp",
        source="arXiv:2405.04434 (hf)",
    )
)
