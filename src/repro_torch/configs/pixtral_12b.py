"""pixtral-12b — Pixtral-ViT frontend + Mistral-Nemo backbone
[hf:mistralai/Pixtral-12B-2409, unverified].

Backbone only (the ViT frontend is a stub; ``input_specs`` feeds precomputed
patch embeddings): 40L, d_model=5120, 32 heads (GQA kv=8, head_dim=128),
d_ff=14336 (SwiGLU), vocab 131072.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1e6,
        mlp_kind="swiglu",
        frontend="embed",
        tie_embeddings=False,
        optimizer="adamw",
        source="hf:mistralai/Pixtral-12B-2409 (unverified)",
    )
)
