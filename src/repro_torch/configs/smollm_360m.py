"""smollm-360m — llama-architecture small model [hf:HuggingFaceTB/SmolLM].

32L, d_model=960, 15 heads with GQA kv=5, d_ff=2560 (SwiGLU), vocab 49152,
tied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        mlp_kind="swiglu",
        tie_embeddings=True,
        optimizer="adamw",
        source="hf:HuggingFaceTB/SmolLM-360M",
    )
)
