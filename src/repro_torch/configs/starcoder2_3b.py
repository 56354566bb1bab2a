"""starcoder2-3b — GQA + RoPE code model [arXiv:2402.19173].

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288 (GELU MLP), vocab 49152,
tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        mlp_kind="gelu",
        tie_embeddings=True,
        optimizer="adamw",
        source="arXiv:2402.19173 (hf)",
    )
)
