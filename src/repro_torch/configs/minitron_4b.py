"""minitron-4b — pruned Nemotron [arXiv:2407.14679].

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216 with squared-ReLU MLP
(Nemotron family), vocab 256000, untied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab_size=256000,
        mlp_kind="relu2",
        tie_embeddings=False,
        optimizer="adamw",
        source="arXiv:2407.14679 (hf)",
    )
)
