"""musicgen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  Backbone only: 48L, d_model=2048, 32 heads (MHA),
d_ff=8192, vocab=2048 (one EnCodec codebook head).  The EnCodec frontend is a
stub per the assignment: ``input_specs`` feeds precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_kind="gelu",
        frontend="embed",
        tie_embeddings=False,
        optimizer="adamw",
        source="arXiv:2306.05284 (hf)",
    )
)
