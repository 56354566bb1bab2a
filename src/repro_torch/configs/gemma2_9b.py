"""gemma2-9b — local+global alternating attention with logit softcaps
[arXiv:2408.00118].

42L, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336 (GeGLU),
vocab 256000.  Odd layers use sliding-window (4096) attention, even layers
global; attention logits soft-capped at 50, final logits at 30; pre+post
RMSNorm around each sub-block; embeddings scaled by sqrt(d_model) and tied.
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

CONFIG = register(
    ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        stages=(StageSpec(kinds=("attn_local", "attn_global"), repeats=21),),
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        mlp_kind="geglu",
        post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        optimizer="adamw",
        source="arXiv:2408.00118 (hf)",
    )
)
