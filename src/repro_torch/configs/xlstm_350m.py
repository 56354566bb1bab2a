"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L, d_model=1024, 4 heads (kv=4), d_ff=0 (xLSTM blocks carry their own
up/down projections and gates; no separate FFN), vocab 50304.  Blocks
alternate mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
strictly recurrent) in 1:1 ratio.
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

CONFIG = register(
    ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        stages=(StageSpec(kinds=("mlstm", "slstm"), repeats=12),),
        xlstm_d_inner=2048,
        tie_embeddings=True,
        optimizer="adamw",
        layout="pure_dp",
        source="arXiv:2405.04517 (unverified)",
    )
)
