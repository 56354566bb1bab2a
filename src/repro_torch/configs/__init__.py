"""Architecture registry of the port: ``get_config(name)`` returns the full
config, ``reduced(cfg)`` the smoke-test variant.  ``ALL_ARCHS`` lists the
reference's ten architectures, in its order: every one runs through the
port's model entry points.  The two embedding front ends (musicgen-large,
pixtral-12b) take precomputed frame / patch embeddings; they train and
serve through ``forward`` / ``prefill`` / ``decode_step``, and the serving
engine programs their chips but refuses their requests, as the
reference's engine fails on them."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    REGISTRY,
    StageSpec,
    get_config,
    reduced,
)

from repro_torch.configs import xlstm_350m  # noqa: F401
from repro_torch.configs import musicgen_large  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
from repro_torch.configs import gemma2_9b  # noqa: F401
from repro_torch.configs import minitron_4b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import deepseek_v2_236b  # noqa: F401
from repro_torch.configs import kimi_k2_1t  # noqa: F401
from repro_torch.configs import pixtral_12b  # noqa: F401
from repro_torch.configs import jamba_52b  # noqa: F401

ALL_ARCHS = [
    "xlstm-350m",
    "musicgen-large",
    "smollm-360m",
    "gemma2-9b",
    "minitron-4b",
    "starcoder2-3b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "pixtral-12b",
    "jamba-v0.1-52b",
]
