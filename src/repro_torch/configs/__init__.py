"""Architecture registry of the port: ``get_config(name)`` returns the full
config, ``reduced(cfg)`` the smoke-test variant.  Registered: the
architectures the port serves whole (``ALL_ARCHS``)."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    REGISTRY,
    StageSpec,
    get_config,
    reduced,
)

from repro_torch.configs import xlstm_350m  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
from repro_torch.configs import gemma2_9b  # noqa: F401
from repro_torch.configs import minitron_4b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import kimi_k2_1t  # noqa: F401
from repro_torch.configs import deepseek_v2_236b  # noqa: F401
from repro_torch.configs import jamba_52b  # noqa: F401

# the architectures served whole
ALL_ARCHS = [
    "xlstm-350m", "smollm-360m", "gemma2-9b", "minitron-4b", "starcoder2-3b", "kimi-k2-1t-a32b",
    "deepseek-v2-236b", "jamba-v0.1-52b",
]
