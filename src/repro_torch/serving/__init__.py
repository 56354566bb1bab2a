from repro_torch.serving.engine import ModelRunner, Request, ServingEngine  # noqa: F401
from repro_torch.serving.farm import ChipFarm  # noqa: F401
from repro_torch.serving.kvcache import BlockCacheConfig, BlockKVCache  # noqa: F401
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: F401
