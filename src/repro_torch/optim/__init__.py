from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    adafactor,
    sgd,
    make_optimizer,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_with_warmup,
    linear_warmup,
)
