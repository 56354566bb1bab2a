from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    PROGRAMMED_SLOTS,
    active_slot,
    restore_programmed,
    save_programmed,
    swap_active,
)
