from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    PROGRAMMED_SLOTS,
    active_slot,
    latest_step,
    restore_checkpoint,
    restore_programmed,
    save_checkpoint,
    save_programmed,
    swap_active,
)
