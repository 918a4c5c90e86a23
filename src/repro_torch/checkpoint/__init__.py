from .checkpoint import (  # noqa: F401
    committed_steps,
    latest_step,
    load_checkpoint,
    load_checkpoint_items,
    save_checkpoint,
    wait_for_writes,
)
