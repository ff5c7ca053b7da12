from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointStore,
    load_pytree,
    save_pytree,
)
