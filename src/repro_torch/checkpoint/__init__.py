"""Checkpoint store of the port (counterpart: ``src/repro/checkpoint/``)."""
from repro_torch.checkpoint.store import (
    ARTIFACT_STEP,
    atomic_write_json,
    atomic_write_text,
    latest_step,
    load_artifact,
    load_metadata,
    prune_checkpoints,
    restore_checkpoint,
    restore_with_metadata,
    save_artifact,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "restore_with_metadata",
    "load_metadata", "latest_step", "prune_checkpoints",
    "save_artifact", "load_artifact", "ARTIFACT_STEP",
    "atomic_write_text", "atomic_write_json",
]
