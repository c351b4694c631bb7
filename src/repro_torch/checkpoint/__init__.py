"""Sharded ``.npy`` + JSON-manifest checkpoints, in the format of
:mod:`repro.checkpoint`, so either package restores the other's."""
from repro_torch.checkpoint.checkpoint import (
    ELASTIC,
    CheckpointManager,
    CorruptCheckpointError,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "CorruptCheckpointError", "ELASTIC",
           "save_checkpoint", "load_checkpoint"]
