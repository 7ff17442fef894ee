"""Packed checkpoints, in the reference's format (``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
