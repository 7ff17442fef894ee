"""Model zoo of the port: the dense transformer family."""
from __future__ import annotations

from repro_torch.models.base import ArchConfig

__all__ = ["build_model"]


def build_model(cfg: ArchConfig):
    """The model implementing ``cfg.family`` (dense only so far)."""
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg)
