"""Phi-3-medium-14B [arXiv:2404.14219]: dense, RoPE + SwiGLU + GQA.

40L d_model=5120 40H (kv=10, head_dim=128) d_ff=17920 vocab=100352."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab=100352,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi3-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=5, head_dim=16,
        d_ff=160, vocab=256, attn_chunk=64,
    )
