"""H2O-Danube3-4B [arXiv:2401.16818]: llama + mistral mix with sliding
window attention.

24L d_model=3840 32H (kv=8, head_dim=120) d_ff=10240 vocab=32000,
sliding window 4096 on every layer.  head_dim 120 is no multiple of the
16-value MixFP4 block, so the full config serves the bf16 KV cache only."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
        d_ff=10240, vocab=32000, window=4096,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=8, attn_chunk=64,
    )
