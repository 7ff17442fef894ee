"""The paper's 476M Qwen3-style pretraining model (§4.2, Fig. 11).

hidden 1024, 16 query heads, 4 kv heads, intermediate 4096, 18 layers."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixfp4-476m", family="dense",
        n_layers=18, d_model=1024, n_heads=16, n_kv_heads=4,
        d_ff=4096, vocab=151936, qk_norm=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mixfp4-476m-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qk_norm=True, attn_chunk=64,
    )
