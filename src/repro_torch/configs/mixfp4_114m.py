"""The paper's 114M Qwen3-style pretraining model (§4.2, Fig. 10).

hidden 512, 8 query heads, 4 kv heads, intermediate 2048, 9 layers,
QK-norm, RoPE, SwiGLU."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixfp4-114m", family="dense",
        n_layers=9, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab=151936, qk_norm=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mixfp4-114m-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qk_norm=True, attn_chunk=64,
    )
