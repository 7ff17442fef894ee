"""StarCoder2-15B [arXiv:2402.19173]: dense, GQA + RoPE, GeLU MLP.

40L d_model=6144 48H (kv=4, head_dim=128) d_ff=24576 vocab=49152.  A kv
head serves a group of 12 query heads."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab=49152, mlp_type="gelu",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=256, mlp_type="gelu", attn_chunk=64,
    )
