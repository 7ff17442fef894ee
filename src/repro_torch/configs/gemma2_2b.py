"""Gemma-2-2B [arXiv:2408.00118].

26L d_model=2304 8H (kv=4, head_dim=256) d_ff=9216 vocab=256000.
Local (window 4096) / global alternating attention, attention softcap 50,
final logit softcap 30, GeGLU, sqrt(d) embedding scaling."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000, mlp_type="geglu",
        window=4096, local_global_period=2,
        softcap_attn=50.0, softcap_final=30.0, emb_scale=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="geglu",
        window=8, local_global_period=2,
        softcap_attn=50.0, softcap_final=30.0, emb_scale=True,
        attn_chunk=64,
    )
