"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (kv=4, head_dim=128) d_ff=768/expert, 128 experts
top-8, QK-norm, vocab 151936.  The smoke config pads its 8 experts to 16
(dummy experts 8-15 are zero and receive no tokens).

Copied field for field from ``src/repro/configs/qwen3_moe_30b_a3b.py``
(``config`` :8-15, ``smoke_config`` :18-25)."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936, rope_theta=1_000_000.0, qk_norm=True,
        n_experts=128, top_k=8, d_ff_expert=768,
        ep_mode="expert",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256, qk_norm=True,
        n_experts=8, top_k=2, d_ff_expert=96,
        ep_mode="expert", attn_chunk=64,
    )
