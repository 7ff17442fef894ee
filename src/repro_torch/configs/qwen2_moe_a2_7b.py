"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) d_ff=1408/expert, 60 routed experts top-4 +
4 shared experts (shared intermediate 4*1408=5632), vocab 151936.  The
stack is stored at 64 experts (``ep_mode="expert"`` pads to 16s; the four
dummy experts are zero and receive no tokens).

Copied field for field from ``src/repro/configs/qwen2_moe_a2_7b.py``
(``config`` :11-18, ``smoke_config`` :21-28)."""
from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936, rope_theta=1_000_000.0,
        n_experts=60, top_k=4, d_ff_expert=1408, shared_expert_ff=5632,
        ep_mode="expert",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=256,
        n_experts=6, top_k=2, d_ff_expert=96, shared_expert_ff=128,
        ep_mode="ffn", attn_chunk=64,
    )
