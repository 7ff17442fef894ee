"""Kernel entry points and their launch counts.

Counterpart of ``repro/kernels/ops.py``.  Each entry runs its CUDA kernel
for CUDA tensors and the kernel's plain PyTorch version for CPU tensors;
there is no fallback from one to the other.  Every kernel module keeps a
plain-integer ``launches`` count that its wrapper bumps once per kernel
launch (the CUDA path only) — the counterpart of ``count_dispatches``:
:func:`reset_launch_counts` before a run and :func:`launch_counts` after
it show which kernels the run went through.
"""
from __future__ import annotations

from repro_torch.kernels import mixfp4_attn, mixfp4_gemm, mixfp4_quant

__all__ = ["quantize_rows", "pack_weight_qt", "gemm_w4a16",
           "attn_decode_packed", "launch_counts", "reset_launch_counts",
           "KERNELS"]

#: kernel name -> the module whose wrapper launches it
KERNELS = {
    "mixfp4_quant_rows": mixfp4_quant,
    "mixfp4_gemm_w4a16": mixfp4_gemm,
    "mixfp4_attn_decode": mixfp4_attn,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts():
    for mod in KERNELS.values():
        mod.launches = 0


def quantize_rows(x, *, scale32=None, per_row: bool = False):
    """MixFP4 row quantizer -> (payload, scales, scale32).  ``scale32``
    pins the level-2 scale (the packed KV cache pins one shared value so
    rows written at different steps agree)."""
    return mixfp4_quant.mixfp4_quant_rows(x, scale32=scale32,
                                          per_row=per_row)


def pack_weight_qt(w, method: str = "mixfp4",
                   block: tuple[int, int] = (16, 16)):
    """Quantize and pack a (K, N) weight into a 2-D-tiled QTensor."""
    from repro_torch.core import qtensor  # deferred: core imports kernels
    return qtensor.quantize(
        w, qtensor.QuantSpec(method, qtensor.BlockLayout2D(*block)))


def gemm_w4a16(x, payload, scales, scale32, *, n_out=None):
    return mixfp4_gemm.mixfp4_gemm_w4a16(x, payload, scales, scale32,
                                         n_out=n_out)


def attn_decode_packed(q, k_payload, k_scales, v_payload, v_scales,
                       lengths, **kw):
    return mixfp4_attn.mixfp4_attn_decode(q, k_payload, k_scales, v_payload,
                                          v_scales, lengths, **kw)
