"""Kernel entry points and their launch counts.

Counterpart of ``repro/kernels/ops.py``.  Each entry runs its CUDA kernel
for CUDA tensors and the kernel's plain PyTorch version for CPU tensors;
there is no fallback from one to the other.  Every kernel keeps a
plain-integer launch count on its module that its wrapper bumps once per
kernel launch (the CUDA path only) — the counterpart of
``count_dispatches``: :func:`reset_launch_counts` before a run and
:func:`launch_counts` after it show which kernels the run went through.
"""
from __future__ import annotations

from repro_torch.kernels import fwht, mixfp4_attn, mixfp4_gemm, mixfp4_quant

__all__ = ["quantize_rows", "pack_weight_qt", "gemm_w4a16", "gemm_w4a4",
           "gemm_w4a4_fused", "rht_rows", "attn_decode_packed",
           "launch_counts", "reset_launch_counts", "KERNELS"]

#: kernel name -> (module whose wrapper launches it, its count attribute)
KERNELS = {
    "mixfp4_quant_rows": (mixfp4_quant, "launches"),
    "mixfp4_gemm_w4a16": (mixfp4_gemm, "launches"),
    "mixfp4_attn_decode": (mixfp4_attn, "launches"),
    "mixfp4_gemm_w4a4": (mixfp4_gemm, "launches_w4a4"),
    "mixfp4_gemm_w4a4_fused": (mixfp4_gemm, "launches_w4a4_fused"),
    "fwht_rows": (fwht, "launches"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts():
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


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


def gemm_w4a4(xp, xs, xs32, payload, scales, scale32, *,
              per_row: bool = False, n_out=None):
    """Packed activation rows x packed weight (per-tensor or per-row
    activation scale)."""
    return mixfp4_gemm.mixfp4_gemm_w4a4(xp, xs, xs32, payload, scales,
                                        scale32, per_row=per_row,
                                        n_out=n_out)


def gemm_w4a4_fused(x, x_scale32, payload, scales, scale32, *,
                    per_row: bool = False, rht_signs=None, n_out=None):
    """Dense rows quantized in the GEMM's prologue (optionally after the
    grouped RHT) x packed weight: one launch per projection."""
    return mixfp4_gemm.mixfp4_gemm_w4a4_fused(
        x, x_scale32, payload, scales, scale32, per_row=per_row,
        rht_signs=rht_signs, n_out=n_out)


def rht_rows(x, signs, *, group: int = 16):
    """Grouped random Hadamard transform of (M, K) rows."""
    return fwht.fwht_rows(x, signs, group=group)


def attn_decode_packed(q, k_payload, k_scales, v_payload, v_scales,
                       lengths, **kw):
    return mixfp4_attn.mixfp4_attn_decode(q, k_payload, k_scales, v_payload,
                                          v_scales, lengths, **kw)
