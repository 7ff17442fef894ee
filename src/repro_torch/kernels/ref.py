"""Plain-PyTorch oracles of the kernels, built from ``repro_torch.core``
(counterpart of ``repro/kernels/ref.py``).  They share no code with the
kernels' plain versions beyond the core numerics."""
from __future__ import annotations

import torch

from repro_torch.core import hadamard, qtensor
from repro_torch.core.qtensor import BlockLayout1D, BlockLayout2D, QuantSpec

__all__ = ["ref_quant_pack_rows", "ref_dequant_weight_kn", "ref_dequant_kv",
           "ref_gemm_w4a16", "ref_gemm_w4a4", "ref_attn_decode_packed",
           "ref_fwht_rows"]


def ref_quant_pack_rows(x: torch.Tensor, method: str = "mixfp4",
                        block: int = 16):
    """(M, K) -> (payload (M, K/2), scales (M, K/block), scale32) through
    ``qtensor.quantize`` with 1-D blocks along K."""
    if x.ndim != 2 or x.shape[1] % block:
        raise ValueError("expects (M, K) with K a multiple of the block")
    qt = qtensor.quantize(x, QuantSpec(method, BlockLayout1D(-1, block)))
    return qt.payload, qt.scales, qt.scale32


def ref_dequant_weight_kn(payload, scales, scale32,
                          block: tuple[int, int] = (16, 16)) -> torch.Tensor:
    qt = qtensor.QTensor(payload, scales,
                         torch.as_tensor(scale32, dtype=torch.float32),
                         method="mixfp4", layout=BlockLayout2D(*block),
                         shape=(payload.shape[0] * 2, payload.shape[1]))
    return qt.dequantize()


def ref_gemm_w4a16(x, payload, scales, scale32,
                   block: tuple[int, int] = (16, 16)) -> torch.Tensor:
    """bf16(x) @ bf16(dequantize(W)) with f32 accumulation."""
    w = ref_dequant_weight_kn(payload, scales, scale32, block)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.bfloat16).to(torch.float32))


def ref_gemm_w4a4(xp, xs, xs32, payload, scales, scale32,
                  block: tuple[int, int] = (16, 16),
                  act_block: int = 16) -> torch.Tensor:
    """Packed activation rows (scale32 ``xs32``, per tensor or (M,)) times
    the packed weight: the W4A16 oracle on the dequantized rows."""
    m, k = xp.shape[0], xp.shape[1] * 2
    qx = qtensor.QTensor(xp, xs, torch.as_tensor(xs32, dtype=torch.float32,
                                                 device=xp.device),
                         method="mixfp4", layout=BlockLayout1D(-1, act_block),
                         shape=(m, k), dtype="float32")
    return ref_gemm_w4a16(qx.dequantize(), payload, scales, scale32, block)


def ref_dequant_kv(payload, scales, scale32=1.0) -> torch.Tensor:
    return qtensor.from_packed_rows(payload, scales, scale32).dequantize()


def ref_attn_decode_packed(q, k_payload, k_scales, v_payload, v_scales,
                           lengths, *, window: int = 0, k_scale32=1.0,
                           v_scale32=1.0, softcap: float = 0.0
                           ) -> torch.Tensor:
    """Dequantize the cache and run masked softmax . V in f32 (query at
    position ``lengths - 1``)."""
    b, h, dh = q.shape
    s, hkv = k_payload.shape[1:3]
    g = h // hkv
    k = ref_dequant_kv(k_payload, k_scales, k_scale32)
    v = ref_dequant_kv(v_payload, v_scales, v_scale32)
    qr = q.to(torch.float32).reshape(b, hkv, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k) * (dh ** -0.5)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    kv_len = torch.as_tensor(lengths, dtype=torch.int64,
                             device=q.device).expand(b)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < kv_len[:, None]
    if window:
        mask &= kpos[None, :] > (kv_len - 1 - window)[:, None]
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(scores, dim=-1), v)
    return o.reshape(b, h, dh)


def ref_fwht_rows(x: torch.Tensor, signs, group: int = 16) -> torch.Tensor:
    """Grouped RHT along the last axis (rows independent)."""
    return hadamard.rht(x, signs, dim=-1, group=group)
