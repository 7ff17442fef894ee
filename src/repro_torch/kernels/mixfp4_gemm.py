"""W4A16 GEMM over a packed MixFP4 weight:
y (M, N) f32 = bf16(x) (M, K) @ decode(W) * scale32.

Counterpart of ``repro/kernels/mixfp4_gemm.py :: mixfp4_gemm_w4a16``.
The weight is payload (K/2, NW) u8 with two K-adjacent nibbles per byte
(low nibble = even row) and scales (K/16, NW/16) u8, one per 16x16 tile;
NW may exceed the logical N (zero-padded storage).  ``mixfp4_gemm_w4a16``
launches ``csrc/mixfp4_gemm_w4a16.cu`` for CUDA tensors and runs
:func:`gemm_w4a16_plain` for CPU tensors.  Both decode value x block scale
to bf16 (exact: at most 7 significant bits), multiply with f32
accumulation, and apply scale32 to the f32 result.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["mixfp4_gemm_w4a16", "gemm_w4a16_plain", "decode_weight_bf16",
           "launches"]

_G = 16

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0


def _decode_nibbles(nib: torch.Tensor, t_full: torch.Tensor) -> torch.Tensor:
    """Fig. 9 decode (the reference's shift-path arithmetic)."""
    sign = 1.0 - 2.0 * ((nib >> 3) & 1).to(torch.float32)
    p = (nib & 0x7).to(torch.float32)
    e = torch.floor(p * 0.5)
    mbit = p - 2.0 * e
    v_e2m1 = torch.where(p < 2.0, 0.5 * mbit,
                         torch.exp2(e - 1.0) * (1.0 + 0.5 * mbit))
    return sign * torch.where(t_full.to(torch.bool), p, v_e2m1)


def decode_weight_bf16(payload: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """(K/2, NW) payload + (K/16, NW/16) scale bytes -> bf16 (K, NW) with
    the block scales fused (scale32 not applied)."""
    k2, nw = payload.shape
    nib = torch.stack([payload & 0xF, (payload >> 4) & 0xF], dim=1).reshape(
        2 * k2, nw)
    s = (scales & 0x7F).contiguous().view(torch.float8_e4m3fn).to(
        torch.float32)
    t = scales >> 7
    s_full = s.repeat_interleave(_G, 0).repeat_interleave(_G, 1)
    t_full = t.repeat_interleave(_G, 0).repeat_interleave(_G, 1)
    return (_decode_nibbles(nib, t_full) * s_full).to(torch.bfloat16)


def gemm_w4a16_plain(x: torch.Tensor, payload: torch.Tensor,
                     scales: torch.Tensor, scale32: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Plain PyTorch version: bf16 operands, f32 products and sums."""
    w = decode_weight_bf16(payload, scales)[:, :n_out]
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     w.to(torch.float32))
    return y * scale32.to(torch.float32)


def mixfp4_gemm_w4a16(x: torch.Tensor, payload: torch.Tensor,
                      scales: torch.Tensor, scale32: torch.Tensor, *,
                      n_out: int | None = None) -> torch.Tensor:
    """x (M, K) bf16/f32 with K = 2 * payload rows -> (M, n_out) f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    m, k = x.shape
    k2, nw = payload.shape
    n_out = nw if n_out is None else int(n_out)
    if k != 2 * k2 or k % _G or nw % _G or n_out > nw:
        raise ValueError(f"x K={k} vs payload {tuple(payload.shape)}, "
                         f"n_out={n_out}")
    if scales.shape != (k // _G, nw // _G):
        raise ValueError(f"scales {tuple(scales.shape)} vs payload "
                         f"{tuple(payload.shape)}")
    if payload.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise ValueError("payload and scales must be uint8")
    s32 = torch.as_tensor(scale32, dtype=torch.float32,
                          device=x.device).reshape(())
    if x.device.type == "cpu":
        return gemm_w4a16_plain(x, payload, scales, s32, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("payload", payload), ("scales", scales)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    xb = x.to(torch.bfloat16).contiguous()   # one RNE rounding, as the
    if xb.data_ptr() % 16:                   # reference does before its kernel
        xb = xb.clone()
    s32 = s32.contiguous()
    y = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    err = _lib().mixfp4_gemm_w4a16(
        xb.data_ptr(), payload.data_ptr(), scales.data_ptr(), s32.data_ptr(),
        y.data_ptr(), m, k, nw, n_out,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_gemm_w4a16 launch failed: cudaError {err}")
    launches += 1
    return y


def _lib():
    lib = build.load("mixfp4_gemm_w4a16")
    fn = lib.mixfp4_gemm_w4a16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
