"""One-token decode attention over the packed MixFP4 KV cache.

Counterpart of ``repro/kernels/mixfp4_attn.py :: mixfp4_attn_decode``.
Layout (the JAX package's):

  q           (B, H, dh)          bf16/f32 — the RoPE'd decode query
  k/v payload (B, S, Hkv, dh/2)   uint8
  k/v scales  (B, S, Hkv, dh/16)  uint8
  lengths     (B,)                int32 — valid rows, the current one included

GQA groups the H query heads per kv head (head h reads kv head h // g).
Masks are the reference's: ``kpos < len`` and, for ``window > 0``,
``kpos > len - 1 - window``; softcap ``c * tanh(s / c)`` after the
dh^-0.5 scale.  ``mixfp4_attn_decode`` launches
``csrc/mixfp4_attn_decode.cu`` for CUDA tensors and runs
:func:`attn_decode_plain` for CPU tensors.  Returns (B, H, dh) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["mixfp4_attn_decode", "attn_decode_plain", "dequant_kv",
           "launches"]

_G = 16
_NEG_INF = -1e30

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0


def dequant_kv(payload: torch.Tensor, scales: torch.Tensor,
               scale32) -> torch.Tensor:
    """Packed rows (..., dh/2) + (..., dh/16) -> f32 (..., dh)."""
    from repro_torch.core import qtensor  # deferred: kernels below core
    return qtensor.from_packed_rows(payload, scales, scale32).dequantize()


def attn_decode_plain(q, k_payload, k_scales, v_payload, v_scales, lengths,
                      *, window: int = 0, k_scale32=1.0, v_scale32=1.0,
                      softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: dequantize the cache, masked softmax . V."""
    b, h, dh = q.shape
    s, hkv = k_payload.shape[1:3]
    g = h // hkv
    k = dequant_kv(k_payload, k_scales, k_scale32)
    v = dequant_kv(v_payload, v_scales, v_scale32)
    qr = q.to(torch.float32).reshape(b, hkv, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k) * (dh ** -0.5)
    if softcap:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    kv_len = torch.as_tensor(lengths, dtype=torch.int32,
                             device=q.device).expand(b)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < kv_len[:, None]
    if window > 0:
        mask &= kpos[None, :] > (kv_len - 1 - window)[:, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask[:, None, None], p, torch.zeros_like(p))
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(b, h, dh)


def mixfp4_attn_decode(q, k_payload, k_scales, v_payload, v_scales, lengths,
                       *, window: int = 0, k_scale32=1.0, v_scale32=1.0,
                       softcap: float = 0.0) -> torch.Tensor:
    """Decode attention -> (B, H, dh) f32.  CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    global launches
    b, h, dh = q.shape
    s, hkv, dh2 = k_payload.shape[1:]
    if dh != 2 * dh2 or dh % _G or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} vs packed K "
                         f"{tuple(k_payload.shape)}")
    for name, t, last in (("k_payload", k_payload, dh2),
                          ("v_payload", v_payload, dh2),
                          ("k_scales", k_scales, dh // _G),
                          ("v_scales", v_scales, dh // _G)):
        if tuple(t.shape) != (b, s, hkv, last) or t.dtype != torch.uint8:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{(b, s, hkv, last)} uint8")
    window = int(window)
    if q.device.type == "cpu":
        return attn_decode_plain(q, k_payload, k_scales, v_payload, v_scales,
                                 lengths, window=window, k_scale32=k_scale32,
                                 v_scale32=v_scale32, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if dh > 256 or h // hkv > 8:
        raise ValueError(f"kernel supports dh <= 256 and H/Hkv <= 8, got "
                         f"dh={dh}, H/Hkv={h // hkv}")
    for name, t in (("k_payload", k_payload), ("k_scales", k_scales),
                    ("v_payload", v_payload), ("v_scales", v_scales)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    qf = q.to(torch.float32).contiguous()
    lens = torch.as_tensor(lengths, dtype=torch.int32,
                           device=q.device).expand(b).contiguous()
    s32 = torch.stack([
        torch.as_tensor(k_scale32, dtype=torch.float32,
                        device=q.device).reshape(()),
        torch.as_tensor(v_scale32, dtype=torch.float32,
                        device=q.device).reshape(())])
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.float32))
    inv_cap = float(torch.tensor(1.0 / softcap if softcap else 0.0,
                                 dtype=torch.float32))
    err = _lib().mixfp4_attn_decode(
        qf.data_ptr(), k_payload.data_ptr(), k_scales.data_ptr(),
        v_payload.data_ptr(), v_scales.data_ptr(), lens.data_ptr(),
        s32.data_ptr(), out.data_ptr(), b, s, h, hkv, dh, window, scale,
        float(softcap), inv_cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_attn_decode launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def _lib():
    lib = build.load("mixfp4_attn_decode")
    fn = lib.mixfp4_attn_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
