"""MixFP4 row quantizer (Algorithm 1): (M, K) f32 -> payload (M, K/2) u8,
scales (M, K/16) u8 under a per-tensor, per-row or pinned ``scale32``.

Counterpart of ``repro/kernels/mixfp4_quant.py``.  ``mixfp4_quant_rows``
launches ``csrc/mixfp4_quant.cu`` for CUDA tensors and runs
:func:`quant_rows_plain` — the same arithmetic in plain PyTorch — for CPU
tensors.  Both are byte-exact with the reference: reciprocal multiplies,
round-half-even, E4M3 by RNE after a [0, 448] clamp, and one fixed
summation order for the per-block MSE (adjacent pairs, 16 -> 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import scaling
from repro_torch.kernels import build

__all__ = ["mixfp4_quant_rows", "quant_rows_plain", "quant_block_math",
           "derive_scale32", "launches"]

_G = 16
_R6 = float(torch.tensor(1.0 / 6.0, dtype=torch.float32))
_R7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0


def _e4m3_rne(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


def _rne_e2m1(a: torch.Tensor) -> torch.Tensor:
    a = a.clamp(0.0, 6.0)
    lo = torch.round(a * 2.0) * 0.5
    mid = torch.round(a)
    hi = torch.round(a * 0.5) * 2.0
    return torch.where(a < 2.0, lo, torch.where(a < 4.0, mid, hi))


def _tree_sum16(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (16) as adjacent pairs: 16 -> 8 -> 4 -> 2 -> 1
    (the kernel's order)."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _guard(s: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    s = torch.where((absmax > 0) & (s <= 0), torch.full_like(s, 2.0 ** -9), s)
    return torch.where(absmax > 0, s, torch.ones_like(s))


def quant_block_math(xs: torch.Tensor):
    """Per-block math on xs (..., nb, 16) already divided by scale32.
    Returns (values on the lattice, f32 scale8, uint8 type bits)."""
    absmax = xs.abs().amax(dim=-1)
    s2 = _guard(_e4m3_rne(absmax * _R6), absmax)
    y2 = xs * (1.0 / s2)[..., None]
    q2 = torch.sign(y2) * _rne_e2m1(y2.abs())
    err2 = _tree_sum16((q2 * s2[..., None] - xs).square()) * 0.0625
    s1 = _guard(_e4m3_rne(absmax * _R7), absmax)
    y1 = xs * (1.0 / s1)[..., None]
    q1 = torch.sign(y1) * torch.round(y1.abs()).clamp(0.0, 7.0)
    err1 = _tree_sum16((q1 * s1[..., None] - xs).square()) * 0.0625
    t = err1 < err2                                   # ties -> E2M1
    q = torch.where(t[..., None], q1, q2)
    s8 = torch.where(t, s1, s2)
    return q, s8, t.to(torch.uint8)


def _encode_nibbles(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    sign = (q < 0).to(torch.uint8) << 3
    a = q.abs()
    idx2 = torch.where(a < 2.0, a * 2.0,
                       torch.where(a < 6.0, a + 2.0, torch.full_like(a, 7.0)))
    idx = torch.where(t[..., None].to(torch.bool), a, idx2)
    return sign | idx.to(torch.uint8)


def _pack_scale(s8: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    mag = s8.to(torch.float8_e4m3fn).view(torch.uint8) & 0x7F
    return torch.where(mag == 0, mag, mag | (t << 7)).to(torch.uint8)


def quant_rows_plain(x: torch.Tensor, s32_rows: torch.Tensor):
    """Plain PyTorch version of the kernel: x (M, K) f32, s32_rows (M, 1)
    f32 -> (payload (M, K/2) u8, scales (M, K/16) u8)."""
    m, k = x.shape
    xs = (x * (1.0 / s32_rows)).reshape(m, k // _G, _G)
    q, s8, t = quant_block_math(xs)
    nib = _encode_nibbles(q, t).reshape(m, k)
    payload = (nib[:, 0::2] | (nib[:, 1::2] << 4)).to(torch.uint8)
    return payload, _pack_scale(s8, t)


def derive_scale32(x: torch.Tensor, scale32=None, per_row: bool = False):
    """The level-2 scale as the reference derives it: max|x| * (1/2688)
    (per tensor, or per row), 1 for all-zero data; or the pinned value."""
    if scale32 is not None:
        s = torch.as_tensor(scale32, dtype=torch.float32, device=x.device)
        return s.reshape(-1).expand(x.shape[0]) if per_row else s.reshape(())
    return scaling.row_scale(x) if per_row else scaling.tensor_scale(x)


def mixfp4_quant_rows(x: torch.Tensor, *, scale32=None,
                      per_row: bool = False):
    """Quantize (M, K) f32 rows with g=16 blocks along K.  Returns
    (payload (M, K/2) u8, scales (M, K/16) u8, scale32 — () or (M,) f32).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"expected (M, K) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    m, k = x.shape
    if k % _G:
        raise ValueError(f"K={k} must be a multiple of {_G}")
    s32 = derive_scale32(x, scale32, per_row)
    if x.device.type == "cpu":
        rows = s32.reshape(-1, 1).expand(m, 1)
        payload, scales = quant_rows_plain(x, rows)
        return payload, scales, s32
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    s32_dev = s32.contiguous()
    payload = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, k // _G), dtype=torch.uint8, device=x.device)
    lib = _lib()
    err = lib.mixfp4_quant_rows(
        x.data_ptr(), s32_dev.data_ptr(), int(per_row), payload.data_ptr(),
        scales.data_ptr(), m, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_quant_rows launch failed: cudaError {err}")
    launches += 1
    return payload, scales, s32


def _lib():
    lib = build.load("mixfp4_quant")
    fn = lib.mixfp4_quant_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
