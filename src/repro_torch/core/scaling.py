"""Two-level block scaling and the type-in-sign scale byte (paper §2.1,
§B.3).  Counterpart of ``repro/core/scaling.py``.

Level 2: per-tensor (or per-row) f32 scale ``s32 = max|X| / 2688``.
Level 1: per-block E4M3 scale ``s8 = E4M3(blockmax / amax_target)``.
The E4M3 scale is positive, so its sign bit carries the block's format
type T (0 = E2M1, 1 = E1M2).
"""
from __future__ import annotations

import torch

from repro_torch.core import formats

__all__ = ["tensor_scale", "row_scale", "block_scale_e4m3",
           "pack_scale_with_type", "unpack_scale_and_type",
           "E4M3_MIN_SUBNORMAL"]

E4M3_MIN_SUBNORMAL = 2.0 ** -9


def _recip(denom: float) -> float:
    """The f32 reciprocal the reference multiplies by (never a divide)."""
    return float(torch.tensor(1.0 / denom, dtype=torch.float32))


def tensor_scale(x: torch.Tensor,
                 denom: float = formats.PER_TENSOR_DENOM) -> torch.Tensor:
    """Per-tensor f32 scale; an all-zero tensor gets scale 1."""
    amax = x.abs().max().to(torch.float32)
    return torch.where(amax > 0, amax * _recip(denom),
                       torch.ones_like(amax))


def row_scale(x: torch.Tensor,
              denom: float = formats.PER_TENSOR_DENOM) -> torch.Tensor:
    """Per-row f32 scale, shape (M,); all-zero rows get scale 1."""
    amax = x.abs().amax(dim=-1).to(torch.float32)
    return torch.where(amax > 0, amax * _recip(denom),
                       torch.ones_like(amax))


def block_scale_e4m3(block_absmax: torch.Tensor,
                     amax_target: float) -> torch.Tensor:
    """Per-block E4M3 scale, f32-valued.  A nonzero block whose scale
    rounds to 0 gets the smallest subnormal 2^-9; an all-zero block gets 1."""
    raw = block_absmax.to(torch.float32) * _recip(amax_target)
    s = formats.round_to_e4m3(raw.clamp(0.0, formats.E4M3_MAX))
    s = torch.where((block_absmax > 0) & (s <= 0),
                    torch.full_like(s, E4M3_MIN_SUBNORMAL), s)
    return torch.where(block_absmax > 0, s, torch.ones_like(s))


def pack_scale_with_type(scale_f32: torch.Tensor,
                         type_bits: torch.Tensor) -> torch.Tensor:
    """Scale byte = {T | e4m3[6:0]}.  A zero-magnitude scale never carries
    the type bit: the dead-block byte is 0x00, never 0x80."""
    mag = formats.e4m3_to_bits(scale_f32) & 0x7F
    t = (type_bits.to(torch.uint8) & 1) << 7
    return torch.where(mag == 0, mag, mag | t).to(torch.uint8)


def unpack_scale_and_type(packed: torch.Tensor):
    """Inverse of :func:`pack_scale_with_type` -> (f32 scale, uint8 T)."""
    t = (packed >> 7) & 1
    return formats.bits_to_e4m3(packed & 0x7F), t.to(torch.uint8)
