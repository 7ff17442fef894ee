"""Bit-exact packed storage of 1-D blocks (Fig. 1 wire format).
Counterpart of ``repro/core/pack.py``.

Per block of 16 values: 16 nibbles packed two per byte (low nibble = even
index), one scale byte {T | e4m3[6:0]}, plus one f32 per-tensor scale —
4.5 bits/value.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats, scaling
from repro_torch.core.quantize import BlockQuantized

__all__ = ["PackedMixFP4", "pack_blocks", "unpack_blocks"]


class PackedMixFP4(NamedTuple):
    payload: torch.Tensor   # (..., nblocks, g//2) uint8
    scales: torch.Tensor    # (..., nblocks) uint8
    scale32: torch.Tensor   # () f32


def pack_blocks(bq: BlockQuantized) -> PackedMixFP4:
    t = bq.type_bits[..., None].to(torch.bool)
    nib = torch.where(t, formats.e1m2_encode(bq.values),
                      formats.e2m1_encode(bq.values))
    payload = (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)
    scales = scaling.pack_scale_with_type(bq.scale8, bq.type_bits)
    return PackedMixFP4(payload, scales, bq.scale32.to(torch.float32))


def unpack_blocks(p: PackedMixFP4, dtype=torch.float32) -> torch.Tensor:
    """Fig. 9 decode plus both scales -> (..., nblocks, g)."""
    lo = p.payload & 0xF
    hi = (p.payload >> 4) & 0xF
    nib = torch.stack([lo, hi], dim=-1).reshape(*p.payload.shape[:-1], -1)
    s8, t = scaling.unpack_scale_and_type(p.scales)
    vals = formats.decode_to_e2m2(nib, t[..., None])
    return (vals * s8[..., None] * p.scale32).to(dtype)
