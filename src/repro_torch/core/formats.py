"""FP4 micro-format codebooks and rounding primitives (paper §2.1, §3.1).

Counterpart of ``repro/core/formats.py``.  Magnitude codebooks:

  E2M1 (bias 1) : {0, 0.5, 1, 1.5, 2, 3, 4, 6}   — NVFP4 payload
  E1M2 (bias 0) : {0 .. 7} after the fixed x2 decode remap (== INT4)

Payload nibbles are ``[s | p2 p1 p0]``; for E1M2 the stored payload is the
integer level itself.  E4M3 block scales round through
``torch.float8_e4m3fn`` (round to nearest even).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "FP4Format", "E2M1", "E1M2",
    "quantize_to_codebook",
    "e2m1_encode", "e2m1_decode", "e1m2_encode", "e1m2_decode",
    "decode_to_e2m2",
    "E4M3_MAX", "PER_TENSOR_DENOM",
    "round_to_e4m3", "e4m3_to_bits", "bits_to_e4m3",
]

E4M3_MAX = 448.0
PER_TENSOR_DENOM = 2688.0  # = 6 * 448 = 7 * 384 (Algorithm 1, line 4)


@dataclass(frozen=True)
class FP4Format:
    """A 4-bit micro-format: magnitude codebook + AbsMax anchor value."""

    name: str
    levels: tuple
    amax_target: float

    def levels_tensor(self, device, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(self.levels, dtype=dtype, device=device)


E2M1 = FP4Format("e2m1", (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0), 6.0)
E1M2 = FP4Format("e1m2", (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0), 7.0)

_E2M1_DECODE = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
_E1M2_DECODE = (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)


def quantize_to_codebook(x: torch.Tensor, fmt: FP4Format) -> torch.Tensor:
    """Round |x| to the nearest level of ``fmt`` (ties to the even index),
    keep the sign, saturate at the top level."""
    levels = fmt.levels_tensor(x.device, x.dtype)
    mags = x.abs()
    mids = 0.5 * (levels[1:] + levels[:-1])
    idx = torch.searchsorted(mids, mags.contiguous(), right=False)
    lo = idx.clamp(0, 6)
    is_tie = mags == mids[lo]
    tie_up = (lo % 2) == 1
    idx = torch.where(is_tie & tie_up, lo + 1, idx).clamp(0, 7)
    return torch.sign(x) * levels[idx]


def e2m1_encode(values: torch.Tensor) -> torch.Tensor:
    """Signed values on the E2M1 lattice -> uint8 nibbles [s|p2p1p0]."""
    levels = torch.tensor(_E2M1_DECODE, dtype=values.dtype,
                          device=values.device)
    payload = (values.abs()[..., None] - levels).abs().argmin(-1)
    sign = (values < 0).to(torch.uint8)
    return (sign << 3) | payload.to(torch.uint8)


def e2m1_decode(nibbles: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    mags = torch.tensor(_E2M1_DECODE, dtype=dtype,
                        device=nibbles.device)[(nibbles & 0x7).long()]
    return torch.where(((nibbles >> 3) & 1) == 1, -mags, mags)


def e1m2_encode(values: torch.Tensor) -> torch.Tensor:
    """Signed values on the effective E1M2 lattice {0..7} -> nibbles."""
    payload = values.abs().round().clamp(0, 7).to(torch.uint8)
    sign = (values < 0).to(torch.uint8)
    return (sign << 3) | payload


def e1m2_decode(nibbles: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    mags = torch.tensor(_E1M2_DECODE, dtype=dtype,
                        device=nibbles.device)[(nibbles & 0x7).long()]
    return torch.where(((nibbles >> 3) & 1) == 1, -mags, mags)


def decode_to_e2m2(nibbles: torch.Tensor, type_bit: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Fig. 9 unified decoder: T=0 -> E2M1, T=1 -> E1M2 (x2 remap).
    ``type_bit`` broadcasts against ``nibbles``."""
    return torch.where(type_bit.to(torch.bool),
                       e1m2_decode(nibbles, dtype),
                       e2m1_decode(nibbles, dtype))


def round_to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest E4M3 value (RNE), returned as f32.  Callers
    clamp to [0, 448] first."""
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def e4m3_to_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 values (E4M3-representable) -> uint8 bit patterns."""
    return x.to(torch.float8_e4m3fn).view(torch.uint8)


def bits_to_e4m3(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bit patterns -> f32 values."""
    return bits.to(torch.uint8).contiguous().view(
        torch.float8_e4m3fn).to(torch.float32)
