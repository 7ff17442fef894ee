"""Block-scaled adaptive quantization — Algorithm 1 (MixFP4) and NVFP4,
round-to-nearest-even.  Counterpart of ``repro/core/quantize.py``.

Per block (16 values along the GEMM reduction axis, or a 16x16 weight
tile) each candidate format is evaluated under its own E4M3 scale
(blockmax / amax_target) and the lowest-MSE candidate wins; the winning
index is the type bit T.  Stochastic rounding belongs to the training
slice and is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import formats, scaling
from repro_torch.core.formats import FP4Format

__all__ = ["METHODS", "BlockQuantized", "method_candidates",
           "adaptive_block_quantize", "block_quantize_1d",
           "block_quantize_2d"]

METHODS: dict[str, tuple[FP4Format, ...]] = {
    "nvfp4": (formats.E2M1,),
    "mixfp4": (formats.E2M1, formats.E1M2),
}


def method_candidates(method: str) -> tuple[FP4Format, ...]:
    try:
        return METHODS[method]
    except KeyError:
        raise ValueError(f"unknown quantization method {method!r}; "
                         f"one of {sorted(METHODS)}") from None


class BlockQuantized(NamedTuple):
    """values (..., nblocks, g) on the lattice; scale8 (..., nblocks) f32;
    scale32 () f32; type_bits (..., nblocks) uint8."""

    values: torch.Tensor
    scale8: torch.Tensor
    scale32: torch.Tensor
    type_bits: torch.Tensor


def adaptive_block_quantize(xb: torch.Tensor,
                            candidates: Sequence[FP4Format], *,
                            scale32: torch.Tensor | None = None
                            ) -> BlockQuantized:
    """Algorithm 1 (RNE) on pre-blocked data ``xb`` of shape
    (..., nblocks, g)."""
    xb = xb.to(torch.float32)
    if scale32 is None:
        scale32 = scaling.tensor_scale(xb)
    xs = xb * (1.0 / scale32)
    absmax = xs.abs().amax(dim=-1)
    qs, s8s, errs = [], [], []
    for fmt in candidates:
        s8 = scaling.block_scale_e4m3(absmax, fmt.amax_target)
        q = formats.quantize_to_codebook(xs * (1.0 / s8)[..., None], fmt)
        errs.append((q * s8[..., None] - xs).square().mean(dim=-1))
        qs.append(q)
        s8s.append(s8)
    if len(candidates) == 1:
        return BlockQuantized(qs[0], s8s[0], scale32,
                              torch.zeros_like(absmax, dtype=torch.uint8))
    # argmin with ties to the lowest index (E2M1 first)
    sel = torch.zeros_like(absmax, dtype=torch.long)
    best = errs[0]
    for i in range(1, len(candidates)):
        better = errs[i] < best
        sel = torch.where(better, torch.full_like(sel, i), sel)
        best = torch.where(better, errs[i], best)
    q_sel = torch.stack(qs).gather(
        0, sel[None, ..., None].expand(1, *qs[0].shape))[0]
    s8_sel = torch.stack(s8s).gather(0, sel[None])[0]
    return BlockQuantized(q_sel, s8_sel, scale32, sel.to(torch.uint8))


def block_quantize_1d(x: torch.Tensor, method: str, *, block: int = 16,
                      axis: int = -1):
    """1-D blocks of ``block`` along ``axis`` (zero-padded).  Returns
    (BlockQuantized, original axis length, axis)."""
    candidates = method_candidates(method)
    s32 = scaling.tensor_scale(x)
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    pad = (-n) % block
    if pad:
        xm = F.pad(xm, (0, pad))
    xb = xm.reshape(*xm.shape[:-1], xm.shape[-1] // block, block)
    return adaptive_block_quantize(xb, candidates, scale32=s32), n, axis


def _to_blocks_2d(w: torch.Tensor, bm: int, bn: int):
    m, n = w.shape
    pm, pn = (-m) % bm, (-n) % bn
    if pm or pn:
        w = F.pad(w, (0, pn, 0, pm))
    gm, gn = w.shape[0] // bm, w.shape[1] // bn
    t = w.reshape(gm, bm, gn, bn).permute(0, 2, 1, 3)
    return t.reshape(gm, gn, bm * bn), (m, n)


def block_quantize_2d(w: torch.Tensor, method: str, *,
                      block: tuple[int, int] = (16, 16)):
    """(bm x bn) tiles sharing one scale and type bit (weights, Fig. 7).
    Returns (BlockQuantized over (gm, gn, bm*bn), logical shape, block)."""
    if w.ndim != 2:
        raise ValueError("block_quantize_2d expects a matrix")
    candidates = method_candidates(method)
    bm, bn = block
    s32 = scaling.tensor_scale(w)
    tb, shape = _to_blocks_2d(w, bm, bn)
    return (adaptive_block_quantize(tb, candidates, scale32=s32),
            shape, block)
