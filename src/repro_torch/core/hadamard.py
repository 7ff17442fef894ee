"""Fast Walsh-Hadamard transform and the grouped random Hadamard transform
(RHT).  Counterpart of ``repro/core/hadamard.py``.

The RHT splits an axis into groups of ``group`` elements (a power of two,
the quantization block by default) and hits each with sign-randomized
H_g / sqrt(g).  It is orthogonal, so ``(H D x) . (H D w) = x . w`` for the
same D and H on both GEMM operands: it changes only the quantization
statistics.  ``serve_signs`` is the deterministic diagonal of serve-time
W4A4 (weights rotated at pack time, activations before the quantizer);
it is host numpy, carried over verbatim, so it is bitwise the
reference's.  ``rht_signs`` (a random draw for training) is not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["fwht", "rht", "serve_signs"]


def fwht(x: torch.Tensor, *, dim: int = -1,
         normalize: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along ``dim`` (length 2^k): the
    reference's butterfly, stage for stage."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    if normalize:
        x = x * (n ** -0.5)
    return x.movedim(-1, dim)


@functools.lru_cache(maxsize=None)
def _serve_signs_np(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng((seed << 32) | n)
    return np.where(rng.integers(0, 2, n) > 0, 1.0, -1.0).astype(np.float32)


def serve_signs(n: int, seed: int = 0x5147) -> np.ndarray:
    """Deterministic +-1 diagonal (n,) f32 of the serve-time RHT: a pure
    function of ``n`` (and ``seed``), so the weight packer and ``qlinear``
    rebuild the same D without threading state.  A read-only numpy array;
    callers copy it onto their device."""
    return _serve_signs_np(int(n), int(seed))


def rht(x: torch.Tensor, signs, *, dim: int = -1,
        group: int = 16) -> torch.Tensor:
    """Grouped random Hadamard transform along ``dim``; ``signs`` (len,)
    must be the same on both GEMM operands for it to cancel."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n % group:
        raise ValueError(f"axis length {n} not divisible by RHT group "
                         f"{group}")
    if not isinstance(signs, torch.Tensor):
        signs = torch.from_numpy(np.asarray(signs))
    x = x * signs.to(device=x.device, dtype=x.dtype)
    xg = fwht(x.reshape(*x.shape[:-1], n // group, group))
    return xg.reshape(x.shape).movedim(-1, dim)
