"""Grouped random Hadamard transform of f32 rows: a +-1 sign flip, then a
Walsh-Hadamard butterfly inside each group of ``group`` lanes, times
group^-1/2.

Counterpart of ``repro/kernels/fwht.py :: fwht_rows``.  ``fwht_rows``
launches ``csrc/fwht_rows.cu`` for CUDA tensors and runs
:func:`fwht_rows_math` — the reference's body, stage for stage — for CPU
tensors.  Every step is an elementwise f32 multiply, add or subtract, so
the kernel (built without multiply-add contraction) is bitwise equal to
the plain version; the W4A4 per-row scale and the dual-format select
downstream read these bits.

``fwht_row_scale`` is that per-row scale in one launch, from the same
kernel source: ``scaling.row_scale(fwht_rows_math(x, signs, 16))``, the
reference's spelling in ``qmm``'s per-row branch, without writing the
transformed (M, K) matrix.  Its plain version, :func:`row_scale_plain`, is
that composition.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats, scaling
from repro_torch.kernels import build, tuning

__all__ = ["fwht_rows", "fwht_rows_math", "fwht_row_scale",
           "row_scale_plain", "launches", "launches_row_scale",
           "KERNEL_GROUPS", "RHT_GROUP"]

#: transform groups the CUDA kernel is instantiated for
KERNEL_GROUPS = (4, 8, 16, 32, 64)

#: the serve-time RHT group, the only one the row scale takes
RHT_GROUP = 16
# the f32 values the plain row scale multiplies by: RHT_GROUP ** -0.5 and
# 1 / 2688 (python float -> f32)
_NORM = float(torch.tensor(RHT_GROUP ** -0.5, dtype=torch.float32))
_RECIP = float(torch.tensor(1.0 / formats.PER_TENSOR_DENOM,
                            dtype=torch.float32))

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0
#: launches of the row-scale entry, likewise
launches_row_scale = 0


def fwht_rows_math(x: torch.Tensor, signs: torch.Tensor,
                   group: int) -> torch.Tensor:
    """Sign flip + grouped FWHT butterfly on f32 rows x (M, K); signs
    broadcast to (1, K).  Same adds, subtracts and ``group ** -0.5`` as
    ``core.hadamard.rht``."""
    m, k = x.shape
    x = (x * signs.reshape(1, k)).reshape(m, k // group, group)
    h = 1
    while h < group:
        x = x.reshape(m, k // group, group // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(m, k // group, group)
        h *= 2
    return (x * (group ** -0.5)).reshape(m, k)


def fwht_rows(x: torch.Tensor, signs: torch.Tensor, *,
              group: int = 16) -> torch.Tensor:
    """Grouped RHT along the last axis of x (M, K); signs (K,).  Returns
    (M, K) in x's dtype.  CUDA tensors launch the kernel (f32 only); CPU
    tensors take the plain version."""
    global launches
    m, k = x.shape
    if group <= 0 or group & (group - 1):
        raise ValueError(f"FWHT group must be a power of two, got {group}")
    if k % group:
        raise ValueError(f"axis length {k} not divisible by RHT group "
                         f"{group}")
    if tuple(signs.shape) != (k,):
        raise ValueError(f"signs must have shape ({k},), got "
                         f"{tuple(signs.shape)}")
    if x.device.type == "cpu":
        return fwht_rows_math(x.to(torch.float32),
                              signs.to(torch.float32), group).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or group not in KERNEL_GROUPS:
        raise ValueError(f"the kernel takes float32 rows and a group in "
                         f"{KERNEL_GROUPS}, got {x.dtype}, group {group}")
    if signs.device != x.device:
        raise ValueError(f"signs must be on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    sg = signs.to(torch.float32).contiguous()
    if sg.data_ptr() % 16:
        sg = sg.clone()
    out = torch.empty_like(x)
    # the f32 value the plain version multiplies by (python float -> f32)
    norm = float(torch.tensor(group ** -0.5, dtype=torch.float32))
    err = _lib().fwht_rows(x.data_ptr(), sg.data_ptr(), out.data_ptr(), m, k,
                           group, norm,
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fwht_rows launch failed: cudaError {err}")
    launches += 1
    return out


def row_scale_plain(x: torch.Tensor,
                    signs: torch.Tensor | None) -> torch.Tensor:
    """The per-row W4A4 scale of the transformed rows: ``row_scale`` of
    :func:`fwht_rows_math` (group 16), or of x itself without signs."""
    xt = x if signs is None else fwht_rows_math(x, signs, RHT_GROUP)
    return scaling.row_scale(xt)


def fwht_row_scale(x: torch.Tensor,
                   signs: torch.Tensor | None = None) -> torch.Tensor:
    """(M,) f32 per-row scale of the grouped (16) RHT of f32 rows x (M, K)
    with signs (K,), bitwise ``row_scale(fwht_rows_math(x, signs, 16))``;
    ``signs=None`` is the identity transform.  CUDA tensors launch the
    kernel; CPU tensors take :func:`row_scale_plain`."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"expected (M, K) float32 rows, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    if k % RHT_GROUP:
        raise ValueError(f"axis length {k} not divisible by RHT group "
                         f"{RHT_GROUP}")
    if signs is not None and tuple(signs.shape) != (k,):
        raise ValueError(f"signs must have shape ({k},), got "
                         f"{tuple(signs.shape)}")
    if x.device.type == "cpu":
        return row_scale_plain(
            x, None if signs is None else signs.to(torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if signs is not None and signs.device != x.device:
        raise ValueError(f"signs must be on {x.device}")
    plan = tuning.row_scale_plan(m, k)
    return _row_scale_launch(x, signs, plan.ctas, plan.threads)


def _row_scale_launch(x: torch.Tensor, signs: torch.Tensor | None,
                      ctas: int, threads: int) -> torch.Tensor:
    """Launch the row-scale kernel with ``ctas`` CTAs per row of
    ``threads`` threads (``decode_study.py rowscale-sweep`` calls it with
    other plans than ``tuning.row_scale_plan``'s)."""
    global launches_row_scale
    m, k = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    sg_ptr = None
    if signs is not None:
        sg = signs.to(torch.float32).contiguous()
        if sg.data_ptr() % 16:
            sg = sg.clone()
        sg_ptr = sg.data_ptr()
    out = torch.empty(m, dtype=torch.float32, device=x.device)
    err = _lib().fwht_row_scale(
        x.data_ptr(), sg_ptr, out.data_ptr(), m, k, ctas, threads, _NORM,
        _RECIP, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fwht_row_scale launch failed: cudaError {err}")
    launches_row_scale += 1
    return out


def _lib():
    lib = build.load("fwht_rows")
    fn, rs = lib.fwht_rows, lib.fwht_row_scale
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rs.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        rs.restype = ctypes.c_int
    return lib
