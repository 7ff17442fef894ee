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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["fwht_rows", "fwht_rows_math", "launches", "KERNEL_GROUPS"]

#: transform groups the CUDA kernel is instantiated for
KERNEL_GROUPS = (4, 8, 16, 32, 64)

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0


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


def _lib():
    lib = build.load("fwht_rows")
    fn = lib.fwht_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
