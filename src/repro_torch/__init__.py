"""PyTorch/CUDA port of the MixFP4 serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``models/``, ``configs/``, ``serving/``, ``launch/``) so each module has an
obvious counterpart.  Every Pallas kernel on the served path is a
hand-written ``sm_90a`` CUDA kernel under ``csrc/``, built at first use by
``kernels/build.py``; each has a plain PyTorch version beside it that CPU
tensors take.

This package imports ``torch`` and ``numpy`` only.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` is the default; it
    raises when no GPU is present instead of quietly running on the CPU —
    callers that mean the CPU say ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        # The f32 products outside the kernels (the LM head, prefill
        # attention) must be full f32 as in the reference, never TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
