"""Carry weights across from the JAX package: numpy in, torch out.

The JAX dense value tree (``TransformerLM.init`` values) stacks every
per-layer leaf with a leading L axis under ``"layers"``; the port keeps one
dict per layer.  An MoE layer's expert stacks come as (L, E, K, N) leaves
(packed: children (L, E, ...)) and carry over as per-layer (E, ...) stacks;
its router stays f32.  Packed trees (``ServeEngine.params``) hold QTensors whose
children carry that L axis, possibly on storage padded past the logical
shape.  Callers hand in ``np.asarray`` leaves; a packed leaf is any object
with ``payload``/``scales``/``scale32``/``shape``/``method`` and a
``layout`` with ``bm``/``bn`` (the reference's QTensor after a
``tree.map(np.asarray, ...)``), so this module needs nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import qtensor
from repro_torch.models.base import ArchConfig

__all__ = ["params_from_numpy", "packed_from_numpy"]


def _is_packed(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("payload", "scales", "scale32",
                                          "shape", "layout"))


def _tensor(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def _split_layers(tree, n_layers: int, leaf_fn) -> list[dict]:
    """{name: (L, ...)} nested dicts -> L per-layer dicts of leaf_fn(x[l])."""
    def take(node, layer):
        if isinstance(node, dict):
            return {k: take(v, layer) for k, v in node.items()}
        return leaf_fn(node, layer)
    return [take(tree, layer) for layer in range(n_layers)]


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's dense value tree -> the port's dense parameters."""
    dev = resolve_device(device)
    leaf = lambda a, layer: _tensor(np.asarray(a)[layer], dev)
    return {"embed": _tensor(tree["embed"], dev),
            "ln_f": _tensor(tree["ln_f"], dev),
            "layers": _split_layers(tree["layers"], cfg.n_layers, leaf)}


def packed_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's packed tree -> the port's packed parameters with the
    same bytes (storage padding included), and the ``rht_signs`` record of
    a tree packed with ``act_rht=True``."""
    dev = resolve_device(device)

    def leaf(a, layer):
        if not _is_packed(a):
            return _tensor(np.asarray(a)[layer], dev)
        return qtensor.QTensor(
            _tensor(np.asarray(a.payload)[layer], dev),
            _tensor(np.asarray(a.scales)[layer], dev),
            _tensor(np.asarray(a.scale32, np.float32)[layer], dev),
            method=a.method,
            layout=qtensor.BlockLayout2D(a.layout.bm, a.layout.bn),
            shape=tuple(a.shape), dtype=str(a.dtype))

    out = {"embed": _tensor(tree["embed"], dev),
           "ln_f": _tensor(tree["ln_f"], dev),
           "layers": _split_layers(tree["layers"], cfg.n_layers, leaf)}
    if "rht_signs" in tree:
        out["rht_signs"] = {k: _tensor(v, dev)
                            for k, v in tree["rht_signs"].items()}
    return out
