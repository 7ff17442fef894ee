"""Carry weights across from the JAX package: numpy in, torch out.

The JAX dense value tree (``TransformerLM.init`` values) stacks every
per-layer leaf with a leading L axis under ``"layers"``; the port keeps one
dict per layer.  An MoE layer's expert stacks come as (L, E, K, N) leaves
(packed: children (L, E, ...)) and carry over as per-layer (E, ...) stacks;
its router stays f32.  Packed trees (``ServeEngine.params``) hold QTensors whose
children carry that L axis, possibly on storage padded past the logical
shape.  Callers hand in ``np.asarray`` leaves or CPU tensors; a packed
leaf is any object with ``payload``/``scales``/``scale32``/``shape``/
``method`` and a ``layout`` with ``bm``/``bn`` (the reference's QTensor
after a ``tree.map(np.asarray, ...)``, or a tree that
``checkpoint.CheckpointManager.restore_packed`` rebuilt), so this module
needs nothing of JAX.  :func:`packed_to_stacked` goes the other way: the
port's packed parameters in the reference's layout, which is what a
checkpoint holds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import qtensor
from repro_torch.models.base import ArchConfig

__all__ = ["params_from_numpy", "packed_from_numpy", "packed_to_stacked"]


def _is_packed(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("payload", "scales", "scale32",
                                          "shape", "layout"))


def _tensor(a, device):
    """A copy of ``a`` (an array or a tensor, bf16 included) on device."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    return torch.from_numpy(np.array(a)).to(device)


def _at(a, layer: int):
    """Layer ``layer`` of a stacked leaf."""
    return a[layer] if isinstance(a, torch.Tensor) else np.asarray(a)[layer]


def _split_layers(tree, n_layers: int, leaf_fn) -> list[dict]:
    """{name: (L, ...)} nested dicts -> L per-layer dicts of leaf_fn(x[l]);
    every leaf must stack exactly ``n_layers`` layers."""
    def depths(node) -> set:
        if isinstance(node, dict):
            return set().union(*map(depths, node.values()))
        return {int((node.payload if _is_packed(node) else node).shape[0])}

    found = depths(tree)
    if found != {n_layers}:
        raise ValueError(f"the tree stacks {sorted(found)} layers; the "
                         f"config has n_layers={n_layers}")
    def take(node, layer):
        if isinstance(node, dict):
            return {k: take(v, layer) for k, v in node.items()}
        return leaf_fn(node, layer)
    return [take(tree, layer) for layer in range(n_layers)]


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's dense value tree -> the port's dense parameters."""
    dev = resolve_device(device)
    leaf = lambda a, layer: _tensor(_at(a, layer), dev)
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
            return _tensor(_at(a, layer), dev)
        return qtensor.QTensor(
            _tensor(_at(a.payload, layer), dev),
            _tensor(_at(a.scales, layer), dev),
            _tensor(_at(a.scale32, layer), dev).to(torch.float32),
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


def packed_to_stacked(params: dict) -> dict:
    """The reverse of :func:`packed_from_numpy`: the port's packed
    parameters in the reference's layout, every per-layer leaf stacked
    along a leading L axis under ``"layers"`` (a QTensor's children too:
    its ``scale32`` becomes (L,), or (L, E) for an expert stack), as CPU
    tensors (what a checkpoint writes)."""
    dev = torch.device("cpu")

    def stack(nodes: list):
        first = nodes[0]
        if isinstance(first, dict):
            if any(set(n) != set(first) for n in nodes):
                raise ValueError("layers differ in structure: "
                                 f"{[sorted(n) for n in nodes]}")
            return {k: stack([n[k] for n in nodes]) for k in first}
        if isinstance(first, qtensor.QTensor):
            return qtensor.stack([q.to(dev) for q in nodes])
        return torch.stack([t.to(dev) for t in nodes])

    out = {"embed": params["embed"].to(dev), "ln_f": params["ln_f"].to(dev),
           "layers": stack(params["layers"])}
    if "rht_signs" in params:
        out["rht_signs"] = {k: v.to(dev)
                            for k, v in params["rht_signs"].items()}
    return out
