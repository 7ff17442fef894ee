"""``QTensor``: the packed wire format with its layout attached.
Counterpart of the non-sharded half of ``repro/core/qtensor.py``.

  payload  uint8 — two 4-bit codes per byte
  scales   uint8 — {T | e4m3[6:0]} per block
  scale32  f32   — per-tensor (or per-row / per-layer) scale

Layouts (the same as the JAX package, so tests compare like with like):

  1-D (KV rows, activations; blocks of ``g`` along ``axis``):
      payload (*lead, Kp//2)  scales (*lead, Kp//g)        Kp = pad16(K)
  2-D (weights, (bm x bn) tiles on a (K, N) matrix):
      payload (Kp//2, Np)     scales (Kp//bm, Np//bn)
      two K-consecutive nibbles per byte (low nibble = even row).

Storage may be larger than the logical shape (zero bytes padding the
grid, e.g. the JAX engine's tile pre-padding): zero payload under zero
scale bytes decodes to exact zeros, and ``shape`` keeps the logical dims.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.core import formats, pack as pack_lib, quantize as Q, scaling

__all__ = ["BlockLayout1D", "BlockLayout2D", "QuantSpec", "QTensor",
           "PACKABLE_METHODS", "quantize", "quantize_rows",
           "from_packed_rows", "stack", "qmm", "qmm_experts", "ShapeDtype",
           "tree_spec", "tree_like"]

_G = 16
PACKABLE_METHODS = ("nvfp4", "mixfp4")


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class BlockLayout1D:
    axis: int = -1
    block: int = _G


@dataclass(frozen=True)
class BlockLayout2D:
    bm: int = _G
    bn: int = _G


BlockLayout = Union[BlockLayout1D, BlockLayout2D]


@dataclass(frozen=True)
class QuantSpec:
    method: str = "mixfp4"
    layout: BlockLayout = BlockLayout1D()


@dataclass
class QTensor:
    """A packed block-quantized tensor (see the module docstring).  Extra
    leading dims on the children (a layer axis, say) broadcast through
    ``dequantize``."""

    payload: torch.Tensor
    scales: torch.Tensor
    scale32: torch.Tensor
    method: str = "mixfp4"
    layout: BlockLayout = dataclasses.field(default_factory=BlockLayout1D)
    shape: tuple = ()
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        """Wire bytes: payload + block-scale bytes + 4 B per tensor scale."""
        return (self.payload.numel() + self.scales.numel()
                + 4 * max(self.scale32.numel(), 1))

    def batch_size(self) -> int:
        nb = self.payload.ndim - (len(self.shape)
                                  if isinstance(self.layout, BlockLayout1D)
                                  else 2)
        return int(math.prod(self.payload.shape[:nb])) if nb else 1

    def replace(self, **kw) -> "QTensor":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "QTensor":
        return self.replace(payload=self.payload.to(device),
                            scales=self.scales.to(device),
                            scale32=self.scale32.to(device))

    # -- decode -----------------------------------------------------------
    def dequantize(self, dtype=None) -> torch.Tensor:
        out = getattr(torch, dtype or self.dtype)
        if isinstance(self.layout, BlockLayout2D):
            return self._dequantize_2d().to(out)
        return self._dequantize_1d().to(out)

    def _s32(self, ndim: int) -> torch.Tensor:
        s = self.scale32.to(torch.float32)
        return s.reshape(s.shape + (1,) * (ndim - s.ndim))

    def _dequantize_2d(self) -> torch.Tensor:
        bm, bn = self.layout.bm, self.layout.bn
        lo = self.payload & 0xF
        hi = (self.payload >> 4) & 0xF
        k2, n = self.payload.shape[-2:]
        nib = torch.stack([lo, hi], dim=-2).reshape(
            *self.payload.shape[:-2], 2 * k2, n)
        s8, t = scaling.unpack_scale_and_type(self.scales)
        s_full = s8.repeat_interleave(bm, -2).repeat_interleave(bn, -1)
        t_full = t.repeat_interleave(bm, -2).repeat_interleave(bn, -1)
        x = formats.decode_to_e2m2(nib, t_full) * s_full * self._s32(nib.ndim)
        m, nn = self.shape
        return x[..., :m, :nn]

    def _dequantize_1d(self) -> torch.Tensor:
        g = self.layout.block
        lo = self.payload & 0xF
        hi = (self.payload >> 4) & 0xF
        nib = torch.stack([lo, hi], dim=-1).reshape(
            *self.payload.shape[:-1], 2 * self.payload.shape[-1])
        s8, t = scaling.unpack_scale_and_type(self.scales)
        x = (formats.decode_to_e2m2(nib, t.repeat_interleave(g, -1))
             * s8.repeat_interleave(g, -1) * self._s32(nib.ndim))
        axis = self.layout.axis
        x = x[..., :self.shape[axis]]
        dest = axis if axis < 0 else axis - len(self.shape)
        return x.movedim(-1, dest)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------
def _check_packable(method: str):
    if method not in PACKABLE_METHODS:
        raise ValueError(f"method {method!r} is not expressible in the "
                         f"MixFP4 wire format (packable: {PACKABLE_METHODS})")


def quantize(x: torch.Tensor, spec: QuantSpec = QuantSpec()) -> QTensor:
    """Quantize ``x`` into the packed wire format (RNE)."""
    _check_packable(spec.method)
    if isinstance(spec.layout, BlockLayout2D):
        return _quantize_2d(x, spec)
    return _quantize_1d(x, spec)


def _quantize_1d(x: torch.Tensor, spec: QuantSpec) -> QTensor:
    lay = spec.layout
    bq, _n, _axis = Q.block_quantize_1d(x, spec.method, block=lay.block,
                                        axis=lay.axis)
    p = pack_lib.pack_blocks(bq)
    lead = p.scales.shape[:-1]
    payload = p.payload.reshape(*lead, p.scales.shape[-1] * lay.block // 2)
    axis_neg = lay.axis if lay.axis < 0 else lay.axis - x.ndim
    return QTensor(payload, p.scales, p.scale32, method=spec.method,
                   layout=BlockLayout1D(axis_neg, lay.block),
                   shape=tuple(x.shape), dtype=_dtype_name(x.dtype))


def _quantize_2d(w: torch.Tensor, spec: QuantSpec) -> QTensor:
    if w.ndim != 2:
        raise ValueError("BlockLayout2D expects a (K, N) matrix")
    bm, bn = spec.layout.bm, spec.layout.bn
    bq, shape, _ = Q.block_quantize_2d(w, spec.method, block=(bm, bn))
    gm, gn = bq.type_bits.shape
    vals = bq.values.reshape(gm, gn, bm, bn).permute(0, 2, 1, 3).reshape(
        gm * bm, gn * bn)
    t_full = bq.type_bits.repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    nib = torch.where(t_full.to(torch.bool), formats.e1m2_encode(vals),
                      formats.e2m1_encode(vals))
    payload = (nib[0::2, :] | (nib[1::2, :] << 4)).to(torch.uint8)
    scales = scaling.pack_scale_with_type(bq.scale8, bq.type_bits)
    return QTensor(payload, scales, bq.scale32, method=spec.method,
                   layout=BlockLayout2D(bm, bn), shape=tuple(shape),
                   dtype=_dtype_name(w.dtype))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def quantize_rows(x: torch.Tensor, *,
                  scale32: torch.Tensor | float | None = None,
                  pad_to: int | None = None,
                  per_row: bool = False) -> QTensor:
    """Row quantizer (MixFP4, RNE, g=16 blocks along the last axis of an
    (M, K) matrix) through ``kernels.ops.quantize_rows``.  ``scale32`` pins
    the per-tensor (or, with ``per_row``, per-row) scale; ``pad_to``
    zero-pads K onto a packed grid while the logical shape stays
    ``x.shape``."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    if x.ndim != 2:
        raise ValueError("quantize_rows expects (M, K)")
    m, k = x.shape
    kp = _pad_to(k, _G) if pad_to is None else int(pad_to)
    if kp < k or kp % _G:
        raise ValueError(f"quantize_rows: pad_to={pad_to} must be a "
                         f"multiple of {_G} >= K={k}")
    x32 = x.to(torch.float32)
    if kp != k:
        x32 = F.pad(x32, (0, kp - k))
    payload, scales, s32 = ops.quantize_rows(x32, scale32=scale32,
                                             per_row=per_row)
    return QTensor(payload, scales, s32, method="mixfp4",
                   layout=BlockLayout1D(-1, _G), shape=(m, k),
                   dtype=_dtype_name(x.dtype))


def from_packed_rows(payload: torch.Tensor, scales: torch.Tensor,
                     scale32: torch.Tensor | float = 1.0, *,
                     dtype: str = "float32") -> QTensor:
    """Wrap already-packed 1-D rows (g=16 blocks along the last axis)."""
    s32 = torch.as_tensor(scale32, dtype=torch.float32, device=payload.device)
    return QTensor(payload, scales, s32, method="mixfp4",
                   layout=BlockLayout1D(-1, _G),
                   shape=(*payload.shape[:-1], payload.shape[-1] * 2),
                   dtype=dtype)


def stack(qts: Sequence[QTensor]) -> QTensor:
    """Stack same-layout QTensors along a new leading batch dim (their
    ``scale32``s too: () each gives (N,), an expert stack's (E,) gives
    (N, E))."""
    first = qts[0]
    for qt in qts[1:]:
        if (qt.method, qt.layout, qt.shape, qt.dtype) != \
           (first.method, first.layout, first.shape, first.dtype):
            raise ValueError("stack() requires identical QTensor metadata")
    return first.replace(
        payload=torch.stack([q.payload for q in qts]),
        scales=torch.stack([q.scales for q in qts]),
        scale32=torch.stack([q.scale32 for q in qts]))


# ---------------------------------------------------------------------------
# qmm: x @ packed 2-D weight -> the W4A16, W4A4 or fused W4A4 kernel
# ---------------------------------------------------------------------------
def _act_scale32_like_quantize_rows(x2: torch.Tensor,
                                    per_row: bool = False) -> torch.Tensor:
    """The activation scale exactly as the row quantizer derives it
    (``scaling.tensor_scale`` / ``scaling.row_scale``); zero K-padding
    changes neither, so the unpadded rows give the same value.  All-zero
    rows get scale 1 and quantize to zero codes."""
    x2 = x2.to(torch.float32)
    return scaling.row_scale(x2) if per_row else scaling.tensor_scale(x2)


def qmm(x: Union[torch.Tensor, QTensor], w: QTensor, *,
        fuse_act_quant: bool = False,
        act_scale32: torch.Tensor | float | None = None,
        per_row_act: bool = False,
        act_rht_signs: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w, f32 out, for an unbatched 2-D packed weight.

    * ``x`` dense (..., K): the W4A16 kernel (``kernels.ops.gemm_w4a16``).
    * ``x`` dense + ``fuse_act_quant``: the W4A4 kernel with the row
      quantizer fused into its prologue, one launch, bitwise
      ``quantize_rows(x, pad_to=Kp)`` followed by ``qmm``.  ``act_scale32``
      pins the activation scale; by default it is derived as the quantizer
      would.  ``per_row_act`` switches to one scale per row, and
      ``act_rht_signs`` (+-1 on the weight's stored Kp grid; needs
      ``per_row_act``) applies the grouped RHT ahead of the quantizer: the
      row scales are then read from the transformed rows, which takes one
      ``fwht_rows`` launch beside the GEMM's, and the weight must carry the
      same transform along K (``pack_projections(act_rht=True)``).
    * ``x`` a 1-D-blocked QTensor of rows on the weight's Kp grid: the
      packed W4A4 kernel, per row when ``x.scale32`` is an (M,) vector.

    x is zero-padded onto the weight's stored K grid when that grid is wider
    than K (padded weight rows decode to exact zeros)."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    if fuse_act_quant and isinstance(x, QTensor):
        raise ValueError("qmm: fuse_act_quant quantizes a DENSE activation "
                         "in the kernel prologue; the operand is already "
                         "packed — drop the flag or pass the dense rows")
    if not (isinstance(w, QTensor) and isinstance(w.layout, BlockLayout2D)
            and w.payload.ndim == 2):
        raise ValueError("qmm expects an unbatched 2-D-tiled QTensor "
                         "weight (slice stacked weights first)")
    k_logical, n_logical = w.shape
    kp = 2 * w.payload.shape[0]
    if x.shape[-1] != k_logical:
        raise ValueError(f"qmm: x K={x.shape[-1]} vs weight K={k_logical}")

    if isinstance(x, QTensor):
        if not (isinstance(x.layout, BlockLayout1D)
                and x.layout.axis in (-1, len(x.shape) - 1)
                and x.layout.block == _G and x.payload.ndim == 2
                and x.payload.shape[1] * 2 == kp):
            raise ValueError("qmm: a packed activation must be (M, K) rows "
                             "with g=16 blocks along K on the weight's "
                             f"packed K grid ({kp})")
        per_row = x.scale32.ndim == 1
        return ops.gemm_w4a4(x.payload, x.scales, x.scale32, w.payload,
                             w.scales, w.scale32, per_row=per_row,
                             n_out=n_logical)

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_logical)
    if not fuse_act_quant:
        if kp != k_logical:
            x2 = F.pad(x2, (0, kp - k_logical))
        y = ops.gemm_w4a16(x2, w.payload, w.scales, w.scale32,
                           n_out=n_logical)
        return y.reshape(*lead, n_logical)

    if act_rht_signs is not None and not per_row_act:
        raise ValueError("qmm: act_rht_signs requires per_row_act=True "
                         "(the RHT lever rides the row-local scale "
                         "contract)")
    # rows cast to f32 before padding, where the quantizer casts them
    x2p = x2.to(torch.float32)
    if kp != k_logical:
        x2p = F.pad(x2p, (0, kp - k_logical))
    if act_rht_signs is not None and tuple(act_rht_signs.shape) != (kp,):
        raise ValueError(f"qmm: act_rht_signs must live on the weight's "
                         f"packed Kp grid ({kp},), got "
                         f"{tuple(act_rht_signs.shape)}")
    if act_scale32 is not None:
        s32x = torch.as_tensor(act_scale32, dtype=torch.float32,
                               device=x2p.device)
    elif per_row_act:
        # the row scale of the values the prologue quantizes: the rows
        # after the RHT when signs ride along (one launch, no transformed
        # copy of the rows)
        s32x = ops.rht_row_scale(x2p, act_rht_signs)
    else:
        s32x = _act_scale32_like_quantize_rows(x2)
    y = ops.gemm_w4a4_fused(x2p, s32x, w.payload, w.scales, w.scale32,
                            per_row=per_row_act, rht_signs=act_rht_signs,
                            n_out=n_logical)
    return y.reshape(*lead, n_logical)


def qmm_experts(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e], f32 out, for a stack of expert weights: x
    (E, C, K) dense, ``w`` a 2-D-tiled QTensor whose children lead with E
    (``pack_projections`` of an (E, K, N) stack), each expert with its own
    ``scale32``.  Every expert runs in one W4A16 launch
    (``kernels.ops.gemm_w4a16_experts``), each expert's rows bitwise what
    :func:`qmm` gives on that expert's slice.  x is zero-padded onto the
    stored K grid when that grid is wider than K."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    if not (isinstance(w, QTensor) and isinstance(w.layout, BlockLayout2D)
            and w.payload.ndim == 3):
        raise ValueError("qmm_experts expects a 2-D-tiled QTensor stack "
                         "with children (E, ...)")
    k_logical, n_logical = w.shape
    e, kp = w.payload.shape[0], 2 * w.payload.shape[1]
    if x.ndim != 3 or x.shape[0] != e or x.shape[-1] != k_logical:
        raise ValueError(f"qmm_experts: x {tuple(x.shape)} vs a stack of "
                         f"{e} experts with K={k_logical}")
    if kp != k_logical:
        x = F.pad(x, (0, kp - k_logical))
    return ops.gemm_w4a16_experts(x, w.payload, w.scales, w.scale32,
                                  n_out=n_logical)


# ---------------------------------------------------------------------------
# JSON-able tree specs (checkpointing: rebuild the structure without arrays)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeDtype:
    """A leaf of a restore skeleton: its shape and its dtype's numpy name."""

    shape: tuple
    dtype: str


def _layout_to_json(layout: BlockLayout) -> dict:
    if isinstance(layout, BlockLayout2D):
        return {"kind": "2d", "bm": layout.bm, "bn": layout.bn}
    return {"kind": "1d", "axis": layout.axis, "block": layout.block}


def _layout_from_json(d: dict) -> BlockLayout:
    if d["kind"] == "2d":
        return BlockLayout2D(d["bm"], d["bn"])
    return BlockLayout1D(d["axis"], d["block"])


def tree_spec(tree):
    """JSON-able structural spec of a tree of nested dicts and lists whose
    leaves are tensors or QTensors, the reference's format exactly: a
    QTensor records its metadata and each child's shape and dtype name
    (``"uint8"``, ``"float32"``, ...), ``pspec`` always null (the port
    declares no sharding); dicts keep their insertion order."""
    if isinstance(tree, QTensor):
        return {"__qtensor__": {
            "method": tree.method,
            "layout": _layout_to_json(tree.layout),
            "shape": list(tree.shape),
            "dtype": tree.dtype,
            "pspec": None,
            "children": {
                name: {"shape": list(getattr(tree, name).shape),
                       "dtype": _dtype_name(getattr(tree, name).dtype)}
                for name in ("payload", "scales", "scale32")},
        }}
    if isinstance(tree, dict):
        return {"__dict__": {k: tree_spec(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [tree_spec(v) for v in tree],
                "tuple": isinstance(tree, tuple)}
    return {"__leaf__": None}


def tree_like(spec):
    """Inverse of :func:`tree_spec`: a skeleton with the same structure.
    QTensor children are :class:`ShapeDtype`s where the spec records them
    (``0`` otherwise, as in the reference), other leaves ``0``; a spec's
    ``pspec`` is ignored."""
    if "__qtensor__" in spec:
        m = spec["__qtensor__"]
        kids = m.get("children")
        if kids:
            children = [ShapeDtype(tuple(kids[n]["shape"]), kids[n]["dtype"])
                        for n in ("payload", "scales", "scale32")]
        else:
            children = [0, 0, 0]
        return QTensor(*children, method=m["method"],
                       layout=_layout_from_json(m["layout"]),
                       shape=tuple(m["shape"]), dtype=m["dtype"])
    if "__dict__" in spec:
        return {k: tree_like(v) for k, v in spec["__dict__"].items()}
    if "__list__" in spec:
        seq = [tree_like(v) for v in spec["__list__"]]
        return tuple(seq) if spec.get("tuple") else seq
    return 0
