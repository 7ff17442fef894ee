"""Shared model layers for serving: config, norms, RoPE, the quantized
linear, attention, the packed KV cache, MLP and LM head.

Counterpart of ``repro/models/base.py`` (the dense serving path).  Numerics
follow the reference exactly where they are easy to get wrong:

* the residual stream is bf16; ``rms_norm`` computes in f32 and casts back;
  ``qlinear`` returns the activation dtype;
* RoPE splits the head into halves (not interleaved pairs), in f32;
* GeGLU uses the tanh approximation of GELU (``jax.nn.gelu``'s default);
* the LM head is an f32 product with the f32 embedding, then the softcap,
  then a slice to ``vocab``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core import hadamard, qtensor
from repro_torch.kernels import ops

__all__ = ["ArchConfig", "ActQuant", "ACT_QUANT_MODES", "PROJECTION_KEYS",
           "is_packable_projection", "pack_projections", "padded_vocab",
           "decode_positions", "rms_norm", "apply_rope", "qlinear",
           "rht_signs_on_grid", "attention", "KV_SCALE32",
           "quantize_kv_rows", "attn_apply", "mlp", "lm_logits"]


@dataclass(frozen=True)
class ArchConfig:
    """The dense-family fields of the reference ``ArchConfig``."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 512
    head_dim: int = 0            # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"     # swiglu | gelu | geglu
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    window: int = 0              # sliding-window attention (0 = full)
    local_global_period: int = 0
    attn_chunk: int = 1024       # query rows per attention block
    norm_eps: float = 1e-5
    emb_scale: bool = False      # gemma-style sqrt(d) embedding scaling

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """Embedding rows padded as the reference pads them for TP sharding."""
    return ((vocab + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Packing the projections
# ---------------------------------------------------------------------------
PROJECTION_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_up", "w_down",
                             "w_gate"})


def is_packable_projection(key: str, leaf) -> bool:
    return (key in PROJECTION_KEYS and isinstance(leaf, torch.Tensor)
            and leaf.ndim == 2 and min(leaf.shape) >= 16)


def pack_projections(params, method: str = "mixfp4",
                     block: tuple[int, int] = (16, 16),
                     act_rht: bool = False):
    """Replace every dense projection weight of a parameter tree (nested
    dicts and lists) with a packed 2-D-tiled QTensor.  Leaves that are
    already QTensors pass through unchanged.  Returns
    ``(packed_tree, packed_bytes, dense_bytes)`` over all projection leaves
    (dense counted at bf16 rates).

    ``act_rht=True`` rotates each dense projection along K with the
    serve-time grouped RHT (``hadamard.serve_signs(K)``, group 16) before
    quantizing, the transform ``qlinear`` applies to the activations, and
    records the diagonals in a top-level ``"rht_signs"`` entry
    ``{str(K): (K,) f32}``; every such K must be a multiple of 16."""
    spec = qtensor.QuantSpec(method, qtensor.BlockLayout2D(*block))
    stats = {"packed": 0, "dense": 0}
    signs_used: dict[str, torch.Tensor] = {}

    def convert(w):
        if not isinstance(w, qtensor.QTensor) and act_rht:
            k = w.shape[0]
            if k % 16:
                raise ValueError(
                    f"pack_projections(act_rht=True): projection K={k} "
                    f"must be a multiple of the RHT group (16)")
            signs = torch.from_numpy(hadamard.serve_signs(k)).to(w.device)
            signs_used[str(k)] = signs
            w = hadamard.rht(w, signs, dim=0, group=16)
        qt = w if isinstance(w, qtensor.QTensor) else qtensor.quantize(w,
                                                                       spec)
        stats["packed"] += qt.nbytes
        stats["dense"] += math.prod(qt.shape) * qt.batch_size() * 2
        return qt

    def walk(node):
        if isinstance(node, dict):
            return {k: (convert(v) if (is_packable_projection(k, v)
                                       or (k in PROJECTION_KEYS
                                           and isinstance(v,
                                                          qtensor.QTensor)))
                        else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    packed = walk(params)
    if signs_used:
        packed["rht_signs"] = {**packed.get("rht_signs", {}), **signs_used}
    return packed, stats["packed"], stats["dense"]


# ---------------------------------------------------------------------------
# Elementwise / norm / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * g).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (B, S, H, dh); positions (B, S) or (S,).  Half-split rotation."""
    dh = x.shape[-1]
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def decode_positions(cache_len: torch.Tensor, b: int) -> torch.Tensor:
    """(B, 1) positions for a one-token step from a (B,) or scalar length."""
    cl = torch.as_tensor(cache_len)
    return (cl[:, None] if cl.ndim else cl.reshape(1, 1)).expand(
        b, 1).to(torch.int64)


# ---------------------------------------------------------------------------
# Quantized linear: packed weight -> W4A16 or W4A4 kernels
# ---------------------------------------------------------------------------
ACT_QUANT_MODES = ("bf16", "mixfp4", "mixfp4-2pass-rowscale", "mixfp4-2pass",
                   "mixfp4-qdq")


@dataclass(frozen=True)
class ActQuant:
    """How ``qlinear`` serves the activations of a packed projection (the
    reference's ``Ctx.act_quant`` / ``Ctx.act_rht``):

    * ``"bf16"``: dense bf16 rows, the W4A16 kernel;
    * ``"mixfp4"``: W4A4 with per-row scales, the row quantizer fused into
      the GEMM's prologue (one launch per projection);
    * ``"mixfp4-2pass-rowscale"``: ``quantize_rows(per_row=True)`` then the
      W4A4 kernel, bitwise the fused spelling;
    * ``"mixfp4-2pass"``: the legacy per-tensor scale, two launches;
    * ``"mixfp4-qdq"``: the same per-tensor wire bytes decoded back to rows
      and served W4A16 (the debugging oracle of ``"mixfp4-2pass"``).

    ``rht`` (with the two per-row spellings) applies the grouped RHT to the
    activations ahead of the quantizer, against weights rotated at pack
    time (``pack_projections(act_rht=True)``)."""

    mode: str = "bf16"
    rht: bool = False


@functools.lru_cache(maxsize=None)
def rht_signs_on_grid(k: int, kp: int, device: torch.device) -> torch.Tensor:
    """The serve-time RHT diagonal of a weight rotated on its logical K
    (``serve_signs(k)``), extended with +1 onto its stored grid ``kp``: the
    padded lanes are zero in both operands and transform to zero.  (The
    reference draws ``serve_signs(kp)`` from the padded length instead,
    which is another diagonal whenever the storage is padded.)"""
    signs = torch.ones(kp, dtype=torch.float32)
    signs[:k] = torch.from_numpy(hadamard.serve_signs(k))
    return signs.to(device)


def qlinear(x: torch.Tensor, w, act: ActQuant = ActQuant()) -> torch.Tensor:
    """Every projection of the served path: a packed 2-D QTensor weight
    through ``qmm``, f32 out cast back to ``x.dtype``; ``act`` picks the
    activation format (see :class:`ActQuant`)."""
    if not isinstance(w, qtensor.QTensor):
        raise NotImplementedError(
            "dense (qdq-simulated) projections belong to the training "
            "slice (ROADMAP §1 item 10); serve packed weights")
    if act.mode == "bf16":
        return qtensor.qmm(x, w).to(x.dtype)
    if act.mode not in ACT_QUANT_MODES:
        raise ValueError(f"unknown act_quant {act.mode!r} (expected one of "
                         f"{ACT_QUANT_MODES})")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    kp = 2 * w.payload.shape[0]
    signs = rht_signs_on_grid(w.shape[0], kp, x.device) if act.rht else None
    if act.mode == "mixfp4":
        y = qtensor.qmm(x2, w, fuse_act_quant=True, per_row_act=True,
                        act_rht_signs=signs)
    else:
        per_row = act.mode == "mixfp4-2pass-rowscale"
        if signs is not None:
            if not per_row:
                raise ValueError("act_rht rides the per-row scales: use "
                                 "'mixfp4' or 'mixfp4-2pass-rowscale'")
            # the transform of the logical rows; quantize_rows zero-pads
            # them onto Kp, as padding then transforming would
            x2 = ops.rht_rows(x2.to(torch.float32), signs[:k])
        qx = qtensor.quantize_rows(x2, pad_to=kp, per_row=per_row)
        if act.mode != "mixfp4-qdq":
            y = qtensor.qmm(qx, w)
        else:
            # decode the same wire bytes as value x block scale (exact in
            # bf16) and serve them W4A16; the per-tensor scale multiplies
            # the f32 output
            xd = qx.replace(scale32=torch.ones_like(qx.scale32),
                            dtype="float32").dequantize()
            y = qtensor.qmm(xd, w) * qx.scale32
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain; prefill and the bf16 cache)
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal_offset=0, window: int = 0,
              softcap: float = 0.0, chunk: int = 1024, kv_valid_len=None,
              causal: bool = True) -> torch.Tensor:
    """Masked GQA attention in f32: q (B, Sq, H, dh), k/v (B, Sk, Hkv, dh).
    ``causal_offset`` is the absolute position of q[:, 0] (scalar or (B,));
    ``kv_valid_len`` (scalar or (B,)) masks cache rows past the valid ones.
    Query rows run in blocks of ``chunk``."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5
    dev = q.device
    qr = q.reshape(b, sq, hkv, g, dh).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    kpos = torch.arange(sk, device=dev)
    offset = torch.as_tensor(causal_offset, device=dev)
    limit = torch.as_tensor(sk if kv_valid_len is None else kv_valid_len,
                            device=dev)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = qr[:, c0:c0 + chunk]
        nc = qc.shape[1]
        qpos = offset[..., None] + c0 + torch.arange(nc, device=dev)
        s = torch.einsum("bchgd,bshd->bhgcs", qc, kf) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            mask = kpos <= qpos[..., None]
            if window > 0:
                mask = mask & (kpos > qpos[..., None] - window)
        else:
            mask = torch.ones(qpos.shape + (sk,), dtype=torch.bool,
                              device=dev)
        valid = kpos < (limit[:, None, None] if limit.ndim else limit)
        mask = mask & valid                   # (C, Sk) or (B, C, Sk)
        if mask.ndim == 2:
            mask = mask[None]
        s = s.masked_fill(~mask[:, None, None], -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgcs,bshd->bchgd", p, vf)
        outs.append(o.reshape(b, nc, h, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Packed MixFP4 KV cache
# ---------------------------------------------------------------------------
# One per-tensor scale shared by every KV row: rows are written one decode
# step at a time, so the level-2 scale cannot depend on the data.
KV_SCALE32 = 1.0


def quantize_kv_rows(kv: torch.Tensor):
    """kv (..., dh) -> (payload (..., dh/2), scales (..., dh/16)) through
    the row-quantizer kernel under the pinned KV_SCALE32."""
    shape = kv.shape
    flat = kv.reshape(-1, shape[-1]).to(torch.float32)
    payload, scales, _ = ops.quantize_rows(flat, scale32=KV_SCALE32)
    return (payload.reshape(*shape[:-1], shape[-1] // 2),
            scales.reshape(*shape[:-1], shape[-1] // 16))


def _attn_packed_cached(q, knew, vnew, ck: qtensor.QTensor,
                        cv: qtensor.QTensor, cache_len, window: int,
                        cfg: ArchConfig):
    """Attention over one layer of the packed cache.  ``ck``/``cv`` are
    views into the engine's cache and are written IN PLACE.

    Decode (s == 1): quantize the new K/V row, scatter its bytes at each
    sequence's ``cache_len``, and run the decode-attention kernel with
    ``lengths = cache_len + 1``.  Prefill (s > 1, scalar ``cache_len``):
    quantize every prompt row, write them, and attend over the
    *dequantized* rows with the plain ``attention`` — the values later
    decode steps read back."""
    b, s = q.shape[:2]
    kp, ks = quantize_kv_rows(knew)
    vp, vs = quantize_kv_rows(vnew)
    if s == 1:
        cl = torch.as_tensor(cache_len, device=q.device).to(
            torch.int64).expand(b)
        rows = torch.arange(b, device=q.device)
        ck.payload[rows, cl] = kp[:, 0]
        ck.scales[rows, cl] = ks[:, 0]
        cv.payload[rows, cl] = vp[:, 0]
        cv.scales[rows, cl] = vs[:, 0]
        o = ops.attn_decode_packed(
            q[:, 0], ck.payload, ck.scales, cv.payload, cv.scales,
            (cl + 1).to(torch.int32), window=window,
            softcap=cfg.softcap_attn, k_scale32=ck.scale32,
            v_scale32=cv.scale32)
        return o[:, None].to(q.dtype)
    cl = int(cache_len)
    ck.payload[:, cl:cl + s] = kp
    ck.scales[:, cl:cl + s] = ks
    cv.payload[:, cl:cl + s] = vp
    cv.scales[:, cl:cl + s] = vs
    k = qtensor.from_packed_rows(ck.payload, ck.scales,
                                 ck.scale32).dequantize()
    v = qtensor.from_packed_rows(cv.payload, cv.scales,
                                 cv.scale32).dequantize()
    return attention(q, k, v, causal_offset=cl, window=window,
                     softcap=cfg.softcap_attn, chunk=cfg.attn_chunk,
                     kv_valid_len=cl + s)


def attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, positions,
               window: int, kv_cache, cache_len,
               act: ActQuant = ActQuant()) -> torch.Tensor:
    """The attention sub-layer over a cache.  ``kv_cache`` is one layer's
    (K, V): packed QTensors (the fused packed path) or bf16 tensors; either
    is updated in place."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = qlinear(x, p["wq"], act).reshape(b, s, cfg.n_heads, dh)
    knew = qlinear(x, p["wk"], act).reshape(b, s, cfg.n_kv_heads, dh)
    vnew = qlinear(x, p["wv"], act).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        knew = rms_norm(knew, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    knew = apply_rope(knew, positions, cfg.rope_theta)
    ck, cv = kv_cache
    if isinstance(ck, qtensor.QTensor):
        o = _attn_packed_cached(q, knew, vnew, ck, cv, cache_len, window, cfg)
    else:
        cl = cache_len
        if isinstance(cl, int):
            ck[:, cl:cl + s] = knew.to(ck.dtype)
            cv[:, cl:cl + s] = vnew.to(cv.dtype)
        else:
            if s != 1:
                raise ValueError("per-sequence cache_len needs s == 1")
            cl = cl.to(device=x.device, dtype=torch.int64).expand(b)
            rows = torch.arange(b, device=x.device)
            ck[rows, cl] = knew[:, 0].to(ck.dtype)
            cv[rows, cl] = vnew[:, 0].to(cv.dtype)
        o = attention(q, ck, cv, causal_offset=cl, window=window,
                      softcap=cfg.softcap_attn, chunk=cfg.attn_chunk,
                      kv_valid_len=cl + s)
    return qlinear(o.reshape(b, s, cfg.n_heads * dh), p["wo"], act)


# ---------------------------------------------------------------------------
# MLP and LM head
# ---------------------------------------------------------------------------
# The activations evaluate the reference's formulas op by op in the
# activation dtype (bf16), rounding after every op as ``jax.nn`` does on a
# bf16 array — not a fused f32 evaluation rounded once (``F.gelu`` /
# ``F.silu``).  The two differ by an ulp on about a third of the elements,
# and the 4-bit KV and weight quantizers downstream amplify such ulps.
_GELU_C0 = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.bfloat16))
_GELU_C1 = float(torch.tensor(0.044715, dtype=torch.bfloat16))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (the tanh approximation, its default) for bf16 x."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    inner = _GELU_C0 * (x + _GELU_C1 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu(x)`` = x * logistic(x) for bf16 x."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p: dict, x: torch.Tensor, cfg: ArchConfig,
        act: ActQuant = ActQuant()) -> torch.Tensor:
    up = qlinear(x, p["w_up"], act)
    if cfg.mlp_type == "swiglu":
        h = silu(qlinear(x, p["w_gate"], act)) * up
    elif cfg.mlp_type == "geglu":
        h = gelu_tanh(qlinear(x, p["w_gate"], act)) * up
    else:
        h = gelu_tanh(up)
    return qlinear(h, p["w_down"], act)


def lm_logits(x: torch.Tensor, embed: torch.Tensor, softcap: float = 0.0,
              vocab: int | None = None) -> torch.Tensor:
    """Tied-embedding LM head: f32 product, softcap, slice to ``vocab``."""
    logits = torch.matmul(x.to(torch.float32), embed.to(torch.float32).T)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if vocab is not None and logits.shape[-1] != vocab:
        logits = logits[..., :vocab]
    return logits
