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
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core import qtensor
from repro_torch.kernels import ops

__all__ = ["ArchConfig", "PROJECTION_KEYS", "is_packable_projection",
           "pack_projections", "padded_vocab", "decode_positions",
           "rms_norm", "apply_rope", "qlinear", "attention", "KV_SCALE32",
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
                     block: tuple[int, int] = (16, 16)):
    """Replace every dense projection weight of a parameter tree (nested
    dicts and lists) with a packed 2-D-tiled QTensor.  Leaves that are
    already QTensors pass through unchanged.  Returns
    ``(packed_tree, packed_bytes, dense_bytes)`` over all projection leaves
    (dense counted at bf16 rates)."""
    spec = qtensor.QuantSpec(method, qtensor.BlockLayout2D(*block))
    stats = {"packed": 0, "dense": 0}

    def convert(w):
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
# Quantized linear: packed weight -> W4A16 kernel
# ---------------------------------------------------------------------------
def qlinear(x: torch.Tensor, w) -> torch.Tensor:
    """Every projection of the served path: a packed 2-D QTensor weight
    through ``qmm`` (the W4A16 kernel), f32 out cast back to ``x.dtype``."""
    if not isinstance(w, qtensor.QTensor):
        raise NotImplementedError(
            "dense (qdq-simulated) projections belong to the training "
            "slice (ROADMAP §1 item 10); serve packed weights")
    return qtensor.qmm(x, w).to(x.dtype)


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
               window: int, kv_cache, cache_len) -> torch.Tensor:
    """The attention sub-layer over a cache.  ``kv_cache`` is one layer's
    (K, V): packed QTensors (the fused packed path) or bf16 tensors; either
    is updated in place."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = qlinear(x, p["wq"]).reshape(b, s, cfg.n_heads, dh)
    knew = qlinear(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    vnew = qlinear(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
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
    return qlinear(o.reshape(b, s, cfg.n_heads * dh), p["wo"])


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


def mlp(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    up = qlinear(x, p["w_up"])
    if cfg.mlp_type == "swiglu":
        h = silu(qlinear(x, p["w_gate"])) * up
    elif cfg.mlp_type == "geglu":
        h = gelu_tanh(qlinear(x, p["w_gate"])) * up
    else:
        h = gelu_tanh(up)
    return qlinear(h, p["w_down"])


def lm_logits(x: torch.Tensor, embed: torch.Tensor, softcap: float = 0.0,
              vocab: int | None = None) -> torch.Tensor:
    """Tied-embedding LM head: f32 product, softcap, slice to ``vocab``."""
    logits = torch.matmul(x.to(torch.float32), embed.to(torch.float32).T)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if vocab is not None and logits.shape[-1] != vocab:
        logits = logits[..., :vocab]
    return logits
