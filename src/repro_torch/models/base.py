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
from repro_torch.kernels.mixfp4_attn import gather_pages

__all__ = ["ArchConfig", "ActQuant", "ACT_QUANT_MODES", "PROJECTION_KEYS",
           "is_packable_projection", "pack_projections", "padded_vocab",
           "decode_positions", "rms_norm", "apply_rope", "qlinear",
           "rht_signs_on_grid", "attention", "KV_SCALE32",
           "quantize_kv_rows", "attn_apply", "linear_init", "mlp_init",
           "mlp", "lm_logits"]


@dataclass(frozen=True)
class ArchConfig:
    """The dense- and MoE-family fields of the reference ``ArchConfig``."""

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
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert_ff: int = 0
    ep_mode: str = "expert"      # 'expert' pads the stack to 16s | 'ffn'
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
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
    """A projection-named leaf whose trailing (K, N) matrix fills at least
    one 16x16 tile; leading dims (an MoE expert stack) ride along as
    QTensor batch dims."""
    return (key in PROJECTION_KEYS and isinstance(leaf, torch.Tensor)
            and leaf.ndim >= 2 and min(leaf.shape[-2:]) >= 16)


def pack_projections(params, method: str = "mixfp4",
                     block: tuple[int, int] = (16, 16),
                     act_rht: bool = False):
    """Replace every dense projection weight of a parameter tree (nested
    dicts and lists) with a packed 2-D-tiled QTensor.  Leaves that are
    already QTensors pass through unchanged.  A stack (E, K, N) of expert
    matrices is quantized matrix by matrix into one QTensor whose children
    lead with E, each expert with its own ``scale32`` (the reference's
    ``vmap`` of ``quantize``); stacks are not padded past their tiles.
    Returns ``(packed_tree, packed_bytes, dense_bytes)`` over all
    projection leaves (dense counted at bf16 rates, every stored expert
    included).

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
            k = w.shape[-2]
            if k % 16:
                raise ValueError(
                    f"pack_projections(act_rht=True): projection K={k} "
                    f"must be a multiple of the RHT group (16)")
            signs = torch.from_numpy(hadamard.serve_signs(k)).to(w.device)
            signs_used[str(k)] = signs
            w = hadamard.rht(w, signs, dim=-2, group=16)
        if isinstance(w, qtensor.QTensor):
            qt = w
        elif w.ndim == 2:
            qt = qtensor.quantize(w, spec)
        else:
            qt = qtensor.stack([qtensor.quantize(m, spec) for m in w])
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
            "slice (ROADMAP §1 item 6); serve packed weights")
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
              causal: bool = True, pad_blocks: bool = False) -> torch.Tensor:
    """Masked GQA attention in f32: q (B, Sq, H, dh), k/v (B, Sk, Hkv, dh).
    ``causal_offset`` is the absolute position of q[:, 0] (scalar or (B,));
    ``kv_valid_len`` (scalar or (B,)) masks cache rows past the valid ones.

    Query rows run in blocks of ``chunk``.  With ``pad_blocks`` (every
    prefill sets it) each block runs at exactly ``chunk`` rows, the last
    one padded with zero rows: each product then has one shape whatever the
    prompt or chunk length, so a query row's result does not depend on how
    many rows share its call (on the card ``einsum`` goes to cuBLAS, which
    may pick another algorithm, and another summation order, for another
    row count).  That keeps a chunked or suffix-only prefill bitwise the
    whole-prompt one."""
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
        if pad_blocks:
            qc = F.pad(
                qc, (0, 0, 0, 0, 0, 0, 0, chunk - nc)).contiguous()
        qpos = offset[..., None] + c0 + torch.arange(qc.shape[1], device=dev)
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
        outs.append(o[:, :nc].reshape(b, nc, h, dh))
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


def _decode_lengths(cache_len, b: int, s: int, device) -> torch.Tensor:
    """The (B,) int32 write positions of a one-token decode step."""
    if s != 1:
        raise ValueError("per-sequence cache_len needs s == 1")
    return torch.as_tensor(cache_len, device=device).to(torch.int32).expand(b)


def _attn_packed_cached(q, knew, vnew, ck: qtensor.QTensor,
                        cv: qtensor.QTensor, cache_len, window: int,
                        cfg: ArchConfig, *, prefill: bool,
                        block_tables=None):
    """Attention over one layer of the packed cache.  ``ck``/``cv`` are
    views into the engine's cache and are written IN PLACE: a fixed-slot
    cache (B, S, Hkv, ...), or with ``block_tables`` (B, max_pages) int32
    the paged pool's slabs (P, page_len, Hkv, ...), where logical row t of
    sequence b lives at ``(block_tables[b, t // page_len], t % page_len)``
    (``serving.kvpool``).  The two differ only in that row address.

    Decode (``cache_len`` (B,) or a scalar, s == 1): quantize the new K/V
    row straight into each sequence's row ``cache_len`` (one launch) and
    run the decode-attention kernel (fixed or paged) with ``lengths =
    cache_len + 1``.  Idle paged lanes hold zeroed table rows and write
    into page 0, the pool's trash page, which every read masks.  Prefill
    (``cache_len`` the first row's position, any s): quantize every prompt
    row into its row, and attend over each sequence's *dequantized*
    logical rows with the plain ``attention`` — the values later decode
    steps read back, the same for both layouts.  A one-token prefill chunk
    is a prefill too, so chunking never changes which attention a row
    takes."""
    b, s = q.shape[:2]
    if prefill:
        cl = int(cache_len)
    else:
        cl = _decode_lengths(cache_len, b, s, q.device)
    ops.quantize_kv(knew, vnew, ck, cv, cl, block_tables=block_tables)
    if not prefill:
        lengths = cl + 1
        kw = dict(window=window, softcap=cfg.softcap_attn,
                  k_scale32=ck.scale32, v_scale32=cv.scale32)
        slabs = (q[:, 0], ck.payload, ck.scales, cv.payload, cv.scales)
        if block_tables is None:
            o = ops.attn_decode_packed(*slabs, lengths, **kw)
        else:
            o = ops.attn_decode_paged(*slabs, block_tables, lengths, **kw)
        return o[:, None].to(q.dtype)

    def logical(t):
        return t if block_tables is None else gather_pages(t, block_tables)

    k = qtensor.from_packed_rows(logical(ck.payload), logical(ck.scales),
                                 ck.scale32).dequantize()
    v = qtensor.from_packed_rows(logical(cv.payload), logical(cv.scales),
                                 cv.scale32).dequantize()
    return attention(q, k, v, causal_offset=cl, window=window,
                     softcap=cfg.softcap_attn, chunk=cfg.attn_chunk,
                     kv_valid_len=cl + s, pad_blocks=True)


def attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, positions,
               window: int, kv_cache, cache_len, prefill: bool,
               act: ActQuant = ActQuant(),
               block_tables=None) -> torch.Tensor:
    """The attention sub-layer over a cache.  ``kv_cache`` is one layer's
    (K, V): packed QTensors (the fused packed path; with ``block_tables``
    they are paged pool slabs) or bf16 tensors; either is updated in
    place.  ``prefill`` runs the rows from position ``cache_len``; else it
    is a one-token decode step at ``cache_len`` (B,) per sequence."""
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
        o = _attn_packed_cached(q, knew, vnew, ck, cv, cache_len, window,
                                cfg, prefill=prefill,
                                block_tables=block_tables)
    else:
        if prefill:
            cl = int(cache_len)
            ck[:, cl:cl + s] = knew.to(ck.dtype)
            cv[:, cl:cl + s] = vnew.to(cv.dtype)
        else:
            cl = _decode_lengths(cache_len, b, s, x.device)
            rows = torch.arange(b, device=x.device)
            ck[rows, cl] = knew[:, 0].to(ck.dtype)
            cv[rows, cl] = vnew[:, 0].to(cv.dtype)
        o = attention(q, ck, cv, causal_offset=cl, window=window,
                      softcap=cfg.softcap_attn, chunk=cfg.attn_chunk,
                      kv_valid_len=cl + s, pad_blocks=prefill)
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


def linear_init(d_in: int, d_out: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """A (d_in, d_out) f32 projection drawn N(0, 1/d_in), as the
    reference's ``linear_init``."""
    return torch.randn((d_in, d_out), generator=gen, device=device,
                       dtype=torch.float32) * (1.0 / math.sqrt(d_in))


def mlp_init(cfg: ArchConfig, gen: torch.Generator, device: torch.device,
             d_ff: int | None = None) -> dict:
    """The MLP's projections (``w_up``, ``w_down``, and ``w_gate`` for the
    gated types), drawn in that order; ``d_ff`` overrides ``cfg.d_ff``
    (an MoE layer's shared expert)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": linear_init(d, f, gen, device),
         "w_down": linear_init(f, d, gen, device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = linear_init(d, f, gen, device)
    return p


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
