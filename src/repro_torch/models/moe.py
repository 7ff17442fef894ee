"""Mixture-of-Experts layer for serving, without a mesh.

Counterpart of ``repro/models/moe.py`` in its ``ctx.mesh is None`` case:

  1. route in f32: softmax over the router logits, top-k (lower expert
     first on ties, as ``jax.lax.top_k``), gates renormalised;
  2. dispatch: choices sorted by expert (stable), rank within the expert
     -> a slot of an (E_stored, cap + 1, D) bf16 buffer, ``cap =
     max(ceil(T * k * cf / E), 4)``; a choice past ``cap`` is dropped and
     writes zeros into the discard row ``cap``;
  3. every stored expert's FFN over its buffer rows, one W4A16 launch per
     projection for the whole stack (``qtensor.qmm_experts``), where the
     reference maps ``qlinear`` over the experts;
  4. combine: each token's k weighted outputs added one after another in
     bf16, in the reference's scatter order (expert-sorted).

The capacity depends on the token count T, so a token's output depends on
its batchmates (padding, idle lanes, the chunk it prefills in), exactly as
in the reference.  Dispatch and combine run on the device with fixed
shapes: no host sync, no data-dependent shape, no atomics, so two runs are
bitwise equal.  The router's load-balance aux loss is not computed: serving
drops it; it comes back with training (ROADMAP §1 item 6).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qtensor
from repro_torch.models import base
from repro_torch.models.base import ArchConfig

__all__ = ["stored_experts", "moe_init", "moe_apply", "dispatch_buffer"]


def stored_experts(cfg: ArchConfig) -> int:
    """Expert rows as stored: padded to a multiple of 16 in ``"expert"``
    mode, as the reference stores them for its expert-parallel mesh
    (qwen2-moe: 60 -> 64); the dummy experts are zero and receive no
    tokens."""
    if cfg.ep_mode != "expert":
        return cfg.n_experts
    return -(-cfg.n_experts // 16) * 16


def moe_init(cfg: ArchConfig, gen: torch.Generator,
             device: torch.device) -> dict:
    """Random MoE weights from ``gen`` with the reference's distributions:
    router N(0, 1/d) (d, E) f32; expert stacks (E_stored, d, f) and
    (E_stored, f, d), N(0, 1/d_in), zero for the dummy experts; a shared
    SwiGLU expert of width ``shared_expert_ff`` when set."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    e_store = stored_experts(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * std

    def stack(shape, std):
        w = normal(shape, std)
        w[e:] = 0.0
        return w

    s = 1.0 / math.sqrt(d)
    p = {"router": normal((d, e), s),
         "w_up": stack((e_store, d, f), s),
         "w_gate": stack((e_store, d, f), s),
         "w_down": stack((e_store, f, d), 1.0 / math.sqrt(f))}
    if cfg.shared_expert_ff:
        p["shared"] = base.mlp_init(cfg, gen, device,
                                    d_ff=cfg.shared_expert_ff)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equal values (a stable descending sort;
    ``torch.topk`` leaves the order of ties unspecified on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, wr: torch.Tensor, cfg: ArchConfig):
    """Router in f32: top-k gates (renormalised) and expert indices (T, k).
    The logits are a full-f32 product (TF32 stays off:
    ``repro_torch.resolve_device``)."""
    logits = torch.matmul(x.to(torch.float32), wr.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.top_k)
    return gates / gates.sum(dim=-1, keepdim=True), idx


def _dispatch_indices(idx: torch.Tensor, e: int, cap: int):
    """Sort the T*k choices by expert (stable); a choice's rank within its
    expert is its capacity slot, ``cap`` when it is dropped.  Returns flat
    (T*k,) tok_s, e_s, slot, keep and order, as the reference."""
    t, k = idx.shape
    e_f = idx.reshape(-1)
    tok_f = torch.arange(t, device=idx.device).repeat_interleave(k)
    e_s, order = torch.sort(e_f, stable=True)
    tok_s = tok_f[order]
    starts = torch.searchsorted(e_s, torch.arange(e, device=idx.device),
                                side="left")
    pos = torch.arange(t * k, device=idx.device) - starts[e_s]
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    return tok_s, e_s, slot, keep, order


def dispatch_buffer(x: torch.Tensor, idx: torch.Tensor, n_experts: int,
                    e_store: int, cap: int):
    """The (e_store, cap + 1, D) capacity buffer of tokens x (T, D) routed
    to experts idx (T, k), and the dispatch indices.  A dropped choice
    writes zeros into its expert's discard row ``cap``, so every write
    there carries the same bytes; experts that received no choice keep
    zero rows."""
    ind = _dispatch_indices(idx, n_experts, cap)
    tok_s, e_s, slot, keep, _ = ind
    buf = torch.zeros((e_store, cap + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    buf[e_s, slot] = torch.where(keep[:, None], x[tok_s], 0.0)
    return buf, ind


def _expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """Every stored expert's SwiGLU FFN over its (C, D) buffer rows, each
    projection one launch for the whole stack; bf16 between projections
    (the reference's ``qlinear`` casts each output to the activation
    dtype)."""
    dt = buf.dtype
    up = qtensor.qmm_experts(buf, p["w_up"]).to(dt)
    gate = base.silu(qtensor.qmm_experts(buf, p["w_gate"]).to(dt))
    return qtensor.qmm_experts(gate * up, p["w_down"]).to(dt)


def _moe_local(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
               p: dict, cfg: ArchConfig) -> torch.Tensor:
    """x (T, D) bf16, gates (T, k) in x's dtype -> (T, D): dispatch into the
    capacity buffer, the expert FFNs, the combine."""
    t, d = x.shape
    k = idx.shape[1]
    e_store = p["w_up"].payload.shape[0]
    cap = max(int(math.ceil(t * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts)), 4)
    buf, (tok_s, e_s, slot, keep, order) = dispatch_buffer(
        x, idx, cfg.n_experts, e_store, cap)
    back = _expert_ffn(p, buf)
    gate_f = gates.reshape(-1)[order]
    per_choice = back[e_s, slot] * (gate_f * keep).to(x.dtype)[:, None]
    # the reference scatter-adds per_choice into zeros in sorted order;
    # each token's k sorted positions, ascending, give its terms in that
    # order, added one after another in bf16 (no atomics)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=x.device)
    terms, _ = torch.sort(rank.reshape(t, k), dim=-1)
    out = torch.zeros_like(x)
    for c in range(k):
        out = out + per_choice[terms[:, c]]
    return out


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              act: base.ActQuant = base.ActQuant()) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared expert.
    Packed expert stacks serve W4A16 only (``act.mode == "bf16"``)."""
    if act.mode != "bf16":
        raise NotImplementedError(
            f"act_quant={act.mode!r}: W4A4 for MoE experts is not ported "
            "yet (ROADMAP §1 item 5); serve MoE models W4A16")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx = _route(xt, p["router"], cfg)
    out = _moe_local(xt, gates.to(x.dtype), idx, p, cfg)
    if "shared" in p:
        out = out + base.mlp(p["shared"], xt, cfg, act)
    return out.reshape(b, s, d)
