"""Decoder-only transformer LM, dense and MoE families: init, KV cache,
batched single-slot prefill and one-token decode.

Counterpart of ``repro/models/transformer.py``.  Parameters are plain
dicts of tensors with one dict per layer in ``params["layers"]`` (the
reference stacks them for ``lax.scan``; here a Python loop walks the
list).  The KV cache is ``{"k", "v"}`` with a leading layer axis: packed
QTensors (payload (L, B, S, Hkv, dh/2), scales (L, B, S, Hkv, dh/16),
scale32 (L,)) for ``kv_quant="mixfp4"``, or bf16 tensors
(L, B, S, Hkv, dh).  The paged pool (``pages=``) holds page slabs
(L, P, page_len, Hkv, ...) instead, plus a ``"pages"`` block table
(B, max_len // page_len) int32.  Prefill and decode update the cache IN
PLACE and return it.  An MoE layer (``cfg.n_experts``) holds ``"moe"``
(``models.moe``) where a dense one holds ``"mlp"``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import qtensor
from repro_torch.models import base, moe
from repro_torch.models.base import ActQuant, ArchConfig, pack_projections

__all__ = ["TransformerLM"]


class TransformerLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP §1 "
                "item 5); the port serves the dense and MoE families")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda",
             pack: str | None = None) -> dict:
        """Random weights from ``seed`` on ``device`` (same distributions
        as the reference: projections N(0, 1/d_in), embedding N(0, 0.02^2),
        norms 1; MoE layers as ``moe.moe_init``).  The draws differ from
        ``jax.random``'s.  ``pack`` (a method, ``"mixfp4"``) packs each
        layer's projections as soon as they are drawn, so at most one
        layer is ever held dense (a full-width MoE stack is ~59 GB in
        f32); the bytes equal ``pack_projections`` of the dense tree."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, dh = cfg.d_model, cfg.dh
        layers = []
        for _ in range(cfg.n_layers):
            attn = {"wq": base.linear_init(d, cfg.n_heads * dh, gen, dev),
                    "wk": base.linear_init(d, cfg.n_kv_heads * dh, gen, dev),
                    "wv": base.linear_init(d, cfg.n_kv_heads * dh, gen, dev),
                    "wo": base.linear_init(cfg.n_heads * dh, d, gen, dev)}
            if cfg.qk_norm:
                attn["q_norm"] = torch.ones(dh, device=dev)
                attn["k_norm"] = torch.ones(dh, device=dev)
            layer = {"ln_attn": torch.ones(d, device=dev),
                     "attn": attn,
                     "ln_mlp": torch.ones(d, device=dev)}
            if cfg.n_experts:
                layer["moe"] = moe.moe_init(cfg, gen, dev)
            else:
                layer["mlp"] = base.mlp_init(cfg, gen, dev)
            if pack is not None:
                layer = pack_projections(layer, method=pack)[0]
            layers.append(layer)
        embed = torch.randn((base.padded_vocab(cfg.vocab), d), generator=gen,
                            device=dev, dtype=torch.float32) * 0.02
        return {"embed": embed, "layers": layers,
                "ln_f": torch.ones(d, device=dev)}

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 = global); gemma2 alternates local
        and global, every ``local_global_period``-th layer global."""
        cfg = self.cfg
        w = np.zeros((cfg.n_layers,), np.int32)
        if cfg.window and cfg.local_global_period:
            w[:] = cfg.window
            w[cfg.local_global_period - 1::cfg.local_global_period] = 0
        elif cfg.window:
            w[:] = cfg.window
        return w

    # ------------------------------------------------------------------
    # KV cache
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, *,
                   kv_quant: str | None = None, device="cuda",
                   pages: tuple[int, int] | None = None) -> dict:
        """Preallocated cache; ``kv_quant="mixfp4"`` holds it packed (zero
        bytes decode to exact zeros), ``None``/``"bf16"`` dense bf16.

        ``pages=(num_pages, page_len)`` builds the paged pool instead
        (``serving.kvpool``): K/V children are page slabs
        (L, P, page_len, Hkv, ...) shared by every request, and
        ``"pages"`` is a (B, max_len // page_len) int32 block table mapping
        each lane's logical pages to slab rows; zeroed, it points every
        lane at page 0, the pool's trash page."""
        cfg = self.cfg
        if pages is not None:
            if kv_quant != "mixfp4":
                raise ValueError("paged KV (pages=) requires "
                                 f"kv_quant='mixfp4', got {kv_quant!r}")
            num_pages, page_len = pages
            if page_len % 16 or max_len % page_len:
                raise ValueError(
                    f"page_len={page_len} must be a multiple of 16 and "
                    f"divide max_len={max_len}")
        dev = resolve_device(device)
        rows = ((cfg.n_layers, batch_size, max_len, cfg.n_kv_heads)
                if pages is None
                else (cfg.n_layers, num_pages, page_len, cfg.n_kv_heads))
        if kv_quant in (None, "bf16"):
            return {"k": torch.zeros((*rows, cfg.dh), dtype=torch.bfloat16,
                                     device=dev),
                    "v": torch.zeros((*rows, cfg.dh), dtype=torch.bfloat16,
                                     device=dev)}
        if kv_quant != "mixfp4":
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(expected None, 'bf16' or 'mixfp4')")
        if cfg.dh % 16:
            raise ValueError(f"kv_quant='mixfp4' needs head_dim % 16 == 0, "
                             f"got {cfg.dh}")

        def packed():
            return qtensor.QTensor(
                torch.zeros((*rows, cfg.dh // 2), dtype=torch.uint8,
                            device=dev),
                torch.zeros((*rows, cfg.dh // 16), dtype=torch.uint8,
                            device=dev),
                torch.full((cfg.n_layers,), base.KV_SCALE32,
                           dtype=torch.float32, device=dev),
                method="mixfp4", layout=qtensor.BlockLayout1D(-1, 16),
                shape=(*rows[1:], cfg.dh), dtype="float32")

        cache = {"k": packed(), "v": packed()}
        if pages is not None:
            cache["pages"] = torch.zeros((batch_size, max_len // page_len),
                                         dtype=torch.int32, device=dev)
        return cache

    @staticmethod
    def _layer(cache_leaf, layer: int, slot: int | None = None):
        """One layer of a cache leaf (and optionally one batch slot), as a
        view that in-place writes go through."""
        sl = slice(None) if slot is None else slice(slot, slot + 1)
        if isinstance(cache_leaf, qtensor.QTensor):
            return cache_leaf.replace(
                payload=cache_leaf.payload[layer, sl],
                scales=cache_leaf.scales[layer, sl],
                scale32=cache_leaf.scale32[layer])
        return cache_leaf[layer, sl]

    def reset_slot(self, cache: dict, i: int) -> dict:
        """Zero slot ``i``'s rows in place (zero packed bytes decode to
        exact zeros) so a new request starts with no stale K/V.  On the
        paged pool only the lane's block-table row is cleared (to the trash
        page): pool bytes are never zeroed, since unmapped rows are
        unreachable and every mapped row is freshly written or a shared
        immutable prefix page."""
        if "pages" in cache:
            cache["pages"][i] = 0
            return cache
        for leaf in (cache["k"], cache["v"]):
            if isinstance(leaf, qtensor.QTensor):
                leaf.payload[:, i] = 0
                leaf.scales[:, i] = 0
            else:
                leaf[:, i] = 0
        return cache

    # ------------------------------------------------------------------
    # prefill / decode
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens].to(torch.bfloat16)
        if self.cfg.emb_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _run_layers_cached(self, params, x, cache, cache_len, positions,
                           act: ActQuant, *, prefill: bool,
                           slot: int | None = None, block_tables=None):
        cfg = self.cfg
        windows = self.layer_windows()
        for li, lp in enumerate(params["layers"]):
            h = base.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
            kv = (self._layer(cache["k"], li, slot),
                  self._layer(cache["v"], li, slot))
            x = x + base.attn_apply(lp["attn"], h, cfg, positions=positions,
                                    window=int(windows[li]), kv_cache=kv,
                                    cache_len=cache_len, prefill=prefill,
                                    act=act, block_tables=block_tables)
            h = base.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
            if cfg.n_experts:
                x = x + moe.moe_apply(lp["moe"], h, cfg, act)
            else:
                x = x + base.mlp(lp["mlp"], h, cfg, act)
        return base.rms_norm(x, params["ln_f"], cfg.norm_eps)

    def prefill_slot(self, params, tokens: torch.Tensor, cache: dict,
                     slot: int, true_len: int | None = None,
                     act: ActQuant = ActQuant(),
                     start_pos: int = 0):
        """Run a prompt (1, P) into cache slot ``slot`` in one pass.
        ``true_len`` supports prompt bucketing: ``tokens`` is padded up the
        ladder and the logits come from position ``true_len - 1``; padded
        rows are causally invisible to the real ones and masked at decode
        until overwritten.  ``start_pos`` starts the prompt at that cache
        position, past rows already written (a prefix served from the pool,
        or earlier chunks): positions and causality shift by it.  On the
        paged pool the slot's view is its block-table row and the rows
        scatter into its own pages.  ``act`` is the activation format of
        every projection.  Returns (logits (1, V), cache)."""
        cfg = self.cfg
        p_len = tokens.shape[1]
        start = int(start_pos)
        x = self._embed(params, tokens)
        positions = torch.arange(start, start + p_len,
                                 device=x.device)[None, :]
        if "pages" in cache:
            x = self._run_layers_cached(
                params, x, cache, start, positions, act, prefill=True,
                block_tables=cache["pages"][slot:slot + 1])
        else:
            x = self._run_layers_cached(params, x, cache, start, positions,
                                        act, prefill=True, slot=slot)
        last = p_len if true_len is None else int(true_len)
        logits = base.lm_logits(x[:, last - 1], params["embed"],
                                cfg.softcap_final, vocab=cfg.vocab)
        return logits, cache

    def decode_step(self, params, tokens: torch.Tensor, cache: dict,
                    cache_len: torch.Tensor, act: ActQuant = ActQuant()):
        """One token for every sequence: tokens (B,), cache_len (B,) per
        sequence (or a scalar).  ``act`` is the activation format of every
        projection.  Returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = self._embed(params, tokens[:, None])
        positions = base.decode_positions(cache_len, x.shape[0])
        x = self._run_layers_cached(params, x, cache, cache_len, positions,
                                    act, prefill=False,
                                    block_tables=cache.get("pages"))
        logits = base.lm_logits(x[:, 0], params["embed"], cfg.softcap_final,
                                vocab=cfg.vocab)
        return logits, cache
