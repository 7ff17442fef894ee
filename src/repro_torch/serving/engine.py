"""Greedy continuous-batching serving engine over packed MixFP4 weights and
an optional packed MixFP4 KV cache.

Counterpart of ``repro/serving/engine.py``, fixed-slot path: projection
weights are held only as packed QTensors and every projection runs the
W4A16 kernel, or with ``act_quant`` one of the W4A4 paths (``"mixfp4"``:
per-row activation quantization fused into the GEMM; ``act_rht=True``
adds the serve-time grouped RHT on both operands); with
``kv_quant="mixfp4"`` every decode step quantizes the new K/V rows with
the row-quantizer kernel, scatters their bytes into the cache in place and
reads the cache with the decode-attention kernel.
Admissions prefill the whole prompt in one pass (``prefill_slot``); with
``prefill_buckets`` (the default ``"auto"``) the prompt pads up the
pow-2/64-step length ladder, which leaves the emitted stream bitwise
unchanged.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the paged KV pool, chunked prefill, the request lifecycle (faults,
deadlines, journal, watchdog, metrics, the fused -> 2-pass degradation
rung), and mesh serving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hadamard, qtensor
from repro_torch.models import build_model
from repro_torch.models.base import (ACT_QUANT_MODES, ActQuant, ArchConfig,
                                     pack_projections)

__all__ = ["Request", "ServeEngine"]

REASON_MAX_NEW = "max_new_tokens"
REASON_NAN_LOGITS = "nan_logits"

# engine argument -> the ROADMAP item that ports it
_NOT_PORTED = {
    "kv_pool": "§1 item 7 (paged and chunked serving)",
    "prefill_chunk": "§1 item 7 (paged and chunked serving)",
    "faults": "§1 item 9 (serving lifecycle)",
    "journal_dir": "§1 item 9 (serving lifecycle)",
    "hung_step_budget_ms": "§1 item 9 (serving lifecycle)",
    "deadline_ms": "§1 item 9 (serving lifecycle)",
    "ttft_budget_ms": "§1 item 9 (serving lifecycle)",
    "mesh": "§1 item 11 (multi-GPU)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None
    # first greedy token, produced by the admission prefill and emitted by
    # the first step()
    _next: int | None = None


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _validate_act(act_quant, act_rht: bool, pack_weights: bool):
    """The reference engine's checks of ``act_quant`` and ``act_rht``, with
    its messages."""
    if act_quant not in (None, *ACT_QUANT_MODES):
        raise ValueError(
            f"unknown act_quant {act_quant!r} (expected None, 'bf16', "
            "'mixfp4' (fused per-row quantize+GEMM), "
            "'mixfp4-2pass-rowscale' (its two-dispatch bitwise oracle), "
            "'mixfp4-2pass' (the legacy per-tensor composition), or "
            "the 'mixfp4-qdq' debugging oracle)")
    if act_quant not in (None, "bf16") and not pack_weights:
        raise ValueError(
            "act_quant='mixfp4' is the W4A4 path — both GEMM operands "
            "on the wire format — which needs packed weights; drop "
            "pack_weights=False")
    if act_rht:
        if act_quant not in ("mixfp4", "mixfp4-2pass-rowscale"):
            raise ValueError(
                "act_rht=True rotates activations AND packed weights "
                "with a shared grouped Hadamard, which only the "
                "per-row W4A4 modes consume; it requires "
                "act_quant='mixfp4' or 'mixfp4-2pass-rowscale' "
                f"(got {act_quant!r})")
        if not pack_weights:
            raise ValueError(
                "act_rht=True transforms the weights at pack time "
                "(pack_projections(act_rht=True)); drop "
                "pack_weights=False")


def _projections(tree):
    """Every packed projection leaf of a parameter tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _projections(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _projections(v)
    elif isinstance(tree, qtensor.QTensor):
        yield tree


def _check_rht_signs(params: dict, act_rht: bool):
    """Rotated weights and rotated activations go together: with
    ``act_rht`` every projection's logical K must carry its
    ``serve_signs(K)`` diagonal in ``params["rht_signs"]`` (the record
    ``pack_projections(act_rht=True)`` writes, in the port or the
    reference); without it the tree must carry none."""
    recorded = params.get("rht_signs", {})
    if not act_rht:
        if recorded:
            raise ValueError(
                "these weights were rotated at pack time (the tree has "
                "'rht_signs'); serve them with act_rht=True")
        return
    for k in {w.shape[0] for w in _projections(params["layers"])}:
        signs = recorded.get(str(k))
        if signs is None or not np.array_equal(
                np.asarray(signs.cpu()), hadamard.serve_signs(k)):
            raise ValueError(
                f"act_rht=True needs projections rotated at pack time with "
                f"serve_signs({k}); the tree's 'rht_signs' has "
                f"{'no' if signs is None else 'another'} entry for K={k} "
                "(pack dense weights, or bytes packed with act_rht=True)")


class ServeEngine:
    """Greedy continuous-batching decoder for the dense transformer."""

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 8,
                 max_len: int = 512, pack_weights: bool = True,
                 method: str = "mixfp4", kv_quant: str | None = None,
                 prefill_buckets: str | None = "auto", device="cuda",
                 act_quant: str | None = None, act_rht: bool = False,
                 kv_pool: int | None = None,
                 prefill_chunk: int | None = None, faults=None,
                 journal_dir: str | None = None,
                 hung_step_budget_ms: float | None = None,
                 deadline_ms: float | None = None,
                 ttft_budget_ms: float | None = None, mesh=None):
        given = {"kv_pool": kv_pool is not None,
                 "prefill_chunk": prefill_chunk is not None,
                 "faults": faults is not None,
                 "journal_dir": journal_dir is not None,
                 "hung_step_budget_ms": hung_step_budget_ms is not None,
                 "deadline_ms": deadline_ms is not None,
                 "ttft_budget_ms": ttft_budget_ms is not None,
                 "mesh": mesh is not None}
        for arg, on in given.items():
            if on:
                raise NotImplementedError(
                    f"ServeEngine({arg}=...) is not ported yet "
                    f"(ROADMAP {_NOT_PORTED[arg]})")
        if kv_quant not in (None, "bf16", "mixfp4"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(expected None, 'bf16' or 'mixfp4')")
        _validate_act(act_quant, act_rht, pack_weights)
        if not pack_weights:
            raise NotImplementedError(
                "dense qdq-simulated serving belongs to the training slice "
                "(ROADMAP §1 item 10); serve packed weights")
        if prefill_buckets not in (None, "off", "auto", "pow2-64"):
            raise ValueError(f"unknown prefill_buckets {prefill_buckets!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.batch_size = batch_size
        self.max_len = max_len
        self.kv_quant = kv_quant or "bf16"
        self.act_quant = act_quant or "bf16"
        self.act_rht = act_rht
        self.act = ActQuant(self.act_quant, act_rht)
        # projections become packed QTensors (leaves already packed, e.g.
        # bytes carried over from another engine, pass through unchanged);
        # with act_rht the dense ones are rotated along K first
        self.params, self.packed_bytes, self.dense_bytes = pack_projections(
            _to_device(params, self.device), method=method, act_rht=act_rht)
        _check_rht_signs(self.params, act_rht)
        self.compression = (self.dense_bytes / self.packed_bytes
                            if self.packed_bytes else 1.0)
        self.cache = self.model.init_cache(
            batch_size, max_len, device=self.device,
            kv_quant="mixfp4" if self.kv_quant == "mixfp4" else None)
        self.lengths = np.zeros((batch_size,), np.int32)
        self.slots: list[Request | None] = [None] * batch_size
        self.prefill_buckets = (None if prefill_buckets in (None, "off")
                                else "pow2-64")
        self.admissions = 0
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV cache (packed leaves count wire bytes)."""
        total = 0
        for leaf in (self.cache["k"], self.cache["v"]):
            total += (leaf.nbytes if isinstance(leaf, qtensor.QTensor)
                      else leaf.numel() * leaf.element_size())
        return total

    @staticmethod
    def bucket_len(p_len: int, max_len: int) -> int:
        """The pow-2/64-step prompt-length ladder: next power of two from
        8 below 64, then 64-step rungs, clamped to the cache length."""
        b = 8
        while b < min(p_len, 64):
            b *= 2
        if p_len > 64:
            b = -(-p_len // 64) * 64
        return min(b, max_len)

    def _validate(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # the final generated token is emitted but never fed back
        if len(req.prompt) + req.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"request {req.uid} needs {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens but the cache holds "
                f"max_len={self.max_len}")

    def add_request(self, req: Request) -> bool:
        """Admit ``req`` into a free slot (prefilling it now); False when
        every slot is busy.  A prompt whose prefill logits are not finite
        is admitted and ends at once (``finish_reason="nan_logits"``)."""
        self._validate(req)
        free = next((i for i, s in enumerate(self.slots) if s is None), None)
        if free is None:
            return False
        self.slots[free] = req
        self.lengths[free] = 0
        self.cache = self.model.reset_slot(self.cache, free)
        self._prefill_slot(free, req)
        return True

    def has_work(self) -> bool:
        return any(s is not None for s in self.slots)

    def _prefill_slot(self, i: int, req: Request):
        toks = np.asarray(req.prompt, np.int64)
        s_len = len(toks)
        if self.prefill_buckets:
            pb = self.bucket_len(s_len, self.max_len)
            if pb > s_len:
                toks = np.pad(toks, (0, pb - s_len))
        tokens = torch.as_tensor(toks[None, :], device=self.device)
        logits, self.cache = self.model.prefill_slot(
            self.params, tokens, self.cache, i, true_len=s_len, act=self.act)
        self.lengths[i] = s_len
        self.admissions += 1
        finite, nxt = torch.stack([torch.isfinite(logits[0]).all().long(),
                                   torch.argmax(logits[0])]).tolist()
        if not finite:
            # as in step(): a row whose logits are not finite ends its
            # request with no token, and frees the slot
            self._finish(i, REASON_NAN_LOGITS)
            return
        req._next = nxt

    def _finish(self, i: int, reason: str):
        req = self.slots[i]
        req.done = True
        req.finish_reason = reason
        self.slots[i] = None

    def step(self) -> list[tuple[int, int]]:
        """One decode step for every active slot, each at its own cache
        position; returns the (uid, token) pairs emitted.  A freshly
        prefilled request first emits its prefill token, then decodes.  A
        row whose logits are not finite ends that request (no token)."""
        toks = np.zeros((self.batch_size,), np.int64)
        out, active = [], []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if not req.generated:
                req.generated.append(req._next)
                out.append((req.uid, req._next))
                if len(req.generated) >= req.max_new_tokens:
                    self._finish(i, REASON_MAX_NEW)
                    continue
            toks[i] = req.generated[-1]
            active.append(i)
        if not active:
            return out
        # idle lanes decode a dummy token at row 0 of their (free) slot,
        # which the next admission zeroes
        lens = np.zeros((self.batch_size,), np.int64)
        lens[active] = self.lengths[active]
        logits, self.cache = self.model.decode_step(
            self.params, torch.as_tensor(toks, device=self.device),
            self.cache, torch.as_tensor(lens, device=self.device),
            act=self.act)
        next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        finite = torch.isfinite(logits).all(dim=-1).cpu().numpy()
        self.decode_steps += 1
        for i in active:
            req = self.slots[i]
            if not finite[i]:
                self._finish(i, REASON_NAN_LOGITS)
                continue
            tok = int(next_toks[i])
            req.generated.append(tok)
            self.lengths[i] += 1
            out.append((req.uid, tok))
            if len(req.generated) >= req.max_new_tokens:
                self._finish(i, REASON_MAX_NEW)
        return out
