"""Greedy continuous-batching serving engine over packed MixFP4 weights and
an optional packed MixFP4 KV cache.

Counterpart of ``repro/serving/engine.py``, fixed-slot path, for the
dense and MoE families: projection
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

``kv_pool=P`` serves the packed KV cache as a pool of P pages of
``kv_page_len`` rows (``serving.kvpool``): per-request block tables,
copy-on-write prefix caching (a prompt whose prefix is cached prefills
only its suffix) and LRU eviction; decode reads the pool through the paged
attention kernel.  ``prefill_chunk=T`` splits each admission's prefill
into T-token chunks, one per ``step()`` ahead of the decode
(``serving.scheduler``).  Both leave the emitted streams bitwise those of
the fixed-slot, whole-prompt engine.

An MoE model (``family="moe"``) serves W4A16 only.  Its capacity router
couples the rows of one pass (the capacity is a function of the token
count, pads and idle lanes included), so for it neither bucketing nor
chunking leaves the streams unchanged, and its pool is a plain page
allocator without prefix caching, as in the reference.

``save_weights`` writes the packed parameters as a checkpoint in the
reference's format (``checkpoint.CheckpointManager.save_packed``, the
layers stacked as the reference stacks them), and ``load_weights``
restores one, written by either package, onto the engine's device.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the request lifecycle (queue, faults, deadlines, journal, watchdog,
metrics, retries of a checkpoint read, the fused -> 2-pass and paged ->
fixed-slot degradation rungs), and mesh serving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import hadamard, qtensor
from repro_torch.models import build_model
from repro_torch.models.base import (ACT_QUANT_MODES, ActQuant, ArchConfig,
                                     pack_projections)
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.scheduler import ChunkedPrefillScheduler

__all__ = ["Request", "ServeEngine"]

REASON_MAX_NEW = "max_new_tokens"
REASON_NAN_LOGITS = "nan_logits"

# engine argument -> the ROADMAP item that ports it
_NOT_PORTED = {
    "faults": "§1 item 4 (serving lifecycle)",
    "journal_dir": "§1 item 4 (serving lifecycle)",
    "hung_step_budget_ms": "§1 item 4 (serving lifecycle)",
    "deadline_ms": "§1 item 4 (serving lifecycle)",
    "ttft_budget_ms": "§1 item 4 (serving lifecycle)",
    "retry_max": "§1 item 4 (serving lifecycle: the checkpoint_read retry "
                 "and fault boundary)",
    "mesh": "§1 item 7 (multi-GPU)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None
    # first greedy token, produced by the admission prefill (its last chunk
    # when chunked) and emitted by the next step(); None while prefilling
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


def _packed_stats(tree) -> tuple[int, int]:
    """(wire bytes, bf16-equivalent bytes) over the QTensor leaves of a
    parameter tree, as ``pack_projections`` counts them."""
    packed = dense = 0
    for qt in _projections(tree):
        packed += qt.nbytes
        dense += int(np.prod(qt.shape)) * qt.batch_size() * 2
    return packed, dense


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
    """Greedy continuous-batching decoder for the dense and MoE
    transformers."""

    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 8,
                 max_len: int = 512, pack_weights: bool = True,
                 method: str = "mixfp4", kv_quant: str | None = None,
                 prefill_buckets: str | None = "auto", device="cuda",
                 act_quant: str | None = None, act_rht: bool = False,
                 kv_pool: int | None = None, kv_page_len: int = 16,
                 prefill_chunk: int | None = None, faults=None,
                 journal_dir: str | None = None,
                 hung_step_budget_ms: float | None = None,
                 deadline_ms: float | None = None,
                 ttft_budget_ms: float | None = None,
                 retry_max: int | None = None, mesh=None):
        given = {"faults": faults is not None,
                 "journal_dir": journal_dir is not None,
                 "hung_step_budget_ms": hung_step_budget_ms is not None,
                 "deadline_ms": deadline_ms is not None,
                 "ttft_budget_ms": ttft_budget_ms is not None,
                 "retry_max": retry_max is not None,
                 "mesh": mesh is not None}
        for arg, on in given.items():
            if on:
                raise NotImplementedError(
                    f"ServeEngine({arg}=...) is not ported yet "
                    f"(ROADMAP {_NOT_PORTED[arg]})")
        if kv_quant not in (None, "bf16", "mixfp4"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(expected None, 'bf16' or 'mixfp4')")
        if kv_pool is not None:
            if kv_quant != "mixfp4":
                raise ValueError(
                    "kv_pool= is the paged *packed* KV path; it requires "
                    f"kv_quant='mixfp4' (got {kv_quant!r})")
            if kv_page_len % 16 or max_len % kv_page_len:
                raise ValueError(
                    f"kv_page_len={kv_page_len} must be a multiple of 16 "
                    f"(the MixFP4 block) and divide max_len={max_len}")
        _validate_act(act_quant, act_rht, pack_weights)
        if cfg.family == "moe" and act_quant not in (None, "bf16"):
            raise NotImplementedError(
                f"act_quant={act_quant!r}: W4A4 for MoE experts is not "
                "ported yet (ROADMAP §1 item 5); serve MoE models W4A16")
        if not pack_weights:
            raise NotImplementedError(
                "dense qdq-simulated serving belongs to the training slice "
                "(ROADMAP §1 item 6); serve packed weights")
        if prefill_buckets not in (None, "off", "auto", "pow2-64"):
            raise ValueError(f"unknown prefill_buckets {prefill_buckets!r}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be >= 1 token")
            if prefill_buckets == "pow2-64":
                raise ValueError(
                    "prefill_chunk= already runs every chunk at ONE "
                    "static shape (the chunk budget); it replaces the "
                    "prefill_buckets ladder — drop "
                    "prefill_buckets='pow2-64'")
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
        # the paged pool (page 0 is its trash page); prefix caching needs a
        # suffix prefill bitwise the whole one, which only the dense family
        # gives (MoE's capacity couples the rows): the others get a plain
        # page allocator and always prefill from position 0
        self.kv_page_len = kv_page_len
        if kv_pool is not None:
            self.kv_pool = KVPool(kv_pool, kv_page_len,
                                  enable_prefix=cfg.family == "dense")
            self.cache = self.model.init_cache(
                batch_size, max_len, device=self.device, kv_quant="mixfp4",
                pages=(kv_pool, kv_page_len))
            self._slot_pages: list[list[int] | None] = [None] * batch_size
        else:
            self.kv_pool = None
            self.cache = self.model.init_cache(
                batch_size, max_len, device=self.device,
                kv_quant="mixfp4" if self.kv_quant == "mixfp4" else None)
        self.lengths = np.zeros((batch_size,), np.int32)
        self.slots: list[Request | None] = [None] * batch_size
        if prefill_buckets == "auto":
            prefill_buckets = "pow2-64" if prefill_chunk is None else None
        self.prefill_buckets = (None if prefill_buckets in (None, "off")
                                else "pow2-64")
        self.prefill_chunk = prefill_chunk
        self.scheduler = (ChunkedPrefillScheduler(prefill_chunk)
                          if prefill_chunk is not None else None)
        self.admissions = 0
        self.decode_steps = 0
        self.prefill_dispatches = 0    # prefill passes (chunks included)
        self.max_concurrent = 0        # peak occupied slots seen by step()
        self._step_prefill_tokens = 0  # prompt tokens spent this step

    # ------------------------------------------------------------------
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV cache (packed leaves count wire bytes; the
        paged pool's block table counts too)."""
        total = 0
        for leaf in self.cache.values():
            total += (leaf.nbytes if isinstance(leaf, qtensor.QTensor)
                      else leaf.numel() * leaf.element_size())
        return total

    # ------------------------------------------------------------------
    # packed-weight checkpoints, in the reference's format
    # ------------------------------------------------------------------
    def save_weights(self, directory: str, step: int = 0):
        """Write the packed parameters as checkpoint ``step`` of
        ``directory``: stacked into the reference's layout on the host,
        then ``save_packed`` (blocking)."""
        CheckpointManager(directory).save_packed(
            step, convert.packed_to_stacked(self.params), blocking=True)

    def load_weights(self, directory: str, step: int | None = None):
        """Restore a packed checkpoint (the latest step by default), written
        by this engine or by the reference's, onto the engine's device:
        per-array digests and scale planes verified, the layers split
        again, the storage stats recomputed from what was restored.  A read
        that fails raises at once (the reference retries it behind its
        fault boundary, ROADMAP §1 item 4)."""
        restored, _ = CheckpointManager(directory).restore_packed(step)
        if self.act_rht and not (isinstance(restored, dict)
                                 and "rht_signs" in restored):
            raise ValueError(
                "act_rht=True engine restored a checkpoint with no "
                "'rht_signs' entry: the packed weights were not "
                "Hadamard-transformed at pack time "
                "(pack_projections(act_rht=True)), so the activation RHT "
                "would no longer cancel in the GEMM")
        params = convert.packed_from_numpy(restored, self.cfg,
                                           device=self.device)
        _check_rht_signs(params, self.act_rht)
        self.params = params
        self.packed_bytes, self.dense_bytes = _packed_stats(params)
        self.compression = (self.dense_bytes / self.packed_bytes
                            if self.packed_bytes else 1.0)

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
        if self.kv_pool is not None:
            need = self.kv_pool.pages_needed(len(req.prompt),
                                             req.max_new_tokens)
            if need > self.kv_pool.pages_total:
                raise ValueError(
                    f"request {req.uid} needs {need} pool pages but the "
                    f"pool holds {self.kv_pool.pages_total} (deferring it "
                    "would livelock: no amount of draining frees enough)")

    def add_request(self, req: Request) -> bool:
        """Admit ``req`` into a free slot; False (and nothing consumed) when
        every slot is busy or the pool cannot cover the request yet.
        Without ``prefill_chunk`` the admission prefills now; with it the
        prompt prefills one chunk per ``step()``.  A prompt whose prefill
        logits are not finite ends at once (``finish_reason="nan_logits"``).
        """
        self._validate(req)
        i = next((i for i, s in enumerate(self.slots) if s is None), None)
        if i is None:
            return False
        start = 0
        if self.kv_pool is None:
            self.cache = self.model.reset_slot(self.cache, i)
        else:
            # map cached prefix pages and allocate the rest (evicting LRU
            # cached pages as needed); a pool that cannot cover the
            # request defers it
            adm = self.kv_pool.acquire(req.prompt, req.max_new_tokens)
            if adm is None:
                return False
            self._slot_pages[i] = adm.pages
            row = torch.zeros(self.cache["pages"].shape[1], dtype=torch.int32)
            row[:len(adm.pages)] = torch.tensor(adm.pages, dtype=torch.int32)
            self.cache["pages"][i] = row.to(self.device)
            if adm.cow is not None:
                self._cow_copy(*adm.cow)
            start = adm.shared_len
        self.slots[i] = req
        # a chunked admission's length tracks its chunk cursor, so the
        # batched decode's junk row for this lane lands at the next chunk's
        # first row, which that chunk overwrites before anything reads it
        self.lengths[i] = start
        if self.scheduler is not None:
            self.scheduler.enqueue(req.uid, i, req, len(req.prompt),
                                   start_pos=start)
            return True
        logits = self._prefill_slot(i, req, start)
        self._prefill_done(i, req, logits)
        return True

    def _cow_copy(self, src: int, dst: int):
        """The eager copy-on-write of a partial prefix hit: page ``src``'s
        packed K and V bytes into page ``dst``, every layer."""
        for leaf in (self.cache["k"], self.cache["v"]):
            leaf.payload[:, dst] = leaf.payload[:, src]
            leaf.scales[:, dst] = leaf.scales[:, src]

    def has_work(self) -> bool:
        return any(s is not None for s in self.slots)

    def _prefill_slot(self, i: int, req: Request, start_pos: int = 0):
        """One prefill pass over ``req.prompt[start_pos:]`` (the suffix
        after a prefix hit), padded up the bucket ladder when bucketing;
        returns its last real position's logits."""
        toks = np.asarray(req.prompt, np.int64)[start_pos:]
        s_len = len(toks)              # >= 1: a prefix hit stops at p - 1
        if self.prefill_buckets:
            pb = self.bucket_len(s_len, self.max_len - start_pos)
            if pb > s_len:
                toks = np.pad(toks, (0, pb - s_len))
        return self._prefill(i, toks, s_len, start_pos)

    def _prefill(self, i: int, toks: np.ndarray, n_real: int, start: int):
        tokens = torch.as_tensor(toks[None, :], device=self.device)
        logits, self.cache = self.model.prefill_slot(
            self.params, tokens, self.cache, i, true_len=n_real, act=self.act,
            start_pos=start)
        self.prefill_dispatches += 1
        self._step_prefill_tokens += n_real
        return logits

    def _prefill_done(self, i: int, req: Request, logits: torch.Tensor):
        """The admission's prompt is in the cache: stage its first token,
        and register a paged prompt's pages for prefix hits (their bytes
        are final now; eager COW means no shared page is written later)."""
        self.lengths[i] = len(req.prompt)
        self.admissions += 1
        finite, nxt = torch.stack([torch.isfinite(logits[0]).all().long(),
                                   torch.argmax(logits[0])]).tolist()
        if not finite:
            # as in step(): a row whose logits are not finite ends its
            # request with no token, and frees the slot
            self._finish(i, REASON_NAN_LOGITS)
            return
        req._next = nxt
        if self.kv_pool is not None:
            self.kv_pool.insert(req.prompt, self._slot_pages[i])

    def _run_chunk(self):
        """Spend this step's chunk budget on the FIFO-head prefill job: one
        prefill pass of ``prefill_chunk`` prompt tokens from its cursor
        (the final partial chunk pads up to the budget, never past
        max_len)."""
        job = self.scheduler.head()
        if job is None:
            return
        req, i, start = job.req, job.slot, job.cursor
        n_real = min(self.scheduler.chunk, job.p_len - start)
        pad_to = min(self.scheduler.chunk, self.max_len - start)
        toks = np.asarray(req.prompt, np.int64)[start:start + n_real]
        if pad_to > n_real:
            toks = np.pad(toks, (0, pad_to - n_real))
        logits = self._prefill(i, toks, n_real, start)
        if self.scheduler.advance(job, n_real):
            self._prefill_done(i, req, logits)
        else:
            self.lengths[i] = job.cursor

    def _finish(self, i: int, reason: str):
        """End slot ``i``'s request and free the slot.  A paged slot
        releases its pages (tree-registered ones park in the LRU, still
        servable as prefix hits) and points its table row at the trash
        page, so the idle lane's decode writes never land in a page the
        pool may grant again."""
        req = self.slots[i]
        req.done = True
        req.finish_reason = reason
        self.slots[i] = None
        self.lengths[i] = 0
        if self.kv_pool is not None:
            self.kv_pool.release(self._slot_pages[i])
            self._slot_pages[i] = None
            self.cache["pages"][i] = 0

    def pool_report(self) -> dict | None:
        """Pool occupancy, prefix-hit and eviction counters (None when the
        engine is not paged)."""
        return None if self.kv_pool is None else self.kv_pool.stats()

    def _note_step(self, decode_rows: int):
        """The step's line of the scheduler's prefill-token ledger (the one
        source of ``max_prefill_tokens_per_step``).  Admissions prefilled
        between steps count toward the next step, whose decode they
        delayed."""
        spent, self._step_prefill_tokens = self._step_prefill_tokens, 0
        if self.scheduler is not None:
            self.scheduler.note_step(spent, decode_rows)

    def step(self) -> list[tuple[int, int]]:
        """One chunk of the head prefill job (when chunking), then one
        decode step for every running slot, each at its own cache position;
        returns the (uid, token) pairs emitted.  A freshly prefilled
        request first emits its prefill token, then decodes.  A row whose
        logits are not finite ends that request (no token)."""
        if self.scheduler is not None:
            self._run_chunk()
        self.max_concurrent = max(self.max_concurrent,
                                  sum(r is not None for r in self.slots))
        toks = np.zeros((self.batch_size,), np.int64)
        out, active = [], []
        for i, req in enumerate(self.slots):
            if req is None or req._next is None:
                continue               # free, or a chunked prefill's lane
            if not req.generated:
                req.generated.append(req._next)
                out.append((req.uid, req._next))
                if len(req.generated) >= req.max_new_tokens:
                    self._finish(i, REASON_MAX_NEW)
                    continue
            toks[i] = req.generated[-1]
            active.append(i)
        if not active:
            self._note_step(0)
            return out
        # every lane decodes at its own length: idle lanes at row 0 of
        # their free slot (the trash page when paged), a lane still
        # prefilling at its chunk cursor
        logits, self.cache = self.model.decode_step(
            self.params, torch.as_tensor(toks, device=self.device),
            self.cache, torch.as_tensor(self.lengths, device=self.device),
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
        self._note_step(len(active))
        return out
