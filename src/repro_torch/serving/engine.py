"""Greedy continuous-batching serving engine over packed MixFP4 weights and
an optional packed MixFP4 KV cache.

Counterpart of ``repro/serving/engine.py``, for the dense and MoE
families: projection
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

The request lifecycle is the reference's: ``submit`` puts a request on a
bounded FIFO queue (typed rejections, ``QueueFullError`` past
``max_queue``), and each ``step()`` expires deadlines and TTFT budgets,
pumps the queue into free slots, then decodes; every request ends in one
typed terminal state (:class:`RequestState`, ``finish_reason``) and
``cancel`` ends one early.  A seeded ``faults`` injector
(``serving.faults``) fires at the engine's boundaries — ``prefill``,
``decode``, ``pool_acquire``, ``cow_copy``, ``checkpoint_read``,
``process_crash`` — and the engine then runs on the injector's virtual
clock: transients back off (capped, exponential) and retry, a fatal fault
fails its one victim and rolls back its slot and pages, a poisoned row
fails its request with ``nan_logits`` while its batchmates decode on.  Two
degradation rungs keep serving the same streams: an injected ``dispatch``
fault (or a watchdog ``degrade`` verdict) moves the fused W4A4 GEMM to
the quantizer plus the packed W4A4 GEMM (``"mixfp4-2pass-rowscale"``,
bitwise the fused spelling), and ``degrade_after_deferrals`` admissions
deferred by an exhausted pool move the paged pool to fixed slots, each
live request replaying its history (``_replay_histories``: the prompt
through the prefill its admission used, the generated tokens through
``decode_step`` in lockstep, so every K/V row is bitwise the one decode
first wrote, for the dense family).  ``hung_step_budget_ms`` arms the
step watchdog (``serving.watchdog``); ``metrics_report`` gives the
counters, gauges and TTFT/ITL histograms (``serving.metrics``).  Only an
injected fault or a watchdog verdict fires a rung: a real kernel error
is never caught and served around (a real prefill error rolls back its
slot, then propagates).

``save_weights`` writes the packed parameters as a checkpoint in the
reference's format (``checkpoint.CheckpointManager.save_packed``, the
layers stacked as the reference stacks them), and ``load_weights``
restores one, written by either package, onto the engine's device, with
OSError retries behind the ``checkpoint_read`` boundary.

``journal_dir`` makes serving crash-safe (``serving.journal``): the
engine writes admissions, emitted tokens, terminal transitions and the
checkpoint pin through its state machine into a CRC-framed append-only
journal (the reference's format byte for byte; ``journal_sync`` sets the
fsync policy), behind the ``journal_write`` fault boundary, fail-open.  A
fresh engine's ``recover()`` rebuilds every non-terminal journaled request
and resumes it through the same history replay as the paged rung, so a
resumed stream and its K/V rows are bitwise the uninterrupted run's.
``begin_drain`` / ``drain`` / ``finish_drain`` close admissions, let the
batch finish (or hit a deadline) and journal a durable ledger snapshot;
the survivors are the next process's to recover.

Not ported yet: mesh serving (``mesh=`` raises ``NotImplementedError``
naming its ROADMAP item).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import os

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import hadamard, qtensor
from repro_torch.models import build_model
from repro_torch.models.base import (ACT_QUANT_MODES, ActQuant, ArchConfig,
                                     pack_projections)
from repro_torch.serving.faults import InjectedFault, SystemClock
from repro_torch.serving.journal import JournalError, RequestJournal, replay
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import ChunkedPrefillScheduler
from repro_torch.serving.watchdog import StepWatchdog

__all__ = ["Request", "RequestState", "ServeEngine", "QueueFullError",
           "RequestValidationError", "EngineDrainingError", "JournalError",
           "engine_robustness_spec"]


class RequestState(str, enum.Enum):
    """Explicit request lifecycle.  QUEUED -> PREFILLING -> RUNNING is the
    happy path; the four terminal states are mutually exclusive and each
    lands with a typed ``finish_reason`` in ``engine.counters``."""
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    EXPIRED = "EXPIRED"

    def __str__(self) -> str:          # "FINISHED", not "RequestState...."
        return self.value

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.FAILED,
                        RequestState.CANCELLED, RequestState.EXPIRED)


# Typed rejection reasons (request never entered the queue) --------------
REJECT_EMPTY_PROMPT = "empty_prompt"
REJECT_BAD_MAX_NEW = "bad_max_new_tokens"
REJECT_TOO_LONG = "too_long"
REJECT_OVER_POOL_CAPACITY = "over_pool_capacity"
REJECT_QUEUE_FULL = "queue_full"
REJECT_DRAINING = "draining"

# Typed terminal reasons -------------------------------------------------
REASON_MAX_NEW = "max_new_tokens"          # FINISHED
REASON_NAN_LOGITS = "nan_logits"           # FAILED: poisoned/overflowed row
REASON_INJECTED = "injected_fault"         # FAILED: injected fatal fault
REASON_PREFILL_ERROR = "prefill_error"     # FAILED: admission prefill raised
REASON_COW_ERROR = "cow_error"             # FAILED: COW page copy raised
REASON_POOL_ERROR = "pool_error"           # FAILED: page acquisition raised
REASON_RETRIES = "retries_exhausted"       # FAILED: transient never cleared
REASON_DEADLINE = "deadline"               # EXPIRED: total deadline passed
REASON_TTFT = "ttft_deadline"              # EXPIRED: no first token in budget
REASON_CANCELLED = "user_cancel"           # CANCELLED
REASON_WATCHDOG = "watchdog_timeout"       # FAILED: hung-step budget blown

# engine argument -> the ROADMAP item that ports it
_NOT_PORTED = {
    "mesh": "§1 item 7 (multi-GPU)",
}


class RequestValidationError(ValueError):
    """A request rejected before touching any engine state (slot, pool
    page, prefix tree).  Subclasses ValueError so callers'
    ``except ValueError`` handling keeps working."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class QueueFullError(RuntimeError):
    """Backpressure: the bounded admission queue is full.  Callers should
    shed load or retry later; the engine state is untouched."""

    reason = REJECT_QUEUE_FULL


class EngineDrainingError(RuntimeError):
    """The engine is draining: admissions are closed while in-flight
    requests finish.  Clients should retry against a replacement
    instance; the engine state is untouched."""

    reason = REJECT_DRAINING


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # first greedy token, produced by the admission prefill (its last chunk
    # when chunked) and emitted by the next step(); None while prefilling
    _next: int | None = None
    # lifecycle ----------------------------------------------------------
    deadline_ms: float | None = None       # total budget from submission
    ttft_budget_ms: float | None = None    # budget to the FIRST token
    state: RequestState = RequestState.QUEUED
    finish_reason: str | None = None
    error: Exception | None = dataclasses.field(default=None, repr=False)
    submitted_at: float | None = None      # engine-clock seconds
    first_token_at: float | None = None
    _last_token_at: float | None = None    # ITL anchor (metrics)
    _deferrals: int = 0                    # pool-exhaustion re-queues
    _retry_at: float = 0.0                 # backoff gate for re-admission

    def ttft_ms(self) -> float | None:
        if self.submitted_at is None or self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1e3


def engine_robustness_spec(*, max_queue: int = 64,
                           deadline_ms: float | None = None,
                           ttft_budget_ms: float | None = None,
                           degrade_after_deferrals: int | None = None,
                           kv_pool: int | None = None,
                           act_quant: str | None = None) -> dict:
    """Pure description of an engine's robustness configuration — the
    queue bound, deadline defaults, and which rungs of the degradation
    ladder are armed; mirrored live by ``ServeEngine.robustness_report``.
    Both rungs keep the streams and the K/V bytes: the paged rung replays
    each history through the prefill and decode passes that first wrote
    it (``ServeEngine._replay_histories``)."""
    ladder = []
    if act_quant == "mixfp4":
        ladder.append({"from": "fused W4A4 GEMM",
                       "to": "2-pass W4A4 (per-row scales)",
                       "trigger": "failed fused dispatch",
                       "bitwise_preserving": True})
    if kv_pool is not None:
        ladder.append({"from": "paged attention", "to": "fixed-slot",
                       "trigger": (f"admission deferred "
                                   f">= {degrade_after_deferrals} times"
                                   if degrade_after_deferrals
                                   else "disarmed (degrade_after_deferrals"
                                        "=None)"),
                       "bitwise_preserving": True})
    return {
        "queue": {"max_queue": max_queue},
        "deadlines": {"deadline_ms": deadline_ms,
                      "ttft_budget_ms": ttft_budget_ms},
        "degradation_ladder": ladder,
        "states": [s.value for s in RequestState],
    }


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
                 prefill_chunk: int | None = None,
                 max_queue: int = 64, deadline_ms: float | None = None,
                 ttft_budget_ms: float | None = None, faults=None,
                 clock=None, degrade_after_deferrals: int | None = None,
                 retry_max: int = 3, retry_base_ms: float = 10.0,
                 retry_cap_ms: float = 1000.0,
                 hung_step_budget_ms: float | None = None,
                 watchdog_fail_after: int = 2,
                 journal_dir: str | None = None, journal_sync: str = "batch",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=...) is not ported yet "
                f"(ROADMAP {_NOT_PORTED['mesh']})")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if degrade_after_deferrals is not None and degrade_after_deferrals < 1:
            raise ValueError("degrade_after_deferrals must be None "
                             "(disarmed) or >= 1")
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
        # the hung-step watchdog checks its budget before any weight moves
        self.watchdog = (StepWatchdog(hung_step_budget_ms,
                                      fail_after=watchdog_fail_after)
                         if hung_step_budget_ms is not None else None)
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
        self.kv_pool_pages = kv_pool
        self.kv_page_len = kv_page_len
        self._slot_pages: list[list[int] | None] = [None] * batch_size
        if kv_pool is not None:
            self.kv_pool = KVPool(kv_pool, kv_page_len,
                                  enable_prefix=cfg.family == "dense")
            self.cache = self.model.init_cache(
                batch_size, max_len, device=self.device, kv_quant="mixfp4",
                pages=(kv_pool, kv_page_len))
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
        self.max_prefill_tokens_per_step = 0
        # request lifecycle: bounded admission queue, deadline defaults,
        # seeded fault injector (None in production), retry policy.  With
        # an injector installed the engine runs on ITS clock (a virtual
        # clock by default), so deadlines / TTFT / backoff are pure
        # functions of the fault schedule.
        self.max_queue = max_queue
        self.deadline_ms = deadline_ms
        self.ttft_budget_ms = ttft_budget_ms
        self.faults = faults
        if clock is not None:
            self.clock = clock
        elif faults is not None:
            self.clock = faults.clock
        else:
            self.clock = SystemClock()
        self.degrade_after_deferrals = degrade_after_deferrals
        self.retry_max = retry_max
        self.retry_base_ms = retry_base_ms
        self.retry_cap_ms = retry_cap_ms
        self.queue: collections.deque[Request] = collections.deque()
        self.requests: dict[int, Request] = {}   # uid -> every seen request
        self.counters: collections.Counter = collections.Counter()
        self._step_poison: set = set()
        self.draining = False
        # observability: the engine is the only writer; readers take
        # snapshot dicts via metrics_report()
        self.metrics = MetricsRegistry()
        # durability: the append-only request journal, written through the
        # state machine (submit / step / _mark_terminal), so replaying it
        # rebuilds the lifecycle the counters saw
        self.journal_sync = journal_sync
        self.journal = (RequestJournal(journal_dir, sync=journal_sync)
                        if journal_dir is not None else None)
        self.recovered_uids: list[int] = []
        self._weights_pin: dict | None = None   # journal <-> ckpt pinning
        # (slot, request) of the requests resumed by the running _pump,
        # whose generated tokens replay when it ends; replay decode passes
        self._resumed: list[tuple[int, Request]] = []
        self.replay_decode_steps = 0

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
        mgr = CheckpointManager(directory)
        mgr.save_packed(step, convert.packed_to_stacked(self.params),
                        blocking=True)
        self._pin_weights(directory, step, mgr)

    def _pin_weights(self, directory: str, step: int, mgr):
        """Record the packed-checkpoint pin (step + manifest fingerprint)
        on the engine and in the journal, so ``recover()`` can refuse to
        resume journaled streams against other weight bytes."""
        try:
            fp = mgr.packed_fingerprint(step)
        except (OSError, ValueError, KeyError):
            fp = None
        self._weights_pin = {"dir": str(directory), "step": int(step),
                             "fingerprint": fp}
        self._journal_append({"t": "ckpt", "dir": str(directory),
                              "step": int(step), "fp": fp})
        self._journal_flush()

    def load_weights(self, directory: str, step: int | None = None):
        """Restore a packed checkpoint (the latest step by default), written
        by this engine or by the reference's, onto the engine's device:
        per-array digests and scale planes verified, the layers split
        again, the storage stats recomputed from what was restored.  The
        read runs behind the ``checkpoint_read`` fault boundary: transients
        and OSErrors (flaky filesystems) retry with capped backoff."""
        mgr = CheckpointManager(directory)
        restored, _ = self._with_retries(
            "checkpoint_read", lambda: mgr.restore_packed(step),
            retryable=(OSError,))
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
        if step is None:
            step = mgr.latest_step()
        if step is not None:
            self._pin_weights(directory, step, mgr)

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

    # ------------------------------------------------------------------
    # request lifecycle: validation, bounded queue, admission, faults
    # ------------------------------------------------------------------
    def _validate(self, req: Request):
        """Reject malformed requests BEFORE any engine state is touched —
        no slot, no pool page, no prefix-tree refcount."""
        if len(req.prompt) == 0:
            self.counters[f"rejected:{REJECT_EMPTY_PROMPT}"] += 1
            raise RequestValidationError(
                REJECT_EMPTY_PROMPT,
                "empty prompt: a request must carry at least one prompt "
                "token")
        if req.max_new_tokens < 1:
            self.counters[f"rejected:{REJECT_BAD_MAX_NEW}"] += 1
            raise RequestValidationError(
                REJECT_BAD_MAX_NEW,
                "max_new_tokens must be >= 1 (the prefill itself produces "
                "the first token)")
        # the final generated token is emitted but never fed back, so the
        # highest cache position written is prompt + max_new - 2
        if len(req.prompt) + req.max_new_tokens - 1 > self.max_len:
            self.counters[f"rejected:{REJECT_TOO_LONG}"] += 1
            raise RequestValidationError(
                REJECT_TOO_LONG,
                f"request {req.uid} needs {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens but the cache holds "
                f"max_len={self.max_len}")
        if self.kv_pool is not None:
            need = self.kv_pool.pages_needed(len(req.prompt),
                                             req.max_new_tokens)
            if need > self.kv_pool.pages_total:
                self.counters[f"rejected:{REJECT_OVER_POOL_CAPACITY}"] += 1
                raise RequestValidationError(
                    REJECT_OVER_POOL_CAPACITY,
                    f"request {req.uid} needs {need} pool pages but the "
                    f"pool holds {self.kv_pool.pages_total} (deferring it "
                    "would livelock: no amount of draining frees enough)")

    def submit(self, req: Request):
        """Enqueue a request on the bounded admission queue (strict FIFO).
        Raises :class:`RequestValidationError` / :class:`QueueFullError` /
        :class:`EngineDrainingError` with a typed reason; on success the
        request is QUEUED and will be admitted by a later ``step()`` as
        slots and pool pages free up."""
        self._validate(req)
        if self.draining:
            self.counters[f"rejected:{REJECT_DRAINING}"] += 1
            raise EngineDrainingError(
                "engine is draining: admissions are closed while "
                "in-flight requests finish (retry against a replacement "
                "instance)")
        if len(self.queue) >= self.max_queue:
            self.counters[f"rejected:{REJECT_QUEUE_FULL}"] += 1
            raise QueueFullError(
                f"admission queue is full ({self.max_queue} requests); "
                "shed load or retry after a drain")
        req.state = RequestState.QUEUED
        req.submitted_at = self.clock()
        self.requests[req.uid] = req
        self.queue.append(req)
        self.counters["submitted"] += 1
        self._journal_submit(req)

    def cancel(self, uid: int, reason: str = REASON_CANCELLED) -> bool:
        """Cancel a queued or in-flight request.  Returns True if the
        request transitioned to CANCELLED (slot, pool pages and any
        mid-prefill job released); False if it is unknown or already
        terminal."""
        req = self.requests.get(uid)
        if req is None or req.state.terminal:
            return False
        if req.state is RequestState.QUEUED:
            with contextlib.suppress(ValueError):
                self.queue.remove(req)
            self._mark_terminal(req, RequestState.CANCELLED, reason)
            return True
        i = next(i for i, s in enumerate(self.slots) if s is req)
        self._finish_request(i, RequestState.CANCELLED, reason)
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s is not None and not s.done for s in self.slots)

    # -- journal write-through -----------------------------------------
    def _journal_append(self, rec: dict):
        """Append one record behind the ``journal_write`` fault boundary.
        Transients (and real OSErrors) retry with capped backoff; a fatal
        failure disables journaling and keeps serving (fail-open: losing
        durability is a counter, not an outage) — recovery then resumes
        from the last committed record, whose lost tail greedy decode
        re-derives bitwise."""
        if self.journal is None:
            return
        try:
            self._with_retries("journal_write",
                               lambda: self.journal.append(rec),
                               retryable=(OSError,))
        except (InjectedFault, OSError):
            self._disable_journal()

    def _disable_journal(self):
        self.counters["journal_write_failed"] += 1
        self.counters["journal_disabled"] = 1
        with contextlib.suppress(Exception):
            self.journal.close()
        self.journal = None

    def _journal_submit(self, req: Request):
        if self.journal is None:
            return
        rec = {"t": "submit", "uid": req.uid,
               "prompt": [int(t) for t in np.asarray(req.prompt).ravel()],
               "max_new_tokens": int(req.max_new_tokens)}
        if req.deadline_ms is not None:
            rec["deadline_ms"] = req.deadline_ms
        if req.ttft_budget_ms is not None:
            rec["ttft_budget_ms"] = req.ttft_budget_ms
        self._journal_append(rec)

    def _journal_flush(self):
        """Step-boundary flush: under ``journal_sync='batch'`` this is the
        one fsync point that commits the step's token records."""
        if self.journal is not None:
            try:
                self.journal.flush()
            except OSError:
                self._disable_journal()

    # -- fault hooks / clock -------------------------------------------
    def _fire(self, site: str, *, uid: int | None = None, scoped=True):
        """Cross one injector boundary.  ``scoped`` sites victimize the
        request passed as ``uid``; the decode site victimizes among all
        active requests.  Returns the FaultAction (or None)."""
        if self.faults is None:
            return None
        active = () if scoped else tuple(
            r.uid for r in self.slots if r is not None and not r.done)
        act = self.faults.fire(site, uid=uid, active_uids=active)
        if act.delay_ms:
            self.counters["injected_slow_ms"] += int(act.delay_ms)
        return act

    def _sleep(self, seconds: float):
        """Backoff sleep on the engine clock: a virtual clock advances
        deterministically, the system clock really sleeps (capped)."""
        self.clock.sleep(seconds)

    def _backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff: base * 2^(attempt-1), in seconds."""
        return min(self.retry_base_ms * 2.0 ** max(attempt - 1, 0),
                   self.retry_cap_ms) / 1e3

    def _with_retries(self, site: str, fn, *, uid=None, retryable=()):
        """Run ``fn`` behind the ``site`` fault boundary with capped
        exponential backoff on transient failures (injected transients and
        any real exception type in ``retryable``, e.g. OSError for
        checkpoint reads).  Non-transient faults propagate immediately;
        exhausting the budget re-raises the last failure."""
        attempt = 0
        while True:
            try:
                act = self._fire(site, uid=uid)
                if act is not None and act.error is not None:
                    raise act.error
                return fn() if fn is not None else act
            except InjectedFault as e:
                if not e.transient:
                    raise
                last = e
            except retryable as e:
                last = e
            attempt += 1
            if attempt > self.retry_max:
                self.counters[f"retries_exhausted:{site}"] += 1
                raise last
            self.counters[f"retries:{site}"] += 1
            self._sleep(self._backoff_s(attempt))

    # -- admission ------------------------------------------------------
    def add_request(self, req: Request) -> bool:
        """Direct (queue-bypassing) admission.  Returns True when the
        request was CONSUMED (admitted, or failed terminally by an
        admission fault or non-finite prefill logits), False when the
        caller should retry later (no free slot / pool exhausted).
        Without ``prefill_chunk`` the admission prefills now; with it the
        prompt prefills one chunk per ``step()``."""
        self._validate(req)
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        if req.uid not in self.requests:
            self._journal_submit(req)    # once per uid across re-tries
        self.requests[req.uid] = req
        res = self._try_admit(req)
        self._replay_resumed()
        if res == "deferred":
            req._deferrals += 1
            self.counters["deferred_admissions"] += 1
        return res in ("admitted", "failed")

    def _try_admit(self, req: Request) -> str:
        """Try to place ``req`` in a free slot: 'admitted', 'no_slot',
        'deferred' (pool exhausted — retryable), or 'failed' (an admission
        fault consumed the request; its slot and pages were rolled back
        and it is terminally FAILED).

        A request that already holds generated tokens (recovered after a
        restart) resumes mid-stream: its prompt prefills now, whole even on
        a chunked engine, behind the same fault boundary and rollback, and
        its ``generated[:-1]`` replays through ``decode_step`` when the
        admitting call ends, in lockstep with every request resumed with it
        (:meth:`_replay_histories`), so each K/V row is bitwise the one the
        pre-crash engine wrote; decode then feeds ``generated[-1]`` at
        ``len(prompt) + len(generated) - 1``, where that engine stopped.  Its
        pages (the footprint of the prompt with ``max_new_tokens``, which is
        the reference's ``shim_new`` footprint of the history, matched over
        the prompt alone) stay anonymous: never registered for prefix hits,
        since decode still writes the trailing page."""
        i = next((i for i, s in enumerate(self.slots) if s is None), None)
        if i is None:
            return "no_slot"
        start, cow = 0, None
        if self.kv_pool is None:
            # a reused slot starts over at row 0 with zeroed cache rows
            self.cache = self.model.reset_slot(self.cache, i)
        else:
            # map cached prefix pages and allocate the rest (evicting LRU
            # cached pages as needed); a pool that cannot cover the
            # request defers it
            act = self._fire("pool_acquire", uid=req.uid)
            if act is not None and act.error is not None:
                if act.error.transient:
                    return "deferred"  # backs off like real exhaustion
                self._mark_terminal(req, RequestState.FAILED,
                                    REASON_POOL_ERROR, error=act.error)
                return "failed"
            denied = act is not None and act.deny
            adm = None if denied else self.kv_pool.acquire(
                req.prompt, req.max_new_tokens)
            if denied:
                self.counters["injected_pool_denials"] += 1
            if adm is None:
                return "deferred"
            self._slot_pages[i] = adm.pages
            row = torch.zeros(self.cache["pages"].shape[1], dtype=torch.int32)
            row[:len(adm.pages)] = torch.tensor(adm.pages, dtype=torch.int32)
            self.cache["pages"][i] = row.to(self.device)
            start, cow = adm.shared_len, adm.cow
        self.slots[i] = req
        req.state = RequestState.PREFILLING
        # a chunked admission's length tracks its chunk cursor, so the
        # batched decode's junk row for this lane lands at the next chunk's
        # first row, which that chunk overwrites before anything reads it
        self.lengths[i] = start
        if cow is not None:
            cow_act = self._fire("cow_copy", uid=req.uid)
            if cow_act is not None and cow_act.error is not None:
                # a page failure mid-COW rolls back like any admission
                # fault: _finish_slot releases the acquired pages
                self._finish_request(i, RequestState.FAILED,
                                     REASON_COW_ERROR, error=cow_act.error)
                return "failed"
            self._cow_copy(*cow)
        if self.scheduler is not None and not req.generated:
            # chunked admission: the slot is held, step() drains the job
            # one chunk at a time; a paged prompt's pages are registered
            # for prefix hits only when the job completes
            self.scheduler.enqueue(req.uid, i, req, len(req.prompt),
                                   start_pos=start)
            return "admitted"
        logits = self._guarded_prefill(i, req, start)
        if logits is None:
            return "failed"
        if not req.generated:
            return "admitted" if self._prefill_done(i, req, logits) \
                else "failed"
        self.lengths[i] = len(req.prompt)
        self.admissions += 1
        req.state = RequestState.RUNNING
        self._resumed.append((i, req))
        self.counters["resumed"] += 1
        return "admitted"

    def _replay_resumed(self):
        """Replay the generated tokens of the requests resumed since the
        last call, in one lockstep loop."""
        if self._resumed:
            lanes, self._resumed = self._resumed, []
            self._replay_histories(lanes, prompts=False)

    def _guarded_prefill(self, i: int, req: Request, start_pos: int = 0):
        """Admission prefill behind the 'prefill' fault boundary; returns
        its logits.  On an injected fault the slot is rolled back (pages
        released, block table row pointed at the trash page) and the
        request lands FAILED with a typed reason (None then); a REAL
        prefill exception propagates after the same rollback, so the
        engine never holds a half-admitted slot."""
        try:
            self._with_retries("prefill", None, uid=req.uid)
            return self._prefill_slot(i, req, start_pos)
        except InjectedFault as e:
            reason = REASON_RETRIES if e.transient else REASON_INJECTED
            self._finish_request(i, RequestState.FAILED, reason, error=e)
            return None
        except Exception as e:
            self._finish_request(i, RequestState.FAILED,
                                 REASON_PREFILL_ERROR, error=e)
            raise

    def _cow_copy(self, src: int, dst: int):
        """The eager copy-on-write of a partial prefix hit: page ``src``'s
        packed K and V bytes into page ``dst``, every layer."""
        for leaf in (self.cache["k"], self.cache["v"]):
            leaf.payload[:, dst] = leaf.payload[:, src]
            leaf.scales[:, dst] = leaf.scales[:, src]

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
        register a paged prompt's pages for prefix hits (their bytes are
        final now; eager COW means no shared page is written later) and
        flip the request RUNNING.  A prompt whose prefill logits are not
        finite ends FAILED (``nan_logits``) with no token and frees the
        slot, as a decode row does; False then."""
        self.lengths[i] = len(req.prompt)
        self.admissions += 1
        finite, nxt = torch.stack([torch.isfinite(logits[0]).all().long(),
                                   torch.argmax(logits[0])]).tolist()
        if not finite:
            self._finish_request(i, RequestState.FAILED, REASON_NAN_LOGITS)
            return False
        req._next = nxt
        if self.kv_pool is not None:
            self.kv_pool.insert(req.prompt, self._slot_pages[i])
        req.state = RequestState.RUNNING
        return True

    def _run_chunk(self):
        """Spend this step's chunk budget on the FIFO-head prefill job: one
        prefill pass of ``prefill_chunk`` prompt tokens from its cursor
        (the final partial chunk pads up to the budget, never past
        max_len), behind the 'prefill' fault boundary with the same
        rollback as the whole-prompt path."""
        job = self.scheduler.head()
        if job is None:
            return
        req, i, start = job.req, job.slot, job.cursor
        n_real = min(self.scheduler.chunk, job.p_len - start)
        pad_to = min(self.scheduler.chunk, self.max_len - start)
        toks = np.asarray(req.prompt, np.int64)[start:start + n_real]
        if pad_to > n_real:
            toks = np.pad(toks, (0, pad_to - n_real))
        try:
            self._with_retries("prefill", None, uid=req.uid)
        except InjectedFault as e:
            reason = REASON_RETRIES if e.transient else REASON_INJECTED
            self._finish_request(i, RequestState.FAILED, reason, error=e)
            return
        try:
            logits = self._prefill(i, toks, n_real, start)
        except Exception as e:
            self._finish_request(i, RequestState.FAILED,
                                 REASON_PREFILL_ERROR, error=e)
            raise
        if self.scheduler.advance(job, n_real):
            self._prefill_done(i, req, logits)
        else:
            self.lengths[i] = job.cursor

    # -- queue pump / deadlines ----------------------------------------
    def _pump(self):
        """Admit from the bounded queue in strict FIFO order.  A deferred
        head (pool exhausted) backs off exponentially; while it backs off
        nothing behind it is admitted (FIFO fairness).  An IDLE engine
        sleeps the clock up to the head's retry gate instead of spinning —
        with a virtual clock this is what makes deferred admissions
        livelock-free.  The requests it resumed replay their generated
        tokens together at the end."""
        self._admit_queued()
        self._replay_resumed()

    def _admit_queued(self):
        while self.queue:
            head = self.queue[0]
            if head.state is not RequestState.QUEUED:
                self.queue.popleft()       # cancelled/expired while queued
                continue
            now = self.clock()
            if head._retry_at > now:
                if any(s is not None for s in self.slots):
                    return                 # let the batch drain first
                self._sleep(head._retry_at - now)
                continue
            res = self._try_admit(head)
            if res in ("admitted", "failed"):
                self.queue.popleft()
                continue
            if res == "no_slot":
                return
            # deferred: pool exhausted past what a drain may free
            head._deferrals += 1
            self.counters["deferred_admissions"] += 1
            if (self.degrade_after_deferrals is not None
                    and head._deferrals >= self.degrade_after_deferrals
                    and self.kv_pool is not None):
                self._degrade_to_fixed_slot()
                continue                   # re-admit on the fixed path
            head._retry_at = self.clock() + self._backoff_s(head._deferrals)
            return

    def _deadline_for(self, req: Request) -> float | None:
        return req.deadline_ms if req.deadline_ms is not None \
            else self.deadline_ms

    def _ttft_for(self, req: Request) -> float | None:
        return req.ttft_budget_ms if req.ttft_budget_ms is not None \
            else self.ttft_budget_ms

    def _expire_deadlines(self):
        """Expire queued and in-flight requests past their total deadline,
        and first-token-less requests past their TTFT budget."""
        now = self.clock()

        def over(req, budget_ms):
            return (budget_ms is not None and req.submitted_at is not None
                    and (now - req.submitted_at) * 1e3 > budget_ms)

        for req in [r for r in self.queue
                    if r.state is RequestState.QUEUED]:
            if over(req, self._deadline_for(req)) \
                    or over(req, self._ttft_for(req)):
                reason = (REASON_DEADLINE
                          if over(req, self._deadline_for(req))
                          else REASON_TTFT)
                with contextlib.suppress(ValueError):
                    self.queue.remove(req)
                self._mark_terminal(req, RequestState.EXPIRED, reason)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            if over(req, self._deadline_for(req)):
                self._finish_request(i, RequestState.EXPIRED,
                                     REASON_DEADLINE)
            elif req.first_token_at is None and over(req, self._ttft_for(req)):
                self._finish_request(i, RequestState.EXPIRED, REASON_TTFT)

    # -- graceful degradation ------------------------------------------
    def _degrade_fused(self, err=None):
        """Fused W4A4 dispatch failed: fall back to the quantizer followed
        by the packed W4A4 GEMM ('mixfp4-2pass-rowscale').  The fused
        kernel is bitwise that composition (the same per-row scale and the
        same weight bytes), so the stream is preserved exactly — only the
        launch count and latency change.  ``act_rht`` carries over: the
        two-pass path applies the same grouped Hadamard before quantizing.
        The projections read ``self.act`` on every call, so swapping it is
        the whole move."""
        if self.act_quant != "mixfp4":
            raise RuntimeError(
                "fused-dispatch degradation requested but the engine is "
                f"not on the fused W4A4 path (act_quant={self.act_quant!r})"
            ) from err
        self.act_quant = "mixfp4-2pass-rowscale"
        self.act = ActQuant(self.act_quant, self.act_rht)
        self.counters["degraded_fused_to_2pass"] += 1

    def _degrade_to_fixed_slot(self):
        """Pool exhaustion past the deferral budget: abandon the paged
        pool for the fixed-slot packed KV cache.  Every in-flight request
        is migrated by replaying its token history into the fresh cache
        (:meth:`_replay_histories`), bitwise for the dense family; a
        request resumed by this pump replays whole with them.  A
        mid-prefill chunk job restarts from position 0 (its cached-prefix
        rows lived in the abandoned pages)."""
        live = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        self._resumed = []
        self.kv_pool = None
        self.kv_pool_pages = None
        self._slot_pages = [None] * self.batch_size
        self.cache = None              # free the pool before the new cache
        self.cache = self.model.init_cache(self.batch_size, self.max_len,
                                           device=self.device,
                                           kv_quant="mixfp4")
        self.counters["degraded_paged_to_fixed"] += 1
        lanes = []
        for i, req in live:
            if (self.scheduler is not None
                    and req.state is RequestState.PREFILLING):
                self.lengths[i] = 0
                self.scheduler.restart(req.uid, 0)
            else:
                lanes.append((i, req))
        self._replay_histories(lanes)

    def _replay_histories(self, lanes, *, prompts: bool = True):
        """Rebuild the K/V rows of ``lanes`` ((slot, request) pairs) from
        their token histories ``prompt ++ generated[:-1]``.

        Each prompt prefills as its admission did (whole and bucketed,
        into the lane's fresh slot or pages; chunked prefill is bitwise
        whole prefill), unless ``prompts=False`` says its rows are in the
        cache already.  Then the generated tokens run through
        ``decode_step`` in lockstep across the lanes, each lane at its next
        position until its tail is used up.  A decode row is bitwise
        independent of its batchmates and of the cache's capacity, so each
        comes out as the decode step first wrote it.  Every other lane —
        free, mid-prefill, running, or replayed to its end — feeds token 0
        at its own ``lengths[i]``, the row its next pass writes again
        before reading it, as an idle lane does in ``step()``.  The replay
        emits no token, observes no ITL, crosses no fault boundary and
        drops its logits.  Afterwards ``lengths[i] == len(prompt) +
        len(generated) - 1``, where the next step feeds ``generated[-1]``;
        a request with no token yet takes its first from the prefill
        logits.  A replay costs one decode pass per token of the longest
        tail (``replay_decode_steps``)."""
        tails = {}
        for i, req in lanes:
            if prompts:
                logits = self._prefill_slot(i, req)
                if not req.generated:   # first token not emitted yet
                    req._next = int(torch.argmax(logits[0]))
            self.lengths[i] = len(req.prompt)
            tails[i] = req.generated[:-1]
        for t in range(max(map(len, tails.values()), default=0)):
            toks = np.zeros((self.batch_size,), np.int64)
            rows = [i for i, tail in tails.items() if t < len(tail)]
            for i in rows:
                toks[i] = tails[i][t]
            _, self.cache = self.model.decode_step(
                self.params, torch.as_tensor(toks, device=self.device),
                self.cache, torch.as_tensor(self.lengths, device=self.device),
                act=self.act)
            self.lengths[rows] += 1
            self.replay_decode_steps += 1

    def robustness_report(self) -> dict:
        """Live robustness state: queue depth/bounds, deadline config,
        degradation ladder position, lifecycle counters, and terminal
        state totals.  The static shape mirrors
        :func:`engine_robustness_spec`."""
        spec = engine_robustness_spec(
            max_queue=self.max_queue, deadline_ms=self.deadline_ms,
            ttft_budget_ms=self.ttft_budget_ms,
            degrade_after_deferrals=self.degrade_after_deferrals,
            kv_pool=self.kv_pool_pages, act_quant=self.act_quant)
        states = collections.Counter(
            str(r.state) for r in self.requests.values())
        spec["queue"]["depth"] = len(self.queue)
        spec["counters"] = dict(self.counters)
        spec["request_states"] = dict(states)
        spec["act_quant"] = self.act_quant
        spec["paged"] = self.kv_pool is not None
        spec["draining"] = self.draining
        spec["journaled"] = self.journal is not None
        if self.watchdog is not None:
            spec["watchdog"] = self.watchdog.report()
        return spec

    # -- graceful drain / crash recovery -------------------------------
    def begin_drain(self):
        """Close admissions: ``submit()`` now rejects with the typed
        ``draining`` reason while in-flight (and already-queued) requests
        keep stepping to completion.  Idempotent."""
        if not self.draining:
            self.draining = True
            self.counters["drain_begun"] = 1

    def finish_drain(self) -> dict:
        """Snapshot the ledger after the drain loop stops: one ``ledger``
        journal record (counters, per-request final states, any
        mid-prefill cursors) committed with a forced fsync, whatever the
        steady-state ``journal_sync``.  Requests still live at the drain
        deadline stay non-terminal in the journal: the next process
        recovers them."""
        survivors = [uid for uid, r in self.requests.items()
                     if not r.state.terminal]
        if self.journal is not None:
            rec = {"t": "ledger",
                   "counters": {k: float(v)
                                for k, v in self.counters.items()},
                   "requests": {str(uid): {"state": str(r.state),
                                           "reason": r.finish_reason,
                                           "n_tokens": len(r.generated)}
                                for uid, r in self.requests.items()},
                   "survivors": survivors}
            if self.scheduler is not None:
                rec["prefill_jobs"] = self.scheduler.jobs_report()
            self._journal_append(rec)
            if self.journal is not None:
                try:
                    self.journal.flush(force_sync=True)
                except OSError:
                    self.counters["journal_write_failed"] += 1
        terminal = len(self.requests) - len(survivors)
        return {"drained": not survivors, "completed": terminal,
                "survivors": survivors}

    def drain(self, deadline_ms: float | None = None,
              max_steps: int = 10000) -> dict:
        """Blocking graceful drain: close admissions, step until the batch
        and queue empty, ``deadline_ms`` passes (on the engine clock) or
        ``max_steps`` steps ran, then snapshot the ledger.  Returns the
        :meth:`finish_drain` report plus the steps spent."""
        self.begin_drain()
        t0 = self.clock()
        steps = 0
        while self.has_work() and steps < max_steps:
            if deadline_ms is not None \
                    and (self.clock() - t0) * 1e3 > deadline_ms:
                break
            self.step()
            steps += 1
        report = self.finish_drain()
        report["steps"] = steps
        return report

    def recover(self, journal_dir: str | None = None) -> dict:
        """Rebuild every non-terminal journaled request into this (fresh)
        engine and continue decode.

        Each live request comes back with its journaled prompt and tokens
        and re-enters the batch through :meth:`_try_admit`: its prompt
        prefills into a fresh slot or pages and its ``generated[:-1]``
        replays through ``decode_step``, so its K/V rows are bitwise the
        pre-crash ones, and decode resumes by feeding ``generated[-1]``
        where the dead process stopped.  Under greedy decode the resumed
        stream is bitwise the uninterrupted run's, and tokens emitted but
        lost to an unsynced journal tail are re-derived and re-emitted.

        A journal that pins packed weights (a ``ckpt`` record) refuses to
        resume unless this engine restored the same step with the same
        manifest fingerprint.  Requests whose tokens already reach
        ``max_new_tokens`` (terminal record lost in the tail) are finalized
        FINISHED without re-admission.  Recovery may requeue past
        ``max_queue`` (repopulation, not load)."""
        if journal_dir is not None:
            if self.journal is None:
                self.journal = RequestJournal(journal_dir,
                                              sync=self.journal_sync)
            elif os.path.abspath(self.journal.dir) \
                    != os.path.abspath(journal_dir):
                raise JournalError(
                    f"engine already journals to {self.journal.dir}; "
                    f"refusing to recover from {journal_dir}")
        if self.journal is None:
            raise JournalError(
                "recover() needs a journal: pass journal_dir= or "
                "construct the engine with journal_dir=")
        state = replay(self.journal.records)
        ck = state.checkpoint
        if ck is not None:
            pin = self._weights_pin
            if pin is None:
                raise JournalError(
                    f"journal pins packed weights to step {ck['step']} "
                    f"of {ck['dir']} but this engine never restored a "
                    "checkpoint; load_weights() that step first — "
                    "bitwise resume is only promised under the same "
                    "weight bytes")
            if ck.get("fingerprint") and pin.get("fingerprint") \
                    and ck["fingerprint"] != pin["fingerprint"]:
                raise JournalError(
                    f"journal pins packed weights to manifest "
                    f"fingerprint {ck['fingerprint']} (step "
                    f"{ck['step']}) but this engine restored "
                    f"{pin['fingerprint']} (step {pin['step']})")
            if ck.get("step") != pin.get("step"):
                raise JournalError(
                    f"journal pins packed weights to step {ck['step']} "
                    f"but this engine restored step {pin['step']}")
        report = {"replayed_records": len(self.journal.records),
                  "requests": len(state.requests),
                  "already_terminal": 0, "resumed": 0, "finalized": 0,
                  "dangling_tokens": state.dangling_tokens,
                  "truncated_bytes":
                      self.journal.stats.get("truncated_bytes", 0),
                  "corrupt_record_index":
                      self.journal.stats.get("corrupt_record_index")}
        now = self.clock()
        for rr in state.requests.values():
            if rr.terminal:
                report["already_terminal"] += 1
                continue
            req = Request(uid=rr.uid,
                          prompt=np.asarray(rr.prompt, np.int32),
                          max_new_tokens=rr.max_new_tokens,
                          generated=list(rr.tokens),
                          deadline_ms=rr.deadline_ms,
                          ttft_budget_ms=rr.ttft_budget_ms)
            # the deadline anchors restart: the dead process's wall time is
            # gone, and a recovered stream should not expire as it resumes
            req.submitted_at = now
            if rr.tokens:
                req.first_token_at = now
                req._last_token_at = now
            self.requests[req.uid] = req
            self.recovered_uids.append(req.uid)
            if len(rr.tokens) >= rr.max_new_tokens:
                self._mark_terminal(req, RequestState.FINISHED,
                                    REASON_MAX_NEW)
                report["finalized"] += 1
                continue
            req.state = RequestState.QUEUED
            self.queue.append(req)
            report["resumed"] += 1
            self.counters["recovered"] += 1
        # place as many as fit now; the rest admit as slots free up
        self._pump()
        self._journal_flush()
        return report

    # -- terminal transitions ------------------------------------------
    def _mark_terminal(self, req: Request, state: RequestState, reason: str,
                       error: Exception | None = None):
        req.state = state
        req.finish_reason = reason
        req.error = error
        req.done = True
        self.counters[f"{state.value.lower()}:{reason}"] += 1
        self._journal_append({"t": "terminal", "uid": req.uid,
                              "state": state.value, "reason": reason})

    def _finish_request(self, i: int, state: RequestState, reason: str,
                        error: Exception | None = None):
        """Terminal transition for the request in slot ``i``, and the
        slot's rollback: any mid-prefill job forgotten, pool pages
        released, the slot freed (``_finish_slot``)."""
        req = self.slots[i]
        self._mark_terminal(req, state, reason, error=error)
        if self.scheduler is not None:
            self.scheduler.drop(req.uid)
        self._finish_slot(i)

    def _finish_slot(self, i: int):
        """Free slot ``i``; its idle lane decodes at row 0.  A paged slot
        releases its pages (tree-registered ones park in the LRU, still
        servable as prefix hits) and points its table row at the trash
        page, so the idle lane's decode writes never land in a page the
        pool may grant again."""
        self.slots[i] = None
        self.lengths[i] = 0
        if self.kv_pool is not None:
            if self._slot_pages[i]:
                self.kv_pool.release(self._slot_pages[i])
            self._slot_pages[i] = None
            self.cache["pages"][i] = 0

    def pool_report(self) -> dict | None:
        """Pool occupancy, prefix-hit and eviction counters (None when the
        engine is not paged)."""
        return None if self.kv_pool is None else self.kv_pool.stats()

    # -- observability --------------------------------------------------
    def _active_slots(self) -> int:
        return sum(s is not None and not s.done for s in self.slots)

    def _note_step(self, decode_rows: int):
        """End-of-step bookkeeping: the prefill-token ledger (counters +
        scheduler step_log) and the live metrics gauges.  Admissions
        prefilled between steps count toward the next step, whose decode
        they delayed."""
        spent, self._step_prefill_tokens = self._step_prefill_tokens, 0
        self.max_prefill_tokens_per_step = max(
            self.max_prefill_tokens_per_step, spent)
        if spent:
            self.counters["prefill_tokens"] += spent
        self.counters["max_prefill_tokens_per_step"] = \
            self.max_prefill_tokens_per_step
        if self.scheduler is not None:
            self.scheduler.note_step(spent, decode_rows)
        m = self.metrics
        m.set_gauge("queue_depth", len(self.queue))
        m.set_gauge("active_slots", float(self._active_slots()))
        if self.kv_pool is not None:
            st = self.kv_pool.stats()
            for key in ("pages_active", "prefix_hit_tokens"):
                m.set_gauge(f"kv_pool.{key}", st[key])

    def metrics_report(self) -> dict:
        """One JSON-able observability snapshot: lifecycle counters
        (merged with the registry's), live gauges, TTFT/ITL histogram
        percentiles, pool stats and the scheduler ledger
        (``serving.metrics.render_prometheus`` renders it)."""
        snap = self.metrics.snapshot()
        counters = dict(self.counters)
        counters.update(snap["counters"])
        gauges = dict(snap["gauges"])
        gauges.update({
            "queue_depth": float(len(self.queue)),
            "active_slots": float(self._active_slots()),
            "max_queue": float(self.max_queue),
            "max_prefill_tokens_per_step":
                float(self.max_prefill_tokens_per_step),
            "draining": float(self.draining),
        })
        report = {"counters": counters, "gauges": gauges,
                  "histograms": snap["histograms"]}
        if self.kv_pool is not None:
            report["kv_pool"] = self.kv_pool.stats()
        if self.scheduler is not None:
            report["scheduler"] = self.scheduler.report()
        if self.journal is not None:
            report["journal"] = self.journal.report()
        if self.watchdog is not None:
            report["watchdog"] = self.watchdog.report()
        return report

    # -- the step --------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Expire deadlines, pump the queue into free slots, run one chunk
        of the head prefill job (when chunking), then one decode step for
        every running slot, each at its own cache position; returns the
        (uid, token) pairs emitted.  A freshly prefilled request first
        emits its prefill token, then decodes.  The decode crosses the
        'decode' fault boundary (``_guarded_decode``).  A row whose logits
        are not finite — really, or poisoned by the injector — fails ITS
        request only (``nan_logits``, no token); decode is row-independent,
        so the survivors' streams are untouched."""
        t0 = self.clock()
        # the process_crash boundary fires BEFORE any state mutation
        act = self._fire("process_crash", scoped=False)
        if act is not None and act.error is not None:
            raise act.error
        self._expire_deadlines()
        self._pump()
        if self.scheduler is not None:
            self._run_chunk()
        self.max_concurrent = max(self.max_concurrent,
                                  sum(r is not None for r in self.slots))
        toks = np.zeros((self.batch_size,), np.int64)
        out, active = [], []
        for i, req in enumerate(self.slots):
            if req is None or req.state is RequestState.PREFILLING:
                continue               # free, or a chunked prefill's lane
            if not req.generated:
                req.first_token_at = self.clock()
                req._last_token_at = req.first_token_at
                self.metrics.observe("ttft_ms", req.ttft_ms())
                req.generated.append(req._next)
                out.append((req.uid, req._next))
                self._journal_append({"t": "token", "uid": req.uid,
                                      "tok": int(req._next)})
                if len(req.generated) >= req.max_new_tokens:
                    self._finish_request(i, RequestState.FINISHED,
                                         REASON_MAX_NEW)
                    continue
            toks[i] = req.generated[-1]
            active.append(i)
        if not active:
            self._note_step(0)
            self._finish_step(t0)
            return out
        logits = self._guarded_decode(toks, active)
        next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        finite = torch.isfinite(logits).all(dim=-1).cpu().numpy()
        self.decode_steps += 1
        now = self.clock()
        for i in active:
            req = self.slots[i]
            if req is None:
                continue               # quarantined by a mid-step fault
            if req.uid in self._step_poison or not finite[i]:
                self._finish_request(i, RequestState.FAILED,
                                     REASON_NAN_LOGITS)
                continue
            tok = int(next_toks[i])
            req.generated.append(tok)
            self.lengths[i] += 1
            out.append((req.uid, tok))
            self._journal_append({"t": "token", "uid": req.uid,
                                  "tok": tok})
            if req._last_token_at is not None:
                self.metrics.observe("itl_ms",
                                     (now - req._last_token_at) * 1e3)
            req._last_token_at = now
            if len(req.generated) >= req.max_new_tokens:
                self._finish_request(i, RequestState.FINISHED,
                                     REASON_MAX_NEW)
        self._note_step(len(active))
        self._finish_step(t0)
        return out

    def _finish_step(self, t0: float):
        """Step-boundary work: one journal flush commits the step's token
        records (the ``journal_sync='batch'`` fsync point), then the
        watchdog hears the step's heartbeat (on the engine clock) and its
        verdicts run the degradation ladder."""
        self._journal_flush()
        if self.watchdog is None:
            return
        verdict = self.watchdog.beat((self.clock() - t0) * 1e3)
        if verdict == "degrade":
            # first strikes ride the bitwise-preserving fused rung when it
            # is armed; otherwise the strike just counts
            if self.act_quant == "mixfp4":
                self._degrade_fused()
            self.counters["watchdog_degrades"] += 1
        elif verdict == "fail":
            self._watchdog_fail()

    def _watchdog_fail(self):
        """Past the degradation rung: fail the most starved in-flight
        request (longest since its last token) with the typed
        ``watchdog_timeout`` reason, releasing its slot and pool pages
        instead of wedging the batch."""
        live = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.done]
        if not live:
            return

        def anchor(req):
            if req._last_token_at is not None:
                return req._last_token_at
            return req.submitted_at if req.submitted_at is not None else 0.0

        i, _ = min(live, key=lambda ir: anchor(ir[1]))
        self._finish_request(i, RequestState.FAILED, REASON_WATCHDOG)
        self.counters["watchdog_fails"] += 1

    def _guarded_decode(self, toks, active):
        """The decode launch behind the 'decode' fault boundary.  Injected
        'slow' faults advance the clock (TTFT/deadline pressure),
        'dispatch' faults move the fused W4A4 path to its two-pass rung
        (or, off the fused path, back off and retry), transients back off
        and retry, and a fatal fault fails its victim and rolls back its
        slot, then decodes the survivors.  Poisoned rows are recorded on
        the host (``_step_poison``); no device read is added."""
        self._step_poison = set()
        attempt = 0
        spins = 0
        while True:
            spins += 1
            if spins > self.retry_max + self.batch_size + 8:
                raise RuntimeError(
                    "decode fault boundary did not converge (a schedule "
                    "that fires fatally on every occurrence can starve "
                    "the dispatch); refusing to spin")
            act = self._fire("decode", scoped=False)
            if act is not None:
                self._step_poison |= set(act.poison_uids)
                err = act.error
                if err is not None:
                    if err.kind == "dispatch" and self.act_quant == "mixfp4":
                        self._degrade_fused(err)
                        continue
                    if err.kind == "dispatch" or err.transient:
                        attempt += 1
                        if attempt > self.retry_max:
                            self.counters["retries_exhausted:decode"] += 1
                            raise err
                        self.counters["retries:decode"] += 1
                        self._sleep(self._backoff_s(attempt))
                        continue
                    # fatal, request-scoped: fail the victim, decode the rest
                    victim = next(
                        (i for i in active
                         if self.slots[i] is not None
                         and self.slots[i].uid == err.uid), None)
                    if victim is not None:
                        self._finish_request(victim, RequestState.FAILED,
                                             REASON_INJECTED, error=err)
                    continue
            logits, self.cache = self.model.decode_step(
                self.params, torch.as_tensor(toks, device=self.device),
                self.cache, torch.as_tensor(self.lengths, device=self.device),
                act=self.act)
            return logits
