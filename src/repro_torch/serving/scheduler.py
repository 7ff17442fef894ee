"""Chunked-prefill scheduler: long admissions never stall the decode batch.

Counterpart of ``repro/serving/scheduler.py`` (the same jobs, cursors and
per-step ledger for the same calls), without the journal snapshot and the
degradation restart, which belong to the serving lifecycle.

A whole-prompt admission runs the entire prompt through one prefill
before the next ``step()`` can decode, so every in-flight request's
inter-token latency spikes by the full prompt length.  Here admissions are
split into fixed token-budget *chunks* interleaved with decode steps: each
``engine.step()`` spends at most ``chunk_tokens`` prompt tokens of prefill
work, then decodes the running batch as usual.

Why chunking is *exact* (the port's tests hold it bitwise):

* KV rows quantize under the pinned ``KV_SCALE32`` contract, so a row's
  packed bytes are a pure function of its values — write order (one chunk
  at a time vs the whole prompt at once) cannot change them.  The same
  holds for the paged pool slabs.
* ``prefill_slot(start_pos=s0)`` shifts positions and causality by ``s0``
  and attends over the already-written cache rows ``[0, s0)`` with the
  same masked full-cache attention the whole-prompt call uses, in query
  blocks of one fixed shape, so each query row's softmax runs over the
  identical key set in the identical order — the last chunk's
  final-position logits are bitwise the whole-prompt call's.

Chunks run at one shape (the token budget; the final partial chunk is
padded up and masked with ``true_len``).

This module is pure Python: the engine owns the device work and calls in
here for job order, cursors and the per-step token ledger.
"""
from __future__ import annotations

import collections
import dataclasses

__all__ = ["ChunkedPrefillScheduler", "PrefillJob"]


@dataclasses.dataclass
class PrefillJob:
    """One admission being prefilled chunk-by-chunk.  ``cursor`` is the
    next prompt position to prefill (starts at the prefix-cache
    ``shared_len`` for paged prefix hits); the job completes when it
    reaches ``p_len``."""
    uid: int
    slot: int
    req: object                 # repro_torch.serving.engine.Request
    p_len: int
    cursor: int = 0
    chunks_done: int = 0

    @property
    def remaining(self) -> int:
        return self.p_len - self.cursor


class ChunkedPrefillScheduler:
    """FIFO chunked-prefill scheduler with a per-step token ledger.

    The engine enqueues one :class:`PrefillJob` per chunked admission and
    calls :meth:`head` each step to learn which job gets this step's chunk
    budget; after running the device work it reports back through
    :meth:`advance` (and :meth:`note_step` once the step's decode ran).
    Jobs progress strictly in admission order — one job prefills at a
    time, so a burst of admissions cannot multiply the per-step prefill
    work past the budget.

    ``step_log`` records ``{"prefill_tokens", "decode_rows", "backlog"}``
    per engine step — the deterministic, wall-clock-free evidence that no
    decode step was delayed by more than ``chunk_tokens``.
    """

    def __init__(self, chunk_tokens: int):
        if chunk_tokens < 1:
            raise ValueError(
                f"prefill chunk budget must be >= 1 token, got {chunk_tokens}")
        self.chunk = int(chunk_tokens)
        self._jobs: collections.OrderedDict[int, PrefillJob] = \
            collections.OrderedDict()
        self.step_log: list[dict] = []
        self.chunks_run = 0
        self.tokens_prefilled = 0
        self.jobs_completed = 0

    # -- job lifecycle -----------------------------------------------------
    def enqueue(self, uid: int, slot: int, req, p_len: int,
                start_pos: int = 0) -> PrefillJob:
        if uid in self._jobs:
            raise ValueError(f"request {uid} already has a prefill job")
        job = PrefillJob(uid=uid, slot=slot, req=req, p_len=p_len,
                         cursor=start_pos)
        self._jobs[uid] = job
        return job

    def head(self) -> PrefillJob | None:
        """The job that gets this step's chunk budget (FIFO), or None."""
        for job in self._jobs.values():
            return job
        return None

    def get(self, uid: int) -> PrefillJob | None:
        return self._jobs.get(uid)

    def advance(self, job: PrefillJob, n_tokens: int) -> bool:
        """Record one executed chunk of ``n_tokens`` real prompt tokens.
        Returns True when the job just completed (the engine then flips
        the request RUNNING and registers pool pages)."""
        job.cursor += n_tokens
        job.chunks_done += 1
        self.chunks_run += 1
        self.tokens_prefilled += n_tokens
        if job.cursor >= job.p_len:
            del self._jobs[job.uid]
            self.jobs_completed += 1
            return True
        return False

    # -- per-step ledger ---------------------------------------------------
    def note_step(self, prefill_tokens: int, decode_rows: int) -> None:
        self.step_log.append({
            "prefill_tokens": int(prefill_tokens),
            "decode_rows": int(decode_rows),
            "backlog": self.backlog_tokens(),
        })

    def backlog_tokens(self) -> int:
        return sum(j.remaining for j in self._jobs.values())

    @property
    def pending_jobs(self) -> int:
        return len(self._jobs)

    def max_prefill_tokens_per_step(self) -> int:
        return max((s["prefill_tokens"] for s in self.step_log), default=0)

    def report(self) -> dict:
        """Ledger summary."""
        return {
            "chunk_tokens": self.chunk,
            "pending_jobs": self.pending_jobs,
            "backlog_tokens": self.backlog_tokens(),
            "chunks_run": self.chunks_run,
            "tokens_prefilled": self.tokens_prefilled,
            "jobs_completed": self.jobs_completed,
            "steps_logged": len(self.step_log),
            "max_prefill_tokens_per_step":
                self.max_prefill_tokens_per_step(),
        }
