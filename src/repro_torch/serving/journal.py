"""Append-only request journal: the durability layer under the engine.

Counterpart of ``repro/serving/journal.py`` (stdlib only), with the same
record format byte for byte, so a journal written by either package's
engine is read and recovered by the other's.

A serving process is a single point of total loss without one: a crash or
a deploy drops every in-flight stream, the prefix tree, and all pool
accounting.  The journal fixes the *requests* half of that — weights are
already durable (``checkpoint.manager``), and the KV cache never needs to
be: every cache row is a pure function of the token history, so a
restarted engine rebuilds byte-identical KV state by replaying
``prompt ++ generated[:-1]`` — the prompt through the prefill its
admission used, the generated tokens through the decode step that first
wrote them (``ServeEngine._replay_histories``, the same replay the
paged->fixed-slot degradation rung uses).  What must survive the crash is
therefore tiny and append-only: admission prompts, per-step emitted
tokens, and terminal transitions.

Record format (binary, CRC-per-record)::

    <u32 payload_len> <u32 crc32(payload)> <payload: compact JSON, utf-8>

* **Torn tail**: a crash mid-append leaves a final record whose header or
  payload hits EOF early.  ``scan_journal`` detects it (the bytes simply
  run out) and the writer truncates it on open — the committed prefix is
  untouched.  Losing unsynced tail *tokens* is harmless by construction:
  greedy decode is deterministic, so recovery re-derives exactly the
  tokens the lost records held.
* **Mid-record corruption**: a complete record whose CRC mismatches (bit
  rot, a torn *overwrite*) is not silently skippable — everything after
  an untrusted length field is untrusted.  ``scan_journal`` raises
  :class:`JournalCorruption` naming the record index and byte offset and
  carrying the good prefix; the writer (``repair=True``, the engine's
  posture) truncates to that prefix and records what was dropped.
* **fsync batching** (``sync=``): ``"always"`` fsyncs per append,
  ``"batch"`` (default) pushes records to the OS every ``flush()`` (the
  engine flushes at each step boundary) but fsyncs only every
  ``sync_every`` flushes — a crash loses at most ``sync_every`` steps of
  tail records, every one of which greedy recovery re-derives bitwise,
  so the amortization costs durability nothing — and ``"off"`` leaves
  flushing to the OS entirely (benchmark baseline).  ``flush(
  force_sync=True)`` fsyncs under every policy (the drain ledger).

Record kinds (the ``"t"`` field):

* ``submit``   — uid, prompt tokens, max_new_tokens, deadline knobs
* ``token``    — one emitted token for uid
* ``terminal`` — uid reached FINISHED/FAILED/CANCELLED/EXPIRED (+reason)
* ``ckpt``     — packed-weight pin: checkpoint dir, step, manifest
  fingerprint.  Recovery refuses to resume against different weights
  (a bitwise-identical stream is only promised under the same bytes).
* ``ledger``   — drain snapshot: counters + per-request final states.

:func:`replay` folds a record list into per-request
:class:`ReplayedRequest` states; ``engine.recover()`` replays every
non-terminal one's history and continues decode bitwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib

__all__ = [
    "JournalError", "JournalCorruption", "RequestJournal", "scan_journal",
    "replay", "ReplayedRequest", "JournalState", "SYNC_MODES",
]

_HEADER = struct.Struct("<II")
SYNC_MODES = ("always", "batch", "off")
JOURNAL_NAME = "requests.journal"


class JournalError(RuntimeError):
    """Journal-layer failure (bad config, checkpoint-pin mismatch)."""


class JournalCorruption(JournalError):
    """A complete record whose CRC (or JSON payload) does not verify.

    Carries everything a recovery path needs: the 0-based ``index`` of
    the bad record, its byte ``offset``, and ``records`` — the good
    prefix scanned before it (safe to replay)."""

    def __init__(self, path: str, index: int, offset: int, reason: str,
                 records: list):
        super().__init__(
            f"corrupt journal record [{index}] at byte {offset} of "
            f"{path}: {reason} ({len(records)} good records precede it)")
        self.path = path
        self.index = index
        self.offset = offset
        self.reason = reason
        self.records = records


def scan_journal(path: str) -> tuple[list[dict], dict]:
    """Read every committed record of ``path``.

    Returns ``(records, stats)``.  A torn tail (header or payload cut
    short by a crash mid-append) is tolerated: scanning stops at the last
    complete record and ``stats["torn_tail_bytes"]`` reports the dangling
    byte count with ``stats["valid_bytes"]`` the truncation point.  A
    CRC/JSON failure on a COMPLETE record raises
    :class:`JournalCorruption` naming the record.  A missing or empty
    file is a clean cold start (no records)."""
    records: list[dict] = []
    stats = {"records": 0, "bytes": 0, "valid_bytes": 0,
             "torn_tail_bytes": 0}
    if not os.path.exists(path):
        return records, stats
    with open(path, "rb") as f:
        blob = f.read()
    stats["bytes"] = len(blob)
    off = 0
    while off < len(blob):
        if off + _HEADER.size > len(blob):
            stats["torn_tail_bytes"] = len(blob) - off
            break
        length, crc = _HEADER.unpack_from(blob, off)
        payload = blob[off + _HEADER.size: off + _HEADER.size + length]
        if len(payload) < length:
            stats["torn_tail_bytes"] = len(blob) - off
            break
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise JournalCorruption(path, len(records), off,
                                    "crc32 mismatch", records)
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise JournalCorruption(
                path, len(records), off,
                f"payload verifies but does not parse: {e}",
                records) from e
        records.append(rec)
        off += _HEADER.size + length
    stats["records"] = len(records)
    stats["valid_bytes"] = off
    return records, stats


class RequestJournal:
    """Append-only CRC-framed journal writer over one directory.

    Opening scans the existing file first: the torn tail of a crashed
    writer is truncated away, and (with ``repair=True``, the serving
    default) a corrupt suffix is truncated to the last good record —
    ``stats`` records what was dropped so recovery can surface it.  With
    ``repair=False`` corruption raises :class:`JournalCorruption` (the
    strict posture for tests and forensics).  The committed records seen
    at open stay available on ``self.records`` for ``replay``."""

    def __init__(self, directory: str, *, sync: str = "batch",
                 sync_every: int = 128, repair: bool = True):
        if sync not in SYNC_MODES:
            raise JournalError(f"unknown journal_sync {sync!r} "
                               f"(expected one of {SYNC_MODES})")
        if sync_every < 1:
            raise JournalError(
                f"sync_every must be >= 1, got {sync_every}")
        self.dir = directory
        self.sync = sync
        self.sync_every = int(sync_every)
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, JOURNAL_NAME)
        try:
            self.records, self.stats = scan_journal(self.path)
        except JournalCorruption as e:
            if not repair:
                raise
            self.records = e.records
            self.stats = {"records": len(e.records),
                          "valid_bytes": e.offset,
                          "corrupt_record_index": e.index,
                          "corrupt_reason": e.reason}
        valid = self.stats.get("valid_bytes", 0)
        on_disk = os.path.getsize(self.path) \
            if os.path.exists(self.path) else 0
        if on_disk > valid:
            # torn tail and/or corrupt suffix: truncate to the committed
            # prefix before appending (never append after garbage)
            with open(self.path, "r+b") as f:
                f.truncate(valid)
            self.stats["truncated_bytes"] = on_disk - valid
        self._f = open(self.path, "ab")
        self.appended = 0
        self._unflushed = 0
        self._flushes_since_sync = 0
        self.fsyncs = 0

    # ------------------------------------------------------------------
    def append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        self._f.write(_HEADER.pack(len(payload),
                                   zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self.appended += 1
        self._unflushed += 1
        if self.sync == "always":
            self._f.flush()
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            self._unflushed = 0

    def flush(self, *, force_sync: bool = False) -> None:
        """Push buffered records to the OS; under ``"batch"`` fsync every
        ``sync_every``-th flush (the unsynced tail is bounded and greedy
        recovery re-derives it bitwise).  ``force_sync`` fsyncs under
        EVERY policy — the drain snapshot must be durable regardless of
        the steady-state one."""
        if self._f.closed:
            return
        self._f.flush()
        self._flushes_since_sync += 1
        due = (self.sync == "batch"
               and self._flushes_since_sync >= self.sync_every)
        if self._unflushed and (due or force_sync):
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            self._unflushed = 0
        if due or force_sync:
            self._flushes_since_sync = 0

    def close(self) -> None:
        if not self._f.closed:
            self.flush(force_sync=True)
            self._f.close()

    def report(self) -> dict:
        """Flat scalar snapshot for ``metrics_report()["journal"]``."""
        return {
            "appended": self.appended,
            "fsyncs": self.fsyncs,
            "replayed_records": len(self.records),
            "truncated_bytes": self.stats.get("truncated_bytes", 0),
            "corrupt_record_index":
                self.stats.get("corrupt_record_index", -1),
            "sync_always": self.sync == "always",
        }


# ---------------------------------------------------------------------------
# Replay: fold records into per-request states
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReplayedRequest:
    """One request's journaled history, folded for recovery."""
    uid: int
    prompt: list
    max_new_tokens: int
    deadline_ms: float | None = None
    ttft_budget_ms: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    state: str | None = None          # terminal state name, or None (live)
    reason: str | None = None

    @property
    def terminal(self) -> bool:
        return self.state is not None


@dataclasses.dataclass
class JournalState:
    """Everything :func:`replay` derives from a record list: requests in
    submission order, the latest packed-checkpoint pin (or None), and the
    count of drain-ledger snapshots seen."""
    requests: dict            # uid -> ReplayedRequest, insertion-ordered
    checkpoint: dict | None = None
    ledgers: int = 0
    dangling_tokens: int = 0  # token records for unknown uids (skipped)

    def live(self) -> list:
        """Non-terminal requests in submission order — what recovery
        re-prefills."""
        return [r for r in self.requests.values() if not r.terminal]


def replay(records: list) -> JournalState:
    """Fold journal ``records`` into a :class:`JournalState`.  Unknown
    record kinds are skipped (forward compatibility); token/terminal
    records for a uid with no submit record are counted but dropped (the
    submit record was lost to a truncated prefix — without the prompt
    the request cannot be rebuilt, and its client will resubmit)."""
    state = JournalState(requests={})
    for rec in records:
        kind = rec.get("t")
        if kind == "submit":
            uid = rec["uid"]
            state.requests[uid] = ReplayedRequest(
                uid=uid, prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                deadline_ms=rec.get("deadline_ms"),
                ttft_budget_ms=rec.get("ttft_budget_ms"))
        elif kind == "token":
            rr = state.requests.get(rec["uid"])
            if rr is None:
                state.dangling_tokens += 1
            else:
                rr.tokens.append(int(rec["tok"]))
        elif kind == "terminal":
            rr = state.requests.get(rec["uid"])
            if rr is not None:
                rr.state = rec["state"]
                rr.reason = rec.get("reason")
        elif kind == "ckpt":
            state.checkpoint = {"dir": rec.get("dir"),
                                "step": rec.get("step"),
                                "fingerprint": rec.get("fp")}
        elif kind == "ledger":
            state.ledgers += 1
    return state
