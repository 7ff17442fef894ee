"""The port's request journal (``repro_torch.serving.journal``) on the CPU,
held against the JAX package's.

Every case of the reference's ``tests/test_journal.py`` runs again on the
port's module: CRC framing, a torn tail truncated on open, mid-record
corruption naming its record and keeping the good prefix (or raising with
``repair=False``), clean cold starts, the fsync policies and ``replay``.
Added here: the two packages read each other's journals.  A journal
written by one package's ``RequestJournal`` (clean, torn mid-header,
torn mid-payload, corrupt) scans to the same records and stats in the
other's ``scan_journal``, reopens to the same records and stats in its
``RequestJournal``, and replays to the same state; and the two writers
write the same bytes.

  PYTHONPATH=src python -m pytest -q tests/test_torch_journal.py
"""
import dataclasses
import json
import os
import struct
import zlib

import pytest

from repro.serving import journal as jjournal
from repro_torch.serving import journal as tjournal
from repro_torch.serving.journal import (JOURNAL_NAME, JournalCorruption,
                                         JournalError, ReplayedRequest,
                                         RequestJournal, replay, scan_journal)


def _records(n=5, uid=1):
    recs = [{"t": "submit", "uid": uid, "prompt": [1, 2, 3],
             "max_new_tokens": n}]
    recs += [{"t": "token", "uid": uid, "tok": 10 + i} for i in range(n)]
    return recs


def _write(tmp_path, recs, sync="always", module=tjournal):
    j = module.RequestJournal(str(tmp_path), sync=sync)
    for r in recs:
        j.append(r)
    j.close()
    return os.path.join(str(tmp_path), JOURNAL_NAME)


# ---------------------------------------------------------------------------
# round trip + cold start
# ---------------------------------------------------------------------------
def test_round_trip(tmp_path):
    recs = _records()
    path = _write(tmp_path, recs)
    got, stats = scan_journal(path)
    assert got == recs
    assert stats["records"] == len(recs)
    assert stats["torn_tail_bytes"] == 0
    assert stats["valid_bytes"] == stats["bytes"] == os.path.getsize(path)


def test_missing_and_empty_journal_are_clean_cold_starts(tmp_path):
    path = os.path.join(str(tmp_path), JOURNAL_NAME)
    got, stats = scan_journal(path)          # missing file
    assert got == [] and stats["records"] == 0
    open(path, "wb").close()                 # empty file
    got, stats = scan_journal(path)
    assert got == [] and stats["records"] == 0
    j = RequestJournal(str(tmp_path))        # writer over the empty file
    assert j.records == []
    j.append({"t": "submit", "uid": 0, "prompt": [1], "max_new_tokens": 1})
    j.close()
    assert scan_journal(path)[0][0]["uid"] == 0


def test_reopen_appends_after_committed_prefix(tmp_path):
    _write(tmp_path, _records(3))
    j = RequestJournal(str(tmp_path))
    assert len(j.records) == 4               # 1 submit + 3 tokens
    j.append({"t": "terminal", "uid": 1, "state": "FINISHED",
              "reason": "max_new_tokens"})
    j.close()
    got, _ = scan_journal(os.path.join(str(tmp_path), JOURNAL_NAME))
    assert len(got) == 5 and got[-1]["t"] == "terminal"


# ---------------------------------------------------------------------------
# torn tail: crash mid-append
# ---------------------------------------------------------------------------
def _tear(path, recs, cut):
    """Chop the last record of ``path`` mid-payload (2 bytes) or into its
    header (its payload and 6 of the 8 header bytes)."""
    last_payload = len(json.dumps(recs[-1], separators=(",", ":")).encode())
    torn = 2 if cut == "payload" else last_payload + 6
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - torn)


@pytest.mark.parametrize("cut", ["header", "payload"])
def test_torn_tail_truncated_on_open(tmp_path, cut):
    """Scanning stops at the last complete record and reopening truncates
    the dangling bytes, so the next append lands after a clean prefix."""
    recs = _records(4)
    path = _write(tmp_path, recs)
    _tear(path, recs, cut)
    got, stats = scan_journal(path)
    assert got == recs[:-1]
    assert stats["torn_tail_bytes"] > 0
    j = RequestJournal(str(tmp_path))
    assert j.records == recs[:-1]
    assert j.stats["truncated_bytes"] == stats["torn_tail_bytes"]
    j.append(recs[-1])                       # append after repair
    j.close()
    assert scan_journal(path)[0] == recs


# ---------------------------------------------------------------------------
# mid-record corruption: CRC mismatch on a complete record
# ---------------------------------------------------------------------------
def _corrupt_record(path, index):
    """Flip one payload byte of record ``index`` in place."""
    with open(path, "r+b") as f:
        blob = f.read()
        off = 0
        for _ in range(index):
            length, _crc = struct.unpack_from("<II", blob, off)
            off += 8 + length
        f.seek(off + 8)
        f.write(bytes([blob[off + 8] ^ 0xFF]))
    return off


def test_corruption_names_record_and_recovers_prefix(tmp_path):
    recs = _records(5)
    path = _write(tmp_path, recs)
    off = _corrupt_record(path, 3)
    with pytest.raises(JournalCorruption) as ei:
        scan_journal(path)
    err = ei.value
    assert err.index == 3 and err.offset == off
    assert err.records == recs[:3]
    assert "crc32 mismatch" in str(err)
    # repair=True (the serving posture): truncate to the good prefix
    j = RequestJournal(str(tmp_path))
    assert j.records == recs[:3]
    assert j.stats["corrupt_record_index"] == 3
    assert j.stats["truncated_bytes"] > 0
    j.close()
    assert scan_journal(path)[0] == recs[:3]


def test_corruption_strict_posture_raises(tmp_path):
    path = _write(tmp_path, _records(3))
    _corrupt_record(path, 1)
    with pytest.raises(JournalCorruption):
        RequestJournal(str(tmp_path), repair=False)


def test_valid_crc_bad_json_is_corruption(tmp_path):
    """A record whose CRC verifies but whose payload is not JSON is still
    corruption (a torn overwrite can do this), never silently skipped."""
    path = os.path.join(str(tmp_path), JOURNAL_NAME)
    payload = b"\xff not json"
    with open(path, "wb") as f:
        f.write(struct.pack("<II", len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF))
        f.write(payload)
    with pytest.raises(JournalCorruption, match="does not parse"):
        scan_journal(path)


# ---------------------------------------------------------------------------
# fsync policy
# ---------------------------------------------------------------------------
def test_sync_modes_and_flush_accounting(tmp_path):
    with pytest.raises(JournalError, match="journal_sync"):
        RequestJournal(str(tmp_path), sync="sometimes")
    j = RequestJournal(str(tmp_path / "a"), sync="always")
    j.append({"t": "token", "uid": 0, "tok": 1})
    j.append({"t": "token", "uid": 0, "tok": 2})
    assert j.fsyncs == 2                     # one per append
    j.close()
    j = RequestJournal(str(tmp_path / "b"), sync="batch", sync_every=4)
    for i in range(8):
        j.append({"t": "token", "uid": 0, "tok": i})
        j.flush()
    assert j.fsyncs == 2                     # every 4th flush
    j.close()
    j = RequestJournal(str(tmp_path / "c"), sync="off")
    j.append({"t": "token", "uid": 0, "tok": 1})
    j.flush()
    assert j.fsyncs == 0                     # OS-buffered
    j.flush(force_sync=True)                 # the drain ledger path
    assert j.fsyncs == 1
    j.close()


# ---------------------------------------------------------------------------
# replay folding
# ---------------------------------------------------------------------------
LIFECYCLES = [
    {"t": "submit", "uid": 1, "prompt": [1, 2], "max_new_tokens": 4,
     "deadline_ms": 500.0},
    {"t": "submit", "uid": 2, "prompt": [3], "max_new_tokens": 2},
    {"t": "token", "uid": 1, "tok": 7},
    {"t": "token", "uid": 2, "tok": 8},
    {"t": "token", "uid": 1, "tok": 9},
    {"t": "terminal", "uid": 2, "state": "CANCELLED",
     "reason": "slow_client"},
    {"t": "ckpt", "dir": "/w", "step": 3, "fp": "abc"},
    {"t": "ledger", "counters": {}},
    {"t": "from_the_future", "x": 1},        # unknown kind: skipped
]


def test_replay_folds_lifecycles():
    st = replay(LIFECYCLES)
    assert list(st.requests) == [1, 2]       # submission order
    r1, r2 = st.requests[1], st.requests[2]
    assert isinstance(r1, ReplayedRequest)
    assert r1.tokens == [7, 9] and not r1.terminal
    assert r1.deadline_ms == 500.0
    assert r2.tokens == [8] and r2.terminal
    assert r2.state == "CANCELLED" and r2.reason == "slow_client"
    assert st.checkpoint == {"dir": "/w", "step": 3, "fingerprint": "abc"}
    assert st.ledgers == 1
    assert [r.uid for r in st.live()] == [1]


def test_replay_drops_dangling_tokens():
    """Token/terminal records for a uid with no submit record (the submit
    was lost to a truncated prefix) are counted and dropped: the prompt
    is gone, so the request cannot be rebuilt."""
    st = replay([{"t": "token", "uid": 9, "tok": 1},
                 {"t": "token", "uid": 9, "tok": 2},
                 {"t": "terminal", "uid": 9, "state": "FINISHED"}])
    assert st.requests == {}
    assert st.dangling_tokens == 2


# ---------------------------------------------------------------------------
# the two packages read each other's journals
# ---------------------------------------------------------------------------
PACKAGES = {"port": tjournal, "reference": jjournal}
DAMAGE = ["clean", "torn-header", "torn-payload", "corrupt"]


def _scan(module, path):
    """(records, stats, corrupt index or None) as ``module`` scans
    ``path``."""
    try:
        recs, stats = module.scan_journal(path)
        return recs, stats, None
    except module.JournalCorruption as e:
        return e.records, {"offset": e.offset, "reason": e.reason}, e.index


@pytest.mark.parametrize("damage", DAMAGE)
@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_journals_cross_read(tmp_path, writer, reader, damage):
    """A journal the writer's package wrote, then damaged, reads back the
    same in the reader's package as in the writer's own: scanned records
    and stats, the reopened writer's records and stats, the replayed
    state; and the repaired file takes the next append the same way."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    recs = LIFECYCLES[:6] + _records(4, uid=3)
    path = _write(tmp_path / "j", recs, module=w)
    if damage.startswith("torn"):
        _tear(path, recs, damage.split("-")[1])
    elif damage == "corrupt":
        _corrupt_record(path, 4)
    assert _scan(r, path) == _scan(w, path)
    got, want = _scan(r, path)[0], recs[:len(_scan(w, path)[0])]
    assert got == want and len(got) == {"clean": 11, "torn-header": 10,
                                        "torn-payload": 10,
                                        "corrupt": 4}[damage]
    blob = open(path, "rb").read()
    opened = {}
    for name, module in (("reader", r), ("writer", w)):
        with open(path, "wb") as f:          # each reopens the same bytes
            f.write(blob)
        j = module.RequestJournal(str(tmp_path / "j"))
        j.append({"t": "terminal", "uid": 3, "state": "FINISHED",
                  "reason": "max_new_tokens"})
        j.close()
        opened[name] = (j.records, j.stats, open(path, "rb").read())
    assert opened["reader"] == opened["writer"]
    assert dataclasses.asdict(r.replay(got)) == \
        dataclasses.asdict(w.replay(got))


@pytest.mark.parametrize("sync", ["always", "batch", "off"])
def test_both_writers_write_the_same_bytes(tmp_path, sync):
    """The port's writer and the reference's write the same file for the
    same records, and report the same counts."""
    blobs, reports = [], []
    for name, module in PACKAGES.items():
        j = module.RequestJournal(str(tmp_path / name), sync=sync,
                                  sync_every=2)
        for rec in LIFECYCLES:
            j.append(rec)
            j.flush()
        j.close()
        blobs.append(open(j.path, "rb").read())
        reports.append(j.report())
    assert blobs[0] == blobs[1]
    assert reports[0] == reports[1]
