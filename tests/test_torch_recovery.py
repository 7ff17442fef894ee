"""The port's crash recovery and graceful drain on the CPU, held against the
JAX package.

Every case of the reference's ``tests/test_recovery.py`` that needs the
journal runs again on the port's ``ServeEngine`` (the watchdog cases are
in ``tests/test_torch_lifecycle.py``), at the reference's recovery config
(2 layers, d_model 64) with the reference's seeded weights carried across
by ``convert.params_from_numpy``:

* ``crash_restart_sweep`` on the reference's five engine configurations
  (fixed slots, paged, chunked, fused W4A4, two-pass W4A4 paged and
  chunked): every stitched stream equal to the uninterrupted oracle's,
  and, added here, every request's K/V bytes (read from its slot as it
  finishes) equal to the oracle's, resumed requests included;
* a lost terminal record finalized without re-admission (the report and
  the journal the recovery appends equal to the reference's on the same
  journal), an empty journal as a cold start, the typed drain rejection
  and its durable ledger, drain-deadline survivors recovered, the
  checkpoint pin refusing other weights, a fatal ``journal_write`` fault
  failing open;
* added here: recovery requeues past ``max_queue`` with fresh deadline
  anchors, and a paged resume holds its original footprint in anonymous
  pages.

Against the JAX engine (its jits compiled without excess precision, as in
``tests/test_torch_lifecycle.py``, from the same packed bytes): the port's
journal of a ``drive`` is the reference's byte for byte, and the port
recovers a journal the reference's engine left at a crash, with streams
equal to the reference's uninterrupted run.

  PYTHONPATH=src python -m pytest -q tests/test_torch_recovery.py
"""
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import base as jbase  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.models.base import ArchConfig  # noqa: E402
from repro_torch.serving.engine import (EngineDrainingError,  # noqa: E402
                                        JournalError, Request, RequestState,
                                        ServeEngine)
from repro_torch.serving.faults import (FaultInjector, FaultRule,  # noqa: E402
                                        InjectedFault, VirtualClock,
                                        crash_restart_sweep, drive)
from repro_torch.serving.journal import (JOURNAL_NAME,  # noqa: E402
                                         RequestJournal, replay,
                                         scan_journal)

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# the reference's recovery-test config, in the port's terms
DENSE = ArchConfig(name="recovery-test", family="dense", n_layers=2,
                   d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=64,
                   attn_chunk=64)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7]]

# the reference's engine configurations for bitwise resume
CONFIGS = {
    "fixed": {},
    "paged": dict(kv_quant="mixfp4", kv_pool=9, kv_page_len=16),
    "chunked": dict(prefill_chunk=4),
    "w4a4-fused": dict(act_quant="mixfp4"),
    "w4a4-paged-chunked": dict(act_quant="mixfp4-2pass-rowscale",
                               kv_quant="mixfp4", kv_pool=9,
                               kv_page_len=16, prefill_chunk=4),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work, the count it had
    restored after (see ``tests/test_torch_lifecycle.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# Made when the module is imported, before any test runs: a jit-cache
# context made later would drop every trace cached until then.
ALIAS_TRACES = jax.make_user_context(default_value=None)


@pytest.fixture(scope="module")
def pallas_memory_space_alias():
    """jax 0.9 renamed ``pltpu.TPUMemorySpace`` (which the reference GEMM
    uses) to ``MemorySpace``; alias it for this module only, with what is
    traced meanwhile cached under a context of its own
    (``tests/test_torch_lifecycle.py``)."""
    from jax.experimental.pallas import tpu as pltpu
    missing = not hasattr(pltpu, "TPUMemorySpace")
    if missing:
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    with ALIAS_TRACES(__name__):
        yield
    if missing:
        del pltpu.TPUMemorySpace


@pytest.fixture(scope="module")
def jax_dense(pallas_memory_space_alias):
    """The reference's recovery-test weights (its ``small_cfg`` at
    ``PRNGKey(0)``), initialised in one compiled call."""
    cfg, seed = jfaults._family_cfg("dense")
    assert seed == 0
    model = jbase.build_model(cfg)
    return jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def params(jax_dense):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_dense),
                                     DENSE, device="cpu")


def _engine(params, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(DENSE, params, device="cpu", **kw)


def _drain(eng, streams=None):
    streams = {} if streams is None else streams
    guard = 0
    while eng.has_work():
        for uid, tok in eng.step():
            streams.setdefault(uid, []).append(tok)
        guard += 1
        assert guard < 200
    return streams


def _submit(eng, prompts, max_new_tokens):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=np.asarray(p, np.int32),
                           max_new_tokens=max_new_tokens))


def _slot_rows(eng, i: int) -> list:
    """The K/V bytes of every row slot ``i``'s request wrote (rows
    [0, lengths[i])), read through the block table on a paged engine."""
    n = int(eng.lengths[i])
    out = []
    for name in ("k", "v"):
        leaf = eng.cache[name]
        planes = ([leaf.payload, leaf.scales]
                  if isinstance(leaf, qtensor.QTensor) else [leaf])
        for a in planes:
            if "pages" in eng.cache:
                pos = torch.arange(n)
                bt = eng.cache["pages"][i].long()
                a = a[:, bt[pos // eng.kv_page_len], pos % eng.kv_page_len]
            else:
                a = a[:, i, :n]
            out.append(a.clone())
    return out


def _capture_rows(eng, rows: dict):
    """Record into ``rows`` (uid -> K/V bytes) each request's rows as it
    finishes (the engine's terminal transition is wrapped)."""
    finish = eng._finish_request

    def capture(i, state, reason, error=None):
        if state is RequestState.FINISHED:
            rows[eng.slots[i].uid] = _slot_rows(eng, i)
        finish(i, state, reason, error=error)

    eng._finish_request = capture
    return eng


def _equal_rows(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# kill and recover, bitwise, across engine configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_crash_recover_bitwise(params, tmp_path, config):
    """Crashes at strided step boundaries, then recovery over the same
    journal: every stitched stream is the oracle's, every request ends
    terminal, no pool page stays active, and every request's K/V bytes
    (a resumed one's rows rebuilt by the replay included) are the
    oracle's."""
    kw = CONFIGS[config]
    built = []                # (journal dir, rows finished in that engine)

    def make_engine(faults=None, journal_dir=None):
        rows: dict = {}
        built.append((journal_dir, rows))
        return _capture_rows(_engine(params, faults=faults,
                                     journal_dir=journal_dir,
                                     journal_sync="always", **kw), rows)

    rep = crash_restart_sweep(make_engine, PROMPTS,
                              journal_root=str(tmp_path),
                              max_new_tokens=4, crash_stride=2,
                              max_crashes=3)
    ran = [c for c in rep["crashes"] if not c.get("skipped")]
    assert ran, rep
    assert all(c["recovered"] + c["finalized"] >= 1 for c in ran), ran
    assert sum(c["recovered"] for c in ran) >= 1, ran
    (none, oracle), runs = built[0], built[1:]
    assert none is None and sorted(oracle) == [0, 1]
    per_dir: dict = {}
    for jd, rows in runs:
        for uid, r in rows.items():
            assert _equal_rows(r, oracle[uid]), (jd, uid)
            per_dir.setdefault(jd, set()).add(uid)
    # each crash's two engines finished every request between them
    assert all(uids == {0, 1} for uids in per_dir.values()), per_dir


def test_recover_finalizes_request_with_lost_terminal(params, jax_dense,
                                                      tmp_path):
    """A request whose token records already reach max_new_tokens but
    whose terminal record was lost in the unsynced tail is finalized
    FINISHED at recovery without re-admission; the recovery report and the
    record it appends are the reference's on a copy of the journal."""
    j = RequestJournal(str(tmp_path / "port"), sync="always")
    j.append({"t": "submit", "uid": 5, "prompt": [1, 2, 3],
              "max_new_tokens": 3})
    for t in (7, 8, 9):
        j.append({"t": "token", "uid": 5, "tok": t})
    j.close()                        # note: no terminal record
    shutil.copytree(tmp_path / "port", tmp_path / "reference")
    eng = _engine(params)
    rep = eng.recover(str(tmp_path / "port"))
    assert rep == {**rep, "requests": 1, "resumed": 0, "finalized": 1}
    req = eng.requests[5]
    assert req.state is RequestState.FINISHED
    assert req.finish_reason == "max_new_tokens"
    assert req.generated == [7, 8, 9]
    assert eng.recovered_uids == [5]
    assert not eng.has_work()
    # the finalization itself was journaled: a second recovery sees the
    # request terminal
    assert replay(scan_journal(j.path)[0]).requests[5].terminal
    jeng = jengine.ServeEngine(jfaults._family_cfg("dense")[0], jax_dense,
                               batch_size=2, max_len=32)
    assert jeng.recover(str(tmp_path / "reference")) == rep
    assert dict(jeng.counters) == dict(eng.counters)
    assert open(j.path, "rb").read() == open(
        tmp_path / "reference" / JOURNAL_NAME, "rb").read()


def test_recover_empty_journal_is_cold_start(params, tmp_path):
    eng = _engine(params)
    rep = eng.recover(str(tmp_path))
    assert rep["requests"] == rep["resumed"] == rep["finalized"] == 0
    # the engine is fully serviceable afterwards
    got = drive(eng, PROMPTS, max_new_tokens=3)
    oracle = drive(_engine(params), PROMPTS, max_new_tokens=3)
    assert got["streams"] == oracle["streams"]
    with pytest.raises(JournalError, match="needs a journal"):
        _engine(params).recover()
    with pytest.raises(JournalError, match="refusing to recover"):
        eng.recover(str(tmp_path / "elsewhere"))


def test_recover_requeues_past_max_queue_with_fresh_deadlines(params,
                                                              tmp_path):
    """Recovery repopulates the queue past ``max_queue`` (it is not load)
    and restarts each request's deadline anchors at recovery, so
    journaled requests whose budget the dead process's wall time used up
    still finish; their streams are the uninterrupted run's."""
    oracle = drive(_engine(params, batch_size=1), [*PROMPTS, [9, 8]],
                   max_new_tokens=4)["streams"]
    j = RequestJournal(str(tmp_path), sync="always")
    for uid, p in enumerate([*PROMPTS, [9, 8]]):
        j.append({"t": "submit", "uid": uid, "prompt": p,
                  "max_new_tokens": 4, "deadline_ms": 50.0})
        for tok in oracle[uid][:uid]:        # 0, 1 and 2 tokens emitted
            j.append({"t": "token", "uid": uid, "tok": tok})
    j.close()
    clock = VirtualClock()
    clock.sleep(1000.0)
    eng = _engine(params, batch_size=1, max_queue=1, clock=clock)
    rep = eng.recover(str(tmp_path))
    assert rep["resumed"] == 3 and eng.recovered_uids == [0, 1, 2]
    assert len(eng.queue) == 2 > eng.max_queue - 1
    assert all(r.submitted_at == 1000.0 for r in eng.requests.values())
    streams = {uid: list(r.generated) for uid, r in eng.requests.items()}
    _drain(eng, streams)
    assert streams == oracle
    assert all(r.state is RequestState.FINISHED
               for r in eng.requests.values())
    assert eng.counters["recovered"] == 3 and eng.counters["resumed"] == 2


def test_paged_resume_holds_its_footprint_in_anonymous_pages(params,
                                                             tmp_path):
    """A resumed request on a paged engine holds the pages of its original
    footprint, none of them registered for prefix hits: after the drain
    the pool has no active and no cached page."""
    eng = _engine(params, kv_quant="mixfp4", kv_pool=9, kv_page_len=16,
                  journal_dir=str(tmp_path), journal_sync="always",
                  faults=FaultInjector(0, [FaultRule(
                      "process_crash", "error", at=(3,))]))
    prompts = [list(range(1, 19)), [5, 6, 7]]
    _submit(eng, prompts, max_new_tokens=6)
    with pytest.raises(InjectedFault):
        _drain(eng)
    eng2 = _engine(params, kv_quant="mixfp4", kv_pool=9, kv_page_len=16,
                   journal_dir=str(tmp_path), journal_sync="always")
    assert eng2.recover()["resumed"] == 2
    for i, req in enumerate(eng2.slots):
        assert len(eng2._slot_pages[i]) == eng2.kv_pool.pages_needed(
            len(req.prompt), req.max_new_tokens)
    assert eng2.replay_decode_steps == max(len(r.generated) - 1
                                           for r in eng2.slots)
    _drain(eng2)
    st = eng2.pool_report()
    assert st["pages_active"] == 0 and st["pages_cached"] == 0


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------
def test_drain_rejects_typed_and_journals_ledger(params, tmp_path):
    eng = _engine(params, journal_dir=str(tmp_path), journal_sync="batch")
    _submit(eng, PROMPTS, 3)
    eng.step()
    eng.begin_drain()
    assert eng.robustness_report()["draining"]
    with pytest.raises(EngineDrainingError):
        eng.submit(Request(uid=99, prompt=np.asarray([1], np.int32),
                           max_new_tokens=1))
    assert eng.counters["rejected:draining"] == 1
    rep = eng.drain()
    assert rep["drained"] and rep["survivors"] == []
    assert rep["completed"] == len(PROMPTS)
    assert all(r.state is RequestState.FINISHED
               for r in eng.requests.values())
    # the ledger snapshot hit disk durably (forced fsync under 'batch')
    recs, _ = scan_journal(os.path.join(str(tmp_path), JOURNAL_NAME))
    ledgers = [r for r in recs if r["t"] == "ledger"]
    assert len(ledgers) == 1
    assert ledgers[0]["survivors"] == []
    assert set(ledgers[0]["requests"]) == {"0", "1"}
    assert eng.journal.fsyncs >= 1
    assert eng.metrics_report()["journal"]["appended"] == len(recs)
    assert eng.robustness_report()["journaled"]


def test_drain_deadline_survivors_recovered_bitwise(params, tmp_path):
    """A drain that blows its deadline leaves the stragglers non-terminal
    in the journal; the next process recovers them and the stitched
    streams are the uninterrupted run's."""
    oracle = drive(_engine(params), PROMPTS, max_new_tokens=5)
    eng = _engine(params, journal_dir=str(tmp_path), journal_sync="always")
    pre: dict = {i: [] for i in range(len(PROMPTS))}
    _submit(eng, PROMPTS, 5)
    for uid, tok in eng.step():
        pre[uid].append(tok)
    rep = eng.drain(deadline_ms=0.0)     # expires before another step
    assert not rep["drained"]
    assert sorted(rep["survivors"]) == [0, 1]
    # the dead process's ledger names the survivors for the next one
    recs, _ = scan_journal(os.path.join(str(tmp_path), JOURNAL_NAME))
    assert [r for r in recs if r["t"] == "ledger"][-1]["survivors"] \
        == rep["survivors"]
    eng2 = _engine(params, journal_dir=str(tmp_path), journal_sync="always")
    rec = eng2.recover()
    assert rec["resumed"] == 2
    post = _drain(eng2, {i: [] for i in pre})
    for uid in pre:
        assert pre[uid] + post[uid] == oracle["streams"][uid], uid
        assert eng2.requests[uid].state is RequestState.FINISHED


def test_drain_max_steps_journals_prefill_jobs(params, tmp_path):
    """A drain cut by ``max_steps`` on a chunked engine journals the
    mid-prefill cursors (``prefill_jobs``) with its survivors, and the
    survivors recover to the uninterrupted streams."""
    kw = dict(kv_quant="mixfp4", kv_pool=9, kv_page_len=16,
              prefill_chunk=4)
    prompts = [list(range(1, 12)), [5, 6, 7]]
    oracle = drive(_engine(params, **kw), prompts, max_new_tokens=4)
    eng = _engine(params, journal_dir=str(tmp_path), **kw)
    _submit(eng, prompts, 4)
    rep = eng.drain(max_steps=2)
    assert rep["steps"] == 2 and sorted(rep["survivors"]) == [0, 1]
    recs, _ = scan_journal(os.path.join(str(tmp_path), JOURNAL_NAME))
    (ledger,) = [r for r in recs if r["t"] == "ledger"]
    assert [(j["uid"], j["cursor"]) for j in ledger["prefill_jobs"]] == \
        [(0, 8), (1, 0)]
    pre = {uid: list(r.generated) for uid, r in eng.requests.items()}
    eng2 = _engine(params, journal_dir=str(tmp_path), **kw)
    assert eng2.recover()["resumed"] == 2
    _drain(eng2, pre)
    assert pre == oracle["streams"]


# ---------------------------------------------------------------------------
# journal <-> packed-checkpoint pinning
# ---------------------------------------------------------------------------
def test_recover_refuses_unpinned_and_mismatched_weights(params, tmp_path):
    jdir = str(tmp_path / "journal")
    ckpt = str(tmp_path / "ckpt")
    eng = _engine(params, journal_dir=jdir, journal_sync="always")
    eng.save_weights(ckpt, step=3)
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=4))
    eng.step()
    # crash: abandon un-flushed.  A fresh engine that never restored the
    # pinned checkpoint must refuse to resume...
    cold = _engine(params)
    with pytest.raises(JournalError, match="never restored"):
        cold.recover(jdir)
    # ...one that restored a different step must refuse too...
    wrong = _engine(params)
    wrong.save_weights(str(tmp_path / "other"), step=9)
    with pytest.raises(JournalError, match="step"):
        wrong.recover(jdir)
    # ...and one that load_weights() the pinned step resumes bitwise.
    good = _engine(params)
    good.load_weights(ckpt, step=3)
    assert good._weights_pin["fingerprint"] == eng._weights_pin[
        "fingerprint"] is not None
    rep = good.recover(jdir)
    assert rep["resumed"] == 1
    stream = list(eng.requests[0].generated)
    while good.has_work():
        for uid, tok in good.step():
            stream.append(tok)
    oracle = drive(_engine(params), [[1, 2, 3]], max_new_tokens=4)
    assert stream == oracle["streams"][0]


# ---------------------------------------------------------------------------
# fail-open journaling
# ---------------------------------------------------------------------------
def test_journal_write_fault_fails_open(params, tmp_path):
    """A fatal journal-append fault disables journaling and keeps serving:
    durability loss is a counter, not an outage, and the streams stay the
    un-journaled run's."""
    inj = FaultInjector(0, [FaultRule("journal_write", "error", at=(0,))])
    eng = _engine(params, faults=inj, journal_dir=str(tmp_path),
                  journal_sync="always")
    got = drive(eng, PROMPTS, max_new_tokens=3)
    assert eng.journal is None
    assert eng.counters["journal_disabled"] == 1
    assert eng.counters["journal_write_failed"] >= 1
    assert not eng.robustness_report()["journaled"]
    assert all(s is RequestState.FINISHED for s in got["states"].values())
    oracle = drive(_engine(params), PROMPTS, max_new_tokens=3)
    assert got["streams"] == oracle["streams"]


# ---------------------------------------------------------------------------
# the port against the JAX engine
# ---------------------------------------------------------------------------
def _jit_pack(params, method="mixfp4", act_rht=False):
    tree, packed, dense = jax.jit(functools.partial(
        jbase.pack_projections, method=method, act_rht=act_rht))(params)
    return tree, int(packed), int(dense)


def _strict_reference_engine(params, **kw):
    """The JAX engine, packing in one compiled call, with every build of
    its jits compiled without excess precision."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "pack_projections", _jit_pack)
        eng = jengine.ServeEngine(jfaults._family_cfg("dense")[0], params,
                                  batch_size=2, max_len=32, **kw)
    build = eng._build_jits

    def strict_build():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=NO_EXCESS_PRECISION))
            build()

    eng._build_jits = strict_build
    strict_build()
    return eng


CROSS = {"fixed": {"kv_quant": "mixfp4"},
         "paged-chunked": {"kv_quant": "mixfp4", "kv_pool": 9,
                           "prefill_chunk": 4}}


@pytest.mark.parametrize("run", list(CROSS))
def test_journal_bytes_and_recovery_across_packages(jax_dense, tmp_path,
                                                    run):
    """The same ``drive`` through both engines writes the same journal
    file, byte for byte (its records carry no clock); and the port
    recovers the journal the reference's engine left at a crash, the
    stitched streams equal to the reference's uninterrupted ones."""
    kw = CROSS[run]
    prompts = [np.asarray(p, np.int32) for p in ([1, 2, 3, 4], [5, 6, 7],
                                                 [9, 10, 11, 12, 13])]
    jdir = {n: str(tmp_path / n) for n in ("ref", "port", "crash")}
    jeng = _strict_reference_engine(jax_dense, journal_dir=jdir["ref"],
                                    journal_sync="always", **kw)
    want = jfaults.drive(jeng, prompts, max_new_tokens=4)
    packed = convert.packed_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                       DENSE, device="cpu")
    eng = _engine(packed, journal_dir=jdir["port"], journal_sync="always",
                  **kw)
    got = drive(eng, prompts, max_new_tokens=4)
    assert got["streams"] == want["streams"]
    blob = open(os.path.join(jdir["port"], JOURNAL_NAME), "rb").read()
    assert blob == open(os.path.join(jdir["ref"], JOURNAL_NAME), "rb").read()
    assert len(scan_journal(os.path.join(jdir["port"], JOURNAL_NAME))[0]) \
        == 3 + 3 * 4 + 3                 # submits, tokens, terminals
    # the reference crashes at its third step, two requests mid-stream
    # and one queued
    inj = jfaults.FaultInjector(3, [jfaults.FaultRule(
        "process_crash", "error", at=(2,))])
    dead = _strict_reference_engine(jax_dense, faults=inj,
                                    journal_dir=jdir["crash"],
                                    journal_sync="always", **kw)
    pre: dict = {i: [] for i in range(len(prompts))}
    for i, p in enumerate(prompts):
        dead.submit(jengine.Request(uid=i, prompt=p, max_new_tokens=4))
    with pytest.raises(jfaults.InjectedFault):
        while dead.has_work():
            for uid, tok in dead.step():
                pre[uid].append(tok)
    assert any(0 < len(s) < 4 for s in pre.values())
    eng2 = _engine(packed, journal_dir=jdir["crash"], **kw)
    rep = eng2.recover()
    assert rep["resumed"] >= 2
    _drain(eng2, pre)
    assert pre == want["streams"]
