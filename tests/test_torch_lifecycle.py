"""The port's serving lifecycle on the CPU, held against the JAX package.

Every case of the reference's ``tests/test_faults.py`` engine section runs
again on the port's ``ServeEngine``, at the same ``faults-dense`` smoke
config (2 layers, d_model 64) with the reference's seeded weights carried
across by ``convert.params_from_numpy``: the state machine, the bounded
queue, ``cancel``, deadlines and TTFT budgets on a virtual clock, typed
rejections that touch no pool page, capped-backoff retries at the prefill
and checkpoint-read boundaries, poison isolation (dense and MoE: the
survivors bitwise the fault-free run, the victim a strict prefix), both
degradation rungs with unchanged streams, and the chaos sweep on a paged
engine.  Added here: the step watchdog on a virtual clock (slow decodes
give a ``degrade`` verdict, then a ``fail`` with ``watchdog_timeout``),
``cancel`` during a chunked prefill, the rollback of a chunk fault and of
a COW fault, a real prefill error rolled back and re-raised, and the
metrics report.

Three runs drive the JAX ``ServeEngine`` through the reference's ``drive``
beside the port under the port's ``drive``, with the same rules, from the
same packed bytes: a W4A16 fixed-slot chaos seed, a paged chaos seed and
the fused-to-two-pass rung.  Streams, states, reasons, virtual-clock TTFTs
and lifecycle counters must be equal.  The reference engines' jits are
compiled with ``xla_allow_excess_precision`` off (every bf16 op rounds as
in the port, ``tests/test_torch_engine.py``), each time the engine builds
them, the rung's rebuild included.

  PYTHONPATH=src python -m pytest -q tests/test_torch_lifecycle.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.qgemm import QuantConfig  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.models.base import ArchConfig  # noqa: E402
from repro_torch.serving import faults as flt  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    REASON_CANCELLED, REASON_COW_ERROR, REASON_DEADLINE, REASON_INJECTED,
    REASON_MAX_NEW, REASON_NAN_LOGITS, REASON_PREFILL_ERROR, REASON_RETRIES,
    REASON_TTFT, REASON_WATCHDOG, QueueFullError, Request, RequestState,
    RequestValidationError, ServeEngine)
from repro_torch.serving.faults import (FaultInjector, FaultRule,  # noqa: E402
                                        InjectedFault, VirtualClock)
from repro_torch.serving.metrics import render_prometheus  # noqa: E402

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# the reference's faults-dense smoke config, in the port's terms
DENSE = ArchConfig(name="faults-dense", family="dense", n_layers=2,
                   d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=64,
                   attn_chunk=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work, the count it had
    restored after: the suite runs several test processes side by side,
    and one thread per core in every process makes small ops contend for
    the cores (see ``tests/test_torch_expert_walk.py``)."""
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
    uses) to ``MemorySpace``; alias it for this module only.  What is
    traced meanwhile is cached under a context of its own, so no test
    outside this module reuses a trace that needed the alias, and the
    traces cached before are kept (``tests/test_torch_checkpoint.py``)."""
    from jax.experimental.pallas import tpu as pltpu
    missing = not hasattr(pltpu, "TPUMemorySpace")
    if missing:
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    with ALIAS_TRACES(__name__):
        yield
    if missing:
        del pltpu.TPUMemorySpace


def _jax_family_params(family: str):
    """The reference CLI's sweep config of ``family`` (``_family_cfg``)
    and its seeded dense weights, initialised in one compiled call."""
    cfg, seed = jfaults._family_cfg(family)
    model = jbase.build_model(cfg)
    params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(seed))
    return cfg, seed, params


@pytest.fixture(scope="module")
def jax_dense(pallas_memory_space_alias):
    cfg, _, params = _jax_family_params("dense")
    assert cfg.replace(quant=None) == jbase.ArchConfig(
        name="chaos-dense", family="dense", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=128, vocab=64, attn_chunk=64,
        quant=None)
    return params


@pytest.fixture(scope="module")
def dense_params(jax_dense):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_dense),
                                     DENSE, device="cpu")


def _engine(params, cfg=DENSE, **kw):
    return ServeEngine(cfg, params, batch_size=kw.pop("batch_size", 2),
                       max_len=kw.pop("max_len", 32), device="cpu", **kw)


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _drain(eng, streams=None):
    streams = {} if streams is None else streams
    guard = 0
    while eng.has_work():
        for uid, tok in eng.step():
            streams.setdefault(uid, []).append(tok)
        guard += 1
        assert guard < 200
    return streams


# ---------------------------------------------------------------------------
# state machine / bounded queue / cancel / deadlines
# ---------------------------------------------------------------------------
def test_state_machine_happy_path(dense_params):
    eng = _engine(dense_params, clock=VirtualClock())
    req = Request(uid=0, prompt=_prompts(64, [4])[0], max_new_tokens=2)
    assert req.state is RequestState.QUEUED and not req.state.terminal
    eng.submit(req)
    assert req.submitted_at is not None
    streams = []
    while eng.has_work():
        streams.extend(eng.step())
    assert req.state is RequestState.FINISHED and req.state.terminal
    assert req.finish_reason == REASON_MAX_NEW
    assert len(streams) == 2
    assert req.ttft_ms() is not None and req.ttft_ms() >= 0.0
    assert eng.counters["submitted"] == 1
    assert eng.counters[f"finished:{REASON_MAX_NEW}"] == 1
    assert eng.robustness_report()["request_states"] == {"FINISHED": 1}


def test_bounded_queue_backpressure(dense_params):
    eng = _engine(dense_params, batch_size=1, max_queue=1,
                  clock=VirtualClock())
    p = _prompts(64, [3, 3, 3])
    eng.submit(Request(uid=0, prompt=p[0], max_new_tokens=1))
    with pytest.raises(QueueFullError, match="queue is full"):
        eng.submit(Request(uid=1, prompt=p[1], max_new_tokens=1))
    assert eng.counters["rejected:queue_full"] == 1
    # the rejected request never entered the engine's books
    assert 1 not in eng.requests and len(eng.queue) == 1
    _drain(eng)
    eng.submit(Request(uid=2, prompt=p[2], max_new_tokens=1))
    _drain(eng)
    assert eng.requests[2].state is RequestState.FINISHED


def test_cancel_queued_and_running(dense_params):
    eng = _engine(dense_params, batch_size=1, clock=VirtualClock())
    p = _prompts(64, [3, 3])
    a = Request(uid=0, prompt=p[0], max_new_tokens=8)
    b = Request(uid=1, prompt=p[1], max_new_tokens=8)
    eng.submit(a)
    eng.submit(b)                       # waits behind a (batch_size=1)
    assert eng.cancel(1)                # cancelled while QUEUED
    assert b.state is RequestState.CANCELLED
    assert b.finish_reason == REASON_CANCELLED
    eng.step()                          # admits + first token for a
    assert a.state is RequestState.RUNNING
    assert eng.cancel(0)                # cancelled while RUNNING
    assert a.state is RequestState.CANCELLED
    assert eng.slots == [None]          # slot released
    assert not eng.cancel(0)            # already terminal
    assert not eng.cancel(99)           # unknown uid
    assert eng.counters[f"cancelled:{REASON_CANCELLED}"] == 2
    assert not eng.has_work()


def test_deadline_and_ttft_expiry(dense_params):
    clk = VirtualClock()
    eng = _engine(dense_params, clock=clk)
    p = _prompts(64, [3, 3, 4])
    # queued expiry: both budgets checked before any admission work
    a = Request(uid=0, prompt=p[0], max_new_tokens=4, deadline_ms=50.0)
    b = Request(uid=1, prompt=p[1], max_new_tokens=4, ttft_budget_ms=20.0)
    eng.submit(a)
    eng.submit(b)
    clk.advance(0.1)                    # 100 ms > both budgets
    eng.step()
    assert (a.state, a.finish_reason) == (RequestState.EXPIRED,
                                          REASON_DEADLINE)
    assert (b.state, b.finish_reason) == (RequestState.EXPIRED, REASON_TTFT)
    assert eng.counters[f"expired:{REASON_DEADLINE}"] == 1
    assert eng.counters[f"expired:{REASON_TTFT}"] == 1
    # in-flight expiry: the slot is freed, the stream stops
    c = Request(uid=2, prompt=p[2], max_new_tokens=16, deadline_ms=200.0)
    eng.submit(c)
    eng.step()                          # admitted, first token emitted
    assert c.state is RequestState.RUNNING and len(c.generated) >= 1
    clk.advance(0.5)
    eng.step()
    assert (c.state, c.finish_reason) == (RequestState.EXPIRED,
                                          REASON_DEADLINE)
    assert eng.slots == [None, None] and not eng.has_work()
    # a request that GOT its first token in time is not TTFT-expired
    assert c.ttft_ms() is not None and c.ttft_ms() <= 200.0


# ---------------------------------------------------------------------------
# validation ordering: a rejected request touches NO engine state
# ---------------------------------------------------------------------------
def test_rejections_leave_pool_and_slots_untouched(dense_params):
    eng = _engine(dense_params, kv_quant="mixfp4", kv_pool=2,
                  kv_page_len=16, clock=VirtualClock())
    assert eng.kv_pool.pages_total == 1      # page 0 is the trash page
    before = eng.pool_report()
    cases = [
        (Request(uid=0, prompt=np.zeros((0,), np.int32)), "empty_prompt"),
        (Request(uid=1, prompt=np.array([1], np.int32), max_new_tokens=0),
         "bad_max_new_tokens"),
        (Request(uid=2, prompt=np.arange(40, dtype=np.int32) % 8,
                 max_new_tokens=4), "too_long"),
        # 15 prompt + 4 new - 1 = 18 positions = 2 pages > pages_total=1
        (Request(uid=3, prompt=np.arange(15, dtype=np.int32) % 8,
                 max_new_tokens=4), "over_pool_capacity"),
    ]
    for req, reason in cases:
        with pytest.raises(RequestValidationError) as ei:
            eng.submit(req)
        assert ei.value.reason == reason
        assert eng.counters[f"rejected:{reason}"] == 1
        assert eng.pool_report() == before, reason
    assert eng.slots == [None, None]
    assert not eng.queue and not eng.requests
    # RequestValidationError subclasses ValueError
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(Request(uid=4, prompt=np.zeros((0,), np.int32)))


# ---------------------------------------------------------------------------
# retries: capped exponential backoff at the fault boundaries
# ---------------------------------------------------------------------------
def test_prefill_transient_retries_then_succeeds(dense_params):
    inj = FaultInjector(0, [FaultRule("prefill", "transient", at=(0, 1))])
    eng = _engine(dense_params, batch_size=1, faults=inj)
    req = Request(uid=0, prompt=_prompts(64, [4])[0], max_new_tokens=2)
    eng.submit(req)
    _drain(eng)
    assert req.state is RequestState.FINISHED
    assert eng.counters["retries:prefill"] == 2
    assert "retries_exhausted:prefill" not in eng.counters
    # backoff ran on the injector's virtual clock: 10ms + 20ms
    assert inj.clock() == pytest.approx(0.030)


def test_prefill_retries_exhausted_fails_typed(dense_params):
    inj = FaultInjector(0, [FaultRule("prefill", "transient", prob=1.0)])
    eng = _engine(dense_params, batch_size=1, faults=inj, retry_max=2)
    req = Request(uid=0, prompt=_prompts(64, [4])[0], max_new_tokens=2)
    eng.submit(req)
    eng.step()
    assert req.state is RequestState.FAILED
    assert req.finish_reason == REASON_RETRIES
    assert isinstance(req.error, InjectedFault) and req.error.transient
    assert eng.counters["retries:prefill"] == 2
    assert eng.counters["retries_exhausted:prefill"] == 1
    assert eng.slots == [None] and not eng.has_work()


def test_checkpoint_read_transient_retried(dense_params, tmp_path):
    src = _engine(dense_params, batch_size=1, max_len=16)
    src.save_weights(str(tmp_path))
    inj = FaultInjector(0, [FaultRule("checkpoint_read", "transient",
                                      at=(0,))])
    eng = _engine(dense_params, batch_size=1, max_len=16, faults=inj)
    eng.load_weights(str(tmp_path))
    assert eng.counters["retries:checkpoint_read"] == 1
    want, got = manager._flatten(src.params)[0], manager._flatten(
        eng.params)[0]
    assert len(want) == len(got)
    for x, y in zip(want, got):
        assert np.array_equal(manager._host_bytes(x), manager._host_bytes(y))


# ---------------------------------------------------------------------------
# poison isolation: survivors bitwise vs the fault-free run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_poison_isolation_per_family(pallas_memory_space_alias, family):
    """A NaN-poisoned request fails ITS slot only: under W4A16 decode is
    row-independent, so the surviving stream is bitwise the fault-free
    oracle's.  (MoE rides at batch 2, below the capacity-coupling
    threshold.)"""
    jcfg, seed, jparams = _jax_family_params(family)
    cfg, _ = flt._family_cfg(family)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    prompts = _prompts(cfg.vocab, [4, 5], seed=seed)

    def mk(faults=None):
        return _engine(params, cfg=cfg, faults=faults)

    oracle = flt.drive(mk(), prompts, max_new_tokens=4)
    inj = FaultInjector(seed, [FaultRule("decode", "nan", at=(1,))])
    got = flt.drive(mk(faults=inj), prompts, max_new_tokens=4)
    (victim,) = inj.fatal_victims()
    assert got["states"][victim] is RequestState.FAILED
    assert got["reasons"][victim] == REASON_NAN_LOGITS
    assert got["streams"][victim] == \
        oracle["streams"][victim][:len(got["streams"][victim])]
    assert len(got["streams"][victim]) < len(oracle["streams"][victim])
    for uid in got["streams"]:
        if uid != victim:
            assert got["states"][uid] is RequestState.FINISHED
            assert got["streams"][uid] == oracle["streams"][uid], family


def test_w4a4_same_schedule_is_batch_deterministic(dense_params):
    """Replaying the same seeded schedule on the fused W4A4 path
    reproduces every stream and terminal state."""
    prompts = _prompts(64, [4, 5])

    def run():
        rules = [FaultRule("decode", "nan", at=(1,)),
                 FaultRule("decode", "slow", prob=0.3, delay_ms=5.0)]
        eng = _engine(dense_params, act_quant="mixfp4",
                      faults=FaultInjector(7, rules))
        return flt.drive(eng, prompts, max_new_tokens=4)

    a, b = run(), run()
    assert a["streams"] == b["streams"]
    assert a["states"] == b["states"]
    assert a["reasons"] == b["reasons"]
    assert a["ttft_ms"] == b["ttft_ms"]
    assert sum(s is RequestState.FAILED for s in a["states"].values()) == 1


# ---------------------------------------------------------------------------
# graceful degradation: both rungs preserve the emitted streams
# ---------------------------------------------------------------------------
def test_fused_dispatch_degrades_to_2pass_bitwise(dense_params):
    prompts = _prompts(64, [4, 5])

    def mk(faults=None):
        return _engine(dense_params, act_quant="mixfp4", faults=faults)

    oracle = flt.drive(mk(), prompts, max_new_tokens=4)
    inj = FaultInjector(0, [FaultRule("decode", "dispatch", at=(1,),
                                      times=1)])
    eng = mk(faults=inj)
    got = flt.drive(eng, prompts, max_new_tokens=4)
    assert got["streams"] == oracle["streams"]
    assert all(s is RequestState.FINISHED for s in got["states"].values())
    assert eng.act_quant == "mixfp4-2pass-rowscale"
    assert eng.act.mode == "mixfp4-2pass-rowscale"
    assert eng.counters["degraded_fused_to_2pass"] == 1


def test_pool_exhaustion_degrades_to_fixed_slot(dense_params):
    """Admissions deferred past the budget abandon the paged pool: every
    in-flight request migrates by re-prefilling its token history, and
    the deferred request admits on the fixed-slot path; the streams are
    the fixed-slot engine's."""
    prompts = _prompts(64, [15, 15])
    oracle = flt.drive(_engine(dense_params, kv_quant="mixfp4",
                               clock=VirtualClock()),
                       prompts, max_new_tokens=4)
    # 15 prompt + 4 new - 1 = 18 positions = 2 pages each; the pool holds
    # 2 usable pages, so the second admission defers while the first runs
    eng = _engine(dense_params, kv_quant="mixfp4", kv_pool=3,
                  kv_page_len=16, degrade_after_deferrals=1,
                  clock=VirtualClock())
    a = Request(uid=0, prompt=prompts[0], max_new_tokens=4)
    b = Request(uid=1, prompt=prompts[1], max_new_tokens=4)
    eng.submit(a)
    streams = {0: [], 1: []}
    for _ in range(2):                   # a generates mid-flight tokens
        for uid, tok in eng.step():
            streams[uid].append(tok)
    eng.submit(b)
    _drain(eng, streams)
    assert eng.counters["degraded_paged_to_fixed"] == 1
    assert eng.kv_pool is None and "pages" not in eng.cache
    assert streams == oracle["streams"]
    assert a.state is RequestState.FINISHED
    assert b.state is RequestState.FINISHED


def test_robustness_spec_is_the_reference_but_the_paged_rung():
    """The port describes its robustness configuration as the reference
    does, but for the paged rung: it keeps the streams without promising
    bitwise K/V rows (a re-prefilled history's rows past the first layer
    come from the prefill attention, not the decode kernel)."""
    from repro_torch.serving.engine import engine_robustness_spec
    kw = dict(max_queue=3, deadline_ms=5.0, ttft_budget_ms=2.0,
              degrade_after_deferrals=2, kv_pool=16, act_quant="mixfp4")
    want = jengine.engine_robustness_spec(**kw)
    got = engine_robustness_spec(**kw)
    fused, paged = got.pop("degradation_ladder")
    want_fused, want_paged = want.pop("degradation_ladder")
    assert got == want
    assert fused.pop("preserves") == "token streams and K/V bytes"
    assert fused == want_fused
    assert want_paged["bitwise_preserving"] is True
    assert paged.pop("bitwise_preserving") is False
    assert paged.pop("preserves").startswith("token streams")
    assert paged == {k: v for k, v in want_paged.items()
                     if k != "bitwise_preserving"}


# ---------------------------------------------------------------------------
# chaos harness smoke: the sweep's own invariants hold on the paged engine
# ---------------------------------------------------------------------------
def test_chaos_sweep_paged_dense_smoke(dense_params):
    prompts = _prompts(64, [4, 5, 6])

    def mk(faults=None):
        return _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                       kv_page_len=16, faults=faults)

    report = flt.chaos_sweep(mk, prompts, seeds=(0,), max_new_tokens=3)
    assert report["ok"]
    (sched,) = report["schedules"]
    assert sched["events"] >= 1 and not sched["violations"]
    assert any(k.startswith(("failed:", "finished:"))
               for k in sched["counters"])


# ---------------------------------------------------------------------------
# the port's additions: watchdog, chunked cancel, rollbacks, metrics
# ---------------------------------------------------------------------------
def test_watchdog_degrades_then_fails(dense_params):
    """Slow decodes on a virtual clock blow the hung-step budget: the first
    strike's verdict moves the fused path to its two-pass rung, the
    second fails the most starved request with ``watchdog_timeout``; the
    survivor's stream is the fault-free one."""
    prompts = _prompts(64, [4, 5])
    oracle = flt.drive(_engine(dense_params, act_quant="mixfp4"), prompts,
                       max_new_tokens=4)
    inj = FaultInjector(0, [FaultRule("decode", "slow", prob=1.0,
                                      delay_ms=50.0)])
    eng = _engine(dense_params, act_quant="mixfp4", faults=inj,
                  hung_step_budget_ms=10.0)
    got = flt.drive(eng, prompts, max_new_tokens=4)
    report = eng.metrics_report()["watchdog"]
    assert report["degrades"] >= 1 and report["fails"] >= 1
    assert eng.counters["degraded_fused_to_2pass"] == 1
    assert eng.counters["watchdog_degrades"] == report["degrades"]
    assert eng.counters["watchdog_fails"] == report["fails"]
    failed = [u for u, s in got["states"].items()
              if s is RequestState.FAILED]
    assert failed and all(got["reasons"][u] == REASON_WATCHDOG
                          for u in failed)
    for uid, stream in got["streams"].items():
        want = oracle["streams"][uid]
        if uid in failed:
            assert stream == want[:len(stream)] and len(stream) < len(want)
        else:
            assert stream == want
    assert eng.robustness_report()["watchdog"] == report


def test_cancel_during_chunked_prefill_releases_pages_and_job(dense_params):
    eng = _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                  prefill_chunk=4, clock=VirtualClock())
    prompt = _prompts(64, [15])[0]
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=3))
    eng.step()                           # admitted, first chunk run
    assert eng.requests[0].state is RequestState.PREFILLING
    assert eng.scheduler.jobs_report()[0]["cursor"] == 4
    assert eng.pool_report()["pages_active"] == 2
    assert eng.cancel(0)
    assert eng.requests[0].finish_reason == REASON_CANCELLED
    assert eng.scheduler.pending_jobs == 0
    assert eng.scheduler.jobs_report() == []
    assert eng.pool_report()["pages_active"] == 0
    assert eng.slots == [None, None] and not eng.has_work()
    # the engine serves on, the fresh engine's stream
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=3))
    fresh = _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                    prefill_chunk=4, clock=VirtualClock())
    fresh.submit(Request(uid=1, prompt=prompt, max_new_tokens=3))
    assert _drain(eng) == _drain(fresh)


def test_chunk_fault_rolls_back_its_slot(dense_params):
    """A fatal fault on a later prefill chunk fails that request, drops its
    job and releases its pages; its batchmate's stream is untouched."""
    prompts = _prompts(64, [5, 12])

    def mk(faults=None):
        return _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                       prefill_chunk=4, faults=faults)

    oracle = flt.drive(mk(), prompts, max_new_tokens=3)
    # prefill crossings: uid 0's two chunks, then uid 1's chunks 0, 1, ...
    inj = FaultInjector(0, [FaultRule("prefill", "error", at=(3,))])
    eng = mk(faults=inj)
    got = flt.drive(eng, prompts, max_new_tokens=3)
    assert (got["states"][1], got["reasons"][1]) == (RequestState.FAILED,
                                                     REASON_INJECTED)
    assert got["streams"][1] == [] and inj.fatal_victims() == {1}
    assert got["streams"][0] == oracle["streams"][0]
    assert eng.scheduler.pending_jobs == 0
    assert eng.pool_report()["pages_active"] == 0


def test_cow_fault_rolls_back_its_slot(dense_params):
    """A fault on the copy-on-write of a partial prefix hit fails that
    admission (``cow_error``) and releases the pages it had acquired."""
    base = _prompts(64, [20])[0]
    prompts = [base, np.concatenate([base[:18], [7, 9]]).astype(np.int32)]

    def mk(faults=None):
        return _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                       faults=faults)

    oracle = flt.drive(mk(), prompts, max_new_tokens=3)
    inj = FaultInjector(0, [FaultRule("cow_copy", "error", at=(0,))])
    eng = mk(faults=inj)
    got = flt.drive(eng, prompts, max_new_tokens=3)
    assert (got["states"][1], got["reasons"][1]) == (RequestState.FAILED,
                                                     REASON_COW_ERROR)
    assert got["streams"][0] == oracle["streams"][0]
    assert eng.pool_report()["pages_active"] == 0
    assert eng.pool_report()["cow_copies"] == 1


def test_real_prefill_error_rolls_back_and_raises(dense_params,
                                                  monkeypatch):
    eng = _engine(dense_params, kv_quant="mixfp4", kv_pool=9,
                  clock=VirtualClock())

    def broken(*args, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(eng.model, "prefill_slot", broken)
    req = Request(uid=0, prompt=_prompts(64, [5])[0], max_new_tokens=3)
    eng.submit(req)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step()
    assert (req.state, req.finish_reason) == (RequestState.FAILED,
                                              REASON_PREFILL_ERROR)
    assert eng.slots == [None, None]
    assert eng.pool_report()["pages_active"] == 0


def test_metrics_report_counts_ttft_and_itl(dense_params):
    inj = FaultInjector(3, [FaultRule("decode", "slow", prob=0.5,
                                      delay_ms=7.0)])
    eng = _engine(dense_params, kv_quant="mixfp4", faults=inj)
    got = flt.drive(eng, _prompts(64, [4, 5, 6]), max_new_tokens=4)
    rep = eng.metrics_report()
    hist = rep["histograms"]
    assert hist["ttft_ms"]["count"] == 3
    assert hist["itl_ms"]["count"] == 3 * 3
    assert sorted(got["ttft_ms"].values())[-1] == hist["ttft_ms"]["max"]
    assert rep["gauges"]["max_queue"] == 64.0
    assert rep["gauges"]["queue_depth"] == rep["gauges"]["active_slots"] == 0
    assert rep["counters"]["finished:max_new_tokens"] == 3
    text = render_prometheus(rep)
    assert "mixfp4_ttft_ms_count 3" in text
    assert 'mixfp4_itl_ms{quantile="0.99"}' in text


# ---------------------------------------------------------------------------
# the port against the JAX engine, the same rules through both harnesses
# ---------------------------------------------------------------------------
def _jit_pack(params, method="mixfp4", act_rht=False):
    tree, packed, dense = jax.jit(functools.partial(
        jbase.pack_projections, method=method, act_rht=act_rht))(params)
    return tree, int(packed), int(dense)


def _strict_reference_engine(params, **kw):
    """The JAX engine, packing in one compiled call, with every build of
    its jits (at init and at a rung) compiled without excess precision."""
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


# run -> (engine options of both engines, the rules for a package's
# faults module)
CROSS_RUNS = {
    "fixed-chaos": ({"kv_quant": "mixfp4"},
                    lambda f: f.schedule_for_seed(1, n_requests=4)),
    "paged-chaos": ({"kv_quant": "mixfp4", "kv_pool": 9},
                    lambda f: f.schedule_for_seed(2, n_requests=4)),
    "fused-rung": ({"kv_quant": "mixfp4", "act_quant": "mixfp4"},
                   lambda f: [f.FaultRule("decode", "dispatch", at=(1,),
                                          times=1),
                              f.FaultRule("decode", "slow", prob=0.3,
                                          delay_ms=5.0)]),
}


@pytest.mark.parametrize("run", list(CROSS_RUNS))
def test_port_and_reference_drive_alike(jax_dense, run):
    kw, rules = CROSS_RUNS[run]
    seed = 4
    prompts = _prompts(64, [4, 5, 6, 7], seed=seed)
    jeng = _strict_reference_engine(
        jax_dense, faults=jfaults.FaultInjector(seed, rules(jfaults)), **kw)
    want = jfaults.drive(jeng, prompts, max_new_tokens=4)
    packed = convert.packed_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                       DENSE, device="cpu")
    inj = FaultInjector(seed, rules(flt))
    eng = _engine(packed, faults=inj, **kw)
    got = flt.drive(eng, prompts, max_new_tokens=4)
    assert got["streams"] == want["streams"]
    assert {u: str(s) for u, s in got["states"].items()} == \
        {u: str(s) for u, s in want["states"].items()}
    assert got["reasons"] == want["reasons"]
    assert got["ttft_ms"] == want["ttft_ms"]
    assert dict(eng.counters) == dict(jeng.counters)
    assert inj.log == jeng.faults.log
    assert eng.act_quant == jeng.act_quant
    if "kv_pool" in kw:
        assert eng.pool_report() == jeng.pool_report()
    # the runs exercise what they are named for
    assert got["steps"] == want["steps"]
    if run == "fused-rung":
        assert eng.counters["degraded_fused_to_2pass"] == 1
    else:
        assert any(s is RequestState.FAILED for s in got["states"].values())
