"""The port's fault injector, metrics and watchdog against the JAX
package's, with no model.

``repro_torch.serving.faults`` is the port's own copy of
``repro/serving/faults.py`` (the port may not import the reference), so
the two must agree exactly: under the same seed, rules and sequence of
boundary crossings the two injectors give the same event ``log``,
``fatal_victims()`` and ``summary()``; ``parse_faults`` gives the same
rules for good specs and the same error class and message for malformed
ones; ``schedule_for_seed`` the same rules and ``check_invariants`` the
same violations.  ``Histogram``/``percentile`` snapshots and the
Prometheus text of ``render_prometheus`` are equal for the same
observations, and ``StepWatchdog`` gives the same verdicts and report
over the same heartbeats.  No tolerance: everything here is exact.

  PYTHONPATH=src python -m pytest -q tests/test_torch_faults.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro.serving import watchdog as jwatchdog  # noqa: E402
from repro_torch.serving import faults, metrics, watchdog  # noqa: E402


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


def _rules(pkg, name: str):
    """Named rule sets of either package's ``FaultRule``."""
    R = pkg.FaultRule
    return {
        "mixed": [R("decode", "nan", prob=0.5),
                  R("decode", "slow", prob=0.5, delay_ms=10.0),
                  R("prefill", "error", at=(1,))],
        "capped": [R("decode", "nan", prob=1.0, times=1),
                   R("decode", "transient", prob=0.3, times=2)],
        "pinned": [R("prefill", "transient", at=(0, 1), uid=3),
                   R("decode", "error", at=(2,), uid=1),
                   R("decode", "dispatch", at=(1,), times=1)],
        "pool": [R("pool_acquire", "deny", prob=0.4),
                 R("pool_acquire", "transient", at=(2,)),
                 R("cow_copy", "error", prob=0.5),
                 R("checkpoint_read", "transient", at=(0,))],
        "every-site": [R(site, "slow", prob=0.25, delay_ms=3.0)
                       for site in faults.SITES],
    }[name]


def _crossings(inj, n: int = 12):
    """One fixed sequence of boundary crossings: a decode with 1-3 active
    requests, a prefill, pool and COW crossings, a checkpoint read."""
    acts = []
    for k in range(n):
        active = tuple(range(k % 3 + 1))
        acts.append(inj.fire("decode", active_uids=active))
        acts.append(inj.fire("prefill", uid=k))
        acts.append(inj.fire("pool_acquire", uid=k))
        if k % 2:
            acts.append(inj.fire("cow_copy", uid=k))
        if k % 5 == 0:
            acts.append(inj.fire("checkpoint_read"))
    return [(sorted(a.poison_uids), a.deny, a.delay_ms,
             None if a.error is None else (str(a.error), a.error.kind,
                                           a.error.transient))
            for a in acts]


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("name", ["mixed", "capped", "pinned", "pool",
                                  "every-site"])
def test_injector_log_victims_and_summary_equal(name, seed):
    ours = faults.FaultInjector(seed, _rules(faults, name))
    ref = jfaults.FaultInjector(seed, _rules(jfaults, name))
    assert _crossings(ours) == _crossings(ref)
    assert ours.log == ref.log
    assert ours.fatal_victims() == ref.fatal_victims()
    assert ours.summary() == ref.summary()
    assert ours.clock() == ref.clock()


@pytest.mark.parametrize("seed", range(6))
def test_schedule_for_seed_equal(seed):
    ours = faults.schedule_for_seed(seed, n_requests=6)
    ref = jfaults.schedule_for_seed(seed, n_requests=6)
    assert [dataclasses.asdict(r) for r in ours] == \
        [dataclasses.asdict(r) for r in ref]
    inj = faults.FaultInjector(seed, ours)
    jinj = jfaults.FaultInjector(seed, ref)
    assert _crossings(inj, 20) == _crossings(jinj, 20)
    assert inj.log == jinj.log


GOOD_SPECS = [
    "7:decode=nan@3,decode=slow:25@p0.2,pool_acquire=deny@p0.1,"
    "prefill=transient@0#4",
    "0:decode=slow",
    "0:decode=slow:5",
    "0:prefill=transient@0#4,checkpoint_read=transient@0",
    "-3:cow_copy=error@p0.5, decode=dispatch@1",
    "12:",
]
BAD_SPECS = [
    "decode=nan",                 # no seed
    "x:decode=nan",
    "7:decode=bogus",             # unknown kind
    "7:warp=nan",                 # unknown site
    "7:decode",                   # no kind at all
    "7:decode=nan@x",
    "7:decode=nan#u",
    "7:decode=slow:fast",
    "7:decode=deny",              # deny only at pool_acquire
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_faults_same_rules(spec):
    ours, ref = faults.parse_faults(spec), jfaults.parse_faults(spec)
    assert ours.seed == ref.seed
    assert [dataclasses.asdict(r) for r in ours.rules] == \
        [dataclasses.asdict(r) for r in ref.rules]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_faults_same_errors(spec):
    with pytest.raises(Exception) as want:
        jfaults.parse_faults(spec)
    with pytest.raises(Exception) as got:
        faults.parse_faults(spec)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [("warp_drive", "error"), ("decode", "bogus"),
                                  ("decode", "deny")])
def test_fault_rule_validation_same_errors(args):
    with pytest.raises(ValueError) as want:
        jfaults.FaultRule(*args)
    with pytest.raises(ValueError) as got:
        faults.FaultRule(*args)
    assert str(got.value) == str(want.value)


def test_clocks_advance_alike():
    ours, ref = faults.VirtualClock(1.5), jfaults.VirtualClock(1.5)
    for c in (ours, ref):
        c.advance(0.25)
        c.sleep(0.125)
    assert ours() == ref() == 1.875
    assert faults.SystemClock.MAX_SLEEP_S == jfaults.SystemClock.MAX_SLEEP_S


@pytest.mark.parametrize("case", ["clean", "bad-finished", "not-prefix",
                                  "untyped", "victim-not-failed", "leak"])
def test_check_invariants_same_violations(case):
    oracle = {"streams": {0: [1, 2, 3], 1: [4, 5, 6]}}
    streams = {0: [1, 2, 3], 1: [4]}
    states = {0: "FINISHED", 1: "FAILED"}
    reasons = {0: "max_new_tokens", 1: "nan_logits"}
    pool = {"pages_active": 0}
    if case == "bad-finished":
        streams[0] = [1, 2, 9]
    elif case == "not-prefix":
        streams[1] = [7]
    elif case == "untyped":
        reasons[1] = None
    elif case == "victim-not-failed":
        states[1] = "EXPIRED"
    elif case == "leak":
        pool = {"pages_active": 2}
    out = []
    for pkg in (faults, jfaults):
        inj = pkg.FaultInjector(0, [pkg.FaultRule("decode", "nan", at=(0,),
                                                  uid=1)])
        inj.fire("decode", active_uids=(0, 1))
        got = {"streams": streams, "states": states, "reasons": reasons}
        out.append(pkg.check_invariants(oracle, got, inj, pool))
    assert out[0] == out[1]
    assert bool(out[0]) == (case != "clean")


def _samples(seed: int, n: int) -> list[float]:
    rng = np.random.RandomState(seed)
    return [float(v) for v in rng.lognormal(2.0, 1.0, n)]


@pytest.mark.parametrize("n", [0, 1, 7, 100, 5000])
def test_histogram_and_percentile_equal(n):
    xs = _samples(n, n)
    for q in (0, 50, 90, 99, 100):
        assert metrics.percentile(xs, q) == jmetrics.percentile(xs, q)
    ours, ref = metrics.Histogram(maxlen=64), jmetrics.Histogram(maxlen=64)
    for x in xs:
        ours.observe(x)
        ref.observe(x)
    assert ours.snapshot() == ref.snapshot()


def test_registry_and_prometheus_text_equal():
    regs = [metrics.MetricsRegistry(histogram_window=16),
            jmetrics.MetricsRegistry(histogram_window=16)]
    for reg in regs:
        for k, x in enumerate(_samples(1, 40)):
            reg.observe("ttft_ms", x)
            reg.observe("itl_ms", x / 7)
            reg.inc("requests.finished")
            reg.set_gauge("queue_depth", k % 5)
        reg.inc("retries:decode", 3)
    snaps = [r.snapshot() for r in regs]
    assert snaps[0] == snaps[1]
    report = dict(snaps[0], kv_pool={"pages_active": 3, "occupancy": 0.5,
                                     "name": "skipped"},
                  scheduler={"chunks_run": 7, "armed": True},
                  watchdog={"beats": 4})
    assert metrics.render_prometheus(report) == \
        jmetrics.render_prometheus(report)
    assert metrics.render_prometheus(report, prefix="x") == \
        jmetrics.render_prometheus(report, prefix="x")


@pytest.mark.parametrize("fail_after", [1, 2, 3])
def test_watchdog_verdicts_equal(fail_after):
    beats = [1.0, 6.0, 7.0, 2.0, 9.0, 9.5, 10.0, 11.0, 0.5, 5.0, 5.01, 12.0]
    ours = watchdog.StepWatchdog(5.0, fail_after=fail_after)
    ref = jwatchdog.StepWatchdog(5.0, fail_after=fail_after)
    assert [ours.beat(b) for b in beats] == [ref.beat(b) for b in beats]
    assert ours.report() == ref.report()


@pytest.mark.parametrize("kw", [{"budget_ms": 0.0}, {"budget_ms": -1.0},
                                {"budget_ms": 5.0, "fail_after": 0}])
def test_watchdog_rejects_bad_budgets_alike(kw):
    budget = kw.pop("budget_ms")
    with pytest.raises(ValueError) as want:
        jwatchdog.StepWatchdog(budget, **kw)
    with pytest.raises(ValueError) as got:
        watchdog.StepWatchdog(budget, **kw)
    assert str(got.value) == str(want.value)
