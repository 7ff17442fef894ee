"""Deterministic, seeded fault injection for the serving engine.

Counterpart of ``repro/serving/faults.py``: the same sites, kinds, rules,
injector draws (blake2b over ``(seed, site, occurrence)``), spec grammar
and chaos harness, so one schedule fires the same events at the same
boundary crossings in either package's engine.

The engine's failure handling has to be *deterministic*, not just
"doesn't crash": the MixFP4 format bit lives in the sign of the E4M3
scale byte, so a single corrupted byte silently flips a block's
micro-format.  The W4A4 activation path quantizes under per-ROW scales,
so a request's bytes are a pure function of its own activations —
batchmates (including injected poison victims) cannot move them.  That
turns the sweep's headline check into a hard claim: every unaffected
stream must be **bitwise-identical** to the fault-free run, under W4A16
AND W4A4 alike.  The only way to pin that is to make the faults
themselves reproducible.

This module is pure host-side machinery (no torch):

* :class:`FaultRule` — one fault at one engine boundary (*site*), fired
  either at explicit occurrence indices or with a per-occurrence
  probability, both deterministic functions of ``(seed, site, n)``.
* :class:`FaultInjector` — the seeded schedule.  The engine calls
  ``fire(site, ...)`` at each of its host/device boundaries —
  ``prefill``, ``decode``, ``cow_copy``, ``pool_acquire``,
  ``checkpoint_read``, ``journal_write``, ``process_crash`` — and the
  injector answers with a
  :class:`FaultAction`: raise a typed error, poison a victim's logits
  (NaN), deny a pool-page acquisition, or advance the clock (a "slow"
  step).  Every fired event lands in ``injector.log``.  A ``dispatch``
  fault degrades the fused W4A4 path to its two-launch per-row
  composition (``mixfp4-2pass-rowscale``) — bitwise-preserving by
  construction, which the sweep verifies rather than assumes.
* :class:`VirtualClock` — deterministic time.  When an injector is
  installed the engine's deadlines, TTFT accounting, and retry backoff
  all run on this clock, so "p99 TTFT under injected slow steps" is a
  pure function of the seed.
* :func:`drive` / :func:`chaos_sweep` — the chaos harness: sweep seeded
  fault schedules against the fault-free oracle engine and assert the
  lifecycle invariants: unaffected streams bitwise-identical to the
  fault-free oracle, affected streams a strict prefix, every fatal fault
  resolving to exactly one terminal state, and no pool page /
  prefix-tree refcount leaks after drain.
* :func:`crash_restart_sweep` — kill-and-recover chaos: a seeded
  ``process_crash`` at each (strided) step boundary, the engine abandoned
  as a SIGKILL leaves it, a fresh engine ``recover()``-ed from the
  journal, and every stitched stream held bitwise to the oracle's.

CLI::

    PYTHONPATH=src python -m repro_torch.serving.faults \
        --families dense,moe --seeds 0,1,2 --device cpu
    PYTHONPATH=src python -m repro_torch.serving.faults \
        --families dense --seeds 0,1 --act-quant mixfp4 --device cuda
    PYTHONPATH=src python -m repro_torch.serving.faults \
        --families dense --seeds 0 --crash --crash-stride 2 --device cpu
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

__all__ = [
    "SITES", "KINDS", "FaultRule", "FaultAction", "InjectedFault",
    "FaultInjector", "VirtualClock", "SystemClock", "parse_faults",
    "drive", "schedule_for_seed", "check_invariants", "chaos_sweep",
    "crash_restart_sweep",
]

# Engine host/device boundaries an injector can hook.  ``journal_write``
# guards every request-journal append (serving.journal); ``process_crash``
# fires at the top of ``engine.step()`` — an 'error' there simulates
# SIGKILL between steps (the harness abandons the engine un-flushed and
# recovers a fresh one from the journal).
SITES = ("prefill", "decode", "cow_copy", "pool_acquire",
         "checkpoint_read", "journal_write", "process_crash")

# What a fired fault does:
#   error     - raise InjectedFault (fatal for the request at that site)
#   transient - raise InjectedFault(transient=True); succeeds on retry
#   nan       - poison the victim request's logits (host-side NaN)
#   slow      - advance the clock by delay_ms (an injected slow step)
#   dispatch  - raise a failed-kernel-dispatch error (the engine degrades
#               fused -> 2-pass per-row W4A4 when it can, bitwise)
#   deny      - pool_acquire only: the pool pretends to be exhausted
KINDS = ("error", "transient", "nan", "slow", "dispatch", "deny")


class InjectedFault(RuntimeError):
    """A fault raised at an engine boundary by the injector."""

    def __init__(self, site: str, kind: str, occurrence: int,
                 uid: int | None = None):
        super().__init__(f"injected {kind} fault at {site}"
                         f"[{occurrence}]"
                         + (f" (uid={uid})" if uid is not None else ""))
        self.site = site
        self.kind = kind
        self.occurrence = occurrence
        self.uid = uid

    @property
    def transient(self) -> bool:
        return self.kind == "transient"


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One fault at one site.  Fires at the occurrence indices in ``at``
    and/or with probability ``prob`` per occurrence (deterministic in
    ``(seed, site, occurrence)``); ``times`` caps total fires.  ``uid``
    pins the victim request for nan/error faults (None = the injector
    picks deterministically among the active requests)."""
    site: str
    kind: str
    at: tuple = ()
    prob: float = 0.0
    uid: int | None = None
    delay_ms: float = 50.0
    times: int | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.kind == "deny" and self.site != "pool_acquire":
            raise ValueError("'deny' faults only make sense at the "
                             "pool_acquire site")


@dataclasses.dataclass
class FaultAction:
    """What the engine must do after a boundary check: raise ``error``
    (after applying ``delay_ms`` / counters), treat an acquisition as
    denied, and/or poison ``poison_uids``' logits rows."""
    fired: tuple = ()               # FaultRule instances that fired
    error: InjectedFault | None = None
    deny: bool = False
    poison_uids: frozenset = frozenset()
    delay_ms: float = 0.0


class VirtualClock:
    """Deterministic monotonic clock: advances only when told to (injected
    slow steps, retry backoff).  ``__call__`` -> seconds."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += float(seconds)

    def sleep(self, seconds: float) -> None:     # no real sleeping
        self.advance(seconds)


class SystemClock:
    """Wall clock (time.monotonic) with a real — but capped — sleep, so a
    mis-configured backoff can never hang a serving process for long."""

    MAX_SLEEP_S = 0.25

    def __call__(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(min(max(seconds, 0.0), self.MAX_SLEEP_S))


def _unit(seed: int, site: str, n: int, salt: str = "") -> float:
    """Deterministic uniform [0,1) from (seed, site, occurrence) — stable
    across platforms/processes (blake2b, not Python's randomized hash)."""
    h = hashlib.blake2b(f"{seed}:{site}:{n}:{salt}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultInjector:
    """Seeded fault schedule over the engine's boundaries.

    The injector counts every ``fire(site, ...)`` call per site; whether a
    rule fires at occurrence ``n`` depends only on ``(seed, site, n)`` and
    the rule itself — never on wall time or dict order — so a schedule
    replays exactly as long as the engine is driven the same way."""

    def __init__(self, seed: int, rules, clock: VirtualClock | None = None):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self.clock = clock if clock is not None else VirtualClock()
        self.counts = {site: 0 for site in SITES}
        self.fires = {id(r): 0 for r in self.rules}
        self.log: list[dict] = []

    # ------------------------------------------------------------------
    def _rule_fires(self, rule: FaultRule, n: int) -> bool:
        if rule.times is not None and self.fires[id(rule)] >= rule.times:
            return False
        if n in rule.at:
            return True
        return bool(rule.prob) and \
            _unit(self.seed, rule.site, n, rule.kind) < rule.prob

    def fire(self, site: str, *, uid: int | None = None,
             active_uids=()) -> FaultAction:
        """One boundary crossing at ``site``.  Returns the action; the
        ENGINE raises ``action.error`` (so its counters see it first)."""
        n = self.counts[site]
        self.counts[site] = n + 1
        act = FaultAction()
        fired = []
        for rule in self.rules:
            if rule.site != site or not self._rule_fires(rule, n):
                continue
            self.fires[id(rule)] += 1
            victim = rule.uid
            if victim is None and rule.kind in ("nan", "error"):
                pool = list(active_uids) if active_uids else (
                    [uid] if uid is not None else [])
                if pool:
                    victim = pool[int(_unit(self.seed, site, n, "victim")
                                     * len(pool)) % len(pool)]
            if rule.kind == "slow":
                act.delay_ms += rule.delay_ms
            elif rule.kind == "deny":
                act.deny = True
            elif rule.kind == "nan":
                if victim is not None:
                    act.poison_uids = act.poison_uids | {victim}
            else:   # error / transient / dispatch
                if act.error is None:
                    act.error = InjectedFault(site, rule.kind, n, uid=victim)
            fired.append(rule)
            self.log.append({"site": site, "occurrence": n,
                             "kind": rule.kind, "uid": victim,
                             "t": self.clock()})
        act.fired = tuple(fired)
        if act.delay_ms:
            self.clock.advance(act.delay_ms / 1e3)
        return act

    # ------------------------------------------------------------------
    def fatal_victims(self) -> set:
        """Distinct request uids hit by a request-fatal fault (nan/error
        at a request-scoped site) — each must resolve to exactly one
        terminal FAILED state."""
        return {e["uid"] for e in self.log
                if e["kind"] in ("nan", "error") and e["uid"] is not None}

    def summary(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [dataclasses.asdict(r) for r in self.rules],
            "occurrences": dict(self.counts),
            "events": len(self.log),
            "by_kind": _count_by(self.log, "kind"),
            "by_site": _count_by(self.log, "site"),
        }


def _count_by(log, key):
    out: dict = {}
    for e in log:
        out[e[key]] = out.get(e[key], 0) + 1
    return out


# ---------------------------------------------------------------------------
# Spec parsing: "--inject-faults SEED:site=kind[:ms][@when][#uid],..."
# ---------------------------------------------------------------------------
def parse_faults(spec: str) -> FaultInjector:
    """Parse ``"SEED:site=kind[:ms][@when][#uid],..."`` into an injector.

    ``when`` is either an occurrence index (``@3``), a probability
    (``@p0.1``), or absent (= every occurrence).  Examples::

        7:decode=nan@3
        7:decode=slow:25@p0.2,pool_acquire=deny@p0.1
        0:prefill=transient@0#4,checkpoint_read=transient@0
    """
    head, sep, body = spec.partition(":")
    if not sep or not head.strip().lstrip("-").isdigit():
        raise ValueError(
            f"bad fault spec {spec!r}: expected 'SEED:site=kind[@when],...'")
    seed = int(head)
    rules = []
    for part in filter(None, (p.strip() for p in body.split(","))):
        try:
            site, rhs = part.split("=", 1)
            uid = None
            if "#" in rhs:
                rhs, uid_s = rhs.rsplit("#", 1)
                uid = int(uid_s)
            when = None
            if "@" in rhs:
                rhs, when = rhs.rsplit("@", 1)
            kind, _, ms = rhs.partition(":")
            at, prob = (), 0.0
            if when is None:
                prob = 1.0
            elif when.startswith("p"):
                prob = float(when[1:])
            else:
                at = (int(when),)
            rules.append(FaultRule(
                site=site.strip(), kind=kind.strip(), at=at, prob=prob,
                uid=uid, delay_ms=float(ms) if ms else 50.0))
        except (ValueError, TypeError) as e:
            if isinstance(e, ValueError) and ("fault site" in str(e)
                                              or "fault kind" in str(e)):
                raise
            raise ValueError(f"bad fault rule {part!r} in {spec!r}: "
                             "expected 'site=kind[:ms][@when][#uid]'") from e
    return FaultInjector(seed, rules)


# ---------------------------------------------------------------------------
# Chaos harness: drive engines under a schedule and check the invariants
# ---------------------------------------------------------------------------
def drive(engine, prompts, *, max_new_tokens=4, deadline_ms=None,
          ttft_budget_ms=None, max_steps: int = 2000) -> dict:
    """Submit one request per prompt through the engine's bounded queue and
    step to drain.  Returns per-uid streams plus terminal states/reasons.
    ``max_steps`` guards against livelock — a stuck engine is a finding,
    not a hang."""
    from repro_torch.serving.engine import Request
    reqs = [Request(uid=i, prompt=_np_prompt(p),
                    max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
                    ttft_budget_ms=ttft_budget_ms)
            for i, p in enumerate(prompts)]
    streams: dict = {r.uid: [] for r in reqs}
    for r in reqs:
        engine.submit(r)
    steps = 0
    while engine.has_work():
        for uid, tok in engine.step():
            streams[uid].append(tok)
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"engine made no progress after {max_steps} steps "
                f"(queue={len(engine.queue)}, "
                f"active={sum(s is not None for s in engine.slots)})")
    return {
        "streams": streams,
        "states": {r.uid: r.state for r in reqs},
        "reasons": {r.uid: r.finish_reason for r in reqs},
        "ttft_ms": {r.uid: r.ttft_ms() for r in reqs},
        "steps": steps,
    }


def _np_prompt(p):
    import numpy as np
    return np.asarray(p, np.int32)


def schedule_for_seed(seed: int, *, n_requests: int) -> list:
    """A mixed deterministic schedule for the CI sweep: one NaN poisoning
    (victim picked deterministically among the then-active requests, so
    the fault always lands on a live stream), one fatal prefill error on
    a later admission, sporadic slow decode steps, and occasional denied
    page acquisitions (no-ops for unpaged engines) — all pure functions
    of the seed."""
    later = (seed % n_requests + 1 + seed // n_requests) % n_requests
    return [
        FaultRule("decode", "nan", at=(2 + seed % 3,)),
        FaultRule("prefill", "error", at=(later,)),
        FaultRule("decode", "slow", prob=0.15, delay_ms=20.0),
        FaultRule("pool_acquire", "deny", prob=0.1, times=2),
    ]


def check_invariants(oracle: dict, got: dict, injector,
                     pool_stats: dict | None) -> list:
    """The chaos-sweep assertions.  Full *bitwise* identity against the
    fault-free oracle for every FINISHED stream and strict-prefix for
    every interrupted one — under W4A16 and, since the per-row W4A4
    scales (PR 9), under ``act_quant='mixfp4'`` too (no per-tensor
    batch coupling left to excuse a byte of drift).  Returns a list of
    violation strings (empty = pass)."""
    bad = []
    fatal = injector.fatal_victims()
    for uid, stream in got["streams"].items():
        state = got["states"][uid]
        want = oracle["streams"][uid]
        if str(state) == "FINISHED":
            if stream != want:
                bad.append(f"uid {uid} FINISHED but stream != oracle: "
                           f"{stream} vs {want}")
        else:
            if stream != want[:len(stream)]:
                bad.append(f"uid {uid} {state}: stream is not a prefix of "
                           f"the oracle's: {stream} vs {want}")
            if got["reasons"][uid] is None:
                bad.append(f"uid {uid} terminal {state} without a typed "
                           "reason")
    failed = {uid for uid, s in got["states"].items()
              if str(s) == "FAILED"}
    if fatal != failed:
        bad.append(f"fatal-fault victims {sorted(fatal)} != FAILED set "
                   f"{sorted(failed)}: every injected fatal fault must "
                   "resolve to exactly one terminal FAILED request")
    if pool_stats is not None:
        if pool_stats["pages_active"] != 0:
            bad.append(f"pool leaked {pool_stats['pages_active']} active "
                       "pages after drain")
    return bad


def crash_restart_sweep(make_engine, prompts, *, journal_root,
                        max_new_tokens=4, crash_stride=1,
                        max_crashes=32) -> dict:
    """Kill-and-recover chaos: crash at EVERY step boundary, recover,
    assert survivor streams bitwise.

    For each boundary ``k`` (strided), a seeded ``process_crash`` fault
    fires at the top of step ``k``; the harness abandons that engine
    exactly as a SIGKILL would (no flush, no close — the journal holds
    what its sync policy committed; ``make_engine`` should journal with
    ``journal_sync='always'`` so the crash point, not buffering, decides
    what survives), builds a FRESH engine over the same journal dir,
    calls ``engine.recover()`` and drives it to drain.  The invariant is
    the tentpole claim: for every request, pre-crash tokens ++
    post-recovery tokens must be **bitwise** the fault-free oracle's
    stream, every request must still reach a terminal state, and a paged
    pool must end with ``pages_active == 0`` (no leaked pages or
    prefix-tree refcounts).

    ``make_engine(faults=..., journal_dir=...)`` must build a fresh
    engine (same config/weights) each call; ``journal_dir=None`` means
    no journal (the oracle run).  Raises AssertionError listing every
    violation; returns a report dict otherwise."""
    import os

    oracle = drive(make_engine(faults=None, journal_dir=None), prompts,
                   max_new_tokens=max_new_tokens)
    report: dict = {"oracle_steps": oracle["steps"], "crashes": []}
    violations: list[str] = []
    boundaries = list(range(1, oracle["steps"] + 1, crash_stride))
    boundaries = boundaries[:max_crashes]
    from repro_torch.serving.engine import Request
    for k in boundaries:
        jd = os.path.join(journal_root, f"crash_{k:04d}")
        inj = FaultInjector(k, [FaultRule("process_crash", "error",
                                          at=(k,))])
        eng = make_engine(faults=inj, journal_dir=jd)
        reqs = [Request(uid=i, prompt=_np_prompt(p),
                        max_new_tokens=max_new_tokens)
                for i, p in enumerate(prompts)]
        pre: dict = {r.uid: [] for r in reqs}
        for r in reqs:
            eng.submit(r)
        crashed = False
        steps = 0
        while eng.has_work():
            try:
                out = eng.step()
            except InjectedFault as e:
                if e.site != "process_crash":
                    raise
                crashed = True
                break
            for uid, tok in out:
                pre[uid].append(tok)
            steps += 1
            if steps > 2000:
                raise RuntimeError("crash harness livelocked pre-crash")
        if not crashed:
            # the schedule outran the run (admission timing shifted the
            # step count); nothing to recover — skip the boundary
            report["crashes"].append({"boundary": k, "skipped": True})
            continue
        # abandoned: eng is dropped with whatever the journal committed
        eng2 = make_engine(faults=None, journal_dir=jd)
        rec = eng2.recover()
        post: dict = {}
        steps = 0
        while eng2.has_work():
            for uid, tok in eng2.step():
                post.setdefault(uid, []).append(tok)
            steps += 1
            if steps > 2000:
                raise RuntimeError("crash harness livelocked post-crash")
        for uid, want in oracle["streams"].items():
            full = pre.get(uid, []) + post.get(uid, [])
            if full != want:
                violations.append(
                    f"boundary {k}: uid {uid} resumed stream != oracle: "
                    f"pre={pre.get(uid)} post={post.get(uid)} "
                    f"want={want}")
            req = eng2.requests.get(uid)
            pre_req = eng.requests.get(uid)
            terminal = (req is not None and req.state.terminal) or \
                (req is None and pre_req is not None
                 and pre_req.state.terminal)
            if not terminal:
                violations.append(
                    f"boundary {k}: uid {uid} never reached a terminal "
                    "state after recovery")
        pool = eng2.pool_report()
        if pool is not None and pool["pages_active"] != 0:
            violations.append(
                f"boundary {k}: pool leaked {pool['pages_active']} "
                "active pages after recovery drain")
        report["crashes"].append({
            "boundary": k, "skipped": False,
            "recovered": rec["resumed"], "finalized": rec["finalized"],
            "already_terminal": rec["already_terminal"],
        })
    report["ok"] = not violations
    if violations:
        raise AssertionError("crash-restart sweep violations:\n  "
                             + "\n  ".join(violations))
    return report


def chaos_sweep(make_engine, prompts, seeds, *, max_new_tokens=4,
                schedule=None) -> dict:
    """Sweep seeded schedules against the fault-free oracle.

    ``make_engine(faults=...)`` must build a FRESH engine (same config and
    weights) each call; ``schedule`` overrides :func:`schedule_for_seed`.
    Returns a report; raises AssertionError listing every violation."""
    oracle_eng = make_engine(faults=None)
    oracle = drive(oracle_eng, prompts, max_new_tokens=max_new_tokens)
    report: dict = {"oracle_steps": oracle["steps"], "schedules": []}
    violations = []
    for seed in seeds:
        rules = (schedule(seed) if schedule is not None
                 else schedule_for_seed(seed, n_requests=len(prompts)))
        inj = FaultInjector(seed, rules)
        eng = make_engine(faults=inj)
        got = drive(eng, prompts, max_new_tokens=max_new_tokens)
        bad = check_invariants(oracle, got, inj, eng.pool_report())
        report["schedules"].append({
            "seed": seed, "events": len(inj.log),
            "states": {u: str(s) for u, s in got["states"].items()},
            "violations": bad,
            "counters": dict(eng.counters),
        })
        violations.extend(f"seed {seed}: {v}" for v in bad)
    report["ok"] = not violations
    if violations:
        raise AssertionError("chaos sweep violations:\n  "
                             + "\n  ".join(violations))
    return report


# ---------------------------------------------------------------------------
# CLI: the chaos-smoke leg
# ---------------------------------------------------------------------------
def _family_cfg(family: str):
    """The reference CLI's sweep configuration of ``family`` and its init
    seed (dense: a 2-layer d=64 model; moe: the qwen3-moe smoke config)."""
    from repro_torch.models.base import ArchConfig
    if family == "dense":
        return ArchConfig(name="chaos-dense", family="dense", n_layers=2,
                          d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                          vocab=64, attn_chunk=64), 0
    if family == "moe":
        from repro_torch import configs
        return configs.smoke_config("qwen3-moe-30b-a3b"), 5
    if family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"the {family} family is not ported yet (ROADMAP §1 item 5)")
    raise ValueError(f"unknown family {family!r}")


def main(argv=None) -> int:
    import argparse

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    ap = argparse.ArgumentParser(
        description="seeded chaos sweep over the serving engine")
    ap.add_argument("--families", default="dense,moe")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the engines run ('cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--act-quant", default=None,
                    help="engine act_quant= for the sweep (e.g. 'mixfp4' "
                         "runs the fused per-row W4A4 path — the bitwise "
                         "invariants hold there too, and a 'dispatch' "
                         "fault exercises the fused->2-pass degradation; "
                         "dense only)")
    ap.add_argument("--crash", action="store_true",
                    help="also run the kill-and-recover sweep: crash at "
                         "every step boundary, recover from the journal, "
                         "assert resumed streams bitwise the oracle")
    ap.add_argument("--crash-stride", type=int, default=1,
                    help="crash every Nth boundary (a time knob)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ok = True
    for family in filter(None, args.families.split(",")):
        cfg, init_seed = _family_cfg(family)
        params = build_model(cfg).init(init_seed, device=device)
        rng = np.random.RandomState(init_seed)
        prompts = [rng.randint(0, cfg.vocab, 3 + i % 3)
                   for i in range(args.requests)]
        # MoE stays at batch 2: the capacity router's rank-within-expert
        # competition can couple rows once B*top_k choices on one expert
        # can exceed cap (>= 4), so the bitwise oracle holds below that
        batch = 2
        kw: dict = dict(batch_size=batch, max_len=32, device=device)
        if args.act_quant:
            kw.update(act_quant=args.act_quant)
        if family == "dense":
            kw.update(kv_quant="mixfp4", kv_pool=2 * batch * 2 + 1,
                      kv_page_len=16)

        def make_engine(faults=None, journal_dir=None,
                        _cfg=cfg, _p=params, _kw=kw):
            jkw = dict(_kw)
            if journal_dir is not None:
                # 'always' so the crash point, not fsync batching,
                # decides what the recovery run sees on disk
                jkw.update(journal_dir=journal_dir, journal_sync="always")
            return ServeEngine(_cfg, _p, faults=faults, **jkw)

        try:
            rep = chaos_sweep(make_engine, prompts, seeds,
                              max_new_tokens=args.new_tokens)
            print(f"[chaos] {family}: OK "
                  f"({len(rep['schedules'])} schedules, "
                  f"{sum(s['events'] for s in rep['schedules'])} events)")
        except AssertionError as e:
            print(f"[chaos] {family}: FAIL\n{e}")
            ok = False
        if args.crash:
            import tempfile
            with tempfile.TemporaryDirectory() as root:
                try:
                    crep = crash_restart_sweep(
                        make_engine, prompts, journal_root=root,
                        max_new_tokens=args.new_tokens,
                        crash_stride=args.crash_stride)
                    ran = [c for c in crep["crashes"]
                           if not c.get("skipped")]
                    print(f"[chaos] {family}: crash-restart OK "
                          f"({len(ran)}/{len(crep['crashes'])} boundaries, "
                          f"{crep['oracle_steps']} oracle steps)")
                except AssertionError as e:
                    print(f"[chaos] {family}: crash-restart FAIL\n{e}")
                    ok = False
    print("[chaos] sweep", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    # re-enter through the canonical module so InjectedFault is the SAME
    # class object the engine's except-clauses are bound to (`python -m`
    # loads this file as __main__, a second module instance otherwise)
    from repro_torch.serving.faults import main as _main
    raise SystemExit(_main())
