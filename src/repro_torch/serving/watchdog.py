"""Step watchdog: a hung-step budget over the engine's heartbeat.

The engine worker is one thread and the engine is one state machine — a
decode dispatch that stops returning (a wedged interpreter, a runaway
injected ``slow`` schedule, a pathological retry storm) would silently
freeze every stream with no typed outcome.  The watchdog turns "the step
took too long" into the same ladder the engine already uses for every
other failure:

* Each ``engine.step()`` reports its duration (on the ENGINE clock — a
  virtual clock under fault injection, so hung-step behavior is a pure
  function of the seed).
* A step over ``budget_ms`` is a **strike**; a step back under budget
  clears the count (sustained slowness is the signal, not one outlier).
* The first strike answers ``"degrade"`` — the engine fires its existing
  degradation ladder (fused W4A4 -> the 2-pass per-row composition,
  bitwise-preserving), trading dispatch count for simpler kernels.
* ``fail_after`` consecutive strikes answer ``"fail"`` — the engine
  fails the *most starved* in-flight request (longest since its last
  token) with the typed ``watchdog_timeout`` reason, releasing its slot
  and pool pages instead of wedging the whole batch behind it.

The watchdog never touches the engine itself: it is pure host-side
accounting (no jax, no threads), and the engine applies the verdicts so
its counters and journal see every transition first.
"""
from __future__ import annotations

__all__ = ["StepWatchdog"]


class StepWatchdog:
    """Consecutive-overrun escalation over per-step heartbeats.

    ``beat(elapsed_ms)`` returns ``None`` (healthy), ``"degrade"`` (first
    strikes), or ``"fail"`` (``fail_after``-th consecutive strike; the
    strike count resets so the next verdict needs sustained slowness
    again, not one more slow step)."""

    def __init__(self, budget_ms: float, *, fail_after: int = 2):
        if budget_ms <= 0:
            raise ValueError(f"hung-step budget must be positive, got "
                             f"{budget_ms}")
        if fail_after < 1:
            raise ValueError(f"fail_after must be >= 1, got {fail_after}")
        self.budget_ms = float(budget_ms)
        self.fail_after = int(fail_after)
        self.strikes = 0
        self.beats = 0
        self.overruns = 0
        self.degrades = 0
        self.fails = 0
        self.last_ms = 0.0
        self.worst_ms = 0.0

    def beat(self, elapsed_ms: float) -> str | None:
        self.beats += 1
        self.last_ms = float(elapsed_ms)
        self.worst_ms = max(self.worst_ms, self.last_ms)
        if elapsed_ms <= self.budget_ms:
            self.strikes = 0
            return None
        self.strikes += 1
        self.overruns += 1
        if self.strikes >= self.fail_after:
            self.strikes = 0
            self.fails += 1
            return "fail"
        self.degrades += 1
        return "degrade"

    def report(self) -> dict:
        """Flat scalar snapshot for ``metrics_report()["watchdog"]``."""
        return {
            "budget_ms": self.budget_ms,
            "fail_after": self.fail_after,
            "beats": self.beats,
            "strikes": self.strikes,
            "overruns": self.overruns,
            "degrades": self.degrades,
            "fails": self.fails,
            "last_step_ms": self.last_ms,
            "worst_step_ms": self.worst_ms,
        }
