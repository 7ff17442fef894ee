"""Serving metrics: counters / gauges / histograms + Prometheus text rendering.

The engine already keeps typed lifecycle counters (``engine.counters``) and
ad-hoc reports (``pool_report``, ``robustness_report``).  This module is the
uniform observability layer on top: a small registry the engine feeds every
``step()`` — queue depth, active slots, KV-pool occupancy / prefix-hit rate,
TTFT and inter-token-latency samples — exposed two ways:

* ``engine.metrics_report()`` — one JSON-able dict (counters + gauges +
  histogram percentile snapshots + scheduler ledger), consumed by the
  frontend benchmark and the tests;
* ``render_prometheus(report)`` — Prometheus text exposition for the HTTP
  server's ``GET /metrics`` (serving.server).

Everything here is host-side pure Python with no locking requirements
beyond the GIL: the engine worker thread is the only writer, and readers
(the HTTP thread) only ever see snapshot dicts.

Histograms keep a bounded reservoir of raw samples (latest ``maxlen``) so
percentiles are exact over the recent window rather than bucket-estimated —
at serving-bench scale (hundreds of requests) the window covers the whole
run, which keeps the seeded benchmarks deterministic.
"""
from __future__ import annotations

import collections
from typing import Iterable

__all__ = ["MetricsRegistry", "Histogram", "render_prometheus", "percentile"]


def percentile(samples: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — matches the convention in
    serving.faults / benchmarks so p50/p99 agree across reports."""
    xs = sorted(samples)
    if not xs:
        return 0.0
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[rank])


class Histogram:
    """Bounded-reservoir histogram: keeps the most recent ``maxlen``
    samples plus lifetime count/sum, snapshots exact percentiles over
    the window."""

    def __init__(self, maxlen: int = 4096):
        self._window: collections.deque[float] = collections.deque(
            maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self._window.append(v)
        self.count += 1
        self.total += v

    def snapshot(self) -> dict:
        w = list(self._window)
        return {
            "count": self.count,
            "sum": self.total,
            "mean": (self.total / self.count) if self.count else 0.0,
            "p50": percentile(w, 50),
            "p90": percentile(w, 90),
            "p99": percentile(w, 99),
            "max": max(w) if w else 0.0,
        }


class MetricsRegistry:
    """Name -> counter/gauge/histogram.  Names are dotted lowercase
    (``requests.finished``, ``ttft_ms``); the Prometheus renderer
    sanitizes them.  Creation is implicit on first touch so call sites
    stay one-liners."""

    def __init__(self, histogram_window: int = 4096):
        self.counters: collections.Counter[str] = collections.Counter()
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._hist_window = histogram_window

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = Histogram(self._hist_window)
        hist.observe(value)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }


def _prom_name(prefix: str, name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return f"{prefix}_{''.join(out)}"


def render_prometheus(report: dict, prefix: str = "mixfp4") -> str:
    """Render a ``metrics_report()`` dict as Prometheus text exposition.

    Counters/gauges map 1:1; histogram snapshots become ``*_count``,
    ``*_sum``, and ``{quantile=...}`` gauge lines (summary-style).  Any
    extra top-level sub-dicts of scalars (``kv_pool``, ``scheduler``)
    flatten to gauges so the scrape carries the whole report.
    """
    lines: list[str] = []

    def emit(kind: str, name: str, value, labels: str = "") -> None:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        pn = _prom_name(prefix, name)
        lines.append(f"# TYPE {pn} {kind}")
        lines.append(f"{pn}{labels} {value}")

    for name, value in sorted(report.get("counters", {}).items()):
        emit("counter", name, value)
    for name, value in sorted(report.get("gauges", {}).items()):
        emit("gauge", name, value)
    for name, snap in sorted(report.get("histograms", {}).items()):
        pn = _prom_name(prefix, name)
        lines.append(f"# TYPE {pn} summary")
        for q in ("p50", "p90", "p99"):
            lines.append(
                f'{pn}{{quantile="0.{q[1:]}"}} {snap.get(q, 0.0)}')
        lines.append(f"{pn}_count {snap.get('count', 0)}")
        lines.append(f"{pn}_sum {snap.get('sum', 0.0)}")
    for section in ("kv_pool", "scheduler", "journal", "watchdog"):
        sub = report.get(section)
        if isinstance(sub, dict):
            for name, value in sorted(sub.items()):
                emit("gauge", f"{section}.{name}", value)
    return "\n".join(lines) + "\n"
