"""Unified serving telemetry: metrics, lifecycle tracing, Perfetto export.

The paper's headline claim — reconfiguration time *hidden* behind
execution — is observational: it is only provable with a per-event
timeline of context loads overlapping decode.  Before this module every
serving layer kept its own ad-hoc accounting (``SlotPool.stats`` dicts,
``ServeStats`` dataclass, scheduler dicts, ``ContextSwitchEngine.stats``,
``time.perf_counter`` deltas in benches); this is the one measurement
layer they all share:

  * ``MetricRegistry`` — counters, gauges, and fixed-bucket histograms
    under one namespace.  The clock is injected (``clock=``), so the
    discrete-event simulator (virtual time) and the live engine (wall
    time) emit the SAME metric stream — ``simulate_dynamic(telemetry=)``
    writes the very counters (``ctx.loads``, ``ctx.load_seconds``,
    ``ctx.hidden_load_seconds``) the live ``ContextSwitchEngine`` writes.
  * ``MetricView`` — a dict-shaped window onto one registry namespace.
    Existing ``stats`` dict call-sites (engines, benches, tests) keep
    working verbatim while the registry is the single store.
  * ``Tracer`` — per-request lifecycle spans/events (submit → queued →
    admitted → prefill-chunk[i] → first-token → decode ticks → retire,
    plus context load/switch, prefix hit/CoW, page reclaim, spec rounds)
    in a bounded ring buffer.  Disabled (the default), every record call
    returns before allocating anything — near-zero overhead, gated by a
    test.
  * Chrome trace-event JSON export (``Tracer.chrome_trace`` /
    ``export``), viewable in Perfetto (https://ui.perfetto.dev): one
    track per context slot / pool slot, so a ``load:`` span on one track
    overlapping a ``run:`` span on another is the paper's hidden load,
    visually.  Spans carry the *exact* timestamps the engine's
    hidden-load accounting used, so the fraction recomputed from trace
    spans matches ``ContextSwitchEngine.hidden_load_fraction`` (tested
    to < 1%).

``Telemetry`` bundles one registry + one tracer + one clock and is what
components accept (``telemetry=``); ``scoped(prefix)`` hands a component
its own key namespace over the same store.  See docs/observability.md
for the metric glossary and span taxonomy — CI fails if a key is emitted
that the glossary does not document.
"""
from __future__ import annotations

import json
import time
from bisect import bisect_right
from collections import deque
from collections.abc import MutableMapping
from typing import Any, Callable, Optional

__all__ = ["LATENCY_BUCKETS_S", "Histogram", "ManualClock", "MetricRegistry",
           "MetricView", "Telemetry", "Tracer", "safe_ratio"]


def safe_ratio(num: float, den: float, default: float = 0.0) -> float:
    """``num / den`` with an explicit zero-denominator answer.  Every
    serving ratio (hidden-load fraction, steps/tick, acceptance rate,
    tok/s) routes through here so an early snapshot — taken before any
    load/tick/round happened — reports ``default`` instead of raising or
    propagating NaN into BENCH json."""
    return num / den if den else default


# Fixed buckets shared by every latency histogram (seconds).  Fixed — not
# adaptive — so histograms from different runs/machines/simulations merge
# bucket-for-bucket and BENCH diffs stay meaningful.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` is observations <=
    ``buckets[i]`` (last slot is the overflow).  Percentiles are the
    upper edge of the covering bucket — an upper bound, resolution
    bounded by the bucket grid (documented in docs/observability.md)."""

    __slots__ = ("buckets", "counts", "count", "total", "vmax")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0

    def observe(self, v: float):
        self.counts[bisect_right(self.buckets, v)] += 1
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding quantile ``q`` in [0, 1]
        (``vmax`` for the overflow bucket); 0.0 when empty."""
        if not self.count:
            return 0.0
        need = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= need and c:
                return self.buckets[i] if i < len(self.buckets) else self.vmax
        return self.vmax

    def summary(self) -> dict:
        return {"count": self.count,
                "sum": round(self.total, 6),
                "mean": round(safe_ratio(self.total, self.count), 6),
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99),
                "max": round(self.vmax, 6)}


class MetricRegistry:
    """Counters + gauges + histograms under one flat namespace.

    Values auto-register on first touch; ``doc`` strings ride along for
    the glossary check (every emitted key must appear in
    docs/observability.md — ``tools/check_metric_docs.py``).  The clock
    is injected so a simulator can drive the registry on virtual time.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._values: dict[str, float] = {}       # counters + gauges
        self._gauges: set[str] = set()
        self._hists: dict[str, Histogram] = {}
        self._docs: dict[str, str] = {}

    # ------------------------------------------------------------ scalars
    def inc(self, name: str, n=1, doc: str = ""):
        self._values[name] = self._values.get(name, 0) + n
        if doc and name not in self._docs:
            self._docs[name] = doc

    def set(self, name: str, v, doc: str = ""):
        self._values[name] = v
        if doc and name not in self._docs:
            self._docs[name] = doc

    def gauge(self, name: str, v, doc: str = ""):
        self._values[name] = v
        self._gauges.add(name)
        if doc and name not in self._docs:
            self._docs[name] = doc

    def value(self, name: str):
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values or name in self._hists

    # --------------------------------------------------------- histograms
    def observe(self, name: str, v: float, buckets=LATENCY_BUCKETS_S,
                doc: str = ""):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(buckets)
            if doc:
                self._docs[name] = doc
        h.observe(v)

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    # ------------------------------------------------------------ reports
    def keys(self) -> list[str]:
        """Every metric key this registry has emitted (scalar names +
        histogram names) — the set the docs glossary must cover."""
        return sorted(set(self._values) | set(self._hists))

    def snapshot(self) -> dict:
        """Flat scalars + per-histogram summaries, one dict."""
        out: dict[str, Any] = dict(self._values)
        for name, h in self._hists.items():
            out[name] = h.summary()
        return out

    def view(self, prefix: str = "") -> "MetricView":
        return MetricView(self, prefix)


class MetricView(MutableMapping):
    """Dict-shaped window onto one ``MetricRegistry`` namespace.

    ``engine.stats["host_ticks"] += 1`` and ``dict(engine.stats)`` keep
    working exactly as with the old per-engine dicts — but the values
    live in the shared registry under ``prefix + key``, so one snapshot
    call sees every layer.  Iteration covers the keys touched *through
    this view* (its local namespace), not the whole registry."""

    def __init__(self, registry: MetricRegistry, prefix: str = ""):
        self._reg = registry
        self._prefix = prefix
        self._names: dict[str, None] = {}         # insertion-ordered set

    def __getitem__(self, k: str):
        try:
            return self._reg.value(self._prefix + k)
        except KeyError:
            raise KeyError(k) from None

    def __setitem__(self, k: str, v):
        self._reg.set(self._prefix + k, v)
        self._names.setdefault(k)

    def __delitem__(self, k: str):
        del self._reg._values[self._prefix + k]
        self._names.pop(k, None)

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __contains__(self, k) -> bool:
        return k in self._names


class ManualClock:
    """Settable clock for simulators and tests: ``clock()`` returns the
    last value given to ``advance``/``set`` — registry and tracer behave
    identically on virtual and wall time."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def set(self, t: float):
        self.t = t

    def advance(self, dt: float):
        self.t += dt


class Tracer:
    """Bounded ring buffer of lifecycle events, exportable as Chrome
    trace-event JSON (open at https://ui.perfetto.dev).

    Events are ``(track, name, ph, t0, dur, args)`` tuples with raw
    *clock-seconds* timestamps; tracks are free-form strings that become
    one Perfetto row each (``ctxslot0``, ``pool3``, ``sched``, ...).
    ``span`` takes explicit ``t0``/``t1`` so instrumentation can hand
    over the very timestamps its own accounting used (that is what makes
    the trace-derived hidden-load fraction match the engine's to < 1%).

    Disabled, ``span``/``instant`` return before touching anything —
    call sites in hot loops additionally guard ``if tracer.enabled:``
    before building f-string names or args dicts, so a disabled tracer
    costs one attribute test per record point (allocation-gated by
    ``tests/test_telemetry.py::test_disabled_tracer_allocates_nothing``).
    """

    __slots__ = ("enabled", "clock", "capacity", "_buf", "dropped")

    def __init__(self, capacity: int = 1 << 16,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = False):
        self.enabled = enabled
        self.clock = clock
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self.dropped = 0      # ring overwrites (capacity exceeded)

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self):
        self._buf.clear()
        self.dropped = 0

    # ------------------------------------------------------------- record
    def instant(self, name: str, track: str, ts: Optional[float] = None,
                args: Optional[dict] = None):
        if not self.enabled:
            return
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append((track, name, "i",
                          self.clock() if ts is None else ts, 0.0, args))

    def span(self, name: str, track: str, t0: float, t1: float,
             args: Optional[dict] = None):
        if not self.enabled:
            return
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append((track, name, "X", t0, t1 - t0, args))

    # ------------------------------------------------------------- export
    def events(self) -> list[dict]:
        """Normalized copies (raw seconds) for programmatic checks."""
        return [{"track": tr, "name": nm, "ph": ph, "t0": t0, "dur": dur,
                 "args": args} for tr, nm, ph, t0, dur, args in self._buf]

    def chrome_trace(self, process_name: str = "repro-serve") -> dict:
        """Chrome trace-event JSON object.  ``ts``/``dur`` are
        microseconds relative to the earliest event (Perfetto renders
        absolute perf_counter epochs poorly); timestamps are NOT rounded
        so span arithmetic on the export reproduces the engine's float
        accounting."""
        evs = list(self._buf)
        base = min((e[3] for e in evs), default=0.0)
        tids = {tr: i + 1 for i, tr in
                enumerate(sorted({e[0] for e in evs}))}
        out: list[dict] = [{"name": "process_name", "ph": "M", "pid": 1,
                            "tid": 0, "args": {"name": process_name}}]
        for tr, tid in tids.items():
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"name": tr}})
        for tr, nm, ph, t0, dur, args in evs:
            ev: dict[str, Any] = {"name": nm, "ph": ph, "cat": "serve",
                                  "pid": 1, "tid": tids[tr],
                                  "ts": (t0 - base) * 1e6}
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"                 # instant scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "repro-serve") -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f)
            f.write("\n")
        return path


class Telemetry:
    """One registry + one tracer + one clock, shared by every serving
    layer of a server.  ``scoped(prefix)`` returns a handle over the
    SAME store whose ``view()`` keys are namespaced — engines get
    ``eng.<i>.``, the context engine ``ctx.``, schedulers ``sched.`` —
    while histograms and root counters stay global (``observe``/``inc``
    ignore the prefix: a latency distribution spans engines by design).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 trace: bool = False, trace_capacity: int = 1 << 16,
                 registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None, prefix: str = ""):
        self.clock = clock
        self.registry = (MetricRegistry(clock=clock) if registry is None
                         else registry)
        self.tracer = (Tracer(capacity=trace_capacity, clock=clock,
                              enabled=trace) if tracer is None else tracer)
        self.prefix = prefix

    def scoped(self, prefix: str) -> "Telemetry":
        return Telemetry(clock=self.clock, registry=self.registry,
                         tracer=self.tracer,
                         prefix=self.prefix + prefix)

    def view(self, sub: str = "") -> MetricView:
        """A stats view over this component's namespace."""
        return self.registry.view(self.prefix + sub)

    # Root-namespace conveniences: request-level histograms and counters
    # are deliberately unprefixed so every engine of a server feeds the
    # same distribution.
    def observe(self, name: str, v: float, doc: str = ""):
        self.registry.observe(name, v, doc=doc)

    def inc(self, name: str, n=1, doc: str = ""):
        self.registry.inc(name, n, doc=doc)
