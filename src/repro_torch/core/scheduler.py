"""Reconfiguration scheduling: discrete-event timing model + live driver.

Reproduces the paper's three timing case studies analytically and drives the
real ``ContextSwitchEngine`` with the same schedules so model and measurement
can be compared:

  * conventional FPGA        — serial: every switch pays full reconfiguration
  * preloaded (Fig 6c/d)     — all contexts resident; switch cost ~0
  * dynamic reconfig (Fig 6e/f, S9) — next context loads *during* current
    execution; visible reconfiguration = max(0, t_load - t_exec_available)

Invariants checked by property tests:
  * preloaded saving  in [0, 1)       (paper: ideal bound 100 %)
  * dynamic  saving   in [0, 0.5] for alternating 2-net schedules and
    <= 1 - 1/(k+1) in general        (paper: ideal bound 50 % for their case)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.policy import ReconfigPolicy


@dataclass(frozen=True)
class Run:
    """One execution of a network: `net` must be resident when it starts."""
    net: str
    exec_time: float
    repeat: int = 1


def simulate_conventional(schedule: Sequence[Run],
                          load_time: dict[str, float]) -> float:
    """Single-configuration FPGA: reconfigure serially on every net change."""
    t, current = 0.0, None
    for r in schedule:
        if r.net != current:
            t += load_time[r.net]
            current = r.net
        t += r.exec_time * r.repeat
    return t


def simulate_preloaded(schedule: Sequence[Run],
                       load_time: dict[str, float],
                       switch_time: float = 0.0,
                       preload_upfront: bool = False) -> float:
    """All contexts resident (paper case 2: two preloaded configurations).

    ``preload_upfront`` charges the one-time initial loads (the paper's
    comparison excludes them, as they happen once at deployment).
    """
    t, current = 0.0, None
    if preload_upfront:
        t += sum(load_time[n] for n in {r.net for r in schedule})
    for r in schedule:
        if r.net != current:
            t += switch_time
            current = r.net
        t += r.exec_time * r.repeat
    return t


def simulate_dynamic(schedule: Sequence[Run],
                     load_time: dict[str, float],
                     num_slots: int = 2,
                     switch_time: float = 0.0,
                     policy: Optional[ReconfigPolicy] = None,
                     telemetry=None) -> float:
    """Dynamic reconfiguration with `num_slots` resident slots.

    Event simulation: while run i executes in its slot, the loader (one
    configuration port, like the FPGA's single config interface) streams the
    weights of upcoming non-resident nets into free slots, evicting
    least-recently-used non-active residents to make room.  Visible stall
    before run i = remaining load time for its net.  This is the paper's
    'reconfigure while executing' timeline (Fig 6e), generalized to
    arbitrary schedules and slot counts.

    Which net loads where — and which resident is evicted — is decided by
    the shared ``ReconfigPolicy``, the exact object that drives the live
    ``ContextSwitchEngine``; this function only advances the clock.  Pass
    ``policy`` to inspect its decision trace afterwards.

    ``telemetry`` (a ``repro_torch.core.telemetry.Telemetry``) makes the
    simulator emit the SAME metric keys the live engine writes —
    ``ctx.loads`` / ``ctx.load_seconds`` / ``ctx.hidden_load_seconds`` /
    ``ctx.switches`` / ``ctx.context_changes`` — plus ``load:``/``run:``
    spans on virtual-time tracks, so a simulated timeline opens in
    Perfetto exactly like a measured one.
    """
    pol = policy if policy is not None else ReconfigPolicy(num_slots)
    assert pol.num_slots == num_slots, (pol.num_slots, num_slots)
    t = 0.0
    loader_free_at = 0.0
    load_done_at: dict[str, float] = {}
    load_spans: list[tuple[str, float, float]] = []   # (net, start, done)
    exec_spans: list[tuple[str, float, float]] = []
    stats = trace = None
    if telemetry is not None:
        stats = telemetry.view("ctx.")
        for k in ("loads", "switches", "context_changes"):
            stats.setdefault(k, 0)
        for k in ("load_seconds", "hidden_load_seconds", "switch_seconds",
                  "visible_stall_seconds"):
            stats.setdefault(k, 0.0)
        trace = telemetry.tracer
    current = None

    def fire_completions(now: float):
        """Report finished loads to the policy, in completion order."""
        for net, done in sorted(load_done_at.items(), key=lambda kv: kv[1]):
            if done <= now:
                pol.complete(net)
                del load_done_at[net]

    def queue_load(net: str, now: float):
        nonlocal loader_free_at
        start = max(now, loader_free_at)
        loader_free_at = start + load_time[net]
        load_done_at[net] = loader_free_at
        load_spans.append((net, start, loader_free_at))
        if stats is not None:
            stats["loads"] += 1
            stats["load_seconds"] += load_time[net]

    for i, r in enumerate(schedule):
        fire_completions(t)
        decision = pol.ensure(r.net, active=None)   # quiescent: between runs
        if decision is not None and decision.load:
            queue_load(r.net, t)
        if not pol.is_resident(r.net):       # visible stall: remaining load
            done = load_done_at.pop(r.net)
            if stats is not None and done > t:
                stats["visible_stall_seconds"] += done - t
            t = max(t, done)
            pol.complete(r.net)
        pol.activate(r.net)
        if stats is not None:
            stats["switches"] += 1
            stats["switch_seconds"] += switch_time
            if r.net != current:
                stats["context_changes"] += 1
        current = r.net
        t += switch_time
        fire_completions(t)
        # prefetch upcoming nets while this one executes (hidden loads)
        upcoming = [nxt.net for nxt in schedule[i + 1:]]
        for dec in pol.prefetch(upcoming, active=r.net):
            queue_load(dec.net, t)
        fire_completions(t)                  # zero-cost loads land instantly
        exec_spans.append((r.net, t, t + r.exec_time * r.repeat))
        t += r.exec_time * r.repeat

    if stats is not None:
        # hidden = load time overlapped by execution, clamped per load —
        # the same definition the live engine accumulates online
        for _, l0, l1 in load_spans:
            ov = sum(max(0.0, min(l1, e1) - max(l0, e0))
                     for _, e0, e1 in exec_spans)
            stats["hidden_load_seconds"] += min(ov, l1 - l0)
        if trace is not None and trace.enabled:
            for net, l0, l1 in load_spans:
                trace.span(f"load:{net}", "sim-loader", l0, l1)
            for net, e0, e1 in exec_spans:
                trace.span(f"run:{net}", "sim-exec", e0, e1)
    return t


def time_saving(baseline: float, ours: float) -> float:
    return (baseline - ours) / baseline


# ---------------------------------------------------------------------------
# live driver: runs the same schedule on a real ContextSwitchEngine
# ---------------------------------------------------------------------------

def run_schedule_live(engine, schedule: Sequence[Run], inputs: dict,
                      dynamic: bool = True, lookahead: int | None = 1,
                      settle: bool = False) -> dict:
    """Drive the real engine; returns measured wall/clock decomposition.

    dynamic=True  — preload upcoming contexts while the current one runs;
                    which ones (and which resident gets evicted) comes from
                    ``engine.policy`` — the same ``ReconfigPolicy`` object
                    ``simulate_dynamic`` runs, so the model and the
                    measurement execute literally the same decision code.
    dynamic=False — conventional: evict + blocking load on every change.

    ``lookahead`` bounds the prefetch window (None = policy default);
    ``settle`` waits for each preload before proceeding — decision points
    then happen in the same order as the simulator's, making the policy
    trace deterministic (used by the sim/live agreement tests; leave False
    for real overlap).
    """
    import time as _time
    t0 = _time.perf_counter()
    stalls = 0.0
    for i, r in enumerate(schedule):
        if not dynamic:
            # single-configuration FPGA: a net change always reloads.
            prev = engine.active.name if engine.active else None
            if prev != r.net:
                for name in list(engine.resident()):
                    if name != prev:
                        engine.evict(name)          # only the active stays
                ts = _time.perf_counter()
                engine.preload(r.net, block=True)
                stalls += _time.perf_counter() - ts
                engine.switch(r.net)
                if prev is not None:
                    engine.evict(prev)              # old config overwritten
        else:
            ts = _time.perf_counter()
            # quiescent point (previous run finished): the policy may
            # overwrite any slot, including the previously active one
            fut = engine.preload(r.net, allow_evict_active=True)
            if settle:
                fut.result()
            engine.switch(r.net, wait=True)  # stall only if load incomplete
            stalls += _time.perf_counter() - ts
            upcoming = [nxt.net for nxt in schedule[i + 1:]]
            for f in engine.prefetch(upcoming, limit=lookahead):
                if settle:                   # hidden behind run() otherwise
                    f.result()
        for _ in range(r.repeat):
            engine.run(*inputs[r.net])
    return {"total": _time.perf_counter() - t0, "visible_stalls": stalls}
