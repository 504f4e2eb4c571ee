"""Context-switching execution engine — the paper's contribution, on a
CUDA card.

The paper's FPGA holds **two local copies** of every configuration primitive
(2T-2FeFET switches, dual LUT banks): the inactive copy is programmed while
the active one executes, and switching is a <1 ns select-signal flip.

Mapping here (see DESIGN.md §2):
  * a *context* = weight tree + its apply function ("fabric program")
  * a *slot*    = device-resident buffer set; ``num_slots=2`` is the paper's
    dual-configuration design (more slots = the time-multiplexed FPGA of
    Trimberger'97, supported but costing HBM exactly as the paper notes it
    costs area)
  * *preload*   = host->device copy from pinned host memory on a side CUDA
    stream, into a non-active slot; a ``torch.cuda.Event`` recorded after
    the copy marks the slot ready (the serial enable transistor == the slot
    state machine: an executing step can never read a LOADING slot)
  * *switch*    = O(1) pointer swap; the compute stream waits on the slot's
    ready event, no device data movement

PyTorch runs eagerly, so a context's apply function is called directly:
there is no executable cache to fill at registration.  The JAX package's
non-volatile ``ContextStore`` (checkpoint-backed contexts) is not ported
yet.
"""
from __future__ import annotations

import enum
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core.env import resolve_device
from repro_torch.core.policy import ReconfigPolicy
from repro_torch.core.telemetry import Telemetry, safe_ratio


class ContextState(enum.Enum):
    EMPTY = "empty"
    LOADING = "loading"      # enable transistor OFF: invisible to execution
    READY = "ready"          # resident, selectable
    ACTIVE = "active"        # the select signal points here


@dataclass
class ContextDescriptor:
    """A registered configuration: how to compute and where weights come
    from.  The JAX package's partial reconfiguration (``base``: load only
    a delta over a resident context, used by its Super-Sub cascade) is
    not ported yet."""
    name: str
    apply_fn: Callable                    # (params, *inputs) -> outputs
    weights_fn: Callable[[], Any]         # -> host weight tree


@dataclass
class ContextSlot:
    idx: int
    state: ContextState = ContextState.EMPTY
    name: Optional[str] = None
    buffers: Any = None                   # device weight tree
    bytes_resident: int = 0
    copied: Optional[torch.cuda.Event] = None   # CUDA: load copy finished


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _nbytes(tree) -> int:
    return sum(x.nbytes for x in _leaves(tree) if hasattr(x, "nbytes"))


class ContextSwitchEngine:
    """Dual-slot (by default) context-switching executor.

    All slot-allocation / eviction / prefetch *decisions* are delegated to
    a ``ReconfigPolicy`` (``repro_torch.core.policy``) — the same object the
    discrete-event simulator runs — so the engine only performs the
    physical work: device transfers, slot state flips, stats.
    """

    def __init__(self, num_slots: int = 2, device=None,
                 policy: ReconfigPolicy | None = None,
                 telemetry: Telemetry | None = None):
        assert num_slots >= 2, "dynamic reconfiguration needs >= 2 slots"
        if policy is None:
            policy = ReconfigPolicy(num_slots=num_slots)
        assert policy.num_slots == num_slots, \
            (policy.num_slots, num_slots)
        self.policy = policy
        self.slots = [ContextSlot(i) for i in range(num_slots)]
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # loads copy on their own stream, behind the compute stream's work
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._compute_stream = (torch.cuda.current_stream(self.device)
                                if self._cuda else None)
        self._contexts: dict[str, ContextDescriptor] = {}
        self._pending: dict[str, Future] = {}
        self._deferred: dict[str, Future] = {}    # waiting for a free slot
        self._lock = threading.RLock()
        # one configuration port, like the FPGA's single config interface:
        self._loader = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ctx-loader")
        # Shared measurement layer: stats live in the server-wide registry
        # under ``ctx.`` (dict call-sites unchanged — MetricView), spans go
        # to the shared tracer on one track per slot (``ctxslot<i>``), and
        # the clock is injected so simulated engines tick virtual time.
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._clock = self.telemetry.clock
        self._trace = self.telemetry.tracer
        self.stats = self.telemetry.view("ctx.")
        self.stats.update({
            "loads": 0, "load_seconds": 0.0, "bytes_loaded": 0,
            "switches": 0, "switch_seconds": 0.0, "evictions": 0,
            "hidden_load_seconds": 0.0, "context_changes": 0,
        })
        # overlap accounting (all guarded by self._lock).  One loader
        # thread => at most one load window open at a time.
        self._exec_busy_until = 0.0
        self._runs_in_flight = 0
        self._run_started_at: Optional[float] = None
        self._load_started_at: Optional[float] = None
        self._load_hidden_accum = 0.0     # exec∩load overlap, completed runs

    # ------------------------------------------------------------- registry
    def register(self, desc: ContextDescriptor):
        """Register a context (its weights load on the first preload)."""
        with self._lock:
            self._contexts[desc.name] = desc

    # --------------------------------------------------------------- slots
    def _find_slot(self, name: str) -> Optional[ContextSlot]:
        for s in self.slots:
            if s.name == name and s.state in (ContextState.READY,
                                              ContextState.ACTIVE):
                return s
        return None

    # ------------------------------------------------------------- loading
    def _active_name(self) -> Optional[str]:
        a = self.active
        return a.name if a is not None else None

    def _evict_name_unlocked(self, name: str, demote_ok: bool = False):
        """Free the slot holding `name` (policy already decided this)."""
        for s in self.slots:
            if s.name == name and s.state in (ContextState.READY,
                                              ContextState.ACTIVE):
                if s.state == ContextState.ACTIVE and not demote_ok:
                    raise RuntimeError(
                        f"policy evicted ACTIVE context {name!r} "
                        "without allow_evict_active")
                if self._trace.enabled:
                    self._trace.instant(f"evict:{name}", f"ctxslot{s.idx}",
                                        ts=self._clock())
                s.state = ContextState.EMPTY
                s.name, s.buffers, s.bytes_resident = None, None, 0
                s.copied = None
                self.stats["evictions"] += 1
                return
        # slot already gone (e.g. explicit evict raced ahead) — fine.

    def _submit_unlocked(self, desc: ContextDescriptor) -> Future:
        fut = self._loader.submit(self._do_load, desc)
        return fut

    def preload(self, name: str, block: bool = False,
                allow_evict_active: bool = False) -> Future:
        """Start loading `name` into a non-active slot (overlaps execution).

        This is the paper's dynamic reconfiguration: the call returns
        immediately; the active context keeps executing.  Repeated preloads
        of an in-flight name return the same future.  Victim selection is
        the policy's: it evicts the LRU non-active resident; when every
        slot is pinned (ACTIVE or loading) the request is *deferred* and
        resubmitted automatically as soon as a slot frees up.

        ``allow_evict_active`` marks a quiescent point (no run in flight):
        the policy may then overwrite even the currently selected context,
        exactly like the simulator's between-runs decision.
        """
        desc = self._contexts[name]
        with self._lock:
            slot = self._find_slot(name)
            if slot is not None:                        # already resident
                f: Future = Future()
                f.set_result(slot)
                return f
            pending = self._pending.get(name)
            if pending is not None and not pending.done():
                return pending                          # already in flight
            decision = self.policy.ensure(
                name, active=None if allow_evict_active
                else self._active_name())
            if decision is None:                        # all slots pinned
                ph: Future = Future()
                self._pending[name] = ph
                self._deferred[name] = ph
                fut = ph
            else:
                for v in decision.evictions:
                    self._evict_name_unlocked(
                        v, demote_ok=allow_evict_active)
                fut = self._submit_unlocked(desc)
                self._pending[name] = fut
        if block:
            fut.result()
        return fut

    def prefetch(self, upcoming: "list[str]",
                 limit: Optional[int] = None) -> "list[Future]":
        """Stream upcoming contexts into shadow slots per the policy's
        lookahead plan (hidden behind the active context's execution).

        One atomic policy consultation under the engine lock — the same
        ``ReconfigPolicy.prefetch`` call the simulator makes, so live and
        simulated prefetch/evict decisions are literally the same code.
        """
        futs: list[Future] = []
        with self._lock:
            known = [n for n in upcoming
                     if n in self._contexts and n not in self._deferred]
            for dec in self.policy.prefetch(
                    known, active=self._active_name(), limit=limit):
                for v in dec.evictions:
                    self._evict_name_unlocked(v)
                fut = self._submit_unlocked(self._contexts[dec.net])
                self._pending[dec.net] = fut
                futs.append(fut)
            self._kick_deferred_unlocked()   # evictions may free deferred
        return futs

    def _kick_deferred_unlocked(self):
        """Resubmit deferred loads whose slot just became available (FIFO:
        the configuration port serves requests in arrival order)."""
        for name in list(self._deferred):
            decision = self.policy.ensure(name, active=self._active_name())
            if decision is None:
                break                                   # still no room
            ph = self._deferred.pop(name)
            for v in decision.evictions:
                self._evict_name_unlocked(v)
            real = self._submit_unlocked(self._contexts[name])

            def _chain(f: Future, ph: Future = ph):
                exc = f.exception()
                if exc is not None:
                    ph.set_exception(exc)
                else:
                    ph.set_result(f.result())
            real.add_done_callback(_chain)

    def _claim_slot(self, name: str) -> ContextSlot:
        """Runs on the loader thread.  The policy freed a slot when this
        load was admitted, so an EMPTY slot exists by the time the single
        port gets to it; the wait loop is a defensive backstop."""
        deadline = time.monotonic() + 60.0
        while True:
            with self._lock:
                for slot in self.slots:
                    if slot.state == ContextState.EMPTY:
                        slot.state = ContextState.LOADING
                        slot.name = name
                        return slot
            if time.monotonic() > deadline:             # pragma: no cover
                raise RuntimeError(f"no slot became loadable for {name!r}")
            time.sleep(0.001)

    def _do_load(self, desc: ContextDescriptor):
        slot = self._claim_slot(desc.name)
        t0 = self._clock()
        with self._lock:
            self._load_started_at = t0
            self._load_hidden_accum = 0.0
        try:
            bufs = self._copy_in(desc.weights_fn(), slot)
        except BaseException:
            with self._lock:                 # failed load never wedges a slot
                slot.state = ContextState.EMPTY
                slot.name, slot.buffers, slot.bytes_resident = None, None, 0
                slot.copied = None
                self.policy.abort(desc.name)
                self._load_started_at = None
                self._kick_deferred_unlocked()
            if self._trace.enabled:
                self._trace.instant(f"load-failed:{desc.name}",
                                    f"ctxslot{slot.idx}", ts=self._clock())
            raise
        now = self._clock()
        dt = now - t0
        with self._lock:
            slot.buffers = bufs
            slot.bytes_resident = nbytes = _nbytes(bufs)
            slot.state = ContextState.READY
            self.policy.complete(desc.name)
            self.stats["loads"] += 1
            self.stats["load_seconds"] += dt
            self.stats["bytes_loaded"] += nbytes
            # overlap accounting: execution time inside [t0, now] counts
            # this load as *hidden* reconfiguration.  Runs that completed
            # during the window accumulated their clamped overlap in
            # _load_hidden_accum (see run()); a run still in flight
            # contributes the part since max(run_start, load_start).
            hidden = self._load_hidden_accum
            if self._run_started_at is not None:
                hidden += now - max(self._run_started_at, t0)
            hidden = max(0.0, min(dt, hidden))
            self.stats["hidden_load_seconds"] += hidden
            self._load_started_at = None
            self._kick_deferred_unlocked()
        if self._trace.enabled:
            # the span carries the SAME t0/now the accounting above used,
            # so a hidden-load fraction recomputed from exported spans
            # reproduces the engine's number (tested to < 1%).
            self._trace.span(f"load:{desc.name}", f"ctxslot{slot.idx}",
                             t0, now, args={"bytes": nbytes,
                                            "hidden_s": round(hidden, 6)})
        return slot

    def _copy_in(self, host, slot: ContextSlot):
        """Copy a host weight tree into device buffers, tensor by tensor
        (the two-step WL programming analogue).  On a CUDA card the copies
        run on the side stream from pinned host memory (tensors that are
        not pinned are pinned first), so they overlap the compute stream's
        steps; the slot's ``copied`` event is recorded after the last one
        and this loader thread -- never the compute thread -- waits on it,
        so the load's measured time is the copy's.  Buffers are marked as
        used by the compute stream, so freeing an evicted slot never hands
        its memory to a new load while queued steps still read it."""
        if not self._cuda:
            return _map(lambda t: t.to(self.device), host)

        def one(t):
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            d = t.to(self.device, non_blocking=True)
            d.record_stream(self._compute_stream)
            return d

        with torch.cuda.stream(self._copy_stream):
            bufs = _map(one, host)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._copy_stream)
        slot.copied.synchronize()
        return bufs

    # ------------------------------------------------------------ switching
    def switch(self, name: str, wait: bool = True,
               timeout: float = 120.0) -> float:
        """Activate a resident context.  Returns the switch latency in s.

        O(1): no device data movement.  If the context is still LOADING and
        ``wait``, blocks until READY (the paper's case where t_load >
        t_exec and reconfiguration is only partially hidden).
        """
        t0 = self._clock()
        deadline = t0 + timeout
        checked_done: Optional[Future] = None
        while True:
            # residency check and activation under ONE lock acquisition: a
            # concurrent eviction (loader kick, another client's prefetch)
            # between them could otherwise activate an emptied slot.
            with self._lock:
                slot = self._find_slot(name)
                if slot is not None:
                    if slot.copied is not None:   # ordered behind the copy
                        torch.cuda.current_stream(self.device).wait_event(
                            slot.copied)
                    prev = None
                    for s in self.slots:
                        if s.state == ContextState.ACTIVE:
                            s.state = ContextState.READY
                            prev = s.name
                    slot.state = ContextState.ACTIVE
                    self.policy.activate(name)
                    now = self._clock()
                    dt = now - t0
                    self.stats["switches"] += 1
                    if prev != name:     # an actual select-signal flip
                        self.stats["context_changes"] += 1
                        if self._trace.enabled:
                            self._trace.instant(
                                f"switch:{name}", f"ctxslot{slot.idx}",
                                ts=now, args={"from": prev})
                    self.stats["switch_seconds"] += dt
                    self._kick_deferred_unlocked()  # prev became evictable
                    return dt
                pending = self._pending.get(name)
            if pending is None:
                raise KeyError(f"context {name!r} not resident; preload first")
            if pending.done():
                if pending.exception() is not None:
                    pending.result()         # surface the load failure
                if pending is checked_done:
                    # re-checked residency under the lock after this future
                    # resolved and the slot is still gone: evicted again
                    raise KeyError(
                        f"context {name!r} not resident; preload first")
                # the load may have finished between our locked residency
                # check and here — loop once to re-check under the lock
                checked_done = pending
                continue
            if not wait:
                raise RuntimeError(f"context {name!r} still loading")
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise TimeoutError(f"context {name!r} did not become READY")
            pending.result(remaining)

    def deactivate(self):
        """Park the select signal: ACTIVE -> READY (slot stays resident)."""
        with self._lock:
            for s in self.slots:
                if s.state == ContextState.ACTIVE:
                    s.state = ContextState.READY
            self.policy.deactivate()
            self._kick_deferred_unlocked()

    @property
    def active(self) -> Optional[ContextSlot]:
        for s in self.slots:
            if s.state == ContextState.ACTIVE:
                return s
        return None

    # ------------------------------------------------------------ execution
    def run(self, *inputs):
        """Execute the active context on `inputs`."""
        slot = self.active
        if slot is None:
            raise RuntimeError("no ACTIVE context; call switch() first")
        return self.run_step(self._contexts[slot.name].apply_fn, *inputs,
                             slot=slot)

    def run_step(self, fn, *inputs, block: bool = True, slot=None):
        """Token-granular execution: run one program against the ACTIVE
        slot's weight buffers, with the engine's hidden-load (overlap)
        accounting.  ``block`` waits for the compute stream, so the run's
        measured span is the device's, not just the enqueue.

        This is how the continuous-batching step engine drives the fabric:
        each decode step is one ``run_step`` call, so a context switch
        between any two steps is an O(1) select flip and a shadow-slot
        load overlaps *steps*, not whole batches.  ``fn`` receives the
        slot buffers as its first argument (``fn(params, *inputs)``) — the
        engine never captures weights, the slot may be evicted and
        reloaded between calls.  ``slot`` pins a pre-resolved slot so a
        caller that looked up an executable for it (``run``) can't race a
        concurrent switch into mismatched fn/buffers.
        """
        if slot is None:
            slot = self.active
        if slot is None:
            raise RuntimeError("no ACTIVE context; call switch() first")
        t0 = self._clock()
        with self._lock:
            self._runs_in_flight += 1
            if self._run_started_at is None:
                self._run_started_at = t0
        try:
            out = fn(slot.buffers, *inputs)
            if block and self._cuda:
                torch.cuda.current_stream(self.device).synchronize()
        finally:
            now = self._clock()
            with self._lock:
                self._runs_in_flight -= 1
                self._exec_busy_until = now
                if self._load_started_at is not None:
                    # clamp this run's overlap to the open load window
                    self._load_hidden_accum += max(
                        0.0, now - max(t0, self._load_started_at))
                if self._runs_in_flight == 0:
                    self._run_started_at = None
            if self._trace.enabled:
                # same t0/now as the overlap accounting — see _do_load.
                self._trace.span(f"run:{slot.name}", f"ctxslot{slot.idx}",
                                 t0, now)
        return out

    # --------------------------------------------------------------- misc
    def hidden_load_fraction(self) -> float:
        """Share of reconfiguration time hidden behind execution (the
        paper's headline metric) — single source for every report."""
        with self._lock:
            return safe_ratio(self.stats["hidden_load_seconds"],
                              self.stats["load_seconds"])

    def resident(self) -> list[str]:
        return [s.name for s in self.slots
                if s.state in (ContextState.READY, ContextState.ACTIVE)]

    def evict(self, name: str):
        with self._lock:
            s = self._find_slot(name)
            if s is None:
                return
            if s.state == ContextState.ACTIVE:
                raise RuntimeError("cannot evict the ACTIVE context")
            s.state = ContextState.EMPTY
            s.name, s.buffers, s.bytes_resident = None, None, 0
            s.copied = None
            self.stats["evictions"] += 1
            self.policy.release(name)
            self._kick_deferred_unlocked()

    def shutdown(self):
        self._loader.shutdown(wait=True)

