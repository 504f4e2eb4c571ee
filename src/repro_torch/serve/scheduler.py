"""Switch-aware asynchronous request schedulers.

Two front doors over a ``SwitchableServer``:

  * ``SwitchScheduler``     — streak-batched: coalesces each context's
    backlog into run-to-completion batches (one switch per streak).
  * ``ContinuousScheduler`` — token-granular: a persistent ``StepEngine``
    per context; requests join/leave at every decode step, and the
    active context is re-decided at step boundaries (drain-vs-stack),
    with the next context streaming into the shadow slot while steps of
    the active one execute.

The paper's timing result — reconfiguration hidden behind execution — only
materializes at serving scale if *something* orders the traffic so that
(a) requests for the resident model run back-to-back (one switch amortized
over many batches) and (b) the next model's weights stream into the shadow
slot while the current streak executes.  A synchronous single-caller server
leaves both to the client.  ``SwitchScheduler`` is that something:

    clients ──submit(name, tokens)──▶ per-context queues
                                         │   pick next context:
                                         │   policy.rank_contexts
                                         │   (queue pressure − load cost,
                                         │    age-boosted for fairness)
                                         ▼
                                   service streak ──▶ SwitchableServer
                                         │                 │
                                         │   engine.prefetch(next ranked)
                                         │   (shadow-slot load hidden
                                         ▼    behind the active streak)
                                      futures resolve

All slot/eviction/prefetch decisions route through the engine's shared
``ReconfigPolicy`` (``repro_torch.core.policy``) — the scheduler only shapes the
traffic.  Same-shape greedy requests inside a streak are stacked into one
forward pass; everything else is served back-to-back after a single switch.
"""
from __future__ import annotations

import math
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.distributed.mesh import shard_count
from repro_torch.serve.engine import EngineKey, _mix
from repro_torch.serve.speculative import SpecKey
from repro_torch.serve.telemetry import Telemetry, safe_ratio

# request-level histograms surfaced by every scheduler snapshot
_LATENCY_HISTS = ("ttft_s", "queue_wait_s", "token_latency_s",
                  "decode_stall_s", "admit_to_first_chunk_s",
                  "gen_latency_s", "request_latency_s")


@dataclass
class _Request:
    name: str
    tokens: np.ndarray
    steps: int
    seed: int
    future: Future
    submitted_at: float
    explicit_seed: bool = False    # caller pinned `seed` (reproducible row)


class SwitchScheduler:
    """Async front door over a ``SwitchableServer``.

    ``submit`` enqueues and returns a ``Future``; one scheduler thread
    drains per-context queues in policy-ranked order, coalescing each
    chosen context's backlog into a single service streak and preloading
    the next-ranked context into the shadow slot before the streak runs.

    ``max_streak`` bounds how many requests one context may serve before
    the scheduler re-ranks (starvation bound); ``age_weight`` converts
    request age (seconds) into extra queue pressure so a low-traffic
    context eventually wins over a flooded one.
    """

    def __init__(self, server, max_streak: int = 16,
                 age_weight: float = 10.0, cost_weight: float = 1.0):
        self.server = server
        self.max_streak = max_streak
        self.age_weight = age_weight
        self.cost_weight = cost_weight
        self._queues: dict[str, deque[_Request]] = defaultdict(deque)
        self._cv = threading.Condition()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._load_cost: dict[str, float] = {}   # measured seconds, EMA
        # scheduler stats live in the server's shared MetricRegistry under
        # ``sched.`` (dict-compatible view); a fresh scheduler zeroes its
        # own keys, matching the old fresh-dict semantics
        self.telemetry = getattr(server, "telemetry", None) or Telemetry()
        self._clock = self.telemetry.clock
        self._trace = self.telemetry.tracer
        self.stats = self.telemetry.view("sched.")
        self.stats.update({
            "requests": 0, "batches": 0, "streaks": 0,
            "stacked_requests": 0, "busy_seconds": 0.0,
            "admitted_requests": 0, "rejected_requests": 0,
            "queued_requests": 0,
        })

    # ------------------------------------------------------------- client
    def submit(self, name: str, tokens, steps: int = 1,
               seed: Optional[int] = None) -> Future:
        """Enqueue one request; resolves to the (B, steps) output array."""
        if name not in self.server.served():
            raise KeyError(f"model {name!r} not registered")
        fut: Future = Future()
        req = _Request(name=name, tokens=np.asarray(tokens), steps=steps,
                       seed=self.server.next_seed() if seed is None else seed,
                       future=fut, submitted_at=self._clock())
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is stopped")
            self._queues[name].append(req)
            self.stats["requests"] += 1
            self._note_queued_locked()
            self._cv.notify()
        if self._trace.enabled:
            self._trace.instant(f"submit:{name}", "sched",
                                ts=req.submitted_at)
        return fut

    def _note_queued_locked(self):
        """Refresh the queued-requests gauge; caller holds ``_cv``."""
        self.stats["queued_requests"] = sum(
            len(q) for q in self._queues.values())

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "SwitchScheduler":
        assert self._thread is None, "already started"
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="switch-scheduler")
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the loop; with ``drain`` every queued request is served
        first, otherwise leftovers get a RuntimeError.  Requests that can
        no longer drain (scheduler never started, or its thread died) are
        always failed rather than left with futures that never resolve."""
        with self._cv:
            self._stopping = True
            self._drain = drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        for q in self._queues.values():
            while q:
                q.popleft().future.set_exception(
                    RuntimeError("scheduler stopped before serving this "
                                 "request"))
                self.stats["rejected_requests"] += 1
        with self._cv:
            self._note_queued_locked()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    # ------------------------------------------------------------ ranking
    def _pressures(self, now: float) -> dict[str, float]:
        """Queue pressure per context: backlog size plus age boost (an old
        request in a quiet queue counts as much as `age_weight`·seconds of
        backlog, so no context starves)."""
        out = {}
        for name, q in self._queues.items():
            if q:
                age = now - q[0].submitted_at
                out[name] = len(q) + self.age_weight * age
        return out

    def _ranked(self, now: float) -> list[str]:
        return self.server.engine.policy.rank_contexts(
            self._pressures(now), self._load_cost,
            cost_weight=self.cost_weight)

    def _note_load_cost(self, name: str, seconds: float):
        prev = self._load_cost.get(name)
        self._load_cost[name] = (seconds if prev is None
                                 else 0.5 * prev + 0.5 * seconds)

    # --------------------------------------------------------------- loop
    def _loop(self):
        while True:
            with self._cv:
                while not self._stopping and not any(
                        self._queues.values()):
                    self._cv.wait(timeout=0.1)
                if self._stopping and (not getattr(self, "_drain", True)
                                       or not any(self._queues.values())):
                    return
                now = self._clock()
                ranked = self._ranked(now)
                name = ranked[0]
                streak: list[_Request] = []
                q = self._queues[name]
                while q and len(streak) < self.max_streak:
                    streak.append(q.popleft())
                self.stats["admitted_requests"] += len(streak)
                self._note_queued_locked()
                for r in streak:
                    self.telemetry.observe(
                        "queue_wait_s", now - r.submitted_at,
                        doc="seconds between submit and admission")
                # next context with pending work (after this streak drains)
                upcoming = [n for n in ranked[1:] if self._queues[n]]
                if not upcoming and q:
                    upcoming = [name]        # more of the same backlog
            try:
                self._serve_streak(name, streak, upcoming)
            except BaseException as e:       # backstop: never die with
                for r in streak:             # unresolved futures behind
                    if not r.future.done():
                        r.future.set_exception(e)

    def _serve_streak(self, name: str, streak: list[_Request],
                      upcoming: list[str]):
        engine = self.server.engine
        t0 = self._clock()
        try:
            was_resident = engine.policy.holds(name)
            engine.preload(name)
            engine.switch(name, wait=True)
        except BaseException as e:           # context unloadable: fail the
            for r in streak:                 # streak, keep the loop alive
                if not r.future.done():
                    r.future.set_exception(e)
            return
        if not was_resident:
            self._note_load_cost(name, self._clock() - t0)
        # the paper's dynamic reconfiguration: next context streams into
        # the shadow slot while this streak executes (policy picks victims).
        # Prefetch is advisory: a failure must not take the streak down
        # (the next streak pays a demand load instead).
        try:
            engine.prefetch(upcoming, limit=1)
        except Exception:
            pass
        for group in self._stack(streak):
            try:
                out = self._run_group(name, group)
            except BaseException as e:       # a bad batch fails only itself
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            off = 0
            done = self._clock()
            for r in group:
                n = r.tokens.shape[0]
                r.future.set_result(out[off:off + n])
                off += n
                self.telemetry.observe(
                    "request_latency_s", done - r.submitted_at,
                    doc="seconds between submit and future resolution")
            self.stats["batches"] += 1
        now = self._clock()
        self.stats["streaks"] += 1
        self.stats["busy_seconds"] += now - t0
        if self._trace.enabled:
            self._trace.span(f"streak:{name}", "sched", t0, now,
                             args={"requests": len(streak)})

    # ------------------------------------------------------------ batching
    def _stack(self, streak: list[_Request]) -> list[list[_Request]]:
        """Coalesce same-shape requests into joint forward passes.

        Only greedy (temperature==0) contexts stack — stacked rows share
        one sampling key, which would correlate temperature>0 draws.
        Non-stackable requests run back-to-back, still amortizing the
        switch across the streak.
        """
        sm = self.server._served[streak[0].name]
        if sm.temperature > 0.0:
            return [[r] for r in streak]
        groups: dict[tuple, list[_Request]] = {}
        order: list[tuple] = []
        for r in streak:
            key = (r.tokens.shape[1], r.steps)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        self.stats["stacked_requests"] += sum(
            len(g) - 1 for g in groups.values() if len(g) > 1)
        return [groups[k] for k in order]

    def _run_group(self, name: str, group: list[_Request]) -> np.ndarray:
        tokens = (group[0].tokens if len(group) == 1 else
                  np.concatenate([r.tokens for r in group], axis=0))
        return self.server.serve_batch(name, tokens, steps=group[0].steps,
                                       seed=group[0].seed)

    # ------------------------------------------------------------- report
    def snapshot(self) -> dict:
        return _snapshot(self.stats, self.server.engine, self.telemetry)


def _snapshot(stats: dict, engine, telemetry=None) -> dict:
    """Scheduler stats merged with the context engine's switching stats —
    one shape for every scheduler's report.  With a telemetry handle,
    request-level latency histograms (summaries) ride along too."""
    eng = engine.stats
    out = {**stats, "switches": eng["switches"],
           "context_changes": eng["context_changes"],
           "loads": eng["loads"], "evictions": eng["evictions"],
           "hidden_load_fraction": engine.hidden_load_fraction()}
    if telemetry is not None:
        hists = {}
        for name in _LATENCY_HISTS:
            h = telemetry.registry.histogram(name)
            if h is not None and h.count:
                hists[name] = h.summary()
        if hists:
            out["latency_hists"] = hists
    return out


# ---------------------------------------------------------------------------
# token-granular continuous batching
# ---------------------------------------------------------------------------

@dataclass
class _Inflight:
    """One submitted request fanned out over `need` slot rows."""
    req: _Request
    need: int
    rows: dict = None

    def __post_init__(self):
        self.rows = {}


class ContinuousScheduler:
    """Token-granular front door: one persistent ``StepEngine`` per
    context, advanced one decode step at a time.

    Every iteration of the loop is one step boundary, where ALL of the
    paper's hide-the-load machinery happens at token granularity:

      * admission    — queued requests prefill into free slots of the
                       active context's pool (no padding to the slowest
                       request: a finished row frees its slot immediately)
      * retirement   — EOS / step-limit rows leave, futures resolve
      * ranking      — ``policy.rank_contexts`` on queue pressure (age
                       boosted) + a paused context's stranded live rows
      * drain-vs-stack — if another context's pressure beats the active
                       one by ``switch_margin``, stop admitting (drain)
                       and start its shadow-slot preload behind the
                       remaining steps; keep stacking otherwise
      * switch       — O(1) select flip once the pool drains (or
                       immediately past ``preempt_margin`` — paused rows
                       stay frozen in their engine's state and resume on
                       switch-back)

    Decode state persists per context across switches (beyond-paper: an
    FPGA loses flip-flop state on reconfiguration; our slots are HBM).

    ``paged=True`` gives every context's engine a paged slot pool
    (``page_size`` tokens per page); admission then also gates on free
    pages.  ``prefill_chunk=C`` streams each admitted prompt into its
    slot in (b, C) chunks, one per tick, behind the decode steps;
    ``quantize_kv="int8"`` (paged) stores the page pools as int8 codes
    with per-token scales; ``shards=N`` (paged) splits every engine's page
    bank into N per-shard free-lists (over ``mesh``'s first axis when
    given), with admission routed to the least-loaded shard;
    ``multi_step=T`` fuses up to T decode steps into each engine tick
    (one CUDA graph replay on a card), so the rank/drain/admit
    bookkeeping amortizes over up to T tokens, with streams bitwise those
    of single steps (``snapshot()["steps_per_tick"]`` reports the
    realized ratio); ``prefix_cache=True`` (paged) maps an admission's
    already written whole-page prompt prefix read-only and prefills only
    its suffix, evicting cached pages LRU-first under page pressure
    (the snapshot then carries ``prefix_hits``, ``prefix_pages_mapped``,
    ``cow_copies`` and ``cache_evictions``); ``share_bank=True`` (paged)
    has every engine of a context allocate from, and index into, one
    ``SharedBank`` (a speculative target column of the context too).

    ``draft`` maps a context name to a *draft* context: requests for that
    context run on a speculative ``SpecEngine`` (draft proposes
    ``spec_k`` tokens, the target verifies them in one multi-token pass;
    ``spec_tree`` candidates per depth; ``spec_adaptive`` walks each
    engine's K inside [1, spec_k] from the measured acceptance) instead
    of a plain ``StepEngine`` — mixed speculative/plain traffic shares the
    same rank/drain/stack loop, and each draft/target hand-off inside a
    round is an O(1) select flip with the other context prefetched into
    the shadow slot.  The speculative engines' cache columns are always
    paged (``page_size`` when ``paged``).

    Per-request seeds ARE honored for plain contexts: a seeded row draws
    from its own generator state (folded with the row's token position),
    so a seeded resubmission reproduces its tokens exactly regardless of
    slot or surrounding traffic.  Speculative contexts reject seeds (the
    accept/reject cascade has no per-row schedule).
    """

    def __init__(self, server, batch_size: int = 8,
                 age_weight: float = 10.0, cost_weight: float = 1.0,
                 switch_margin: float = 1.5, preempt_margin: float = 6.0,
                 draft: Optional[dict] = None, spec_k: int = 4,
                 spec_tree: int = 1, spec_adaptive: bool = False,
                 prefill_chunk: Optional[int] = None,
                 paged: bool = False, page_size: int = 256,
                 quantize_kv: Optional[str] = None,
                 shards: Optional[int] = None, mesh=None,
                 multi_step: int = 1, prefix_cache: bool = False,
                 share_bank: bool = False):
        self.server = server
        self.batch_size = batch_size
        # sharded page bank (paged mode): engines partition their page
        # pool over `shards` per-shard free-lists (and over `mesh`'s
        # first axis when given) with locality-routed admission
        if (shards or mesh) and not paged:
            raise ValueError("shards/mesh need paged=True")
        self.shards = shards
        self.mesh = mesh
        # paged slot pool: every context's engine pools KV pages across
        # slots (per-request memory ∝ its own length, not max_len), so
        # the same memory serves more concurrent short requests;
        # admission additionally gates on free pages via ``can_admit``
        self.paged = paged
        self.page_size = page_size
        # chunked admission: a long prompt's prefill hides behind decode
        # steps one (b, C) chunk per tick instead of stalling them
        self.prefill_chunk = prefill_chunk
        # int8 page pool (paged mode): about half the bytes per page
        self.quantize_kv = quantize_kv
        # fused decode: each engine tick commits up to ``multi_step``
        # steps in one device program
        self.multi_step = multi_step
        # prefix cache (paged mode): admissions whose prompt starts with
        # an already written whole-page run map those pages read-only
        # and prefill only the divergent suffix; ``can_admit`` evicts
        # cached pages LRU-first under page pressure
        if prefix_cache and not paged:
            raise ValueError("prefix_cache needs paged=True")
        self.prefix_cache = prefix_cache
        # shared page banks: a context's engines allocate from one pool
        # and share one prefix index
        if share_bank and not paged:
            raise ValueError("share_bank needs paged=True")
        self.share_bank = share_bank
        self.age_weight = age_weight
        self.cost_weight = cost_weight
        self.switch_margin = switch_margin
        self.preempt_margin = preempt_margin
        self.draft = dict(draft or {})
        self.spec_k = spec_k
        # speculative tree width (siblings per depth; 1 == flat chain)
        if spec_tree < 1:
            raise ValueError(f"spec_tree must be >= 1, got {spec_tree}")
        self.spec_tree = spec_tree
        # acceptance-driven adaptive K: EWMA the measured per-tick
        # acceptance fraction and walk each spec engine's K inside
        # [1, spec_k] (spec_k is the ceiling — admission slack, program
        # cache, and submit validation all use it)
        self.spec_adaptive = spec_adaptive
        self._accept_ewma: dict[str, float] = {}
        self._spec_prev: dict[str, tuple[int, int]] = {}
        self._queues: dict[str, deque[_Request]] = defaultdict(deque)
        self._inflight: dict[int, _Inflight] = {}
        self._inflight_seq = 0          # monotonic key: ids recycle, this
        self._cv = threading.Condition()                      # never does
        self._stopping = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self._load_cost: dict[str, float] = {}
        # paused contexts with frozen rows: when they went stranded (only
        # touched by the loop thread) — the starvation guard's age base
        self._stranded_since: dict[str, float] = {}
        self._tick_ctx: Optional[str] = None   # context the current tick
        #                                        acts on (failure target)
        # shared-registry stats view (see SwitchScheduler.__init__)
        self.telemetry = getattr(server, "telemetry", None) or Telemetry()
        self._clock = self.telemetry.clock
        self._trace = self.telemetry.tracer
        self.stats = self.telemetry.view("sched.")
        self.stats.update({
            "requests": 0, "steps": 0, "admitted_rows": 0,
            "drain_switches": 0, "preempt_switches": 0,
            "busy_seconds": 0.0,
            "admitted_requests": 0, "rejected_requests": 0,
            "queued_requests": 0,
            "admit_blocked_no_slots": 0, "admit_blocked_no_pages": 0,
            "admit_blocked_no_shard_pages": 0,
        })

    # ------------------------------------------------------------- client
    def submit(self, name: str, tokens, steps: int = 1,
               seed: Optional[int] = None) -> Future:
        """Enqueue one request; resolves to the (b, steps) output array.

        ``seed`` pins the request's sampling draws to its own per-slot
        seed column (``DecodeState.rseed``), folded with each token's
        position: a seeded resubmission reproduces its tokens exactly,
        independent of slot assignment, admission boundary, and pool
        traffic.  Speculative contexts (see ``draft``) reject seeds."""
        if name not in self.server.served():
            raise KeyError(f"model {name!r} not registered")
        if seed is not None and name in self.draft:
            raise ValueError(
                "speculative contexts do not honor per-request seeds; "
                "submit to a plain context for seed reproducibility")
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        b, S = tokens.shape
        if b > self.batch_size:
            raise ValueError(f"request batch {b} > pool size "
                             f"{self.batch_size}")
        sm = self.server._served[name]
        slack = self.spec_k if name in self.draft else 0
        if S + steps + slack > sm.max_len:
            raise ValueError(f"prompt {S} + {steps} steps (+{slack} "
                             f"speculative slack) exceeds max_len "
                             f"{sm.max_len}")
        fut: Future = Future()
        req = _Request(name=name, tokens=tokens, steps=steps,
                       seed=self.server.next_seed() if seed is None
                       else seed,
                       future=fut, submitted_at=self._clock(),
                       explicit_seed=seed is not None)
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is stopped")
            self._queues[name].append(req)
            self.stats["requests"] += 1
            self._note_queued_locked()
            self._cv.notify()
        if self._trace.enabled:
            self._trace.instant(f"submit:{name}", "sched",
                                ts=req.submitted_at)
        return fut

    def _note_queued_locked(self):
        """Refresh the queued-requests gauge; caller holds ``_cv``."""
        self.stats["queued_requests"] = sum(
            len(q) for q in self._queues.values())

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ContinuousScheduler":
        assert self._thread is None, "already started"
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-scheduler")
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        with self._cv:
            self._stopping = True
            self._drain = drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err = RuntimeError("scheduler stopped before serving this request")
        for q in self._queues.values():
            while q:
                q.popleft().future.set_exception(err)
                self.stats["rejected_requests"] += 1
        for inf in list(self._inflight.values()):   # admitted, unfinished
            if not inf.req.future.done():
                inf.req.future.set_exception(err)
        self._inflight.clear()
        with self._cv:
            self._note_queued_locked()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    # ------------------------------------------------------------ engines
    def _engine(self, name: str):
        if name in self.draft:
            return self._spec_engine(name)
        eng = self.server.step_engine(name, self.batch_size,
                                      prefill_chunk=self.prefill_chunk,
                                      paged=self.paged,
                                      page_size=self.page_size,
                                      quantize_kv=self.quantize_kv,
                                      shards=self.shards, mesh=self.mesh,
                                      multi_step=self.multi_step,
                                      prefix_cache=self.prefix_cache,
                                      share_bank=self.share_bank)
        if eng.runner is None:
            cse = self.server.engine
            # every device program (prefill + step) routes through the
            # context engine so shadow-slot loads overlap *steps* and the
            # hidden-load accounting sees token-granular execution; the
            # params slot is filled with the ACTIVE buffers by run_step.
            eng.runner = lambda fn, params, *args: cse.run_step(fn, *args)
        return eng

    def _spec_engine(self, name: str):
        dname = self.draft[name]
        eng = self.server.spec_engine(
            name, dname, self.batch_size, k=self.spec_k,
            tree_width=self.spec_tree,
            page_size=self.page_size if self.paged else None,
            prefill_chunk=self.prefill_chunk,
            prefix_cache=self.prefix_cache,
            quantize_kv=self.quantize_kv,
            share_bank=self.share_bank)
        if eng.runner is None:
            cse = self.server.engine

            def runner(which, fn, *args, _t=name, _d=dname):
                # the paper's dual-copy cascade at program granularity:
                # activate the side this program needs (O(1) when
                # resident) and stream the OTHER side into the shadow
                # slot behind this program's execution
                want, other = (_t, _d) if which == "target" else (_d, _t)
                cse.preload(want)
                cse.switch(want, wait=True)
                try:
                    cse.prefetch([other], limit=1)
                except Exception:
                    pass
                return cse.run_step(fn, *args)

            eng.runner = runner
        return eng

    def _step_key(self, name: str) -> EngineKey:
        """The server-side ``_step_engines`` cache key this scheduler's
        configuration resolves to (the same frozen ``EngineKey``
        ``SwitchableServer.step_engine`` builds; full-key matching
        matters because the server outlives schedulers with different
        configurations)."""
        ps = None
        if self.paged:
            ps = min(self.page_size, self.server._served[name].max_len)
        return EngineKey(name=name, batch_size=self.batch_size,
                         prefill_chunk=self.prefill_chunk, page_size=ps,
                         quantize_kv=self.quantize_kv,
                         prefix_cache=self.prefix_cache,
                         shared_bank=self.share_bank,
                         shards=shard_count(self.shards, self.mesh),
                         multi_step=self.multi_step)

    def _spec_key(self, name: str) -> SpecKey:
        """The server-side ``_spec_engines`` cache key this scheduler's
        configuration resolves to — the resolved page size mirrors
        ``SwitchableServer.spec_engine`` (scheduler page size when paged,
        the SpecEngine default otherwise)."""
        sm = self.server._served[name]
        ps = (min(self.page_size, sm.max_len) if self.paged
              else math.gcd(sm.max_len, 256))
        return SpecKey(name=name, draft=self.draft[name],
                       batch_size=self.batch_size, k=self.spec_k,
                       tree_width=self.spec_tree, page_size=ps,
                       quantize_kv=self.quantize_kv,
                       prefix_cache=self.prefix_cache,
                       prefill_chunk=self.prefill_chunk,
                       shared_bank=self.share_bank)

    def _live_engines(self):
        out = {}
        for name in self.server.served():
            if name in self.draft:
                eng = self.server._spec_engines.get(self._spec_key(name))
            else:
                eng = self.server._step_engines.get(self._step_key(name))
            if eng is not None and eng.live_slots():
                out[name] = eng
        return out

    # ------------------------------------------------------------ ranking
    def _pressures(self, now: float) -> dict[str, float]:
        out = {}
        with self._cv:
            for name, q in self._queues.items():
                if q:
                    age = now - q[0].submitted_at
                    out[name] = len(q) + self.age_weight * age
        # a paused context's stranded rows count as pressure too — they
        # must eventually be resumed and retired.  Age-boost them exactly
        # like queued requests (starvation guard): sustained pressure on a
        # hot competitor must not defer a preempted context's frozen rows
        # indefinitely.
        for name, eng in self._live_engines().items():
            age = now - self._stranded_since.get(name, now)
            out[name] = (out.get(name, 0.0) + eng.live_slots()
                         + self.age_weight * age)
        return out

    def _note_load_cost(self, name: str, seconds: float):
        prev = self._load_cost.get(name)
        self._load_cost[name] = (seconds if prev is None
                                 else 0.5 * prev + 0.5 * seconds)

    # --------------------------------------------------------------- loop
    def _has_work(self) -> bool:
        return (any(self._queues.values())
                or bool(self._live_engines()))

    def _loop(self):
        cur: Optional[str] = None
        while True:
            with self._cv:
                if not self._has_work():
                    if self._stopping:
                        return
                    self._cv.wait(timeout=0.05)
                    continue
                if self._stopping and not self._drain:
                    return
            try:
                cur = self._tick(cur)
            except BaseException as e:
                # fail the context the tick was ACTING on when it raised
                # (_tick may have switched away from `cur` first — failing
                # the stale name would poison an innocent context's
                # requests), keep the loop alive
                self._fail_context(self._tick_ctx, e)
                cur = None

    def _tick(self, cur: Optional[str]) -> Optional[str]:
        """One step boundary: rank, maybe switch, admit, step, retire."""
        self._tick_ctx = cur                  # who a mid-tick failure hits
        now = self._clock()
        pressures = self._pressures(now)
        if not pressures:
            return cur
        policy = self.server.engine.policy
        ranked = policy.rank_contexts(pressures, self._load_cost,
                                      cost_weight=self.cost_weight)
        cand = ranked[0]
        stack = True                          # keep admitting `cur`
        if cur is None:
            cur = self._try_activate(cand, cur)
            self._tick_ctx = cur
            if cur is None:
                return None
        elif cand != cur:
            cur_p = pressures.get(cur, 0.0)
            cand_p = pressures.get(cand, 0.0)
            eng = self._engine(cur)
            if eng.live_slots() == 0 and not self._queues[cur]:
                nxt = self._try_activate(cand, cur)   # free flip: nothing
                if nxt == cand:                       # to drain
                    self.stats["drain_switches"] += 1
                    if self._trace.enabled:
                        self._trace.instant(f"drain-switch:{cand}", "sched")
                cur = nxt
                self._tick_ctx = cur
            elif cand_p > self.switch_margin * max(cur_p, 1e-9):
                # drain decision: stop stacking; stream the winner into
                # the shadow slot behind the remaining steps (advisory —
                # a failed prefetch just means a demand load later)
                stack = False
                try:
                    self.server.engine.prefetch([cand], limit=1)
                except Exception:
                    pass
                drained = eng.live_slots() == 0
                preempt = cand_p > self.preempt_margin * max(cur_p, 1e-9)
                if drained or (preempt and policy.is_resident(cand)):
                    nxt = self._try_activate(cand, cur)
                    if nxt == cand:
                        kind = ("drain_switches" if drained
                                else "preempt_switches")
                        self.stats[kind] += 1
                        if self._trace.enabled:
                            self._trace.instant(
                                f"{kind[:-len('_switches')]}-switch:{cand}",
                                "sched")
                    cur = nxt
                    self._tick_ctx = cur
        eng = self._engine(cur)
        if stack:
            self._admit(cur, eng)
        if eng.live_slots():
            t0 = self._clock()
            finished = eng.step(None)         # params come from run_step
            self.stats["steps"] += 1
            self.stats["busy_seconds"] += self._clock() - t0
            self._resolve(finished)
            if self.spec_adaptive and cur in self.draft:
                self._adapt_k(cur, eng)
        else:
            time.sleep(0.0005)                # waiting on a load/queue
        # starvation-guard bookkeeping: stamp contexts left holding frozen
        # rows; the stamp ages their pressure until they are resumed
        mark = self._clock()
        live = self._live_engines()
        for name in live:
            self._stranded_since.setdefault(name, mark)
        self._stranded_since.pop(cur, None)
        for name in list(self._stranded_since):
            if name not in live:
                del self._stranded_since[name]
        return cur

    def _adapt_k(self, name: str, eng):
        """Acceptance-driven K: EWMA (alpha=0.2) the fraction of DRAFTED
        tokens the target accepted since the last look (stats deltas, so
        resets and other schedulers' traffic don't pollute it), then walk
        K one step inside [1, spec_k] with hysteresis — above 0.8 the
        draft is tracking the target and a longer chain amortizes more
        target calls per round; below 0.4 most drafted tokens are wasted
        draft steps, so shrink.  The dead band between keeps K stable
        under ordinary acceptance noise."""
        committed = eng.stats["committed_tokens"]
        rows = eng.stats["row_rounds"]
        pc, pr = self._spec_prev.get(name, (0, 0))
        dc, dr = committed - pc, rows - pr
        if dr <= 0:
            return                      # no row finished a round this tick
        self._spec_prev[name] = (committed, rows)
        # each row-round commits accepted+1 (the bonus/correction token)
        acc = (dc / dr - 1.0) / max(eng.k, 1)
        ew = self._accept_ewma.get(name)
        ew = acc if ew is None else 0.8 * ew + 0.2 * acc
        self._accept_ewma[name] = ew
        if ew > 0.8 and eng.k < eng.k_max:
            eng.set_k(eng.k + 1)
        elif ew < 0.4 and eng.k > 1:
            eng.set_k(eng.k - 1)

    def _activate(self, name: str) -> str:
        t0 = self._clock()
        was_resident = self.server.engine.policy.holds(name)
        self.server.engine.preload(name)
        self.server.engine.switch(name, wait=True)
        if not was_resident:
            self._note_load_cost(name, self._clock() - t0)
        return name

    def _try_activate(self, name: str, cur: Optional[str]) -> Optional[str]:
        """Activate `name`; on failure (unloadable context) fail ITS
        requests — queued, in flight, and stranded rows — so its pressure
        drains and the loop doesn't retry the same broken load forever.
        Returns the new active context (`cur` unchanged on failure)."""
        try:
            return self._activate(name)
        except BaseException as e:
            self._fail_context(name, e)   # also drops its engine's rows
            return cur

    # ---------------------------------------------------------- admission
    def _admit(self, name: str, eng):
        """Fill free slots from `name`'s queue (whole requests only: a
        request's rows prefill together, so its draws and MoE routing
        match the run-to-completion path)."""
        while True:
            with self._cv:
                q = self._queues[name]
                if not q:
                    return
                if not eng.can_admit(q[0].tokens, q[0].steps):
                    # distinguish WHY the head of the queue is stuck: no
                    # free slot, no pages pool-wide, or pages exist but
                    # not on the shard its pages route to
                    block = getattr(eng, "last_admit_block", None)
                    key = {"slots": "admit_blocked_no_slots",
                           "pages": "admit_blocked_no_pages",
                           "shard_pages": "admit_blocked_no_shard_pages",
                           }.get(block)
                    if key is not None:
                        self.stats[key] += 1
                    return
                req = q.popleft()
                self._note_queued_locked()
            b = req.tokens.shape[0]
            inf = _Inflight(req=req, need=b)
            key = self._inflight_seq
            self._inflight_seq += 1
            self._inflight[key] = inf
            # explicitly seeded requests pin each row to its own seed,
            # derived deterministically from (seed, row), so the same
            # (seed, prompt) resubmission reproduces row-for-row
            seeds = None
            if req.explicit_seed:
                seeds = [_mix(req.seed, i) for i in range(b)]
            try:
                gens = eng.admit(None, req.tokens, max_new=req.steps,
                                 metas=[(key, i) for i in range(b)],
                                 seeds=seeds,
                                 submitted_at=req.submitted_at)
            except BaseException as e:
                del self._inflight[key]
                self.stats["rejected_requests"] += 1
                req.future.set_exception(e)
                continue
            self.stats["admitted_rows"] += b
            self.stats["admitted_requests"] += 1
            self._resolve([g for g in gens if g.done])

    def _resolve(self, finished):
        for g in finished:
            key, row = g.meta
            inf = self._inflight.get(key)
            if inf is None:
                continue
            inf.rows[row] = g.tokens
            if len(inf.rows) == inf.need:
                del self._inflight[key]
                out = np.stack([np.asarray(inf.rows[i], np.int32)
                                for i in range(inf.need)])
                if not inf.req.future.done():
                    inf.req.future.set_result(out)
                    self.telemetry.observe(
                        "request_latency_s",
                        self._clock() - inf.req.submitted_at,
                        doc="seconds between submit and future resolution")

    def _fail_context(self, cur: Optional[str], exc: BaseException):
        """Fail everything belonging to `cur` (all contexts when None):
        queued requests, in-flight requests, and the context's engine
        state — a failed request's rows must not keep stepping, or their
        later retirement would route into the wrong inflight record."""
        with self._cv:
            reqs = []
            if cur is not None:
                q = self._queues[cur]
                while q:
                    reqs.append(q.popleft())
                self._note_queued_locked()
            self.stats["rejected_requests"] += len(reqs)
        for key, inf in list(self._inflight.items()):
            if cur is None or inf.req.name == cur:
                self._inflight.pop(key, None)
                if not inf.req.future.done():
                    inf.req.future.set_exception(exc)
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
        for (name, bsz, *_), eng in list(
                self.server._step_engines.items()):
            if bsz == self.batch_size and (cur is None or name == cur) \
                    and eng.live_slots():
                eng.reset()
        for skey, eng in list(self.server._spec_engines.items()):
            if skey.batch_size == self.batch_size \
                    and (cur is None or skey.name == cur) \
                    and eng.live_slots():
                eng.reset()

    # ------------------------------------------------------------- report
    def snapshot(self) -> dict:
        out = _snapshot(self.stats, self.server.engine, self.telemetry)
        ticks = dsteps = 0
        prefix = {"prefix_hits": 0, "prefix_pages_mapped": 0,
                  "cow_copies": 0, "cache_evictions": 0}
        for key, eng in self.server._step_engines.items():
            # full-key match: the server outlives schedulers
            if key == self._step_key(key.name):
                ticks += eng.stats["host_ticks"]
                dsteps += eng.stats["device_steps"]
                for k in prefix:
                    prefix[k] += eng.stats.get(k, 0)
        # always present (0 / 0.0 before the first tick) so report
        # consumers never need an existence check
        out["host_ticks"] = ticks
        out["device_steps"] = dsteps
        out["steps_per_tick"] = round(safe_ratio(dsteps, ticks), 3)
        if self.prefix_cache:
            # prefix-cache effectiveness across this config's engines
            out.update(prefix)
        rounds = row_rounds = committed = 0
        for skey, eng in self.server._spec_engines.items():
            # full-key match: the server outlives schedulers, so engines
            # from a prior draft/spec configuration may coexist
            if (self.draft.get(skey.name) == skey.draft
                    and skey == self._spec_key(skey.name)):
                rounds += eng.stats["rounds"]
                row_rounds += eng.stats["row_rounds"]
                committed += eng.stats["committed_tokens"]
        if rounds or self.draft:
            out["spec_rounds"] = rounds
            out["spec_committed_tokens"] = committed
            out["accepted_tokens_per_round"] = round(
                safe_ratio(committed, row_rounds), 3)
            # fraction of *drafted* tokens the target accepted: each row
            # round drafts spec_k and commits accepted+1 (the bonus token)
            out["spec_acceptance_rate"] = round(
                safe_ratio(committed - row_rounds,
                           row_rounds * self.spec_k), 3)
        return out
