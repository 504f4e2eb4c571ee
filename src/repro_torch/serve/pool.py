"""Host-side slot-pool bookkeeping shared by the serving engines.

``StepEngine`` and ``SpecEngine`` keep the same host-side pool around
their (different) device programs: a fixed bank of ``batch_size`` slots,
a free-list over them, per-slot ``Generation`` handles, retirement back
to the free-list, and the instant-retire key salt.  ``SlotPool`` is that
bookkeeping extracted once, so admission-path changes (validation,
chunked prefill, recycling order) land in one place and every engine
inherits them.

Pool invariants:

  * **FIFO recycling** — slots are taken from the *front* of the
    free-list and retired to the *back*.  The order is load-bearing: the
    admission draw indexes a shared (B, V) gumbel field by slot, so the
    seeded-draw reproducibility tests pin which slot a re-admission
    lands in.  A failed admission restores its slots to the front in
    their original order (``_restore_slots``), making the retry
    indistinguishable from the failed call.
  * **Admission is validated up front** — ``metas`` / ``seeds`` must
    match the prompt row count exactly.  An over-long ``seeds`` list
    used to raise ``IndexError`` deep in the key plumbing, and a short
    ``metas`` list silently mislabeled rows so retirement routed into
    the wrong inflight record.
  * **The device state is the engine's** — this class never touches
    caches or programs; engines that keep their sampling draws in a
    ``self.sampler`` (``repro_torch.serve.sampling``) get
    ``_salt_admit_key`` (the instant-retire salt) for free.

``ShardedPagePool`` splits the page bank into equal per-shard slices
with one free-list each (the JAX package's, without its refcounts).
The JAX package's refcounted prefix sharing (``PrefixIndex``, with
``PagePool.adopt``/``acquire``) and cross-engine ``SharedBank`` are not
ported yet, so every allocated page here has exactly one owner.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.serve.telemetry import Telemetry


@dataclass
class Generation:
    """Host-side handle for one admitted request (one slot row)."""
    rid: int
    prompt_len: int
    max_new: int
    slot: int = -1
    tokens: list = field(default_factory=list)
    done: bool = False
    meta: Any = None                      # scheduler payload (futures etc.)
    pages: Optional[list] = None          # pool pages owned (paged engines);
    #                                       None once released at retirement
    # lifecycle stamps (engine clock), for TTFT / queue-wait / latency
    # histograms and the per-request trace span:
    submitted_at: Optional[float] = None  # scheduler enqueue (if known)
    admitted_at: Optional[float] = None   # slot granted
    first_token_at: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.tokens)


class PagePool:
    """Host-side page allocator over one shared device KV page bank.

    The device side is one ``layers.PagedKV`` pool of ``total_pages``
    pages per layer; this class hands out page *ids*.  Page 0 is the
    PARK page: it is never allocated, dead page-table entries point at it
    (every table entry must be a valid pool index), and non-live rows'
    per-step writes are routed into it — so ``allocatable ==
    total_pages - 1``.

    Recycling contract (mirrors ``SlotPool``'s slot free-list, and is
    load-bearing for test reproducibility the same way):

      * **FIFO** — ``take`` pops from the *front*, ``release``
        (retirement) appends to the *back*: a page is reused as late as
        possible, and the allocation order of a fixed traffic pattern is
        deterministic.
      * **failed-admit restore** — ``restore`` puts pages back at the
        *front in their original order*, so a retried admission draws
        exactly the pages the failed call drew.
    """

    PARK = 0

    def __init__(self, total_pages: int, telemetry: Telemetry | None = None):
        if total_pages < 2:
            raise ValueError(f"need >= 2 pages (1 park + 1 allocatable), "
                             f"got {total_pages}")
        self.total_pages = total_pages
        self._tm = telemetry             # optional: free_pages gauge
        self.reset()

    num_shards = 1

    def _note_free(self):
        if self._tm is not None:
            self._tm.registry.gauge(
                self._tm.prefix + "free_pages", len(self._free))

    @property
    def allocatable(self) -> int:
        return self.total_pages - 1

    def free_pages(self) -> int:
        return len(self._free)

    def blocked(self, n: int) -> Optional[str]:
        """Why ``take(n)`` would fail right now: ``None`` (it would not),
        ``"pages"`` (the pool is short) or ``"shard_pages"`` (room
        exists, but not on the shard this request routes to -- sharded
        pools only)."""
        return None if n <= len(self._free) else "pages"

    def blocked_rows(self, b: int, n: int) -> Optional[str]:
        """``blocked`` for ``b`` independent rows of ``n`` pages each,
        admitted in sequence under the routing policy."""
        return None if b * n <= len(self._free) else "pages"

    def take(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"take({n}) with {len(self._free)} free "
                               "pages")
        pages = [self._free.popleft() for _ in range(n)]
        self._held.update(pages)
        self._note_free()
        return pages

    def _drop(self, pages: list[int]) -> list[int]:
        for p in pages:
            if p not in self._held:
                raise ValueError(f"page {p} is not allocated")
            self._held.remove(p)
        return pages

    def restore(self, pages: list[int]):
        """Failed admission: pages go back to the FRONT in original
        order."""
        self._free.extendleft(reversed(self._drop(pages)))
        self._note_free()

    def release(self, pages: list[int]):
        """Retirement: pages go to the BACK (FIFO recycling)."""
        self._free.extend(self._drop(pages))
        self._note_free()

    def reset(self):
        self._free: deque[int] = deque(range(1, self.total_pages))
        self._held: set[int] = set()
        self._note_free()


class ShardedPagePool(PagePool):
    """``PagePool`` split into ``num_shards`` equal slices with one
    free-list per shard.

    Page-id encoding: global page ``p`` lives on shard
    ``p // pages_per_shard`` at local index ``p % pages_per_shard``, so
    the page table stays a plain (B, P) int32 array and a shard recovers
    its local index by subtracting its base.  Local page 0 of EVERY
    shard is reserved: shard 0's is the global PARK page (id 0), and the
    others give each bank slice a park target of its own, so a write a
    shard does not own lands in its own slice.  Hence ``allocatable ==
    total_pages - num_shards``.

    Routing (deterministic, so a fixed traffic pattern replays exactly):
    a request that can ever fit on one shard (``n <=
    per_shard_allocatable``) goes whole to the least-loaded shard (most
    free pages, ties to the lowest index); a bigger one spans, drawing
    its pages one at a time from whichever shard is most free at that
    moment.  ``release`` and ``restore`` return a page to its OWNING
    shard's free-list with the base class's FIFO / front-restore
    contract, so the per-shard allocation order is deterministic too.
    Per-shard gauges ``shard.{s}.free_pages`` and counters
    ``shard.{s}.admitted_pages`` go to the telemetry registry."""

    def __init__(self, total_pages: int, num_shards: int,
                 telemetry: Telemetry | None = None):
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        if total_pages % num_shards:
            raise ValueError(f"total_pages {total_pages} must divide by "
                             f"num_shards {num_shards}")
        per = total_pages // num_shards
        if per < 2:
            raise ValueError(f"each shard needs its reserved local page 0 "
                             f"plus >= 1 allocatable page; {total_pages} "
                             f"pages over {num_shards} shards gives {per}")
        self.num_shards = num_shards
        self.pages_per_shard = per
        super().__init__(total_pages, telemetry=telemetry)

    # ``_free`` is never set: every base-class method that touched it is
    # overridden, and an attribute error beats mutating a stale view.

    def _note_free(self):
        if self._tm is None:
            return
        reg, pre = self._tm.registry, self._tm.prefix
        reg.gauge(pre + "free_pages", self.free_pages())
        for s, dq in enumerate(self._shards):
            reg.gauge(f"{pre}shard.{s}.free_pages", len(dq))

    def _note_admitted(self, shard: int, n: int):
        if self._tm is not None and n:
            self._tm.registry.inc(
                f"{self._tm.prefix}shard.{shard}.admitted_pages", n)

    @property
    def allocatable(self) -> int:
        return self.total_pages - self.num_shards

    @property
    def per_shard_allocatable(self) -> int:
        return self.pages_per_shard - 1

    def free_pages(self) -> int:
        return sum(len(dq) for dq in self._shards)

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def least_loaded(self) -> int:
        """The shard with the most free pages; ties go to the lowest
        index."""
        return max(range(self.num_shards),
                   key=lambda s: (len(self._shards[s]), -s))

    def route(self, n: int) -> Optional[int]:
        if n > self.per_shard_allocatable:
            return None                     # can never fit on one shard
        return self.least_loaded()

    def blocked(self, n: int) -> Optional[str]:
        shard = self.route(n)               # None: the pages span shards
        if shard is None:
            return None if n <= self.free_pages() else "pages"
        if n <= len(self._shards[shard]):
            return None
        return "shard_pages" if n <= self.free_pages() else "pages"

    def blocked_rows(self, b: int, n: int) -> Optional[str]:
        """Simulate admitting ``b`` rows of ``n`` pages each through the
        routing policy (each row routed on its own, as ``b`` sequential
        ``take(n)`` calls would be) without touching the free-lists."""
        counts = [len(dq) for dq in self._shards]
        span = n > self.per_shard_allocatable
        for _ in range(b):
            if span:
                if n > sum(counts):
                    return "pages"
                for _ in range(n):      # spanning pops most-free first
                    s = max(range(self.num_shards),
                            key=lambda i: (counts[i], -i))
                    counts[s] -= 1
            else:
                s = max(range(self.num_shards),
                        key=lambda i: (counts[i], -i))
                if n > counts[s]:
                    return "shard_pages" if n <= sum(counts) else "pages"
                counts[s] -= n
        return None

    def take(self, n: int) -> list[int]:
        shard = self.route(n)
        if shard is None:
            return self._take_spanning(n)
        dq = self._shards[shard]
        if n > len(dq):
            raise RuntimeError(f"take({n}) with {len(dq)} free pages on "
                               f"routed shard {shard}")
        pages = [dq.popleft() for _ in range(n)]
        self._held.update(pages)
        self._note_admitted(shard, n)
        self._note_free()
        return pages

    def _take_spanning(self, n: int) -> list[int]:
        if n > self.free_pages():
            raise RuntimeError(f"take({n}) with {self.free_pages()} free "
                               "pages")
        pages, counts = [], [0] * self.num_shards
        for _ in range(n):
            s = self.least_loaded()
            pages.append(self._shards[s].popleft())
            counts[s] += 1
        self._held.update(pages)
        for s, c in enumerate(counts):
            self._note_admitted(s, c)
        self._note_free()
        return pages

    def restore(self, pages: list[int]):
        freed = self._drop(pages)
        for s in range(self.num_shards):
            own = [p for p in freed if self.shard_of(p) == s]
            if own:
                self._shards[s].extendleft(reversed(own))
        self._note_free()

    def release(self, pages: list[int]):
        for p in self._drop(pages):
            self._shards[self.shard_of(p)].append(p)
        self._note_free()

    def reset(self):
        per = self.pages_per_shard
        self._shards: list[deque[int]] = [
            deque(range(s * per + 1, (s + 1) * per))
            for s in range(self.num_shards)]
        self._held = set()
        self._note_free()


class SlotPool:
    """Mixin: host-side slot pool for a fixed-shape device batch.

    Subclasses call ``_pool_init`` once and ``_pool_reset`` from their
    ``reset``; they own the device state and the jitted programs.
    """

    eos_id: Optional[int] = None

    def _pool_init(self, batch_size: int, telemetry: Telemetry | None = None):
        self.batch_size = batch_size
        self.slots: list[Optional[Generation]] = [None] * batch_size
        self._free: deque[int] = deque(range(batch_size))
        self._live = np.zeros(batch_size, dtype=bool)
        self._rid = 0
        # Shared measurement layer: ``self.stats`` is a dict-shaped view
        # over the server-wide MetricRegistry (standalone engines get a
        # private one), keeping every existing ``stats["key"]`` call-site
        # while snapshots/benches read one store.  A server hands each
        # engine a scoped ``eng.<i>.`` namespace.
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._trace = self.telemetry.tracer
        # Engine-lifetime tick counters (NOT cleared by ``reset``;
        # benches take deltas): ``host_ticks`` counts decode round-trips
        # to the device, ``device_steps`` the decode steps those trips
        # retired — their ratio is the multi-step amortization.
        # Engines with richer accounting (SpecEngine) extend this.
        self.stats = self.telemetry.view()
        self.stats.update({"host_ticks": 0, "device_steps": 0,
                           "admitted_rows": 0, "retired_rows": 0,
                           "tokens_out": 0})
        # inter-commit gap tracking for the decode-stall histogram
        # (engine-lifetime, like the tick counters above)
        self._last_commit_at: Optional[float] = None

    def _pool_reset(self):
        self.slots = [None] * self.batch_size
        self._free = deque(range(self.batch_size))
        self._live[:] = False

    # -------------------------------------------------------------- queries
    def free_slots(self) -> int:
        return len(self._free)

    def live_slots(self) -> int:
        """Occupied slots: live decode rows plus rows still mid-prefill
        (both hold a slot and both are pending work)."""
        return self.batch_size - len(self._free)

    def pending_slots(self) -> int:
        """Slots reserved but still mid-prefill (chunked admission)."""
        return 0

    def live(self) -> list[Generation]:
        return [g for g in self.slots if g is not None]

    # Why the last ``can_admit`` said no: ``None`` (it said yes),
    # ``"slots"``, ``"pages"``, or ``"shard_pages"`` (sharded pools:
    # room exists, just not on the shard the request routes to).
    # Schedulers read this to attribute blocked admissions.
    last_admit_block: Optional[str] = None

    def can_admit(self, tokens, max_new: int) -> bool:
        """Whether ``admit(tokens, max_new)`` would fit *right now*.
        Schedulers gate on this instead of ``free_slots`` so engines
        with extra admission resources (the paged engine's page pool)
        can veto without raising."""
        b = 1 if np.ndim(tokens) == 1 else np.shape(tokens)[0]
        ok = b <= self.free_slots()
        self.last_admit_block = None if ok else "slots"
        return ok

    # ------------------------------------------------------------ admission
    def _admit_args(self, tokens, metas, seeds):
        """Validate + normalize admission arguments.

        Returns ``(tokens (b, S) int32, rseeds (b,) int64, seeded (b,)
        bool)``.  ``seeds`` entries may be ``None`` (pool schedule) or an
        int seed (the row draws from its own generator state).
        """
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        b, S = tokens.shape
        if metas is not None and len(metas) != b:
            raise ValueError(f"metas has {len(metas)} entries for {b} "
                             "prompt rows")
        if seeds is not None and len(seeds) != b:
            raise ValueError(f"seeds has {len(seeds)} entries for {b} "
                             "prompt rows")
        rseeds = np.zeros((b,), np.int64)
        seeded = np.zeros((b,), bool)
        for i, s in enumerate(seeds or []):
            if s is None:
                continue
            rseeds[i] = int(s)
            seeded[i] = True
        return tokens.astype(np.int32), rseeds, seeded

    def _take_slots(self, b: int) -> list[int]:
        if b > len(self._free):
            raise RuntimeError(f"admit({b}) with {len(self._free)} free "
                               "slots")
        return [self._free.popleft() for _ in range(b)]

    def _restore_slots(self, slots: list[int]):
        """Failed admission: the slots go back to the FRONT in their
        original order, so a retry draws exactly what the failed call
        drew (FIFO order is load-bearing — see the class docstring)."""
        self._free.extendleft(reversed(slots))

    def _register(self, slots: list[int], prompt_len: int, max_new: int,
                  metas, first=None, submitted_at=None) -> list[Generation]:
        """Create one ``Generation`` per slot.  With ``first`` (the
        sampled first tokens) the rows go live; without it they are
        reserved-but-pending (chunked admission fills them later).
        ``submitted_at`` (scheduler enqueue time, engine clock) feeds the
        queue-wait and TTFT histograms."""
        now = self.telemetry.clock()
        gens = []
        for i, s in enumerate(slots):
            g = Generation(rid=self._rid, prompt_len=prompt_len,
                           max_new=max_new, slot=s,
                           meta=metas[i] if metas else None,
                           submitted_at=submitted_at, admitted_at=now)
            self._rid += 1
            self.stats["admitted_rows"] += 1
            if submitted_at is not None:
                self.telemetry.observe("queue_wait_s", now - submitted_at)
            if first is not None:
                g.tokens.append(int(first[i]))
                self._live[s] = True
                self.stats["tokens_out"] += 1
                self._note_first_token(g, now)
            self.slots[s] = g
            gens.append(g)
        return gens

    def _note_first_token(self, g: Generation, now: Optional[float] = None):
        """Stamp a row's first emitted token; observes TTFT (relative to
        scheduler submit when known, else to admission)."""
        if g.first_token_at is not None:
            return
        if now is None:
            now = self.telemetry.clock()
        g.first_token_at = now
        ref = g.submitted_at if g.submitted_at is not None else g.admitted_at
        self.telemetry.observe("ttft_s", now - ref)
        if self._trace.enabled:
            self._trace.instant(
                f"first-token:{g.rid}",
                f"{self.telemetry.prefix}pool{g.slot}", ts=now)

    def _note_tick(self, t0: float, now: float, nsteps: int, nrows: int):
        """Per-tick telemetry: the per-token latency sample (tick
        duration amortized over the decode steps it committed), the
        host-side inter-commit stall (gap between the previous tick's
        commit and this tick's start — scheduler/bookkeeping overhead),
        and the tick span."""
        if nrows and nsteps:
            self.telemetry.observe("token_latency_s", (now - t0) / nsteps)
        last = self._last_commit_at
        if last is not None and t0 > last:
            self.telemetry.observe("decode_stall_s", t0 - last)
        self._last_commit_at = now
        if self._trace.enabled:
            self._trace.span("tick", f"{self.telemetry.prefix}eng",
                             t0, now, args={"steps": nsteps, "rows": nrows})

    # ----------------------------------------------------------- retirement
    def _retire_done(self, gens: list[Generation]) -> list[Generation]:
        finished = []
        now = None
        for g in gens:
            eos = (self.eos_id is not None and g.tokens
                   and g.tokens[-1] == self.eos_id)
            if len(g.tokens) >= g.max_new or eos:
                g.done = True
                self.slots[g.slot] = None
                self._live[g.slot] = False
                self._free.append(g.slot)
                finished.append(g)
                if now is None:
                    now = self.telemetry.clock()
                self.stats["retired_rows"] += 1
                self.telemetry.observe("gen_latency_s", now - g.admitted_at)
                if self._trace.enabled:
                    # one span per request on its slot's track:
                    # admitted -> retired (Perfetto: slot occupancy).
                    self._trace.span(
                        f"req:{g.rid}",
                        f"{self.telemetry.prefix}pool{g.slot}",
                        g.admitted_at, now,
                        args={"tokens": len(g.tokens),
                              "prompt_len": g.prompt_len, "eos": bool(eos)})
        return finished

    def _salt_admit_key(self):
        """Advance the engine's admission draws after an instant retire: a
        slot freed with no step in between (steps==1 / EOS at admission)
        must not hand a same-boundary re-admission the draw field the
        retiree already used."""
        self.sampler.salt()

    # ----------------------------------------------------------------- loop
    def drain(self, params=None) -> list[Generation]:
        """Step until the pool is empty; returns everything finished."""
        out = []
        while self.live_slots():
            out.extend(self.step(params))
        return out
