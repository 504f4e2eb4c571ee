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

``PagePool`` refcounts its pages, so one page can be mapped into
several tables (prefix sharing); ``ShardedPagePool`` splits the page
bank into equal per-shard slices with one free-list each.
``PrefixIndex`` maps whole-page token runs of written prompts to the
pages holding them, and ``SharedBank`` puts one pool, one index and one
set of device caches behind every engine serving the same cache
content.  Page choices are the JAX package's, call for call.
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
    """Host-side *refcounted* page allocator over one shared device KV
    page bank.

    The device side is one ``layers.PagedKV`` pool of ``total_pages``
    pages per layer; this class hands out page *ids*.  Page 0 is the
    PARK page: it is never allocated, dead page-table entries point at it
    (every table entry must be a valid pool index), and non-live rows'
    per-step writes are routed into it — so ``allocatable ==
    total_pages - 1``.

    Every allocated page carries a reference count.  ``take`` hands out
    fresh pages at refcount 1; ``acquire`` adds a reference (prefix
    sharing: the same physical page mapped into another table, or held
    by the prefix index); ``release``/``restore`` *decrement*, and a page
    re-enters the free-list only when its count reaches 0.  With every
    page at refcount 1 the pool behaves as a plain allocator.

    Recycling contract (mirrors ``SlotPool``'s slot free-list, and is
    load-bearing for test reproducibility the same way):

      * **FIFO** — ``take`` pops from the *front*, ``release``
        (retirement) appends pages reaching refcount 0 to the *back*: a
        page is reused as late as possible, and the allocation order of
        a fixed traffic pattern is deterministic.
      * **failed-admit restore** — ``restore`` puts pages reaching
        refcount 0 back at the *front in their original order*, so a
        retried admission draws exactly the pages the failed call drew.
    """

    PARK = 0

    def __init__(self, total_pages: int, telemetry: Telemetry | None = None):
        if total_pages < 2:
            raise ValueError(f"need >= 2 pages (1 park + 1 allocatable), "
                             f"got {total_pages}")
        self.total_pages = total_pages
        self._tm = telemetry             # optional: free_pages gauge
        self.reset()

    def _note_free(self):
        if self._tm is not None:
            self._tm.registry.gauge(
                self._tm.prefix + "free_pages", len(self._free))

    @property
    def allocatable(self) -> int:
        return self.total_pages - 1

    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        """References held on an allocated page (0 == on the free-list)."""
        return self._held.get(page, 0)

    # A one-shard pool answers the sharded-routing queries trivially, so
    # the engine's admission path is the same over both pool kinds.
    num_shards = 1

    def shard_of(self, page: int) -> int:
        return 0

    def shard_free(self, shard: int) -> int:
        return len(self._free)

    def route(self, n: int) -> Optional[int]:
        """Shard a fresh ``n``-page allocation would be routed to
        (``None``: the pages span shards).  One shard: always 0."""
        return 0

    def blocked(self, n: int, shard: Optional[int] = None) -> Optional[str]:
        """Why ``take(n, shard)`` would fail right now: ``None`` (it
        would not), ``"pages"`` (the pool is short) or ``"shard_pages"``
        (room exists, but not on the shard this request routes to --
        sharded pools only)."""
        return None if n <= len(self._free) else "pages"

    def blocked_rows(self, b: int, n: int) -> Optional[str]:
        """``blocked`` for ``b`` independent rows of ``n`` pages each,
        admitted in sequence under the routing policy."""
        return None if b * n <= len(self._free) else "pages"

    def take(self, n: int, shard: Optional[int] = None) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"take({n}) with {len(self._free)} free "
                               "pages")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._held[p] = 1
        self._note_free()
        return pages

    def adopt(self, page: int) -> bool:
        """Re-allocate one specific FREE page at refcount 1 -- the prefix
        index's restore path: the bank still holds the page's bytes, so a
        surviving index entry re-pins exactly that page.  False (and no
        change) if the page was handed out or is out of range."""
        try:
            self._free.remove(page)
        except ValueError:
            return False
        self._held[page] = 1
        self._note_free()
        return True

    def note_reclaimed(self, pages: list[int]):
        """Telemetry hook: pages the engine just reclaimed from the prefix
        cache.  A sharded pool counts them per owning shard; one shard has
        nothing more to record."""

    def acquire(self, pages: list[int]):
        """Add one reference to each (already allocated) page: prefix
        sharing maps the same physical page into another table, or the
        prefix index pins it past its owner's retirement."""
        for p in pages:
            if self._held.get(p, 0) < 1:
                raise ValueError(f"acquire({p}): page is not allocated")
            self._held[p] += 1

    def _decref(self, pages: list[int]) -> list[int]:
        """Drop one reference per page -> the pages that reached 0, in the
        order given (they leave ``_held`` and must rejoin a free-list)."""
        freed = []
        for p in pages:
            n = self._held.get(p, 0)
            if n < 1:
                raise ValueError(f"refcount underflow on page {p}")
            if n == 1:
                del self._held[p]
                freed.append(p)
            else:
                self._held[p] = n - 1
        return freed

    def restore(self, pages: list[int]):
        """Failed admission: drop one reference; pages reaching refcount 0
        go back to the FRONT in their original order."""
        self._free.extendleft(reversed(self._decref(pages)))
        self._note_free()

    def release(self, pages: list[int]):
        """Retirement: drop one reference; pages reaching refcount 0 go to
        the BACK (FIFO recycling)."""
        self._free.extend(self._decref(pages))
        self._note_free()

    def reset(self):
        self._free: deque[int] = deque(range(1, self.total_pages))
        self._held: dict[int, int] = {}  # page id -> refcount (allocated)
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
    per_shard_allocatable``) goes whole to one shard -- the engine routes
    a prefix hit to the shard already holding its cached pages, a cold
    admission to the least-loaded shard (most free pages, ties to the
    lowest index); a bigger one spans, drawing its pages one at a time
    from whichever shard is most free at that moment.  Refcounts are
    global (a page's id never changes); ``release`` and ``restore``
    return a page reaching refcount 0 to its OWNING shard's free-list
    with the base class's FIFO / front-restore contract, so the
    per-shard allocation order is deterministic too.  Per-shard gauges
    ``shard.{s}.free_pages`` and counters ``shard.{s}.admitted_pages``
    and ``shard.{s}.reclaimed_pages`` go to the telemetry registry."""

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

    def shard_free(self, shard: int) -> int:
        return len(self._shards[shard])

    def least_loaded(self) -> int:
        """The shard with the most free pages; ties go to the lowest
        index."""
        return max(range(self.num_shards),
                   key=lambda s: (len(self._shards[s]), -s))

    def route(self, n: int) -> Optional[int]:
        if n > self.per_shard_allocatable:
            return None                     # can never fit on one shard
        return self.least_loaded()

    def blocked(self, n: int, shard: Optional[int] = None) -> Optional[str]:
        if shard is None or n > self.per_shard_allocatable:
            shard = self.route(n)           # None: the pages span shards
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

    def take(self, n: int, shard: Optional[int] = None) -> list[int]:
        """``n`` fresh pages on ``shard`` (a prefix hit's anchor shard),
        or where the routing policy puts them when ``shard`` is None or
        ``n`` outgrows one shard."""
        if shard is None or n > self.per_shard_allocatable:
            shard = self.route(n)
        if shard is None:
            return self._take_spanning(n)
        dq = self._shards[shard]
        if n > len(dq):
            raise RuntimeError(f"take({n}) with {len(dq)} free pages on "
                               f"routed shard {shard}")
        pages = [dq.popleft() for _ in range(n)]
        for p in pages:
            self._held[p] = 1
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
            p = self._shards[s].popleft()
            self._held[p] = 1
            counts[s] += 1
            pages.append(p)
        for s, c in enumerate(counts):
            self._note_admitted(s, c)
        self._note_free()
        return pages

    def restore(self, pages: list[int]):
        freed = self._decref(pages)
        for s in range(self.num_shards):
            own = [p for p in freed if self.shard_of(p) == s]
            if own:
                self._shards[s].extendleft(reversed(own))
        self._note_free()

    def release(self, pages: list[int]):
        for p in self._decref(pages):
            self._shards[self.shard_of(p)].append(p)
        self._note_free()

    def adopt(self, page: int) -> bool:
        try:
            self._shards[self.shard_of(page)].remove(page)
        except (ValueError, IndexError):
            return False
        self._held[page] = 1
        self._note_free()
        return True

    def note_reclaimed(self, pages: list[int]):
        if self._tm is None or not pages:
            return
        counts: dict[int, int] = {}
        for p in pages:
            s = self.shard_of(p)
            counts[s] = counts.get(s, 0) + 1
        for s, c in counts.items():
            self._tm.registry.inc(
                f"{self._tm.prefix}shard.{s}.reclaimed_pages", c)

    def reset(self):
        per = self.pages_per_shard
        self._shards: list[deque[int]] = [
            deque(range(s * per + 1, (s + 1) * per))
            for s in range(self.num_shards)]
        self._held = {}
        self._note_free()


@dataclass
class _PrefixNode:
    """One cached prompt page: the edge from its parent is the page's
    full token run, ``page`` is the pool page holding those tokens' k/v."""
    page: int
    run: tuple
    parent: Optional["_PrefixNode"]
    children: dict = field(default_factory=dict)   # run tuple -> node
    last_used: int = 0


class PrefixIndex:
    """Radix (longest-common-prefix) index over *fully written* prompt
    pages.

    Granularity is whole pages: an edge is one page's complete
    ``page_size``-token run, so a lookup matches the longest indexed
    prefix in units of pages.  A page enters only once its owner has
    written it completely (the last, partly filled prompt page never
    does; decode tokens land past the prompt, so an indexed page is
    immutable for the rest of its life).  ``namespace`` keys the bank's
    value format into every path: an int8 bank's codes are a lossy
    function of the same tokens, so ``"fp16"`` and ``"int8"`` entries
    never cross-match, even in one index.

    The index holds no refcounts itself: the engine pairs ``insert`` with
    ``PagePool.acquire`` (the index's reference) and ``evict_lru`` with
    ``PagePool.release``.  Eviction is leaf-first (an inner node's
    children are reachable only through it) and least recently used
    among the leaves."""

    def __init__(self, page_size: int, namespace: str = "fp16"):
        self.page_size = page_size
        self.namespace = namespace
        self._root: dict = {}            # (namespace, run) -> _PrefixNode
        self._clock = 0                  # monotonic recency counter

    def __len__(self) -> int:
        return len(self.pages())

    def _runs(self, tokens) -> list[tuple]:
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        return [tuple(int(x) for x in toks[j * ps:(j + 1) * ps])
                for j in range(len(toks) // ps)]

    def _key(self, node: Optional[_PrefixNode], run: tuple):
        return (self.namespace, run) if node is None else run

    def _children(self, node: Optional[_PrefixNode]) -> dict:
        return self._root if node is None else node.children

    def lookup(self, tokens, peek: bool = False) -> list[int]:
        """Longest indexed prefix of ``tokens`` in WHOLE pages -> the page
        ids holding it (possibly []).  Bumps recency on the path; ``peek``
        leaves it untouched -- a capacity probe (``can_admit``) must not
        keep never-admitted prefixes hot, nor bump twice the path its
        ``admit`` bumps."""
        if not peek:
            self._clock += 1
        node, out = None, []
        for run in self._runs(tokens):
            nxt = self._children(node).get(self._key(node, run))
            if nxt is None:
                break
            if not peek:
                nxt.last_used = self._clock
            out.append(nxt.page)
            node = nxt
        return out

    def insert(self, tokens, pages: list[int]) -> list[int]:
        """Index one admitted row's fully written prompt pages:
        ``pages[j]`` holds tokens ``[j*page_size, (j+1)*page_size)``.
        Runs already indexed keep their page (first writer wins) -> the
        page ids NEWLY inserted, for which the caller must
        ``PagePool.acquire`` the index's reference."""
        self._clock += 1
        node, fresh = None, []
        for j, run in enumerate(self._runs(tokens)):
            if j >= len(pages):
                break
            key = self._key(node, run)
            kids = self._children(node)
            nxt = kids.get(key)
            if nxt is None:
                nxt = _PrefixNode(page=int(pages[j]), run=run, parent=node,
                                  last_used=self._clock)
                kids[key] = nxt
                fresh.append(nxt.page)
            else:
                nxt.last_used = self._clock
            node = nxt
        return fresh

    def _nodes(self) -> list[_PrefixNode]:
        out, stack = [], list(self._root.values())
        while stack:
            nd = stack.pop()
            out.append(nd)
            stack.extend(nd.children.values())
        return out

    def pages(self) -> set[int]:
        """Every page id the index pins."""
        return {nd.page for nd in self._nodes()}

    def evict_lru(self, n: int, can_evict) -> list[int]:
        """Drop up to ``n`` cached pages, least recently used *leaves*
        first (an inner node cannot go before its children, or the
        subtree leaks).  Only pages ``can_evict`` approves leave -- the
        engine passes refcount == 1, i.e. no live table maps the page.
        -> the evicted page ids; the caller drops the index's pool
        reference for each."""
        out = []
        while len(out) < n:
            leaves = [nd for nd in self._nodes()
                      if not nd.children and can_evict(nd.page)]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: (nd.last_used, nd.page))
            kids = self._children(victim.parent)
            del kids[self._key(victim.parent, victim.run)]
            out.append(victim.page)
        return out

    def clear(self):
        self._root = {}

    def snapshot(self) -> dict:
        """The trie's host state as plain lists and ints (JSON-safe).  The
        pages' bytes live in the device bank and are NOT captured: a
        snapshot is worth restoring only while the bank survives (an
        engine reset keeps its cache tensors; ``restore`` re-pins the
        pages from the pool's free-list)."""
        nodes = []

        def walk(node, path):
            for nd in self._children(node).values():
                rec_path = path + [list(nd.run)]
                nodes.append({"path": rec_path, "page": int(nd.page),
                              "last_used": int(nd.last_used)})
                walk(nd, rec_path)

        walk(None, [])
        return {"namespace": self.namespace, "page_size": self.page_size,
                "clock": int(self._clock), "nodes": nodes}

    def restore(self, snap: dict, adopt) -> list[int]:
        """Rebuild trie branches from an earlier ``snapshot``.

        ``adopt(page) -> bool`` must re-pin the page in the pool (the
        index's reference): ``PagePool.adopt``.  A node whose page cannot
        be adopted (recycled since the snapshot) is dropped *with its
        whole subtree*: its children's runs are reachable only through
        the lost page.  Existing entries win over the snapshot's (first
        writer wins, as in ``insert``).  -> the pages adopted; the index
        now pins them."""
        if (snap["namespace"] != self.namespace
                or snap["page_size"] != self.page_size):
            raise ValueError(
                f"snapshot is {snap['namespace']}/page {snap['page_size']}, "
                f"index is {self.namespace}/page {self.page_size}")
        self._clock = max(self._clock, int(snap["clock"]))
        adopted = []
        # snapshot() emits parents before children, so one forward pass
        # sees every node's parent already rebuilt (or already dropped)
        for rec in snap["nodes"]:
            path = [tuple(r) for r in rec["path"]]
            node, lost = None, False
            for run in path[:-1]:
                node = self._children(node).get(self._key(node, run))
                if node is None:
                    lost = True             # the parent branch was dropped
                    break
            if lost:
                continue
            run = path[-1]
            kids = self._children(node)
            key = self._key(node, run)
            if key in kids:
                continue
            if not adopt(rec["page"]):
                continue
            kids[key] = _PrefixNode(page=int(rec["page"]), run=run,
                                    parent=node,
                                    last_used=int(rec["last_used"]))
            adopted.append(int(rec["page"]))
        return adopted


@dataclass
class SharedBank:
    """One shared paged-KV bank: the allocator, the prefix index and the
    device caches, shared by every engine serving the same cache content.

    Keyed by *content* -- (context name, page size, kv format) -- not by
    pool shape: engines of different batch sizes over the same weights
    read and write the same pages, so a prompt one of them indexed is a
    prefix hit for all of them.  ``caches`` starts ``None``; the first
    engine to reset allocates it.  The device programs write the caches
    in place, so ``caches`` is the one tensor tree every engine over the
    bank holds, at fixed addresses (a CUDA graph captured by one engine
    reads them where they are): no engine ever replaces it."""
    pool: PagePool
    index: Optional[PrefixIndex] = None
    caches: Any = None


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
