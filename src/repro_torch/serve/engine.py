"""Serving execution layer: continuous-batching step engine + batch loops.

The core abstraction is ``StepEngine`` — a persistent, fixed-shape decode
batch advanced one token at a time:

  * ``DecodeState``  — slot-pooled KV cache (one cache row per slot, or
                       per-slot page tables over one shared page pool) +
                       per-slot token/position, with a free-list over slots
  * ``admit``        — prefill a prompt into a free slot's cache row
                       (``LM.insert_cache_rows``: only that row changes) or
                       into its own pages (``LM.insert_cache_pages``); with
                       ``prefill_chunk=C`` reserve the slot and stream the
                       prompt in (b, C) chunks, one per tick, behind decode
  * ``step``         — one decode step for every live slot; per-request
                       positions go down to the attention kernel as a
                       ``(B,)`` vector; with ``multi_step=T`` up to T
                       fused steps, one CUDA graph replay on a card
  * retirement       — EOS / step-limit frees the slot back to the pool

Requests join, leave, and (one level up, in ``serve/scheduler.py``) switch
model contexts at *step* boundaries — the paper's hide-the-load principle
at token granularity instead of batch granularity.

``ServingEngine`` keeps the classic run-to-completion API; ``generate`` is
a thin wrapper that admits the whole batch into a ``StepEngine`` and steps
it to completion.  Sampling is ``argmax(logits / T + gumbel)`` (greedy at
T == 0); the gumbel fields come from a ``GumbelDraws`` object, which tests
may replace to inject another framework's draws.
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.env import synchronize
from repro_torch.distributed.mesh import shard_count
from repro_torch.models.model import LM
from repro_torch.serve.pool import (Generation, PagePool, PrefixIndex,
                                    SharedBank, ShardedPagePool, SlotPool)
from repro_torch.serve.telemetry import Telemetry, safe_ratio

__all__ = ["DecodeState", "EngineKey", "Generation", "GumbelDraws",
           "PagePool", "PrefixIndex", "ServeStats", "ServingEngine",
           "SharedBank", "ShardedPagePool", "SlotPool", "StepEngine"]

_M64 = (1 << 64) - 1


def _mix(*xs: int) -> int:
    """Deterministic 63-bit seed from a sequence of ints (splitmix64
    finalizer chained over the inputs): the port's stand-in for JAX's
    ``fold_in`` key derivation."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (int(x) & _M64)) & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class GumbelDraws:
    """The step engine's random draws, as explicit torch generator state.

    The schedule is the JAX engine's, with ``_mix`` for ``fold_in``:

      * ``reset(seed)`` — key := seed, t := 0
      * ``advance()``   — every decode step: key := mix(key, t), t += 1;
                          returns the step's key
      * ``admit_key()`` — an admission draws from the current key at
                          t == 0 and from mix(key, 2^30 ^ t) afterwards
                          (a slot retired by step t-1 and recycled here
                          must not hand the newcomer the old occupant's
                          last gumbel row)
      * ``salt()``      — after an instant retire: key := mix(key, 2^30 | t)
      * ``field(key, shape)``          — the gumbel field of one key
      * ``uniform(key, shape)``        — the uniform [0, 1) field of one
                          key (speculative acceptance)
      * ``fold(key, x)``               — the key mix(key, x) (``fold_in``)
      * ``rows(seeds, produced_at, V)`` — seeded rows: row i draws from
                          mix(seeds[i], produced_at[i]), independent of
                          slot, admission boundary and pool traffic

    A field is drawn with a ``torch.Generator`` on the engine's device
    seeded from the key.  Tests subclass this to feed the JAX engine's
    own gumbel and uniform fields (torch and JAX generators differ)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.reset(0)

    def reset(self, seed: int):
        self.key = _mix(seed)
        self.t = 0

    def advance(self):
        self.key = _mix(self.key, self.t)
        self.t += 1
        return self.key

    def admit_key(self):
        return self.key if self.t == 0 else _mix(self.key, (1 << 30) ^ self.t)

    def salt(self):
        self.key = _mix(self.key, (1 << 30) | self.t)

    def snapshot(self):
        return self.key, self.t

    def restore(self, snap):
        self.key, self.t = snap

    def field(self, key, shape) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(int(key))
        u = torch.rand(shape, generator=gen, device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def uniform(self, key, shape) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(int(key))
        return torch.rand(shape, generator=gen, device=self.device)

    def fold(self, key, x: int):
        return _mix(key, x)

    def rows(self, seeds, produced_at, V: int) -> torch.Tensor:
        return torch.stack([self.field(_mix(_mix(s), p), (V,))
                            for s, p in zip(seeds, produced_at)])


def _sample(logits, temperature: float, gumbel=None) -> torch.Tensor:
    """The sampling rule: greedy argmax at ``temperature <= 0``, else
    ``argmax(logits / temperature + gumbel)`` with ``gumbel`` a field of
    logits' shape (the Gumbel-max form of a categorical draw)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.argmax(logits / temperature + gumbel,
                        dim=-1).to(torch.int32)


class EngineKey(NamedTuple):
    """Frozen cache key for ONE step-engine configuration: every knob that
    changes a device program or the cache layout is a named field.
    ``page_size is None`` means the row cache layout (``paged=False``)."""
    name: Optional[str] = None          # model context (None: single-model)
    batch_size: int = 1
    prefill_chunk: Optional[int] = None
    page_size: Optional[int] = None     # None == row layout (paged off)
    quantize_kv: Optional[str] = None
    prefix_cache: bool = False
    shared_bank: bool = False           # pages/prefixes from a SharedBank
    shards: int = 1                     # page-bank shards (1 == unsharded)
    multi_step: int = 1                 # fused decode steps per tick


class ServeStats:
    """Run-to-completion loop accounting, stored in the shared
    ``MetricRegistry`` (``serve.*`` under a server) so one snapshot sees
    the batch loops next to the step engines and the context engine."""

    __slots__ = ("_v",)
    _FLOATS = ("prefill_s", "decode_s")

    def __init__(self, view=None):
        if view is None:
            view = Telemetry().view()
        object.__setattr__(self, "_v", view)
        for k in self._FLOATS:
            view.setdefault(k, 0.0)
        view.setdefault("tokens", 0)

    def __getattr__(self, k):
        try:
            return self._v[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self._v[k] = v

    @property
    def tok_per_s(self) -> float:
        return safe_ratio(self._v["tokens"], self._v["decode_s"])


# ---------------------------------------------------------------------------
# continuous-batching step engine
# ---------------------------------------------------------------------------

@dataclass
class DecodeState:
    """The batch state.  ``caches`` live on the device and are written in
    place; the per-slot columns are host arrays (uploaded per step, a few
    bytes per row) so the host never waits on the device to read them.

    ``rseed``/``seeded`` are the per-request seed column: a seeded slot
    draws from its own generator state (``GumbelDraws.rows``) folded with
    the position of the token being produced instead of the pool
    schedule, so a seeded resubmission reproduces its tokens exactly
    regardless of which slot it lands in or what else shares the pool."""
    caches: Any            # per layer: KVCache (B, ...) or PagedKV (NP, ...)
    tok: np.ndarray        # (B,) int32 — last sampled token per slot
    pos: np.ndarray        # (B,) int32 — cache position `tok` is fed at
    rseed: np.ndarray      # (B,) int64 — per-slot request seed
    seeded: np.ndarray     # (B,) bool — slot draws from rseed, not the pool
    table: np.ndarray      # (B, P) int32 — per-slot page table (paged)
    table_dev: Optional[torch.Tensor] = None   # device copy of ``table``


@dataclass
class _PendingPrefill:
    """One admitted-but-still-prefilling request (chunked admission): its
    slots are reserved, its prompt streams into their cache rows (or
    pages) one chunk per engine tick."""
    tokens: np.ndarray                    # (b, S) full prompt, int32
    gens: list                            # Generation handles (slots set)
    rseeds: np.ndarray                    # (b,) int64 per-row seeds
    seeded: np.ndarray                    # (b,) bool
    done: int = 0                         # prompt tokens already chunked
    #                                       (starts at the first divergent
    #                                       token on a prefix hit)
    tables: Optional[np.ndarray] = None   # (b, P) page tables (paged mode)
    cow: Optional[tuple] = None           # (src, dst) page pair to copy
    #                                       before the first chunk write;
    #                                       src holds a pool reference
    #                                       (dropped when the copy runs)
    hit: bool = False                     # admitted through a prefix hit
    mapped: int = 0                       # shared pages mapped read-only
    had_cow: bool = False                 # plan included a boundary copy
    started: bool = False                 # first chunk has executed
    #                                       (admit-to-first-chunk latency)


def _tensors(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _mapped(plan) -> list:
    """The pages a prefix plan maps or copies from: never evicted to make
    room for the plan's own fresh pages."""
    retained, cow_src, _, _ = plan
    return retained + ([cow_src] if cow_src is not None else [])


class _TickGraph:
    """One CUDA graph of the fused tick (``StepEngine._fused_tick``),
    captured over static device buffers -- ``inp``, the tick's packed
    host columns (staged through pinned ``inp_host``), and ``gumbel``,
    the steps' fields -- for one set of weight, cache and table buffers.
    It holds those by weak reference only: a graph keeps the addresses
    it was captured on, so once any of them is gone (a weight slot
    evicted and reloaded) ``alive`` turns False and the engine drops the
    graph, never keeping the buffers alive itself.  ``launches`` is what
    the capture recorded of every kernel wrapper's count
    (``kernels.launches_since``): a replay calls no wrapper, so the
    engine adds it once per replay."""

    def __init__(self, bufs, n_inp: int, gumbel, device):
        self._refs = [weakref.ref(t) for t in bufs]
        self.inp_host = torch.empty((n_inp,), dtype=torch.int32,
                                    pin_memory=True)
        self.inp = torch.empty((n_inp,), dtype=torch.int32, device=device)
        self.gumbel = None if gumbel is None else torch.empty_like(gumbel)
        self.graph = torch.cuda.CUDAGraph()
        self.res = None
        self.launches = {}

    def alive(self) -> bool:
        return all(r() is not None for r in self._refs)

    def load(self, inp, gumbel) -> None:
        """Copy one tick's inputs into the static buffers."""
        self.inp_host.numpy()[:] = inp
        self.inp.copy_(self.inp_host, non_blocking=True)
        if gumbel is not None:
            self.gumbel.copy_(gumbel)


class StepEngine(SlotPool):
    """Continuous-batching decode engine for one model context.

    Fixed batch shape ``batch_size``; requests occupy slots.  The engine
    is deliberately un-timed and thread-free: callers (the classic
    ``generate`` wrapper, the token-granular ``ContinuousScheduler``)
    decide when to step, when to switch contexts, and what to measure.

    ``params`` is passed per call: under the context-switching server the
    weights live in a ``ContextSwitchEngine`` slot that may be evicted and
    reloaded between steps; the engine never captures them.

    ``paged=True`` swaps the row-granular cache for a *paged slot pool*:
    one shared bank of ``num_pages`` pages of ``page_size`` tokens, each
    admitted row owning only the ``ceil((S+max_new-1)/page)`` pages its
    own lifetime needs, and a per-slot page table mapping positions onto
    pool pages (down to the ``paged_attention`` kernel).  ``num_pages``
    defaults to ``batch_size * max_len/page_size + 1`` (the row layout's
    capacity); a smaller bank serves more concurrent short requests in
    the same memory (admission gates on ``can_admit``: free slots AND free
    pages).  Retirement returns pages; non-live rows' per-step writes go
    to the park page so a freed page can be recycled at once.  Sampling
    never sees the cache layout, so paged and row streams are identical.

    ``prefill_chunk=C`` switches admission to *chunked prefill*:
    ``admit`` reserves the slots and queues the prompt, and each tick runs
    at most ONE (b, C) chunk (``LM.prefill_chunk[_pages]``, the verify
    pass pointed at admission) before the decode step, so a live row
    waits for one chunk per step, never a whole prompt.  A short prompt
    may jump ahead of a long one's queued chunks, at most
    ``admit_jump_limit`` times in a row.  The final chunk samples the
    first token under the one-shot admission draw rules, so streams are
    token-identical across chunk sizes.

    ``quantize_kv="int8"`` (paged only) stores the page pool as int8
    codes with per-token-per-head f32 scales: about half the bytes per
    page.  Writes quantize; the paged kernels dequantize in registers.
    Outputs are close to, not bitwise equal to, the full-precision pool's.

    ``shards=N`` / ``mesh=...`` (paged only) split the page bank into N
    equal slices with one free-list each (``ShardedPagePool``): a page id
    encodes (shard, local page) as ``(id // pages_per_shard, id %
    pages_per_shard)``; admission puts a small request's pages on the
    least-loaded shard and spans a big one across shards.  ``shards``
    alone is *logical* sharding: only page ids change, and the paged
    read is indifferent to them, so streams are bitwise those of the
    unsharded engine.  ``mesh`` (a ``repro_torch.distributed.mesh.Mesh``
    of N shards) is the bank's mesh; its shards
    must all name the model's device, where the bank stays (placing the
    slices on several cards is not ported yet).  ``local_read=True``
    (needs ``mesh``) makes each shard read and write only its own slice
    in decode and chunked prefill (the B5 partial kernel for decode) and
    merges the shards' partial softmaxes with one pmax/psum; that
    changes the reduction order, so it is allclose, not bitwise.
    ``num_pages`` then defaults to ``N * (ceil(need / N) + 1)`` (need =
    the row layout's capacity in pages, plus each shard's reserved local
    page 0).

    ``multi_step=T`` commits up to T decode steps per tick
    (``LM.decode_multi_step[_pages]``), bitwise the tokens of T single
    steps: the tick stops committing at the step where any slot would
    change occupancy (EOS, token budget, page end), so retirements and
    the draw schedule stay exactly those of the single-step engine.  On
    a CUDA card a tick is one replay of a CUDA graph of the T steps
    (captured once per set of weight, cache and table buffers) and one
    readback; on the CPU the same body runs eagerly.  While a chunked
    prompt is pending the engine single-steps, so the prompt keeps its
    one chunk per tick.

    ``prefix_cache=True`` (paged only) shares already written prompt
    pages across admissions: every completed prompt's whole pages are
    indexed by their token runs (``PrefixIndex``), and a single-row
    admission whose prompt starts with an indexed run maps those page ids
    into its table -- refcounted, read-only -- and prefills only from the
    first divergent token, as one final chunk (``_chunk_fn``, the paged
    verify route), on one-shot engines too.  A full-prefix hit recomputes
    just the last prompt token; that write would land in a *shared*
    page, so the engine copies that one boundary page first
    (``LM.copy_cache_pages``): shared pages are never written.  Retired
    prompts' pages stay cached at refcount 1; when an admission is short
    of pages, ``can_admit`` evicts them LRU-first (leaves before their
    parents) until it fits.  Multi-row admissions stay cold but index
    their prompts.  int8 pools index under their own namespace.  Hit
    streams are bitwise a cold admission's where both compute the same
    numbers: chunked engines, and one-shot fp engines on the CPU.  A
    one-shot cold admission runs flash prefill over the prompt's own
    full-precision k/v, a hit's suffix the verify kernel over the pool,
    which round apart on the card and, on an int8 pool, by int8 rounding
    (as in the JAX engine).  Counters
    ``prefix_hits``, ``prefix_pages_mapped``, ``cow_copies`` and
    ``cache_evictions`` go to the engine's registry view.

    ``bank=SharedBank(...)`` (paged only) allocates from a bank that
    several engines share (``SwitchableServer.shared_bank``): its pool
    (and its sharding), its prefix index and its device caches.  The
    programs write the caches in place, so every engine over the bank
    holds the same tensors at the same addresses; nothing is handed
    back and forth between calls (the JAX engine's ``_bank_pull`` /
    ``_bank_push`` exist because its jitted calls donate buffers).
    """

    def __init__(self, model: LM, batch_size: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 paged: bool = False, page_size: int = 256,
                 num_pages: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 sampler: Optional[GumbelDraws] = None,
                 prefill_chunk: Optional[int] = None,
                 admit_jump_limit: int = 4, multi_step: int = 1,
                 quantize_kv: Optional[str] = None,
                 prefix_cache: bool = False,
                 bank: Optional[SharedBank] = None,
                 shards: Optional[int] = None, mesh=None,
                 local_read: bool = False):
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        self.multi_step = multi_step
        self._graphs: dict[tuple, _TickGraph] = {}
        self.graph_captures = 0          # CUDA graphs captured, and the
        self.graph_capture_s = 0.0       # seconds their captures took
        self.model = model
        self.device = model.device
        telemetry = telemetry if telemetry is not None else Telemetry()
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.sampler = sampler if sampler is not None else GumbelDraws(
            model.device)
        if quantize_kv not in (None, "int8"):
            raise ValueError(f"quantize_kv must be None or 'int8', got "
                             f"{quantize_kv!r}")
        if quantize_kv is not None and not paged:
            raise ValueError(
                "quantize_kv targets the shared page pool: it needs "
                "paged=True (the row cache stays full precision)")
        self.quantize_kv = quantize_kv
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            if any(mix != "attn" for mix, _ in model.pattern):
                raise ValueError(
                    "chunked prefill needs an all-attention model "
                    "(recurrent state cannot carry across chunk "
                    "boundaries)")
            if model.cfg.sliding_window:
                raise ValueError(
                    "chunked prefill needs a full (non-ring) cache: a "
                    "pending row's parked decode writes would wrap onto "
                    "window entries the chunks just filled")
        self.prefill_chunk = prefill_chunk
        self.admit_jump_limit = admit_jump_limit
        self._jumps = 0              # consecutive short-prompt jump-aheads
        self._pending: deque[_PendingPrefill] = deque()

        # sharded page bank: resolve the mesh/shard knobs up front (the
        # pool they configure is built in the paged branch below)
        if mesh is not None and shards not in (None, mesh.size):
            raise ValueError(f"shards={shards} disagrees with the mesh's "
                             f"{mesh.size} shards")
        shards_asked = shards is not None or mesh is not None
        shards = shard_count(shards, mesh)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if (mesh is not None or shards > 1) and not paged:
            raise ValueError(
                "sharding partitions the page bank: shards/mesh need "
                "paged=True (the row cache has per-slot affinity)")
        if local_read and mesh is None:
            raise ValueError(
                "local_read reads the bank shard by shard over mesh "
                "devices: it needs mesh=")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh {mesh} lies on {mesh.device}, the "
                             f"model on {self.device}")
        self.mesh = mesh
        self.local_read = bool(local_read)
        self.num_shards = shards

        self.paged = paged
        if bank is not None and not paged:
            raise ValueError(
                "a shared bank IS a page pool: it needs paged=True")
        self._bank = bank
        if paged:
            model._require_paged_support()   # all-attention, non-ring
            page_size = min(page_size, max_len)
            if max_len % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide max_len "
                    f"{max_len}: a row's virtual space is a whole number "
                    "of pages (and the gathered view must equal the row "
                    "cache elementwise for the identity guarantees)")
            self.page_size = page_size
            self.pages_per_row = max_len // page_size
        if paged and bank is not None:
            # the bank's creator sized AND sharded the pool; this engine
            # allocates from it beside the bank's other engines
            bank_shards = bank.pool.num_shards
            if shards_asked and shards != bank_shards:
                raise ValueError(
                    f"shards={shards} but the shared bank's pool has "
                    f"{bank_shards} shard(s) — the bank's creator fixes "
                    "the sharding")
            self.num_shards = bank_shards
            if bank.pool.total_pages - bank_shards < self.pages_per_row:
                raise ValueError(
                    f"shared bank of {bank.pool.total_pages} pages cannot "
                    f"hold one worst-case row ({self.pages_per_row} pages) "
                    "plus the reserved park page(s)")
            self.num_pages = bank.pool.total_pages
            self._pages = bank.pool
        elif paged:
            if num_pages is None:
                # capacity parity with the row layout: every slot can
                # always hold a worst-case row, split evenly across
                # shards (+1 reserved local park page per shard)
                need = batch_size * self.pages_per_row
                num_pages = self.num_shards * (
                    -(-need // self.num_shards) + 1)
            if self.num_shards > 1 and num_pages % self.num_shards:
                raise ValueError(
                    f"num_pages {num_pages} must divide by shards "
                    f"{self.num_shards}: the bank splits into equal "
                    "per-shard slices")
            if num_pages - self.num_shards < self.pages_per_row:
                raise ValueError(
                    f"num_pages {num_pages} cannot hold one worst-case "
                    f"row ({self.pages_per_row} pages) plus the reserved "
                    "park page(s)")
            self.num_pages = num_pages
            self._pages = (
                ShardedPagePool(num_pages, self.num_shards,
                                telemetry=telemetry)
                if self.num_shards > 1
                else PagePool(num_pages, telemetry=telemetry))
        else:
            self.page_size = None
            self.pages_per_row = 0
            self.num_pages = 0
            self._pages = None
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache shares pages of the pooled bank: it needs "
                "paged=True (the row cache has nothing to share)")
        self.prefix_cache = prefix_cache
        # int8 codes are a lossy function of the same source tokens:
        # namespacing keeps fp16 and int8 entries from ever cross-matching
        if not prefix_cache:
            self._prefix = None
        elif bank is not None:
            # one index per bank: prefixes another engine of this bank
            # indexed are hits here -- the pages are the same pool
            if bank.index is None:
                bank.index = PrefixIndex(self.page_size,
                                         namespace=quantize_kv or "fp16")
            self._prefix = bank.index
        else:
            self._prefix = PrefixIndex(self.page_size,
                                       namespace=quantize_kv or "fp16")

        # Execution hook: when set, every device program runs as
        # ``runner(fn, params, *args)`` — the continuous scheduler points
        # this at ``ContextSwitchEngine.run_step`` so steps execute
        # against the ACTIVE slot's buffers with hidden-load accounting.
        self.runner = None

        self.state: Optional[DecodeState] = None
        self._pool_init(batch_size, telemetry=telemetry)
        if paged:
            # prefix-cache counters (0 with the cache off): benches and
            # the scheduler's snapshot read them engine-lifetime
            self.stats.update(prefix_hits=0, prefix_pages_mapped=0,
                              cow_copies=0, cache_evictions=0)
        self.reset()

    # ------------------------------------------------------------- lifecycle
    def reset(self, seed: Optional[int] = None, keep_prefix: bool = False):
        """Empty pool + restarted draw schedule.  Cache buffers are reused
        when they exist: a freed slot's stale row is dead weight that the
        next admission overwrites in full (a freed page is rewritten
        before any of its positions is read), so only the first reset
        pays the allocation.

        ``keep_prefix=True`` carries the prefix cache across the reset:
        the index is snapshotted before the allocator clears and, since
        the cache tensors survive, its pages are re-adopted from the
        fresh free-list afterwards, so the first admission of a cached
        prompt after the reset still hits.  The first reset allocates
        zeroed caches and keeps nothing.  An engine over a shared bank
        releases only its own rows' pages: the pool, the index and the
        caches keep serving the bank's other engines."""
        B = self.batch_size
        snap = None
        if keep_prefix and self._bank is None and self._prefix is not None:
            snap = self._prefix.snapshot()
        if self._bank is not None:
            own = []
            for g in self.slots:
                if g is not None and g.pages:
                    own += g.pages
                    g.pages = None
            for ps in self._pending:
                if ps.cow is not None:      # the deferred copy's pin
                    own.append(ps.cow[0])
                    ps.cow = None
                for g in ps.gens:
                    if g.pages:
                        own += g.pages
                        g.pages = None
            if own:
                self._pages.release(own)
        elif self._pages is not None:
            self._pages.reset()
        if self._bank is None and self._prefix is not None:
            self._prefix.clear()     # its pages just left the allocator
        caches = self.state.caches if self.state is not None else None
        if self._bank is not None and self._bank.caches is not None:
            caches = self._bank.caches
        rebuilt = caches is None
        if rebuilt:
            caches = (self.model.init_page_pool(
                          self.num_pages, self.page_size,
                          quantized=self.quantize_kv is not None)
                      if self.paged else
                      self.model.init_cache(B, self.max_len))
        if self._bank is not None:
            self._bank.caches = caches
        table = np.zeros((B, self.pages_per_row), np.int32)
        table_dev = None
        if self.paged:
            # zeroed in place once it exists: a captured tick graph keeps
            # reading the table at the address it was captured on
            table_dev = (self.state.table_dev if self.state is not None
                         else None)
            if table_dev is None:
                table_dev = torch.from_numpy(table).to(self.device)
            else:
                table_dev.zero_()
        self.state = DecodeState(
            caches=caches, tok=np.zeros((B,), np.int32),
            pos=np.zeros((B,), np.int32), rseed=np.zeros((B,), np.int64),
            seeded=np.zeros((B,), bool),
            # every table entry must be a valid pool index; park (0) is
            # the safe default — empty slots read/write garbage space
            table=table, table_dev=table_dev)
        self.sampler.reset(self.seed if seed is None else seed)
        self._pool_reset()
        self._pending.clear()
        self._jumps = 0
        if snap is not None and not rebuilt:
            # the cache tensors survived the reset: the snapshot's pages
            # still hold their token runs, so re-adopt them from the fresh
            # free-list (refcount 1 each, LRU recency kept)
            self._prefix.restore(snap, self._pages.adopt)

    def export_prefix_index(self) -> Optional[dict]:
        """Host-side snapshot of the prefix index: which pool pages hold
        which token runs (the bank keeps the k/v bytes), so an engine over
        the SAME bank content can re-adopt them
        (``restore_prefix_index``).  ``None`` with the cache off."""
        return None if self._prefix is None else self._prefix.snapshot()

    def restore_prefix_index(self, snap: dict) -> list[int]:
        """Re-adopt a snapshot's cached pages into this engine's index:
        every page still on the free-list is claimed back at refcount 1
        with its LRU recency; entries whose page was handed out meanwhile
        drop out with their subtrees (their bytes are someone else's
        now).  -> the page ids adopted."""
        if self._prefix is None:
            raise ValueError("prefix_cache is off: nothing to restore "
                             "into")
        return self._prefix.restore(snap, self._pages.adopt)

    def _shard_arg(self):
        """``(mesh, axis)`` under local reads (the paged programs then
        read the bank shard by shard), else None (one global read)."""
        return ((self.mesh, self.mesh.axis_names[0]) if self.local_read
                else None)

    def _call(self, fn, params, *args):
        if self.runner is None:
            return fn(params, *args)
        return self.runner(fn, params, *args)

    # -------------------------------------------------------------- queries
    def pending_slots(self) -> int:
        return sum(len(ps.gens) for ps in self._pending)

    def free_pages(self) -> int:
        return self._pages.free_pages() if self.paged else 0

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages one row needs for its whole lifetime: positions
        ``0 .. prompt_len + max_new - 2`` are written/read (the final
        sampled token is never fed back)."""
        return max(1, -(-(prompt_len + max_new - 1) // self.page_size))

    def can_admit(self, tokens, max_new: int) -> bool:
        if not super().can_admit(tokens, max_new):
            return False                 # super set last_admit_block
        if not self.paged:
            return True
        tokens = np.asarray(tokens)
        b, S = (1, tokens.shape[0]) if tokens.ndim == 1 else tokens.shape
        npages = self.pages_needed(S, max_new)
        plan = None
        if self.prefix_cache and b == 1:
            plan = self._prefix_plan(tokens.reshape(1, S), max_new,
                                     peek=True)
        block = self._admit_block(b, npages, plan)
        if block is not None:
            # under pressure the cache gives memory back before admission
            # is refused: refcount-1 cached pages (no live table maps
            # them) leave LRU-first until the request fits or nothing
            # evictable is left -- never the pages this very request is
            # about to map.  A shard-local shortage ("shard_pages")
            # scopes eviction to the routed shard: freeing elsewhere
            # cannot help the shard the request must land on.
            if plan is not None:
                self._make_room(block, plan[3], self._route_prefix(plan),
                                _mapped(plan))
            else:
                self._make_room(block, b * npages, self._pages.route(npages))
            block = self._admit_block(b, npages, plan)
        self.last_admit_block = block
        return block is None

    def _admit_block(self, b: int, npages: int, plan) -> Optional[str]:
        """Why the next admission would fail on pages: ``None`` (it fits),
        ``"pages"`` (the pool is short) or ``"shard_pages"`` (the routed
        shard is short though the pool is not -- sharded pools only)."""
        if plan is not None:
            return self._pages.blocked(plan[3],
                                       shard=self._route_prefix(plan))
        if b == 1:
            return self._pages.blocked(npages)
        return self._pages.blocked_rows(b, npages)

    def _route_prefix(self, plan) -> Optional[int]:
        """Locality routing for a prefix hit: the row's fresh pages land
        on the shard that holds the matched pages (the CoW boundary page
        when there is one -- its copy must lie beside its source under
        local reads).  ``None`` (route freely) when nothing anchors the
        hit or the pool has one shard."""
        if self._pages.num_shards == 1:
            return None
        retained, cow_src, _, _ = plan
        anchor = cow_src if cow_src is not None else (
            retained[-1] if retained else None)
        return None if anchor is None else self._pages.shard_of(anchor)

    # -------------------------------------------------------- prefix cache
    def _reclaim(self, deficit: int, protect=(),
                 shard: Optional[int] = None) -> int:
        """Evict up to ``deficit`` cached prefix pages (LRU leaves first;
        only refcount-1 pages, held by nothing but the index) back into
        the free-list.  ``shard`` scopes eviction to that shard's pages.
        -> the pages reclaimed."""
        if self._prefix is None or deficit <= 0:
            return 0
        keep = set(protect)

        def _evictable(p):
            if p in keep or self._pages.refcount(p) != 1:
                return False
            return shard is None or self._pages.shard_of(p) == shard

        evicted = self._prefix.evict_lru(deficit, _evictable)
        if evicted:
            self._pages.release(evicted)
            self._pages.note_reclaimed(evicted)
            self.stats["cache_evictions"] += len(evicted)
            if self._trace.enabled:
                self._trace.instant(
                    "page-reclaim", f"{self.telemetry.prefix}eng",
                    args={"evicted": len(evicted)})
        return len(evicted)

    def _make_room(self, block: Optional[str], need: int,
                   shard: Optional[int], protect=()) -> None:
        """Evict before a take that ``block`` (a ``blocked`` answer) says
        would fail: a shard-local shortage (``"shard_pages"``) evicts on
        ``shard`` until ``need`` pages fit there, a pool-wide one anywhere
        until they fit in the pool; ``protect`` is never evicted."""
        if block == "shard_pages" and shard is not None:
            self._reclaim(need - self._pages.shard_free(shard),
                          protect=protect, shard=shard)
        elif block is not None:
            self._reclaim(need - self._pages.free_pages(), protect=protect)

    def _prefix_plan(self, tokens, max_new: int, peek: bool = False):
        """The longest indexed whole-page prefix of a single-row prompt
        -> ``(retained, cow_src, d, owned)``, or ``None`` (a miss, the
        cache off, or several rows).  ``retained``: the page ids mapped
        read-only; ``d``: where prefill resumes (the first divergent
        token, at most S-1 -- the last prompt token is always recomputed,
        for the logits that sample the first token); ``cow_src``: the
        shared boundary page to copy when ``d`` lands inside it;
        ``owned``: the fresh pages still to allocate (the CoW destination
        among them).  ``peek`` leaves the index's recency as it is: a
        capacity probe must not bump it, the ``admit`` that follows
        does."""
        if self._prefix is None or tokens.shape[0] != 1:
            return None
        b, S = tokens.shape
        hit = self._prefix.lookup(tokens[0], peek=peek)
        if not hit:
            return None
        ps = self.page_size
        d = min(len(hit) * ps, S - 1)
        retained = hit[:d // ps]
        cow_src = hit[d // ps] if d < len(hit) * ps else None
        owned = self.pages_needed(S, max_new) - len(retained)
        return retained, cow_src, d, owned

    def _take_prefix_pages(self, plan, S: int, max_new: int):
        """A prefix-hit row's table: the matched pages mapped read-only
        (one pool reference each), fresh pages for the rest -- the first
        fresh page is the CoW destination when the plan has one.  The
        CoW *source* takes a pool reference too, though it never enters
        the table: the copy may run later (chunked admission defers it to
        the first chunk tick), and without the pin an interleaved
        admission's ``_reclaim`` could find it at refcount 1 once its
        owner retired, evict it and recycle its storage before the copy
        reads it.  The pin drops when the copy runs (or on the failure
        paths).  -> (table (1, P), pages in table order, fresh)."""
        retained, cow_src, d, owned = plan
        shard = self._route_prefix(plan)
        self._make_room(self._pages.blocked(owned, shard=shard), owned,
                        shard, _mapped(plan))
        fresh = self._pages.take(owned, shard=shard)   # raises if short
        self._pages.acquire(retained)
        if cow_src is not None:
            self._pages.acquire([cow_src])       # pinned until the copy
        npages = len(retained) + owned
        table = np.full((1, self.pages_per_row), PagePool.PARK, np.int32)
        table[0, :len(retained)] = retained
        table[0, len(retained):npages] = fresh
        return table, retained + fresh, fresh

    def _drop_prefix_pages(self, plan, fresh):
        """Failed prefix-hit admission: the fresh pages go back to the
        FRONT in their original order (a retry draws them again), the
        mapped references drop (the index still pins those pages) and so
        does the CoW source's pin."""
        retained, cow_src, _, _ = plan
        self._pages.restore(fresh)
        self._pages.release(retained)
        if cow_src is not None:
            self._pages.release([cow_src])

    def _index_prompt(self, tokens_row, pages):
        """Index one row's *fully written* prompt pages -- called only once
        its prefill is done, so every indexed page holds its whole token
        run and is never written again (the owner's later writes are
        decode tokens at positions >= S).  The partly filled last prompt
        page never enters.  The index takes one pool reference per page
        it newly adopted; runs already indexed keep their first writer's
        page."""
        if self._prefix is None or pages is None:
            return
        n = len(tokens_row) // self.page_size
        if n:
            self._pages.acquire(self._prefix.insert(tokens_row, pages[:n]))

    # ------------------------------------------------------ page allocation
    def _take_pages(self, b: int, S: int, max_new: int):
        """Allocate each admitted row its pages and build the (b, P)
        tables (unused tail entries point at the park page).  Rows take
        their pages one after another -- on a sharded pool each routes to
        the least-loaded shard at its turn, as ``blocked_rows`` prices --
        and a mid-batch shortage gives the earlier rows' pages back, so
        the caller sees one atomic failure.  With the prefix cache on, a
        shortage first evicts cached pages (a shard-local one up to one
        row's worth on the shard the next row routes to).  Returns
        (tables, flat page list for failure restore)."""
        npages = self.pages_needed(S, max_new)
        if self.prefix_cache:
            blk = self._pages.blocked_rows(b, npages)
            self._make_room(blk, npages if blk == "shard_pages"
                            else b * npages, self._pages.route(npages))
        taken: list[list[int]] = []
        tables = np.full((b, self.pages_per_row), PagePool.PARK, np.int32)
        try:
            for i in range(b):
                rows = self._pages.take(npages)
                tables[i, :npages] = rows
                taken.append(rows)
        except BaseException:
            for rows in reversed(taken):
                self._pages.restore(rows)
            raise
        return tables, [p for rows in taken for p in rows]

    def _reserve(self, b: int, S: int, max_new: int, plan=None):
        """Take b slots and, paged, their pages (a prefix hit's ``plan``:
        its mapped and fresh pages) -> (slots, tables or None, flat page
        list, the hit's fresh pages); on a shortage nothing stays
        taken."""
        slots = self._take_slots(b)
        if not self.paged:
            return slots, None, [], []
        try:
            if plan is not None:
                tables, pages, fresh = self._take_prefix_pages(
                    plan, S, max_new)
            else:
                tables, pages = self._take_pages(b, S, max_new)
                fresh = []
        except BaseException:
            self._restore_slots(slots)
            raise
        return slots, tables, pages, fresh

    def _hand_pages(self, gens, pages, S: int, max_new: int) -> None:
        """Record each generation's own pages (released on retire)."""
        if self.paged:
            npages = self.pages_needed(S, max_new)
            for i, g in enumerate(gens):
                g.pages = pages[i * npages:(i + 1) * npages]

    def _set_tables(self, slots, tables) -> None:
        st = self.state
        st.table[slots] = tables
        st.table_dev[torch.as_tensor(slots, device=self.device).long()
                     ] = torch.from_numpy(tables).to(self.device)

    # ------------------------------------------------------- device programs
    def _admit_fn(self, params, tokens, slots, tables, rseeds, seeded):
        """Prefill (b, S) prompts into cache rows `slots` (paged: into the
        rows' own pages through ``tables``) and sample their first tokens
        from the admission draw; row r of a (B, V) field indexed by slot,
        so a single-row admission in a half-full batch samples the same
        token it would in a full batched prefill.  Seeded rows draw from
        their own generator (folded with S: the first token is produced
        at position S).  Sampling never sees the cache layout."""
        st, model = self.state, self.model
        b, S = tokens.shape
        logits, rows = model.prefill(params, tokens, self.max_len)
        first = self._admit_sample(logits[:, -1], slots, rseeds, seeded,
                                   np.full((b,), S))
        if self.paged:
            model.insert_cache_pages(st.caches, rows, tables)
            self._set_tables(slots, tables)
        else:
            model.insert_cache_rows(st.caches, rows, slots)
        st.tok[slots] = first
        st.pos[slots] = S
        st.rseed[slots] = rseeds
        st.seeded[slots] = seeded
        return first

    def _admit_sample(self, last, slots, rseeds, seeded, plen):
        """First tokens of admitted rows from their last prompt logits
        ``last`` ((b, V) f32), under the admission draw: row r of one
        (B, V) field indexed by slot; seeded rows draw from their own
        generator folded with the prompt length ``plen`` (the first token
        is produced there).  One-shot and chunked admission share it, so
        their streams are token-identical."""
        T = self.temperature
        g = None
        if T > 0.0:
            V = last.shape[-1]
            g = self.sampler.field(self.sampler.admit_key(),
                                   (self.batch_size, V))
            g = g[torch.as_tensor(slots, device=g.device)]
            if seeded.any():
                idx = np.nonzero(seeded)[0]
                g[torch.as_tensor(idx, device=g.device)] = self.sampler.rows(
                    rseeds[idx], plen[idx], V)
        return _sample(last, T, g).cpu().numpy()

    def _chunk_fn(self, params, tokens, pos, slots, tables, final=None):
        """One prefill chunk: the (b, C) block's k/v go into cache rows
        ``slots`` at per-row offsets ``pos`` (paged: through the rows'
        page tables, exactly the chunk's positions).  A streaming chunk
        stops there: no logits, no sampling.  The final chunk (``final =
        (nvalid, rseeds, seeded)``) is padded to C with ``nvalid`` real
        tokens per row (the write mask keeps pad k/v out of the cache);
        the last real token's logits sample the first token under the
        one-shot admission draw (``_admit_sample``), and the rows go live
        at the prompt length ``pos + nvalid``.  Returns the first tokens
        of a final chunk."""
        st, model, dev = self.state, self.model, self.device
        b, W = tokens.shape
        args = (params, st.caches, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos).to(dev))
        kw = dict(need_logits=final is not None)
        if final is not None:
            nv = torch.from_numpy(final[0]).to(dev)
            kw["wmask"] = torch.arange(W, device=dev)[None, :] < nv[:, None]
        if self.paged:
            logits, _ = model.prefill_chunk_pages(
                *args, torch.from_numpy(tables).to(dev),
                shard=self._shard_arg(), **kw)
        else:
            logits, _ = model.prefill_chunk(
                *args, torch.from_numpy(slots).to(dev), **kw)
        if final is None:
            return None
        nvalid, rseeds, seeded = final
        last = logits[torch.arange(b, device=dev), nv.long() - 1]  # (b, V)
        plen = pos + nvalid
        first = self._admit_sample(last, slots, rseeds, seeded, plen)
        st.tok[slots] = first
        st.pos[slots] = plen
        st.rseed[slots] = rseeds
        st.seeded[slots] = seeded
        return first

    def _copy_fn(self, params, src, dst):
        """Copy-on-write: duplicate pool pages ``src`` -> ``dst`` in every
        layer BEFORE the diverging row's first write, in place
        (``params`` is unused; it keeps the runner's ``fn(params,
        *args)`` convention)."""
        del params
        self.model.copy_cache_pages(self.state.caches, src, dst)

    def _step_fn(self, params, live):
        """One decode step for the whole batch; ``live`` ((B,) bool) rows
        advance, the others park (paged: their writes go to the park
        page; row: to their own dead row at slot ``min(pos, S-1)``)."""
        st, model, T = self.state, self.model, self.temperature
        dev = self.device
        tok = torch.from_numpy(st.tok[:, None]).to(dev)
        pos = torch.from_numpy(st.pos).to(dev)
        if self.paged:
            logits, _ = model.decode_step_pages(
                params, st.caches, tok, pos, st.table_dev,
                live=torch.from_numpy(live).to(dev),
                shard=self._shard_arg())
        else:
            logits, _ = model.decode_step(params, st.caches, tok, pos)
        last = logits[:, -1]
        key = self.sampler.advance()
        g = None
        if T > 0.0:
            B, V = last.shape
            g = self.sampler.field(key, (B, V))
            sl = st.seeded & live
            if sl.any():
                idx = np.nonzero(sl)[0]
                g[torch.as_tensor(idx, device=g.device)] = self.sampler.rows(
                    st.rseed[idx], st.pos[idx] + 1, V)
        nxt = _sample(last, T, g).cpu().numpy()
        st.tok = nxt.astype(np.int32)
        st.pos = np.minimum(np.where(live, st.pos + 1, st.pos),
                            self.max_len - 1).astype(np.int32)
        return nxt

    def _fused_tick(self, params, inp, gumbel):
        """The fused tick's device program: up to ``multi_step`` decode
        steps (``LM.decode_multi_step[_pages]``) on device buffers alone,
        with no host sync, so that one CUDA graph captures it.  ``inp``
        ((5B + 1,) int32) packs the tick's host columns: tok, pos, live,
        rem (each row's remaining tokens), budget (its position cap: the
        end of its pages, or max_len), then go (0: no step commits, the
        capture's warm-up).  ``gumbel`` ((T, B, V) f32, None when greedy)
        holds the steps' fields.  A live row stops the tick after the
        step that spends its budget, reaches its cap or samples EOS: the
        single-step engine's retirement.  Returns (B*T + 1,) int32, the
        steps' tokens row by row, then n, the steps committed."""
        st, model, B = self.state, self.model, self.batch_size
        T, eos = self.temperature, self.eos_id
        tok, pos, live, rem, budget = inp[:5 * B].view(5, B)
        live = live != 0

        def sample_fn(last, pos, i):
            return _sample(last, T, None if gumbel is None else gumbel[i])

        def stop_fn(nxt, posr, i):
            done = (rem <= i + 1) | (posr >= budget)
            if eos is not None:
                done = done | (nxt == eos)
            return (live & done).any()

        kw = dict(live=live, pos_cap=self.max_len - 1,
                  commit=inp[5 * B] != 0)
        if self.paged:
            out, n, *_ = model.decode_multi_step_pages(
                params, st.caches, tok[:, None], pos, st.table_dev,
                self.multi_step, sample_fn, stop_fn,
                shard=self._shard_arg(), **kw)
        else:
            out, n, *_ = model.decode_multi_step(
                params, st.caches, tok[:, None], pos, self.multi_step,
                sample_fn, stop_fn, **kw)
        return torch.cat([out.reshape(-1), n.view(1)])

    def _fused_fields(self, live):
        """The gumbel fields of the tick's ``multi_step`` steps, (T, B, V)
        (None when greedy): step i draws what the i-th single step would,
        the pool field of the draw chain's next key, seeded live rows
        their own field at the position they produce (pos + 1 + i).  The
        chain runs on by T keys here; ``_mstep_fn`` leaves it n on."""
        if self.temperature <= 0.0:
            return None
        st, B, V = self.state, self.batch_size, self.model.cfg.vocab_size
        idx = np.nonzero(st.seeded & live)[0]
        fields = []
        for i in range(self.multi_step):
            g = self.sampler.field(self.sampler.advance(), (B, V))
            if idx.size:
                g[torch.as_tensor(idx, device=g.device)] = self.sampler.rows(
                    st.rseed[idx], st.pos[idx] + 1 + i, V)
            fields.append(g)
        return torch.stack(fields)

    def _tick_graph(self, params, inp, gumbel) -> _TickGraph:
        """The tick graph over the current weight, cache and table
        buffers, captured on first use.  Graphs whose buffers are gone
        are dropped first.  The capture follows ``torch.cuda.graphs``: a
        warm-up on a side stream (with go = 0, so it commits nothing and
        leaves every state as it was), then the capture, thread-local so
        that the context engine's loader may copy weights meanwhile."""
        bufs = [*_tensors(params), *_tensors(self.state.caches)]
        if self.paged:
            bufs.append(self.state.table_dev)
        self._graphs = {k: g for k, g in self._graphs.items() if g.alive()}
        key = tuple(map(id, bufs))
        g = self._graphs.get(key)
        if g is not None:
            return g
        t0 = time.perf_counter()
        g = _TickGraph(bufs, inp.size, gumbel, self.device)
        warm = inp.copy()
        warm[-1] = 0
        g.load(warm, gumbel)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._fused_tick(params, g.inp, g.gumbel)
        cur.wait_stream(side)
        before = kernels.launch_counts()
        with torch.cuda.graph(g.graph, capture_error_mode="thread_local"):
            g.res = self._fused_tick(params, g.inp, g.gumbel)
        g.launches = kernels.launches_since(before)
        kernels.add_launches(g.launches, times=-1)   # captured, not run
        self._graphs[key] = g
        self.graph_captures += 1
        self.graph_capture_s += time.perf_counter() - t0
        return g

    def _mstep_fn(self, params, live, rem, budget):
        """One fused tick: up to ``multi_step`` decode steps, then ONE
        readback of (tokens, n).  On a CUDA card the tick replays its
        graph (and adds the graph's launches to the kernels' counts); on
        the CPU ``_fused_tick`` runs eagerly.  Leaves the draw chain n
        keys on and tok and pos where n single steps would.  -> (out (B,
        n) int32, n)."""
        st, B = self.state, self.batch_size
        inp = np.concatenate([st.tok, st.pos, live, rem, budget,
                              [1]]).astype(np.int32)
        snap = self.sampler.snapshot()
        gumbel = self._fused_fields(live)
        if self.device.type == "cuda":
            g = self._tick_graph(params, inp, gumbel)
            g.load(inp, gumbel)
            g.graph.replay()
            kernels.add_launches(g.launches)
            res = g.res
        else:
            res = self._fused_tick(params, torch.from_numpy(inp), gumbel)
        res = res.cpu().numpy()                  # the tick's one readback
        n = int(res[-1])
        out = res[:-1].reshape(B, self.multi_step)[:, :n]
        self.sampler.restore(snap)
        for _ in range(n):
            self.sampler.advance()
        st.tok = out[:, -1].copy()
        st.pos = np.minimum(np.where(live, st.pos + n, st.pos),
                            self.max_len - 1).astype(np.int32)
        return out, n

    # ------------------------------------------------------------- admission
    def admit(self, params, tokens, max_new: int,
              metas: Optional[list] = None,
              seeds: Optional[list] = None,
              submitted_at: Optional[float] = None) -> list[Generation]:
        """Admit (b, S) prompt rows into b free slots.  Raises if the pool
        lacks room or the request would run past the cache; callers gate
        on ``can_admit``.

        One-shot mode (``prefill_chunk is None``): prefill + first token
        in one whole-prompt program.  Chunked mode: the slots are
        reserved and the prompt queued; chunks stream in one per
        subsequent ``step``/``prefill_tick``, and the returned
        ``Generation``s stay token-less until their final chunk samples
        the first token.

        ``seeds``: optional per-row sampling seeds — ``None`` entries keep
        the pool's shared draw schedule; an int pins that row to its own
        generator state, making its draws reproducible independent of
        slot, admission boundary, and surrounding traffic.
        """
        tokens, rseeds, seeded = self._admit_args(tokens, metas, seeds)
        b, S = tokens.shape
        if S + max_new > self.max_len:
            raise ValueError(f"prompt {S} + {max_new} new tokens exceeds "
                             f"max_len {self.max_len}")
        plan = (self._prefix_plan(tokens, max_new) if self.prefix_cache
                else None)
        if self.prefill_chunk is not None:
            return self._admit_chunked(tokens, max_new, metas, rseeds,
                                       seeded, plan=plan,
                                       submitted_at=submitted_at)
        if plan is not None:
            return self._admit_prefix_hit(params, tokens, max_new, metas,
                                          rseeds, seeded, plan,
                                          submitted_at=submitted_at)
        slots, tables, pages, _ = self._reserve(b, S, max_new)
        try:
            first = self._call(self._admit_fn, params, tokens,
                               np.asarray(slots, np.int64), tables, rseeds,
                               seeded)
        except BaseException:
            self._restore_slots(slots)   # failed admit must not leak slots
            if pages:                    # nor pages (front, original order)
                self._pages.restore(pages)
            raise
        gens = self._register(slots, S, max_new, metas, first=first,
                              submitted_at=submitted_at)
        self._hand_pages(gens, pages, S, max_new)
        if self.paged:
            for i, g in enumerate(gens):
                self._index_prompt(tokens[i], g.pages)
        if self._retire_done(gens):
            # a slot freed with no step in between (steps==1 / EOS at
            # admission): advance the draws so a same-boundary
            # re-admission of that slot cannot reuse this draw field.
            self._salt_admit_key()
        return gens

    def _admit_prefix_hit(self, params, tokens, max_new: int, metas,
                          rseeds, seeded, plan,
                          submitted_at=None) -> list[Generation]:
        """One-shot admission on a prefix hit: the matched pages map
        read-only into the new row's table, the boundary page is copied
        when the divergence lands inside one (BEFORE any write -- shared
        pages are never mutated), and only the prompt's un-cached suffix
        runs, as ONE final chunk (``_chunk_fn`` at the suffix's width).
        The chunk samples under the one-shot admission draw, and the
        shared pages hold the k/v this prompt's own prefill would write
        (same tokens, same positions), so the stream is a cold
        admission's, bitwise where both run the same device route."""
        b, S = tokens.shape
        retained, cow_src, d, owned = plan
        slots, table, pages, fresh = self._reserve(b, S, max_new, plan)
        try:
            if cow_src is not None:
                self._call(self._copy_fn, params, [cow_src], [fresh[0]])
            self._set_tables(slots, table)
            first = self._call(
                self._chunk_fn, params,
                np.ascontiguousarray(tokens[:, d:], dtype=np.int32),
                np.full((b,), d, np.int32), np.asarray(slots, np.int64),
                table, (np.full((b,), S - d, np.int32), rseeds, seeded))
        except BaseException:
            self._restore_slots(slots)
            self._drop_prefix_pages(plan, fresh)
            raise
        if cow_src is not None:
            self._pages.release([cow_src])       # copy done: pin drops
        gens = self._register(slots, S, max_new, metas, first=first,
                              submitted_at=submitted_at)
        gens[0].pages = pages
        self._index_prompt(tokens[0], pages)
        # counters only once the admission committed: a failed program
        # rolls pages and slots back and leaves the stats alone
        self._note_hit(gens[0], len(retained), cow_src is not None)
        if self._retire_done(gens):
            self._salt_admit_key()
        return gens

    def _note_hit(self, g: Generation, mapped: int, cow: bool) -> None:
        """A committed prefix-hit admission: its counters and its
        ``prefix-hit:<rid>`` trace instant."""
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_mapped"] += mapped
        if cow:
            self.stats["cow_copies"] += 1
        if self._trace.enabled:
            self._trace.instant(
                f"prefix-hit:{g.rid}", f"{self.telemetry.prefix}eng",
                args={"mapped": mapped, "cow": cow})

    def _admit_chunked(self, tokens, max_new, metas, rseeds, seeded,
                       plan=None, submitted_at=None) -> list[Generation]:
        """Reserve slots (and pages) and queue the prompt for chunked
        prefill.  The reserved rows park at the LAST cache slot: every
        decode step still writes a (garbage) k/v for every row, and slot
        ``max_len-1`` is the one slot never read (with ``prompt + max_new
        <= max_len`` a row's decode feeds stop at ``max_len-2``).  Paged
        rows' tables go live now: the decode steps that run meanwhile
        route the reserved rows' writes to the park page, and the final
        chunk's row needs its table at the next step."""
        b, S = tokens.shape
        slots, tables, pages, fresh = self._reserve(b, S, max_new, plan)
        done, cow = 0, None
        if plan is not None:
            # prefix hit: the matched pages map read-only, chunking
            # resumes at the first divergent token, and the boundary page
            # (if any) is copied right before the first chunk
            done = plan[2]
            if plan[1] is not None:
                cow = (plan[1], fresh[0])
        if self.paged:
            self._set_tables(slots, tables)
        self.state.pos[slots] = self.max_len - 1
        gens = self._register(slots, S, max_new, metas,
                              submitted_at=submitted_at)
        self._hand_pages(gens, pages, S, max_new)
        self._pending.append(_PendingPrefill(
            tokens=np.asarray(tokens, np.int32), gens=gens, rseeds=rseeds,
            seeded=seeded, done=done, tables=tables, cow=cow,
            hit=plan is not None,
            mapped=len(plan[0]) if plan is not None else 0,
            had_cow=cow is not None))
        return gens

    def _promote_pending(self):
        """Admission priority: a short prompt (whole prompt in ONE chunk)
        may jump ahead of a long prompt's queued chunk work -- it costs
        the long prompt one tick and gets the short request its first
        token at once.  After ``admit_jump_limit`` consecutive jumps the
        head MUST run a chunk, so a stream of shorts delays a long prompt
        by at most that many ticks per chunk.  Rotates the chosen entry to
        the queue front."""
        C = self.prefill_chunk
        head = self._pending[0]
        if (len(self._pending) > 1 and head.tokens.shape[1] - head.done > C
                and self._jumps < self.admit_jump_limit):
            for i in range(1, len(self._pending)):
                if self._pending[i].tokens.shape[1] <= C:
                    ps = self._pending[i]
                    del self._pending[i]
                    self._pending.appendleft(ps)
                    self._jumps += 1
                    return
        self._jumps = 0                  # the head makes progress

    def _note_chunk(self, ps: _PendingPrefill, t0: float, start: int,
                    end: int, final: bool):
        """Chunk telemetry: the admit-to-first-chunk latency sample
        (admission until its first chunk starts) and the ``prefill-chunk``
        span on this engine's track."""
        now = self.telemetry.clock()
        if not ps.started:
            ps.started = True
            self.telemetry.observe("admit_to_first_chunk_s",
                                   t0 - ps.gens[0].admitted_at)
        if self._trace.enabled:
            self._trace.span(
                "prefill-chunk", f"{self.telemetry.prefix}eng", t0, now,
                args={"rid": ps.gens[0].rid, "start": start, "end": end,
                      "final": final})

    def prefill_tick(self, params) -> list[Generation]:
        """Run at most ONE chunk program -- the admission budget of a
        tick.  Returns generations that finished at this boundary (a
        final chunk can instant-retire: steps == 1, or EOS as the first
        token)."""
        if not self._pending:
            return []
        C = self.prefill_chunk
        if self.admit_jump_limit:
            self._promote_pending()
        ps = self._pending[0]
        b, S = ps.tokens.shape
        start = ps.done
        end = min(start + C, S)
        nvalid = end - start
        chunk = np.zeros((b, C), np.int32)
        chunk[:, :nvalid] = ps.tokens[:, start:end]
        slots = np.asarray([g.slot for g in ps.gens], np.int64)
        pos = np.full((b,), start, np.int32)
        t0 = self.telemetry.clock()
        try:
            if ps.cow is not None:
                # copy-on-write the shared boundary page BEFORE this
                # request's first write lands in it; then the
                # admission-time pin on the source drops (the index still
                # holds its own reference)
                src, dst = ps.cow
                self._call(self._copy_fn, params, [src], [dst])
                ps.cow = None
                self._pages.release([src])
            if end < S:
                self._call(self._chunk_fn, params, chunk, pos, slots,
                           ps.tables)
                ps.done = end
                self._note_chunk(ps, t0, start, end, final=False)
                return []
            first = self._call(self._chunk_fn, params, chunk, pos, slots,
                               ps.tables, (np.full((b,), nvalid, np.int32),
                                           ps.rseeds, ps.seeded))
        except BaseException:
            # a failed chunk abandons the whole request: its rows go back
            # so the pool keeps serving (the caller fails the futures).
            # Pages restore in ONE call, in their original take order.
            self._pending.popleft()
            if ps.cow is not None:
                # the deferred copy never ran: drop the source's pin, the
                # page goes back to being plain index-cached (evictable)
                self._pages.release([ps.cow[0]])
            pages = []
            for g in ps.gens:
                self.slots[g.slot] = None
                pages += g.pages or []
                g.pages = None
            if pages:
                self._pages.restore(pages)
            self._restore_slots([g.slot for g in ps.gens])
            raise
        self._pending.popleft()
        self._note_chunk(ps, t0, start, end, final=True)
        if ps.hit:
            # counters only once the hit committed (its final chunk
            # sampled): an abandoned admission rolled its pages back
            self._note_hit(ps.gens[0], ps.mapped, ps.had_cow)
        now = self.telemetry.clock()
        for i, g in enumerate(ps.gens):
            g.tokens.append(int(first[i]))
            self._live[g.slot] = True
            self.stats["tokens_out"] += 1
            self._note_first_token(g, now)
        if self.paged:
            # the prompt is fully written now: its whole pages become
            # indexable (BEFORE retirement, so an instant retire still
            # fills the cache -- the index's reference outlives the row)
            for i, g in enumerate(ps.gens):
                self._index_prompt(ps.tokens[i], g.pages)
        finished = self._retire_done(ps.gens)
        if finished:
            self._salt_admit_key()
        return finished

    # ----------------------------------------------------------- retirement
    def _retire_done(self, gens: list[Generation]) -> list[Generation]:
        """Retire finished rows AND release their pages (FIFO: to the
        back of the page free-list).  No device-side table reset is
        needed: the retired slot stops being ``live``, so its per-step
        writes route to the park page from the next step on."""
        finished = super()._retire_done(gens)
        if self.paged:
            for g in finished:
                if g.pages:
                    self._pages.release(g.pages)
                    g.pages = None
        return finished

    # ---------------------------------------------------------------- step
    def step(self, params) -> list[Generation]:
        """One engine tick: at most one prefill chunk (chunked admission),
        then one decode step for every live slot -- or, with
        ``multi_step=T`` and no prompt pending, up to T fused steps.
        Returns the generations that finished (EOS or step limit) at this
        boundary; their slots are already back on the free-list."""
        finished = self.prefill_tick(params) if self._pending else []
        if not self._live.any():
            return finished
        live = self._live.copy()
        t0 = self.telemetry.clock()
        if self.multi_step > 1 and not self._pending:
            out, n = self._call(self._mstep_fn, params, live,
                                *self._budgets())
        else:
            out, n = self._call(self._step_fn, params, live)[:, None], 1
        now = self.telemetry.clock()
        self.stats["host_ticks"] += 1
        self.stats["device_steps"] += n
        stepped = []
        for s in range(self.batch_size):
            g = self.slots[s]
            if g is None or not live[s]:
                continue                  # empty, or reserved mid-prefill
            g.tokens.extend(int(t) for t in out[s])
            stepped.append(g)
        self.stats["tokens_out"] += n * len(stepped)
        self._note_tick(t0, now, n, len(stepped))
        return finished + self._retire_done(stepped)

    def _budgets(self):
        """The fused tick's per-row limits: each live row's remaining
        tokens and its position cap (the end of its pages, or max_len);
        0 for the other rows.  -> (rem, budget), (B,) int32 each."""
        rem = np.zeros((self.batch_size,), np.int32)
        budget = np.zeros((self.batch_size,), np.int32)
        for s, g in enumerate(self.slots):
            if g is None or not self._live[s]:
                continue
            rem[s] = g.remaining
            budget[s] = (len(g.pages) * self.page_size
                         if self.paged and g.pages else self.max_len)
        return rem, budget


# ---------------------------------------------------------------------------
# classic run-to-completion engine (wrappers over StepEngine)
# ---------------------------------------------------------------------------

class ServingEngine:
    def __init__(self, model: LM, params, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 telemetry: Optional[Telemetry] = None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.stats = ServeStats(self.telemetry.view())
        self._eng_seq = 0            # per-engine metric namespace counter
        # Per-(batch, layout) engine cache, LRU-bounded: each entry pins a
        # full KV pool, so traffic with many distinct batch shapes must
        # not accumulate pools without limit.
        self.max_cached_pools = 4
        self._step_engines: "OrderedDict[EngineKey, StepEngine]" = (
            OrderedDict())

    def step_engine(self, batch_size: int, paged: bool = False,
                    page_size: int = 256, multi_step: int = 1) -> StepEngine:
        """The continuous-batching engine behind ``generate`` /
        ``generate_paged`` / ``generate_fused`` (cached per (batch shape,
        page layout, fused steps); least recently used idle keys beyond
        ``max_cached_pools`` are dropped to free their KV pools, and their
        tick graphs with them)."""
        key = EngineKey(batch_size=batch_size,
                        page_size=page_size if paged else None,
                        multi_step=multi_step)
        eng = self._step_engines.get(key)
        if eng is None:
            eng = StepEngine(self.model, batch_size, self.max_len,
                             temperature=self.temperature, seed=self.seed,
                             paged=paged, page_size=page_size,
                             multi_step=multi_step,
                             telemetry=self.telemetry.scoped(
                                 f"eng.{self._eng_seq}."))
            self._eng_seq += 1
            self._step_engines[key] = eng
        self._step_engines.move_to_end(key)
        if len(self._step_engines) > self.max_cached_pools:
            for b in [b for b, e in self._step_engines.items()
                      if e is not eng and not e.live_slots()]:
                if len(self._step_engines) <= self.max_cached_pools:
                    break
                del self._step_engines[b]
        return eng

    def _run(self, eng: StepEngine, tokens, steps: int,
             seed: Optional[int]) -> np.ndarray:
        B = tokens.shape[0]
        t0 = self.telemetry.clock()
        eng.reset(seed=self.seed if seed is None else seed)
        gens = eng.admit(self.params, tokens, max_new=steps)
        synchronize(self.model.device)
        self.stats.prefill_s += self.telemetry.clock() - t0

        t0 = self.telemetry.clock()
        while eng.live_slots():
            eng.step(self.params)
        synchronize(self.model.device)
        self.stats.decode_s += self.telemetry.clock() - t0
        self.stats.tokens += B * steps
        return np.stack([np.asarray(g.tokens, np.int32) for g in gens])

    def generate(self, tokens, steps: int,
                 seed: Optional[int] = None) -> np.ndarray:
        """tokens: (B, S) prompt; returns (B, steps) generated ids.

        Thin wrapper over ``StepEngine``: the whole batch is admitted at
        t=0 and stepped to completion — the degenerate (static-batch) case
        of continuous batching, with identical sampling draws."""
        tokens = np.asarray(tokens)
        return self._run(self.step_engine(tokens.shape[0]), tokens, steps,
                         seed)

    def generate_paged(self, tokens, steps: int, page: int = 256,
                       seed: Optional[int] = None) -> np.ndarray:
        """Paged-cache decode loop — the same wrapper over
        ``StepEngine(paged=True)``: the whole batch is admitted at t=0
        into per-slot page tables over one shared page pool.  Identical
        outputs to ``generate``."""
        tokens = np.asarray(tokens)
        eng = self.step_engine(tokens.shape[0], paged=True,
                               page_size=min(page, self.max_len))
        return self._run(eng, tokens, steps, seed)

    def generate_fused(self, tokens, steps: int,
                       seed: Optional[int] = None) -> np.ndarray:
        """The whole decode as one device program: prefill and the first
        token, then the other ``steps - 1`` decode steps as ONE fused tick
        of a ``StepEngine(multi_step=steps - 1)`` -- one CUDA graph replay
        on a card, a plain loop on the CPU.  Returns (B, steps) ids,
        identical to ``generate``'s."""
        tokens = np.asarray(tokens)
        eng = self.step_engine(tokens.shape[0],
                               multi_step=max(steps - 1, 1))
        return self._run(eng, tokens, steps, seed)
