"""The port's prefix cache: refcounted ``PagePool``/``ShardedPagePool``,
``PrefixIndex``, copy-on-write admission, ``SharedBank``, and the cache
through the step engine, the schedulers and the launcher, on the CPU in
float32.

The host-side allocator and index are held call for call against the
JAX package's (same returns, free-list order and refcounts); the engines
against the JAX engine on the same weights (greedy streams, counters and
page tables).  Inside the port a prefix hit must be bitwise a cold
admission, as the JAX suite holds it (``tests/test_prefix_cache.py``):
greedy and seeded temperature, one-shot and chunked, fp and int8, under
``multi_step=4``, on logical shards and under local reads."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro.serve.pool import PagePool as JaxPagePool  # noqa: E402
from repro.serve.pool import PrefixIndex as JaxPrefixIndex  # noqa: E402
from repro.serve.pool import ShardedPagePool as JaxShardedPool  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.distributed.mesh import Mesh  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import EngineKey, StepEngine  # noqa: E402
from repro_torch.serve.pool import (PagePool, PrefixIndex,  # noqa: E402
                                    ShardedPagePool)
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(port LM, port params, JAX LM, JAX params): reduced tinyllama in
    float32 end to end, JAX weights bridged into the port.  f32, because
    hit == cold is a bitwise claim: it holds exactly when the shared
    pages hold the same numbers the cold prefill writes."""
    jm = jax_build(jax_reduced(jax_get_arch("tinyllama-1.1b"), **F32),
                   cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(override(reduced(get_arch("tinyllama-1.1b")), **F32),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def _engine(m, prefix_cache, chunk=None, batch=4, max_len=64, page=8,
            temp=0.0, num_pages=None, quantize=None, cls=StepEngine, **kw):
    return cls(m, batch_size=batch, max_len=max_len, temperature=temp,
               prefill_chunk=chunk, paged=True, page_size=page,
               num_pages=num_pages, quantize_kv=quantize,
               prefix_cache=prefix_cache, **kw)


def _toks(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def _first_token(eng, p, gens):
    """Step until ``gens`` have their first tokens (a chunked prompt is
    indexed only once its final chunk ran)."""
    while not all(g.tokens for g in gens):
        eng.step(p)


def _held(eng) -> dict:
    """page -> refcount of the engine's pool, for either package."""
    pool = eng._pages
    return dict(pool._ref if hasattr(pool, "_ref") else pool._held)


def _free(pool) -> list:
    return ([list(d) for d in pool._shards] if hasattr(pool, "_shards")
            else list(pool._free))


def _check_invariants(eng):
    """Refcount conservation after any event: free + |pages of live
    tables U cached pages| == allocatable, and each allocated page's
    refcount is the number of tables mapping it, plus the index's pin,
    plus one for each pending admission still holding it as the source
    of a copy not yet run."""
    held = [g.pages for g in eng.slots if g is not None and g.pages]
    table_pages = [p for pages in held for p in pages]
    index_pages = eng._prefix.pages()
    cow_pins = [ps.cow[0] for ps in eng._pending if ps.cow is not None]
    reachable = set(table_pages) | index_pages
    assert eng.free_pages() + len(reachable) == eng._pages.allocatable
    assert set(cow_pins) <= index_pages
    for pg in reachable:
        want = (table_pages.count(pg) + (pg in index_pages)
                + cow_pins.count(pg))
        assert eng._pages.refcount(pg) == want, (pg, want)
    for pg in range(1, eng._pages.total_pages):
        if pg not in reachable:
            assert eng._pages.refcount(pg) == 0, pg


# ---------------------------------------------------------------------------
# host side: refcounted pools and the index, call for call against JAX
# ---------------------------------------------------------------------------

def _pool_script(pool, rng_seed: int) -> list:
    """A seeded random sequence of take / acquire / release / restore /
    adopt (and, sharded, take on a named shard) -> every return, free
    list and refcount along the way.  Errors count as returns."""
    rng = np.random.default_rng(rng_seed)
    log, owned = [], []
    for _ in range(120):
        op = int(rng.integers(0, 6))
        try:
            if op == 0:
                n = int(rng.integers(1, 4))
                shard = (int(rng.integers(0, pool.num_shards))
                         if pool.num_shards > 1 and rng.random() < 0.5
                         else None)
                out = pool.take(n, shard=shard)
                owned.append(out)
            elif op == 1 and owned:
                out = pool.acquire(owned[int(rng.integers(len(owned)))])
                owned.append(list(owned[-1]))
            elif op == 2 and owned:
                out = pool.release(owned.pop(int(rng.integers(len(owned)))))
            elif op == 3 and owned:
                out = pool.restore(owned.pop(int(rng.integers(len(owned)))))
            elif op == 4:
                page = int(rng.integers(0, pool.total_pages + 1))
                out = pool.adopt(page)
                if out:
                    owned.append([page])
            else:
                out = (pool.blocked(int(rng.integers(1, 6))),
                       pool.route(2), pool.shard_free(0))
        except (ValueError, RuntimeError) as e:
            out = type(e).__name__
        log.append((op, out, _free(pool),
                    sorted(pool._ref.items() if hasattr(pool, "_ref")
                           else pool._held.items())))
    for bad in ([1], [pool.total_pages - 1]):
        try:
            pool.release(bad)
            pool.release(bad)
            pool.release(bad)
        except ValueError as e:
            log.append(type(e).__name__)
    return log


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_refcounts_match_jax(shards, seed):
    """Same returns, free-list order and refcounts as JAX's pools under a
    seeded random acquire / release / restore / adopt / take sequence;
    refcount underflow and acquiring a free page raise on both."""
    if shards == 1:
        mine, ref = PagePool(12), JaxPagePool(12)
    else:
        mine, ref = ShardedPagePool(16, shards), JaxShardedPool(16, shards)
    got = _pool_script(mine, seed)
    assert got == _pool_script(ref, seed)
    assert any(entry[0] == 4 and entry[1] is True for entry in got
               if isinstance(entry, tuple))          # an adopt succeeded


def test_pool_order_contract():
    """Restore puts pages reaching 0 at the FRONT in order, release at
    the BACK; a page another holder still references touches neither
    (the JAX suite's sequence)."""
    pool = PagePool(8)
    a = pool.take(3)
    pool.acquire([a[1]])
    pool.restore(a)
    assert pool.take(2) == [1, 3] and pool.refcount(2) == 1
    pool.release([2])
    assert pool.take(5) == [4, 5, 6, 7, 2]
    with pytest.raises(ValueError):
        pool.acquire([8])


def _index_script(cls) -> list:
    """Insert / lookup (peek or not) / evict / snapshot / restore over
    three token families sharing prefixes -> every return."""
    rng = np.random.default_rng(5)
    fams = [rng.integers(0, 5, 40) for _ in range(3)]
    fams[1][:8] = fams[0][:8]                    # a shared first page pair
    idx, log, next_page = cls(page_size=4), [], [1]

    def pages(n):
        out = list(range(next_page[0], next_page[0] + n))
        next_page[0] += n
        return out

    for step in range(60):
        f = fams[int(rng.integers(3))][:int(rng.integers(3, 41))]
        op = int(rng.integers(0, 4))
        if op == 0:
            log.append(idx.insert(f, pages(len(f) // 4 + 1)))
        elif op == 1:
            log.append(idx.lookup(f, peek=bool(rng.integers(2))))
        elif op == 2:
            keep = {int(x) for x in rng.integers(1, next_page[0] + 1, 3)}
            log.append(idx.evict_lru(int(rng.integers(1, 4)),
                                     lambda p, k=keep: p not in k))
        else:
            snap = idx.snapshot()
            taken = {int(x) for x in rng.integers(1, next_page[0] + 1, 4)}
            fresh = cls(page_size=4)
            log.append((fresh.restore(snap, lambda p, t=taken: p not in t),
                        sorted(fresh.pages())))
        log.append(sorted(idx.pages()))
    int8 = cls(page_size=4, namespace="int8")
    int8.insert(fams[0], [90, 91])
    log.append((idx.lookup(fams[0][:8]), int8.lookup(fams[0][:8])))
    with pytest.raises(ValueError):
        int8.restore(idx.snapshot(), lambda p: True)
    idx.clear()
    log.append(idx.pages())
    return log


def test_prefix_index_matches_jax():
    """Whole-page lookup, first-writer-wins insert, LRU-leaf eviction
    under a pin, snapshot/restore with lost pages (their subtrees drop)
    and namespaces: the same pages as JAX's index, step for step."""
    assert _index_script(PrefixIndex) == _index_script(JaxPrefixIndex)


# ---------------------------------------------------------------------------
# inside the port: prefix hit == cold admission, bitwise
# ---------------------------------------------------------------------------

def _cold_and_hit(m, p, prompt, donor, steps=6, seeds=None, draws=None,
                  **kw):
    """The prompt admitted cold, and admitted again after ``donor``
    (then itself) filled the cache -> (cold stream, hit stream, hit
    engine).  ``draws``: a sampler class, one instance per engine."""
    if draws is not None:
        kw["sampler"] = draws("cpu")
    cold = _engine(m, False, **kw)
    cold.admit(p, prompt, max_new=steps, seeds=seeds)
    ref = cold.drain(p)[0].tokens
    if draws is not None:
        kw["sampler"] = draws("cpu")
    eng = _engine(m, True, **kw)
    eng.admit(p, donor, max_new=steps, seeds=seeds)
    eng.drain(p)
    gens = eng.admit(p, prompt, max_new=steps, seeds=seeds)
    eng.drain(p)
    return ref, gens[0].tokens, eng


@pytest.mark.parametrize("chunk,quantize", [(None, None), (16, None),
                                            (16, "int8")])
@pytest.mark.parametrize("seeded", [False, True])
def test_hit_stream_matches_cold(pair, seeded, chunk, quantize):
    """A full-prefix hit (4 pages mapped read-only, the fifth copied on
    write, the last token recomputed through the verify route, on a
    one-shot engine too) emits bitwise the cold admission's tokens.  A
    one-shot int8 engine is the exception, in JAX as here: its cold
    first token reads the prompt's own full-precision k/v, a hit's the
    int8 codes (``test_one_shot_int8_hit_matches_jax``)."""
    tm, tp, _, _ = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 3)             # 5 whole pages
    ref, got, eng = _cold_and_hit(
        tm, tp, prompt, prompt, seeds=[11] if seeded else None,
        temp=0.8 if seeded else 0.0, chunk=chunk, quantize=quantize)
    assert got == ref
    assert (eng.stats["prefix_hits"], eng.stats["prefix_pages_mapped"],
            eng.stats["cow_copies"]) == (1, 4, 1)
    _check_invariants(eng)


@pytest.mark.parametrize("seeded", [False, True])
def test_one_shot_int8_hit_matches_jax(pair, seeded):
    """One-shot int8: a cold admission samples its first token from the
    prefill's full-precision k/v, a hit's suffix from the pool's int8
    codes, so hit and cold part by int8 rounding -- in the JAX engine as
    in the port (this prompt's greedy streams differ from the first
    token on in both).  The port's cold and hit streams each equal the
    JAX engine's (its gumbel fields injected)."""
    from test_torch_serve import JaxDraws
    tm, tp, jm, jp = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 3)
    kw = dict(seeds=[11] if seeded else None, temp=0.8 if seeded else 0.0,
              quantize="int8")
    got = _cold_and_hit(tm, tp, prompt, prompt, draws=JaxDraws, **kw)
    want = _cold_and_hit(jm, jp, prompt, prompt, cls=JaxStepEngine, **kw)
    assert got[:2] == tuple(list(t) for t in want[:2])
    assert got[2].stats["cow_copies"] == want[2].stats["cow_copies"] == 1
    if not seeded:
        assert got[0] != got[1]


@pytest.mark.parametrize("chunk", [None, 16])
def test_partial_divergence_matches_cold(pair, chunk):
    """Divergence mid-prompt: the two shared whole pages map, the suffix
    prefills from token 16, no copy."""
    tm, tp, _, _ = pair
    base = _toks(tm.cfg.vocab_size, 37, 4)
    var = base.copy()
    var[0, 20:] = (var[0, 20:] + 1) % tm.cfg.vocab_size
    ref, got, eng = _cold_and_hit(tm, tp, var, base, chunk=chunk)
    assert got == ref
    assert eng.stats["prefix_pages_mapped"] == 2
    assert eng.stats["cow_copies"] == 0


@pytest.mark.parametrize("chunk", [None, 16])
def test_hits_match_jax_engine(pair, chunk):
    """Greedy: a donor, then a full-prefix hit and a partial one while
    the donor still decodes -- the port's streams, counters, page tables
    and free-list after every admission equal the JAX engine's."""
    tm, tp, jm, jp = pair
    V = tm.cfg.vocab_size
    base = _toks(V, 40, 6)
    part = base[:, :37].copy()
    part[0, 20:] = (part[0, 20:] + 1) % V
    seen = []
    for m, p, cls in ((tm, tp, StepEngine), (jm, jp, JaxStepEngine)):
        eng = _engine(m, True, chunk=chunk, cls=cls)
        gens, log = [], []
        for toks in (base, base, part):
            gens += eng.admit(p, toks, max_new=6)
            _first_token(eng, p, gens)
            log.append((np.asarray(eng.state.table).tolist(),
                        _free(eng._pages), sorted(_held(eng).items())))
            eng.step(p)
        eng.drain(p)
        log.append([list(g.tokens) for g in gens])
        log.append({k: eng.stats[k] for k in (
            "prefix_hits", "prefix_pages_mapped", "cow_copies",
            "cache_evictions")})
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[0][-1]["prefix_hits"] == 2


def test_multistep_hits_bitwise_single_step(pair):
    """``multi_step=4`` with hits (CoW and partial) is bitwise the
    single-step prefix engine, and both equal the cold streams."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size
    base = _toks(V, 40, 7)
    part = base[:, :30].copy()
    part[0, 25:] = (part[0, 25:] + 1) % V
    traffic = [base, _toks(V, 12, 8), base, part]
    out = {}
    for ms, pc in ((1, False), (1, True), (4, True)):
        eng = _engine(tm, pc, temp=0.8, multi_step=ms)
        gens = []
        for i, t in enumerate(traffic):
            gens += eng.admit(tp, t, max_new=7, seeds=[i])
            eng.step(tp)
        eng.drain(tp)
        out[(ms, pc)] = [g.tokens for g in gens]
        if pc:
            assert eng.stats["prefix_hits"] == 2
    assert out[(4, True)] == out[(1, True)] == out[(1, False)]


# ---------------------------------------------------------------------------
# copy-on-write, eviction, the deferred copy's pin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cow_leaves_donor_pages_untouched(pair, quantize):
    """The hit's last-token recompute and its decode writes land in the
    copy: every indexed donor page, on every leaf of every layer (int8
    codes and scales), is bitwise what it was before the hit."""
    tm, tp, _, _ = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 9)
    eng = _engine(tm, True, quantize=quantize)
    eng.admit(tp, prompt, max_new=6)
    eng.drain(tp)
    donors = torch.as_tensor(sorted(eng._prefix.pages()))
    assert len(donors) == 5
    before = [t[donors].clone() for c in eng.state.caches for t in c
              if t is not None]
    eng.admit(tp, prompt, max_new=6)
    eng.drain(tp)
    after = [t[donors] for c in eng.state.caches for t in c
             if t is not None]
    assert eng.stats["cow_copies"] == 1
    assert len(before) == (4 if quantize else 2) * tm.cfg.num_layers
    assert all(torch.equal(b, a) for b, a in zip(before, after))


def test_copy_cache_pages_is_a_byte_copy(pair):
    tm = pair[0]
    for q in (False, True):
        caches = tm.init_page_pool(6, 4, quantized=q)
        for c in caches:
            for t in c:
                if t is not None:
                    t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
        want = [[None if t is None else t.clone() for t in c]
                for c in caches]
        tm.copy_cache_pages(caches, [1, 4], [2, 5])
        for c, w in zip(caches, want):
            for t, u in zip(c, w):
                if t is None:
                    continue
                assert torch.equal(t[[2, 5]], u[[1, 4]])
                assert torch.equal(t[[0, 1, 3, 4]], u[[0, 1, 3, 4]])


def test_cached_pages_evicted_lru_under_pressure(pair):
    """When free pages cannot cover an admission, refcount-1 cached pages
    go LRU-first (A's chain before B's); a full cache empties for a
    fresh admission; every page comes back."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size
    eng = _engine(tm, True, batch=2, max_len=32, num_pages=9)
    a, b, c = (_toks(V, 24, s) for s in (10, 11, 12))
    for t in (a, b):
        eng.admit(tp, t, max_new=4)
        eng.drain(tp)
    assert eng.free_pages() == 2
    assert eng.can_admit(c, 4)                  # reclaims 2 of A's pages
    eng.admit(tp, c, max_new=4)
    eng.drain(tp)
    assert eng.stats["cache_evictions"] >= 2
    assert len(eng._prefix.lookup(a[0])) < 3
    assert len(eng._prefix.lookup(b[0])) == 3
    assert eng.free_pages() + len(eng._prefix.pages()) == 8
    _check_invariants(eng)
    full = _engine(tm, True, batch=1, max_len=32, num_pages=5)
    full.admit(tp, a, max_new=4)
    full.drain(tp)
    assert full.can_admit(c, 4)
    full.admit(tp, c, max_new=4)
    full.drain(tp)
    assert full.stats["cache_evictions"] >= 2


def test_deferred_cow_source_survives_reclaim(pair):
    """A chunked hit copies its boundary page at its first chunk tick;
    until then the source is pinned, so a probe under page pressure must
    not evict (and recycle) it, and the hit's stream stays the cold
    one."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size
    kw = dict(chunk=8, batch=3, max_len=32, page=8, num_pages=10)
    F = _toks(V, 24, 20)
    cold = _engine(tm, False, **kw)
    cold.admit(tp, F, max_new=4)
    ref = cold.drain(tp)[0].tokens
    eng = _engine(tm, True, **kw)
    eng.admit(tp, F, max_new=4)
    eng.drain(tp)
    h2 = eng._prefix.lookup(F[0], peek=True)[2]
    eng.admit(tp, _toks(V, 24, 21), max_new=4)   # queues ahead of the hit
    hit = eng.admit(tp, F, max_new=4)[0]
    assert eng._pages.refcount(h2) == 2           # index + the copy's pin
    assert eng.free_pages() == 0
    assert not eng.can_admit(_toks(V, 4, 22), 4)
    assert eng.stats["cache_evictions"] == 0 and h2 in eng._prefix.pages()
    _check_invariants(eng)
    eng.drain(tp)
    assert hit.tokens == ref
    assert eng._pages.refcount(h2) == 1           # the pin dropped
    _check_invariants(eng)


# ---------------------------------------------------------------------------
# a seeded fuzz, event by event against the JAX engine
# ---------------------------------------------------------------------------

def _fuzz(m, p, vocab, cls, check=None):
    """40 seeded events of admit (a family's prefix, the tail diverged
    half the time) / step / drain on a chunked prefix engine -> per
    event: the page tables, free-list, refcounts and finished streams."""
    rng = np.random.default_rng(0)
    eng = _engine(m, True, chunk=8, batch=3, max_len=32, page=4,
                  num_pages=16, cls=cls)
    fams = [_toks(vocab, 28, 100 + i) for i in range(3)]
    log = []
    for _ in range(40):
        act, streams = rng.integers(0, 3), []
        if act == 0 and eng.free_slots() and not eng.pending_slots():
            fam = fams[rng.integers(0, len(fams))]
            toks = fam[:, :int(rng.integers(4, 25))].copy()
            if rng.random() < 0.5:
                toks[0, -1] = int((toks[0, -1] + 1) % vocab)
            if eng.can_admit(toks, 3):
                eng.admit(p, toks, max_new=3)
        elif act == 1 and eng.live_slots():
            streams = [tuple(g.tokens) for g in eng.step(p)]
        elif act == 2 and eng.live_slots():
            streams = [tuple(g.tokens) for g in eng.drain(p)]
        if check is not None:
            check(eng)
        log.append((np.asarray(eng.state.table).tolist(), _free(eng._pages),
                    sorted(_held(eng).items()), sorted(eng._prefix.pages()),
                    streams))
    log.append({k: eng.stats[k] for k in (
        "prefix_hits", "prefix_pages_mapped", "cow_copies",
        "cache_evictions")})
    return log


def test_fuzz_conservation_and_tables_match_jax(pair):
    """Refcount conservation after every event, and the page tables,
    free-list, refcounts, cached pages and streams equal the JAX
    engine's event by event."""
    tm, tp, jm, jp = pair
    V = tm.cfg.vocab_size
    got = _fuzz(tm, tp, V, StepEngine, check=_check_invariants)
    assert got[-1]["prefix_hits"] > 0
    assert got == _fuzz(jm, jp, V, JaxStepEngine)


# ---------------------------------------------------------------------------
# shards, reset, export/restore, shared banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_read", [False, True])
def test_sharded_hit_routed_and_bitwise(pair, local_read):
    """On 4 shards a hit's fresh pages (the CoW destination first) land
    on the shard of its anchor page, and its stream is the unsharded
    cold stream; under ``local_read`` too (greedy, where the merge's
    rounding leaves the tokens as they are here)."""
    tm, tp, _, _ = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 13)
    cold = _engine(tm, False)
    cold.admit(tp, prompt, max_new=6)
    ref = cold.drain(tp)[0].tokens
    kw = (dict(mesh=Mesh(("cpu",) * 4), local_read=True) if local_read
          else dict(shards=4))
    eng = _engine(tm, True, **kw)
    eng.admit(tp, _toks(tm.cfg.vocab_size, 20, 14), max_new=6)
    eng.admit(tp, prompt, max_new=6)
    eng.drain(tp)
    plan = eng._prefix_plan(prompt, 6, peek=True)
    anchor = eng._pages.shard_of(plan[1])
    g = eng.admit(tp, prompt, max_new=6)[0]
    fresh = g.pages[len(plan[0]):]
    assert {eng._pages.shard_of(p) for p in fresh} == {anchor}
    eng.drain(tp)
    assert g.tokens == ref
    assert eng.stats["cow_copies"] == 1
    _check_invariants(eng)


def test_reset_keep_prefix_and_export_restore(pair):
    """``reset(keep_prefix=True)`` re-adopts the cached pages, so the
    next admission hits and equals the cold stream; a plain reset forgets
    them; an exported snapshot restores while its pages are free, and a
    node whose page was handed out since drops with its subtree."""
    tm, tp, _, _ = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 15)
    ref, _, eng = _cold_and_hit(tm, tp, prompt, prompt)
    cached = eng._prefix.pages()
    snap = eng.export_prefix_index()
    json.dumps(snap)
    eng.reset(keep_prefix=True)
    assert eng._prefix.pages() == cached
    assert all(eng._pages.refcount(p) == 1 for p in cached)
    g = eng.admit(tp, prompt, max_new=6)[0]
    eng.drain(tp)
    assert g.tokens == ref and eng.stats["prefix_hits"] == 2
    eng.reset()
    assert not eng._prefix.pages()
    assert eng.free_pages() == eng._pages.allocatable
    assert eng.restore_prefix_index(snap) == sorted(cached)
    g = eng.admit(tp, prompt, max_new=6)[0]
    eng.drain(tp)
    assert g.tokens == ref and eng.stats["prefix_hits"] == 3
    _check_invariants(eng)
    other = _engine(tm, True)
    other.admit(tp, _toks(tm.cfg.vocab_size, 7, 16), max_new=2)
    assert 1 in cached and other._pages.refcount(1) == 1
    assert other.restore_prefix_index(snap) == []    # root page taken
    assert not other._prefix.pages()
    with pytest.raises(ValueError, match="prefix_cache is off"):
        _engine(tm, False).restore_prefix_index(snap)


def test_shared_bank_serves_two_engines():
    """One ``SharedBank`` behind a batch-4 and a batch-2 engine of one
    context: a prompt the first indexed is a hit in the second, both
    hold the same cache tensors, both equal the cold stream, and a reset
    of one releases only its own rows."""
    server, cfgs = launch.build_server(["tinyllama-1.1b"], 2, 64,
                                       arch_overrides=F32, device="cpu")
    try:
        name = "tinyllama-1.1b"
        params = server._served[name].weights_fn()
        prompt = _toks(cfgs[name].vocab_size, 40, 17)
        a = server.step_engine(name, 4, paged=True, page_size=8,
                               prefix_cache=True, share_bank=True)
        b = server.step_engine(name, 2, paged=True, page_size=8,
                               prefix_cache=True, share_bank=True)
        bank = server.shared_bank(name, 8)
        assert a._pages is b._pages is bank.pool
        assert a._prefix is b._prefix is bank.index
        assert a.state.caches is b.state.caches is bank.caches
        assert bank.pool.total_pages == 4 * 8 + 1
        cold = StepEngine(a.model, batch_size=2, max_len=64, paged=True,
                          page_size=8)
        cold.admit(params, prompt, max_new=6)
        ref = cold.drain(params)[0].tokens
        a.admit(params, prompt, max_new=6)
        a.drain(params)
        held = b.admit(params, _toks(cfgs[name].vocab_size, 20, 18),
                       max_new=6)[0].pages
        g = b.admit(params, prompt, max_new=6)[0]
        b.drain(params)
        assert g.tokens == ref and b.stats["prefix_hits"] == 1
        live = a.admit(params, prompt, max_new=6)[0].pages   # a's hit
        own = b.admit(params, _toks(cfgs[name].vocab_size, 12, 19),
                      max_new=6)[0].pages
        cached = bank.index.pages()
        b.reset()                          # releases b's row alone
        assert all(bank.pool.refcount(p) == (p in cached) for p in own)
        assert all(bank.pool.refcount(p) >= 1 for p in live)
        assert set(held) & cached and a.state.caches is bank.caches
        a.reset()
        assert all(bank.pool.refcount(p) == (p in cached) for p in live)
        assert bank.pool.free_pages() + len(cached) \
            == bank.pool.allocatable
        with pytest.raises(ValueError, match="shard"):
            StepEngine(a.model, batch_size=2, max_len=64, paged=True,
                       page_size=8, bank=bank, shards=4)
        with pytest.raises(ValueError, match="num_pages"):
            server.shared_bank("x", 8)
    finally:
        server.shutdown()


def test_bank_reset_releases_a_pending_copy_pin(pair):
    """A bank engine reset while a chunked hit still waits for its
    boundary copy releases the copy source's pin with the row's pages
    (the JAX engine's bank reset drops the pending admission without it,
    which leaves the source pinned for good): afterwards every cached
    page is back at refcount 1, evictable."""
    from repro_torch.serve.pool import SharedBank
    tm, tp, _, _ = pair
    prompt = _toks(tm.cfg.vocab_size, 40, 23)
    bank = SharedBank(PagePool(4 * 8 + 1))
    eng = _engine(tm, True, chunk=16, bank=bank)
    eng.admit(tp, prompt, max_new=6)
    eng.drain(tp)
    eng.admit(tp, prompt, max_new=6)           # pending, cow = (page 5, .)
    (ps,) = eng._pending
    src = ps.cow[0]
    assert bank.pool.refcount(src) == 2
    _check_invariants(eng)
    eng.reset()
    assert not eng._pending and bank.pool.refcount(src) == 1
    assert all(bank.pool.refcount(p) == 1 for p in bank.index.pages())
    assert bank.pool.free_pages() + len(bank.index.pages()) \
        == bank.pool.allocatable


# ---------------------------------------------------------------------------
# schedulers and launcher
# ---------------------------------------------------------------------------

def _shared_prefix_traffic(names, cfgs, n, seed, head=32, tail=8):
    rng = np.random.default_rng(seed)
    shared = {nm: rng.integers(0, cfgs[nm].vocab_size, (1, head))
              for nm in names}
    return [(names[r % len(names)], np.concatenate(
        [shared[names[r % len(names)]],
         rng.integers(0, cfgs[names[r % len(names)]].vocab_size,
                      (1, tail))], axis=1)) for r in range(n)]


@pytest.mark.parametrize("names,slots,share", [
    (["supersub-super", "supersub-sub"], 2, False),
    (["supersub-super", "supersub-sub", "tinyllama-1.1b"], 2, True)])
def test_scheduler_prefix_cache_end_to_end(names, slots, share):
    """``ContinuousScheduler(prefix_cache=True)``: shared-prefix traffic
    gives the run-to-completion outputs and the snapshot carries the
    sharing counters.  With 3 contexts on 2 weight slots contexts are
    evicted and reloaded between their requests: the bank and index
    belong to the step engine, so hits after a reload still equal the
    cold streams (here over a shared bank)."""
    server, cfgs = launch.build_server(names, slots, 64,
                                       arch_overrides=F32, device="cpu")
    try:
        reqs = _shared_prefix_traffic(names, cfgs, 2 * len(names) + 2, 0)
        with ContinuousScheduler(server, batch_size=4, paged=True,
                                 page_size=16, prefix_cache=True,
                                 share_bank=share) as sched:
            outs = []
            for n, t in reqs:                  # one at a time: each
                outs.append(sched.submit(n, t, steps=4).result(120))
            snap = sched.snapshot()            # context reloads between
        loads = server.engine.stats["loads"]
        for (name, toks), out in zip(reqs, outs):
            np.testing.assert_array_equal(
                out, server.serve_batch(name, toks, steps=4))
        assert snap["prefix_hits"] == len(reqs) - len(names)
        assert snap["prefix_pages_mapped"] == 2 * snap["prefix_hits"]
        if len(names) > slots:
            assert loads > len(names)          # evicted and reloaded
        for key, eng in server._step_engines.items():
            assert key.prefix_cache and key.shared_bank == share
        with pytest.raises(ValueError, match="paged"):
            ContinuousScheduler(server, batch_size=4, prefix_cache=True)
        with pytest.raises(ValueError, match="paged"):
            ContinuousScheduler(server, batch_size=4, share_bank=True)
    finally:
        server.shutdown()


def test_launcher_prefix_cache(capsys):
    rc = launch.main(["--platform", "cpu", "--mode", "continuous",
                      "--paged", "--page-size", "8", "--prefix-cache",
                      "--requests", "4", "--steps", "2", "--seq", "16",
                      "--batch", "1"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    for k in ("prefix_hits", "prefix_pages_mapped", "cow_copies",
              "cache_evictions"):
        assert k in rep
    with pytest.raises(SystemExit) as e:
        launch.main(["--platform", "cpu", "--prefix-cache"])
    assert e.value.code == 2
    assert "requires --paged" in capsys.readouterr().err


def test_engine_key_and_validation(pair):
    tm = pair[0]
    k = EngineKey(name="a", batch_size=4, page_size=8, prefix_cache=True,
                  shared_bank=True)
    assert k.prefix_cache and k.shared_bank and k.multi_step == 1
    assert k != EngineKey(name="a", batch_size=4, page_size=8)
    name, bsz, *_ = k
    assert (name, bsz) == ("a", 4)
    with pytest.raises(ValueError, match="paged"):
        StepEngine(tm, batch_size=2, max_len=64, prefix_cache=True)
    eng = _engine(tm, True, quantize="int8")
    assert eng._prefix.namespace == "int8"
