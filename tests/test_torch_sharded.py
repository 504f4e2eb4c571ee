"""The sharded page bank in the port: kernel B5's plain version
(``paged_decode_partial``), ``ShardedPagePool``, per-shard local reads
(``attention_*_pages_sharded``) and the sharded step engines, against
the JAX package's, on the CPU in float32.

The JAX local-read path runs under ``shard_map`` on a real mesh of four
devices, which JAX builds only when the host platform is forced to four
devices before it starts.  So one module fixture runs this file as a
subprocess (``python tests/test_torch_sharded.py --jax-reference
OUT.npz``) with ``XLA_FLAGS`` in its environment; it writes JAX's
logits to an ``.npz`` that the tests read.  Logits compare at
``atol=5e-4, rtol=1e-3`` (``test_torch_model.py``'s tolerance), the B5
plain version at ``atol=2e-5`` (``test_kernels.py``'s float32 one),
streams token for token."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_partial as jax_partial)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_partial_reference as jax_partial_ref)
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro.serve.pool import ShardedPagePool as JaxShardedPool  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.distributed.mesh import Mesh, shard_count  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_partial, paged_decode_reference)
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import EngineKey, StepEngine  # noqa: E402
from repro_torch.serve.pool import ShardedPagePool  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from test_torch_serve import (F32, JaxDraws, _prompts,  # noqa: E402
                              _run_stream)

ATOL = 2e-5                 # float32 kernels, as test_kernels.py:_tol
NSH = 4                     # shards
PAGE, PPR = 8, 8            # page size, pages per row (max_len 64)
L = 8                       # pages per shard: a bank of NSH * L pages
PROMPTS = (20, 37, 5)       # one prefill per row
STEPS = 4                   # teacher-forced decode steps
KB = 8                      # verify block
# each row's pages (global ids; local page 0 of every shard, ids 0, 8,
# 16, 24, is reserved): row 0 spans shards 0-3, row 1 lives on shard 2,
# row 2 on shard 3, so shards 0 and 1 own nothing of rows 1 and 2
ROW_PAGES = ([1, 9, 17, 25, 2, 10], [18, 19, 20, 21, 22, 23], [26, 27])


def _close(got, want, atol=5e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _jax_pair():
    """(JAX LM, JAX params): reduced tinyllama (G=2) in float32."""
    jm = jax_build(jax_reduced(jax_get_arch("tinyllama-1.1b"), **F32),
                   cache_dtype=jnp.float32)
    return jm, jm.init(jax.random.key(0))


def _tables():
    t = np.zeros((len(PROMPTS), PPR), np.int32)
    for b, pages in enumerate(ROW_PAGES):
        t[b, :len(pages)] = pages
    return t


def _inputs():
    """Prompts, decode tokens and the verify block, from a seed."""
    rng = np.random.default_rng(11)
    V = 256
    prompts = [rng.integers(0, V, (1, n)).astype(np.int32) for n in PROMPTS]
    dec = rng.integers(0, V, (STEPS, len(PROMPTS), 1)).astype(np.int32)
    blk = rng.integers(0, V, (len(PROMPTS), KB)).astype(np.int32)
    return prompts, dec, blk


def _run_model(m, p, pool, insert, decode, verify, shard):
    """Prefill each row, insert it through its table, then STEPS decode
    steps and one KB-token verify block, all teacher-forced ->
    {"decode": (STEPS, B, V), "verify": (B, KB, V)} numpy logits."""
    prompts, dec, blk = _inputs()
    tables = _tables()
    for b, pr in enumerate(prompts):
        _, rows = m.prefill(p, pr, PPR * PAGE)
        pool = insert(pool, rows, tables[b:b + 1])
    pos = np.asarray(PROMPTS, np.int32)
    out = []
    for i in range(STEPS):
        logits, pool = decode(pool, dec[i], pos + i, tables, shard)
        out.append(np.asarray(logits[:, 0], np.float32))
    logits, _ = verify(pool, blk, pos + STEPS, tables, shard)
    return {"decode": np.stack(out), "verify": np.asarray(logits,
                                                          np.float32)}


def _jax_logits(jm, jp, quantized, shard):
    j = jnp.asarray
    return _run_model(
        jm, jp, jm.init_page_pool(NSH * L, PAGE, quantized=quantized),
        jm.insert_cache_pages,
        lambda pool, t, pos, tab, sh: jm.decode_step_pages(
            jp, pool, j(t), j(pos), j(tab), shard=sh),
        lambda pool, t, pos, tab, sh: jm.verify_step_pages(
            jp, pool, j(t), j(pos), j(tab), shard=sh),
        shard)


def _port_logits(tm, tp, quantized, shard):
    t = torch.from_numpy
    return _run_model(
        tm, tp, tm.init_page_pool(NSH * L, PAGE, quantized=quantized),
        lambda pool, rows, tab: tm.insert_cache_pages(pool, rows, t(tab)),
        lambda pool, tok, pos, tab, sh: tm.decode_step_pages(
            tp, pool, tok, t(pos), t(tab), shard=sh),
        lambda pool, tok, pos, tab, sh: tm.verify_step_pages(
            tp, pool, tok, t(pos), t(tab), shard=sh),
        shard)


def jax_reference(out_path: str) -> None:
    """Run by the module fixture in a subprocess with four forced host
    devices: JAX's local-read logits (fp and int8 banks) under a real
    four-device mesh, written to ``out_path``."""
    from repro.distributed.mesh import make_mesh
    assert jax.device_count() == NSH, jax.device_count()
    jm, jp = _jax_pair()
    shard = (make_mesh((NSH,), ("model",)), "model")
    res = {}
    for quantized in (False, True):
        got = _jax_logits(jm, jp, quantized, shard)
        for k, v in got.items():
            res[f"{k}_{'int8' if quantized else 'fp'}"] = v
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_local_read(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(root / "src"), os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, __file__, "--jax-reference", str(out)],
                   env=env, check=True, timeout=600, cwd=root)
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def pair():
    """(port LM, port params, JAX LM, JAX params) on the same weights."""
    jm, jp = _jax_pair()
    tm = build_model(override(reduced(get_arch("tinyllama-1.1b")), **F32),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def _cpu_mesh(n=NSH):
    return Mesh(("cpu",) * n)


# ---------------------------------------------------------------------------
# kernel B5: one shard's partial, plain version against JAX
# ---------------------------------------------------------------------------

def _partial_case(quantized, seed=0):
    """q (B, H, hd), a 4-shard bank (NP = 4 * Lp pages of 16), global
    tables with rows spread over the shards, positions; int8 codes and
    scales when ``quantized``."""
    rng = np.random.default_rng(seed)
    B, H, Hkv, hd, page, P, Lp = 5, 8, 2, 32, 16, 4, 5
    NP = NSH * Lp
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    shape = (NP, Hkv, page, hd)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        sc = [(rng.random((NP, Hkv, page)) / 64).astype(np.float32)
              for _ in range(2)]
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        sc = [None, None]
    # row 4 lives on shard 1 only: every other shard owns nothing of it
    table = np.asarray([[1, 6, 11, 16], [2, 3, 0, 0], [7, 12, 17, 8],
                        [13, 18, 4, 9], [6, 7, 8, 0]], np.int32)
    pos = np.asarray([50, 20, 63, 33, 40], np.int32)
    return q, k, v, sc, table, pos, Lp


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shard", range(NSH))
def test_partial_plain_matches_jax(quantized, shard):
    q, k, v, (ks, vs), table, pos, Lp = _partial_case(quantized)
    sl = slice(shard * Lp, (shard + 1) * Lp)
    base = shard * Lp
    tsc = {} if ks is None else dict(k_scale=torch.from_numpy(ks[sl]),
                                     v_scale=torch.from_numpy(vs[sl]))
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks[sl]),
                                     v_scale=jnp.asarray(vs[sl]))
    kernels.reset_launch_counts()
    got = paged_decode_partial(
        torch.from_numpy(q), torch.from_numpy(k[sl]),
        torch.from_numpy(v[sl]), torch.from_numpy(table),
        torch.from_numpy(pos), base, **tsc)
    assert paged_decode_partial.launches == 0        # CPU: plain version
    assert paged_decode_partial.launches_int8 == 0
    args = (jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]),
            jnp.asarray(table), jnp.asarray(pos), base)
    for want in (jax_partial(*args, interpret=True, **jsc),
                 jax_partial_ref(*args, **jsc)):
        for g, w in zip(got, want):
            _close(g, w, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
def test_partial_row_owning_nothing_is_exact(quantized):
    """Row 4's pages all lie on shard 1: on every other shard it comes
    back as exactly (0, -1e30, 0), so the merge's exp(m - pmax(m)) is 0
    and not NaN."""
    q, k, v, (ks, vs), table, pos, Lp = _partial_case(quantized)
    for shard in (0, 2, 3):
        sl = slice(shard * Lp, (shard + 1) * Lp)
        sc = {} if ks is None else dict(k_scale=torch.from_numpy(ks[sl]),
                                        v_scale=torch.from_numpy(vs[sl]))
        acc, m, l = paged_decode_partial(
            torch.from_numpy(q), torch.from_numpy(k[sl]),
            torch.from_numpy(v[sl]), torch.from_numpy(table),
            torch.from_numpy(pos), shard * Lp, **sc)
        assert torch.equal(acc[4], torch.zeros_like(acc[4]))
        assert torch.equal(l[4], torch.zeros_like(l[4]))
        assert torch.equal(m[4], torch.full_like(m[4], TL.NEG_INF))


@pytest.mark.parametrize("quantized", [False, True])
def test_merged_partials_equal_paged_decode(quantized):
    q, k, v, (ks, vs), table, pos, Lp = _partial_case(quantized)
    t = torch.from_numpy
    accs, ms, ls = [], [], []
    for shard in range(NSH):
        sl = slice(shard * Lp, (shard + 1) * Lp)
        sc = {} if ks is None else dict(k_scale=t(ks[sl]),
                                        v_scale=t(vs[sl]))
        acc, m, l = paged_decode_partial(t(q), t(k[sl]), t(v[sl]),
                                         t(table), t(pos), shard * Lp, **sc)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    acc, _, l = TL._psum_partials(accs, ms, ls)
    out = (acc / l[..., None]).reshape(q.shape)
    sc = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    want = paged_decode_reference(t(q), t(k), t(v), t(table), t(pos), **sc)
    _close(out, want, atol=ATOL, rtol=1e-4)


# ---------------------------------------------------------------------------
# ShardedPagePool against JAX's
# ---------------------------------------------------------------------------

def test_sharded_pool_matches_jax():
    """The same take / release / restore / route sequence gives the same
    page ids, block reasons and free counts as JAX's pool."""
    def script(pool):
        log = [pool.allocatable, pool.per_shard_allocatable,
               pool.free_pages(), [pool.shard_of(p) for p in (1, 3, 7, 11)],
               pool.route(1)]
        a = pool.take(2)
        log += [a, pool.route(1)]
        b = pool.take(1)
        big = pool.take(5)
        log += [b, big, pool.free_pages(), pool.blocked(1)]
        pool.release(a)
        log += [pool.blocked(2), pool.blocked(3)]
        pool.release(big[:2])
        log += [pool.blocked_rows(2, 2), pool.blocked_rows(1, 5),
                pool.route(5), pool.free_pages()]
        c = pool.take(2)
        pool.restore(c)
        log += [c, pool.take(2), pool.least_loaded()]
        pool.reset()
        log += [pool.free_pages(), pool.take(3), pool.take(3)]
        return log

    assert script(ShardedPagePool(12, 4)) == script(JaxShardedPool(12, 4))
    for bad in ((10, 4), (4, 4), (8, 0)):
        with pytest.raises(ValueError):
            ShardedPagePool(*bad)


def test_sharded_pool_gauges():
    from repro_torch.serve.telemetry import Telemetry
    tm = Telemetry()
    pool = ShardedPagePool(12, 2, telemetry=tm)   # 5 allocatable a shard
    a = pool.take(4)                        # shard 0
    pool.take(3)                            # shard 1, the least loaded
    pool.release(a)
    assert pool.take(7) == [5, 1, 2, 3, 10, 4, 11]   # > 5: spans, 5 + 2
    snap = tm.registry.snapshot()
    assert snap["free_pages"] == 0
    assert snap["shard.0.free_pages"] == snap["shard.1.free_pages"] == 0
    assert snap["shard.0.admitted_pages"] == 4 + 5
    assert snap["shard.1.admitted_pages"] == 3 + 2


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("chunk", [None, 8])
def test_logical_shards_bitwise_and_match_jax(pair, temperature, chunk):
    """``shards=4`` with no mesh changes only page ids: streams bitwise
    those of the port's unsharded paged engine, and the JAX engine's
    ``StepEngine(shards=4)`` (its gumbel fields injected)."""
    tm, tp, jm, jp = pair
    prompts = _prompts(tm.cfg.vocab_size)
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=64, temperature=temperature,
              paged=True, page_size=16, prefill_chunk=chunk)
    ref = _run_stream(StepEngine(tm, sampler=JaxDraws("cpu"), **kw), tp,
                      prompts, 6, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), shards=4, **kw)
    got = _run_stream(eng, tp, prompts, 6, seeds)
    assert got == ref
    assert eng._pages.num_shards == 4
    assert eng.free_pages() == eng._pages.allocatable
    want = _run_stream(JaxStepEngine(jm, shards=4, **kw), jp, prompts, 6,
                       seeds)
    assert got == [list(w) for w in want]


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("quantize_kv", [None, "int8"])
def test_local_read_streams_equal_unsharded(pair, chunk, quantize_kv):
    """``mesh=Mesh(("cpu",) * 4), local_read=True``: every shard reads
    and writes only its slice; the greedy streams equal the unsharded
    engine's (JAX's sharded worker, checks 4 and 5), one-shot and
    chunked, and with an int8 bank."""
    tm, tp, _, _ = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(12, 40))
    kw = dict(batch_size=2, max_len=64, paged=True, page_size=16,
              prefill_chunk=chunk, quantize_kv=quantize_kv)
    ref = _run_stream(StepEngine(tm, **kw), tp, prompts, 6, [None, None])
    eng = StepEngine(tm, mesh=_cpu_mesh(), local_read=True, **kw)
    assert eng.num_shards == 4 and eng.local_read
    kernels.reset_launch_counts()
    assert _run_stream(eng, tp, prompts, 6, [None, None]) == ref
    assert eng.free_pages() == eng._pages.allocatable


@pytest.mark.parametrize("quantized", [False, True])
def test_local_read_logits_match_jax_mesh(pair, jax_local_read, quantized):
    """Decode and verify logits under per-shard local reads: the port on
    four logical CPU shards against JAX's ``shard_map`` over a real
    four-device mesh, and against the port's own global read."""
    tm, tp, _, _ = pair
    tag = "int8" if quantized else "fp"
    got = _port_logits(tm, tp, quantized, (_cpu_mesh(), "model"))
    glob = _port_logits(tm, tp, quantized, None)
    for k in ("decode", "verify"):
        _close(got[k], jax_local_read[f"{k}_{tag}"])
        _close(got[k], glob[k])


def test_local_read_writes_stay_in_owned_slices(pair):
    """Decode under local reads writes each token once, into its own
    page, and a non-live row's token into park pages only: layer 0's
    bank (its k/v come from the same input on both paths) equals the
    global-read bank bitwise everywhere but the shards' reserved local
    pages 0 (the park targets); the deeper layers' banks, whose inputs
    went through the merged softmax, are allclose."""
    tm, tp, _, _ = pair
    prompts, dec, _ = _inputs()
    tables = torch.from_numpy(_tables())
    banks = []
    for shard in (None, (_cpu_mesh(), "model")):
        pool = tm.init_page_pool(NSH * L, PAGE)
        for b, pr in enumerate(prompts):
            _, rows = tm.prefill(tp, pr, PPR * PAGE)
            tm.insert_cache_pages(pool, rows, tables[b:b + 1])
        pos = torch.tensor(PROMPTS, dtype=torch.int32)
        live = torch.tensor([True, True, False])
        tm.decode_step_pages(tp, pool, dec[0], pos, tables, live=live,
                             shard=shard)
        banks.append(pool)
    owned = [p for p in range(NSH * L) if p % L]
    for i, (a, b) in enumerate(zip(*banks)):
        for x, y in ((a.k, b.k), (a.v, b.v)):
            if i == 0:
                assert torch.equal(x[owned], y[owned])
            else:
                _close(y[owned], x[owned])


def test_engine_key_has_shards_field():
    k = EngineKey(name="a", batch_size=4, page_size=8, shards=4)
    assert k.shards == 4
    assert k != EngineKey(name="a", batch_size=4, page_size=8)
    assert EngineKey(name="a", batch_size=4).shards == 1
    # the one rule the engine, the server and the scheduler key share
    assert (shard_count(None, None), shard_count(None, _cpu_mesh()),
            shard_count(2, None)) == (1, NSH, 2)


@pytest.mark.parametrize("shards", [None, NSH])
def test_multi_row_admit_is_atomic(pair, shards):
    """A multi-row admission takes its rows' pages one row after another
    (each routed on its own on a sharded pool); a shortage part-way
    gives every page back in place, so the free-lists read as before."""
    tm = pair[0]
    eng = StepEngine(tm, batch_size=4, max_len=64, paged=True,
                     page_size=16, shards=shards, num_pages=12)
    pool = eng._pages
    before = ([list(d) for d in pool._shards] if shards else
              list(pool._free))
    with pytest.raises(RuntimeError):
        eng._take_pages(3, 56, 8)            # 4 pages a row: the third
        #                                      row finds too few
    after = ([list(d) for d in pool._shards] if shards else
             list(pool._free))
    assert after == before and not pool._held
    tables, pages = eng._take_pages(2, 40, 8)
    assert tables.shape == (2, 4) and len(pages) == 6
    assert (tables[:, 3] == 0).all()         # unused tail parks


def test_sharded_engine_guards(pair):
    tm = pair[0]
    with pytest.raises(ValueError, match="paged"):
        StepEngine(tm, batch_size=2, max_len=64, shards=4)
    with pytest.raises(ValueError, match="divide"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   shards=3, num_pages=16)
    with pytest.raises(ValueError, match="worst-case"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   shards=4, num_pages=4)    # 0 allocatable pages/shard
    with pytest.raises(ValueError, match="mesh"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   local_read=True)          # local_read needs a mesh
    with pytest.raises(ValueError, match="disagrees"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   shards=2, mesh=_cpu_mesh())
    with pytest.raises(NotImplementedError, match="distinct devices"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   mesh=Mesh(["cpu", "meta"]))


def test_default_page_budget_scales_with_shards(pair):
    """Every shard gets the batch's worst case share plus one spare; one
    shard keeps batch * ppr + 1."""
    tm = pair[0]
    one = StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16)
    assert one._pages.total_pages == 2 * 4 + 1
    four = StepEngine(tm, batch_size=2, max_len=64, paged=True,
                      page_size=16, shards=4)
    assert four._pages.total_pages == 4 * (2 + 1)
    assert four._pages.per_shard_allocatable == 2


def test_engine_reports_shard_pages_block(pair):
    """Pages exist pool-wide but not on the shard the request routes to:
    the block reason says ``shard_pages``, as JAX's engine does."""
    tm, tp, jm, jp = pair
    rng = np.random.default_rng(1)
    long = rng.integers(0, tm.cfg.vocab_size, (1, 24)).astype(np.int32)
    mid = rng.integers(0, tm.cfg.vocab_size, (1, 6)).astype(np.int32)
    tiny = mid[:, :2]
    kw = dict(batch_size=3, max_len=32, paged=True, page_size=4, shards=2,
              num_pages=18)                  # 8 allocatable per shard
    out = []
    for eng, p in ((StepEngine(tm, **kw), tp), (JaxStepEngine(jm, **kw),
                                                jp)):
        eng.admit(p, long, max_new=2)        # shard 0 down to 1 free
        eng.admit(p, long, max_new=2)        # shard 1 down to 1 free
        out.append((eng.can_admit(mid, 2), eng.last_admit_block,
                    eng.can_admit(tiny, 0), eng.last_admit_block))
    assert out[0] == out[1] == (False, "shard_pages", True, None)


def test_continuous_scheduler_sharded_matches_serve_batch():
    """``ContinuousScheduler(paged=True, shards=4)``: mixed traffic gives
    the run-to-completion outputs, the engines are keyed by their shard
    count, every page drains back, and the snapshot carries JAX's
    blocked-admission keys."""
    names = ["supersub-super", "supersub-sub"]
    server, cfgs = launch.build_server(names, 2, 64, arch_overrides=F32,
                                       device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(names[r % 2], rng.integers(0, cfgs[names[r % 2]].vocab_size,
                                            (1, [8, 40, 16][r % 3])))
                for r in range(6)]
        with ContinuousScheduler(server, batch_size=4, paged=True,
                                 page_size=16, shards=4) as sched:
            outs = [f.result(timeout=120) for f in
                    [sched.submit(n, t, steps=4) for n, t in reqs]]
        for (name, toks), out in zip(reqs, outs):
            np.testing.assert_array_equal(
                out, server.serve_batch(name, toks, steps=4))
        for key, eng in server._step_engines.items():
            assert key.shards == 4 and eng._pages.num_shards == 4
            assert eng.free_pages() == eng._pages.allocatable
        snap = sched.snapshot()
        for k in ("admit_blocked_no_slots", "admit_blocked_no_pages",
                  "admit_blocked_no_shard_pages"):
            assert k in snap
    finally:
        server.shutdown()


@pytest.mark.parametrize("extra", [[], ["--host-devices", "4"]])
def test_launcher_shards(extra, capsys):
    """``--paged --shards 4`` (with ``--host-devices 4``: over a mesh of
    four logical CPU devices) reports the JAX launcher's keys; without
    ``--paged`` it is refused, as in JAX."""
    rc = launch.main(["--platform", "cpu", "--mode", "continuous",
                      "--paged", "--page-size", "16", "--shards", "4",
                      "--requests", "4", "--steps", "3", "--seq", "8",
                      "--batch", "1", *extra])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mode"] == "continuous" and rep["loads"] >= 2
    assert "admit_blocked_no_shard_pages" in rep
    with pytest.raises(SystemExit) as e:
        launch.main(["--platform", "cpu", "--shards", "4"])
    assert e.value.code == 2
    assert "--shards needs --paged" in capsys.readouterr().err


def test_launcher_mesh_only_with_enough_devices(monkeypatch):
    """As in JAX, ``--shards N`` builds a mesh only when N devices are
    visible: the CPU platform has ``--host-devices`` of them."""
    assert len(launch.visible_devices("cpu", None)) == 1
    assert launch.visible_devices("cpu", 4) == [torch.device("cpu")] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert len(launch.visible_devices("gpu", 4)) == 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        jax_reference(sys.argv[2])
