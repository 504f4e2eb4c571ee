"""The port's dense layers against the JAX package's, on the same numpy
weights and inputs, in float32 on the CPU (``atol=1e-5``).  The JAX side
runs its reference path (``kernels.set_mode("off")``); the port runs its
kernels' plain versions.  Cache writes (the row cache, ``_page_write``
and ``insert_pages``) must land leaf for leaf where JAX's ``.at[...]``
updates land."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def _cfgs():
    kw = dict(dtype="float32", param_dtype="float32")
    return (override(reduced(get_arch("tinyllama-1.1b")), **kw),
            jax_reduced(jax_get_arch("tinyllama-1.1b"), **kw))


def _attn_params(cfg, rng):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {"wq": rng.standard_normal((d, H, hd)) * s,
            "wk": rng.standard_normal((d, Hkv, hd)) * s,
            "wv": rng.standard_normal((d, Hkv, hd)) * s,
            "wo": rng.standard_normal((H, hd, d)) / np.sqrt(H * hd)}


def _pair(tree):
    """numpy tree -> (torch tree, jax tree), float32."""
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
         tree.items()}
    j = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in tree.items()}
    return t, j


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=1e-5)


def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), atol=1e-4)
    _close(TL.rope_freqs(32, 1e4), JL.rope_freqs(32, 1e4))
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    for gated in (True, False):
        p = {k: rng.standard_normal(s.shape).astype(np.float32) / 4
             for k, s in TL.mlp_specs(16, 24, gated).items()}
        tp, jp = _pair(p)
        _close(TL.mlp(tp, torch.from_numpy(h)), JL.mlp(jp, jnp.asarray(h)))


def test_attention_and_prefill_match_jax():
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(1)
    tp, jp = _pair(_attn_params(tcfg, rng))
    B, S, max_len = 2, 21, 40
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pt, pj = torch.from_numpy(np.ascontiguousarray(pos)), jnp.asarray(pos)
    _close(TL.attention(tp, xt, pt, tcfg), JL.attention(jp, xj, pj, jcfg))
    out, cache = TL.attention_prefill(tp, xt, pt, tcfg, max_len,
                                      torch.float32)
    jout, jcache = JL.attention_prefill(jp, xj, pj, jcfg, max_len,
                                        jnp.float32)
    _close(out, jout)
    assert cache.k.shape == (B, tcfg.num_kv_heads, max_len, tcfg.head_dim)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_row_decode_matches_jax_and_writes_in_place():
    """Per-row positions, one row parked past the cache end (its write
    clamps to slot S-1, as JAX's does)."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(2)
    tp, jp = _pair(_attn_params(tcfg, rng))
    B, S = 3, 32
    shape = (B, tcfg.num_kv_heads, S, tcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([0, 17, S + 3], np.int32)
    cache = TL.KVCache(k=torch.from_numpy(k0.copy()),
                       v=torch.from_numpy(v0.copy()))
    kbuf = cache.k
    out, new = TL.attention_decode(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), cache, tcfg)
    assert new.k is kbuf                                # updated in place
    jout, jnew = JL.attention_decode(jp, jnp.asarray(x), jnp.asarray(pos),
                                     JL.KVCache(k=jnp.asarray(k0),
                                                v=jnp.asarray(v0)), jcfg)
    _close(out, jout)
    _close(new.k, jnew.k)        # the new token's k/v: same slots, values
    _close(new.v, jnew.v)        # to float32 rounding of the projection


def _pool_case(rng, cfg, B=3, P=4, page=8):
    NP = B * P + 2
    shape = (NP, cfg.num_kv_heads, page, cfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
    return k0, v0, tables.astype(np.int32)


def test_page_write_lands_where_jax_lands():
    """(B, K) tokens scattered through shuffled tables, one token masked
    to the park page and one parked past the table's end (clamped to the
    last entry): every pool leaf equals JAX's ``.at[pids, :, slots, :]``
    result exactly."""
    tcfg, _ = _cfgs()
    rng = np.random.default_rng(3)
    B, K, P, page = 3, 2, 4, 8
    k0, v0, tables = _pool_case(rng, tcfg, B, P, page)
    kv = (B, K, tcfg.num_kv_heads, tcfg.head_dim)
    k = rng.standard_normal(kv).astype(np.float32)
    v = rng.standard_normal(kv).astype(np.float32)
    positions = np.array([[0, 9], [30, 31], [P * page + 2, 5]], np.int32)
    wmask = np.array([[True, True], [True, False], [True, True]])
    cache = TL.PagedKV(k=torch.from_numpy(k0.copy()),
                       v=torch.from_numpy(v0.copy()))
    TL._page_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(tables), torch.from_numpy(positions),
                   wmask=torch.from_numpy(wmask))
    jc = JL._page_write(JL.PagedKV(k=jnp.asarray(k0), v=jnp.asarray(v0)),
                        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                        jnp.asarray(positions), wmask=jnp.asarray(wmask))
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jc.v))
    assert not np.array_equal(cache.k.numpy()[TL.PARK_PAGE],
                              k0[TL.PARK_PAGE])   # the masked token parked


def test_insert_pages_lands_where_jax_lands():
    """Admission scatter: rows (B, Hkv, P*page, hd) through (B, P) tables
    whose dead tail entries point at the park page."""
    tcfg, _ = _cfgs()
    rng = np.random.default_rng(4)
    B, P, page = 2, 3, 8
    k0, v0, tables = _pool_case(rng, tcfg, B, P, page)
    tables[1, 1:] = TL.PARK_PAGE                 # row 1 owns one page
    tables[0, 2] = TL.PARK_PAGE
    rs = (B, tcfg.num_kv_heads, P * page, tcfg.head_dim)
    rk = rng.standard_normal(rs).astype(np.float32)
    rv = rng.standard_normal(rs).astype(np.float32)
    cache = TL.PagedKV(k=torch.from_numpy(k0.copy()),
                       v=torch.from_numpy(v0.copy()))
    TL.insert_pages(cache, TL.KVCache(k=torch.from_numpy(rk),
                                      v=torch.from_numpy(rv)),
                    torch.from_numpy(tables))
    jc = JL.insert_pages(JL.PagedKV(k=jnp.asarray(k0), v=jnp.asarray(v0)),
                         JL.KVCache(k=jnp.asarray(rk), v=jnp.asarray(rv)),
                         jnp.asarray(tables))
    live = [p for p in range(k0.shape[0]) if p != TL.PARK_PAGE]
    # several dead entries scatter into the park page in one update, and
    # which one lands is unspecified in both frameworks: compare the rest
    np.testing.assert_array_equal(cache.k.numpy()[live],
                                  np.asarray(jc.k)[live])
    np.testing.assert_array_equal(cache.v.numpy()[live],
                                  np.asarray(jc.v)[live])
    with pytest.raises(ValueError, match="pages"):
        TL.insert_pages(cache, TL.KVCache(k=torch.from_numpy(rk[:, :, :8]),
                                          v=torch.from_numpy(rv[:, :, :8])),
                        torch.from_numpy(tables))


def test_paged_decode_matches_jax_and_row_decode():
    """One decode step through the page pool equals JAX's paged step
    (output and pool) and the port's own row-cache step on the gathered
    rows."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(5)
    tp, jp = _pair(_attn_params(tcfg, rng))
    B, P, page = 3, 4, 8
    k0, v0, tables = _pool_case(rng, tcfg, B, P, page)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([3, 20, 31], np.int32)
    live = np.array([True, False, True])
    cache = TL.PagedKV(k=torch.from_numpy(k0.copy()),
                       v=torch.from_numpy(v0.copy()))
    out, _ = TL.attention_decode_pages(tp, torch.from_numpy(x),
                                       torch.from_numpy(pos), cache,
                                       torch.from_numpy(tables), tcfg,
                                       wmask=torch.from_numpy(live))
    jout, jc = JL.attention_decode_pages(
        jp, jnp.asarray(x), jnp.asarray(pos),
        JL.PagedKV(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        jnp.asarray(tables), jcfg, wmask=jnp.asarray(live))
    _close(out, jout)
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)

    from repro_torch.kernels.paged_attention.ref import gather_pages
    t = torch.from_numpy(tables)
    rows = TL.KVCache(k=gather_pages(torch.from_numpy(k0), t).contiguous(),
                      v=gather_pages(torch.from_numpy(v0), t).contiguous())
    rout, _ = TL.attention_decode(tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), rows, tcfg)
    torch.testing.assert_close(out[live], rout[live], rtol=0, atol=0)
