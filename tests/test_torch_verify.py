"""The port's verify kernels (row and paged, chunked prefill's attention)
and its int8 page pool against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it against the JAX Pallas kernel in interpret mode and against the JAX
reference on the same numpy inputs in float32 (``atol=2e-5``, the
float32 tolerance of ``test_kernels.py``; the int8 pairs of
``test_quantized_pages.py``: ``1e-6`` between the references, ``2e-5``
against the kernel).  The layer tests run JAX on its reference path
(``set_mode("off")``) and compare outputs and the caches written."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_verify_attention as jax_paged_verify)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_reference as jax_paged_decode_ref,
    paged_verify_reference as jax_paged_verify_ref)
from repro.kernels.verify_attention.ops import (  # noqa: E402
    verify_attention as jax_verify)
from repro.kernels.verify_attention.ref import (  # noqa: E402
    verify_reference as jax_verify_ref)
from repro.models import layers as JL  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention, paged_verify_attention)
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    verify_attention)
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 2e-5          # float32, as test_kernels.py:_tol


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=1e-2):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _tree(rng, B, K):
    """(B, K) ancestor bitmasks: node i sees itself and a random subset
    of the nodes before it."""
    bits = rng.integers(0, 1 << 30, (B, K))
    i = np.arange(K)
    return ((bits & ((1 << i) - 1)) | (1 << i)).astype(np.int32)


def _pool(rng, NP, Hkv, page, hd, int8):
    """A random page pool: float32 pages, or int8 codes plus f32 scales."""
    if not int8:
        return (_randn(rng, NP, Hkv, page, hd),
                _randn(rng, NP, Hkv, page, hd), None, None)
    codes = [rng.integers(-127, 128, (NP, Hkv, page, hd)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((NP, Hkv, page)) / 32).astype(np.float32)
              for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1]


def _tables(rng, B, P, page, pos, K):
    """(B, P) tables over B*P+1 pages in shuffled order; entries whose
    first position lies at or past ``pos + K`` are dead (park page 0)."""
    ids = rng.permutation(np.arange(1, B * P + 1)).reshape(B, P)
    dead = np.arange(P)[None, :] * page >= np.asarray(pos)[:, None] + K
    return np.where(dead, 0, ids).astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels and the JAX references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,hd,K,pos,tree", [
    (2, 4, 2, 64, 32, 5, [0, 37], False),      # G=2, pos 0 and mid-block
    (1, 4, 4, 48, 16, 8, [21], False),         # G=1, ragged S
    (2, 8, 2, 64, 32, 4, [12, 50], True),      # G=4, tree mask
])
def test_verify_plain_matches_jax(B, H, Hkv, S, hd, K, pos, tree):
    rng = np.random.default_rng(S + K)
    q = _randn(rng, B, K, H, hd)
    k, v = _randn(rng, B, Hkv, S, hd), _randn(rng, B, Hkv, S, hd)
    bk, bv = _randn(rng, B, K, Hkv, hd), _randn(rng, B, K, Hkv, hd)
    p = np.asarray(pos, np.int32)
    tr = _tree(rng, B, K) if tree else None
    got = verify_attention(*_t(q, k, v, bk, bv, p), tree=_t(tr)[0])
    args = _j(q, k, v, bk, bv, p)
    _close(got, jax_verify(*args, tree=_j(tr)[0], interpret=True))
    _close(got, jax_verify_ref(*args, tree=_j(tr)[0]))


@pytest.mark.parametrize("B,H,Hkv,P,page,hd,K,pos,int8,tree", [
    (2, 4, 2, 4, 16, 32, 5, [0, 37], False, False),   # pos 0, mid-page
    (3, 4, 4, 3, 8, 16, 4, [9, 1, 16], True, False),  # int8, G=1
    (2, 8, 2, 4, 16, 32, 6, [20, 33], True, True),    # int8, tree, G=4
    (2, 4, 2, 4, 16, 32, 3, [5, 40], False, True),    # tree
])
def test_paged_verify_plain_matches_jax(B, H, Hkv, P, page, hd, K, pos,
                                        int8, tree):
    """Shuffled tables with dead entries on the park page; an int8 pool
    dequantizes, the block stays float32."""
    rng = np.random.default_rng(P * page + K)
    NP = B * P + 1
    q = _randn(rng, B, K, H, hd)
    bk, bv = _randn(rng, B, K, Hkv, hd), _randn(rng, B, K, Hkv, hd)
    kp, vp, ks, vs = _pool(rng, NP, Hkv, page, hd, int8)
    p = np.asarray(pos, np.int32)
    table = _tables(rng, B, P, page, p, K)
    tr = _tree(rng, B, K) if tree else None
    tq, tk, tv, tbk, tbv, ttab, tpos, tks, tvs, ttr = _t(
        q, kp, vp, bk, bv, table, p, ks, vs, tr)
    got = paged_verify_attention(tq, tk, tv, tbk, tbv, ttab, tpos,
                                 k_scale=tks, v_scale=tvs, tree=ttr)
    jq, jk, jv, jbk, jbv, jtab, jpos, jks, jvs, jtr = _j(
        q, kp, vp, bk, bv, table, p, ks, vs, tr)
    kw = dict(k_scale=jks, v_scale=jvs, tree=jtr)
    _close(got, jax_paged_verify(jq, jk, jv, jbk, jbv, jtab, jpos,
                                 interpret=True, **kw))
    _close(got, jax_paged_verify_ref(jq, jk, jv, jbk, jbv, jtab, jpos, **kw),
           atol=1e-6 if int8 else ATOL)


@pytest.mark.parametrize("B,H,Hkv,P,page,hd,pos", [
    (2, 4, 2, 4, 16, 32, [30, 63]),
    (3, 4, 4, 3, 8, 16, [0, 9, 23]),          # first token, G=1
])
def test_int8_paged_decode_plain_matches_jax(B, H, Hkv, P, page, hd, pos):
    rng = np.random.default_rng(page + B)
    NP = B * P + 1
    q = _randn(rng, B, H, hd)
    kp, vp, ks, vs = _pool(rng, NP, Hkv, page, hd, True)
    p = np.asarray(pos, np.int32)
    table = _tables(rng, B, P, page, p, 1)
    tq, tk, tv, ttab, tpos, tks, tvs = _t(q, kp, vp, table, p, ks, vs)
    got = paged_decode_attention(tq, tk, tv, ttab, tpos, k_scale=tks,
                                 v_scale=tvs)
    jq, jk, jv, jtab, jpos, jks, jvs = _j(q, kp, vp, table, p, ks, vs)
    _close(got, jax_paged_decode(jq, jk, jv, jtab, jpos, k_scale=jks,
                                 v_scale=jvs, interpret=True))
    _close(got, jax_paged_decode_ref(jq, jk, jv, jtab, jpos, k_scale=jks,
                                     v_scale=jvs), atol=1e-6)


def test_cpu_verify_and_int8_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    B, K, H, Hkv, hd, page, P = 1, 3, 4, 2, 16, 8, 2
    q, bk, bv = _t(_randn(rng, B, K, H, hd), _randn(rng, B, K, Hkv, hd),
                   _randn(rng, B, K, Hkv, hd))
    kp, vp, ks, vs = _t(*_pool(rng, B * P + 1, Hkv, page, hd, True))
    table, pos = _t(np.array([[1, 2]], np.int32), np.array([5], np.int32))
    kg, vg = TL._gather_dequant(TL.PagedKV(kp, vp, ks, vs), table,
                                torch.float32)
    verify_attention(q, kg, vg, bk, bv, pos)
    paged_verify_attention(q, kp, vp, bk, bv, table, pos, k_scale=ks,
                           v_scale=vs)
    paged_decode_attention(q[:, 0], kp, vp, table, pos, k_scale=ks,
                           v_scale=vs)
    assert (verify_attention.launches, paged_verify_attention.launches,
            paged_verify_attention.launches_int8,
            paged_verify_attention.launches_tree,
            paged_decode_attention.launches_int8) == (0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# the int8 quantizer and the int8 pool's writes
# ---------------------------------------------------------------------------

def test_quantize_kv_matches_jax():
    """Codes equal JAX's, scales within ``rtol=1e-6``.  ``torch.round``
    and ``jnp.round`` both round half to even; the inputs include exact
    ties (x / scale = k + 0.5) so a flipped tie would show.  A code may
    still differ by one where the two divisions round their last bit
    apart; none does on these inputs."""
    rng = np.random.default_rng(2)
    x = (_randn(rng, 3, 4, 20, 32) * 5).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, -2.5, 3.5]        # scale 1: exact ties
    codes, scale = TL.quantize_kv(torch.from_numpy(x))
    jcodes, jscale = JL.quantize_kv(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    assert codes[0, 0, 0, :4].tolist() == [127, 0, -2, 4]
    np.testing.assert_allclose(
        TL.dequantize_kv(codes, scale).numpy(),
        np.asarray(JL.dequantize_kv(jcodes, jscale)), rtol=1e-6)


def _cfgs():
    kw = dict(dtype="float32", param_dtype="float32")
    return (override(reduced(get_arch("tinyllama-1.1b")), **kw),
            jax_reduced(jax_get_arch("tinyllama-1.1b"), **kw))


def _int8_case(rng, cfg, B, P, page):
    NP = B * P + 1
    kp, vp, ks, vs = _pool(rng, NP, cfg.num_kv_heads, page, cfg.head_dim,
                           True)
    tables = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
    return (kp, vp, ks, vs), tables.astype(np.int32)


def _tpool(leaves):
    return TL.PagedKV(*[torch.from_numpy(a.copy()) for a in leaves])


def _jpool(leaves):
    return JL.PagedKV(*[jnp.asarray(a) for a in leaves])


def _same_pool(cache, jc, pages=None):
    for got, want in zip(cache, jc):
        got, want = got.numpy(), np.asarray(want)
        if pages is not None:
            got, want = got[pages], want[pages]
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_int8_page_write_and_insert_land_where_jax_lands():
    """Codes and scales of an int8 pool after ``_page_write`` (a masked
    token parks, one token past the table's end clamps) and after
    ``insert_pages`` (dead entries park) equal JAX's leaves."""
    tcfg, _ = _cfgs()
    rng = np.random.default_rng(3)
    B, K, P, page = 3, 2, 4, 8
    leaves, tables = _int8_case(rng, tcfg, B, P, page)
    kv = (B, K, tcfg.num_kv_heads, tcfg.head_dim)
    k, v = _randn(rng, *kv), _randn(rng, *kv)
    positions = np.array([[0, 9], [30, 31], [P * page + 2, 5]], np.int32)
    wmask = np.array([[True, True], [True, False], [True, True]])
    cache = _tpool(leaves)
    TL._page_write(cache, *_t(k, v, tables, positions),
                   wmask=torch.from_numpy(wmask))
    jc = JL._page_write(_jpool(leaves), *_j(k, v, tables, positions),
                        wmask=jnp.asarray(wmask))
    _same_pool(cache, jc)

    tables[1, 1:] = TL.PARK_PAGE                 # row 1 owns one page
    rs = (B, tcfg.num_kv_heads, P * page, tcfg.head_dim)
    rk, rv = _randn(rng, *rs), _randn(rng, *rs)
    cache = _tpool(leaves)
    TL.insert_pages(cache, TL.KVCache(*_t(rk, rv)), torch.from_numpy(tables))
    jc = JL.insert_pages(_jpool(leaves), JL.KVCache(*_j(rk, rv)),
                         jnp.asarray(tables))
    # several dead entries land in the park page in one update, and which
    # lands is unspecified in both frameworks: compare the other pages
    _same_pool(cache, jc, pages=[p for p in range(leaves[0].shape[0])
                                 if p != TL.PARK_PAGE])


# ---------------------------------------------------------------------------
# layers: attention_verify (row) and attention_verify_pages
# ---------------------------------------------------------------------------

@pytest.fixture
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def _attn_params(cfg, rng):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    tree = {"wq": rng.standard_normal((d, H, hd)) * s,
            "wk": rng.standard_normal((d, Hkv, hd)) * s,
            "wv": rng.standard_normal((d, Hkv, hd)) * s,
            "wo": rng.standard_normal((H, hd, d)) / np.sqrt(H * hd)}
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def test_attention_verify_matches_jax(_jax_reference_path):
    """A (B, K) block on the row cache, trailing pads masked by ``wmask``
    (one row's pads run past the last slot and clamp there): outputs and
    the whole cache equal JAX's; masked slots keep what they held."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(4)
    tp, jp = _attn_params(tcfg, rng)
    B, K, S = 3, 6, 32
    shape = (B, tcfg.num_kv_heads, S, tcfg.head_dim)
    k0, v0 = _randn(rng, *shape), _randn(rng, *shape)
    x = _randn(rng, B, K, tcfg.d_model)
    pos = np.array([0, 13, 28], np.int32)
    nvalid = np.array([6, 4, 3])
    wmask = np.arange(K)[None, :] < nvalid[:, None]
    cache = TL.KVCache(*_t(k0.copy(), v0.copy()))
    out, _ = TL.attention_verify(tp, *_t(x, pos), cache, tcfg,
                                 wmask=torch.from_numpy(wmask))
    jout, jc = JL.attention_verify(jp, *_j(x, pos), JL.KVCache(*_j(k0, v0)),
                                   jcfg, wmask=jnp.asarray(wmask))
    _close(out, jout, atol=1e-5, rtol=1e-5)
    _close(cache.k, jc.k, atol=1e-5, rtol=1e-5)
    _close(cache.v, jc.v, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(cache.k[1, :, 17:].numpy(),
                                  k0[1, :, 17:])     # pads left it alone


@pytest.mark.parametrize("int8", [False, True])
def test_attention_verify_pages_matches_jax(_jax_reference_path, int8):
    """A (B, K) block through shuffled tables, pads masked to the park
    page: outputs equal JAX's, and so does every page a row owns (codes
    and scales for an int8 pool); with a tree and depth offsets too."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(5 + int8)
    tp, jp = _attn_params(tcfg, rng)
    B, K, P, page = 2, 5, 4, 8
    NP = B * P + 1
    leaves = _pool(rng, NP, tcfg.num_kv_heads, page, tcfg.head_dim, int8)
    leaves = leaves if int8 else leaves[:2]
    tables = rng.permutation(np.arange(1, NP)).reshape(B, P).astype(
        np.int32)
    x = _randn(rng, B, K, tcfg.d_model)
    pos = np.array([0, 19], np.int32)
    pads = np.arange(K)[None, :] < np.array([5, 3])[:, None]
    owned = np.unique(tables)
    # the tree: root, two children, one grandchild under each; siblings
    # share a depth, so only the first node of each depth writes
    tree = {"offsets": np.array([0, 1, 1, 2, 2], np.int32),
            "tree": np.array([[1, 3, 5, 11, 21]] * B, np.int32)}
    first = np.array([[True, True, False, True, False]] * B)
    for extra, wmask in (({}, pads), (tree, first)):
        cache = _tpool(leaves)
        out, _ = TL.attention_verify_pages(
            tp, *_t(x, pos), cache, torch.from_numpy(tables), tcfg,
            wmask=torch.from_numpy(wmask),
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        jout, jc = JL.attention_verify_pages(
            jp, *_j(x, pos), _jpool(leaves), jnp.asarray(tables), jcfg,
            wmask=jnp.asarray(wmask),
            **{k: jnp.asarray(v) for k, v in extra.items()})
        _close(out, jout, atol=1e-5, rtol=1e-5)
        if int8:
            _same_pool(cache, jc, pages=owned)
        else:
            for got, want in zip(cache[:2], jc[:2]):
                _close(got[owned], np.asarray(want)[owned], atol=1e-5,
                       rtol=1e-5)
