"""Sliding-window rings and the MoE FFN in the port (``mixtral-8x7b``),
against the JAX package's, on the CPU in float32.

Kernels: the plain versions of ring decode and ring verify against the
JAX Pallas kernels in interpret mode and the JAX references
(``atol=2e-5``, ``test_kernels.py``'s float32 tolerance), at per-row
positions below, at and past the ring's length S.  Layers, router and
MoE: the same numpy weights through both packages, JAX on its reference
path (``set_mode("off")``).  Model: reduced mixtral with a 16-token
window (as ``tests/test_models.py`` cuts it), logits at ``atol=5e-4,
rtol=1e-3``; engine streams token for token, greedy and with JAX's
gumbel fields injected (``test_torch_serve.JaxDraws``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_reference as jax_decode_ref)
from repro.kernels.verify_attention.ops import (  # noqa: E402
    verify_attention as jax_verify)
from repro.kernels.verify_attention.ref import (  # noqa: E402
    verify_reference as jax_verify_ref)
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention)
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    verify_attention)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import StepEngine  # noqa: E402
from test_torch_serve import (F32, JaxDraws, _prompts,  # noqa: E402
                              _run_stream, cache_close)

ATOL = 2e-5            # float32 kernels, as test_kernels.py:_tol
WINDOW = 16            # the reduced mixtral's window, as test_models.py


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=1e-2):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _logits_close(got, want):
    _close(got, want, atol=5e-4, rtol=1e-3)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def _cfgs(name="mixtral-8x7b", **kw):
    """(port cfg, JAX cfg): reduced, float32, a 16-token window."""
    kw = {**F32, "sliding_window": WINDOW, **kw}
    return (override(reduced(get_arch(name)), **kw),
            jax_reduced(jax_get_arch(name), **kw))


# ---------------------------------------------------------------------------
# ring decode and ring verify: plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,hd,pos", [
    (4, 4, 2, 16, 32, [5, 15, 16, 35]),     # below, at S-1, at S, 2S+3
    (2, 8, 2, 24, 16, [3, 100]),            # G=4, ragged S, far past S
])
def test_ring_decode_plain_matches_jax(B, H, Hkv, S, hd, pos):
    rng = np.random.default_rng(S)
    q = _randn(rng, B, H, hd)
    k, v = _randn(rng, B, Hkv, S, hd), _randn(rng, B, Hkv, S, hd)
    p = np.asarray(pos, np.int32)
    kernels.reset_launch_counts()
    got = decode_attention(*_t(q, k, v, p), ring=True)
    assert decode_attention.launches_ring == 0      # CPU: plain version
    args = _j(q, k, v, p)
    _close(got, jax_decode(*args, ring=True, interpret=True))
    _close(got, jax_decode_ref(*args, ring=True))
    # below S the ring reads what a full cache reads
    below = p < S
    _close(got[below], decode_attention(*_t(q, k, v, p))[below])


@pytest.mark.parametrize("B,H,Hkv,S,hd,K,pos", [
    (4, 4, 2, 16, 32, 5, [0, 14, 16, 35]),  # empty, wraps mid-block, S, 2S+3
    (2, 8, 2, 24, 16, 8, [20, 61]),         # G=4, ragged S
    (1, 4, 4, 16, 32, 16, [9]),             # K == S
])
def test_ring_verify_plain_matches_jax(B, H, Hkv, S, hd, K, pos):
    rng = np.random.default_rng(S + K)
    q = _randn(rng, B, K, H, hd)
    k, v = _randn(rng, B, Hkv, S, hd), _randn(rng, B, Hkv, S, hd)
    bk, bv = _randn(rng, B, K, Hkv, hd), _randn(rng, B, K, Hkv, hd)
    p = np.asarray(pos, np.int32)
    got = verify_attention(*_t(q, k, v, bk, bv, p), ring=True)
    args = _j(q, k, v, bk, bv, p)
    _close(got, jax_verify(*args, ring=True, interpret=True))
    _close(got, jax_verify_ref(*args, ring=True))


def test_ring_verify_refuses_a_tree_and_a_block_past_the_ring():
    rng = np.random.default_rng(0)
    S, K = 8, 9
    q, bk = _randn(rng, 1, K, 2, 16), _randn(rng, 1, K, 2, 16)
    k = _randn(rng, 1, 2, S, 16)
    with pytest.raises(ValueError, match="ring"):
        verify_attention(*_t(q, k, k, bk, bk, np.int32(3)), ring=True)
    with pytest.raises(ValueError, match="ring"):
        verify_attention(*_t(q[:, :4], k, k, bk[:, :4], bk[:, :4],
                             np.int32(3)), ring=True,
                         tree=torch.ones((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# router and the dense MoE reference
# ---------------------------------------------------------------------------

def _moe_params(cfg, rng):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    tree = {"w_router": _randn(rng, d, e) * 0.3,
            "w_gate": _randn(rng, e, d, f) / np.sqrt(d),
            "w_up": _randn(rng, e, d, f) / np.sqrt(d),
            "w_down": _randn(rng, e, f, d) / np.sqrt(f)}
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


@pytest.mark.parametrize("name", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_router_and_moe_dense_ref_match_jax(name):
    tcfg, jcfg = _cfgs(name)
    rng = np.random.default_rng(1)
    tp, jp = _moe_params(tcfg, rng)
    x = _randn(rng, 2, 7, tcfg.d_model)
    top_p, top_i, aux = TM.router(tp, torch.from_numpy(x[0]), tcfg.moe)
    jtop_p, jtop_i, jaux = JM.router(jp, jnp.asarray(x[0]), jcfg.moe)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    _close(top_p, jtop_p, atol=1e-6, rtol=1e-5)
    _close(aux, jaux, atol=1e-6, rtol=1e-5)
    out, aux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    jout, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    assert out.shape == x.shape
    _close(out, jout, atol=1e-5, rtol=1e-4)
    _close(aux, jaux, atol=1e-6, rtol=1e-5)
    # without a mesh: ep has nothing to split over, tp is JAX's moe_tp
    with pytest.raises(ValueError, match="needs a mesh"):
        TM.moe_apply(tp, torch.from_numpy(x), tcfg, strategy="ep")
    out, aux = TM.moe_apply(tp, torch.from_numpy(x), tcfg, strategy="tp")
    jout, jaux = JM.moe_tp(jp, jnp.asarray(x), jcfg)
    _close(out, jout, atol=1e-5, rtol=1e-4)
    _close(aux, jaux, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# ring attention layers: outputs and the cache, leaf for leaf
# ---------------------------------------------------------------------------

def _attn_params(cfg, rng):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tree = {"wq": _randn(rng, d, H, hd) / np.sqrt(d),
            "wk": _randn(rng, d, Hkv, hd) / np.sqrt(d),
            "wv": _randn(rng, d, Hkv, hd) / np.sqrt(d),
            "wo": _randn(rng, H, hd, d) / np.sqrt(H * hd)}
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def test_ring_attention_layers_match_jax(_jax_reference_path):
    """Prefill of a prompt longer than the window (the ring keeps the
    last 16 tokens, rolled), decode at per-row positions, then a verify
    block that crosses the ring's wrap: outputs and the whole cache equal
    JAX's after each call."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(2)
    tp, jp = _attn_params(tcfg, rng)
    B, S0, max_len = 2, 21, 48
    x = _randn(rng, B, S0, tcfg.d_model)
    positions = np.tile(np.arange(S0, dtype=np.int32), (B, 1))
    out, cache = TL.attention_prefill(tp, *_t(x, positions), tcfg, max_len,
                                      torch.float32)
    jout, jc = JL.attention_prefill(jp, *_j(x, positions), jcfg, max_len,
                                    jnp.float32)
    assert cache.k.shape[2] == WINDOW
    _close(out, jout, atol=1e-5, rtol=1e-5)
    _close(cache.k, jc.k, atol=1e-5, rtol=1e-5)
    _close(cache.v, jc.v, atol=1e-5, rtol=1e-5)

    pos = np.array([21, 26], np.int32)
    x1 = _randn(rng, B, 1, tcfg.d_model)
    out, _ = TL.attention_decode(tp, *_t(x1, pos), cache, tcfg)
    jout, jc = JL.attention_decode(jp, *_j(x1, pos), jc, jcfg)
    _close(out, jout, atol=1e-5, rtol=1e-5)
    _close(cache.k, jc.k, atol=1e-5, rtol=1e-5)

    xb = _randn(rng, B, 5, tcfg.d_model)
    pos = np.array([22, 30], np.int32)            # row 1 wraps at 32
    out, _ = TL.attention_verify(tp, *_t(xb, pos), cache, tcfg)
    jout, jc = JL.attention_verify(jp, *_j(xb, pos), jc, jcfg)
    _close(out, jout, atol=1e-5, rtol=1e-5)
    _close(cache.k, jc.k, atol=1e-5, rtol=1e-5)
    _close(cache.v, jc.v, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# reduced mixtral: logits against JAX, verify against sequential decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    """(port LM, port params, JAX LM, JAX params): reduced mixtral, a
    16-token window, float32, JAX weights bridged into the port."""
    tcfg, jcfg = _cfgs()
    jm = jax_build(jcfg, cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def test_mixtral_logits_match_jax_across_the_wrap(mixtral,
                                                  _jax_reference_path):
    """forward over 26 tokens; prefill 13, decode 13..17 (the ring of 16
    wraps at 16); a 5-token verify from 13 through the wrap; and a
    prefill of 21 (longer than the window) then one decode step."""
    tm, tp, jm, jp = mixtral
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 26))
    want, _ = jm.forward(jp, jnp.asarray(toks))
    fwd = tm.forward(tp, toks)
    _logits_close(fwd, want)
    max_len = 40
    got, caches = tm.prefill(tp, toks[:, :13], max_len)
    jgot, jc = jm.prefill(jp, jnp.asarray(toks[:, :13]), max_len)
    _logits_close(got, jgot)
    vcaches = [TL.KVCache(c.k.clone(), c.v.clone()) for c in caches]
    jvc = jc
    for t in range(13, 18):
        pos = np.full((2,), t, np.int32)
        got, _ = tm.decode_step(tp, caches, toks[:, t:t + 1],
                                torch.from_numpy(pos))
        jgot, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        _logits_close(got, jgot)
        _logits_close(got[:, 0], fwd[:, t])      # ring == windowed forward
    pos = np.full((2,), 13, np.int32)
    got, _ = tm.verify_step(tp, vcaches, toks[:, 13:18],
                            torch.from_numpy(pos))
    jgot, jvc = jm.verify_step(jp, jvc, jnp.asarray(toks[:, 13:18]),
                               jnp.asarray(pos))
    _logits_close(got, jgot)
    _logits_close(got, fwd[:, 13:18])
    for c, v in zip(caches, vcaches):            # verify wrote what K
        cache_close(v.k, c.k)                    # decode steps wrote

    got, caches = tm.prefill(tp, toks[:, :21], max_len)
    jgot, jc = jm.prefill(jp, jnp.asarray(toks[:, :21]), max_len)
    _logits_close(got, jgot)
    for i, c in enumerate(caches):               # the rolled ring
        _logits_close(c.k, jc["b0"].k[i])
        _logits_close(c.v, jc["b0"].v[i])
    pos = np.full((2,), 21, np.int32)
    got, _ = tm.decode_step(tp, caches, toks[:, 21:22], torch.from_numpy(pos))
    _logits_close(got[:, 0], fwd[:, 21])


def test_mixtral_verify_step_equals_sequential_decode(mixtral):
    """Inside the port, per-row positions: one K=6 verify pass gives the
    logits and the caches of 6 decode steps, across the wrap."""
    tm, tp, _, _ = mixtral
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 20))
    _, seq = tm.prefill(tp, toks[:, :12], 40)
    ver = [TL.KVCache(c.k.clone(), c.v.clone()) for c in seq]
    pos = torch.tensor([12, 12], dtype=torch.int32)
    steps = []
    for i in range(6):
        lg, _ = tm.decode_step(tp, seq, toks[:, 12 + i:13 + i], pos + i)
        steps.append(lg)
    lv, _ = tm.verify_step(tp, ver, toks[:, 12:18], pos)
    _close(lv, torch.cat(steps, 1), atol=1e-5, rtol=1e-5)
    for a, b in zip(seq, ver):
        cache_close(b.k, a.k)
        cache_close(b.v, a.v)


# ---------------------------------------------------------------------------
# row step engine against JAX; the engine gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_mixtral_row_engine_streams_match_jax(mixtral, temperature):
    """A 12-token prompt that decodes across the wrap and a 40-token one
    prefilled into the rolled ring, admitted two steps apart."""
    tm, tp, jm, jp = mixtral
    prompts = _prompts(tm.cfg.vocab_size)
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=64, temperature=temperature)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 6, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _run_stream(eng, tp, prompts, 6, seeds) == want


def test_ring_model_refuses_chunked_and_paged_engines(mixtral):
    tm, _, jm, _ = mixtral
    for engine, model in ((StepEngine, tm), (JaxStepEngine, jm)):
        with pytest.raises(ValueError, match="non-ring"):
            engine(model, batch_size=2, max_len=64, prefill_chunk=8)
        with pytest.raises(ValueError, match="non-ring"):
            engine(model, batch_size=2, max_len=64, paged=True,
                   page_size=16)
    with pytest.raises(ValueError, match="non-ring"):
        tm.init_page_pool(5, 16)
    with pytest.raises(NotImplementedError, match="ring and recurrent"):
        tm.prefill_chunk(None, tm.init_cache(1, 32), np.zeros((1, 4)),
                         [0], [0])
