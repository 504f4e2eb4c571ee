"""The port's dense ``LM`` against the JAX package's, on the same weights.

JAX initializes the parameters; ``repro_torch.bridge.params_from_jax``
unstacks them into the port's per-layer layout.  Logits are compared in
float32 at ``atol=5e-4, rtol=1e-3`` (the tolerance of
``test_model_forward_kernel_vs_reference``), with the JAX side on its
reference path and, for ``forward``, on its Pallas kernels in interpret
mode too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def _pair(name, seed=0, **kw):
    """(port LM, port params, JAX LM, JAX params) for the reduced
    float32 config of ``name``."""
    jcfg = jax_reduced(jax_get_arch(name), **F32, **kw)
    jm = jax_build(jcfg, cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(seed))
    tm = build_model(override(reduced(get_arch(name)), **F32, **kw),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


@pytest.fixture(scope="module")
def tiny():
    return _pair("tinyllama-1.1b")


@pytest.fixture(autouse=True)
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def test_bridge_unstacks_layers_and_keeps_dtypes():
    jm = jax_build(jax_reduced(jax_get_arch("tinyllama-1.1b")))
    jp = jm.init(jax.random.key(3), dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, device="cpu")
    L = jm.cfg.num_layers
    assert len(tp["blocks"]) == L
    assert tp["embed"].dtype == torch.bfloat16
    for i in range(L):
        got = tp["blocks"][i]["attn"]["wq"]
        want = tree["blocks"]["b0"]["attn"]["wq"][i]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    with pytest.raises(ValueError, match="repeat axis"):
        params_from_jax({"blocks": {"b0": {}, "b1": {}}}, device="cpu")


@pytest.mark.parametrize("name,mode", [("tinyllama-1.1b", "off"),
                                       ("tinyllama-1.1b", "interpret"),
                                       ("supersub-super", "off")])
def test_forward_logits_match_jax(name, mode):
    tm, tp, jm, jp = _pair(name, seed=1)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, 24))
    jax_kernels.set_mode(mode)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got = tm.forward(tp, toks)
    assert got.shape == (2, 24, tm.cfg.vocab_size)
    assert got.dtype == torch.float32
    _close(got, want)


def test_prefill_and_row_decode_match_jax(tiny):
    """Prefill 13 tokens, then two decode steps at per-row positions;
    logits and caches follow JAX's."""
    tm, tp, jm, jp = tiny
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 15))
    max_len = 32
    got, caches = tm.prefill(tp, toks[:, :13], max_len)
    want, jc = jm.prefill(jp, jnp.asarray(toks[:, :13]), max_len)
    _close(got, want)
    for t in (13, 14):
        pos = np.full((2,), t, np.int32)
        got, caches = tm.decode_step(tp, caches, toks[:, t:t + 1],
                                     torch.from_numpy(pos))
        want, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        _close(got, want)
    for i, c in enumerate(caches):
        _close(c.k, jc["b0"].k[i])
        _close(c.v, jc["b0"].v[i])


def test_paged_decode_matches_jax(tiny):
    """Admission into a page pool through shuffled tables (one row owns
    fewer pages; its dead entries park), then a paged decode step with
    one non-live row."""
    tm, tp, jm, jp = tiny
    rng = np.random.default_rng(3)
    B, S, page, P = 3, 11, 8, 4
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S + 1))
    NP = B * P + 1
    tables = rng.permutation(np.arange(1, NP)).reshape(B, P)
    tables[2, 2:] = 0
    tables = tables.astype(np.int32)
    _, rows = tm.prefill(tp, toks[:, :S], P * page)
    _, jrows = jm.prefill(jp, jnp.asarray(toks[:, :S]), P * page)
    pool = tm.insert_cache_pages(tm.init_page_pool(NP, page), rows, tables)
    jpool = jm.insert_cache_pages(jm.init_page_pool(NP, page), jrows,
                                  jnp.asarray(tables))
    pos = np.full((B,), S, np.int32)
    live = np.array([True, False, True])
    got, pool = tm.decode_step_pages(tp, pool, toks[:, S:],
                                     torch.from_numpy(pos),
                                     torch.from_numpy(tables),
                                     live=torch.from_numpy(live))
    want, jpool = jm.decode_step_pages(jp, jpool, jnp.asarray(toks[:, S:]),
                                       jnp.asarray(pos), jnp.asarray(tables),
                                       live=jnp.asarray(live))
    _close(got[live], np.asarray(want)[live])
    owned = np.unique(tables[tables != 0])
    for i, c in enumerate(pool):
        _close(c.k[owned], np.asarray(jpool["b0"].k[i])[owned])
        _close(c.v[owned], np.asarray(jpool["b0"].v[i])[owned])


def test_unported_configs_refuse():
    with pytest.raises(KeyError, match="not yet ported"):
        get_arch("musicgen-medium")
    recurrent = override(reduced(get_arch("tinyllama-1.1b")), family="ssm")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(recurrent, device="cpu")
