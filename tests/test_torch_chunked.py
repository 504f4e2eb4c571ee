"""Chunked prefill and the int8 page pool in the port's model and step
engine, against the JAX package's on the same weights, and the
invariants the port keeps within itself, on the CPU in float32.

Logits compare at ``atol=5e-4, rtol=1e-3`` (``test_torch_model.py``'s
tolerance) with JAX on its reference path; streams compare token for
token, greedy and with JAX's gumbel fields injected through the
engine's ``sampler`` hook (``test_torch_serve.JaxDraws``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serve.engine import StepEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from test_torch_serve import (F32, JaxDraws, _drain,  # noqa: E402,F401
                              _prompts, _run_stream, pair)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


@pytest.fixture
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


# ---------------------------------------------------------------------------
# model: verify_step, prefill_chunk, prefill_chunk_pages
# ---------------------------------------------------------------------------

def test_verify_and_chunk_logits_match_jax(pair, _jax_reference_path):
    """``verify_step`` after a prefill, ``prefill_chunk`` into named rows
    of a dirty pooled cache (one row at pos 0 gets zeroed first, the
    other continues mid-prompt, pads masked), and ``prefill_chunk_pages``
    on a float32 and an int8 pool: logits and the caches written follow
    JAX's."""
    tm, tp, jm, jp = pair
    rng = np.random.default_rng(11)
    V = tm.cfg.vocab_size
    toks = rng.integers(0, V, (2, 16)).astype(np.int32)

    # verify_step on row caches
    _, caches = tm.prefill(tp, toks[:, :10], 32)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :10]), 32)
    pos = np.full((2,), 10, np.int32)
    got, caches = tm.verify_step(tp, caches, toks[:, 10:15],
                                 torch.from_numpy(pos))
    want, jc = jm.verify_step(jp, jc, jnp.asarray(toks[:, 10:15]),
                              jnp.asarray(pos))
    _close(got, want)
    for i, c in enumerate(caches):
        _close(c.k, jc["b0"].k[i])

    # prefill_chunk into rows (2, 0) of a 3-row pool full of garbage
    caches = tm.init_cache(3, 32)
    jc = jm.init_cache(3, 32)
    junk = rng.standard_normal(caches[0].k.shape).astype(np.float32)
    for c in caches:
        c.k.copy_(torch.from_numpy(junk))
        c.v.copy_(torch.from_numpy(-junk))
    jc = jax.tree.map(lambda x: jnp.broadcast_to(
        jnp.asarray(junk), x.shape), jc)
    jc["b0"] = jc["b0"]._replace(v=-jc["b0"].v)
    chunk, cpos = toks[:, :6], np.array([0, 4], np.int32)
    slots = np.array([2, 0])
    wmask = np.array([[True] * 6, [True] * 4 + [False] * 2])
    got, caches = tm.prefill_chunk(tp, caches, chunk, torch.from_numpy(cpos),
                                   slots, wmask=torch.from_numpy(wmask))
    want, jc = jm.prefill_chunk(jp, jc, jnp.asarray(chunk),
                                jnp.asarray(cpos), jnp.asarray(slots),
                                wmask=jnp.asarray(wmask))
    _close(got, want)
    for i, c in enumerate(caches):
        _close(c.k, jc["b0"].k[i])
        _close(c.v, jc["b0"].v[i])

    # prefill_chunk_pages, float32 and int8 pools, shuffled tables
    page, P = 8, 4
    tables = rng.permutation(np.arange(1, 2 * P + 1)).reshape(2, P)
    tables = tables.astype(np.int32)
    for quantized in (False, True):
        pool = tm.init_page_pool(2 * P + 1, page, quantized=quantized)
        jpool = jm.init_page_pool(2 * P + 1, page, quantized=quantized)
        for start in (0, 6):
            chunk = toks[:, start:start + 6]
            p = np.full((2,), start, np.int32)
            got, pool = tm.prefill_chunk_pages(
                tp, pool, chunk, torch.from_numpy(p),
                torch.from_numpy(tables))
            want, jpool = jm.prefill_chunk_pages(
                jp, jpool, jnp.asarray(chunk), jnp.asarray(p),
                jnp.asarray(tables))
            _close(got, want)
        owned = tables.ravel()
        for i, c in enumerate(pool):
            jb = jpool["b0"]
            for leaf, jleaf in zip(c, jb):
                if leaf is None:
                    continue
                a, b = leaf[owned].numpy(), np.asarray(jleaf[i])[owned]
                if a.dtype == np.int8:    # one code, where a division
                    assert np.abs(a.astype(int) - b).max() <= 1  # rounds
                else:                     # its last bit apart
                    _close(a, b)


# ---------------------------------------------------------------------------
# step engine against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_chunked_engine_streams_match_jax(pair, paged, temperature):
    """Chunked admission (C=8: a 12-token and a 40-token prompt, the
    second streaming in behind a decoding row): the port's streams equal
    the JAX engine's, greedy and with JAX's gumbel fields."""
    tm, tp, jm, jp = pair
    prompts = _prompts(tm.cfg.vocab_size)
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=64, temperature=temperature,
              paged=paged, page_size=16, prefill_chunk=8)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 6, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _run_stream(eng, tp, prompts, 6, seeds) == want


@pytest.mark.parametrize("chunk", [None, 8])
def test_int8_engine_greedy_matches_jax(pair, chunk):
    tm, tp, jm, jp = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(12, 33), seed=9)
    kw = dict(batch_size=2, max_len=64, paged=True, page_size=16,
              quantize_kv="int8", prefill_chunk=chunk)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 6,
                       [None, None])
    eng = StepEngine(tm, **kw)
    assert _run_stream(eng, tp, prompts, 6, [None, None]) == want
    assert eng.free_pages() == eng._pages.allocatable


# ---------------------------------------------------------------------------
# invariants within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_chunked_equals_one_shot_and_paged_equals_row(pair, temperature):
    """Under torch's own generator: chunked admission gives the one-shot
    streams for every chunk width (greedy, and seeded rows, whose draws
    depend on the position only), and a chunked paged engine gives the
    chunked row engine's streams exactly (an unseeded row included: the
    two share one tick schedule)."""
    tm, tp, _, _ = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(9, 30), seed=5)
    T = dict(temperature=temperature)
    seeds = [11, 3] if temperature > 0 else [None, None]
    ref = _run_stream(StepEngine(tm, batch_size=2, max_len=64, **T), tp,
                      prompts, 7, seeds)
    for C in (5, 8, 64):                 # unaligned, multiple, wider
        eng = StepEngine(tm, batch_size=2, max_len=64, prefill_chunk=C, **T)
        assert _run_stream(eng, tp, prompts, 7, seeds) == ref, C
    seeds = [11, None] if temperature > 0 else seeds
    kw = dict(batch_size=2, max_len=64, prefill_chunk=8, **T)
    row = _run_stream(StepEngine(tm, **kw), tp, prompts, 7, seeds)
    eng = StepEngine(tm, paged=True, page_size=16, **kw)
    assert _run_stream(eng, tp, prompts, 7, seeds) == row
    assert eng.free_pages() == eng._pages.allocatable


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, page_size=8),
                                dict(paged=True, page_size=8,
                                     quantize_kv="int8")],
                         ids=["row", "paged", "int8"])
def test_chunked_admission_never_disturbs_inflight_rows(pair, kw):
    """A 30-token prompt streaming in 4-token chunks does not change a
    live row's tokens, and the live row decodes every tick; every page
    comes back."""
    tm, tp, _, _ = pair
    pa, pb = _prompts(tm.cfg.vocab_size, lens=(12, 30), seed=6)

    def solo(prompt, steps):
        eng = StepEngine(tm, batch_size=2, max_len=64, prefill_chunk=4,
                         **kw)
        g = eng.admit(tp, prompt, max_new=steps)[0]
        _drain(eng, tp)
        return g.tokens

    eng = StepEngine(tm, batch_size=2, max_len=64, prefill_chunk=4, **kw)
    a = eng.admit(tp, pa, max_new=10)[0]
    while not a.tokens:
        eng.prefill_tick(tp)
    b = eng.admit(tp, pb, max_new=5)[0]
    assert b.tokens == [] and eng.pending_slots() == 1
    n = len(a.tokens)
    eng.step(tp)                           # one chunk, then decode
    assert len(a.tokens) == n + 1 and b.tokens == []
    _drain(eng, tp)
    assert a.tokens == solo(pa, 10)
    assert b.tokens == solo(pb, 5)
    assert eng.free_slots() == 2
    if eng.paged:
        assert eng.free_pages() == eng._pages.allocatable


def test_int8_logit_divergence_bounded(pair):
    """``test_quantized_pages.test_int8_logit_divergence_bounded`` on the
    port: the same prompt in a float32 and an int8 page pool, the float32
    greedy stream teacher-forced through both; per step the worst logit
    error stays under 20% of the logit spread, the softmax total
    variation at T=0.8 under 0.05, same-noise sampled tokens agree over
    90% of the time, and greedy picks survive in all but two steps."""
    tm, tp, _, _ = pair
    page, P, steps, temp, L, B = 16, 4, 8, 0.8, 12, 2
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (B, L))
    logits, rows = tm.prefill(tp, toks, P * page)
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32).reshape(B, P)
    pools = {q: tm.insert_cache_pages(
        tm.init_page_pool(1 + B * P + 2, page, quantized=q), rows, tables)
        for q in (False, True)}
    tok = torch.argmax(logits[:, -1], -1)
    pos = torch.full((B,), L, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    worst_rel, worst_tv, worst_agree, greedy_same = 0.0, 0.0, 1.0, 0
    for _ in range(steps):
        lf, _ = tm.decode_step_pages(tp, pools[False], tok[:, None], pos,
                                     tables)
        lq, _ = tm.decode_step_pages(tp, pools[True], tok[:, None], pos,
                                     tables)
        lf, lq = lf[:, -1], lq[:, -1]
        spread = lf.amax(-1) - lf.amin(-1)
        rel = (lf - lq).abs().amax(-1) / spread
        tv = 0.5 * (torch.softmax(lf / temp, -1)
                    - torch.softmax(lq / temp, -1)).abs().sum(-1)
        u = torch.rand((64,) + lf.shape, generator=gen).clamp_min(1e-20)
        g = -torch.log(-torch.log(u))
        agree = ((lf / temp + g).argmax(-1)
                 == (lq / temp + g).argmax(-1)).float().mean()
        worst_rel = max(worst_rel, float(rel.max()))
        worst_tv = max(worst_tv, float(tv.max()))
        worst_agree = min(worst_agree, float(agree))
        greedy_same += int((lf.argmax(-1) == lq.argmax(-1)).all())
        tok = lf.argmax(-1)                # teacher-force the f32 stream
        pos = pos + 1
    assert worst_rel < 0.2, worst_rel
    assert worst_tv < 0.05, worst_tv
    assert worst_agree > 0.9, worst_agree
    assert greedy_same >= steps - 2


def test_engine_guards(pair):
    tm, _, _, _ = pair
    with pytest.raises(ValueError, match="paged"):
        StepEngine(tm, batch_size=2, max_len=64, quantize_kv="int8")
    with pytest.raises(ValueError, match="quantize_kv"):
        StepEngine(tm, batch_size=2, max_len=64, paged=True, page_size=16,
                   quantize_kv="int4")
    with pytest.raises(ValueError, match="prefill_chunk"):
        StepEngine(tm, batch_size=2, max_len=64, prefill_chunk=0)


# ---------------------------------------------------------------------------
# scheduler and launcher
# ---------------------------------------------------------------------------

def test_continuous_scheduler_chunked_and_int8():
    """Mixed-context, mixed-length greedy traffic: chunked row and
    chunked paged engines give the run-to-completion outputs, an int8
    chunked engine resolves every request; engines are keyed by chunk
    width and pool type, and every page drains back."""
    names = ["supersub-super", "supersub-sub"]
    server, cfgs = launch.build_server(names, 2, 64, arch_overrides=F32,
                                       device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(names[r % 2], rng.integers(0, cfgs[names[r % 2]].vocab_size,
                                            (2, [8, 40, 16][r % 3])))
                for r in range(4)]
        for kw in (dict(), dict(paged=True, page_size=16),
                   dict(paged=True, page_size=16, quantize_kv="int8")):
            with ContinuousScheduler(server, batch_size=4, prefill_chunk=8,
                                     **kw) as sched:
                outs = [f.result(timeout=120) for f in
                        [sched.submit(n, t, steps=4) for n, t in reqs]]
            for (name, toks), out in zip(reqs, outs):
                assert out.shape == (2, 4)
                if "quantize_kv" not in kw:
                    np.testing.assert_array_equal(
                        out, server.serve_batch(name, toks, steps=4))
        keys = set(server._step_engines)
        assert {(k.prefill_chunk, k.page_size, k.quantize_kv)
                for k in keys} == {(8, None, None), (8, 16, None),
                                   (8, 16, "int8")}
        for key, eng in server._step_engines.items():
            assert eng.prefill_chunk == 8 and not eng.pending_slots()
            if eng.paged:
                assert eng.free_pages() == eng._pages.allocatable
    finally:
        server.shutdown()


@pytest.mark.parametrize("flags", [
    ["--prefill-chunk", "8"],
    ["--prefill-chunk", "8", "--paged", "--page-size", "16",
     "--quantize-kv", "int8"]])
def test_launcher_chunked_and_int8(flags, capsys):
    rc = launch.main(["--platform", "cpu", "--mode", "continuous",
                      "--requests", "4", "--steps", "3", "--seq", "20",
                      "--batch", "2", *flags])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mode"] == "continuous" and rep["loads"] >= 2
    # one admit-to-first-chunk sample per request
    assert rep["latency_hists"]["admit_to_first_chunk_s"]["count"] == 4
    with pytest.raises(SystemExit) as e:
        launch.main(["--platform", "cpu", "--quantize-kv", "int8"])
    assert e.value.code == 2
    assert "requires --paged" in capsys.readouterr().err
