"""The port's speculative decoding: ``speculative_accept``,
``tree_speculative_accept`` and ``SpecEngine`` against the JAX package's,
and the speculative paths of the server, the continuous scheduler and
the launcher, on the CPU in float32.

Both engines run reduced tinyllama on the same weights (JAX init,
bridged), the draft a slightly noised copy (``_perturb``), with the JAX
engine's own uniforms and gumbel fields injected into the port's
(``JaxDraws``).  Each event of a script (admit, round, ``set_k``) must
leave the two engines with the same committed streams, per-round
accepts, page tables, free-lists and counters.  Inside the port a
greedy speculative stream must equal the port's own ``StepEngine``
greedy stream bitwise, and the accept rules must keep the committed
tokens target-distributed under torch's own generator."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.launch import serve as jax_launch  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve import speculative as jspec  # noqa: E402
from repro.serve.scheduler import (  # noqa: E402
    ContinuousScheduler as JaxContinuousScheduler)
from repro.serve.switching import ServedModel as JaxServedModel  # noqa: E402
from repro.serve.switching import (  # noqa: E402
    SwitchableServer as JaxSwitchableServer)
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.serve.speculative import (  # noqa: E402
    SpecEngine, SpecKey, speculative_accept, tree_speculative_accept)
from repro_torch.serve.switching import (ServedModel,  # noqa: E402
                                         SwitchableServer)
from test_spec_paged import _perturb  # noqa: E402
from test_torch_serve import JaxDraws  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def models():
    """Reduced tinyllama in float32 in both packages: (port LM, JAX LM,
    {"t": target, "d": draft} params as (port, JAX) pairs).  The draft
    is the target's weights noised by ``_perturb`` (at 0.002: its argmax
    mostly agrees, sometimes lands on the runner-up, so rounds accept
    partly and trees take their sibling path)."""
    jm = jax_build(jax_reduced(jax_get_arch("tinyllama-1.1b"), **F32),
                   cache_dtype=jnp.float32)
    jt = jm.init(jax.random.key(0))
    jd = _perturb(jt, scale=0.002)
    tm = build_model(override(reduced(get_arch("tinyllama-1.1b")), **F32),
                     cache_dtype=torch.float32, device="cpu")

    def bridge(p):
        return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    return tm, jm, {"t": (bridge(jt), jt), "d": (bridge(jd), jd)}


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)).astype(np.int32) for n in lens]


def _np(x):
    """A numpy copy (a CPU tensor's buffer is written in place later)."""
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


def _record_rounds(eng, log):
    """Log each round's accepts as the engine's verify program returns
    them, for the rows live in that round: toks, m (and for a tree
    alt_depth, alt_tok).  The same hook on either package's engine."""
    orig = eng._call

    def call(which, fn, params, *args):
        out = orig(which, fn, params, *args)
        fns = eng._fns.get(eng.k, {})
        if which == "target" and fn is fns.get("verify"):
            live = np.nonzero(eng._live)[0]
            keep = 4 if eng.tree_width > 1 else 2
            log.append([_np(x)[live] for x in out[:keep]])
        return out
    eng._call = call


def _snapshot(eng) -> dict:
    """Host- and device-side state of a spec engine of either package."""
    st = eng.state
    return {"tok": _np(st.tok), "pos": _np(st.pos),
            "d_table": _np(st.d_table), "t_table": _np(st.t_table),
            "t_free": list(eng._t_pages._free),
            "d_free": list(eng._d_pages._free),
            "slots": list(eng._free), "live": eng._live.copy(),
            "k": eng.k, "stats": dict(eng.stats)}


def _assert_same(got: dict, want: dict, where):
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{where}: {key}")
        else:
            assert got[key] == want[key], (where, key, got[key], want[key])


def _run_script(eng, params, script):
    """Play ``script`` on ``eng``: ("admit", prompt, max_new), ("step",),
    ("set_k", k) or ("drain",).  -> (streams, per-event snapshots,
    per-round accepts)."""
    gens, snaps, rounds = [], [], []
    _record_rounds(eng, rounds)
    for ev in script:
        if ev[0] == "admit":
            gens += eng.admit(params, ev[1], max_new=ev[2])
        elif ev[0] == "step":
            eng.step(params)
        elif ev[0] == "set_k":
            eng.set_k(ev[1])
        else:
            eng.drain(params)
        snaps.append(_snapshot(eng))
    return [list(g.tokens) for g in gens], snaps, rounds


def _pair_engines(models, temperature=0.0, draft="d", **kw):
    tm, jm, p = models
    jeng = jspec.SpecEngine(jm, jm, temperature=temperature, **kw)
    teng = SpecEngine(tm, tm, temperature=temperature,
                      sampler=JaxDraws("cpu"), **kw)
    return (jeng, (p[draft][1], p["t"][1])), (teng, (p[draft][0],
                                                      p["t"][0]))


def _check_against_jax(models, script, temperature=0.0, draft="d", **kw):
    """Run ``script`` on the JAX engine and on the port's (JAX's draws
    injected) and hold every event's outcome equal.  -> (port engine,
    streams, rounds)."""
    (jeng, jp), (teng, tp) = _pair_engines(models, temperature, draft, **kw)
    want, wsnaps, wrounds = _run_script(jeng, jp, script)
    got, gsnaps, grounds = _run_script(teng, tp, script)
    assert got == want
    for i, (g, w) in enumerate(zip(gsnaps, wsnaps)):
        _assert_same(g, w, f"event {i} {script[i][0]}")
    assert len(grounds) == len(wrounds)
    for i, (g, w) in enumerate(zip(grounds, wrounds)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"round {i}")
    return teng, got, grounds


def _staggered(vocab, steps=10, lens=(9, 9, 9), seed=5):
    """Row 0 runs a round alone, then two more rows join (one prompt
    length: each new length costs the JAX engine its compiles)."""
    p = _prompts(vocab, lens, seed)
    return [("admit", p[0], steps), ("step",), ("admit", p[1], steps),
            ("admit", p[2], steps - 3), ("drain",)]


def _greedy_ref(models, prompt, steps, params="t"):
    """The port's own plain greedy stream (``StepEngine``, row cache)."""
    tm, _, p = models
    out = ServingEngine(tm, p[params][0], max_len=64).generate(prompt, steps)
    return [int(t) for t in out[0]]


# ---------------------------------------------------------------------------
# the accept rules
# ---------------------------------------------------------------------------

def _accept_inputs(B, K, W, V, seed):
    """Random target/draft logits and candidates that agree with the
    target's argmax often enough to reach every branch: a chain hit, a
    later sibling's hit, and a miss."""
    rng = np.random.default_rng(seed)
    Kt = 1 + K * W if W else K + 1
    tl = rng.normal(size=(B, Kt, V)).astype(np.float32) * 1.5
    dl = (tl[:, :K] + rng.normal(size=(B, K, V)) * 0.5).astype(np.float32)
    tgt = tl.argmax(-1)
    if not W:
        props = tgt[:, :K].copy()
        miss = rng.random((B, K)) < 0.3
        props[miss] = rng.integers(0, V, miss.sum())
        return tl, dl, props.astype(np.int32)
    cand = rng.integers(0, V, (B, K, W)).astype(np.int32)
    for i in range(K):
        parent = 0 if i == 0 else 1 + (i - 1) * W
        hit = rng.integers(0, W + 1, B)          # W: no sibling hits
        rows = np.nonzero(hit < W)[0]
        cand[rows, i, hit[rows]] = tgt[rows, parent]
    return tl, dl, cand


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_accept_rules_match_jax(tree, temperature):
    """Both accept functions on the same logits and (at temperature)
    JAX's own uniform and gumbel fields: tokens, n, alt_depth and alt_tok
    identical."""
    B, K, W, V = 256, 3, 3, 32
    tl, dl, props = _accept_inputs(B, K, W if tree else 0, V, seed=1)
    key = jax.random.key(7)
    f = jax.random.fold_in

    def g(k):
        return torch.from_numpy(np.array(
            jax.random.gumbel(k, (B, V), jnp.float32)))
    t = [torch.from_numpy(x) for x in (props, dl, tl)]
    if tree:
        want = jspec.tree_speculative_accept(key, props, dl, tl, temperature)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, K, W))))
        got = tree_speculative_accept(*t, temperature, u, g(f(key, 1)),
                                      g(f(key, 2)))
    else:
        want = jspec.speculative_accept(key, props, dl, tl, temperature)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, K))))
        got = speculative_accept(*t, temperature, u, g(f(key, 1)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = got[1].numpy()
    assert 0 < (n == 0).sum() and 0 < (n == K).sum()     # every branch
    if tree:
        assert (got[2].numpy() > 0).sum() > 0


def _gumbel(gen, shape):
    u = torch.rand(shape, generator=gen).clamp_min(
        torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def test_flat_accept_is_target_distributed():
    """The first committed token's marginal is the TARGET distribution
    under a disagreeing draft, with torch's generator drawing the
    proposals, the uniforms and the residual field (JAX's test)."""
    V, K, T, N = 8, 2, 1.0, 40_000
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((K, V), generator=gen) * 1.5
    t = torch.randn((K + 1, V), generator=gen) * 1.5
    qb, tb = q.expand(N, K, V), t.expand(N, K + 1, V)
    props = torch.argmax(qb / T + _gumbel(gen, (N, K, V)), dim=-1)
    tokens, n = speculative_accept(props, qb, tb, T,
                                   torch.rand((N, K), generator=gen),
                                   _gumbel(gen, (N, V)))
    assert 0 < n.float().mean() < K
    emp = np.bincount(tokens[:, 0].numpy(), minlength=V) / N
    np.testing.assert_allclose(emp, torch.softmax(t[0] / T, -1).numpy(),
                               atol=0.013)


def test_tree_accept_is_target_distributed():
    """Exact tree speculative sampling: W i.i.d. draft candidates per
    depth, the depth-1 committed token distributed as target sampling at
    the root (JAX's test, under torch's generator)."""
    B, K, W, V, T = 40_000, 2, 2, 16, 1.0
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((K, V), generator=gen) * 1.5
    t = torch.randn((1 + K * W, V), generator=gen) * 1.5
    cand = torch.argmax(q[None, :, None, :] / T
                        + _gumbel(gen, (B, K, W, V)), dim=-1)
    toks, n, alt_depth, _ = tree_speculative_accept(
        cand, q.expand(B, K, V), t.expand(B, 1 + K * W, V), T,
        torch.rand((B, K, W), generator=gen), _gumbel(gen, (B, V)),
        _gumbel(gen, (B, V)))
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / B
    np.testing.assert_allclose(emp, torch.softmax(t[0] / T, -1).numpy(),
                               atol=0.015)
    assert ((n >= 0) & (n <= K)).all() and (alt_depth > 0).any()


def test_greedy_tree_sibling_zero_is_argmax():
    """The greedy tree's candidates are the top W with ties to the lowest
    index, so sibling 0 is ``argmax`` even among tied logits."""
    from repro_torch.serve.speculative import _top_w
    x = torch.tensor([[0.0, 2.0, 5.0, 5.0, 1.0, 5.0],
                      [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]])
    np.testing.assert_array_equal(_top_w(x, 3).numpy(),
                                  [[2, 3, 5], [0, 1, 2]])
    np.testing.assert_array_equal(
        _top_w(x, 3).numpy(), np.asarray(jax.lax.top_k(x.numpy(), 3)[1]))
    assert (_top_w(x, 1)[:, 0] == torch.argmax(x, -1)).all()


# ---------------------------------------------------------------------------
# engines against JAX
# ---------------------------------------------------------------------------

def _adaptive(vocab):
    """Staggered rows with the depth moved between rounds (set_k clamps
    0 and 99 into [1, k_max])."""
    p = _prompts(vocab, (9, 9, 9), 5)
    return [("admit", p[0], 12), ("step",), ("set_k", 2),
            ("admit", p[1], 12), ("step",), ("set_k", 0), ("step",),
            ("set_k", 99), ("admit", p[2], 9), ("drain",)]


def _recycling(vocab):
    """Admission draws: an instant retire (max_new=1, then the key is
    salted), a slot freed by a round and recycled at the next boundary,
    and a re-admission of the same prompt."""
    p = _prompts(vocab, (9, 9, 9), 6)
    return [("admit", p[0], 1), ("admit", p[1], 2), ("admit", p[2], 9),
            ("step",), ("admit", p[0], 6), ("admit", p[1], 1), ("step",),
            ("admit", p[1], 5), ("drain",)]


CASES = {
    # flat greedy, one-shot, adaptive K
    "greedy-adaptive": dict(script=_adaptive, greedy=True),
    # flat greedy, chunked, EOS inside an accepted block
    "greedy-chunked-eos": dict(script=_staggered, greedy=True,
                               prefill_chunk=3, eos=True),
    "temp-recycled": dict(script=_recycling, temperature=1.3),
    "tree2": dict(script=_staggered, greedy=True, tree_width=2),
    "tree3-temp-chunked": dict(script=lambda v: _staggered(v, seed=11),
                               temperature=1.1, tree_width=3,
                               prefill_chunk=4),
    # int8 columns, the draft the target itself
    "int8-aligned": dict(script=_staggered, greedy=True,
                         quantize_kv="int8", draft="t"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_matches_jax(models, case):
    """Every event of the case's script leaves the port's engine and the
    JAX engine alike: streams, each round's accepts (and a tree's
    alt_depth / alt_tok), tok, pos, both page tables, both free-lists,
    the slot free-list, k and every counter.  Greedy streams are also
    the port's own plain greedy streams, bitwise."""
    spec = dict(CASES[case])
    tm = models[0]
    script = spec.pop("script")(tm.cfg.vocab_size)
    greedy = spec.pop("greedy", False)
    eos = spec.pop("eos", False)
    draft = spec.pop("draft", "d")
    kw = dict(batch_size=3, max_len=64, k=4, page_size=8, **spec)
    if eos:
        prompt = script[0][1]
        ref = _greedy_ref(models, prompt, 10)
        kw["eos_id"] = ref[4]       # inside row 0's stream
        eos_at = ref.index(ref[4])
    eng, got, rounds = _check_against_jax(models, script, draft=draft, **kw)
    admits = [ev for ev in script if ev[0] == "admit"]
    if greedy:
        for (_, prompt, steps), stream in zip(admits, got):
            ref = _greedy_ref(models, prompt, steps)
            if eos:
                ref = ref[:ref.index(kw["eos_id"]) + 1] if (
                    kw["eos_id"] in ref) else ref
            assert stream == ref
    if eos:
        assert len(got[0]) == eos_at + 1
    assert eng.stats["committed_tokens"] > eng.stats["row_rounds"]
    if spec.get("tree_width", 1) > 1:
        assert any((r[2] > 0).any() for r in rounds)   # sibling path
    if draft == "t":
        assert eng.accepted_per_round > 3.0
    assert eng.free_slots() == 3
    assert eng.free_pages() == eng._d_pages.allocatable


def test_tree_verify_logits_match_jax(models):
    """One tree round's verify pass (W=3, 13 nodes, depth offsets and
    ancestor bitmasks built once per depth) on the same admitted state:
    the port's logits within the model limit of JAX's."""
    tm, jm, p = models
    (jeng, jp), (teng, tp) = _pair_engines(models, batch_size=2, max_len=64,
                                           k=4, tree_width=3, page_size=8)
    prompts = _prompts(tm.cfg.vocab_size, (7, 12), 8)
    for pr in prompts:
        jeng.admit(jp, pr, max_new=6)
        teng.admit(tp, pr, max_new=6)
    fns = teng._programs(4)
    W, K = 3, 4
    offsets = np.concatenate([[0], np.repeat(np.arange(1, K + 1), W)])
    np.testing.assert_array_equal(fns["offsets"].numpy(), offsets)
    chain = [1 + (i - 1) * W for i in range(1, K + 1)]
    for j in range(1, 1 + K * W):
        i = (j - 1) // W + 1
        want = 1 | (1 << j)
        for d in range(1, i):
            want |= 1 << chain[d - 1]
        assert int(fns["tree"][0, j]) == want
    block = np.random.default_rng(9).integers(
        0, tm.cfg.vocab_size, (2, 1 + K * W)).astype(np.int32)
    wmask = np.broadcast_to(fns["writer"].numpy(), block.shape)
    jst, tst = jeng.state, teng.state
    want, _ = jm.verify_step_pages(
        jp[1], jst.t_caches, jnp.asarray(block), jst.pos, jst.t_table,
        wmask=jnp.asarray(wmask), offsets=jnp.asarray(offsets, jnp.int32),
        tree=jnp.asarray(fns["tree"].numpy()))
    got, _ = tm.verify_step_pages(
        tp[1], tst.t_caches, torch.from_numpy(block), tst.pos, tst.t_table,
        wmask=torch.from_numpy(wmask.copy()), offsets=fns["offsets"],
        tree=fns["tree"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_spec_engine_admissions_draw_independently(models):
    """Re-admitting one prompt into one slot at temperature > 0 draws a
    fresh field each time (the key moves every round and is salted past
    t=0), under torch's own generator."""
    tm, _, p = models
    prompt = _prompts(tm.cfg.vocab_size, (10,), 8)[0]
    eng = SpecEngine(tm, tm, batch_size=1, max_len=48, k=3,
                     temperature=1.5)
    firsts = []
    for _ in range(6):
        g = eng.admit((p["d"][0], p["t"][0]), prompt, max_new=4)[0]
        while not g.done:
            eng.step((p["d"][0], p["t"][0]))
        firsts.append(g.tokens[0])
    assert len(set(firsts)) > 1


def _bank_servers(models):
    """A JAX and a port server, each with the target ("tgt") and the
    draft ("drf") on one model, the step and spec engines of "tgt" over
    one shared bank with the prefix cache on."""
    tm, jm, p = models
    out = []
    for i, (cls, smc, model) in enumerate((
            (JaxSwitchableServer, JaxServedModel, jm),
            (lambda: SwitchableServer(device="cpu"), ServedModel, tm))):
        srv = cls()
        srv.register(smc(name="tgt", model=model,
                         weights_fn=lambda w=p["t"][1 - i]: w, max_len=32))
        srv.register(smc(name="drf", model=model,
                         weights_fn=lambda w=p["d"][1 - i]: w, max_len=32))
        step = srv.step_engine("tgt", batch_size=2, paged=True, page_size=8,
                               prefix_cache=True, share_bank=True,
                               num_pages=2 * 4 + 6)
        spec = srv.spec_engine("tgt", "drf", batch_size=2, k=3, page_size=8,
                               prefix_cache=True, share_bank=True)
        out.append((srv, step, spec, (p["d"][1 - i], p["t"][1 - i])))
    out[1][2].sampler = JaxDraws("cpu")
    return out


def test_shared_bank_prefix_hits_both_ways_match_jax(models):
    """One ``SharedBank`` behind a plain paged ``StepEngine`` and a
    ``SpecEngine`` of one context: a prompt the plain engine served is a
    hit on the spec target column, and a prompt the spec engine served a
    hit for the plain engine.  Streams, hit counters, the bank's
    free-list and the tables equal the JAX engines'; both streams are
    the target's greedy stream."""
    tm = models[0]
    pa, pb = _prompts(tm.cfg.vocab_size, (12, 17), 7)
    logs = []
    for srv, step, spec, (dp, tp) in _bank_servers(models):
        assert step._prefix is spec._prefix and step._pages is spec._t_pages
        log = []
        g = step.admit(tp, pa, max_new=8)          # plain first ...
        step.drain(tp)
        h = spec.admit((dp, tp), pa, max_new=8)    # ... then a spec hit
        spec.drain((dp, tp))
        log += [list(g[0].tokens), list(h[0].tokens),
                dict(spec.stats), list(spec._t_pages._free)]
        h = spec.admit((dp, tp), pb, max_new=6)    # spec first ...
        log.append(_np(spec.state.t_table))
        spec.drain((dp, tp))
        g = step.admit(tp, pb, max_new=6)          # ... then a plain hit
        step.drain(tp)
        log += [list(h[0].tokens), list(g[0].tokens),
                {k: step.stats[k] for k in ("prefix_hits",
                                            "prefix_pages_mapped",
                                            "cow_copies")},
                list(step._pages._free), dict(spec.stats)]
        logs.append(log)
        srv.shutdown()
    want, got = logs
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            assert a == b, (i, a, b)
    assert got[2]["prefix_hits"] == 1 and got[7]["prefix_hits"] == 1
    assert got[0] == got[1] == _greedy_ref(models, pa, 8)
    assert got[5] == got[6] == _greedy_ref(models, pb, 6)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refusals(pkg):
    """Each refusal of the spec engine, as a thunk, for one package."""
    if pkg == "jax":
        def make(name, **over):
            return jax_build(jax_reduced(jax_get_arch(name), **over))
        Spec, pool = jspec.SpecEngine, jspec.PagePool
        bank = jspec.SharedBank
    else:
        def make(name, **over):
            return build_model(override(reduced(get_arch(name)), **over),
                               device="cpu")
        from repro_torch.serve.pool import PagePool, SharedBank
        Spec, pool, bank = SpecEngine, PagePool, SharedBank
    m = make("tinyllama-1.1b")
    cases = {
        "recurrent draft": lambda: Spec(make("jamba-v0.1-52b"), m, 1, 32),
        "ring target": lambda: Spec(m, make("supersub-super",
                                            sliding_window=16), 1, 32),
        "vocab": lambda: Spec(make("tinyllama-1.1b", vocab_size=128), m,
                              1, 32),
        "k": lambda: Spec(m, m, 1, 32, k=0),
        "tree width": lambda: Spec(m, m, 1, 32, tree_width=0),
        "tree nodes": lambda: Spec(m, m, 1, 32, k=8, tree_width=4),
        "quantize": lambda: Spec(m, m, 1, 32, quantize_kv="fp8"),
        "chunk": lambda: Spec(m, m, 1, 32, prefill_chunk=0),
        "page size": lambda: Spec(m, m, 1, 48, page_size=32),
        "num pages": lambda: Spec(m, m, 1, 32, page_size=8, num_pages=4),
        "bank": lambda: Spec(m, m, 1, 32, page_size=8,
                             bank=bank(pool(4))),
    }
    return m, Spec, cases


def test_refusals_match_jax():
    """Every refusal of the constructor and of ``admit`` raises JAX's
    error type with JAX's message."""
    jm, JSpec, jcases = _refusals("jax")
    tm, TSpec, tcases = _refusals("port")
    for name in jcases:
        with pytest.raises(Exception) as want:
            jcases[name]()
        with pytest.raises(type(want.value)) as got:
            tcases[name]()
        assert str(got.value) == str(want.value), name
    prompt = np.zeros((1, 20), np.int32)
    for kw in (dict(seeds=[7]), dict()):       # seeds; past max_len
        with pytest.raises(ValueError) as want:
            JSpec(jm, jm, 1, 32, k=4).admit(None, prompt, max_new=9, **kw)
        with pytest.raises(ValueError) as got:
            TSpec(tm, tm, 1, 32, k=4).admit(None, prompt, max_new=9, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# scheduler, server and launcher
# ---------------------------------------------------------------------------

def test_scheduler_mixed_spec_and_plain_traffic():
    """A speculative context (supersub-super drafted by supersub-sub)
    beside a plain one through one ``ContinuousScheduler`` on 3 weight
    slots: every future equals the plain run-to-completion answer, the
    snapshot carries JAX's ``spec_*`` keys, and seeds are refused on
    the speculative context with JAX's message."""
    names = ["supersub-super", "supersub-sub", "tinyllama-1.1b"]
    server, cfgs = launch.build_server(names, 3, 40, load_delay_s=0.01,
                                       arch_overrides=F32, device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(n, rng.integers(0, cfgs[n].vocab_size, (1, 12)))
                for n in ["supersub-super", "tinyllama-1.1b"] * 4]
        draft = {"supersub-super": "supersub-sub"}
        with ContinuousScheduler(server, batch_size=2, draft=draft,
                                 spec_k=3) as sched:
            with pytest.raises(ValueError) as got:
                sched.submit("supersub-super", reqs[0][1], steps=2, seed=1)
            with pytest.raises(ValueError) as over:
                sched.submit("supersub-super", reqs[0][1], steps=26)
            futs = [sched.submit(n, t, steps=6) for n, t in reqs]
            outs = [f.result(timeout=300) for f in futs]
        jsched = JaxContinuousScheduler(JaxSwitchableServer(), draft=draft,
                                        spec_k=3)
        jsched.server._served = {n: JaxServedModel(n, None, None, 40)
                                 for n in names}
        for exc, kw in ((got, dict(steps=2, seed=1)), (over,
                                                      dict(steps=26))):
            with pytest.raises(ValueError) as want:
                jsched.submit("supersub-super", reqs[0][1], **kw)
            assert str(exc.value) == str(want.value)
        snap, jsnap = sched.snapshot(), jsched.snapshot()
        assert set(jsnap) <= set(snap)
        assert {"spec_rounds", "spec_committed_tokens",
                "accepted_tokens_per_round",
                "spec_acceptance_rate"} <= set(snap)
        assert snap["spec_rounds"] > 0 and snap["loads"] >= 3
        assert 1.0 <= snap["accepted_tokens_per_round"] <= 4.0
        for (name, toks), out in zip(reqs, outs):
            np.testing.assert_array_equal(
                out, server.serve_batch(name, toks, steps=6))
        key = sched._spec_key("supersub-super")
        assert isinstance(key, SpecKey) and key in server._spec_engines
    finally:
        server.shutdown()


def test_spec_step_failure_fails_only_its_context():
    """A failing speculative round fails the speculative context's
    request, resets its engine, and leaves the plain context serving."""
    names = ["supersub-super", "supersub-sub", "tinyllama-1.1b"]
    server, cfgs = launch.build_server(names, 3, 40, device="cpu")
    try:
        sched = ContinuousScheduler(server, batch_size=2,
                                    draft={"supersub-super": "supersub-sub"},
                                    spec_k=2)
        bad = sched._engine("supersub-super")
        assert isinstance(bad, SpecEngine) and bad.runner is not None

        def boom(params=None):
            raise RuntimeError("injected round failure")
        bad.step = boom
        rng = np.random.default_rng(1)
        with sched:
            fb = sched.submit("supersub-super", rng.integers(0, 256, (1, 8)),
                              steps=4)
            fa = sched.submit("tinyllama-1.1b", rng.integers(0, 256, (1, 8)),
                              steps=4)
            with pytest.raises(RuntimeError, match="injected"):
                fb.result(timeout=120)
            assert fa.result(timeout=300).shape == (1, 4)
        assert bad.live_slots() == 0
    finally:
        server.shutdown()


def test_adapt_k_matches_jax():
    """The scheduler's acceptance EWMA walks K as JAX's does, event for
    event, over a scripted run of per-tick counters."""
    class Eng:
        def __init__(self):
            self.k, self.k_max = 4, 4
            self.stats = {"committed_tokens": 0, "row_rounds": 0}

        def set_k(self, k):
            self.k = max(1, min(int(k), self.k_max))

    draft = {"t": "d"}
    scheds = [cls(srv, draft=draft, spec_k=4, spec_adaptive=True)
              for cls, srv in ((JaxContinuousScheduler,
                                JaxSwitchableServer()),
                               (ContinuousScheduler,
                                SwitchableServer(device="cpu")))]
    engs = [Eng(), Eng()]
    rng = np.random.default_rng(3)
    trail = [[], []]
    for _ in range(60):
        rows = int(rng.integers(0, 3))
        per = float(rng.choice([1.0, 1.5, 4.0, 5.0]))
        for s, e, t in zip(scheds, engs, trail):
            e.stats["row_rounds"] += rows
            e.stats["committed_tokens"] += int(rows * per)
            s._adapt_k("t", e)
            t.append((e.k, round(s._accept_ewma.get("t", -1.0), 12)))
    assert trail[0] == trail[1]
    assert len({k for k, _ in trail[1]}) > 2


def test_launcher_speculative_report(capsys):
    """``--mode speculative --draft ... --spec-k 3 --spec-tree 2
    --spec-adaptive`` on the CPU: the report carries every key of the
    JAX launcher's report for the same flags; only ``--x64`` is still
    refused as not ported."""
    flags = ["--mode", "speculative", "--archs",
             "supersub-super,supersub-sub", "--draft", "supersub-sub",
             "--spec-k", "3", "--spec-tree", "2", "--spec-adaptive",
             "--requests", "2", "--steps", "4", "--seq", "8", "--batch",
             "1", "--pool", "2"]
    assert jax_launch.main(flags) == 0
    want = json.loads(capsys.readouterr().out)
    assert launch.main(["--platform", "cpu", *flags]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(want) <= set(got)
    assert got["spec_rounds"] > 0 and got["mode"] == "speculative"
    for bad in (["--x64"], ["--mode", "continuous", "--spec-tree", "2"],
                ["--mode", "speculative"],
                ["--mode", "speculative", "--draft", "x"],
                ["--mode", "speculative", "--draft", "supersub-sub",
                 "--spec-k", "8", "--spec-tree", "4"]):
        with pytest.raises(SystemExit) as e:
            launch.main(["--platform", "cpu", *bad])
        assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
