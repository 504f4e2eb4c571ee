"""The port's serving tier: step engines against the JAX package's, the
slot- and page-pool invariants within the port, and the schedulers and
launcher end to end, all on the CPU in float32.

Cross-framework streams run on the same weights (JAX init, bridged).
Greedy streams must be identical.  torch and JAX generators draw
different numbers, so the temperature streams are compared with JAX's
own gumbel fields injected through the engine's ``sampler`` hook."""
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import (GumbelDraws, ServingEngine,  # noqa: E402
                                      StepEngine)
from repro_torch.serve.scheduler import (ContinuousScheduler,  # noqa: E402
                                         SwitchScheduler)

F32 = dict(dtype="float32", param_dtype="float32")
CACHE_RTOL = 2e-5


def cache_close(got, want, rtol=CACHE_RTOL):
    """One cache leaf written by a K-token ``verify_step`` against the same
    leaf written by K sequential ``decode_step`` calls: ``|got - want| <=
    rtol * max|want|`` on every element.  The two passes sum in different
    orders (a (B, K) block and (B, 1) steps take different BLAS paths,
    chosen by the machine's thread count), which moves every element by
    a few f32 ulps of the leaf's largest value: an elementwise relative
    limit fails the small elements.  A slot written at the wrong position
    moves by the values' own size, far past this limit."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    limit = rtol * float(np.abs(want).max())
    assert err <= limit, (f"max |verify - decode| {err:.3e} > {rtol} * "
                          f"max|decode| = {limit:.3e}")


@pytest.fixture(scope="module")
def pair():
    """(port LM, port params, JAX LM, JAX params): reduced tinyllama
    (G=2) in float32, JAX weights bridged into the port."""
    jm = jax_build(jax_reduced(jax_get_arch("tinyllama-1.1b"), **F32),
                   cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(override(reduced(get_arch("tinyllama-1.1b")), **F32),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def _prompts(vocab, lens=(12, 40), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)).astype(np.int32) for n in lens]


def _drain(eng, p):
    while eng.live_slots():
        eng.step(p)


def _run_stream(eng, p, prompts, steps, seeds):
    """Admit request 0, step twice, admit request 1 (rows at different
    positions), drain.  Returns the token lists."""
    gens = [eng.admit(p, prompts[0], max_new=steps, seeds=[seeds[0]])[0]]
    for _ in range(2):
        eng.step(p)
    gens.append(eng.admit(p, prompts[1], max_new=steps,
                          seeds=[seeds[1]])[0])
    _drain(eng, p)
    return [list(g.tokens) for g in gens]


class JaxDraws(GumbelDraws):
    """The JAX step engine's draw schedule, keys and fields, handed to
    the port's engine (``jax.random`` keys in place of ``_mix`` seeds)."""

    def reset(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.t = 0

    def advance(self):
        self.key = jax.random.fold_in(self.key, self.t)
        self.t += 1
        return self.key

    def admit_key(self):
        if self.t == 0:
            return self.key
        return jax.random.fold_in(self.key, (1 << 30) ^ self.t)

    def salt(self):
        self.key = jax.random.fold_in(self.key, (1 << 30) | self.t)

    def field(self, key, shape):
        return torch.from_numpy(np.array(
            jax.random.gumbel(key, shape, jnp.float32)))

    def uniform(self, key, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32)))

    def fold(self, key, x):
        return jax.random.fold_in(key, x)

    def rows(self, seeds, produced_at, V):
        return torch.stack([self.field(jax.random.fold_in(
            jax.random.PRNGKey(int(s)), int(p)), (V,))
            for s, p in zip(seeds, produced_at)])


# ---------------------------------------------------------------------------
# step engine against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_step_engine_streams_match_jax(pair, paged, temperature):
    """Staggered admission, one seeded and one pool-schedule row: the
    port's token streams equal the JAX engine's, greedy and (with JAX's
    gumbel fields injected) at temperature."""
    tm, tp, jm, jp = pair
    prompts = _prompts(tm.cfg.vocab_size)
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=64, temperature=temperature,
              paged=paged, page_size=16)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 6, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _run_stream(eng, tp, prompts, 6, seeds) == want


# ---------------------------------------------------------------------------
# invariants within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_paged_streams_bitwise_identical_to_row(pair, temperature):
    tm, tp, _, _ = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(9, 30), seed=5)
    seeds = [11, None] if temperature > 0 else [None, None]
    row = StepEngine(tm, batch_size=2, max_len=64, temperature=temperature)
    ref = _run_stream(row, tp, prompts, 7, seeds)
    eng = StepEngine(tm, batch_size=2, max_len=64, temperature=temperature,
                     paged=True, page_size=16)
    assert _run_stream(eng, tp, prompts, 7, seeds) == ref
    assert eng.free_pages() == eng._pages.allocatable
    assert eng.free_slots() == 2


@pytest.mark.parametrize("paged", [False, True])
def test_admission_never_disturbs_inflight_rows(pair, paged):
    tm, tp, _, _ = pair
    pa, pb = _prompts(tm.cfg.vocab_size, lens=(12, 20), seed=6)
    kw = dict(batch_size=2, max_len=64, paged=paged, page_size=16)

    def solo(prompt, steps):
        eng = StepEngine(tm, **kw)
        g = eng.admit(tp, prompt, max_new=steps)[0]
        _drain(eng, tp)
        return g.tokens

    eng = StepEngine(tm, **kw)
    ga = eng.admit(tp, pa, max_new=10)[0]
    for _ in range(3):
        eng.step(tp)
    gb = eng.admit(tp, pb, max_new=5)[0]          # joins mid-decode
    _drain(eng, tp)
    assert ga.tokens == solo(pa, 10)
    assert gb.tokens == solo(pb, 5)
    assert ga.slot != gb.slot and eng.free_slots() == 2


def test_pages_drain_back_without_leak(pair):
    """Randomized admit / failed-admit / step churn: a failed admission
    restores its slots and pages exactly, and every page comes back."""
    tm, tp, _, _ = pair
    eng = StepEngine(tm, batch_size=3, max_len=48, paged=True, page_size=8,
                     num_pages=12)
    rng = np.random.default_rng(7)
    for _ in range(40):
        action = rng.integers(0, 4)
        S, steps = int(rng.integers(3, 25)), int(rng.integers(1, 9))
        toks = rng.integers(0, tm.cfg.vocab_size, (1, S))
        if action == 0 and eng.can_admit(toks, steps):
            g = eng.admit(tp, toks, max_new=steps)[0]
            assert len(g.pages) == eng.pages_needed(S, steps)
        elif action == 1:
            before = (list(eng._free), list(eng._pages._free))
            with pytest.raises((TypeError, RuntimeError)):   # no params /
                eng.admit(None, toks, max_new=steps)            # no room
            assert (list(eng._free), list(eng._pages._free)) == before
        else:
            eng.step(tp)
    _drain(eng, tp)
    assert eng.free_pages() == eng._pages.allocatable
    assert eng.free_slots() == 3


def test_generate_and_generate_paged_agree(pair):
    tm, tp, _, _ = pair
    toks = np.random.default_rng(8).integers(0, tm.cfg.vocab_size, (3, 10))
    for T in (0.0, 0.7):
        se = ServingEngine(tm, tp, max_len=32, temperature=T)
        a = se.generate(toks, 5, seed=4)
        b = se.generate_paged(toks, 5, page=8, seed=4)
        assert a.shape == (3, 5)
        np.testing.assert_array_equal(a, b)


def test_unported_options_raise(pair):
    """The prefix cache and a shared bank need a paged engine (JAX's
    ``ValueError``s); a speculative context (``draft=``) builds and
    serves a request."""
    tm, _, _, _ = pair
    for kw in (dict(prefix_cache=True), dict(bank=object())):
        with pytest.raises(ValueError, match="paged"):
            StepEngine(tm, batch_size=2, max_len=32, **kw)
    server, cfgs = launch.build_server(["supersub-super", "supersub-sub"],
                                       2, 32, device="cpu")
    try:
        with ContinuousScheduler(
                server, batch_size=2,
                draft={"supersub-super": "supersub-sub"}) as sched:
            toks = np.arange(8)[None] % cfgs["supersub-super"].vocab_size
            out = sched.submit("supersub-super", toks, steps=3).result(
                timeout=120)
        assert out.shape == (1, 3)
        assert sched.snapshot()["spec_rounds"] > 0
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# schedulers and launcher
# ---------------------------------------------------------------------------

def test_continuous_scheduler_paged_matches_serve_batch():
    """Mixed-context, mixed-length greedy traffic through paged pools
    gives the run-to-completion outputs; every page drains back."""
    names = ["supersub-super", "supersub-sub"]
    server, cfgs = launch.build_server(names, 2, 64, load_delay_s=0.01,
                                       arch_overrides=F32, device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(names[r % 2], rng.integers(0, cfgs[names[r % 2]].vocab_size,
                                            (2, [8, 40, 16][r % 3])))
                for r in range(6)]
        with ContinuousScheduler(server, batch_size=4, paged=True,
                                 page_size=16) as sched:
            futs = [sched.submit(n, t, steps=4) for n, t in reqs]
            outs = [f.result(timeout=120) for f in futs]
        for (name, toks), out in zip(reqs, outs):
            assert out.shape == (2, 4)
            np.testing.assert_array_equal(
                out, server.serve_batch(name, toks, steps=4))
        for key, eng in server._step_engines.items():
            assert key.page_size == 16 and eng.paged
            assert eng.free_pages() == eng._pages.allocatable
    finally:
        server.shutdown()


def test_switch_scheduler_matches_sync_and_switches_fewer():
    """Round-robin requests over 3 contexts on 2 slots: every future
    equals the synchronous server's output, and the coalescing scheduler
    flips contexts strictly fewer times than arrival order does."""
    names = ["supersub-super", "supersub-sub", "tinyllama-1.1b"]
    a, cfgs = launch.build_server(names, 2, 40, device="cpu")
    b, _ = launch.build_server(names, 2, 40, device="cpu")
    try:
        rng = np.random.default_rng(1)
        reqs = [(names[r % 3],
                 rng.integers(0, cfgs[names[r % 3]].vocab_size, (2, 16)))
                for r in range(9)]
        with SwitchScheduler(a) as sched:
            futs = [sched.submit(n, t, steps=2, seed=100 + i)
                    for i, (n, t) in enumerate(reqs)]
            outs = [f.result(timeout=120) for f in futs]
        queue_changes = a.engine.stats["context_changes"]
        for i, ((name, toks), out) in enumerate(zip(reqs, outs)):
            np.testing.assert_array_equal(
                out, b.serve_batch(name, toks, steps=2, seed=100 + i))
        assert queue_changes < b.engine.stats["context_changes"]
        assert queue_changes <= len(names)
        assert sched.stats["stacked_requests"] > 0
    finally:
        a.shutdown()
        b.shutdown()


def test_serve_stream_one_token_service_matches_generate():
    """``serve_stream`` (lookahead prefetch, one-token service through the
    context's apply function) answers what a run-to-completion engine
    on the same weights answers, and loads each context once."""
    names = ["supersub-super", "supersub-sub"]
    server, cfgs = launch.build_server(names, 2, 32, device="cpu")
    try:
        rng = np.random.default_rng(2)
        reqs = [(names[r % 2],
                 rng.integers(0, cfgs[names[r % 2]].vocab_size, (2, 8)))
                for r in range(4)]
        outs = server.serve_stream(reqs)
        for (name, toks), out in zip(reqs, outs):
            sm = server._served[name]
            ref = ServingEngine(sm.model, sm.weights_fn(), 32).generate(
                toks, 1)
            np.testing.assert_array_equal(out, ref[:, 0])   # (B,), as JAX
        assert server.engine.stats["loads"] == 2
    finally:
        server.shutdown()


@pytest.mark.parametrize("mode", [["--mode", "queue"],
                                  ["--mode", "continuous", "--paged",
                                   "--page-size", "16"],
                                  ["--mode", "sync", "--full"]])
def test_launcher_report(mode, capsys):
    rc = launch.main(["--platform", "cpu", "--requests", "4", "--steps",
                      "3", "--seq", "8", "--batch", "2", *mode])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mode"] == mode[1]
    assert rep["loads"] >= 2 and rep["context_changes"] >= 2
    assert 0.0 <= rep["hidden_load_fraction"] <= 1.0
    assert rep["env"]["device"] == "cpu"


def test_launcher_rejects_unported_flags(capsys):
    with pytest.raises(SystemExit) as e:
        launch.main(["--platform", "cpu", "--x64"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--x64" in err and "not yet ported" in err
    with pytest.raises(SystemExit) as e:
        launch.main(["--platform", "cpu", "--multi-step", "0"])
    assert e.value.code == 2
    assert "--multi-step must be >= 1" in capsys.readouterr().err
