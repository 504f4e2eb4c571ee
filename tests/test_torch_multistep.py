"""The port's fused multi-step decode on the CPU: ``StepEngine(multi_step=T)``
commits up to T decode steps per tick, bitwise the tokens of T single
steps, and stops committing at the step where a slot would change
occupancy.  On the CPU the engine runs the tick's body eagerly; it is the
body a card captures as one CUDA graph.

The contract, mirrored from the JAX package's ``test_multistep.py`` and
the multi-step cases of ``test_paged_pool.py`` and
``test_quantized_pages.py``: identical streams (greedy and seeded
temperature, row, paged and int8 pools), retirement at the same step,
the same committed device steps in fewer host ticks, and every cache and
recurrent state leaf bitwise equal after the drain (a step that does not
commit must leave every state as it was).  Models are reduced and
float32, on JAX weights bridged into the port; greedy streams also equal
the JAX engine's at ``multi_step=4``."""
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
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.layers import KVCache, PagedKV  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServingEngine, StepEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from test_torch_serve import F32, JaxDraws, _drain  # noqa: E402


def _bridged(name, **kw):
    """(port LM, port params, JAX LM, JAX params): reduced ``name`` in
    float32, JAX weights bridged into the port."""
    kw = {**F32, **kw}
    jm = jax_build(jax_reduced(jax_get_arch(name), **kw),
                   cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(override(reduced(get_arch(name)), **kw),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


@pytest.fixture(scope="module")
def pair():
    return _bridged("tinyllama-1.1b")


def _toks(vocab, S, seed, b=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, S)).astype(
        np.int32)


def _engine(m, multi_step, paged, temperature=0.0, **kw):
    return StepEngine(m, batch_size=3, max_len=64, temperature=temperature,
                      seed=5, paged=paged, page_size=16,
                      multi_step=multi_step, **kw)


def _unread(eng, cache):
    """The leaves of one attention cache with what a step that does not
    commit may write zeroed: each row's k/v at its current position (the
    next step rewrites the same values there) and the park pages."""
    st = eng.state
    rows = torch.arange(eng.batch_size)
    pos = torch.from_numpy(st.pos).long()
    out = [None if t is None else t.clone() for t in cache]
    if isinstance(cache, PagedKV):
        page = cache.k.shape[2]
        table = torch.from_numpy(st.table).long()
        pids = table[rows, torch.clamp(pos // page, max=table.shape[1] - 1)]
        park = torch.arange(eng.num_shards) * (eng.num_pages
                                               // eng.num_shards)
        for t in out:
            if t is not None:
                t[pids, :, pos % page] = 0
                t[park] = 0
    else:
        S = cache.k.shape[2]
        slot = pos % S if eng.model.cfg.sliding_window else pos.clamp(
            max=S - 1)
        for t in out:
            t[rows, :, slot] = 0
    return out


def _same_states(a, b):
    """Both engines' caches and recurrent states, bitwise: the recurrent
    leaves (Mamba conv and SSM, mLSTM/sLSTM C, n, m) exactly, the
    attention caches but for ``_unread``."""
    assert np.array_equal(a.state.pos, b.state.pos)
    assert np.array_equal(a.state.tok, b.state.tok)
    for ca, cb in zip(a.state.caches, b.state.caches, strict=True):
        if isinstance(ca, (KVCache, PagedKV)):
            ca, cb = _unread(a, ca), _unread(a, cb)
        for x, y in zip(ca, cb, strict=True):
            assert (x is None and y is None) or torch.equal(x, y)


def _mixed_stream(eng, p, vocab, temperature, prompts=(8, 20, 12)):
    """Admit A (3 tokens) and B (9) at t=0, step until A retires (at
    device step 2: inside a fused tick of 4), admit C at that boundary,
    drain.  Admissions land at the same device step in the single-step
    and fused engines because a fused tick stops committing at A's
    retirement."""
    seeds = [7, 9, 11] if temperature > 0 else [None, None, None]
    ga = eng.admit(p, _toks(vocab, prompts[0], 1), max_new=3,
                   seeds=[seeds[0]])[0]
    gb = eng.admit(p, _toks(vocab, prompts[1], 2), max_new=9,
                   seeds=[seeds[1]])[0]
    while not ga.done:
        eng.step(p)
    gc = eng.admit(p, _toks(vocab, prompts[2], 3), max_new=5,
                   seeds=[seeds[2]])[0]
    _drain(eng, p)
    return [g.tokens for g in (ga, gb, gc)]


def _fused_matches_single(m, p, paged, temperature, **kw):
    one = _engine(m, 1, paged, temperature, **kw)
    ref = _mixed_stream(one, p, m.cfg.vocab_size, temperature)
    eng = _engine(m, 4, paged, temperature, **kw)
    assert _mixed_stream(eng, p, m.cfg.vocab_size, temperature) == ref
    # the same device steps, in fewer host ticks, and the draw chain and
    # every state where the single-step engine left them
    assert eng.stats["device_steps"] == one.stats["device_steps"]
    assert eng.stats["host_ticks"] < one.stats["host_ticks"]
    assert eng.sampler.snapshot() == one.sampler.snapshot()
    _same_states(eng, one)
    if paged:
        assert eng.free_pages() == eng._pages.allocatable
    return ref


# ---------------------------------------------------------------------------
# T fused steps == T single steps, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [False, True])
def test_multistep_streams_bitwise_identical(pair, temperature, paged):
    tm, tp, _, _ = pair
    _fused_matches_single(tm, tp, paged, temperature)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_int8_multistep_bitwise_matches_int8_single(pair, temperature):
    tm, tp, _, _ = pair
    _fused_matches_single(tm, tp, True, temperature, quantize_kv="int8")


def test_local_read_multistep_matches_single(pair):
    """The sharded bank's local reads (a loop of partials per shard)
    inside the fused tick, over 4 logical CPU devices."""
    from repro_torch.distributed.mesh import make_mesh
    tm, tp, _, _ = pair
    mesh = make_mesh((4,), ("model",), [torch.device("cpu")] * 4)
    _fused_matches_single(tm, tp, True, 0.0, mesh=mesh, local_read=True)


@pytest.mark.parametrize("name,kw", [
    ("mixtral-8x7b", dict(sliding_window=16)),      # ring, MoE
    ("jamba-v0.1-52b", {}),                         # Mamba + MoE
    ("xlstm-125m", {}),                             # mLSTM + sLSTM
])
def test_ring_and_recurrent_models_multistep(name, kw):
    """A's retirement falls inside the first fused tick, so B's recurrent
    states (Mamba conv and SSM, mLSTM/sLSTM C, n, m) run two steps that
    do not commit: ungated, B's stream and the states leave the
    single-step engine's.  mixtral's 20-token prompt wraps its 16-slot
    ring."""
    tm, tp, _, _ = _bridged(name, **kw)
    _fused_matches_single(tm, tp, False, 0.0)


def test_multistep_mid_loop_eos_retire(pair):
    """A row that samples EOS inside a fused tick retires AT that step:
    its stream stops where the single-step engine's stops, the slot frees,
    the co-resident row's tokens are untouched."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size
    probe = _engine(tm, 1, False)
    g = probe.admit(tp, _toks(V, 8, 1), max_new=8)[0]
    _drain(probe, tp)
    eos = g.tokens[2]
    cut = g.tokens[:g.tokens.index(eos) + 1]
    assert 1 < len(cut) < len(g.tokens)
    for paged in (False, True):
        runs = []
        for T in (1, 8):
            eng = _engine(tm, T, paged, eos_id=eos)
            ge = eng.admit(tp, _toks(V, 8, 1), max_new=8)[0]
            gn = eng.admit(tp, _toks(V, 12, 2), max_new=8)[0]
            _drain(eng, tp)
            assert ge.done and ge.tokens == cut
            assert eng.free_slots() == 3
            runs.append((ge.tokens, gn.tokens, eng.stats["device_steps"]))
        assert runs[0] == runs[1]


def test_multistep_amortizes_host_ticks(pair):
    """No retirement in sight: 16 decode steps in exactly 2 ticks of 8."""
    tm, tp, _, _ = pair
    eng = _engine(tm, 8, False)
    eng.admit(tp, _toks(tm.cfg.vocab_size, 8, 1, b=3), max_new=17)
    _drain(eng, tp)
    assert eng.stats["device_steps"] == 16
    assert eng.stats["host_ticks"] == 2


def test_multistep_single_steps_while_prefill_pending(pair):
    """While a prompt streams its chunks the fused engine single-steps
    (one chunk per tick for the pending prompt); streams equal the
    single-step engine's."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size

    def run(T):
        eng = _engine(tm, T, False, prefill_chunk=4)
        ga = eng.admit(tp, _toks(V, 12, 1), max_new=8)[0]
        for _ in range(3):                 # 2 streaming chunks + final
            eng.step(tp)
        assert not eng._pending and ga.tokens
        gb = eng.admit(tp, _toks(V, 20, 2), max_new=6)[0]
        d0 = eng.stats["device_steps"]
        eng.step(tp)                       # B pending: exactly one step
        assert eng.stats["device_steps"] == d0 + 1
        _drain(eng, tp)
        return [ga.tokens, gb.tokens]

    assert run(4) == run(1)


def test_multistep_guards(pair):
    tm, _, _, _ = pair
    with pytest.raises(ValueError, match="multi_step"):
        StepEngine(tm, batch_size=2, max_len=64, multi_step=0)


def test_page_pool_batched_release_under_multistep(pair):
    """One fused tick retires three rows: their pages go to the BACK of
    the free-list row by row in slot order, as the single-step tick's
    batch would; randomized churn under fused ticks replays exactly and
    returns every page."""
    tm, tp, _, _ = pair
    V = tm.cfg.vocab_size
    eng = StepEngine(tm, batch_size=4, max_len=64, paged=True, page_size=16,
                     num_pages=13, seed=5, multi_step=8)
    free0 = list(eng._pages._free)
    gens = [eng.admit(tp, _toks(V, 8, s), max_new=4)[0] for s in (1, 2, 3)]
    owned = [g.pages[:] for g in gens]
    finished = eng.step(tp)
    assert sorted(g.rid for g in finished) == sorted(g.rid for g in gens)
    assert eng.stats["host_ticks"] == 1 and eng.stats["device_steps"] == 3
    assert eng.free_pages() == eng._pages.allocatable
    assert list(eng._pages._free) == \
        free0[3:] + owned[0] + owned[1] + owned[2]

    final = []
    for _ in range(2):
        e2 = StepEngine(tm, batch_size=4, max_len=64, paged=True,
                        page_size=16, num_pages=10, seed=5, multi_step=4)
        rng = np.random.default_rng(123)
        streams = []
        for _ in range(30):
            action = rng.integers(0, 3)
            S, steps = int(rng.integers(4, 30)), int(rng.integers(1, 10))
            toks = rng.integers(0, V, (1, S))
            if action == 0 and e2.can_admit(toks, steps):
                streams.append(e2.admit(tp, toks, max_new=steps)[0].tokens)
            else:
                e2.step(tp)
        _drain(e2, tp)
        assert e2.free_slots() == 4
        assert e2.free_pages() == e2._pages.allocatable == 9
        final.append((streams, list(e2._pages._free)))
    assert final[0] == final[1]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_generate_fused_equals_generate(pair, temperature):
    tm, tp, _, _ = pair
    eng = ServingEngine(tm, tp, max_len=48, temperature=temperature)
    prompt = _toks(tm.cfg.vocab_size, 16, 4, b=2)
    want = eng.generate(prompt, steps=6, seed=3)
    got = eng.generate_fused(prompt, steps=6, seed=3)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    fused = eng.step_engine(2, multi_step=5)
    assert fused.stats["host_ticks"] == 1          # the whole decode, once
    assert fused.stats["device_steps"] == 5


# ---------------------------------------------------------------------------
# against the JAX engine at multi_step=4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [False, True])
def test_multistep_streams_match_jax(pair, paged, temperature):
    """The port's fused streams equal the JAX engine's fused streams on
    the same weights: greedy, and at temperature with JAX's gumbel fields
    injected."""
    tm, tp, jm, jp = pair
    kw = dict(batch_size=3, max_len=64, temperature=temperature, seed=5,
              paged=paged, page_size=16, multi_step=4)
    want = _mixed_stream(JaxStepEngine(jm, **kw), jp, tm.cfg.vocab_size,
                         temperature)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _mixed_stream(eng, tp, tm.cfg.vocab_size, temperature) == want


# ---------------------------------------------------------------------------
# the scheduler, the launcher and the launch counts
# ---------------------------------------------------------------------------

def test_continuous_scheduler_multistep():
    """ContinuousScheduler(multi_step=4) end to end: greedy outputs equal
    the run-to-completion server's, and the snapshot reports the realized
    amortization (steps_per_tick > 1)."""
    names = ["supersub-super", "supersub-sub"]
    server, cfgs = launch.build_server(names, 2, 32, load_delay_s=0.01,
                                       arch_overrides=F32, device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(names[r % 2],
                 rng.integers(0, cfgs[names[r % 2]].vocab_size, (2, 12)))
                for r in range(4)]
        with ContinuousScheduler(server, batch_size=2,
                                 multi_step=4) as sched:
            futs = [sched.submit(n, t, steps=8) for n, t in reqs]
            outs = [f.result(timeout=300) for f in futs]
        snap = sched.snapshot()
        assert snap["device_steps"] > snap["host_ticks"]
        assert snap["steps_per_tick"] > 1.0
        for (name, toks), out in zip(reqs, outs):
            np.testing.assert_array_equal(
                out, server.serve_batch(name, toks, steps=8))
        assert all(key.multi_step == 4 and eng.multi_step == 4
                   for key, eng in server._step_engines.items())
    finally:
        server.shutdown()


def test_launcher_multi_step(capsys):
    rc = launch.main(["--platform", "cpu", "--mode", "continuous",
                      "--paged", "--page-size", "16", "--multi-step", "4",
                      "--requests", "4", "--steps", "6", "--seq", "8",
                      "--batch", "2"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["steps_per_tick"] > 1.0
    assert rep["device_steps"] > rep["host_ticks"]


def test_graph_launch_deltas_add_and_take_back():
    """A replay adds what its capture recorded, by shape too; taking it
    back once (the capture launches nothing) restores every count."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention)
    before = kernels.launch_counts()
    flash_attention.launches += 2
    paged_decode_attention.launches_by_shape[(8, 4, 8, 3, 256, 64)] += 22
    delta = kernels.launches_since(before)
    assert delta[(flash_attention, "launches")] == 2
    assert delta[(paged_decode_attention, "launches_by_shape")] == {
        (8, 4, 8, 3, 256, 64): 22}
    kernels.add_launches(delta, times=3)
    assert flash_attention.launches == before[
        (flash_attention, "launches")] + 8
    kernels.add_launches(delta, times=-4)
    assert kernels.launch_counts() == before
