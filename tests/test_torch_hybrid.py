"""The Mamba + MoE hybrid in the port (``jamba-v0.1-52b``) against the
JAX package's, on the CPU in float32, and both new archs through the
schedulers and the launcher.

The selective scan's plain version is held against JAX's
``selective_scan_reference`` (the JAX Pallas kernel does not run under
the installed JAX: ``ssm_scan/kernel.py`` calls ``pl.store``); Mamba
blocks and the reduced model against the JAX model on its reference
path (``set_mode("off")``) on the same weights, logits at ``atol=5e-4,
rtol=1e-3``; engine streams token for token, greedy and with JAX's
gumbel fields injected (``test_torch_serve.JaxDraws``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_reference as jax_scan_ref)
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import StepEngine  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousScheduler,  # noqa: E402
                                         SwitchScheduler)
from test_torch_serve import (F32, JaxDraws, _prompts,  # noqa: E402
                              _run_stream, cache_close)

JAMBA = "jamba-v0.1-52b"


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _logits_close(got, want):
    _close(got, want, atol=5e-4, rtol=1e-3)


@pytest.fixture
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


# ---------------------------------------------------------------------------
# the selective scan and the Mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,L,d_in,N,init", [
    (2, 13, 32, 8, False),            # odd L, zero state
    (1, 7, 48, 16, True),             # carried state (a verify block)
    (2, 1, 16, 8, True),              # one step
])
def test_ssm_scan_plain_matches_jax(B, L, d_in, N, init):
    rng = np.random.default_rng(L + N)
    u, Bm, Cm = _randn(rng, B, L, d_in), _randn(rng, B, L, N), \
        _randn(rng, B, L, N)
    dt = np.log1p(np.exp(_randn(rng, B, L, d_in)))          # softplus > 0
    A = -np.exp(_randn(rng, d_in, N) * 0.5)
    D = _randn(rng, d_in)
    s0 = _randn(rng, B, d_in, N) if init else None
    args = (u, dt, Bm, Cm, A, D)
    kernels.reset_launch_counts()
    y, s = ssm_scan(*(torch.from_numpy(a) for a in args),
                    None if s0 is None else torch.from_numpy(s0))
    assert ssm_scan.launches == 0                  # CPU: plain version
    jy, js = jax_scan_ref(*(jnp.asarray(a) for a in args),
                          None if s0 is None else jnp.asarray(s0))
    assert y.shape == (B, L, d_in) and s.shape == (B, d_in, N)
    _close(y, jy)
    _close(s, js)


def _ssm_params(cfg, rng):
    """Random numpy weights in the shapes of ``ssm_specs`` (nonzero
    biases and A_log, so every term of the block counts)."""
    specs = TS.ssm_specs(cfg)
    tree = {k: _randn(rng, *s.shape) / np.sqrt(s.shape[0])
            for k, s in specs.items()}
    tree["D"] = np.ones_like(tree["D"])
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def test_mamba_forward_decode_and_conv_state_match_jax(_jax_reference_path):
    """A 9-token forward from zero state, one decode token, then a
    4-token block from the carried state: outputs and both state leaves
    equal JAX's after each."""
    tcfg = override(reduced(get_arch(JAMBA)), **F32)
    jcfg = jax_reduced(jax_get_arch(JAMBA), **F32)
    rng = np.random.default_rng(5)
    tp, jp = _ssm_params(tcfg, rng)
    x = _randn(rng, 2, 14, tcfg.d_model)
    out, st = TS.mamba_forward(tp, torch.from_numpy(x[:, :9]), tcfg)
    jout, jst = JS.mamba_forward(jp, jnp.asarray(x[:, :9]), jcfg)
    d_in = 2 * tcfg.d_model
    assert st.conv.shape == (2, d_in, 3) and st.ssm.shape == (2, d_in, 8)
    for lo, hi in ((9, 10), (10, 14)):
        _close(out, jout)
        _close(st.conv, jst.conv)
        _close(st.ssm, jst.ssm)
        out, st = TS.mamba_decode(tp, torch.from_numpy(x[:, lo:hi]), st,
                                  tcfg)
        jout, jst = JS.mamba_decode(jp, jnp.asarray(x[:, lo:hi]), jst, jcfg)
    _close(out, jout)
    _close(st.ssm, jst.ssm)
    # the recurrence is exact: 14 tokens at once give the same end state
    _, whole = TS.mamba_forward(tp, torch.from_numpy(x), tcfg)
    _close(whole.ssm, st.ssm)
    _close(whole.conv, st.conv)


def test_bridge_orders_the_period_blocks():
    """Two repeats of jamba's 8-block period: port layer r*8 + i holds
    JAX's ``blocks/b{i}[r]``, bitwise and in its dtype."""
    jm = jax_build(jax_reduced(jax_get_arch(JAMBA), num_layers=16))
    jp = jm.init(jax.random.key(2), dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, device="cpu")
    assert len(tp["blocks"]) == 16
    tm = build_model(override(reduced(get_arch(JAMBA)), num_layers=16),
                     device="cpu")
    for layer, p in enumerate(tp["blocks"]):
        r, i = divmod(layer, 8)
        mixer, ffn = tm.kind(layer)
        assert set(p) == {"norm1", mixer, "norm2", ffn}
        src = tree["blocks"][f"b{i}"]
        for group in (mixer, ffn):
            for name, got in p[group].items():
                want = src[group][name][r]
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
    assert tm.kind(4) == ("attn", "mlp") and tm.kind(13) == ("mamba", "moe")
    with pytest.raises(ValueError, match="period blocks"):
        params_from_jax({"blocks": {"b0": {}, "b2": {}}}, device="cpu")


# ---------------------------------------------------------------------------
# reduced jamba: logits against JAX, verify against sequential decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jamba():
    """(port LM, port params, JAX LM, JAX params): reduced jamba (one
    8-layer period), float32, JAX weights bridged into the port."""
    jm = jax_build(jax_reduced(jax_get_arch(JAMBA), **F32),
                   cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(override(reduced(get_arch(JAMBA)), **F32),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def test_jamba_logits_match_jax(jamba, _jax_reference_path):
    """forward over 16 tokens; prefill 10, two decode steps at per-row
    positions; a 4-token verify over the carried Mamba state.  Logits
    follow JAX's and the windowless forward's; the verify pass gives the
    decode steps' logits and states."""
    tm, tp, jm, jp = jamba
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 16))
    want, _ = jm.forward(jp, jnp.asarray(toks))
    fwd = tm.forward(tp, toks)
    _logits_close(fwd, want)
    max_len = 32
    got, caches = tm.prefill(tp, toks[:, :10], max_len)
    jgot, jc = jm.prefill(jp, jnp.asarray(toks[:, :10]), max_len)
    _logits_close(got, jgot)
    ver = [type(c)(*(t.clone() for t in c)) for c in caches]
    jver = jc
    for t in (10, 11):
        pos = np.full((2,), t, np.int32)
        got, _ = tm.decode_step(tp, caches, toks[:, t:t + 1],
                                torch.from_numpy(pos))
        jgot, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        _logits_close(got, jgot)
        _logits_close(got[:, 0], fwd[:, t])
    mamba_0 = caches[0]                  # layer 0 is Mamba: b0, repeat 0
    _logits_close(mamba_0.ssm, jc["b0"].ssm[0])
    _logits_close(mamba_0.conv, jc["b0"].conv[0])
    pos = np.full((2,), 10, np.int32)
    got, _ = tm.verify_step(tp, ver, toks[:, 10:14], torch.from_numpy(pos))
    jgot, _ = jm.verify_step(jp, jver, jnp.asarray(toks[:, 10:14]),
                             jnp.asarray(pos))
    _logits_close(got, jgot)
    _logits_close(got, fwd[:, 10:14])


def test_jamba_verify_step_equals_sequential_decode(jamba):
    tm, tp, _, _ = jamba
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 14))
    _, seq = tm.prefill(tp, toks[:, :8], 24)
    ver = [type(c)(*(t.clone() for t in c)) for c in seq]
    pos = torch.tensor([8, 8], dtype=torch.int32)
    steps = [tm.decode_step(tp, seq, toks[:, 8 + i:9 + i], pos + i)[0]
             for i in range(5)]
    lv, _ = tm.verify_step(tp, ver, toks[:, 8:13], pos)
    _close(lv, torch.cat(steps, 1), atol=1e-5, rtol=1e-5)
    for a, b in zip(seq, ver):
        for x, y in zip(a, b):
            cache_close(y, x)


# ---------------------------------------------------------------------------
# row step engine against JAX; the engine gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_jamba_row_engine_streams_match_jax(jamba, temperature):
    tm, tp, jm, jp = jamba
    prompts = _prompts(tm.cfg.vocab_size, lens=(12, 21))
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=48, temperature=temperature)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 5, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _run_stream(eng, tp, prompts, 5, seeds) == want


def test_hybrid_refuses_chunked_and_paged_engines(jamba):
    tm, _, jm, _ = jamba
    for engine, model in ((StepEngine, tm), (JaxStepEngine, jm)):
        with pytest.raises(ValueError, match="all-attention"):
            engine(model, batch_size=2, max_len=64, prefill_chunk=8)
        with pytest.raises(ValueError, match="all-attention"):
            engine(model, batch_size=2, max_len=64, paged=True,
                   page_size=16)
    with pytest.raises(NotImplementedError, match="ring and recurrent"):
        tm.prefill_chunk(None, tm.init_cache(1, 32), np.zeros((1, 4)),
                         [0], [0])


# ---------------------------------------------------------------------------
# schedulers and launcher over both new archs
# ---------------------------------------------------------------------------

def test_schedulers_serve_mixtral_and_jamba():
    """Mixed mixtral / jamba greedy traffic on 2 weight slots: the
    continuous scheduler (row cache, one-shot admission) and the
    coalescing scheduler give the run-to-completion outputs."""
    names = ["mixtral-8x7b", JAMBA]
    server, cfgs = launch.build_server(names, 2, 48, arch_overrides=F32,
                                       device="cpu")
    try:
        rng = np.random.default_rng(0)
        reqs = [(names[r % 2], rng.integers(0, cfgs[names[r % 2]].vocab_size,
                                            (1, [8, 30, 16, 21][r])))
                for r in range(4)]
        for sched_cls in (lambda s: ContinuousScheduler(s, batch_size=2),
                          SwitchScheduler):
            with sched_cls(server) as sched:
                outs = [f.result(timeout=120) for f in
                        [sched.submit(n, t, steps=4) for n, t in reqs]]
            for (name, toks), out in zip(reqs, outs):
                assert out.shape == (1, 4)
                np.testing.assert_array_equal(
                    out, server.serve_batch(name, toks, steps=4))
        assert server.engine.stats["loads"] >= 2
    finally:
        server.shutdown()


def test_launcher_serves_mixtral_and_jamba(capsys):
    rc = launch.main(["--platform", "cpu", "--archs", f"mixtral-8x7b,{JAMBA}",
                      "--mode", "continuous", "--requests", "4", "--steps",
                      "3", "--seq", "12", "--batch", "1", "--pool", "2"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mode"] == "continuous" and rep["loads"] >= 2
    assert rep["env"]["device"] == "cpu"
