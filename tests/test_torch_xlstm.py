"""The xLSTM model in the port (``xlstm-125m``) against the JAX package's,
on the CPU in float32.

The chunkwise-mLSTM kernel's plain version is held against the JAX
Pallas kernel (interpret mode) and JAX's recurrent oracle at the JAX
kernel test's shapes and limits; the mLSTM and sLSTM blocks and the
reduced model (three mLSTM layers and one sLSTM layer, chunk 16)
against the JAX model on the same weights, logits at ``atol=5e-4,
rtol=1e-3``; engine streams token for token, greedy and with JAX's
gumbel fields injected (``test_torch_serve.JaxDraws``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.mlstm_chunk.ops import (  # noqa: E402
    mlstm_chunk as jax_mlstm_chunk, mlstm_recurrent_reference as jax_rec)
from repro.models import xlstm as JX  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serve.engine import StepEngine as JaxStepEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.model import LM, build_model  # noqa: E402
from repro_torch.serve.engine import StepEngine  # noqa: E402
from test_torch_serve import (F32, JaxDraws, _prompts,  # noqa: E402
                              _run_stream, cache_close)

XLSTM = "xlstm-125m"


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _logits_close(got, want):
    _close(got, want, atol=5e-4, rtol=1e-3)


def _mlstm_inputs(rng, B, H, L, dh):
    """q, k, v standard normal, li of std 0.5, lf = log_sigmoid(N + 1):
    ``tests/test_kernels.py``'s draw, from numpy."""
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((B, H, L)) * 0.5).astype(np.float32)
    lf = -np.logaddexp(0.0, -(rng.standard_normal((B, H, L)) + 1.0))
    return q, k, v, li, lf.astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the chunkwise mLSTM: kernel's plain version and the three forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,L,dh,c", [
    (2, 2, 64, 32, 16), (1, 4, 128, 64, 32), (2, 1, 96, 48, 32),
])
def test_mlstm_chunk_plain_matches_jax(B, H, L, dh, c):
    args = _mlstm_inputs(np.random.default_rng(L + dh), B, H, L, dh)
    kernels.reset_launch_counts()
    h, (C, n, m) = mlstm_chunk(*_t(args), chunk=c)
    assert mlstm_chunk.launches == 0                 # CPU: plain version
    assert h.shape == (B, H, L, dh) and C.shape == (B, H, dh, dh)
    assert n.shape == (B, H, dh) and m.shape == (B, H)
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_mlstm_chunk(*jargs, chunk=c), jax_rec(*jargs)):
        jh, (jC, jn, jm) = want
        _close(h, jh, atol=5e-4, rtol=0)
        _close(C, jC, atol=5e-4, rtol=0)
        _close(n, jn, atol=5e-4, rtol=0)
        _close(m, jm, atol=1e-5, rtol=0)


def test_mlstm_three_forms_agree():
    """Parallel, recurrent and chunkwise (chunk 16, and one that the
    wrapper shrinks from 32 to a divisor of L = 48) give one answer."""
    q, k, v, li, lf = _t(_mlstm_inputs(np.random.default_rng(5), 2, 2, 48,
                                       16))
    h_rec, fin_rec = TX.mlstm_recurrent(q, k, v, li, lf)
    h_par, fin_par = TX.mlstm_parallel(q, k, v, li, lf)
    for h, fin in ((h_par, fin_par),
                   TX.mlstm_chunkwise(q, k, v, li, lf, chunk=16),
                   mlstm_chunk(q, k, v, li, lf, chunk=32)):
        _close(h, h_rec, atol=1e-4, rtol=0)
        for a, b in zip(fin, fin_rec):
            _close(a, b, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TX.mlstm_chunkwise(q, k, v, li, lf, chunk=32)


# ---------------------------------------------------------------------------
# the blocks against JAX
# ---------------------------------------------------------------------------

def _block_params(specs, rng):
    """Random numpy weights in the shapes of ``specs`` (nonzero biases,
    so every term of the block counts) -> (torch tree, JAX tree)."""
    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        fan = s.shape[-2] if len(s.shape) > 1 else 4
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)
    tree = draw(specs)

    def conv(t, fn):
        return {k: conv(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    return conv(tree, torch.from_numpy), conv(tree, jnp.asarray)


@pytest.fixture(scope="module")
def cfgs():
    return (override(reduced(get_arch(XLSTM)), **F32),
            jax_reduced(jax_get_arch(XLSTM), **F32))


@pytest.mark.parametrize("mode,L", [("parallel", 12), ("chunkwise", 32)])
def test_mlstm_block_matches_jax(cfgs, mode, L):
    """From no history in ``mode`` over L tokens, then 3 recurrent tokens
    from the carried state: outputs and every state leaf equal JAX's."""
    tcfg, jcfg = cfgs
    rng = np.random.default_rng(L)
    tp, jp = _block_params(TX.mlstm_specs(tcfg), rng)
    x = rng.standard_normal((2, L + 3, tcfg.d_model)).astype(np.float32)
    kernels.reset_launch_counts()
    y, st = TX.mlstm_block(tp, torch.from_numpy(x[:, :L]), tcfg, mode=mode)
    assert mlstm_chunk.launches == 0
    jy, jst = JX.mlstm_block(jp, jnp.asarray(x[:, :L]), jcfg, mode=mode)
    d_in = 2 * tcfg.d_model
    assert st.C.shape == (2, 4, 64, 64) and st.conv.shape == (2, d_in, 3)
    _close(y, jy)
    for a, b in zip(st, jst):
        _close(a, b)
    y, st = TX.mlstm_block(tp, torch.from_numpy(x[:, L:]), tcfg,
                           mode="recurrent", state=st)
    jy, jst = JX.mlstm_block(jp, jnp.asarray(x[:, L:]), jcfg,
                             mode="recurrent", state=jst)
    _close(y, jy)
    for a, b in zip(st, jst):
        _close(a, b)
    with pytest.raises(ValueError, match="no history"):
        TX.mlstm_block(tp, torch.from_numpy(x[:, :L]), tcfg, mode=mode,
                       state=st)


def test_slstm_block_with_carried_state_matches_jax(cfgs):
    tcfg, jcfg = cfgs
    rng = np.random.default_rng(9)
    tp, jp = _block_params(TX.slstm_specs(tcfg), rng)
    x = rng.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    y, st = TX.slstm_block(tp, torch.from_numpy(x[:, :7]), tcfg)
    jy, jst = JX.slstm_block(jp, jnp.asarray(x[:, :7]), jcfg)
    _close(y, jy)
    y, st = TX.slstm_block(tp, torch.from_numpy(x[:, 7:]), tcfg, state=st)
    jy, jst = JX.slstm_block(jp, jnp.asarray(x[:, 7:]), jcfg, state=jst)
    _close(y, jy)
    for a, b in zip(st, jst):
        assert a.dtype == torch.float32
        _close(a, b)


# ---------------------------------------------------------------------------
# reduced xlstm: bridge, logits, states, verify
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm():
    """(port LM, port params, JAX LM, JAX params): reduced xlstm (one
    4-layer period, chunk 16), float32, JAX weights bridged."""
    jm = jax_build(jax_reduced(jax_get_arch(XLSTM), **F32),
                   cache_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    tm = build_model(override(reduced(get_arch(XLSTM)), **F32),
                     cache_dtype=torch.float32, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp),
                               device="cpu"), jm, jp


def test_bridge_carries_the_xlstm_period(xlstm):
    """b0..b3 become layers 0..3: three mLSTM blocks, then an sLSTM block
    with its nested FFN and (4, H, dh, dh) recurrent gates; no norm2."""
    tm, tp, _, jp = xlstm
    assert [tm.kind(i) for i in range(4)] == [("mlstm", "none")] * 3 + [
        ("slstm", "none")]
    for i, p in enumerate(tp["blocks"]):
        mixer = tm.kind(i)[0]
        assert set(p) == {"norm1", mixer}
        want = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"][f"b{i}"])
        assert set(p[mixer]) == set(want[mixer])
    s = tp["blocks"][3]["slstm"]
    assert s["r_gates"].shape == (4, 4, 32, 32)
    assert set(s["ffn"]) == {"w_gate", "w_up", "w_down"}
    np.testing.assert_array_equal(s["ffn"]["w_down"].numpy(),
                                  np.asarray(jp["blocks"]["b3"]["slstm"]
                                             ["ffn"]["w_down"][0]))


def _states_close(caches, jc, close=_logits_close):
    for i, c in enumerate(caches):
        for a, b in zip(c, jc[f"b{i}"]):
            close(a, b[0])


def test_xlstm_logits_and_states_match_jax(xlstm):
    """forward over 32 tokens (chunkwise); prefill 32 (chunkwise) and 12
    (parallel); two decode steps after the 12; a 4-token verify from the
    same state.  Logits follow JAX's and the forward's; states JAX's."""
    tm, tp, jm, jp = xlstm
    assert tm._mlstm_train_mode(32) == "chunkwise"
    assert tm._mlstm_train_mode(12) == "parallel"
    assert tm._mlstm_train_mode(16) == "parallel"      # one chunk only
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 32))
    want, _ = jm.forward(jp, jnp.asarray(toks))
    kernels.reset_launch_counts()
    fwd = tm.forward(tp, toks)
    _logits_close(fwd, want)
    got, caches = tm.prefill(tp, toks, 40)
    jgot, jc = jm.prefill(jp, jnp.asarray(toks), 40)
    _logits_close(got, jgot)
    _states_close(caches, jc)
    assert mlstm_chunk.launches == 0
    got, caches = tm.prefill(tp, toks[:, :12], 40)
    jgot, jc = jm.prefill(jp, jnp.asarray(toks[:, :12]), 40)
    _logits_close(got, jgot)
    _logits_close(got[:, 0], fwd[:, 11])
    _states_close(caches, jc)
    ver = [type(c)(*(t.clone() for t in c)) for c in caches]
    jver = jc
    for t in (12, 13):
        pos = np.full((2,), t, np.int32)
        got, _ = tm.decode_step(tp, caches, toks[:, t:t + 1],
                                torch.from_numpy(pos))
        jgot, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        _logits_close(got, jgot)
        _logits_close(got[:, 0], fwd[:, t])
    _states_close(caches, jc)
    pos = np.full((2,), 12, np.int32)
    got, _ = tm.verify_step(tp, ver, toks[:, 12:16], torch.from_numpy(pos))
    jgot, _ = jm.verify_step(jp, jver, jnp.asarray(toks[:, 12:16]),
                             jnp.asarray(pos))
    _logits_close(got, jgot)
    _logits_close(got, fwd[:, 12:16])


def test_forced_mlstm_modes_agree(xlstm):
    """``mlstm_mode`` forces one form: at L = 24 the rule picks parallel
    (24 is no multiple of 16); forced chunkwise shrinks the chunk to 8."""
    tm, tp, _, _ = xlstm
    toks = np.random.default_rng(8).integers(0, tm.cfg.vocab_size, (2, 24))
    want = tm.forward(tp, toks)
    for mode in ("parallel", "chunkwise"):
        forced = LM(tm.cfg, cache_dtype=torch.float32, device="cpu",
                    mlstm_mode=mode)
        assert forced._mlstm_train_mode(32) == mode
        _close(forced.forward(tp, toks), want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="mlstm_mode"):
        LM(tm.cfg, device="cpu", mlstm_mode="recurrent")


def test_xlstm_verify_step_equals_sequential_decode(xlstm):
    tm, tp, _, _ = xlstm
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


def test_insert_cache_rows_keeps_recurrent_state_f32():
    """With a bf16 cache the conv inputs are bf16 but C, n, m and the
    sLSTM state stay f32 through admission."""
    cfg = override(reduced(get_arch(XLSTM)), **F32)
    tm = build_model(cfg, cache_dtype=torch.bfloat16, device="cpu")
    params = tm.init(seed=0)
    _, rows = tm.prefill(params, np.arange(12)[None] % cfg.vocab_size, 16)
    caches = tm.init_cache(3, 16)
    tm.insert_cache_rows(caches, rows, [1])
    for c, r in zip(caches, rows):
        for name, dst, src in zip(c._fields, c, r):
            want = torch.bfloat16 if name == "conv" else torch.float32
            assert dst.dtype == want, name
            if name != "conv":
                assert torch.equal(dst[1], src[0])
    assert caches[0].m[0, 0] == TX.NEG_INF          # untouched rows


# ---------------------------------------------------------------------------
# engines, schedulers and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_xlstm_row_engine_streams_match_jax(xlstm, temperature):
    """A 32-token prompt (chunkwise prefill) and a 12-token one
    (parallel), admitted two steps apart."""
    tm, tp, jm, jp = xlstm
    prompts = _prompts(tm.cfg.vocab_size, lens=(32, 12))
    seeds = [7, None] if temperature > 0 else [None, None]
    kw = dict(batch_size=2, max_len=48, temperature=temperature)
    want = _run_stream(JaxStepEngine(jm, **kw), jp, prompts, 5, seeds)
    eng = StepEngine(tm, sampler=JaxDraws("cpu"), **kw)
    assert _run_stream(eng, tp, prompts, 5, seeds) == want


def test_xlstm_refuses_chunked_and_paged_engines(xlstm):
    tm, _, jm, _ = xlstm
    for engine, model in ((StepEngine, tm), (JaxStepEngine, jm)):
        with pytest.raises(ValueError, match="all-attention"):
            engine(model, batch_size=2, max_len=64, prefill_chunk=8)
        with pytest.raises(ValueError, match="all-attention"):
            engine(model, batch_size=2, max_len=64, paged=True,
                   page_size=16)


@pytest.mark.parametrize("mode", ["continuous", "queue", "sync"])
def test_launcher_serves_xlstm(mode, capsys):
    rc = launch.main(["--platform", "cpu", "--archs",
                      f"{XLSTM},supersub-sub", "--mode", mode,
                      "--requests", "4", "--steps", "3", "--seq", "12",
                      "--batch", "1", "--pool", "2"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mode"] == mode and rep["loads"] >= 2
    assert rep["env"]["device"] == "cpu"


@pytest.mark.parametrize("flag", [["--paged"], ["--prefill-chunk", "8"]])
def test_launcher_refuses_paged_and_chunked_xlstm(flag):
    with pytest.raises(ValueError, match="all-attention"):
        launch.main(["--platform", "cpu", "--archs", f"{XLSTM},supersub-sub",
                     "--mode", "continuous", "--requests", "2", "--steps",
                     "2", "--seq", "8", *flag])
