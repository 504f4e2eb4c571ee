"""The port's training path against the JAX package's, on the same state.

JAX initializes the parameters (and a train state);
``repro_torch.bridge.params_from_jax`` / ``train_state_from_jax`` carry
them into the port.  Compared in float32 on the CPU, JAX on its
reference path (``REPRO_PALLAS=off``):
  * ``make_schedule`` and one ``adamw_update`` from the same gradients
    and state (``rtol=1e-6``: the same f32 formula, the global norm's
    leaves summed in another order);
  * ``lm_loss_fn``'s loss and gradients for reduced tinyllama-1.1b
    (chunked and not), reduced mixtral-8x7b (the MoE aux loss), reduced
    jamba-v0.1-52b (Mamba, MLP and MoE layers) and reduced xlstm-125m
    (mLSTM layers through the chunkwise form: 32 tokens, chunk 16), and
    ``chunked_lm_loss`` over several chunks, within the north star's
    ``atol=5e-4, rtol=1e-3``;
  * one and two ``make_train_step`` steps from a bridged JAX state
    (``eps=1.0``, as ``test_trainer.py``'s accumulation test, so that
    Adam does not amplify summation-order noise into +-lr flips);
  * inside the port: microbatches 1 vs 4 and remat vs none;
  * ``SyntheticTokens`` token for token, ``PrefetchLoader``'s straggler
    path, the Super-Sub ``train_classifier`` against the JAX example's
    (``examples/train_cascade.py``, loaded by path);
  * the named errors of what needs several cards or a missing backward
    kernel, and the launcher on the CPU.
"""
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptCfg  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParCfg  # noqa: E402
from repro.configs.base import RunConfig as JaxRunCfg  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro.train.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import (params_from_jax,  # noqa: E402
                                train_state_from_jax)
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import cascade as tcascade  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402
from repro_torch.train.data import (PrefetchLoader,  # noqa: E402
                                    SyntheticTokens)
from repro_torch.core.context import tree_leaves  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
ATOL, RTOL = 5e-4, 1e-3            # the north star's logits tolerance
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def _pair(name, seed=0, **kw):
    """(port LM, JAX LM, JAX params) for the reduced float32 config."""
    jm = jax_build(jax_reduced(jax_get_arch(name), **F32, **kw),
                   cache_dtype=jnp.float32)
    tm = build_model(override(reduced(get_arch(name)), **F32, **kw),
                     cache_dtype=torch.float32, device="cpu")
    return tm, jm, jm.init(jax.random.key(seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A JAX LM-shaped tree (params or gradients) in the port's layout."""
    return params_from_jax(_np(tree), device="cpu")


def _close_trees(got, want, atol=ATOL, rtol=RTOL):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol,
                                   rtol=rtol)


def _run_cfgs(eps=1e-8, **par):
    opt = dict(lr=1e-3, total_steps=100, warmup_steps=5, eps=eps)
    return (RunConfig(optimizer=OptimizerConfig(**opt),
                      parallel=ParallelConfig(**par)),
            JaxRunCfg(optimizer=JaxOptCfg(**opt),
                      parallel=JaxParCfg(**par)))


def _tokens(vocab, batch=4, seq=32, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def tiny():
    return _pair("tinyllama-1.1b")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    got = topt.make_schedule(OptimizerConfig(**kw))
    want = jopt.make_schedule(JaxOptCfg(**kw))
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        np.testing.assert_allclose(float(got(torch.tensor(step))),
                                   float(want(step)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [0.01, 50.0])      # clip off / on
def test_adamw_update_matches_jax(scale):
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params, grads, m, v = (jax.tree.map(
        mk, shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(4))
    grads = jax.tree.map(lambda g: g * scale, grads)
    v = jax.tree.map(np.abs, v)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jstate = {"m": m, "v": v, "count": jnp.asarray(3, jnp.int32)}
    jp, jo, jm = jopt.adamw_update(grads, jstate, params, JaxOptCfg(**cfg))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    tp, to, tm = topt.adamw_update(
        t(grads), {"m": t(m), "v": t(v),
                   "count": torch.tensor(3, dtype=torch.int32)},
        t(params), OptimizerConfig(**cfg))
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(to["count"]) == int(jo["count"]) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,chunked", [("tinyllama-1.1b", False),
                                          ("tinyllama-1.1b", True),
                                          ("mixtral-8x7b", None),
                                          ("jamba-v0.1-52b", None),
                                          ("xlstm-125m", None)])
def test_lm_loss_and_grads_match_jax(name, chunked, tiny):
    tm, jm, jp = tiny if name == "tinyllama-1.1b" else _pair(name)
    rc, jrc = _run_cfgs()
    toks = _tokens(jm.cfg.vocab_size)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtr.lm_loss_fn(jm, p, {"tokens": jnp.asarray(toks)}, jrc,
                                 chunked=chunked), has_aux=True)(jp)
    loss, aux, grads = ttr.value_and_grad(
        lambda p: ttr.lm_loss_fn(tm, p, {"tokens": torch.from_numpy(toks)},
                                 rc, chunked=chunked), _port(jp))
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   atol=ATOL, rtol=RTOL)
    if name in ("mixtral-8x7b", "jamba-v0.1-52b"):     # MoE layers
        assert float(aux["aux"]) > 0
    _close_trees(grads, _port(jg))


def test_chunked_loss_over_chunks_matches_jax():
    rng = np.random.default_rng(5)
    B, S, D, V = 2, 64, 16, 96
    h, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, D), (D, V)))
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda h, w: jtr.chunked_lm_loss(h, w, y, mask, chunk=16),
        argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    loss = ttr.chunked_lm_loss(th, tw, torch.from_numpy(y),
                               torch.from_numpy(mask), chunk=16)
    loss.backward()
    full = ttr.softmax_xent(th.detach() @ tw.detach(), torch.from_numpy(y),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(full), rtol=1e-5)
    for g, j in ((th.grad, jg[0]), (tw.grad, jg[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_train_steps_from_a_bridged_state_match_jax(tiny):
    """One and two ``make_train_step`` steps of each package from the
    same (JAX-initialized) state on the same ``SyntheticTokens`` batches:
    parameters, moments and metrics after each step."""
    tm, jm, _ = tiny
    rc, jrc = _run_cfgs(eps=1.0)
    jstate = jtr.init_state(jm, jax.random.key(0), jrc)
    state = train_state_from_jax(_np(jstate), device="cpu")
    jstep = jax.jit(jtr.make_train_step(jm, jrc))
    step = ttr.make_train_step(tm, rc)
    jdata = JaxTokens(jm.cfg.vocab_size, 32, 4, seed=0)
    data = SyntheticTokens(tm.cfg.vocab_size, 32, 4, seed=0, device="cpu")
    for i in range(2):
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        state, met = step(state, data.batch_at(i))
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       atol=ATOL, rtol=RTOL)
        _close_trees(state["params"], _port(jstate["params"]), atol=1e-5,
                     rtol=1e-4)
        for mom in ("m", "v"):
            _close_trees(state["opt"][mom], _port(jstate["opt"][mom]),
                         atol=1e-6, rtol=RTOL)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert int(state["opt"]["count"]) == i + 1


def _one_step(tm, seed=0, **par):
    rc, _ = _run_cfgs(eps=1.0, **par)
    state = ttr.init_state(tm, seed, rc)
    batch = {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab_size, 8))}
    return ttr.make_train_step(tm, rc)(state, batch)


def test_microbatches_match_one_batch(tiny):
    """A=1 and A=4 give the same update on the same global batch (the
    tolerance of ``test_trainer.py``'s accumulation test)."""
    s1, m1 = _one_step(tiny[0], microbatches=1)
    s4, m4 = _one_step(tiny[0], microbatches=4)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-3)
    _close_trees(s1["params"], s4["params"], atol=1e-4, rtol=1e-3)


def test_remat_matches_no_remat(tiny):
    """Checkpointed layers recompute the same operations: on the CPU the
    step is bit for bit the one that keeps its activations."""
    sa, ma = _one_step(tiny[0])
    sb, mb = _one_step(tiny[0], remat="full")
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(tree_leaves(sa["params"]), tree_leaves(sb["params"])):
        assert torch.equal(a, b)


def test_step_is_functional(tiny):
    """The input state is left as it was, as JAX's (donation aside)."""
    tm = tiny[0]
    rc, _ = _run_cfgs()
    state = ttr.init_state(tm, 0, rc)
    before = [t.clone() for t in tree_leaves(state)]
    batch = {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab_size))}
    ttr.make_train_step(tm, rc)(state, batch)
    for a, b in zip(tree_leaves(state), before):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_synthetic_tokens_match_jax(dtype):
    j = JaxTokens(300, 24, 3, seed=7)
    t = SyntheticTokens(300, 24, 3, seed=7, device="cpu", dtype=dtype)
    for step in (0, 1, 9):
        got = t.batch_at(step)["tokens"]
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j.batch_at(step)["tokens"]))
    with pytest.raises(ValueError, match="int32 or int64"):
        SyntheticTokens(300, 24, 3, device="cpu", dtype=torch.float32)


def test_straggler_prefetch():
    class SlowSource:
        def __init__(self):
            self.calls = 0

        def batch_at(self, step):
            self.calls += 1
            if self.calls == 3:
                time.sleep(0.6)               # one straggling batch
            return {"tokens": torch.full((2, 4), step)}

    loader = PrefetchLoader(SlowSource(), depth=1, deadline_s=0.2)
    got = [loader.batch_at(i) for i in range(5)]
    assert loader.stats["stragglers"] >= 1
    assert len(got) == 5
    loader.close()


# ---------------------------------------------------------------------------
# the Super-Sub members
# ---------------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_cascade", os.path.join(ROOT, "examples",
                                           "train_cascade.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_train_classifier_matches_jax_example():
    """Three steps of the port's ``train_classifier`` against the JAX
    example's, from the same backbone and head, on the same batches: the
    last loss within the north star's limit, each parameter leaf within
    1e-5 relative L2.  Per leaf, not per element: the example's Adam has
    eps=1e-8, which maps a gradient element near zero (an embedding row
    of a token drawn once) to +-lr, so such an element may land apart by
    a fraction of lr on summation-order noise alone."""
    ex = _jax_example()
    jcfg = jax_reduced(jax_get_arch("supersub-super"), **F32, vocab_size=64,
                       num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, head_dim=16, d_ff=128)
    jmodel, jp = ex.make_classifier(jcfg, 5, jax.random.key(1))
    tcfg = override(reduced(get_arch("supersub-super")), **F32,
                    vocab_size=64, num_layers=2, d_model=64, num_heads=4,
                    num_kv_heads=2, head_dim=16, d_ff=128)
    tmodel = build_model(tcfg, cache_dtype=torch.float32, device="cpu")
    tp = {"backbone": _port(jp["backbone"]),
          "head": torch.from_numpy(np.array(jp["head"]))}
    rng = np.random.default_rng(6)
    xs = [rng.integers(0, 64, (8, 12)).astype(np.int32) for _ in range(3)]
    ys = [rng.integers(0, 5, 8).astype(np.int32) for _ in range(3)]
    jp, jl = ex.train_classifier(
        jmodel, jp, iter({"x": jnp.asarray(x), "label": jnp.asarray(y)}
                         for x, y in zip(xs, ys)), 3, 5)
    tp, tl = tcascade.train_classifier(
        tmodel, tp, iter({"x": torch.from_numpy(x),
                          "label": torch.from_numpy(y)}
                         for x, y in zip(xs, ys)), 3, 5)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)
    pairs = list(zip(tree_leaves(tp["backbone"]),
                     tree_leaves(_port(jp["backbone"]))))
    pairs.append((tp["head"], torch.from_numpy(np.array(jp["head"]))))
    worst = max(_rel_l2(a.numpy(), b.numpy()) for a, b in pairs)
    assert worst <= 1e-5, worst


# ---------------------------------------------------------------------------
# named errors and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--dp", "2"], ["--tp", "2"]])
def test_launcher_refuses_several_cards(argv):
    with pytest.raises(ttr.MultiCardTrainingNotPorted, match="§A item 6"):
        launch_train.main(argv + ["--device", "cpu"])


def test_int8_ef_across_pods_is_refused(tiny):
    rc = RunConfig(parallel=ParallelConfig(grad_compression="int8_ef",
                                           pods=2))
    with pytest.raises(ttr.MultiCardTrainingNotPorted, match="int8"):
        ttr.make_train_step(tiny[0], rc)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA card")
def test_launcher_has_no_cpu_fallback():
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])


@pytest.mark.parametrize("name,mesh,refused", [
    ("tinyllama-1.1b", False, None),
    ("mixtral-8x7b", False, None),
    ("jamba-v0.1-52b", False, None),
    ("xlstm-125m", False, None),
    ("mixtral-8x7b", True, "gmm"),          # expert-parallel MoE layers
    ("tinyllama-1.1b", True, None)])        # a mesh, no MoE layer
def test_card_refuses_families_without_backward_kernels(name, mesh,
                                                        refused):
    """On the card the dense, MoE, hybrid and xLSTM families train (B1,
    B8 and B9 have backward kernels; one card's MoE layers run the dense
    reference); the grouped matmul (B7) that a meshed model's MoE layers
    run has none, and the step refuses such a model before it starts,
    naming the kernel (the model's device is set to the card without
    one: the check reads only the device, the family, the mesh and the
    layers).  On the CPU every family trains."""
    from repro_torch.distributed.mesh import Mesh
    tm = build_model(reduced(get_arch(name)), device="cpu",
                     mesh=Mesh(("cpu",) * 4) if mesh else None)
    ttr.check_trainable(tm, RunConfig())          # CPU: every family
    tm.device = torch.device("cuda", 0)
    if refused:
        with pytest.raises(kernels.MissingBackwardKernel,
                           match=f"{refused}.*backward kernel is not "
                                 "ported"):
            ttr.make_train_step(tm, RunConfig())
    else:
        ttr.check_trainable(tm, RunConfig())


def test_launcher_trains_and_resumes_on_cpu(tmp_path):
    out = tmp_path / "m.json"
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--steps", "4", "--seq", "32", "--batch",
            "4", "--log-every", "1", "--checkpoint-every", "2",
            "--checkpoint-dir", ck, "--metrics-out", str(out)]
    assert launch_train.main(argv) == 0
    log = json.loads(out.read_text())
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    for m in log:
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr", "step",
                          "sec_per_step"}
        assert np.isfinite(m["loss"])
    # a crash after step 2: the rerun resumes there and finishes steps 3-4
    # bit for bit as the uninterrupted run
    os.remove(os.path.join(ck, "step_00000004.ckpt"))
    assert launch_train.main(argv) == 0
    again = json.loads(out.read_text())
    assert [m["step"] for m in again] == [3, 4]
    assert again == [{**m, "sec_per_step": r["sec_per_step"]}
                     for m, r in zip(log[2:], again)]
