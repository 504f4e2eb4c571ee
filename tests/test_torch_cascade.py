"""The port's Super-Sub cascade and its task against the JAX package's.

``HierarchicalTask`` draws the same tokens in both packages.  Likelihood
members (the task's own log-likelihood tables, the generalist's blurred
by a fixed numpy draw) and reduced transformer classifiers (2 layers,
d 64, JAX weights bridged into the port) run through both packages'
cascades; predictions must be equal, and the classifiers' pooled logits
within ``atol=5e-4, rtol=1e-3`` in float32.  The port's pipelined
cascade runs on two slots (the card's phase does too) and on three,
where it hides more of each specialist load."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels as jax_kernels  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.cascade import CascadeMember as JaxMember  # noqa: E402
from repro.core.cascade import SuperSubCascade as JaxCascade  # noqa: E402
from repro.core.context import ContextSwitchEngine as JaxEngine  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.train.data import HierarchicalTask as JaxTask  # noqa: E402
from repro_torch.bridge import params_from_jax, tree_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.core.cascade import (CascadeMember, SuperSubCascade,  # noqa: E402
                                      classifier_logits)
from repro_torch.core.context import ContextSwitchEngine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.data import HierarchicalTask  # noqa: E402

VOCAB, SEQ = 64, 48


@pytest.fixture(scope="module")
def task():
    return HierarchicalTask(num_super=4, subs_per_super=3, vocab=VOCAB,
                            seq_len=SEQ, seed=0)


@pytest.fixture(scope="module")
def jtask():
    return JaxTask(num_super=4, subs_per_super=3, vocab=VOCAB, seq_len=SEQ,
                   seed=0)


@pytest.fixture(autouse=True)
def _jax_reference_path():
    prev = jax_kernels.get_mode()
    jax_kernels.set_mode("off")
    try:
        yield
    finally:
        jax_kernels.set_mode(prev)


def _engine(slots=2):
    return ContextSwitchEngine(num_slots=slots, device="cpu")


@pytest.mark.parametrize("seed", [0, 5])
def test_hierarchical_task_draws_equal_jax(seed):
    t = HierarchicalTask(num_super=3, subs_per_super=4, vocab=96,
                         seq_len=20, seed=seed)
    j = JaxTask(num_super=3, subs_per_super=4, vocab=96, seq_len=20,
                seed=seed)
    np.testing.assert_array_equal(t.dists, j.dists)
    np.testing.assert_array_equal(t.sub_of_super, j.sub_of_super)
    for kw in ({}, {"subclasses": np.array([1, 7])}):
        got, want = t.sample(9, seed=seed + 3, **kw), j.sample(9,
                                                               seed=seed + 3,
                                                               **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    b = next(t.batch_iter(4, seed=seed))
    jb = next(j.batch_iter(4, seed=seed))
    for k in ("x", "sub", "sup"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------- members
def _tables(task, noise=0.35, seed=0):
    """(exact log-likelihoods, the generalist's blurred copy), float32."""
    logd = np.log(task.dists + 1e-9)
    noisy = logd + np.random.default_rng(seed).normal(0, noise, logd.shape)
    return logd.astype(np.float32), noisy.astype(np.float32)


def _jax_members(task, delay=0.0):
    logd, noisy = _tables(task)
    sup_of = task.sub_of_super

    def counts(x):
        return jax.vmap(lambda r: jnp.bincount(r, length=task.vocab))(x)

    def super_fn(p, x):
        sub_ll = counts(x).astype(jnp.float32) @ p["logd"].T
        sup_ll = jnp.zeros((x.shape[0], task.num_super))
        return sup_ll.at[:, p["sup_of"]].add(jax.nn.softmax(sub_ll, -1))

    def ll_fn(p, x):
        return counts(x).astype(jnp.float32) @ p["logd"].T

    def w(tree):
        def fn():
            time.sleep(delay)
            return jax.tree.map(jnp.asarray, tree)
        return fn

    sup = JaxMember("super", super_fn, w({"logd": logd, "sup_of": sup_of}))
    gen = JaxMember("generalist", ll_fn, w({"logd": noisy}))
    specs = [JaxMember(f"spec{g}", ll_fn,
                       w({"logd": logd[np.where(sup_of == g)[0]]}), covers=g)
             for g in range(task.num_super)]
    return sup, gen, specs


def _port_members(task, delay=0.0, run_delay=0.0):
    """The same members in plain torch; tables carried across with
    ``tree_from_numpy``.  ``delay`` slows each load, ``run_delay`` each
    pass of a member."""
    logd, noisy = _tables(task)
    sup_of = task.sub_of_super

    def counts(x):
        time.sleep(run_delay)
        x = torch.as_tensor(x).long()
        return torch.zeros(x.shape[0], task.vocab).scatter_add_(
            1, x, torch.ones(x.shape))

    def super_fn(p, x):
        sub_ll = counts(x) @ p["logd"].T
        return torch.zeros(x.shape[0], task.num_super).index_add_(
            1, p["sup_of"], torch.softmax(sub_ll, -1))

    def ll_fn(p, x):
        return counts(x) @ p["logd"].T

    def w(tree):
        host = tree_from_numpy(tree, device="cpu")

        def fn():
            time.sleep(delay)
            return host
        return fn

    sup = CascadeMember("super", super_fn, w({"logd": logd,
                                              "sup_of": sup_of}))
    gen = CascadeMember("generalist", ll_fn, w({"logd": noisy}))
    specs = [CascadeMember(f"spec{g}", ll_fn,
                           w({"logd": logd[np.where(sup_of == g)[0]]}),
                           covers=g)
             for g in range(task.num_super)]
    return sup, gen, specs


def _single_superclass_batches(task, n, seed0, size=16):
    return [task.sample(size, seed=seed0 + b,
                        subclasses=np.array([3 * (b % 4)]))[0]
            for b in range(n)]


def test_likelihood_cascade_evaluate_equals_jax(task, jtask):
    sup, gen, specs = _port_members(task)
    cas = SuperSubCascade(_engine(), sup, specs, gen, task.sub_of_super)
    jsup, jgen, jspecs = _jax_members(jtask)
    jeng = JaxEngine(num_slots=2)
    jcas = JaxCascade(jeng, jsup, jspecs, jgen, jtask.sub_of_super)
    for b in range(4):                   # single-subclass batches of 16
        x, sub, _ = task.sample(32, seed=b, subclasses=np.array([2 * b]))
        got = cas.evaluate(x, sub, batch=16)
        want = jcas.evaluate(x.numpy(), sub.numpy(), batch=16)
        assert got == pytest.approx(want, abs=0), (b, got, want)
    x, sub, _ = task.sample(16, seed=9)
    np.testing.assert_array_equal(cas.static_infer(x),
                                  jcas.static_infer(x.numpy()))
    cas.engine.shutdown()
    jeng.shutdown()


@pytest.mark.parametrize("slots", [2, 3])
def test_pipelined_equals_sequential_and_jax(task, jtask, slots):
    batches = _single_superclass_batches(task, 6, 100)
    sup, gen, specs = _port_members(task)
    seng = _engine(slots)
    scas = SuperSubCascade(seng, sup, specs, gen, task.sub_of_super)
    seq = [scas.dynamic_infer(x) for x in batches]
    seng.shutdown()
    eng = _engine(slots)
    pipe = SuperSubCascade(eng, sup, specs, gen,
                           task.sub_of_super).dynamic_infer_pipelined(batches)
    jsup, jgen, jspecs = _jax_members(jtask)
    jeng = JaxEngine(num_slots=3)        # JAX's pipeline needs three slots
    jpipe = JaxCascade(jeng, jsup, jspecs, jgen, jtask.sub_of_super
                       ).dynamic_infer_pipelined([x.numpy()
                                                  for x in batches])
    assert len(pipe) == len(seq) == len(jpipe) == len(batches)
    for a, b, c in zip(seq, pipe, jpipe):
        assert a["super"] == b["super"] == c["super"]
        np.testing.assert_array_equal(a["sub"], b["sub"])
        np.testing.assert_array_equal(b["sub"], c["sub"])
    # one pass of the super net a batch, one of its specialist
    assert eng.stats["switches"] >= 2 * len(batches)
    eng.shutdown()
    jeng.shutdown()


def test_pipelined_hides_specialist_load_on_two_slots(task):
    sup, gen, specs = _port_members(task, delay=0.05)
    eng = _engine(2)
    cas = SuperSubCascade(eng, sup, specs, gen, task.sub_of_super)
    out = cas.dynamic_infer_pipelined(
        _single_superclass_batches(task, 4, 200))
    assert len(out) == 4
    assert eng.stats["hidden_load_seconds"] > 0.0, dict(eng.stats)
    eng.shutdown()


def test_pipelined_hides_more_load_with_a_spare_slot(task):
    """On three slots batch i's specialist load is issued before batch
    i-1's specialist pass, so it hides behind that pass and the next
    super pass; on two slots behind the super pass only."""
    batches = _single_superclass_batches(task, 6, 300)
    hidden, out = {}, {}
    for slots in (2, 3):
        sup, gen, specs = _port_members(task, delay=0.1, run_delay=0.05)
        eng = _engine(slots)
        out[slots] = SuperSubCascade(eng, sup, specs, gen, task.sub_of_super
                                     ).dynamic_infer_pipelined(batches)
        hidden[slots] = eng.stats["hidden_load_seconds"]
        eng.shutdown()
    for a, b in zip(out[2], out[3]):
        assert a["super"] == b["super"]
        np.testing.assert_array_equal(a["sub"], b["sub"])
    assert len({o["super"] for o in out[3]}) > 1      # specialists change
    assert hidden[3] >= hidden[2] > 0.0, hidden


def test_unknown_superclass_falls_back_to_generalist(task, jtask):
    sup, gen, specs = _port_members(task)
    cas = SuperSubCascade(_engine(), sup, specs[1:], gen, task.sub_of_super)
    jsup, jgen, jspecs = _jax_members(jtask)
    jeng = JaxEngine(num_slots=2)
    jcas = JaxCascade(jeng, jsup, jspecs[1:], jgen, jtask.sub_of_super)
    x, _, _ = task.sample(32, seed=5, subclasses=np.array([0, 1, 2]))
    out, want = cas.dynamic_infer(x), jcas.dynamic_infer(x.numpy())
    assert out["super"] == want["super"] == 0
    assert out["sub"].shape == (32,)
    np.testing.assert_array_equal(out["sub"], want["sub"])
    assert cas.engine.active.name == "generalist"
    cas.engine.shutdown()
    jeng.shutdown()


def test_argmax_ties_pick_the_first_index_as_jax():
    """Tied logits: the superclass and each row's class are the first
    maximal index in both packages (``torch.argmax`` as ``jnp.argmax``)."""
    sup_of = np.array([0, 0, 1, 1, 2, 2])
    tie_sup = np.array([[1.0, 3.0, 3.0], [0.0, 1.0, 1.0]], np.float32)
    tie_sub = np.array([[5.0, 5.0], [1.0, 2.0]], np.float32)
    tie_gen = np.array([[0.0, 2.0, 2.0, 2.0, 0.0, 2.0],
                        [7.0, 7.0, 7.0, 7.0, 7.0, 7.0]], np.float32)
    for logits in (tie_sup, tie_sub, tie_gen):
        assert (torch.from_numpy(logits).argmax(-1).tolist()
                == np.asarray(jnp.argmax(jnp.asarray(logits), -1)).tolist())

    def port(lg):
        return lambda p, x: torch.from_numpy(lg)

    def jx(lg):
        return lambda p, x: jnp.asarray(lg)

    outs = []
    for mk, Member, Engine, Cascade in (
            (port, CascadeMember, _engine, SuperSubCascade),
            (jx, JaxMember, lambda: JaxEngine(num_slots=2), JaxCascade)):
        eng = Engine()
        members = [Member(n, mk(lg), lambda: {}) for n, lg in
                   (("super", tie_sup), ("generalist", tie_gen))]
        specs = [Member("spec1", mk(tie_sub), lambda: {}, covers=1)]
        cas = Cascade(eng, members[0], specs, members[1], sup_of)
        x = np.zeros((2, 4), np.int32)
        outs.append((cas.dynamic_infer(x), cas.static_infer(x)))
        eng.shutdown()
    (dyn, sta), (jdyn, jsta) = outs
    # tie_sup's row mean [0.5, 2, 2] -> superclass 1; its specialist's
    # rows -> local [0, 1] -> global [2, 3]; the generalist's -> [1, 0]
    assert dyn["super"] == jdyn["super"] == 1
    np.testing.assert_array_equal(dyn["sub"], jdyn["sub"])
    np.testing.assert_array_equal(dyn["sub"], [2, 3])
    np.testing.assert_array_equal(sta, jsta)
    np.testing.assert_array_equal(sta, [1, 0])


# ------------------------------------------------------------ transformers
KW = dict(vocab_size=VOCAB, num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
          param_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(port LM, JAX LM) of a reduced float32 supersub-super classifier
    backbone (``examples/train_cascade.py``'s shape)."""
    return (build_model(override(reduced(get_arch("supersub-super")), **KW),
                        cache_dtype=torch.float32, device="cpu"),
            jax_build(jax_reduced(jax_get_arch("supersub-super"), **KW),
                      cache_dtype=jnp.float32))


def _classifier_params(jm, num_classes, seed):
    """(port params, JAX params) of one member, drawn in numpy on the
    shapes of JAX's init (norm weights about 1, the rest about 0.05) and
    bridged into the port."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        a = 0.05 * rng.standard_normal(s.shape)
        if "norm" in jax.tree_util.keystr(path):
            a += 1.0
        return a.astype(s.dtype)

    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    host = {"backbone": jax.tree_util.tree_map_with_path(draw, shapes),
            "head": (0.05 * rng.standard_normal((KW["d_model"],
                                                 num_classes))
                     ).astype(np.float32)}
    return ({"backbone": params_from_jax(host["backbone"], device="cpu"),
             **tree_from_numpy({"head": host["head"]}, device="cpu")},
            jax.tree.map(jnp.asarray, host))


def test_transformer_cascade_equals_jax(task, models):
    tm, jm = models

    def logits(p, t):
        return classifier_logits(tm, p, t)

    @jax.jit
    def jlogits(p, t):
        h, _ = jm.hidden(p["backbone"], t)
        return h.mean(axis=1) @ p["head"]

    classes = {"super": 4, "generalist": 12,
               **{f"spec{g}": 3 for g in range(4)}}
    members, jmembers = {}, {}
    x = task.sample(16, seed=3)[0]
    for i, (name, k) in enumerate(classes.items()):
        tp, jp = _classifier_params(jm, k, seed=10 + i)
        got = logits(tp, x)
        want = np.asarray(jlogits(jp, jnp.asarray(x.numpy())))
        assert got.shape == (16, k) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))
        covers = int(name[4:]) if name.startswith("spec") else None
        members[name] = CascadeMember(name, logits, lambda tp=tp: tp,
                                      covers=covers)
        jmembers[name] = JaxMember(name, jlogits, lambda jp=jp: jp,
                                   covers=covers)

    def cascade(ms, Cascade, eng):
        return Cascade(eng, ms["super"], [ms[f"spec{g}"] for g in range(4)],
                       ms["generalist"], task.sub_of_super)

    eng, jeng = _engine(2), JaxEngine(num_slots=2)
    cas, jcas = cascade(members, SuperSubCascade, eng), cascade(
        jmembers, JaxCascade, jeng)
    for b in range(2):
        xb = task.sample(16, seed=40 + b, subclasses=np.array([3 * b]))[0]
        got, want = cas.dynamic_infer(xb), jcas.dynamic_infer(
            jnp.asarray(xb.numpy()))
        assert got["super"] == want["super"]
        np.testing.assert_array_equal(got["sub"], want["sub"])
    eng.shutdown()
    jeng.shutdown()
