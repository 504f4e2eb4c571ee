"""Partial reconfiguration, ``run_async`` and the ``ContextStore`` of the
port's ``ContextSwitchEngine`` (the counterparts of the JAX package's
``tests/test_context.py`` delta and store tests), on the CPU.  The delta
load's wire bytes and outputs are also held against the JAX engine's on
the same weights."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.context import ContextDescriptor as JaxDesc  # noqa: E402
from repro.core.context import ContextSwitchEngine as JaxEngine  # noqa: E402
from repro_torch.core.context import (ContextDescriptor,  # noqa: E402
                                      ContextState, ContextStore,
                                      ContextSwitchEngine, _leaves)


def _engine(slots=3, **kw):
    return ContextSwitchEngine(num_slots=slots, device="cpu", **kw)


def _mm(p, x):
    return (x @ p["backbone"]) @ p["head"]


def test_delta_load_moves_only_the_delta_as_jax():
    backbone = {"backbone": np.ones((256, 256), np.float32),
                "head": np.ones((256, 8), np.float32)}
    delta = {"head": np.full((256, 8), 2.0, np.float32)}
    results = []
    for Desc, Engine, conv in (
            (ContextDescriptor, _engine, torch.from_numpy),
            (JaxDesc, lambda: JaxEngine(num_slots=3), jnp.asarray)):
        eng = Engine()
        eng.register(Desc(name="base", apply_fn=_mm, weights_fn=lambda: {
            k: conv(v) for k, v in backbone.items()}))
        eng.register(Desc(name="spec", apply_fn=_mm, weights_fn=lambda: {
            k: conv(v) for k, v in delta.items()}, base="base"))
        eng.preload("base", block=True)
        b0 = eng.stats["bytes_loaded"]
        eng.preload("spec", block=True)
        delta_bytes = eng.stats["bytes_loaded"] - b0
        eng.switch("spec")
        spec = np.asarray(eng.run(conv(np.ones((2, 256), np.float32))))
        eng.switch("base")
        base = np.asarray(eng.run(conv(np.ones((2, 256), np.float32))))
        results.append((delta_bytes, spec, base))
        eng.shutdown()
    (nb, spec, base), (jnb, jspec, jbase) = results
    assert nb == jnb == 256 * 8 * 4          # only the head crossed
    np.testing.assert_allclose(spec, 256 * 256 * 2.0)
    np.testing.assert_allclose(base, 256 * 256 * 1.0)
    np.testing.assert_array_equal(spec, jspec)
    np.testing.assert_array_equal(base, jbase)


def test_delta_load_assembles_exactly_a_full_load():
    """The delta slot's tree equals a full load of the same weights leaf
    for leaf; untouched leaves are the base slot's own tensors; wire
    bytes are the delta's, resident bytes the merged tree's."""
    g = torch.Generator().manual_seed(0)
    backbone = {"backbone": torch.randn(64, 64, generator=g),
                "head": torch.randn(64, 8, generator=g),
                "norm": {"w": torch.full((64,), 0.5),
                         "b": torch.zeros(64)},
                "blocks": [{"w": torch.randn(64, 64, generator=g)}]}
    delta = {"head": torch.randn(64, 8, generator=g),
             "norm": {"w": torch.full((64,), 0.25)}}   # nested dicts merge
    full = {**backbone, "head": delta["head"],
            "norm": {"w": delta["norm"]["w"], "b": backbone["norm"]["b"]}}
    eng = _engine()
    for name, fn, base in (("base", lambda: backbone, None),
                           ("spec", lambda: delta, "base"),
                           ("spec-full", lambda: full, None)):
        eng.register(ContextDescriptor(name=name, apply_fn=lambda p, x: x,
                                       weights_fn=fn, base=base))
    eng.preload("base", block=True)
    b0 = eng.stats["bytes_loaded"]
    spec = eng.preload("spec", block=True).result()
    delta_bytes = eng.stats["bytes_loaded"] - b0
    assert delta_bytes == sum(t.nbytes for t in _leaves(delta))
    full_slot = eng.preload("spec-full", block=True).result()
    assert spec.bytes_resident == full_slot.bytes_resident
    assert spec.buffers.keys() == full_slot.buffers.keys()
    assert spec.buffers["norm"].keys() == full_slot.buffers["norm"].keys()
    for a, b in zip(_leaves(spec.buffers), _leaves(full_slot.buffers)):
        assert torch.equal(a, b)
    base = eng._find_slot("base").buffers
    assert spec.buffers["backbone"] is base["backbone"]
    assert spec.buffers["blocks"] is base["blocks"]
    assert spec.buffers["norm"]["b"] is base["norm"]["b"]
    assert spec.buffers["head"] is not base["head"]
    eng.shutdown()


def test_delta_without_resident_base_fails_and_frees_its_slot():
    eng = _engine(slots=2)
    eng.register(ContextDescriptor(
        name="spec", apply_fn=lambda p, x: x,
        weights_fn=lambda: {"w": torch.ones(2)}, base="missing"))
    with pytest.raises(RuntimeError, match="needs base 'missing'"):
        eng.preload("spec").result(timeout=10)
    assert all(s.state == ContextState.EMPTY for s in eng.slots)
    assert eng.stats["loads"] == 0
    for n in "ab":                           # both slots load again
        eng.register(ContextDescriptor(
            name=n, apply_fn=lambda p, x: x * p["w"],
            weights_fn=lambda: {"w": torch.full((2,), 3.0)}))
        eng.preload(n, block=True)
    assert sorted(eng.resident()) == ["a", "b"]
    eng.switch("b")
    assert torch.equal(eng.run(torch.ones(2)), torch.full((2,), 3.0))
    eng.shutdown()


def test_context_store_bf16_round_trip_across_restart(tmp_path):
    """FeFET non-volatility analogue: a bf16 context saved by one engine
    is reloaded by a new engine bit for bit, lists and nesting kept; a
    descriptor without ``weights_fn`` loads from the engine's store, and
    one without a store to load from is refused."""
    g = torch.Generator().manual_seed(1)
    w = {"embed": torch.randn(16, 8, generator=g).to(torch.bfloat16),
         "blocks": [{"w": torch.randn(8, 8, generator=g).to(torch.bfloat16)},
                    {"w": torch.randn(8, 8, generator=g)}],
         "ids": torch.arange(5, dtype=torch.int32),
         "scalar": torch.tensor(2.5, dtype=torch.bfloat16)}
    store = ContextStore(str(tmp_path / "store"))
    path = store.save("ctx", w)
    assert path.endswith("ctx_ctx")
    assert not (tmp_path / "store" / "ctx_ctx.tmp").exists()

    def apply(p, x):
        return (x.to(torch.bfloat16) @ p["blocks"][0]["w"]) * p["scalar"]

    x = torch.randn(3, 8, generator=g)
    first = _engine(slots=2, store=store)
    first.register(ContextDescriptor("ctx", apply, lambda: w))
    first.preload("ctx", block=True)
    first.switch("ctx")
    want = first.run(x)
    first.shutdown()

    eng = _engine(slots=2, store=store)      # a "restarted" process
    eng.register(ContextDescriptor("ctx", apply))   # loads from the store
    slot = eng.preload("ctx", block=True).result()
    eng.switch("ctx")
    got = eng.run(x)
    assert isinstance(slot.buffers["blocks"], list)
    for a, b in zip(_leaves(slot.buffers), _leaves(w)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    eng.shutdown()
    bare = _engine(slots=2)
    with pytest.raises(ValueError, match="no weights_fn"):
        bare.register(ContextDescriptor("ctx", apply))
    bare.shutdown()


def test_context_store_refuses_corrupted_files(tmp_path):
    store = ContextStore(str(tmp_path))
    w = {"w": torch.full((64,), 3.0, dtype=torch.bfloat16),
         "v": torch.ones(4)}
    path = store.save("a", w)
    blob = bytearray(open(path, "rb").read())
    at = blob.find(bytes(torch.full((64,), 3.0,
                                    dtype=torch.bfloat16).view(torch.uint8)))
    assert at >= 0                            # stored uncompressed
    blob[at + 7] ^= 0x01                      # one bit of one leaf
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        store.weights_fn("a")()
    # a file whose digest does not match its leaf
    obj = torch.load(store.save("b", w), weights_only=True)
    obj["digests"]["v"] = "0" * 32
    torch.save(obj, tmp_path / "ctx_b")
    with pytest.raises(IOError, match="digest mismatch at v"):
        store.weights_fn("b")()
    (tmp_path / "ctx_c").write_bytes(b"not a context")
    with pytest.raises(IOError):
        store.weights_fn("c")()
    with pytest.raises(ValueError):
        store.save("d", {"a/b": torch.ones(1)})


def test_run_async_equals_run():
    eng = _engine(slots=2)
    eng.register(ContextDescriptor(
        "a", lambda p, x: torch.tanh(x @ p["w"]),
        lambda: {"w": torch.randn(8, 8, generator=torch.Generator()
                                  .manual_seed(2))}))
    with pytest.raises(RuntimeError, match="no ACTIVE context"):
        eng.run_async(torch.ones(2, 8))
    eng.preload("a", block=True)
    eng.switch("a")
    x = torch.randn(4, 8)
    runs = eng.stats["switches"]
    assert torch.equal(eng.run_async(x), eng.run(x))
    assert eng.stats["switches"] == runs
    eng.shutdown()
