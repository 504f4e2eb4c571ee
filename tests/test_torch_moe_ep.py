"""Expert-parallel and tensor-parallel MoE in the port: kernel B7's plain
version (``gmm``, ``expert_mlp``), the capacity dispatch and combine,
``moe_ep`` / ``moe_tp`` / ``moe_apply`` over a mesh of logical CPU
shards, the mesh collectives and reduced mixtral's ``LM(mesh=...)``,
against the JAX package's, on the CPU in float32.

JAX runs ``moe_ep`` under ``shard_map`` on a real mesh, which needs the
host platform forced to four devices before JAX starts: one module
fixture runs this file as a subprocess (``python
tests/test_torch_moe_ep.py --jax-reference OUT.npz``) with ``XLA_FLAGS``
in its environment, and the tests read its ``.npz``.  Tolerances:
``atol=5e-4`` for MoE outputs (``tests/_distributed_worker.py``'s),
``atol=5e-4, rtol=1e-3`` for logits, ``atol=2e-5`` for the grouped
matmul (``test_kernels.py``'s float32 one)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.gmm.ops import expert_mlp as jax_expert_mlp  # noqa: E402
from repro.kernels.gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.gmm.ref import (  # noqa: E402
    expert_mlp_reference as jax_expert_mlp_ref, gmm_reference as jax_gmm_ref)
from repro.models import moe as JM  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch, override, reduced  # noqa: E402
from repro_torch.distributed.mesh import (Mesh, all_to_all,  # noqa: E402
                                          make_mesh, pmax, psum)
from repro_torch.kernels.gmm.ops import expert_mlp, gmm  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
ATOL = 2e-5                 # float32 kernels, as test_kernels.py:_tol
MOE_ATOL = 5e-4             # as tests/_distributed_worker.py's moe_ep check
EP = 4
B, S = 2, 16                # 8 tokens a shard: capacity 5 at cf 1.25
CASES = {"skewed": 1.25, "nodrop": 4.0}    # router case -> capacity factor


def _close(got, want, atol=MOE_ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _cfgs():
    """(port cfg, JAX cfg): reduced mixtral (4 experts of width 64, top
    2), float32."""
    return (override(reduced(get_arch("mixtral-8x7b")), **F32),
            jax_reduced(jax_get_arch("mixtral-8x7b"), **F32))


def _moe_case(case, cfg):
    """Numpy MoE weights and input.  ``skewed`` biases the router to
    expert 0 so that capacity drops tokens; ``nodrop`` keeps it even."""
    rng = np.random.default_rng(5)
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    tree = {"w_router": rng.standard_normal((d, e)) * 0.3,
            "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if case == "skewed":
        x[..., 0] = np.abs(x[..., 0]) + 2.0
        tree["w_router"][0, 0] = 4.0
    return tree, x


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _jax_lm():
    _, jcfg = _cfgs()
    jm = jax_build(jcfg)
    return jcfg, jm, jm.init(jax.random.key(0))


def jax_reference(out_path: str) -> None:
    """Run by the module fixture in a subprocess with four forced host
    devices: JAX's ``moe_ep`` per router case, and reduced mixtral's
    forward with and without the mesh, written to ``out_path``."""
    from repro.distributed.mesh import make_mesh as jax_make_mesh
    assert jax.device_count() == EP, jax.device_count()
    mesh = jax_make_mesh((EP,), ("model",))
    _, jcfg = _cfgs()
    res = {}
    for case, cf in CASES.items():
        tree, x = _moe_case(case, jcfg)
        y, aux = JM.moe_ep({k: jnp.asarray(v) for k, v in tree.items()},
                           jnp.asarray(x), jcfg, mesh, capacity_factor=cf)
        res[f"ep_{case}"], res[f"aux_{case}"] = np.asarray(y), np.asarray(aux)
    jcfg, jm, jp = _jax_lm()
    toks = _tokens(jcfg)
    res["forward_nomesh"] = np.asarray(jm.forward(jp, toks)[0])
    jmm = jax_build(jcfg, mesh=mesh)
    with mesh:
        res["forward_mesh"] = np.asarray(jmm.forward(jp, toks)[0])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_mesh_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_ep") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(root / "src"), os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, __file__, "--jax-reference", str(out)],
                   env=env, check=True, timeout=600, cwd=root)
    with np.load(out) as f:
        return dict(f)


def _cpu_mesh(n=EP):
    return Mesh(("cpu",) * n)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# kernel B7: the grouped matmul's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,D,F", [
    (2, 32, 64, 128),
    (3, 20, 64, 96),        # C not a multiple of any tile
    (1, 1, 32, 64),
])
def test_gmm_plain_matches_jax(E, C, D, F):
    rng = np.random.default_rng(C)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    kernels.reset_launch_counts()
    got = gmm(torch.from_numpy(x), torch.from_numpy(w))
    assert gmm.launches == 0                         # CPU: plain version
    assert got.shape == (E, C, F) and got.dtype == torch.float32
    for want in (jax_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True),
                 jax_gmm_ref(jnp.asarray(x), jnp.asarray(w))):
        _close(got, want, atol=ATOL, rtol=1e-5)


def test_expert_mlp_plain_matches_jax():
    rng = np.random.default_rng(2)
    E, C, D, F = 2, 24, 64, 128
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    got = expert_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws))
    jx, jws = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    _close(got, jax_expert_mlp(jx, *jws, interpret=True), atol=ATOL,
           rtol=1e-5)
    _close(got, jax_expert_mlp_ref(jx, *jws), atol=ATOL, rtol=1e-5)
    # bf16 in: each product comes back in bf16, as in JAX
    xb = torch.from_numpy(x).bfloat16()
    assert expert_mlp(xb, *(torch.from_numpy(w).bfloat16() for w in ws)
                      ).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_and_combine_match_jax(case):
    cfg, jcfg = _cfgs()
    tree, x = _moe_case(case, cfg)
    xt = x.reshape(-1, cfg.d_model)[:8]              # one shard's tokens
    top_p, top_i, _ = TM.router(_t(tree), torch.from_numpy(xt), cfg.moe)
    jtop_p, jtop_i, _ = JM.router(_j(tree), jnp.asarray(xt), jcfg.moe)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    E, cap = cfg.moe.num_experts, 5
    buf, slot, kept = TM._dispatch_local(torch.from_numpy(xt), top_p, top_i,
                                         E, cap)
    jbuf, jslot, jkept = JM._dispatch_local(jnp.asarray(xt), jtop_p, jtop_i,
                                            E, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if case == "skewed":
        assert not kept.all()                        # drops exercised
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(buf.shape)).astype(np.float32))
    got = TM._combine_local(y, top_p, top_i, slot, kept, cap)
    want = JM._combine_local(jnp.asarray(y.numpy()), jtop_p, jtop_i, jslot,
                             jkept, cap)
    _close(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# moe_ep, moe_tp, moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_moe_ep_one_shard_matches_jax(case):
    """ep=1: JAX's ``moe_ep`` on a one-device mesh."""
    from repro.distributed.mesh import make_mesh as jax_make_mesh
    cfg, jcfg = _cfgs()
    tree, x = _moe_case(case, cfg)
    cf = CASES[case]
    got, aux = TM.moe_ep(_t(tree), torch.from_numpy(x), cfg, _cpu_mesh(1),
                         capacity_factor=cf)
    want, jaux = JM.moe_ep(_j(tree), jnp.asarray(x), jcfg,
                           jax_make_mesh((1,), ("model",)),
                           capacity_factor=cf)
    _close(got, want)
    _close(aux, jaux, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ep_four_shards_match_jax_mesh(case, jax_mesh_ref):
    """ep=4 over four logical CPU shards against JAX's ``shard_map`` over
    four devices.  The skewed router drops (token, choice) pairs, and
    then the result is not the dense one; without drops (cf 4.0) it is
    ``moe_dense_ref``'s too."""
    cfg, _ = _cfgs()
    tree, x = _moe_case(case, cfg)
    tx = torch.from_numpy(x)
    got, aux = TM.moe_ep(_t(tree), tx, cfg, _cpu_mesh(),
                         capacity_factor=CASES[case])
    _close(got, jax_mesh_ref[f"ep_{case}"])
    _close(aux, jax_mesh_ref[f"aux_{case}"], atol=1e-6)
    dense, _ = TM.moe_dense_ref(_t(tree), tx, cfg)
    # shard 0's tokens under shard 0's capacity
    xt = tx[:, :S // EP].reshape(-1, cfg.d_model)
    top_p, top_i, _ = TM.router(_t(tree), xt, cfg.moe)
    cap = int(np.ceil(xt.shape[0] * cfg.moe.top_k / cfg.moe.num_experts
                      * CASES[case]))
    _, _, kept = TM._dispatch_local(xt, top_p, top_i, cfg.moe.num_experts,
                                    cap)
    if case == "skewed":
        assert not kept.all()
        assert (got - dense).abs().max() > 1e-2
    else:
        assert kept.all()
        _close(got, dense)


@pytest.mark.parametrize("tp", [None, 4])
def test_moe_tp_matches_jax(tp):
    """``moe_tp``: with no mesh, one pass over F; over four shards, four F
    slices summed with ``psum`` -- the same function as JAX's."""
    cfg, jcfg = _cfgs()
    tree, x = _moe_case("nodrop", cfg)
    got, aux = TM.moe_tp(_t(tree), torch.from_numpy(x), cfg,
                         None if tp is None else _cpu_mesh(tp))
    want, jaux = JM.moe_tp(_j(tree), jnp.asarray(x), jcfg)
    _close(got, want)
    _close(aux, jaux, atol=1e-6)


def test_moe_apply_follows_jax_auto_rule():
    """ep when the mesh has several shards and experts and sequence split
    over it; tp when the sequence does not (a decode step); the dense
    reference without a mesh."""
    cfg, _ = _cfgs()
    tree, x = _moe_case("skewed", cfg)
    p, mesh = _t(tree), _cpu_mesh()
    tx = torch.from_numpy(x)
    assert torch.equal(TM.moe_apply(p, tx, cfg, mesh)[0],
                       TM.moe_ep(p, tx, cfg, mesh)[0])
    # the rule reads the mesh's size, whatever its one axis is called
    renamed = Mesh(mesh.devices, axis_names=("experts",))
    assert torch.equal(TM.moe_apply(p, tx, cfg, renamed)[0],
                       TM.moe_ep(p, tx, cfg, mesh)[0])
    one = tx[:, :1]
    assert torch.equal(TM.moe_apply(p, one, cfg, mesh)[0],
                       TM.moe_tp(p, one, cfg, mesh)[0])
    assert torch.equal(TM.moe_apply(p, tx, cfg)[0],
                       TM.moe_dense_ref(p, tx, cfg)[0])
    with pytest.raises(ValueError, match="needs a mesh"):
        TM.moe_apply(p, tx, cfg, strategy="ep")
    with pytest.raises(ValueError, match="unknown"):
        TM.moe_apply(p, tx, cfg, strategy="pp")


def test_moe_ep_uses_weight_views(monkeypatch):
    """No step copies the expert weights: every shard's FFN gets views of
    the one weight tensor (its own E/ep experts)."""
    cfg, _ = _cfgs()
    tree, x = _moe_case("nodrop", cfg)
    p = _t(tree)
    seen = []
    real = TM._expert_mlp

    def spy(w_gate, w_up, w_down, xs):
        seen.append([w.data_ptr() for w in (w_gate, w_up, w_down)])
        return real(w_gate, w_up, w_down, xs)

    monkeypatch.setattr(TM, "_expert_mlp", spy)
    TM.moe_ep(p, torch.from_numpy(x), cfg, _cpu_mesh())
    El = cfg.moe.num_experts // EP
    for s, ptrs in enumerate(seen):
        assert ptrs == [p[n][s * El].data_ptr()
                        for n in ("w_gate", "w_up", "w_down")]
    assert len(seen) == EP


def test_lm_forward_under_mesh_matches_jax(jax_mesh_ref):
    """Reduced mixtral's ``LM(mesh=...)`` forward (``moe_ep`` in every
    layer) against JAX's under its four-device mesh; the capacity drops
    move both about 3e-2 away from the forward with no mesh."""
    jcfg, _, jp = _jax_lm()
    cfg, _ = _cfgs()
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(cfg)
    got = build_model(cfg, cache_dtype=torch.float32, device="cpu",
                      mesh=_cpu_mesh()).forward(params, toks)
    nomesh = build_model(cfg, cache_dtype=torch.float32,
                         device="cpu").forward(params, toks)
    _close(got, jax_mesh_ref["forward_mesh"], rtol=1e-3)
    _close(nomesh, jax_mesh_ref["forward_nomesh"], rtol=1e-3)
    for a, b in ((got.numpy(), nomesh.numpy()),
                 (jax_mesh_ref["forward_mesh"],
                  jax_mesh_ref["forward_nomesh"])):
        assert np.abs(a - b).max() > 1e-2


def test_lm_decode_under_mesh_runs_tensor_parallel():
    """Under a mesh, prefill (S % 4 == 0) runs ``moe_ep`` and a decode
    step (S == 1) ``moe_tp``; both without drops (cf 4) agree with the
    model with no mesh."""
    cfg, _ = _cfgs()
    cfg = override(cfg, moe=override(cfg.moe, capacity_factor=4.0))
    plain = build_model(cfg, cache_dtype=torch.float32, device="cpu")
    params = plain.init(seed=1, device="cpu")
    meshed = build_model(cfg, cache_dtype=torch.float32, device="cpu",
                         mesh=_cpu_mesh())
    toks = _tokens(cfg)
    out = []
    for m in (plain, meshed):
        logits, caches = m.prefill(params, toks, 32)
        step, _ = m.decode_step(params, caches, toks[:, :1],
                                torch.full((B,), S, dtype=torch.int32))
        out.append((logits, step))
    for a, b in zip(*out):
        _close(b, a, rtol=1e-3)
    with pytest.raises(ValueError, match="lies on"):
        build_model(cfg, device="cpu", mesh=Mesh(["meta"] * 4))


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_all_to_all_is_jax_tiled():
    """Shard s receives piece s of every source, in source order."""
    parts = [torch.arange(8).reshape(4, 2) + 100 * s for s in range(4)]
    out = all_to_all(parts, split_axis=0, concat_axis=1)
    for s in range(4):
        assert torch.equal(out[s], torch.cat([p[s:s + 1] for p in parts], 1))
    back = all_to_all(out, split_axis=1, concat_axis=0)
    for s in range(4):
        assert torch.equal(back[s], parts[s])
    with pytest.raises(ValueError, match="split"):
        all_to_all([torch.zeros(3)] * 2, 0, 0)


def test_psum_pmax_and_mesh():
    parts = [torch.tensor([1.0, -2.0]) * (s + 1) for s in range(3)]
    assert torch.equal(psum(parts), torch.tensor([6.0, -12.0]))
    assert torch.equal(pmax(parts), torch.tensor([3.0, -2.0]))
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 5)
    assert mesh.shape["model"] == 4 and mesh.axis_names == ("model",)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("model",), devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        Mesh(["cpu", "meta"]).device


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        jax_reference(sys.argv[2])
