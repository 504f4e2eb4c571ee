"""The one-token decode kernels' split of a row's keys over a block cluster
(``kernels/csrc/decode_tc.cuh``), held on the CPU.

The wrappers choose the split from the key capacity alone
(``kernels.decode_splits``: a power of two up to 8, at least two 64-key
tiles a block), so a row's output does not depend on its batch, and cut
the capacity's tiles into one run a block (``kernels.decode_runs``), the
same for a row cache, a page pool and one shard's partial.  The
kernel's arithmetic is written out here in plain torch: each block's
unnormalized flash state (acc, m, l) over its run clipped to the row's
keys, in the log2 domain with the scale on the f32 scores, an empty run as
(0, -1e30, 0), the v scales of an int8 pool on P after l, then the merge.
It must equal the port's plain versions and JAX's plain references within
1e-6 in float32, for the row cache, the ring and an int8 page pool, at
every split the wrappers can choose.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_reference as jax_decode_ref)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_reference as jax_paged_ref)
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_reference)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    gather_pages, gather_scales, paged_decode_partial_reference,
    paged_decode_reference)
from repro_torch.models.layers import _psum_partials  # noqa: E402

ATOL = 1e-6
NEG_INF = -1e30
SPLITS = (1, 2, 4, 8)


@pytest.mark.parametrize("seed", range(8))
def test_split_choice_is_a_power_of_two_whose_runs_cover_every_key(seed):
    """For random pages and capacities: 1, 2, 4 or 8 blocks, the most
    that give every block at least ``DECODE_RUN`` tiles; runs of whole
    tiles that cover each key of [0, cap) exactly once."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        page = int(rng.choice([1, 5, 12, 16, 64, 100, 256]))
        cap = page * int(rng.integers(1, 40))
        s = K.decode_splits(cap)
        tiles = math.ceil(cap / K.DECODE_TILE)
        assert s in SPLITS and (s == 1 or s * K.DECODE_RUN <= tiles)
        assert (2 * s > K.MAX_DECODE_SPLITS
                or 2 * s * K.DECODE_RUN > tiles)       # the most that fit
        runs = K.decode_runs(cap, s)
        assert len(runs) == s
        seen = np.zeros(cap, np.int64)
        for lo, hi in runs:
            assert lo % K.DECODE_TILE == 0 and lo <= hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
        assert [lo for lo, _ in runs[1:]] == [hi for _, hi in runs[:-1]]


def test_split_choice_at_the_served_shapes():
    """tinyllama-1.1b's 768-key rows, mixtral-8x7b's 4096-slot ring and
    the long paged rows (16 pages of 256); a cache of up to three tiles
    cannot split."""
    assert K.decode_splits(768) == 4
    assert K.decode_splits(4096) == 8
    assert [K.decode_splits(c) for c in (64, 191, 192, 256, 448, 449)] == \
        [1, 1, 1, 2, 2, 4]
    assert K.decode_runs(768, 4) == [(0, 192), (192, 384), (384, 576),
                                     (576, 768)]
    assert K.decode_runs(4096, 8)[1] == (512, 1024)


def split_merge(q, k, v, pos, splits, ks=None, vs=None, own=None):
    """The cluster's arithmetic: q (B, H, hd); keys k/v (B, Hkv, T, hd)
    float32 (int8 codes with ks/vs (B, Hkv, T) scales); pos (B,) ->
    (B, H, hd) float32.  With ``own`` ((B, T) bool, the keys on one
    shard's pages) the partial's: only owned keys are read, and the
    merged state comes back unnormalized, (acc (B, Hkv, G, hd), m in the
    natural-log domain or -1e30 where nothing was read, l (B, Hkv, G))."""
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    scale_log2 = hd ** -0.5 * math.log2(math.e)
    qg = q.reshape(B, Hkv, G, hd)
    n = torch.clamp(pos.long(), max=T - 1) + 1
    idx = torch.arange(T)
    states = []
    for lo, hi in K.decode_runs(T, splits):
        valid = (idx >= lo) & (idx < hi) & (idx < n[:, None])   # (B, T)
        if own is not None:
            valid = valid & own
        valid = valid[:, None, None, :]
        s = torch.einsum("bngd,bntd->bngt", qg, k)
        if ks is not None:
            s = s * ks[:, :, None, :]
        s = torch.where(valid, s * scale_log2, float("-inf"))
        m = s.amax(-1)
        m = torch.where(valid.any(-1), m, torch.full_like(m, NEG_INF))
        p = torch.exp2(s - m[..., None])                      # 0 off the run
        l = p.sum(-1)
        if vs is not None:
            p = p * vs[:, :, None, :]
        states.append((torch.einsum("bngt,bntd->bngd", p, v), m, l))
    M = torch.stack([m for _, m, _ in states]).amax(0)
    L = sum(l * torch.exp2(m - M) for _, m, l in states)
    A = sum(a * torch.exp2(m - M)[..., None] for a, m, _ in states)
    if own is not None:
        return A, torch.where(L > 0, M * math.log(2), NEG_INF), L
    return (A / L.clamp_min(1e-30)[..., None]).reshape(B, H, hd)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("ring", [False, True])
def test_split_merge_equals_row_and_ring_decode(splits, ring):
    """Row cache of S = 600 slots (not a tile multiple), rows at pos 0,
    at the runs' first keys and one before, at S - 1; a ring's rows past
    S too (wrapped: every slot)."""
    rng = np.random.default_rng(splits + 10 * ring)
    B, H, Hkv, S, hd = 8, 8, 2, 600, 32
    cuts = [lo for lo, _ in K.decode_runs(S, splits)[1:]]
    pos = [0, S - 1] + [c - 1 for c in cuts] + cuts
    pos += [S, 3 * S + 7] if ring else [1, 63]
    pos = np.asarray((pos * B)[:B], np.int32)
    q, k, v = (_randn(rng, B, H, hd), _randn(rng, B, Hkv, S, hd),
               _randn(rng, B, Hkv, S, hd))
    t = [torch.from_numpy(x) for x in (q, k, v, pos)]
    got = split_merge(*t, splits)
    _close(got, decode_reference(*t))
    _close(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), ring=ring))


@pytest.mark.parametrize("splits", SPLITS)
def test_split_merge_equals_int8_paged_decode(splits):
    """An int8 pool of 16-slot pages in shuffled order, dead entries on the
    park page: codes and per-slot scales gathered by the table, the k
    scales on the scores, the v scales on P."""
    rng = np.random.default_rng(100 + splits)
    B, H, Hkv, P, page, hd = 16, 4, 2, 37, 16, 32
    NP = B * P + 1
    cap = P * page
    cuts = [lo for lo, _ in K.decode_runs(cap, splits)[1:]]
    pos = [3, cap - 1] + cuts + [c - 1 for c in cuts]
    pos = np.asarray((pos * B)[:B], np.int32)
    q = _randn(rng, B, H, hd)
    kc, vc = (rng.integers(-127, 128, (NP, Hkv, page, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.random((NP, Hkv, page)).astype(np.float32) / 64
              for _ in range(2))
    ids = rng.permutation(np.arange(1, NP)).reshape(B, P)
    dead = np.arange(P)[None, :] * page > pos[:, None]
    table = np.where(dead, 0, ids).astype(np.int32)
    tq, tkc, tvc, tks, tvs, tt, tp = (torch.from_numpy(x) for x in
                                      (q, kc, vc, ks, vs, table, pos))
    got = split_merge(tq, gather_pages(tkc, tt).float(),
                      gather_pages(tvc, tt).float(), tp, splits,
                      ks=gather_scales(tks, tt), vs=gather_scales(tvs, tt))
    _close(got, paged_decode_reference(tq, tkc, tvc, tt, tp, k_scale=tks,
                                       v_scale=tvs))
    _close(got, jax_paged_ref(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(table),
                              jnp.asarray(pos), k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs)))


@pytest.mark.parametrize("splits", SPLITS)
def test_split_merge_of_shard_partials_equals_paged_decode(splits):
    """A bf16 bank of 16-slot pages in four shards of 10 pages; rows
    whose pages all lie on one shard, rows across shards and a row at pos
    0.  Each shard's split-and-merge over the keys it owns equals its
    plain partial (acc, m, l), a shard that owns none of a row exactly
    (0, -1e30, 0); merged over the shards (pmax/psum) it equals the paged
    decode, and for a row on one shard the merge adds exact zeros only."""
    rng = np.random.default_rng(200 + splits)
    B, H, Hkv, page, hd, shards, Lp = 6, 4, 2, 16, 32, 4, 10
    P = 6
    cap = P * page
    pos = np.asarray([0, cap - 1, 40, 70, cap - 1, 50], np.int32)
    ids = rng.permutation(np.arange(1, shards * Lp))
    table = np.asarray([ids[:P], [11, 12, 13, 14, 15, 16],
                        [21, 22, 23, 0, 0, 0], ids[P:2 * P],
                        [31, 32, 33, 34, 35, 36], [8, 9, 17, 18, 0, 0]],
                       np.int32)
    q = _randn(rng, B, H, hd)
    kp, vp = (_randn(rng, shards * Lp, Hkv, page, hd) for _ in range(2))
    tq, tkp, tvp, tt, tp = (torch.from_numpy(x) for x in
                            (q, kp, vp, table, pos))
    kg, vg = gather_pages(tkp, tt), gather_pages(tvp, tt)
    parts = []
    for sh in range(shards):
        sl = slice(sh * Lp, (sh + 1) * Lp)
        owned = (tt >= sh * Lp) & (tt < (sh + 1) * Lp)
        own = owned.repeat_interleave(page, dim=1)
        got = split_merge(tq, kg, vg, tp, splits, own=own)
        want = paged_decode_partial_reference(tq, tkp[sl], tvp[sl], tt, tp,
                                              sh * Lp)
        for g, w in zip(got, want):
            _close(g / max(1.0, float(w.abs().max())),
                   w / max(1.0, float(w.abs().max())))
        empty = ~(own & (torch.arange(cap) <= tp[:, None])).any(-1)
        assert torch.equal(got[1][empty],
                           torch.full_like(got[1][empty], NEG_INF))
        parts.append([t[:, :, None] for t in got])
    acc, _, l = _psum_partials(*zip(*parts))
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(B, H, hd)
    _close(out, paged_decode_reference(tq, tkp, tvp, tt, tp))
    one = [1, 4]                              # rows on one shard
    whole = split_merge(tq, kg, vg, tp, splits)
    assert torch.equal(out[one], whole[one])
