"""The kernel wrappers' zero padding, on the CPU.

On the card the attention kernels are instantiated for head widths
32/64/128/256 (the decode body takes any group up to 16), the
selective scan for state sizes 8/16/32/64 and the chunkwise mLSTM for
widths that are multiples of 64.  The wrappers run every other size
padded with zeros: ``kernels.decode_padded`` (decode, paged decode and
one shard's partial: zero columns; a group past 16 in slices of 16
heads), ``kernels.verify_padded`` (both verify kernels:
zero columns, any group), ``ssm_scan.with_state_padding`` (zero state
columns) and ``mlstm_chunk.with_dh_padding`` (zero columns, the true
width's scale).  Here each helper runs the plain version on the padded
operands and must give what the plain version gives unpadded, in
float32, within ``test_kernels.py``'s float32 tolerance (2e-5) times
max(1, the largest plain value).  The inputs are made from a seed with
numpy.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_reference)
from repro_torch.kernels.mlstm_chunk.ops import (  # noqa: E402
    MAX_DH, with_dh_padding)
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    mlstm_chunk_reference)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_partial_reference, paged_decode_reference,
    paged_verify_reference)
from repro_torch.kernels.ssm_scan.ops import (  # noqa: E402
    kernel_state_size, with_state_padding)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_reference)
from repro_torch.kernels.verify_attention.ref import (  # noqa: E402
    verify_reference)

ATOL = 2e-5

# (G, hd): groups of one launch (3, 9, 16), sliced (20 = 16 + 4), widths
# padded (48, 96) alone and with an odd group
DECODE_CASES = [(3, 64), (9, 64), (16, 32), (20, 64), (4, 48), (1, 96),
                (9, 96)]


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=ATOL * scale, rtol=0)


def _launches(G, hd):
    """The (group, width) of each kernel launch ``decode_padded`` makes."""
    return [(min(K.MAX_DECODE_GROUP, G - g0), K.kernel_head_dim(hd))
            for g0 in range(0, G, K.MAX_DECODE_GROUP)]


def _pool(rng, NP, Hkv, page, hd, quantized):
    if not quantized:
        return (_t(rng, NP, Hkv, page, hd), _t(rng, NP, Hkv, page, hd), None,
                None)
    codes = [torch.from_numpy(rng.integers(-127, 128, (NP, Hkv, page, hd),
                                           dtype=np.int8)) for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(0, 1 / 64, (NP, Hkv, page))
                               .astype(np.float32)) for _ in range(2)]
    return (*codes, *scales)


def test_instantiated_sizes_are_not_padded():
    seen = []

    def body(qp, kv, Gs):
        seen.append((Gs, qp.shape[-1]))
        return (qp.view(1, 1, Gs, -1),)

    for g in range(1, 17):
        (out,) = K.decode_padded(torch.ones(1, g, 64), 1, (), body)
        assert torch.equal(out, torch.ones(1, 1, g, 64))
    assert seen == [(g, 64) for g in range(1, 17)]
    assert [kernel_state_size(n) for n in (1, 8, 9, 16, 17, 32, 33, 64)] \
        == [8, 8, 16, 16, 32, 32, 64, 64]
    with pytest.raises(ValueError, match="N up to 64"):
        kernel_state_size(65)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        K.kernel_head_dim(300)


@pytest.mark.parametrize("G,hd", DECODE_CASES)
def test_decode_padding_is_exact(G, hd):
    rng = np.random.default_rng(100 * G + hd)
    B, Hkv, S = 2, 2, 40
    q = _t(rng, B, Hkv * G, hd)
    k, v = _t(rng, B, Hkv, S, hd), _t(rng, B, Hkv, S, hd)
    pos = torch.tensor([0, 33], dtype=torch.int32)
    scale = 1.0 / math.sqrt(hd)
    seen = []

    def body(qp, kv, Gp):
        seen.append((Gp, qp.shape[-1]))
        assert qp.shape == (B, Hkv * Gp, kv[0].shape[-1])
        out = decode_reference(qp, *kv, pos, scale=scale)
        return (out.view(B, Hkv, Gp, -1),)

    (got,) = K.decode_padded(q, Hkv, (k, v), body)
    assert seen == _launches(G, hd)
    _close(got.reshape(B, Hkv * G, hd), decode_reference(q, k, v, pos))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G,hd", DECODE_CASES)
def test_paged_decode_padding_is_exact(G, hd, quantized):
    rng = np.random.default_rng(100 * G + hd + quantized)
    B, Hkv, page, P = 2, 2, 8, 3
    q = _t(rng, B, Hkv * G, hd)
    kp, vp, ks, vs = _pool(rng, B * P + 1, Hkv, page, hd, quantized)
    table = torch.from_numpy(rng.permutation(B * P).astype(np.int32) + 1)
    table = table.reshape(B, P)
    pos = torch.tensor([5, 20], dtype=torch.int32)
    scale = 1.0 / math.sqrt(hd)
    seen = []

    def body(qp, kv, Gp):
        seen.append((Gp, qp.shape[-1]))
        out = paged_decode_reference(qp, *kv, table, pos, scale=scale,
                                     k_scale=ks, v_scale=vs)
        return (out.view(B, Hkv, Gp, -1),)

    (got,) = K.decode_padded(q, Hkv, (kp, vp), body)
    assert seen == _launches(G, hd)
    want = paged_decode_reference(q, kp, vp, table, pos, k_scale=ks,
                                  v_scale=vs)
    _close(got.reshape(B, Hkv * G, hd), want)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G,hd", DECODE_CASES)
def test_partial_padding_is_exact(G, hd, quantized):
    """One shard's (acc, m, l), a row it owns nothing of among them."""
    rng = np.random.default_rng(100 * G + hd + 7 * quantized)
    B, Hkv, page, L, base = 3, 2, 8, 4, 4
    q = _t(rng, B, Hkv * G, hd)
    kp, vp, ks, vs = _pool(rng, L, Hkv, page, hd, quantized)
    table = torch.tensor([[4, 5, 9], [6, 1, 7], [2, 3, 0]],
                         dtype=torch.int32)
    pos = torch.tensor([20, 17, 9], dtype=torch.int32)
    scale = 1.0 / math.sqrt(hd)
    seen = []

    def body(qp, kv, Gp):
        seen.append((Gp, qp.shape[-1]))
        return paged_decode_partial_reference(qp, *kv, table, pos, base,
                                              scale=scale, k_scale=ks,
                                              v_scale=vs)

    got = K.decode_padded(q, Hkv, (kp, vp), body)
    assert seen == _launches(G, hd)
    want = paged_decode_partial_reference(q, kp, vp, table, pos, base,
                                          k_scale=ks, v_scale=vs)
    assert torch.equal(want[1][2], torch.full_like(want[1][2], -1e30))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        fin = w > -1e29                                  # m's empty row
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL * max(
            1.0, float(w[fin].abs().max())))


@pytest.mark.parametrize("G,hd,tree,ring", [
    (3, 48, False, False), (8, 96, False, False), (9, 96, True, False),
    (1, 48, True, False), (4, 96, False, True), (16, 32, False, False)])
def test_verify_padding_is_exact(G, hd, tree, ring):
    """Both verify wrappers' padding: the row cache (a ring among them)
    and a bf16 and an int8 page pool, causal and under a tree mask."""
    rng = np.random.default_rng(10 * G + hd + 3 * tree + ring)
    B, Kb, Hkv, page, P = 2, 5, 2, 8, 3
    S = P * page
    q = _t(rng, B, Kb, Hkv * G, hd)
    bk, bv = _t(rng, B, Kb, Hkv, hd), _t(rng, B, Kb, Hkv, hd)
    k, v = _t(rng, B, Hkv, S, hd), _t(rng, B, Hkv, S, hd)
    pos = torch.tensor([0, S + 3 if ring else 13], dtype=torch.int32)
    anc = None
    if tree:
        bits = torch.from_numpy(rng.integers(0, 1 << 30, (B, Kb),
                                             dtype=np.int32))
        i = torch.arange(Kb, dtype=torch.int32)
        anc = (bits & ((1 << i) - 1)) | (1 << i)
    scale = 1.0 / math.sqrt(hd)
    qp, bkp, bvp, treep, Gk, width = K.verify_padded(
        "verify", q, bk, bv, anc, Hkv)
    assert (Gk, width) == (G, K.kernel_head_dim(hd))
    assert qp.shape == (B, Kb, Hkv * G, width) and bkp.is_contiguous()
    got = verify_reference(qp, K.pad_last(k, width), K.pad_last(v, width),
                           bkp, bvp, pos, ring=ring, scale=scale,
                           tree=treep)[..., :hd]
    _close(got, verify_reference(q, k, v, bk, bv, pos, ring=ring, tree=anc))
    if ring:
        return
    table = torch.from_numpy(rng.permutation(B * P).astype(np.int32) + 1)
    table = table.reshape(B, P)
    for quantized in (False, True):
        kp, vp, ks, vs = _pool(rng, B * P + 1, Hkv, page, hd, quantized)
        got = paged_verify_reference(
            qp, K.pad_last(kp, width), K.pad_last(vp, width), bkp, bvp,
            table, pos, scale=scale, k_scale=ks, v_scale=vs,
            tree=treep)[..., :hd]
        _close(got, paged_verify_reference(q, kp, vp, bk, bv, table, pos,
                                           k_scale=ks, v_scale=vs, tree=anc))


@pytest.mark.parametrize("N", [4, 12, 24, 40])
@pytest.mark.parametrize("init", [False, True])
def test_scan_state_padding_is_exact(N, init):
    rng = np.random.default_rng(N + 50 * init)
    B, L, d_in = 2, 9, 6
    u, Bm, Cm = _t(rng, B, L, d_in), _t(rng, B, L, N), _t(rng, B, L, N)
    dt = torch.nn.functional.softplus(_t(rng, B, L, d_in) - 2.0)
    A = -torch.exp(_t(rng, d_in, N) * 0.5)
    D = _t(rng, d_in)
    s0 = _t(rng, B, d_in, N) if init else None
    seen = []

    def body(*args):
        seen.append(args[4].shape[1])
        return selective_scan_reference(*args)

    y, s = with_state_padding(body, u, dt, Bm, Cm, A, D, s0)
    assert seen == [kernel_state_size(N)] and seen[0] > N
    wy, ws = selective_scan_reference(u, dt, Bm, Cm, A, D, s0)
    _close(y, wy)
    _close(s, ws)


@pytest.mark.parametrize("dh", [96, 40])
def test_mlstm_dh_padding_is_exact(dh):
    rng = np.random.default_rng(dh)
    B, H, L, chunk = 2, 2, 32, 16
    q, k, v = (_t(rng, B, H, L, dh) for _ in range(3))
    li = _t(rng, B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(_t(rng, B, H, L) + 1.0)
    seen = []

    def body(qp, kp, vp, li_, lf_, c, scale):
        seen.append((qp.shape[-1], scale))
        return mlstm_chunk_reference(qp, kp, vp, li_, lf_, c, scale=scale)

    h, (C, n, m) = with_dh_padding(body, q, k, v, li, lf, chunk)
    assert seen == [(-(-dh // 64) * 64, 1.0 / math.sqrt(dh))]
    wh, (wC, wn, wm) = mlstm_chunk_reference(q, k, v, li, lf, chunk)
    for got, want in ((h, wh), (C, wC), (n, wn), (m, wm)):
        _close(got, want)
    with pytest.raises(ValueError, match="dh up to"):
        with_dh_padding(body, *(_t(rng, 1, 1, 4, MAX_DH + 1)
                                for _ in range(3)), li[:1, :1, :4],
                        lf[:1, :1, :4], 4)
