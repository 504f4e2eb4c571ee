"""The hand-written Hopper kernels on the card, against their plain
PyTorch versions on the same CUDA tensors (attention: bf16 in,
``atol=2e-2``, the bf16 tolerance of ``test_kernels.py``; the f32
selective scan within 1e-4 of the plain version's largest value; the f32
chunkwise mLSTM within ``test_kernels.py``'s 5e-4 (h, C, n) and 1e-5 (m),
scaled by the plain values' largest magnitude where it passes 1; one
shard's f32 decode partial (acc, m, l) within 1e-4 of the plain values'
largest magnitude, and exactly (0, -1e30, 0) on a row that owns nothing;
the grouped matmul's bf16 output within one bf16 ulp, 1e-4 + 2**-7
|plain|).  Every kernel is held over the Pallas kernels' domain: the
attention kernels over any head width up to 256 (padded past the
instantiated 32/64/128/256) and any group (the decode bodies padded to
1/2/4/8/16 heads, in slices of 16 past that), the scan over any state
size up to 64, the mLSTM over any width up to 512, the grouped matmul
over any C, D and F; paged verify equals row verify, and paged decode
row decode, bit for bit over the same keys.  The decode kernels are held
at every split of a row's keys over a block cluster (1, 2, 4, 8 blocks),
at each split boundary, with no host sync in a call; the scan and the
mLSTM with no host sync, replayed bit for bit from a CUDA graph, the
mLSTM also in spans of one chunk.  The fused multi-step tick
(``StepEngine(multi_step=4)``) is one graph replay, bit for bit the eager
single steps (row, paged, int8, local reads, ring and MoE, hybrid,
xLSTM), adds its captured launches to the counts on every replay,
recaptures over reloaded weights, and syncs nothing.  The prefix cache:
the page copy is a byte copy, a chunked hit (C = page) is bit for bit
the cold chunked stream (bf16, int8, local reads), and fused prefix
engines, one alone and two over a shared bank, are bit for bit their
single-step twins with one capture each.  Training: flash attention's
backward kernel through autograd against the float32 backward of
``mha_reference`` (each gradient within 2**-7 relative L2, bit for bit
run to run); the selective scan's backward kernel against its plain
reverse loop (each of the seven gradients within 1e-4 relative L2 and
each element within 1e-4 of its largest value, bit for bit run to run),
also through autograd, and the forward's checkpoints (the forward's
bits unchanged, each checkpoint the prefix's final state bit for bit,
none written under ``torch.no_grad()``); the chunkwise mLSTM's backward
kernel against its plain version (autograd through the plain chunkwise
form: each of the five gradients within 1e-4 relative L2 and each
element within 1e-4 of its largest value; bit for bit run to run) at chip_smoke.py's record shapes and over its
domain, also through autograd, a final-state cotangent refused by name,
and the forward's saves leaving its outputs' bits as they are; every
wrapper without a backward kernel refusing a gradient by name; one train
step of reduced tinyllama-1.1b, jamba-v0.1-52b, mixtral-8x7b and
xlstm-125m on the card against the same step on the CPU; only a meshed
model's MoE layers refused.  Every test here is marked ``cuda`` and skips without a card.  This file imports neither JAX nor
the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_backward, mha_backward_reference,
    mha_reference)
from repro_torch.kernels.gmm.ops import (  # noqa: E402
    expert_mlp, expert_mlp_reference, gmm, gmm_reference)
from repro_torch.kernels.mlstm_chunk.ops import (  # noqa: E402
    mlstm_chunk, mlstm_chunk_reference)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention, paged_decode_partial,
    paged_decode_partial_reference, paged_decode_reference,
    paged_verify_attention, paged_verify_reference)
from repro_torch.kernels.ssm_scan.ops import (  # noqa: E402
    selective_scan_reference, ssm_scan)
from repro_torch.kernels.verify_attention.ops import (  # noqa: E402
    verify_attention, verify_reference)
from repro_torch.models.layers import _psum_partials  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (sm_90a kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)


@pytest.mark.parametrize("H,Hkv,hd", [(32, 4, 64), (8, 8, 32), (8, 4, 128),
                                      (4, 2, 64)])
def test_kernels_match_plain_and_count_launches(gen, H, Hkv, hd):
    kernels.reset_launch_counts()
    B, S = 2, 200                                   # S not a tile multiple
    q, k, v = _rn(gen, B, H, S, hd), _rn(gen, B, Hkv, S, hd), \
        _rn(gen, B, Hkv, S, hd)
    for window in (0, 48):
        _close(flash_attention(q, k, v, window=window),
               mha_reference(q, k, v, window=window))
    pos = torch.tensor([0, 199], dtype=torch.int32, device="cuda")
    qd = q[:, :, 0].contiguous()
    _close(decode_attention(qd, k, v, pos), decode_reference(qd, k, v, pos))
    page, P = 16, 13
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    table = torch.randperm(B * P, generator=gen, device="cuda") + 1
    table = table.reshape(B, P).to(torch.int32)
    table[0, 1:] = 0                                # row 0: one live page
    _close(paged_decode_attention(qd, kp, vp, table, pos),
           paged_decode_reference(qd, kp, vp, table, pos))
    torch.cuda.synchronize()
    assert (flash_attention.launches, decode_attention.launches,
            paged_decode_attention.launches) == (2, 1, 1)


def test_paged_kernel_never_reads_the_park_page(gen):
    B, H, Hkv, P, page, hd = 2, 8, 2, 4, 16, 64
    q = _rn(gen, B, H, hd)
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    table = (torch.arange(B * P, device="cuda") + 1).reshape(B, P)
    table = table.to(torch.int32)
    table[:, 2:] = 0
    pos = torch.tensor([20, 31], dtype=torch.int32, device="cuda")
    base = paged_decode_attention(q, kp, vp, table, pos)
    kp[0], vp[0] = float("nan"), float("nan")       # poison the park page
    out = paged_decode_attention(q, kp, vp, table, pos)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


@pytest.mark.parametrize("hd,G,S,window", [
    (32, 1, 1, 0), (64, 8, 200, 0), (64, 16, 333, 48), (128, 4, 257, 200),
    (128, 2, 300, 0), (256, 2, 190, 0), (32, 4, 129, 300), (48, 3, 77, 0),
    (80, 16, 150, 40)])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_kernel_over_its_domain(gen, hd, G, S, window, layout):
    """Every instantiated head width (48 and 80 run padded), groups up to
    16, S of 1 and ragged, windows narrower and wider than the 128-key
    tile, and the model's transposed (B, S, H, hd) views, which the kernel
    reads in place."""
    B, Hkv = 2, 2
    H = G * Hkv
    if layout == "bshd":
        q = _rn(gen, B, S, H, hd).transpose(1, 2)
        k, v = (_rn(gen, B, S, Hkv, hd).transpose(1, 2) for _ in range(2))
    else:
        q, k, v = (_rn(gen, B, H, S, hd), _rn(gen, B, Hkv, S, hd),
                   _rn(gen, B, Hkv, S, hd))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert got.shape == (B, H, S, hd)
    _close(got, mha_reference(q, k, v, window=window))
    assert flash_attention.launches == 1
    width = min(w for w in (32, 64, 128, 256) if w >= hd)
    assert flash_attention.launches_by_shape == {
        (B, H, Hkv, S, width, window): 1}


@pytest.mark.parametrize("scale", [0.0, -0.25, 2.0])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_takes_any_scale_and_mask(gen, scale, causal):
    """Scores are scaled before they are masked, so a zero or negative
    scale is as exact as the usual 1/sqrt(hd); without the causal mask
    every key up to S (within the window) counts."""
    q, k, v = _rn(gen, 1, 8, 150, 64), _rn(gen, 1, 2, 150, 64), \
        _rn(gen, 1, 2, 150, 64)
    for window in (0, 40):
        _close(flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale),
               mha_reference(q, k, v, causal=causal, window=window,
                             scale=scale))


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = torch.zeros(1, 4, 8, 64, device="cuda")      # float32
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q, q)
    qb = torch.randn(1, 4, 8, 64, device="cuda").to(torch.bfloat16)
    # head_dim 48 is no longer refused: it runs padded to 64
    _close(flash_attention(qb[..., :48], qb[..., :48], qb[..., :48]),
           mha_reference(qb[..., :48], qb[..., :48], qb[..., :48]))
    # a group of 12 is no longer refused: it runs padded to 16
    kv = torch.randn(1, 4, 8, 64, device="cuda").to(torch.bfloat16)
    qd = torch.randn(1, 48, 64, device="cuda").to(torch.bfloat16)
    _close(decode_attention(qd, kv, kv, 3), decode_reference(qd, kv, kv, 3))
    with pytest.raises(ValueError, match="head_dim up to 256"):
        decode_attention(torch.zeros(1, 4, 300, dtype=torch.bfloat16,
                                     device="cuda"),
                         torch.zeros(1, 4, 8, 300, dtype=torch.bfloat16,
                                     device="cuda"),
                         torch.zeros(1, 4, 8, 300, dtype=torch.bfloat16,
                                     device="cuda"), 3)


# ---------------------------------------------------------------------------
# verify (chunked prefill) and the int8 page pool
# ---------------------------------------------------------------------------

def _int8_pool(gen, NP, Hkv, page, hd):
    """Random int8 codes and their (NP, Hkv, page) f32 scales."""
    codes = torch.randint(-127, 128, (NP, Hkv, page, hd), generator=gen,
                          device="cuda", dtype=torch.int8)
    scale = torch.rand((NP, Hkv, page), generator=gen, device="cuda") / 64
    return codes, scale


def _tables(gen, B, P, page, pos, Kb=0):
    """(B, P) tables over B*P+1 pages in shuffled order; entries whose
    first position lies at or past ``pos + Kb`` park on page 0."""
    ids = (torch.randperm(B * P, generator=gen, device="cuda") + 1)
    ids = ids.reshape(B, P).to(torch.int32)
    first = torch.arange(P, device="cuda")[None, :] * page
    return torch.where(first >= pos[:, None] + max(Kb, 1),
                       torch.zeros_like(ids), ids).contiguous()


def _tree(gen, B, Kb):
    """Random ancestor bitmasks: node i sees itself and a random subset of
    the nodes before it."""
    bits = torch.randint(0, 1 << 30, (B, Kb), generator=gen, device="cuda",
                         dtype=torch.int32)
    i = torch.arange(Kb, device="cuda", dtype=torch.int32)
    below = (torch.ones_like(i) << i) - 1
    return ((bits & below) | (torch.ones_like(i) << i)).contiguous()


@pytest.mark.parametrize("page", [16, 256])
@pytest.mark.parametrize("hd", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("Kb", [1, 29, 128])
def test_verify_and_int8_kernels_match_plain(gen, hd, G, Kb, page):
    """Row verify, paged verify (bf16 and int8 pools, causal and, for
    Kb <= 31, a tree mask) and int8 paged decode, each against its plain
    version on the same CUDA tensors, over the verify kernels' whole
    domain: every instantiated width (48 runs padded), groups that do and
    do not divide the 128-row tile, blocks that end mid-tile, pages
    shorter and longer than a key tile.  Rows at pos 0 (the block alone)
    and at 300 (full key tiles, then one that ends mid-tile, mid-page).
    Each body counts its own launches."""
    kernels.reset_launch_counts()
    B, Hkv = 2, 2
    P = -(-(300 + Kb) // page)
    H, S = G * Hkv, P * page
    pos = torch.tensor([0, 300], dtype=torch.int32, device="cuda")
    q = _rn(gen, B, Kb, H, hd)
    bk, bv = _rn(gen, B, Kb, Hkv, hd), _rn(gen, B, Kb, Hkv, hd)
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    _close(verify_attention(q, k, v, bk, bv, pos),
           verify_reference(q, k, v, bk, bv, pos))
    table = _tables(gen, B, P, page, pos)
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    kq, ks = _int8_pool(gen, B * P + 1, Hkv, page, hd)
    vq, vs = _int8_pool(gen, B * P + 1, Hkv, page, hd)
    trees = [None] + ([_tree(gen, B, Kb)] if Kb <= kernels.MAX_TREE else [])
    for tree in trees:
        _close(verify_attention(q, k, v, bk, bv, pos, tree=tree),
               verify_reference(q, k, v, bk, bv, pos, tree=tree))
        _close(paged_verify_attention(q, kp, vp, bk, bv, table, pos,
                                      tree=tree),
               paged_verify_reference(q, kp, vp, bk, bv, table, pos,
                                      tree=tree))
        i8 = dict(k_scale=ks, v_scale=vs, tree=tree)
        _close(paged_verify_attention(q, kq, vq, bk, bv, table, pos, **i8),
               paged_verify_reference(q, kq, vq, bk, bv, table, pos, **i8))
    qd = q[:, 0].contiguous()
    _close(paged_decode_attention(qd, kq, vq, table, pos, k_scale=ks,
                                  v_scale=vs),
           paged_decode_reference(qd, kq, vq, table, pos, k_scale=ks,
                                  v_scale=vs))
    torch.cuda.synchronize()
    n = len(trees)
    assert (verify_attention.launches, paged_verify_attention.launches,
            paged_verify_attention.launches_int8,
            paged_verify_attention.launches_tree,
            paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (1 + n, 1, 1,
                                                      2 * (n - 1), 0, 1)


@pytest.mark.parametrize("page", [12, 16, 256])
@pytest.mark.parametrize("hd,G", [(64, 8), (128, 4), (32, 3)])
def test_paged_verify_equals_row_verify_bitwise(gen, page, hd, G):
    """A page pool holding the row cache's keys, page by page in shuffled
    order, gives the row verify's output bit for bit: both run the same
    body over the same keys in the same order (the pool's full tiles by
    TMA a page at a time, or, at a page of 12 rows, copied by the
    producer), causal and under a tree mask."""
    B, Hkv, Kb = 2, 2, 24
    H = G * Hkv
    P = -(-(700 + Kb) // page)
    S = P * page
    pos = torch.tensor([700, 129], dtype=torch.int32, device="cuda")
    q = _rn(gen, B, Kb, H, hd)
    bk, bv = _rn(gen, B, Kb, Hkv, hd), _rn(gen, B, Kb, Hkv, hd)
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    table = (torch.randperm(B * P, generator=gen, device="cuda") + 1)
    table = table.reshape(B, P).to(torch.int32)
    kp = torch.zeros(B * P + 1, Hkv, page, hd, dtype=torch.bfloat16,
                     device="cuda")
    vp = torch.zeros_like(kp)
    rows = k.reshape(B, Hkv, P, page, hd).permute(0, 2, 1, 3, 4)
    kp[table.long()] = rows
    vp[table.long()] = v.reshape(B, Hkv, P, page, hd).permute(0, 2, 1, 3, 4)
    for tree in (None, _tree(gen, B, Kb)):
        row = verify_attention(q, k, v, bk, bv, pos, tree=tree)
        paged = paged_verify_attention(q, kp, vp, bk, bv, table, pos,
                                       tree=tree)
        torch.cuda.synchronize()
        assert torch.equal(row, paged)
        _close(row, verify_reference(q, k, v, bk, bv, pos, tree=tree))


def test_verify_kernels_never_read_past_pos_or_the_park_page(gen):
    """NaN in the park page (its int8 scales too), in allocated pages and
    slots at or past ``pos`` and in row-cache slots at or past ``pos``
    changes nothing: the verify kernels read only the cache before the
    block, the int8 decode only positions up to ``pos``."""
    B, H, Hkv, P, page, hd, Kb = 2, 8, 2, 4, 16, 64, 5
    q = _rn(gen, B, Kb, H, hd)
    bk, bv = _rn(gen, B, Kb, Hkv, hd), _rn(gen, B, Kb, Hkv, hd)
    pos = torch.tensor([20, 0], dtype=torch.int32, device="cuda")
    table = (torch.randperm(B * P, generator=gen, device="cuda") + 1)
    table = table.reshape(B, P).to(torch.int32)
    table[1, 2:] = 0                                # dead entries: park
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    kq, ks = _int8_pool(gen, B * P + 1, Hkv, page, hd)
    vq, vs = _int8_pool(gen, B * P + 1, Hkv, page, hd)
    k, v = _rn(gen, B, Hkv, P * page, hd), _rn(gen, B, Hkv, P * page, hd)
    i8 = dict(k_scale=ks, v_scale=vs)

    def run():
        return (paged_verify_attention(q, kp, vp, bk, bv, table, pos),
                paged_verify_attention(q, kq, vq, bk, bv, table, pos, **i8),
                paged_decode_attention(q[:, 0].contiguous(), kq, vq, table,
                                       pos, **i8),
                verify_attention(q, k, v, bk, bv, pos))

    base = run()
    nan = float("nan")
    t = table.tolist()
    for pid in [0, t[0][2], t[0][3], t[1][1]]:      # never read at all
        kp[pid], vp[pid], ks[pid], vs[pid] = nan, nan, nan, nan
    for pool in (kp, vp):                           # row 0: slots 21..31
        pool[t[0][1], :, 5:] = nan                  # of its second page
    for sc in (ks, vs):
        sc[t[0][1], :, 5:] = nan
    kp[t[0][1], :, 4], vp[t[0][1], :, 4] = nan, nan  # verify: slot 20 too
    k[0, :, 20:], v[0, :, 20:] = nan, nan
    k[1], v[1] = nan, nan
    got = run()
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_verify_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    B, Hkv, hd, page, P = 1, 2, 64, 16, 2
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    table = torch.ones(1, P, dtype=torch.int32, device="cuda")
    kp = torch.zeros(3, Hkv, page, hd, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(B, Hkv, P * page, hd, dtype=torch.bfloat16,
                    device="cuda")

    def blk(Kb, H=8, d=hd):
        return (torch.zeros(B, Kb, H, d, dtype=torch.bfloat16,
                            device="cuda"),
                torch.zeros(B, Kb, Hkv, d, dtype=torch.bfloat16,
                            device="cuda"))

    q, bk = blk(32)
    tree = torch.ones(B, 32, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="tree"):       # K > 31 with a tree
        verify_attention(q, k, k, bk, bk, pos, tree=tree)
    with pytest.raises(ValueError, match="tree"):
        paged_verify_attention(q, kp, kp, bk, bk, table, pos, tree=tree)
    # a group of 3 and head_dim 48 are no longer refused: any group runs,
    # and 48 runs padded to 64
    q = torch.randn(B, 4, 6, hd, device="cuda").to(torch.bfloat16)
    bk = torch.randn(B, 4, Hkv, hd, device="cuda").to(torch.bfloat16)
    kr = torch.randn(B, Hkv, P * page, hd, device="cuda").to(torch.bfloat16)
    pool = torch.randn(3, Hkv, page, hd, device="cuda").to(torch.bfloat16)
    _close(verify_attention(q, kr, kr, bk, bk, pos + 5),
           verify_reference(q, kr, kr, bk, bk, pos + 5))
    q, bk, pool = q[..., :48], bk[..., :48], pool[..., :48]
    _close(paged_verify_attention(q, pool, pool, bk, bk, table, pos + 5),
           paged_verify_reference(q, pool, pool, bk, bk, table, pos + 5))
    q, bk = blk(4, d=300)                               # head dim 300
    with pytest.raises(ValueError, match="head_dim up to 256"):
        verify_attention(q, torch.zeros(B, Hkv, 32, 300, device="cuda",
                                        dtype=torch.bfloat16),
                         torch.zeros(B, Hkv, 32, 300, device="cuda",
                                     dtype=torch.bfloat16), bk, bk, pos)
    q, bk = blk(4)
    with pytest.raises(TypeError, match="float32"):     # int8 pool, scales
        paged_verify_attention(q, kp.to(torch.int8), kp.to(torch.int8), bk,
                               bk, table, pos,
                               k_scale=torch.zeros(3, Hkv, page,
                                                   device="cuda",
                                                   dtype=torch.float16),
                               v_scale=torch.zeros(3, Hkv, page,
                                                   device="cuda",
                                                   dtype=torch.float16))
    with pytest.raises(TypeError, match="int8"):        # bf16 codes + scales
        paged_decode_attention(q[:, 0].contiguous(), kp, kp, table, pos,
                               k_scale=torch.zeros(3, Hkv, page,
                                                   device="cuda"),
                               v_scale=torch.zeros(3, Hkv, page,
                                                   device="cuda"))
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention(q[:, 0].contiguous(), kp, kp, table, pos,
                               k_scale=torch.zeros(3, Hkv, page,
                                                   device="cuda"))


# groups past the old 1/2/4/8 and widths past 32/64/128: groups padded
# with zero heads to 4, 8 or 16 (20 in two launches, 16 + 4), widths padded
# with zero columns (48, 96), 256 instantiated; starcoder2-7b's (9, 128)
# and qwen3-moe-235b-a22b's (16, 128) attention among them
WIDE_HEADS = [(3, 64), (9, 128), (16, 128), (12, 48), (20, 96), (16, 256),
              (8, 256), (1, 256), (5, 32)]


def _decode_case(gen, G, hd):
    B, Hkv, page, P = 2, 2, 16, 5
    pos = torch.tensor([3, 70], dtype=torch.int32, device="cuda")
    q = _rn(gen, B, G * Hkv, hd)
    k, v = _rn(gen, B, Hkv, P * page, hd), _rn(gen, B, Hkv, P * page, hd)
    table = _tables(gen, B, P, page, pos)
    return q, k, v, table, pos, B * P + 1, Hkv, page


@pytest.mark.parametrize("G,hd", WIDE_HEADS)
def test_decode_kernel_takes_any_group_and_width(gen, G, hd):
    """Row decode, full and ring, against its plain version; one launch
    per 16 query heads of a kv head."""
    kernels.reset_launch_counts()
    q, k, v, _, pos, _, _, _ = _decode_case(gen, G, hd)
    _close(decode_attention(q, k, v, pos), decode_reference(q, k, v, pos))
    _close(decode_attention(q, k, v, pos, ring=True),
           decode_reference(q, k, v, pos))
    torch.cuda.synchronize()
    n = -(-G // 16)
    assert (decode_attention.launches,
            decode_attention.launches_ring) == (n, n)


@pytest.mark.parametrize("G,hd", WIDE_HEADS)
def test_paged_decode_kernels_take_any_group_and_width(gen, G, hd):
    """Paged decode over a bf16 and an int8 pool against its plain
    version."""
    kernels.reset_launch_counts()
    q, _, _, table, pos, NP, Hkv, page = _decode_case(gen, G, hd)
    kp, vp = _rn(gen, NP, Hkv, page, hd), _rn(gen, NP, Hkv, page, hd)
    (kq, ks), (vq, vs) = (_int8_pool(gen, NP, Hkv, page, hd)
                          for _ in range(2))
    i8 = dict(k_scale=ks, v_scale=vs)
    _close(paged_decode_attention(q, kp, vp, table, pos),
           paged_decode_reference(q, kp, vp, table, pos))
    _close(paged_decode_attention(q, kq, vq, table, pos, **i8),
           paged_decode_reference(q, kq, vq, table, pos, **i8))
    torch.cuda.synchronize()
    n = -(-G // 16)
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (n, n)


# (splits, page, P): a capacity of P * page keys for which the wrappers
# split each (row, kv head)'s keys over ``splits`` blocks
# (``kernels.decode_splits``); 176, 352, 592 and 1120 keys are not tile
# multiples
SPLIT_CASES = [(1, 16, 11), (2, 16, 22), (4, 16, 37), (8, 16, 70),
               (2, 256, 1), (4, 256, 3), (8, 256, 5)]


def _boundary_positions(B, cap, splits):
    """pos 0 and cap - 1, and one key each side of every split boundary
    (the row's last key one before, at and one past a run's first key),
    cycled over B rows; the rows at small positions leave their later
    splits empty."""
    cuts = [lo for lo, _ in kernels.decode_runs(cap, splits)[1:]]
    pos = [0, cap - 1] + [p for c in cuts for p in (c - 2, c - 1, c)]
    return torch.tensor((pos * B)[:B], dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("splits,page,P", SPLIT_CASES)
@pytest.mark.parametrize("hd,G", [(64, 8), (128, 4)])
def test_decode_split_over_a_cluster_matches_plain(gen, splits, page, P, hd,
                                                   G):
    """Row (full and ring), paged bf16 and paged int8 decode at each split
    the wrappers can choose (``SPLIT_CASES``), pos at 0, at cap - 1 and at
    each split boundary +- 1, over 24 rows.  Slots past pos and the park
    page hold NaN: never read.  One launch a call, and no call syncs with
    the host."""
    B, Hkv = 24, 2
    cap = P * page
    assert kernels.decode_splits(cap) == splits
    pos = _boundary_positions(B, cap, splits)
    q = _rn(gen, B, G * Hkv, hd)
    k, v = _rn(gen, B, Hkv, cap, hd), _rn(gen, B, Hkv, cap, hd)
    table = _tables(gen, B, P, page, pos)
    NP = B * P + 1
    kp, vp = _rn(gen, NP, Hkv, page, hd), _rn(gen, NP, Hkv, page, hd)
    (kq, ks), (vq, vs) = (_int8_pool(gen, NP, Hkv, page, hd)
                          for _ in range(2))
    i8 = dict(k_scale=ks, v_scale=vs)
    want = (decode_reference(q, k, v, pos),
            paged_decode_reference(q, kp, vp, table, pos),
            paged_decode_reference(q, kq, vq, table, pos, **i8))
    past = (torch.arange(cap, device="cuda")[None, None, :, None]
            > pos[:, None, None, None])
    k, v = (torch.where(past, float("nan"), t.float()).to(t.dtype)
            for t in (k, v))
    flat = torch.arange(P * page, device="cuda").reshape(1, P, page)
    slot_past = flat > pos[:, None, None]                   # (B, P, page)
    for pool in (kp, vp):
        pool[table.long()] = torch.where(
            slot_past[:, :, None, :, None], float("nan"),
            pool[table.long()].float()).to(pool.dtype)
        pool[0] = float("nan")                              # the park page
    for scale in (ks, vs):
        scale[table.long()] = torch.where(
            slot_past[:, :, None, :], float("nan"), scale[table.long()])
        scale[0] = float("nan")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (decode_attention(q, k, v, pos),
               decode_attention(q, k, v, pos, ring=True),
               paged_decode_attention(q, kp, vp, table, pos),
               paged_decode_attention(q, kq, vq, table, pos, **i8))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for g, w in zip(got, (want[0],) + want):
        assert torch.isfinite(g).all()
        _close(g, w)
    assert (decode_attention.launches, decode_attention.launches_ring,
            paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (1, 1, 1, 1)


@pytest.mark.parametrize("page", [1, 12, 16, 256])
@pytest.mark.parametrize("hd,G", [(64, 8), (128, 4), (32, 3)])
def test_paged_decode_equals_row_decode_bitwise(gen, page, hd, G):
    """A bf16 page pool holding the row cache's keys, page by page in
    shuffled order, gives the row decode's output bit for bit: both split
    the same keys over the same cluster and fold them in the same order
    (a page of 12 keys straddles the 64-key tiles; at a page of one key a
    block's run holds more page ids than it stages, so it reads them from
    the table)."""
    B, Hkv = 4, 2
    P = -(-1100 // page)
    S = P * page
    pos = torch.tensor([1099, 0, 63, 700], dtype=torch.int32, device="cuda")
    q = _rn(gen, B, G * Hkv, hd)
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    table = (torch.randperm(B * P, generator=gen, device="cuda") + 1)
    table = table.reshape(B, P).to(torch.int32)
    kp = torch.zeros(B * P + 1, Hkv, page, hd, dtype=torch.bfloat16,
                     device="cuda")
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.reshape(B, Hkv, P, page, hd).permute(0, 2, 1, 3, 4)
    vp[table.long()] = v.reshape(B, Hkv, P, page, hd).permute(0, 2, 1, 3, 4)
    row = decode_attention(q, k, v, pos)
    paged = paged_decode_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    assert torch.equal(row, paged)
    _close(row, decode_reference(q, k, v, pos))


@pytest.mark.parametrize("S", [176, 768, 4096])
def test_decode_row_does_not_depend_on_its_batch(gen, S):
    """Each row of a batch of 8, decoded alone (a batch of one) and in a
    batch of 3, row and paged, gives the batch of 8's output bit for bit:
    the split follows the capacity, never B."""
    B, Hkv, G, hd, page = 8, 4, 8, 64, 16
    P = S // page
    pos = torch.tensor([0, 5, S // 3, S // 2, S - 2, S - 1, 63, 64],
                       dtype=torch.int32, device="cuda")
    q = _rn(gen, B, G * Hkv, hd)
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    table = _tables(gen, B, P, page, pos)
    kp, vp = (_rn(gen, B * P + 1, Hkv, page, hd) for _ in range(2))
    row = decode_attention(q, k, v, pos)
    paged = paged_decode_attention(q, kp, vp, table, pos)
    for sl in [slice(b, b + 1) for b in range(B)] + [slice(2, 5)]:
        qs, ks, vs, ts, ps = (t[sl].clone() for t in (q, k, v, table, pos))
        assert torch.equal(decode_attention(qs, ks, vs, ps), row[sl])
        assert torch.equal(paged_decode_attention(qs, kp, vp, ts, ps),
                           paged[sl])


@pytest.mark.parametrize("G,hd", WIDE_HEADS)
def test_partial_kernels_take_any_group_and_width(gen, G, hd):
    """One shard's partial, bf16 and int8, for each half of the bank as a
    shard, against its plain version: acc, m and l."""
    kernels.reset_launch_counts()
    q, _, _, table, pos, NP, Hkv, page = _decode_case(gen, G, hd)
    kp, vp = _rn(gen, NP, Hkv, page, hd), _rn(gen, NP, Hkv, page, hd)
    (kq, ks), (vq, vs) = (_int8_pool(gen, NP, Hkv, page, hd)
                          for _ in range(2))
    for base, sl in ((0, slice(0, NP // 2)), (NP // 2, slice(NP // 2, NP))):
        for pool, sc in (((kp, vp), {}),
                         ((kq, vq), dict(k_scale=ks, v_scale=vs))):
            loc = {n: t[sl].contiguous() for n, t in sc.items()}
            kl, vl = (t[sl].contiguous() for t in pool)
            _partial_close(
                paged_decode_partial(q, kl, vl, table, pos, base, **loc),
                paged_decode_partial_reference(q, kl, vl, table, pos, base,
                                               **loc))
    torch.cuda.synchronize()
    n = -(-G // 16)
    assert (paged_decode_partial.launches,
            paged_decode_partial.launches_int8) == (2 * n, 2 * n)


# ---------------------------------------------------------------------------
# sliding-window rings and the selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("Kb", [5, 64])
def test_ring_decode_and_verify_kernels_match_plain(gen, Kb, G, hd):
    """Every instantiated width (48 padded) and groups that do and do not
    divide the verify tile, a ring of S = 160 slots (full key tiles and a
    partial one), rows at pos 0, S-1 (the verify block wraps), S and
    2S+3.  Ring slots not yet written (pos < S) hold NaN: the kernels
    never read them.  The ring routes count apart from the full-cache
    routes."""
    kernels.reset_launch_counts()
    B, Hkv, S = 4, 2, 160
    H = G * Hkv
    pos = torch.tensor([0, S - 1, S, 2 * S + 3], dtype=torch.int32,
                       device="cuda")
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    qd = _rn(gen, B, H, hd)
    q = _rn(gen, B, Kb, H, hd)
    bk, bv = _rn(gen, B, Kb, Hkv, hd), _rn(gen, B, Kb, Hkv, hd)
    want_d = decode_reference(qd, k, v, pos)
    want_v = verify_reference(q, k, v, bk, bv, pos, ring=True)
    slot = torch.arange(S, device="cuda")[None, None, :, None]
    p = pos[:, None, None, None]
    nan = float("nan")
    kd = torch.where((slot > p) & (p < S), nan, k.float()).to(k.dtype)
    vd = torch.where((slot > p) & (p < S), nan, v.float()).to(v.dtype)
    kv_ = torch.where((slot >= p) & (p < S), nan, k.float()).to(k.dtype)
    vv_ = torch.where((slot >= p) & (p < S), nan, v.float()).to(v.dtype)
    got_d = decode_attention(qd, kd, vd, pos, ring=True)
    got_v = verify_attention(q, kv_, vv_, bk, bv, pos, ring=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got_d).all() and torch.isfinite(got_v).all()
    _close(got_d, want_d)
    _close(got_v, want_v)
    assert (decode_attention.launches_ring, decode_attention.launches,
            verify_attention.launches_ring,
            verify_attention.launches) == (1, 0, 1, 0)
    with pytest.raises(ValueError, match="ring"):
        verify_attention(q, k[:, :, :4].contiguous(), v[:, :, :4]
                         .contiguous(), bk, bv, pos, ring=True)


@pytest.mark.parametrize("d_in", [200, 256, 8192])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("L", [1, 7, 32, 33, 96, 512])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_ssm_scan_kernel_matches_plain(gen, d_in, N, L, init, B):
    """The f32 selective scan against its plain sequential version on
    the same CUDA tensors: y and the final state, from a zero or a
    carried state, d_in a multiple of the block or not, one or two rows,
    one time tile (ragged or whole), two (the second of one step) and
    three or more."""
    kernels.reset_launch_counts()

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, Bm, Cm = rn(B, L, d_in), rn(B, L, N), rn(B, L, N)
    dt = torch.nn.functional.softplus(rn(B, L, d_in) - 2.0)
    A = -torch.exp(rn(d_in, N) * 0.5)
    D = rn(d_in)
    s0 = rn(B, d_in, N) if init else None
    y, s = ssm_scan(u, dt, Bm, Cm, A, D, s0)
    wy, ws = selective_scan_reference(u, dt, Bm, Cm, A, D, s0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == 1
    for got, want in ((y, wy), (s, ws)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    with pytest.raises(ValueError, match="N up to 64"):
        ssm_scan(u, dt, torch.zeros(B, L, 65, device="cuda"),
                 torch.zeros(B, L, 65, device="cuda"),
                 torch.zeros(d_in, 65, device="cuda"), D)


@pytest.mark.parametrize("N", [4, 12, 24, 32, 40, 64])
@pytest.mark.parametrize("init", [False, True])
def test_ssm_scan_kernel_takes_any_state_size(gen, N, init):
    """State sizes past the old 8 and 16: 32 and 64 instantiated, 4, 12,
    24 and 40 zero-padded to the next; y and the final state against the
    plain version, at jamba-v0.1-52b's d_in."""
    kernels.reset_launch_counts()
    B, L, d_in = 2, 40, 8192

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, Bm, Cm = rn(B, L, d_in), rn(B, L, N), rn(B, L, N)
    dt = torch.nn.functional.softplus(rn(B, L, d_in) - 2.0)
    A = -torch.exp(rn(d_in, N) * 0.5)
    D = rn(d_in)
    s0 = rn(B, d_in, N) if init else None
    y, s = ssm_scan(u, dt, Bm, Cm, A, D, s0)
    wy, ws = selective_scan_reference(u, dt, Bm, Cm, A, D, s0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == 1
    for got, want in ((y, wy), (s, ws)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dh", [64, 384])
@pytest.mark.parametrize("L,chunk", [(64, 16), (256, 128), (512, 256),
                                     (384, 256), (200, 256), (256, 256),
                                     (768, 256), (1280, 256), (100, 64)])
@pytest.mark.parametrize("B", [1, 2])
def test_mlstm_chunk_kernel_matches_plain(gen, dh, L, chunk, B):
    """The f32 chunkwise mLSTM against its plain version on the same CUDA
    tensors (f32 products, no TF32): h and the final (C, n, m), one or
    two rows.  One chunk (L = 256), two, three (L = 768, and L = 384,
    which shrinks a 256 chunk to 128), five and 25 (L = 100 shrinks a 64
    chunk to 4); L = 200 makes one ragged chunk of 200, whose last query
    and key tile hold 8 rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launch_counts()
    H = 2

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh)
    li = rn(B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(rn(B, H, L) + 1.0)
    h, fin = mlstm_chunk(q, k, v, li, lf, chunk=chunk)
    c = min(chunk, L)
    while L % c:
        c //= 2
    wh, wfin = mlstm_chunk_reference(q, k, v, li, lf, c)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == 1
    pairs = [(h, wh, 5e-4)] + list(zip(fin, wfin, (5e-4, 5e-4, 1e-5)))
    for got, want, tol in pairs:
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(
            got, want, rtol=0, atol=tol * max(1.0, float(want.abs().max())))
    with pytest.raises(ValueError, match="dh up to 512"):
        mlstm_chunk(*(torch.zeros(1, 1, 8, 520, device="cuda")
                      for _ in range(3)), li[:1, :1, :8], lf[:1, :1, :8])


@pytest.mark.parametrize("B,H,L,chunk", [(1, 1, 256, 256), (1, 4, 768, 256),
                                         (2, 4, 512, 256), (8, 8, 512, 256),
                                         (4, 16, 400, 200), (3, 5, 960, 64)])
def test_mlstm_chunk_m_is_the_plain_versions_bit_for_bit(gen, B, H, L,
                                                          chunk):
    """The stabilizer m, held to 1e-5 where |g| passes 100 (a few ulp of
    g), is the plain version's bit for bit at every count of rows, on
    the card and on the CPU alike: the kernel sums g in the fixed order
    of ``chunk_cumsum``, which does not follow the tensor's shape or
    device as ``torch.cumsum``'s does.  L = 400 makes chunks of 200."""
    kernels.reset_launch_counts()
    q, k, v, li, lf = _mlstm_args(gen, B, H, L, 64)
    _, (_, _, m) = mlstm_chunk(q, k, v, li, lf, chunk=chunk)
    c = min(chunk, L)
    while L % c:
        c //= 2
    _, (_, _, want) = mlstm_chunk_reference(q, k, v, li, lf, c)
    _, (_, _, cpu) = mlstm_chunk_reference(
        *(t.cpu() for t in (q, k, v, li, lf)), c)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == 1
    assert torch.equal(m, want) and torch.equal(m.cpu(), cpu)


def test_mlstm_chunk_kernel_in_spans(gen, monkeypatch):
    """With a state budget of one chunk, the kernel runs the chunks one
    span at a time, each span's first carried state the last one's
    final: h and the final (C, n, m) as the plain version's, as in one
    span."""
    from repro_torch.kernels.mlstm_chunk import ops as mops
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, L, dh, c = 2, 2, 768, 128, 256

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh)
    li = rn(B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(rn(B, H, L) + 1.0)
    whole = mlstm_chunk(q, k, v, li, lf, chunk=c)
    monkeypatch.setattr(mops, "STATE_BUDGET", 1)
    assert mops.chunk_span(B, H, L // c, dh) == 1
    h, fin = mlstm_chunk(q, k, v, li, lf, chunk=c)
    wh, wfin = mlstm_chunk_reference(q, k, v, li, lf, c)
    torch.cuda.synchronize()
    pairs = [(h, wh, 5e-4)] + list(zip(fin, wfin, (5e-4, 5e-4, 1e-5)))
    for got, want, tol in pairs:
        torch.testing.assert_close(
            got, want, rtol=0, atol=tol * max(1.0, float(want.abs().max())))
    for got, one in zip((h, *fin), (whole[0], *whole[1])):
        torch.testing.assert_close(got, one, rtol=0, atol=0)


def _scan_args(gen, B, L, d_in, N):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, Bm, Cm = rn(B, L, d_in), rn(B, L, N), rn(B, L, N)
    dt = torch.nn.functional.softplus(rn(B, L, d_in) - 2.0)
    return (u, dt, Bm, Cm, -torch.exp(rn(d_in, N) * 0.5), rn(d_in),
            rn(B, d_in, N))


def _mlstm_args(gen, B, H, L, dh):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    li = rn(B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(rn(B, H, L) + 1.0)
    return (rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh), li, lf)


@pytest.mark.parametrize("kernel", ["ssm_scan", "mlstm_chunk"])
def test_scan_kernels_sync_free_and_replay_in_a_graph(gen, kernel):
    """The scan (jamba's d_in and N, 2 rows of 100 steps from a carried
    state) and the mLSTM (xlstm-125m's heads, 1 row of 768 tokens, three
    chunks) launch with no host sync (``set_sync_debug_mode("error")``),
    and a CUDA graph that captures the call replays it bit for bit, twice:
    a graph of a whole step can capture them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if kernel == "ssm_scan":
        args = _scan_args(gen, 2, 100, 8192, 16)

        def call():
            return ssm_scan(*args)
    else:
        args = _mlstm_args(gen, 1, 4, 768, 384)

        def call():
            return mlstm_chunk(*args, chunk=256)
    want = call()                               # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()

    def flat(out):
        return [out[0], *out[1]] if kernel == "mlstm_chunk" else list(out)

    for _ in range(2):
        for t in flat(captured):
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, e, w in zip(flat(captured), flat(eager), flat(want)):
            assert torch.equal(got, e) and torch.equal(e, w)


@pytest.mark.parametrize("dh", [48, 96, 200])
def test_mlstm_chunk_kernel_takes_any_width(gen, dh):
    """Widths that are not a multiple of 64 run zero-padded to the next
    one, at their own scale 1/sqrt(dh): h and the final (C, n, m)
    against the plain version, two chunks of 128."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launch_counts()
    B, H, L = 2, 2, 256

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh)
    li = rn(B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(rn(B, H, L) + 1.0)
    h, fin = mlstm_chunk(q, k, v, li, lf, chunk=128)
    wh, wfin = mlstm_chunk_reference(q, k, v, li, lf, 128)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == 1
    pairs = [(h, wh, 5e-4)] + list(zip(fin, wfin, (5e-4, 5e-4, 1e-5)))
    for got, want, tol in pairs:
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(
            got, want, rtol=0, atol=tol * max(1.0, float(want.abs().max())))


# ---------------------------------------------------------------------------
# one shard's decode partial over a sharded bank (B5), the grouped matmul
# (B7)
# ---------------------------------------------------------------------------

def _partial_close(got, want):
    for g, w in zip(got, want):
        fin = w > -1e29                                  # m's empty rows
        scale = max(1.0, float(w[fin].abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("hd,G", [(64, 8), (128, 4), (32, 1)])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_partial_kernel_matches_plain(gen, hd, G, quantized):
    """Every shard's partial over its slice of a 4-shard bank: rows that
    span shards, a row that lives on one shard (the others own nothing
    of it), a position at a page boundary; the local park page poisoned
    with NaN changes nothing (never read)."""
    kernels.reset_launch_counts()
    B, Hkv, page, P, nsh, Lp = 4, 2, 32, 4, 4, 5
    H = G * Hkv
    NP = nsh * Lp
    q = _rn(gen, B, H, hd)
    if quantized:
        (kp, ks), (vp, vs) = (_int8_pool(gen, NP, Hkv, page, hd)
                              for _ in range(2))
    else:
        kp, vp = _rn(gen, NP, Hkv, page, hd), _rn(gen, NP, Hkv, page, hd)
    table = torch.tensor([[1, 6, 11, 16], [7, 8, 9, 0], [12, 17, 2, 0],
                          [13, 14, 0, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([127, 70, 64, 40], dtype=torch.int32, device="cuda")
    for shard in range(nsh):
        sl = slice(shard * Lp, (shard + 1) * Lp)
        kl, vl = kp[sl].clone(), vp[sl].clone()
        sc = {} if not quantized else dict(k_scale=ks[sl].contiguous(),
                                           v_scale=vs[sl].contiguous())
        want = paged_decode_partial_reference(q, kl, vl, table, pos,
                                              shard * Lp, **sc)
        if not quantized:
            kl[0], vl[0] = float("nan"), float("nan")    # local park page
        got = paged_decode_partial(q, kl, vl, table, pos, shard * Lp, **sc)
        torch.cuda.synchronize()
        _partial_close(got, want)
        if shard != 1:                       # row 1 lives on shard 1 only
            acc, m, l = (t[1] for t in got)
            assert torch.equal(acc, torch.zeros_like(acc))
            assert torch.equal(l, torch.zeros_like(l))
            assert torch.equal(m, torch.full_like(m, -1e30))
    n = (paged_decode_partial.launches_int8 if quantized
         else paged_decode_partial.launches)
    assert n == nsh


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page,P", [(16, 37), (256, 5)])
@pytest.mark.parametrize("hd,G", [(64, 8), (128, 4), (32, 3)])
def test_shard_partials_merge_to_the_paged_decode_bitwise(gen, quantized,
                                                          page, P, hd, G):
    """A bank of 4 shards of 2P + 1 pages (local page 0 parks); rows 0-2
    live on shards 0-2, page order shuffled, row 3 spans all four.  Merged
    over the shards as the sharded decode merges them (pmax/psum, then
    the division), the partials give the global paged decode's output bit
    for bit in the rows on one shard: the same body over the same runs of
    keys, the other shards adding exact zeros.  The spanning row is held
    to the plain version."""
    B, Hkv, nsh, Lp = 4, 2, 4, 2 * P + 1
    cap, NP = P * page, nsh * Lp
    pos = torch.tensor([cap - 1, 0, cap // 2 + 1, cap - 2],
                       dtype=torch.int32, device="cuda")
    q = _rn(gen, B, G * Hkv, hd)
    if quantized:
        (kp, ks), (vp, vs) = (_int8_pool(gen, NP, Hkv, page, hd)
                              for _ in range(2))
    else:
        kp, vp = _rn(gen, NP, Hkv, page, hd), _rn(gen, NP, Hkv, page, hd)
    rows = [r * Lp + 1 + torch.randperm(P, generator=gen, device="cuda")
            for r in range(3)]
    rows.append(torch.tensor([(j % nsh) * Lp + P + 1 + j // nsh
                              for j in range(P)], device="cuda"))
    table = torch.stack(rows).to(torch.int32)
    first = torch.arange(P, device="cuda")[None, :] * page
    table = torch.where(first > pos[:, None], torch.zeros_like(table),
                        table).contiguous()
    sc = {} if not quantized else dict(k_scale=ks, v_scale=vs)
    whole = paged_decode_attention(q, kp, vp, table, pos, **sc)
    parts = []
    for shard in range(nsh):
        sl = slice(shard * Lp, (shard + 1) * Lp)
        loc = {n: t[sl].contiguous() for n, t in sc.items()}
        parts.append(paged_decode_partial(q, kp[sl].contiguous(),
                                          vp[sl].contiguous(), table, pos,
                                          shard * Lp, **loc))
    acc, _, l = _psum_partials(*zip(*parts))
    merged = (acc / torch.clamp(l, min=1e-30)[..., None])
    merged = merged.reshape(B, G * Hkv, hd).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(merged[:3], whole[:3])
    _close(merged[3:], paged_decode_reference(q, kp, vp, table, pos,
                                              **sc)[3:])


@pytest.mark.parametrize("E,C,D,F", [
    (2, 320, 256, 512), (3, 20, 64, 136), (1, 1, 32, 64), (2, 130, 136, 130),
    (1, 7, 13, 9), (2, 320, 14336, 4096), (2, 320, 4096, 1000),
    (2, 320, 512, 14336)])
def test_gmm_kernel_matches_plain(gen, E, C, D, F):
    """Ragged C (20, 130, 7, 1: rows past C load as zeros and are not
    stored), F not a multiple of the column tile (136, 1000), D and F that
    run padded to multiples of 8 (13, 9, 130), mixtral's down shape and
    its gate shape; the launch counts at the shape the kernel ran."""
    kernels.reset_launch_counts()
    x = _rn(gen, E, C, D)
    w = (torch.randn((E, D, F), generator=gen, device="cuda")
         / D ** 0.5).to(torch.bfloat16)
    got = gmm(x, w)
    torch.cuda.synchronize()
    want = gmm_reference(x, w)
    lim = 1e-4 + 2.0 ** -7 * want.float().abs()
    assert ((got.float() - want.float()).abs() <= lim).all()
    assert gmm.launches == 1
    assert gmm.launches_by_shape == {(E, C, -(-D // 8) * 8, -(-F // 8) * 8): 1}


def test_expert_mlp_kernels_match_plain(gen):
    """The expert FFN, three grouped matmuls with bf16 roundings between
    them, within the file's bf16 TOL of its plain version."""
    kernels.reset_launch_counts()
    E, C, D, F = 2, 320, 256, 512
    x = _rn(gen, E, C, D)
    wg, wu = ((torch.randn((E, D, F), generator=gen, device="cuda")
               / D ** 0.5).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn((E, F, D), generator=gen, device="cuda")
          / F ** 0.5).to(torch.bfloat16)
    got = expert_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    _close(got, expert_mlp_reference(x, wg, wu, wd))
    assert gmm.launches == 3


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.zeros(2, 8, 64, device="cuda")                 # float32
    with pytest.raises(TypeError, match="bfloat16"):
        gmm(x, torch.zeros(2, 64, 64, device="cuda"))
    xb = torch.randn(2, 8, 64, device="cuda").to(torch.bfloat16)
    wb = torch.randn(2, 48, 64, device="cuda").to(torch.bfloat16)
    # D = 48 is no longer refused (any D >= 1 is)
    got = gmm(xb[..., :48], wb)
    want = gmm_reference(xb[..., :48], wb)
    assert ((got.float() - want.float()).abs()
            <= 1e-4 + 2.0 ** -7 * want.float().abs()).all()
    pool = torch.zeros(4, 2, 16, 64, dtype=torch.bfloat16, device="cuda")
    table = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        paged_decode_partial(torch.zeros(2, 4, 64, device="cuda"), pool,
                             pool, table, 5, 0)
    # a group of 6 is no longer refused: it runs as one launch of 6 heads
    qp = torch.randn(2, 6, 64, device="cuda").to(torch.bfloat16)
    pool = torch.randn(4, 1, 16, 64, device="cuda").to(torch.bfloat16)
    table = torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32,
                         device="cuda")
    pos = torch.tensor([20, 10], dtype=torch.int32, device="cuda")
    _partial_close(paged_decode_partial(qp, pool, pool, table, pos, 0),
                   paged_decode_partial_reference(qp, pool, pool, table, pos,
                                                  0))


# ---------------------------------------------------------------------------
# the fused multi-step tick: one CUDA graph replay
# ---------------------------------------------------------------------------

ENGINES = {                     # (arch, config overrides, engine options)
    "row": ("tinyllama-1.1b", {}, {}),
    "paged": ("tinyllama-1.1b", {}, dict(paged=True, page_size=16)),
    "int8": ("tinyllama-1.1b", {},
             dict(paged=True, page_size=16, quantize_kv="int8")),
    "local_read": ("tinyllama-1.1b", {},
                   dict(paged=True, page_size=16, local_read=True)),
    "ring_moe": ("mixtral-8x7b", dict(sliding_window=16), {}),
    "hybrid": ("jamba-v0.1-52b", {}, {}),
    "xlstm": ("xlstm-125m", {}, {}),
}


def _reduced_lm(arch, cfg_kw):
    from repro_torch.configs import get_arch, override, reduced
    from repro_torch.models.model import build_model
    m = build_model(override(reduced(get_arch(arch)), **cfg_kw),
                    device="cuda")
    return m, m.init(seed=0)


def _step_engine(m, kind, multi_step, temperature=0.0):
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.serve.engine import StepEngine
    kw = dict(ENGINES[kind][2])
    if kw.pop("local_read", False):
        kw.update(local_read=True, mesh=make_mesh(
            (4,), ("model",), [torch.device("cuda", 0)] * 4))
    return StepEngine(m, batch_size=3, max_len=64, temperature=temperature,
                      seed=5, multi_step=multi_step, **kw)


def _fused_stream(eng, p, vocab):
    """A (3 tokens) and B (9) admitted at once, A retiring at device step
    2 (inside a fused tick of 4), C admitted at that boundary, all
    drained.  Seeded rows when the engine samples."""
    g = torch.Generator().manual_seed(1)

    def prompt(S):
        return torch.randint(0, vocab, (1, S), generator=g).numpy()

    seeds = [7, 9, 11] if eng.temperature > 0 else [None] * 3
    ga = eng.admit(p, prompt(8), max_new=3, seeds=seeds[:1])[0]
    gb = eng.admit(p, prompt(20), max_new=9, seeds=seeds[1:2])[0]
    while not ga.done:
        eng.step(p)
    gc = eng.admit(p, prompt(12), max_new=5, seeds=seeds[2:])[0]
    while eng.live_slots():
        eng.step(p)
    return [ga.tokens, gb.tokens, gc.tokens]


@pytest.mark.parametrize("kind,temperature", [
    *((k, 0.0) for k in ENGINES), ("row", 0.8), ("paged", 0.8)])
def test_fused_tick_replays_bitwise_single_steps(gen, kind, temperature):
    """Each fused tick is one replay of the engine's one captured graph
    and one readback, and its streams are bit for bit those of the eager
    single steps: dense row, paged, int8 and local reads over 4 logical
    shards, the ring and MoE, the Mamba hybrid and the xLSTM (A retires
    inside the first tick, so B's recurrent states cross two steps that
    do not commit)."""
    m, p = _reduced_lm(*ENGINES[kind][:2])
    one = _step_engine(m, kind, 1, temperature)
    want = _fused_stream(one, p, m.cfg.vocab_size)
    eng = _step_engine(m, kind, 4, temperature)
    assert _fused_stream(eng, p, m.cfg.vocab_size) == want
    assert eng.stats["device_steps"] == one.stats["device_steps"]
    assert eng.stats["host_ticks"] < one.stats["host_ticks"]
    assert eng.graph_captures == 1 and len(eng._graphs) == 1
    assert eng.sampler.snapshot() == one.sampler.snapshot()


def test_fused_tick_adds_its_captured_launches_on_every_replay(gen):
    """A replay calls no wrapper: the engine adds the capture's launches,
    the decode kernel's T per layer, on every replay (the warm-up before
    the capture launched them once more)."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention)
    m, p = _reduced_lm("tinyllama-1.1b", {})
    eng = _step_engine(m, "paged", 4)
    eng.admit(p, torch.randint(0, 256, (3, 10)).numpy(), max_new=13)
    per_tick = 4 * m.cfg.num_layers
    kernels.reset_launch_counts()
    eng.step(p)                                 # warm-up, capture, replay
    (g,) = eng._graphs.values()
    assert g.launches[(paged_decode_attention, "launches")] == per_tick
    assert paged_decode_attention.launches == 2 * per_tick
    for k in range(2):
        eng.step(p)
        assert paged_decode_attention.launches == (3 + k) * per_tick
    assert eng.stats["device_steps"] == 12 and eng.graph_captures == 1


def test_fused_engine_recaptures_when_the_weights_are_reloaded(gen):
    """A reloaded weight slot holds new buffers (``_copy_in``): the graph
    over the old ones is dropped, not kept alive by the engine, and the
    engine captures again; its streams follow the new weights."""
    import gc
    import weakref
    m, p = _reduced_lm("tinyllama-1.1b", {})
    other = m.init(seed=1)
    prompt = torch.randint(0, 256, (2, 10)).numpy()

    def run(eng, params):
        gens = eng.admit(params, prompt, max_new=9)
        while eng.live_slots():
            eng.step(params)
        return [g.tokens for g in gens]

    eng = _step_engine(m, "row", 4)
    first = run(eng, p)
    old = weakref.ref(p["embed"])
    del p                                       # the slot's old buffers
    gc.collect()
    assert old() is None                        # the graph did not hold them
    reloaded = _tree_clone(other)
    got = run(eng, reloaded)
    assert eng.graph_captures == 2 and len(eng._graphs) == 1
    assert got == run(_step_engine(m, "row", 1), other)
    assert first != got


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_fused_tick_body_is_sync_free(gen, kind):
    """The tick's body, run eagerly on the card with go = 0 (no step
    commits), makes no host sync (``set_sync_debug_mode("error")``), for
    every engine a graph captures."""
    m, p = _reduced_lm(*ENGINES[kind][:2])
    eng = _step_engine(m, kind, 4)
    eng.admit(p, torch.randint(0, 256, (3, 10)).numpy(), max_new=9)
    B = eng.batch_size
    inp = torch.zeros(5 * B + 1, dtype=torch.int32)
    inp[:B] = torch.from_numpy(eng.state.tok)
    inp[B:2 * B] = torch.from_numpy(eng.state.pos)
    inp[2 * B:3 * B] = 1
    inp[3 * B:4 * B] = 8
    inp[4 * B:5 * B] = 64
    inp = inp.cuda()
    eng._fused_tick(p, inp, None)               # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = eng._fused_tick(p, inp, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(res[-1]) == 0                    # go = 0: nothing committed


def test_dropped_engine_drops_its_graphs(gen):
    """Each tick graph keeps a private memory pool: an engine that the
    ``max_cached_pools`` LRU drops takes its graphs with it."""
    import gc
    import weakref
    from repro_torch.serve.engine import ServingEngine
    m, p = _reduced_lm("tinyllama-1.1b", {})
    se = ServingEngine(m, p, max_len=64)
    se.max_cached_pools = 1
    prompt = torch.randint(0, 256, (2, 10)).numpy()
    want = se.generate(prompt, 6)
    same = bool((se.generate_fused(prompt, 6) == want).all())
    (graph,) = se.step_engine(2, multi_step=5)._graphs.values()
    ref = weakref.ref(graph)
    del graph
    se.generate_fused(prompt, 8)       # another engine: the idle ones go
    gc.collect()
    assert same and ref() is None
    assert len(se._step_engines) == 1


# ---------------------------------------------------------------------------
# the prefix cache on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_copy_cache_pages_is_a_byte_copy_on_the_card(gen, quantized):
    """``LM.copy_cache_pages`` moves every leaf of every layer's pool bit
    for bit (bf16 k/v; int8 codes and their f32 scales) into the
    destination pages and leaves every other page as it was."""
    m, _ = _reduced_lm("tinyllama-1.1b", {})
    caches = m.init_page_pool(8, 16, quantized=quantized)
    for c in caches:
        for t in c:
            if t is None:
                continue
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    assert caches[0].k.dtype == (torch.int8 if quantized
                                 else torch.bfloat16)
    want = [[None if t is None else t.clone() for t in c] for c in caches]
    src, dst, rest = [1, 5, 2], [3, 6, 7], [0, 1, 2, 4, 5]
    m.copy_cache_pages(caches, src, dst)
    torch.cuda.synchronize()
    n = 0
    for c, w in zip(caches, want):
        for t, u in zip(c, w):
            if t is None:
                continue
            assert torch.equal(t[dst], u[src]) and torch.equal(t[rest],
                                                               u[rest])
            n += 1
    assert n == (4 if quantized else 2) * m.cfg.num_layers


def _prefix_traffic(vocab, n=3, head=32, tail=8):
    g = torch.Generator().manual_seed(3)
    pre = torch.randint(0, vocab, (1, head), generator=g)
    return [torch.cat([pre, torch.randint(0, vocab, (1, tail), generator=g)],
                      dim=1).numpy() for _ in range(n)]


@pytest.mark.parametrize("quantize_kv", [None, "int8"])
def test_chunked_hit_is_bitwise_the_cold_chunked_stream(gen, quantize_kv):
    """Chunked prefill with the chunk as wide as a page (16), prompts
    sharing a 2-page preamble: each hit resumes at a page boundary, so its
    final chunk is the cold admission's final chunk, over pages that the
    same chunk programs wrote.  The streams are bit for bit the cold
    ones, bf16 and int8."""
    from repro_torch.serve.engine import StepEngine
    m, p = _reduced_lm("tinyllama-1.1b", {})
    prompts = _prefix_traffic(m.cfg.vocab_size)

    def run(prefix_cache):
        eng = StepEngine(m, batch_size=3, max_len=64, paged=True,
                         page_size=16, prefill_chunk=16,
                         quantize_kv=quantize_kv, prefix_cache=prefix_cache)
        first = eng.admit(p, prompts[0], max_new=8)[0]
        while not first.tokens:                 # indexed once it is done
            eng.step(p)
        gens = [first] + [eng.admit(p, t, max_new=8)[0]
                          for t in prompts[1:]]
        while eng.live_slots():
            eng.step(p)
        return [g.tokens for g in gens], eng

    cold, _ = run(False)
    hit, eng = run(True)
    assert hit == cold
    assert (eng.stats["prefix_hits"], eng.stats["prefix_pages_mapped"],
            eng.stats["cow_copies"]) == (2, 4, 0)


def test_fused_engine_with_hits_is_bitwise_its_single_step_twin(gen):
    """A one-shot paged prefix engine fused (``multi_step=4``, one graph
    replay a tick) against its single-step twin: hits mapping shared
    pages, one of them copying its boundary page, give bit for bit the
    same streams, and the copies and table writes leave the captured
    graph valid (one capture)."""
    from repro_torch.serve.engine import StepEngine
    m, p = _reduced_lm("tinyllama-1.1b", {})
    prompts = _prefix_traffic(m.cfg.vocab_size)
    prompts.append(prompts[0][:, :32].copy())   # the bare preamble: a CoW

    def run(multi_step):
        eng = StepEngine(m, batch_size=3, max_len=64, paged=True,
                         page_size=16, prefix_cache=True,
                         multi_step=multi_step)
        gens = []
        for t in prompts:
            while not eng.can_admit(t, 6):
                eng.step(p)
            gens += eng.admit(p, t, max_new=6)
            eng.step(p)
        while eng.live_slots():
            eng.step(p)
        return [g.tokens for g in gens], eng

    want, one = run(1)
    got, eng = run(4)
    assert got == want
    assert eng.stats["prefix_hits"] == one.stats["prefix_hits"] == 3
    assert eng.stats["cow_copies"] == 1 and eng.graph_captures == 1


def test_shared_bank_under_fused_graphs_is_bitwise_single_step(gen):
    """Two fused prefix engines (batch 3 and 2, ``multi_step=4``) over one
    ``SharedBank``.  Between the first engine's graph replays the second
    maps pages the first indexed, copies a shared boundary page, resets
    with ``keep_prefix=True`` and hits again: the bank's tensors stay
    where both captured graphs read them.  Both streams are bit for bit
    their single-step twins', each engine captures one graph, and the
    bank's caches are the tensors it started with."""
    from repro_torch.serve.engine import StepEngine
    from repro_torch.serve.pool import PagePool, SharedBank
    m, p = _reduced_lm("tinyllama-1.1b", {})
    prompts = _prefix_traffic(m.cfg.vocab_size, n=4)
    bare = prompts[0][:, :32].copy()            # the preamble: a CoW hit

    def run(multi_step):
        bank = SharedBank(PagePool(5 * 4 + 1))
        kw = dict(max_len=64, paged=True, page_size=16, prefix_cache=True,
                  bank=bank, multi_step=multi_step)
        a, b = StepEngine(m, batch_size=3, **kw), StepEngine(
            m, batch_size=2, **kw)
        leaves = [t for c in bank.caches for t in c if t is not None]
        ga = a.admit(p, prompts[0], max_new=12)  # indexed on admission
        a.step(p)
        ga += a.admit(p, prompts[1], max_new=12)
        a.step(p)
        gb = b.admit(p, prompts[2], max_new=6)   # maps a's pages
        a.step(p)
        gb += b.admit(p, bare, max_new=6)
        b.step(p)
        a.step(p)
        b.drain(p)
        b.reset(keep_prefix=True)                # between a's replays
        a.step(p)
        gb += b.admit(p, prompts[3], max_new=6)
        while a.live_slots() or b.live_slots():
            for eng in (a, b):
                if eng.live_slots():
                    eng.step(p)
        now = [t for c in bank.caches for t in c if t is not None]
        assert all(x is y for x, y in zip(now, leaves))
        assert a.state.caches is b.state.caches is bank.caches
        return [g.tokens for g in ga], [g.tokens for g in gb], a, b

    want_a, want_b, _, _ = run(1)
    got_a, got_b, a, b = run(4)
    assert got_a == want_a and got_b == want_b
    assert (a.stats["prefix_hits"], b.stats["prefix_hits"],
            b.stats["cow_copies"]) == (1, 3, 1)
    assert a.graph_captures == 1 and b.graph_captures == 1


def test_chunked_hit_under_local_reads_is_bitwise_the_cold_stream(gen):
    """A chunked (C = page) prefix engine whose bank is split over
    ``Mesh((cuda:0,) * 4)`` with local reads (the decode through B5):
    each hit's pages lie on its anchor's shard, its final chunk is the
    cold admission's, and the streams are bit for bit the cold chunked
    local-read engine's."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels.paged_attention.ops import paged_decode_partial
    from repro_torch.serve.engine import StepEngine
    m, p = _reduced_lm("tinyllama-1.1b", {})
    prompts = _prefix_traffic(m.cfg.vocab_size)
    mesh = Mesh((torch.device("cuda", 0),) * 4)

    def run(prefix_cache):
        eng = StepEngine(m, batch_size=3, max_len=64, paged=True,
                         page_size=16, num_pages=4 * 10,
                         prefill_chunk=16, mesh=mesh, local_read=True,
                         prefix_cache=prefix_cache)
        first = eng.admit(p, prompts[0], max_new=8)[0]
        while not first.tokens:
            eng.step(p)
        gens = [first] + [eng.admit(p, t, max_new=8)[0]
                          for t in prompts[1:]]
        while eng.live_slots():
            eng.step(p)
        return [g.tokens for g in gens], eng

    cold, _ = run(False)
    before = paged_decode_partial.launches
    hit, eng = run(True)
    assert hit == cold
    assert paged_decode_partial.launches > before
    assert (eng.stats["prefix_hits"], eng.stats["prefix_pages_mapped"],
            eng.stats["cow_copies"]) == (2, 4, 0)


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", [False, True])
def test_greedy_accept_on_the_card_is_the_cpus(gen, tree):
    """The greedy accept rules on CUDA tensors and on CPU copies of the
    same values agree bit for bit, over bf16-rounded logits (ties
    plausible) at a 32000-token vocabulary, with hits on the chain, on
    later siblings and misses; the greedy tree's top W breaks ties to
    the lowest index on the card too."""
    from repro_torch.serve.speculative import (_top_w, speculative_accept,
                                               tree_speculative_accept)
    B, K, W, V = 64, 4, 3, 32000
    Kt = 1 + K * W if tree else K + 1
    tl = torch.randn((B, Kt, V), generator=gen, device="cuda").to(
        torch.bfloat16).float()
    dl = torch.randn((B, K, V), generator=gen, device="cuda")
    tgt = tl.argmax(-1)
    if tree:
        x = torch.randint(0, V, (B, K, W), generator=gen, device="cuda")
        rows = torch.arange(B, device="cuda")
        for i in range(K):              # row r hits sibling (r + i) % W,
            parent = 0 if i == 0 else 1 + (i - 1) * W   # every 4th misses
            col = (rows + i) % W
            x[rows, i, col] = torch.where(rows % 4 == 3, x[rows, i, col],
                                          tgt[:, parent])
        fn = tree_speculative_accept
    else:
        x = tgt[:, :K].clone()
        miss = torch.rand((B, K), generator=gen, device="cuda") < 0.3
        x[miss] = (x[miss] + 1) % V
        fn = speculative_accept
    on_card = fn(x, dl, tl, 0.0)
    on_cpu = fn(x.cpu(), dl.cpu(), tl.cpu(), 0.0)
    for a, b in zip(on_card, on_cpu):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    n = on_card[1]
    assert (n == 0).any() and (n > 0).any()
    ties = torch.zeros((2, V), device="cuda")
    ties[:, [7, 31999, 5, 100]] = 1.0
    assert _top_w(ties, 3).tolist() == [[5, 7, 100]] * 2


@pytest.mark.parametrize("tree_width", [1, 3])
def test_spec_rounds_on_the_card(gen, tree_width):
    """Reduced tinyllama on the card, an aligned draft: each round
    launches the paged verify kernel once per target layer on its route
    (the causal body for a flat round, the tree route for a tree of
    1 + 4*3 nodes), commits 1 to K+1 tokens a row, more than one a round
    on average (the draft is accepted), and the engine drains with every
    page back."""
    from repro_torch.kernels.paged_attention.ops import paged_verify_attention
    from repro_torch.serve.speculative import SpecEngine
    m, p = _reduced_lm("tinyllama-1.1b", {})
    eng = SpecEngine(m, m, batch_size=2, max_len=64, k=4,
                     tree_width=tree_width, page_size=16)
    g = torch.Generator().manual_seed(2)
    gens = [eng.admit((p, p), torch.randint(
        0, m.cfg.vocab_size, (1, S), generator=g).numpy(), max_new=12)[0]
        for S in (9, 20)]
    route = "launches_tree" if tree_width > 1 else "launches"
    while eng.live_slots():
        before = getattr(paged_verify_attention, route)
        done = sum(len(x.tokens) for x in gens)
        eng.step((p, p))
        assert getattr(paged_verify_attention, route) - before == \
            m.cfg.num_layers
        assert 1 <= sum(len(x.tokens) for x in gens) - done <= 2 * 5
    assert [len(x.tokens) for x in gens] == [12, 12]
    assert eng.accepted_per_round > 1.0 and eng.stats["rounds"] <= 11
    assert eng.free_pages() == eng._d_pages.allocatable


def _classifier_host(m, classes, seed):
    """A cascade classifier's weights in host memory: ``m``'s backbone
    from ``seed`` and a (d, classes) head."""
    g = torch.Generator().manual_seed(seed)
    return {"backbone": m.init(seed=seed, device="cpu"),
            "head": 0.02 * torch.randn(m.cfg.d_model, classes, generator=g)}


def test_delta_load_on_the_card_shares_the_base(gen, tmp_path):
    """A head-only delta over a resident base: only the head crosses the
    link, every backbone tensor of the delta slot is the base slot's
    (same ``data_ptr``), its logits are bitwise a full load's of the same
    weights, the flash kernel runs in them; a bf16 context read back
    from a ``ContextStore`` serves the same logits."""
    from repro_torch.core.cascade import classifier_logits
    from repro_torch.core.context import (ContextDescriptor, ContextStore,
                                          ContextSwitchEngine, tree_leaves)
    m, _ = _reduced_lm("supersub-super", {"param_dtype": "bfloat16"})
    base = _classifier_host(m, 12, seed=1)
    head = {"head": 0.02 * torch.randn(m.cfg.d_model, 12,
                                       generator=torch.Generator()
                                       .manual_seed(2))}
    store = ContextStore(str(tmp_path))
    store.save("full", {**base, **head})
    eng = ContextSwitchEngine(num_slots=3, device="cuda", store=store)

    def apply(p, x):
        return classifier_logits(m, p, x)

    for name, fn, b in (("base", lambda: base, None),
                        ("spec", lambda: head, "base"),
                        ("full", None, None)):         # from the store
        eng.register(ContextDescriptor(name, apply, fn, base=b))
    eng.preload("base", block=True)
    b0 = eng.stats["bytes_loaded"]
    spec = eng.preload("spec", block=True).result()
    assert eng.stats["bytes_loaded"] - b0 == head["head"].nbytes
    base_bufs = eng._find_slot("base").buffers
    assert spec.buffers["head"].is_cuda
    for a, b in zip(tree_leaves(spec.buffers["backbone"]),
                    tree_leaves(base_bufs["backbone"])):
        assert a.data_ptr() == b.data_ptr()
    x = torch.randint(0, m.cfg.vocab_size, (4, 40), generator=torch
                      .Generator().manual_seed(3)).cuda()
    out = {}
    for name in ("spec", "full"):
        eng.preload(name, block=True)
        eng.switch(name)
        kernels.reset_launch_counts()
        out[name] = eng.run(x)
        assert flash_attention.launches == m.cfg.num_layers
    assert torch.equal(out["spec"], out["full"])
    assert torch.equal(eng.run_async(x), out["full"])
    eng.shutdown()


@pytest.mark.parametrize("slots", [2, 3])
def test_cascade_pipelined_equals_sequential_on_the_card(gen, slots):
    """Reduced transformer members on the card: the pipelined cascade's
    predictions are bitwise the sequential ones (the same kernels on the
    same buffers), and every member pass runs the flash kernel."""
    from repro_torch.core.cascade import (CascadeMember, SuperSubCascade,
                                          classifier_logits)
    from repro_torch.core.context import ContextSwitchEngine
    from repro_torch.train.data import HierarchicalTask
    m, _ = _reduced_lm("supersub-super", {"param_dtype": "bfloat16"})
    task = HierarchicalTask(num_super=4, subs_per_super=3,
                            vocab=m.cfg.vocab_size, seq_len=48, seed=0)

    def member(name, classes, seed, covers=None):
        host = _classifier_host(m, classes, seed)
        return CascadeMember(name, lambda p, x: classifier_logits(m, p, x),
                             lambda: host, covers=covers)

    sup, gen_m = member("super", 4, 1), member("generalist", 12, 2)
    specs = [member(f"spec{g}", 3, 10 + g, covers=g) for g in range(4)]
    batches = [task.sample(16, seed=b, subclasses=[3 * (b % 4)])[0].cuda()
               for b in range(6)]
    runs = []
    for pipelined in (False, True):
        eng = ContextSwitchEngine(num_slots=slots, device="cuda")
        cas = SuperSubCascade(eng, sup, specs, gen_m, task.sub_of_super)
        kernels.reset_launch_counts()
        runs.append(cas.dynamic_infer_pipelined(batches) if pipelined
                    else [cas.dynamic_infer(x) for x in batches])
        assert flash_attention.launches == 2 * len(batches) * \
            m.cfg.num_layers
        eng.shutdown()
    for a, b in zip(*runs):
        assert a["super"] == b["super"]
        assert (a["sub"] == b["sub"]).all()


# ---------------------------------------------------------------------------
# training: B1's backward, the named no-backward errors, a train step
# ---------------------------------------------------------------------------

BWD_RTOL = 2.0 ** -7   # relative L2 of each gradient (chip_smoke.py's limit)


@pytest.mark.parametrize("B,H,Hkv,S,hd,window", [
    (2, 8, 2, 200, 64, 0), (1, 4, 4, 130, 32, 0), (2, 6, 3, 97, 128, 40),
    (1, 4, 2, 70, 256, 0), (2, 4, 1, 64, 80, 0), (1, 20, 1, 33, 64, 9)])
def test_flash_backward_matches_plain(gen, B, H, Hkv, S, hd, window):
    """Autograd through ``flash_attention`` on the card (the forward
    kernel keeping its row log-sum-exps, then the backward kernel) against
    the float32 backward of ``mha_reference``, on the model's (B, S, H, hd)
    layout seen as (B, H, S, hd) views; head width 80 runs padded to 128,
    a group of 20 in one launch.  Twice, bit for bit."""
    kernels.reset_launch_counts()
    q, k, v = (_rn(gen, B, S, n, hd) for n in (H, Hkv, Hkv))
    do = _rn(gen, B, S, H, hd)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*(t.transpose(1, 2) for t in leaves),
                              window=window)
        out.transpose(1, 2).backward(do)
        grads.append([t.grad for t in leaves])
    ref = [t.transpose(1, 2) for t in mha_backward_reference(
        *(t.transpose(1, 2).float() for t in (q, k, v, do)), window=window)]
    torch.cuda.synchronize()
    for a, b, r in zip(*grads, ref):
        assert torch.equal(a, b)
        assert ((a.float() - r).norm() / r.norm()).item() <= BWD_RTOL
    assert flash_attention_backward.launches == 2


def test_flash_backward_is_the_functions_gradient(gen):
    """``flash_attention`` with grad needed is a ``torch.autograd.Function``
    whose backward launches the kernel; without it, the serving launch."""
    q, k, v = (_rn(gen, 1, 2, 16, 64) for _ in range(3))
    q.requires_grad_()
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None and "Flash" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


def _no_backward_calls(gen):
    """One call of each wrapper without a backward kernel, on the card,
    with its first tensor input requiring grad."""
    B, H, Hkv, hd, S = 2, 8, 2, 64, 64
    q = _rn(gen, B, H, hd).requires_grad_()
    k, v = _rn(gen, B, Hkv, S, hd), _rn(gen, B, Hkv, S, hd)
    pos = torch.tensor([3, 40], dtype=torch.int32, device="cuda")
    page, P = 16, 4
    kp, vp = (_rn(gen, B * P + 1, Hkv, page, hd) for _ in range(2))
    table = (torch.arange(B * P, device="cuda", dtype=torch.int32)
             + 1).reshape(B, P)
    qv = _rn(gen, B, 4, H, hd).requires_grad_()
    bk, bv = _rn(gen, B, 4, Hkv, hd), _rn(gen, B, 4, Hkv, hd)
    x = _rn(gen, 2, 8, 64).requires_grad_()
    w = _rn(gen, 2, 64, 32)
    return {
        "decode_attention": lambda: decode_attention(q, k, v, pos),
        "verify_attention": lambda: verify_attention(qv, k, v, bk, bv, pos),
        "paged_decode_attention": lambda: paged_decode_attention(
            q, kp, vp, table, pos),
        "paged_verify_attention": lambda: paged_verify_attention(
            qv, kp, vp, bk, bv, table, pos),
        "paged_decode_partial": lambda: paged_decode_partial(
            q, kp, vp, table, pos, 0),
        "gmm": lambda: gmm(x, w),
    }


@pytest.mark.parametrize("name", ["decode_attention", "verify_attention",
                                  "paged_decode_attention",
                                  "paged_verify_attention",
                                  "paged_decode_partial", "gmm"])
def test_wrappers_without_a_backward_refuse_a_gradient(gen, name):
    """A gradient asked of a kernel with no backward kernel raises its
    named error (rather than return a tensor with no ``grad_fn``); the
    same call under ``torch.no_grad()`` launches as serving does."""
    call = _no_backward_calls(gen)[name]
    with pytest.raises(kernels.MissingBackwardKernel,
                       match=f"backward kernel of {name}"):
        call()
    with torch.no_grad():
        call()
    torch.cuda.synchronize()


# B8's backward at chip_smoke.py's record shapes, (B, L, d_in, N,
# init_state, final-state cotangent): jamba-v0.1-52b's training pass, and
# N 12 (padded) off the kernel's tiles with both states
SCAN_BWD_CASES = [(4, 512, 8192, 16, False, False),
                  (2, 100, 1000, 12, True, True)]
SCAN_BWD_RTOL = 1e-4          # chip_smoke.py's limit, each of 7 gradients


def _scan_bwd_args(gen, B, L, d_in, N, init, ds):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u, Bm, Cm = rn(B, L, d_in), rn(B, L, N), rn(B, L, N)
    dt = torch.nn.functional.softplus(rn(B, L, d_in) - 2.0)
    A, D = -torch.exp(rn(d_in, N) * 0.5), rn(d_in)
    return (u, dt, Bm, Cm, A, D, rn(B, d_in, N) if init else None,
            rn(B, L, d_in), rn(B, d_in, N) if ds else None)


def _scan_grads_close(got, want):
    """Each gradient within ``SCAN_BWD_RTOL`` relative L2 of the plain one
    and each element within ``SCAN_BWD_RTOL`` x its largest value."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert float((g - w).norm()) <= SCAN_BWD_RTOL * float(w.norm())
        torch.testing.assert_close(g, w, rtol=0, atol=SCAN_BWD_RTOL
                                   * float(w.abs().max()))


@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_ssm_scan_backward_kernel_matches_plain(gen, case):
    """The scan's backward kernel against its plain reverse loop on the
    same CUDA tensors, all seven gradients, and two launches bit for
    bit."""
    from repro_torch.kernels.ssm_scan.ops import (
        selective_scan_backward_reference, ssm_scan_backward)
    kernels.reset_launch_counts()
    args = _scan_bwd_args(gen, *case)
    got = ssm_scan_backward(*args)
    again = ssm_scan_backward(*args)
    torch.cuda.synchronize()
    assert ssm_scan_backward.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _scan_grads_close(got, selective_scan_backward_reference(*args))


def test_ssm_scan_autograd_on_the_card_matches_the_plain_backward(gen):
    """Autograd through ``ssm_scan`` on CUDA tensors (its Function: the
    forward kernel, then the backward kernel) gives the plain backward's
    gradients, at N 12 (padded: the pad and crop differentiated as
    ordinary ops) from a carried state, with cotangents on y and on the
    final state; under ``torch.no_grad()`` it launches as serving does."""
    from repro_torch.kernels.ssm_scan.ops import (
        selective_scan_backward_reference, ssm_scan_backward)
    kernels.reset_launch_counts()
    args = _scan_bwd_args(gen, 2, 100, 1000, 12, True, True)
    leaves = [t.clone().requires_grad_() for t in args[:7]]
    y, s = ssm_scan(*leaves)
    torch.autograd.backward((y, s), (args[7], args[8]))
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan_backward.launches) == (1, 1)
    _scan_grads_close([t.grad for t in leaves],
                      selective_scan_backward_reference(*args))
    with torch.no_grad():
        ssm_scan(*leaves)
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan_backward.launches) == (2, 1)


# the forward with its checkpoint output: jamba's training shape, the
# padded record's (N 12, a carried state) and one chunk and a step
SCAN_CKPT_CASES = [(4, 512, 8192, 16, False), (2, 100, 1000, 12, True),
                   (1, 17, 64, 16, True)]


@pytest.mark.parametrize("B,L,d_in,N,init", SCAN_CKPT_CASES)
def test_ssm_scan_checkpoints_leave_the_forward_unchanged(gen, B, L, d_in, N,
                                                          init):
    """The forward launched with its checkpoint pointer set gives y and
    the final state bit for bit as the forward without it."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_checkpointed
    args = _scan_bwd_args(gen, B, L, d_in, N, init, False)[:7]
    kernels.reset_launch_counts()
    y, s, ck = ssm_scan_checkpointed(*args)
    want_y, want_s = ssm_scan(*args)
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan.launches_checkpointed) == (2, 1)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert ck.shape == (B, -(-L // 16), d_in, -(-N // 16) * 16)


@pytest.mark.parametrize("B,L,d_in,N,init", SCAN_CKPT_CASES)
def test_ssm_scan_checkpoints_are_the_states_before_each_chunk(gen, B, L,
                                                               d_in, N, init):
    """Checkpoint k is the plain recurrence's state before step 16 k
    (within the scan's limit, 1e-4 of its largest value; zero past N),
    and bit for bit the state the forward kernel ends with after the
    first 16 k steps; the backward from them gives the bits of the
    backward that makes its own."""
    from repro_torch.kernels.ssm_scan.ops import (
        selective_scan_checkpoints, ssm_scan_backward, ssm_scan_checkpointed)
    args = _scan_bwd_args(gen, B, L, d_in, N, init, True)
    ck = ssm_scan_checkpointed(*args[:7])[2]
    want = selective_scan_checkpoints(*args[:7])[2]
    torch.testing.assert_close(ck[..., :N], want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(ck[..., N:], torch.zeros_like(ck[..., N:]))
    u, dt, Bm, Cm, A, D, s0 = args[:7]
    for k in range(1, ck.shape[1]):
        t = 16 * k
        prefix = ssm_scan(u[:, :t], dt[:, :t], Bm[:, :t], Cm[:, :t], A, D,
                          s0)[1]
        assert torch.equal(ck[:, k, :, :N], prefix)
    kernels.reset_launch_counts()
    given = ssm_scan_backward(*args, checkpoints=ck)
    own = ssm_scan_backward(*args)
    torch.cuda.synchronize()
    assert (ssm_scan.launches_checkpointed, ssm_scan_backward.launches) == \
        (1, 2)
    assert all(torch.equal(a, b) for a, b in zip(given, own))


def test_ssm_scan_under_no_grad_writes_no_checkpoints(gen):
    """A forward with a gradient writes checkpoints (one launch); the same
    call under ``torch.no_grad()`` launches as serving does, and so does
    a call whose inputs need no gradient."""
    args = _scan_bwd_args(gen, 2, 100, 1000, 16, True, False)[:7]
    leaves = [t.clone().requires_grad_() for t in args]
    kernels.reset_launch_counts()
    with torch.no_grad():
        ssm_scan(*leaves)
    ssm_scan(*args)
    assert (ssm_scan.launches, ssm_scan.launches_checkpointed) == (2, 0)
    ssm_scan(*leaves)
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan.launches_checkpointed) == (3, 1)


# B9's backward at chip_smoke.py's record shapes, (B, H, L, dh, chunk,
# forget bias): xlstm-125m's training batch, and dh 96 (padded to 128)
# over 16 chunks, its forget gates near 1 (the state carried across
# every boundary)
MLSTM_BWD_CASES = [(8, 4, 512, 384, 256, 1.0), (2, 4, 1024, 96, 64, 6.0)]
# each of the five gradients, relative L2 and elementwise over the largest
# value (chip_smoke.py's limit)
MLSTM_BWD_RTOL = 1e-4


def _mlstm_bwd_args(gen, B, H, L, dh, fbias=1.0):
    """(q, k, v, li, lf, dh_out), drawn as chip_smoke.py draws them."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v = rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh)
    li = rn(B, H, L) * 0.5
    lf = torch.nn.functional.logsigmoid(rn(B, H, L) + fbias)
    return q, k, v, li, lf, rn(B, H, L, dh)


def _mlstm_grads_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert float((g - w).norm()) <= MLSTM_BWD_RTOL * float(w.norm())
        torch.testing.assert_close(g, w, rtol=0, atol=MLSTM_BWD_RTOL
                                   * float(w.abs().max()))


def _mlstm_card_grads(args, chunk, times=1):
    """The five gradients of h for the cotangent ``args[5]``, by autograd
    through ``mlstm_chunk`` on the card as training takes them (its
    Function: one forward launch writing its saves, then ``times``
    backward launches from them)."""
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    h, _ = mlstm_chunk(*leaves, chunk=chunk)
    return [torch.autograd.grad(h, leaves, args[5], retain_graph=True)
            for _ in range(times)]


@pytest.mark.parametrize("case", MLSTM_BWD_CASES)
def test_mlstm_chunk_backward_kernel_matches_plain(gen, case):
    """The mLSTM's backward kernel from the forward's saves, reached
    through autograd as training reaches it, against the plain backward
    on the same CUDA tensors, all five gradients; two backward launches
    from one forward's saves bit for bit."""
    from repro_torch.kernels.mlstm_chunk.ops import (
        mlstm_chunk_backward, mlstm_chunk_backward_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, L, dh, c, fbias = case
    args = _mlstm_bwd_args(gen, B, H, L, dh, fbias)
    kernels.reset_launch_counts()
    got, again = _mlstm_card_grads(args, c, times=2)
    torch.cuda.synchronize()
    assert mlstm_chunk_backward.launches == 2
    assert (mlstm_chunk.launches, mlstm_chunk.launches_saved) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _mlstm_grads_close(got, mlstm_chunk_backward_reference(*args[:5], c,
                                                           args[5]))


@pytest.mark.parametrize("B,H,L,dh,chunk", [
    (1, 2, 200, 64, 256),       # one ragged chunk: tiles of 8 rows
    (2, 2, 100, 48, 64),        # 25 chunks of 4, dh padded to 64
    (1, 1, 768, 384, 256),      # three chunks
    (1, 2, 384, 128, 256),      # a chunk of 256 shrunk to 128
    (2, 1, 320, 200, 64),       # 5 chunks, dh padded to 256
    (1, 1, 1024, 512, 256),     # the widest dh, four chunks
    (1, 2, 512, 320, 128),      # dh 320: a 192-column strip and 128
    (1, 1, 768, 448, 256)])     # dh 448: two strips of 192 and 64
@pytest.mark.parametrize("fbias", [1.0, 6.0])
def test_mlstm_chunk_backward_kernel_over_its_domain(gen, B, H, L, dh,
                                                     chunk, fbias):
    """The backward kernel over the forward's domain: any chunk up to 256
    (ragged tiles), one to 25 chunks, any dh up to 512 (zero-padded;
    widths that leave a column remainder after 192-column strips);
    forget gates as the forward's tests draw them and near 1 (the state
    carried across the chunks)."""
    from repro_torch.kernels.mlstm_chunk.ops import (
        mlstm_chunk_backward_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _mlstm_bwd_args(gen, B, H, L, dh, fbias)
    c = min(chunk, L)
    while L % c:
        c //= 2
    got, = _mlstm_card_grads(args, chunk)
    _mlstm_grads_close(got, mlstm_chunk_backward_reference(*args[:5], c,
                                                           args[5]))


def test_mlstm_chunk_autograd_on_the_card_matches_the_plain_backward(gen):
    """Autograd through ``mlstm_chunk`` on CUDA tensors (its Function: the
    forward kernel with its saves, then the backward kernel) gives the
    plain backward's gradients at dh 96 (the Function pads to 128 and
    the backward crops the gradients); a cotangent of the final state
    raises its named error, and ``mlstm_chunk_backward`` called on CUDA
    tensors without the forward's saves raises; under
    ``torch.no_grad()`` the forward launches as serving does, writing no
    saves."""
    from repro_torch.kernels.mlstm_chunk.ops import (
        FinalStateCotangent, mlstm_chunk_backward,
        mlstm_chunk_backward_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _mlstm_bwd_args(gen, 2, 4, 256, 96, 6.0)
    kernels.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    h, (C, n, m) = mlstm_chunk(*leaves, chunk=64)
    h.backward(args[5])
    torch.cuda.synchronize()
    assert (mlstm_chunk.launches_saved, mlstm_chunk_backward.launches) == \
        (1, 1)
    _mlstm_grads_close([t.grad for t in leaves],
                       mlstm_chunk_backward_reference(*args[:5], 64,
                                                      args[5]))
    for i in range(3):
        out = mlstm_chunk(*leaves, chunk=64)
        with pytest.raises(FinalStateCotangent, match="final state"):
            (out[1][i].sum() + out[0].sum()).backward()
    with pytest.raises(ValueError, match="saves"):
        mlstm_chunk_backward(*args, chunk=64)
    with torch.no_grad():
        mlstm_chunk(*leaves, chunk=64)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches_saved == 4


@pytest.mark.parametrize("B,H,L,dh,chunk", [case[:5] for case in
                                             MLSTM_BWD_CASES]
                         + [(1, 2, 200, 64, 256)])
def test_mlstm_chunk_saves_leave_the_forward_unchanged(gen, B, H, L, dh,
                                                       chunk):
    """The forward with its saves set (under a gradient) gives h and the
    final (C, n, m) bit for bit as the serving forward under
    ``torch.no_grad()``, which writes no saves."""
    q, k, v, li, lf, _ = _mlstm_bwd_args(gen, B, H, L, dh)
    kernels.reset_launch_counts()
    with torch.no_grad():
        want = mlstm_chunk(q, k, v, li, lf, chunk=chunk)
    assert mlstm_chunk.launches_saved == 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
    got = mlstm_chunk(*leaves, chunk=chunk)
    torch.cuda.synchronize()
    assert (mlstm_chunk.launches, mlstm_chunk.launches_saved) == (2, 1)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "mixtral-8x7b", "xlstm-125m"])
def test_train_step_on_the_card_matches_the_cpu(gen, name):
    """One ``make_train_step`` step of a reduced model (tinyllama-1.1b: 2
    layers; jamba-v0.1-52b: one 8-layer period of Mamba, attention, MLP
    and MoE layers; mixtral-8x7b: 2 layers of attention and 4-expert MoE;
    xlstm-125m: 4 layers, three mLSTM and an sLSTM, chunk 16, so that the
    64 tokens make 4 chunks; llama's N(0, 0.02) init, eps=1.0) on the
    card (bf16 activations, the flash kernel and its backward, the scan
    kernel and its backward, the mLSTM kernel and its backward) against
    the same step on the CPU in float32, from the same state and batch:
    loss and gradient norm within 2e-2 relative, every parameter after
    the step within 1e-5 (at eps=1.0 the update is lr times the clipped
    gradient, lr 1e-3)."""
    from repro_torch.configs import get_arch, override, reduced
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig)
    from repro_torch.models.model import build_model
    from repro_torch.train import trainer as ttr
    from repro_torch.core.context import tree_leaves, tree_map
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk_backward
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_backward
    cfg = reduced(get_arch(name))
    kernels.reset_launch_counts()
    rc = RunConfig(optimizer=OptimizerConfig(lr=1e-3, total_steps=10,
                                             warmup_steps=1, eps=1.0),
                   parallel=ParallelConfig())
    cpu = build_model(override(cfg, dtype="float32"),
                      cache_dtype=torch.float32, device="cpu")
    card = build_model(cfg, device="cuda")
    state = ttr.init_state(cpu, 0, rc, init_std=0.02)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(1))
    want, wm = ttr.make_train_step(cpu, rc)(state, {"tokens": tokens})
    got, gm = ttr.make_train_step(card, rc)(
        tree_map(lambda t: t.cuda(), state), {"tokens": tokens.cuda()})
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 2e-2 * abs(float(wm[k]))
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    assert (flash_attention_backward.launches > 0) == (name != "xlstm-125m")
    assert (ssm_scan_backward.launches > 0) == (name == "jamba-v0.1-52b")
    assert (mlstm_chunk_backward.launches > 0) == (name == "xlstm-125m")


def test_card_refuses_to_train_a_family_without_backward_kernels(gen):
    """Every family builds its step on one card (the xLSTM family through
    B9's backward kernel); only a model whose MoE layers run under a mesh
    (B7, the grouped matmul, has no backward kernel) is refused."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.train import trainer as ttr
    for name in ("xlstm-125m", "mixtral-8x7b", "jamba-v0.1-52b"):
        ttr.make_train_step(build_model(reduced(get_arch(name)),
                                        device="cuda"), RunConfig())
    m = build_model(reduced(get_arch("mixtral-8x7b")), device="cuda",
                    mesh=Mesh((torch.device("cuda", 0),) * 4))
    with pytest.raises(kernels.MissingBackwardKernel, match="gmm"):
        ttr.make_train_step(m, RunConfig())
