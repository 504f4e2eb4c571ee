"""Public wrappers of the paged kernels: one-token decode, K-query
verify and one shard's decode partial over its slice of a sharded bank,
over a full-precision or an int8 page pool.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
``csrc/paged_attention.cu`` (decode, verify) or ``csrc/paged_partial.cu``
(the partial) or raises.  An int8 pool passes its
(NP, Hkv, page) f32 ``k_scale``/``v_scale``; its launches count in
``<wrapper>.launches_int8``, the full-precision body's in
``<wrapper>.launches``.  A verify with a ``tree`` mask counts in
``paged_verify_attention.launches_tree`` instead, whatever the pool.
The decode also counts by shape, (B, Hkv, G, P, page, hd) of each
launch, in ``.launches_by_shape``, and the verify by (B, Hkv, G, Kb, P,
page, hd, int8), every route.  ``paged_decode_partial``
takes one shard's local slice of a sharded bank and the shard's first
global page id.  The decode and the partial split each (row, kv head)'s
keys over a cluster of ``kernels.decode_splits`` blocks, by key index as
the row-cache decode does, so a pool holding a row cache's keys gives
that decode's output bit for bit, and a row whose pages all lie on one
shard comes out of the shards' merged partials as the global decode's.

The decode, partial and verify kernels are instantiated for head widths
32/64/128/256 and take any group (the decode family up to 16 heads a
launch); any other width up to 256 runs zero-padded and a wider decode
group in slices of 16 heads (``kernels.decode_padded``,
``kernels.verify_padded``), which is exact.  The verify kernel reads q
(B, Kb, H, hd) and the block's keys and values in place and writes its
(B, Kb, H, hd) output itself.
"""
from __future__ import annotations

import collections

import torch

from repro_torch import kernels as K
from repro_torch.kernels.paged_attention.ref import (
    gather_pages, gather_scales, paged_decode_partial_reference,
    paged_decode_reference, paged_verify_reference)

_fns: dict = {}


def _pool_args(k_pages, v_pages, k_scale, v_scale, page_table, B):
    """Check the pool side for the kernels -> (pool pointers, quantized,
    NP, Hkv, page, P)."""
    NP, Hkv, page, hd = k_pages.shape
    P = page_table.shape[1]
    quant = k_scale is not None
    dt = torch.int8 if quant else torch.bfloat16
    K.check_cuda_input("k_pages", k_pages, dt, (NP, Hkv, page, hd))
    K.check_cuda_input("v_pages", v_pages, dt, (NP, Hkv, page, hd))
    ptrs = [k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        K.check_cuda_input("k_scale", k_scale, torch.float32,
                           (NP, Hkv, page))
        K.check_cuda_input("v_scale", v_scale, torch.float32,
                           (NP, Hkv, page))
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    K.check_cuda_input("page_table", page_table, torch.int32, (B, P))
    return ptrs, quant, NP, Hkv, page, P


def _scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 pool passes both k_scale and v_scale")
    return () if k_scale is None else (k_scale, v_scale)


def _c(symbol: str, nptr: int, nint: int, lib: str = "paged_attention"):
    fn = _fns.get(symbol)
    if fn is None:
        fn = _fns[symbol] = K.c_function(
            lib, symbol, [K.P] * nptr + [K.I] * nint + [K.F, K.P])
    return fn


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q: (B, H, hd); k_pages/v_pages: (NP, Hkv, page, hd) shared pool
    (int8 codes with ``k_scale``/``v_scale``); page_table: (B, P) int32;
    pos: () or (B,) int32 -> (B, H, hd).

    Row b attends to its positions [0, pos[b]], key t read from pool
    page ``page_table[b, t // page]``.  Dead table entries (past a row's
    allocation) must hold a valid pool index (the park page); they are
    never read for a position <= pos."""
    B, H, hd = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    scales = _scales(k_scale, v_scale)
    if K.on_cpu(q, k_pages, v_pages, page_table, pos, *scales):
        return paged_decode_reference(q, k_pages, v_pages, page_table, pos,
                                      scale=scale, k_scale=k_scale,
                                      v_scale=v_scale)
    K.require_no_grad("paged_decode_attention", q, k_pages, v_pages, *scales)
    Hkv = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    def body(qp, kv, G):
        pool, quant, _, _, page, P = _pool_args(*kv, k_scale, v_scale,
                                                page_table, B)
        width = qp.shape[-1]
        K.check_cuda_input("q", qp, torch.bfloat16, (B, Hkv * G, width))
        out = torch.empty_like(qp)
        sym = ("paged_decode_attention_int8" if quant
               else "paged_decode_attention_bf16")
        rc = _c(sym, 4 + len(pool), 7)(
            qp.data_ptr(), *pool, page_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, Hkv, G, P, page, width,
            K.decode_splits(P * page), float(scale), K.stream_ptr(qp))
        K.check_launch(sym, rc)
        if quant:
            paged_decode_attention.launches_int8 += 1
        else:
            paged_decode_attention.launches += 1
        paged_decode_attention.launches_by_shape[
            (B, Hkv, G, P, page, width)] += 1
        return (out.view(B, Hkv, G, width),)

    (out,) = K.decode_padded(q, Hkv, (k_pages, v_pages), body)
    return out.reshape(B, H, hd)


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
# (B, Hkv, G, P, page, hd) -> launches at that shape, either pool
paged_decode_attention.launches_by_shape = collections.Counter()


def paged_verify_attention(q, k_pages, v_pages, blk_k, blk_v, page_table,
                           pos, *, scale: float | None = None, k_scale=None,
                           v_scale=None, tree=None) -> torch.Tensor:
    """q: (B, Kb, H, hd); the pool (as in ``paged_decode_attention``)
    holds the cache BEFORE the block's writes; blk_k/blk_v: (B, Kb, Hkv,
    hd) full precision; page_table: (B, P); pos: () or (B,) int32 base
    positions; ``tree``: optional (B, Kb) int32 ancestor bitmasks ->
    (B, Kb, H, hd).  Query i of row b (position pos[b] + i) attends to
    the row's positions [0, pos[b]-1] through the table plus block
    tokens j <= i (or the tree's bits)."""
    B, Kb, H, hd = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    if tree is not None:
        tree = torch.as_tensor(tree, dtype=torch.int32, device=q.device)
    scales = _scales(k_scale, v_scale)
    if K.on_cpu(q, k_pages, v_pages, blk_k, blk_v, page_table, pos,
                *scales, *(() if tree is None else (tree,))):
        return paged_verify_reference(q, k_pages, v_pages, blk_k, blk_v,
                                      page_table, pos, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale,
                                      tree=tree)
    K.require_no_grad("paged_verify_attention", q, k_pages, v_pages, blk_k,
                      blk_v, *scales)
    Hkv = k_pages.shape[1]
    q, blk_k, blk_v, tree, G, width = K.verify_padded(
        "paged_verify_attention", q, blk_k, blk_v, tree, Hkv)
    K.check_verify_operands(q, blk_k, blk_v, tree)
    k_pages, v_pages = K.pad_last(k_pages, width), K.pad_last(v_pages,
                                                              width)
    pool, quant, NP, _, page, P = _pool_args(k_pages, v_pages, k_scale,
                                             v_scale, page_table, B)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    sym = ("paged_verify_attention_int8" if quant
           else "paged_verify_attention_bf16")
    rc = _c(sym, 7 + len(pool), 8)(
        q.data_ptr(), *pool, blk_k.data_ptr(), blk_v.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(),
        None if tree is None else tree.data_ptr(), out.data_ptr(),
        B, Hkv, G, Kb, P, page, NP, width, float(scale), K.stream_ptr(q))
    K.check_launch(sym, rc)
    if tree is not None:
        paged_verify_attention.launches_tree += 1
    elif quant:
        paged_verify_attention.launches_int8 += 1
    else:
        paged_verify_attention.launches += 1
    paged_verify_attention.launches_by_shape[
        (B, Hkv, G, Kb, P, page, width, quant)] += 1
    return out[..., :hd]


paged_verify_attention.launches = 0
paged_verify_attention.launches_int8 = 0
paged_verify_attention.launches_tree = 0
# (B, Hkv, G, Kb, P, page, hd, int8 pool) -> launches at that shape
paged_verify_attention.launches_by_shape = collections.Counter()

def paged_decode_partial(q, k_pages, v_pages, page_table, pos, base: int,
                         *, scale: float | None = None, k_scale=None,
                         v_scale=None):
    """One shard's unnormalized flash-decode state over its LOCAL bank
    slice.  q: (B, H, hd); k_pages/v_pages: (L, Hkv, page, hd) the
    shard's slice (int8 codes with (L, Hkv, page) ``k_scale``/
    ``v_scale``); page_table: (B, P) int32 GLOBAL page ids; pos: () or
    (B,) int32; ``base``: the shard's first global page id (an int) ->
    (acc (B, Hkv, G, hd) f32, m (B, Hkv, G) f32, l (B, Hkv, G) f32).

    Row b folds its keys t <= pos[b] on pages the shard owns (ids in
    [base, base + L)); a row that owns none comes back as exactly (0,
    -1e30, 0), which the caller's pmax/psum merge weighs to zero."""
    B, H, hd = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    scales = _scales(k_scale, v_scale)
    if K.on_cpu(q, k_pages, v_pages, page_table, pos, *scales):
        return paged_decode_partial_reference(
            q, k_pages, v_pages, page_table, pos, base, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    K.require_no_grad("paged_decode_partial", q, k_pages, v_pages, *scales)
    Hkv = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    def body(qp, kv, G):
        pool, quant, L, _, page, P = _pool_args(*kv, k_scale, v_scale,
                                                page_table, B)
        width = qp.shape[-1]
        K.check_cuda_input("q", qp, torch.bfloat16, (B, Hkv * G, width))
        acc = torch.empty((B, Hkv, G, width), dtype=torch.float32,
                          device=qp.device)
        m = torch.empty((B, Hkv, G), dtype=torch.float32, device=qp.device)
        l = torch.empty_like(m)
        sym = ("paged_decode_partial_int8" if quant
               else "paged_decode_partial_bf16")
        rc = _c(sym, 6 + len(pool), 9, "paged_partial")(
            qp.data_ptr(), *pool, page_table.data_ptr(), pos.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, G, P, page,
            width, int(base), L, K.decode_splits(P * page), float(scale),
            K.stream_ptr(qp))
        K.check_launch(sym, rc)
        if quant:
            paged_decode_partial.launches_int8 += 1
        else:
            paged_decode_partial.launches += 1
        return acc, m, l

    return K.decode_padded(q, Hkv, (k_pages, v_pages), body)


paged_decode_partial.launches = 0
paged_decode_partial.launches_int8 = 0

__all__ = ["gather_pages", "gather_scales", "paged_decode_attention",
           "paged_decode_partial", "paged_decode_partial_reference",
           "paged_decode_reference", "paged_verify_attention",
           "paged_verify_reference"]
