"""Dense transformer layers of the port: RMSNorm, RoPE, GQA attention and
the gated MLP, with row and paged KV caches.

Plain functions: ``params`` (a dict of tensors) in, tensors out, in the
JAX package's layouts (q ``(B, S, H, hd)``, row cache ``(B, Hkv, S,
hd)``, page pool ``(NP, Hkv, page, hd)``, page table ``(B, P)`` int32).
Attention goes through the kernel wrappers of ``repro_torch.kernels``:
the hand-written kernel for CUDA tensors, its plain version for CPU
tensors.  Where the JAX package returned an updated cache (buffer
donation), these functions write the cache IN PLACE and return it.

Entry points by execution mode:
  * ``attention``               — forward over a whole sequence, no cache
  * ``attention_prefill``       — same, plus the populated row cache
  * ``attention_decode``        — one token against the row cache
  * ``attention_decode_pages``  — one token against the shared page pool
  * ``attention_verify``        — K tokens against the row cache
  * ``attention_verify_pages``  — K tokens against the shared page pool
    (both: chunked prefill's chunk, a speculative verify block)
  * ``attention_decode_pages_sharded`` / ``attention_verify_pages_sharded``
    — the same over a page bank sharded over a mesh, each shard reading
    only its own slice (``shard=(mesh, axis)`` of the two above)

A sliding-window model (``cfg.sliding_window = W > 0``) keeps a RING row
cache of ``S = min(max_len, W)`` slots: position t lives at slot ``t % S``
and decode / verify attend to the last S positions only.  The page pool
takes full attention only (``LM._require_paged_support``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import pmax, psum
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    gather_pages, gather_scales, paged_decode_attention,
    paged_decode_partial, paged_verify_attention)
from repro_torch.kernels.verify_attention.ops import verify_attention
from repro_torch.models.common import PSpec

NEG_INF = -1e30  # bf16-safe large negative


# ---------------------------------------------------------------------------
# norms / mlp
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def mlp_specs(d: int, f: int, gated: bool = True) -> dict:
    out = {"w_up": PSpec((d, f)), "w_down": PSpec((f, d))}
    if gated:
        out["w_gate"] = PSpec((d, f))
    return out


def mlp(params, x):
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")   # jax.nn.gelu
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Contiguous row KV cache (full attention: S == max_len; a sliding
    window W: a ring of S == min(max_len, W) slots)."""
    k: torch.Tensor       # (B, Hkv, S, hd)
    v: torch.Tensor       # (B, Hkv, S, hd)


def attn_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": PSpec((d, cfg.num_heads, cfg.head_dim)),
        "wk": PSpec((d, cfg.num_kv_heads, cfg.head_dim)),
        "wv": PSpec((d, cfg.num_kv_heads, cfg.head_dim)),
        "wo": PSpec((cfg.num_heads, cfg.head_dim, d)),
    }


def _qkv(params, x, positions, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(params, o, x):
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(x.dtype))


def _sdpa_auto(q, k, v, cfg: ArchConfig):
    """q: (B, S, H, hd), k/v: (B, S, Hkv, hd) self-attention over one
    position range -> (B, S, H, hd), through the flash kernel (its plain
    version on the CPU).  The JAX package's chunked and masked-einsum
    paths are what its flash kernel replaces off the TPU; here the kernel
    or its plain version always runs."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          window=cfg.sliding_window)
    return out.transpose(1, 2)


def attention(params, x, positions, cfg: ArchConfig):
    """Forward over a whole sequence (no cache)."""
    q, k, v = _qkv(params, x, positions, cfg)
    return _out(params, _sdpa_auto(q, k, v, cfg), x)


def attention_prefill(params, x, positions, cfg: ArchConfig, max_len: int,
                      cache_dtype=torch.bfloat16):
    """Prefill from position 0: returns the output and a fresh row cache
    holding the prompt's k/v (zero tail): ``max_len`` slots, or for a
    sliding window W the ring of ``min(max_len, W)`` slots, which keeps
    the prompt's last W tokens rolled so that token t sits at slot
    ``t % W``."""
    q, k, v = _qkv(params, x, positions, cfg)
    out = _out(params, _sdpa_auto(q, k, v, cfg), x)
    S, W = x.shape[1], cfg.sliding_window
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)          # (B, Hkv, S, hd)
    if W > 0 and S > W:
        kT = torch.roll(kT[:, :, -W:], S % W, dims=2)
        vT = torch.roll(vT[:, :, -W:], S % W, dims=2)
    cache = init_kv_cache(cfg, x.shape[0], max_len, cache_dtype, x.device)
    n = kT.shape[2]
    cache.k[:, :, :n] = kT.to(cache_dtype)
    cache.v[:, :, :n] = vT.to(cache_dtype)
    return out, cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    W = cfg.sliding_window
    S = min(max_len, W) if W else max_len
    shape = (batch, cfg.num_kv_heads, S, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x, pos, cache: KVCache, cfg: ArchConfig):
    """One-step decode against the row cache.  x: (B, 1, D); pos: scalar
    (whole batch at one position) or (B,) int32 (every row at its own
    position).  The new token's k/v are written IN PLACE first, at slot
    ``min(pos, S-1)`` (freed rows park at S-1) or, in a ring, ``pos %
    S``; then row b attends to slots [0, pos[b]] (a wrapped ring: all S).
    Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    q, k, v = _qkv(params, x, pos[:, None], cfg)          # q: (B, 1, H, hd)
    S = cache.k.shape[2]
    ring = cfg.sliding_window > 0
    rows = torch.arange(B, device=x.device)
    slot = (pos % S if ring else pos.clamp(max=S - 1)).long()
    cache.k[rows, :, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, :, slot] = v[:, 0].to(cache.v.dtype)
    out = decode_attention(q[:, 0], cache.k, cache.v, pos,
                           ring=ring)[:, None]
    return _out(params, out, x), cache


def attention_verify(params, x, pos, cache: KVCache, cfg: ArchConfig,
                     wmask=None):
    """K tokens per row against the row cache: x (B, K, D) at positions
    ``pos[b] .. pos[b]+K-1`` (``pos``: scalar or (B,) int32).  Attention
    reads the cache as it stood BEFORE the block plus the block's own k/v
    under an intra-block causal mask (token i sees what the i-th
    sequential ``attention_decode`` step would see, across a ring's wrap
    too); then the K tokens' k/v are written IN PLACE at slot
    ``min(position, S-1)`` (parked rows clamp to their dead last slot)
    or, in a ring (K <= S), ``position % S``.  ``wmask`` ((B, K) bool,
    optional) gates the writes only: a False token (a chunk's pad) computes normally
    but its write is skipped, its slot left as it was.  The scatter stays
    one sync-free ``index_put_``: a False token writes back what its slot
    already holds.  That is a skip as long as no True token shares the
    slot, which holds wherever the engine calls this: only pads run past
    the last slot, where the clamp gathers them.  Returns (out (B, K, D),
    cache)."""
    B, K, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    positions = pos[:, None] + torch.arange(K, dtype=torch.int32,
                                            device=x.device)[None]
    q, k, v = _qkv(params, x, positions, cfg)              # q: (B, K, H, hd)
    ring = cfg.sliding_window > 0
    out = verify_attention(q, cache.k, cache.v, k, v, pos, ring=ring)
    S = cache.k.shape[2]
    rows = torch.arange(B, device=x.device)[:, None]
    slots = (positions % S if ring else positions.clamp(max=S - 1)).long()
    kw, vw = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if wmask is not None:
        m = wmask[:, :, None, None]
        kw = torch.where(m, kw, cache.k[rows, :, slots])
        vw = torch.where(m, vw, cache.v[rows, :, slots])
    cache.k[rows, :, slots] = kw
    cache.v[rows, :, slots] = vw
    return _out(params, out, x), cache


# ---------------------------------------------------------------------------
# paged slot pool: per-row page tables over ONE shared page pool
#
# Page 0 is the PARK page: never allocated to a request and never read for
# a live position -- dead table entries point at it (every table entry
# must be a valid pool index), and non-live rows' per-step writes are
# routed into it, so a retired slot's stale writes never disturb pages
# already recycled to a neighbor.
# ---------------------------------------------------------------------------

class PagedKV(NamedTuple):
    """Shared page pool: position j*page+s of a request lives at
    ``pool[table[j], :, s]`` for that request's page table.

    ``ks``/``vs`` are the int8 pool's scale leaves ((NP, Hkv, page) f32,
    ``None`` for a full-precision pool): then ``k``/``v`` hold symmetric
    absmax int8 codes and entry ``[p, h, s, :]`` is ``k[p, h, s, :] *
    ks[p, h, s]`` -- one scale per token per kv head, so a decoded token
    quantizes on its own without rescaling its page."""
    k: torch.Tensor       # (NP, Hkv, page, hd): cache dtype, or int8
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None     # (NP, Hkv, page) f32 (int8 only)
    vs: Optional[torch.Tensor] = None


PARK_PAGE = 0

KV_QMAX = 127.0           # symmetric int8: codes in [-127, 127]


def init_page_pool(cfg: ArchConfig, num_pages: int, page: int,
                   dtype=torch.bfloat16, device=None,
                   quantized: bool = False) -> PagedKV:
    shape = (num_pages, cfg.num_kv_heads, page, cfg.head_dim)
    if quantized:
        return PagedKV(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def quantize_kv(x):
    """Symmetric absmax int8 over the last axis: x (..., hd) -> (codes
    int8 (..., hd), scale f32 (...,)) with ``x ~= codes * scale``.  The
    JAX package's arithmetic, step for step in f32 (``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / KV_QMAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    return (q.float() * scale[..., None]).to(dtype)


def _page_write(cache: PagedKV, k, v, tables, positions, wmask=None):
    """Scatter (B, K) tokens' k/v into the shared pool, IN PLACE.

    k/v: (B, K, Hkv, hd); tables: (B, P) int32; positions: (B, K) int
    positions; ``wmask`` ((B, K) bool, optional) routes False tokens'
    writes to the PARK page instead (non-live rows' per-step decode
    writes land in garbage space without touching any request's pages).
    Lands where the JAX package's ``pool.at[pids, :, slots, :].set``
    does."""
    P = tables.shape[1]
    page = cache.k.shape[2]
    positions = positions.long()
    pidx = torch.clamp(positions // page, max=P - 1)       # parked rows
    pids = torch.gather(tables.long(), 1, pidx)
    if wmask is not None:
        pids = torch.where(wmask, pids, torch.full_like(pids, PARK_PAGE))
    slots = positions % page
    if cache.ks is not None:             # int8 pool: quantize on write
        k, ksc = quantize_kv(k)
        v, vsc = quantize_kv(v)
        cache.ks[pids, :, slots] = ksc
        cache.vs[pids, :, slots] = vsc
    cache.k[pids, :, slots, :] = k.to(cache.k.dtype)
    cache.v[pids, :, slots, :] = v.to(cache.v.dtype)
    return cache


def _gather_dequant(cache: PagedKV, tables, dtype):
    """Reference read of an int8 pool: codes and scales gathered through
    the tables and dequantized to ``dtype`` -> (kg, vg) (B, Hkv, P*page,
    hd).  Unwritten positions hold code 0 and read as 0.0."""
    kg = dequantize_kv(gather_pages(cache.k, tables),
                       gather_scales(cache.ks, tables), dtype)
    vg = dequantize_kv(gather_pages(cache.v, tables),
                       gather_scales(cache.vs, tables), dtype)
    return kg, vg


def attention_decode_pages(params, x, pos, cache: PagedKV, tables,
                           cfg: ArchConfig, wmask=None, shard=None):
    """One-step decode against the shared page pool.  x: (B, 1, D);
    pos: (B,) int32 (or scalar, broadcast); tables: (B, P) int32;
    ``wmask`` ((B,) bool, optional): False rows write to the park page.

    Write-then-read in the same order as ``attention_decode`` -- the new
    token's k/v land in its page first, then row b attends to its
    positions [0, pos[b]] through its table -- so live rows' outputs equal
    the row cache's.  ``shard`` (``(mesh, axis)``, optional) switches to
    per-shard local reads (``attention_decode_pages_sharded``).  Returns
    (out (B, 1, D), cache)."""
    if shard is not None:
        return attention_decode_pages_sharded(params, x, pos, cache, tables,
                                              cfg, shard, wmask=wmask)
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    positions = pos[:, None]
    q, k, v = _qkv(params, x, positions, cfg)              # q: (B, 1, H, hd)
    _page_write(cache, k, v, tables, positions,
                wmask=None if wmask is None else wmask[:, None])
    out = paged_decode_attention(q[:, 0], cache.k, cache.v, tables, pos,
                                 k_scale=cache.ks,
                                 v_scale=cache.vs)[:, None]
    return _out(params, out, x), cache


def attention_verify_pages(params, x, pos, cache: PagedKV, tables,
                           cfg: ArchConfig, wmask=None, offsets=None,
                           tree=None, shard=None):
    """K tokens per row against the shared page pool: x (B, K, D) at
    positions ``pos[b] .. pos[b]+K-1``.  Attention reads the pool as it
    stood BEFORE the block (through the tables; an int8 pool dequantized)
    plus the block's own k/v under an intra-block causal mask -- the same
    split as ``attention_verify`` -- then the K tokens' k/v are scattered
    into the rows' pages, IN PLACE (``wmask`` False tokens go to the park
    page).  A recycled page needs no zeroing: its owner writes each
    position before that position becomes readable (reads mask ``cols <
    pos``).

    ``offsets`` ((K,) int32, optional) replaces the ``arange(K)`` position
    offsets (RoPE and write slots) with per-node tree depths, and ``tree``
    ((B, K) int32 ancestor bitmasks) the causal mask: bit j of ``tree[b,
    i]`` makes block token j visible to block query i.  Siblings share a
    depth, so the caller parks all but one writer per depth through
    ``wmask``.  ``shard`` (``(mesh, axis)``, optional) switches to
    per-shard local reads (``attention_verify_pages_sharded``).  Returns
    (out (B, K, D), cache)."""
    if shard is not None:
        return attention_verify_pages_sharded(params, x, pos, cache, tables,
                                              cfg, shard, wmask=wmask,
                                              offsets=offsets, tree=tree)
    B, K, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    if offsets is None:
        offsets = torch.arange(K, dtype=torch.int32, device=x.device)
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=x.device)
    positions = pos[:, None] + offsets[None]
    q, k, v = _qkv(params, x, positions, cfg)              # q: (B, K, H, hd)
    out = paged_verify_attention(q, cache.k, cache.v, k, v, tables, pos,
                                 k_scale=cache.ks, v_scale=cache.vs,
                                 tree=tree)
    _page_write(cache, k, v, tables, positions, wmask=wmask)
    return _out(params, out, x), cache


# ---------------------------------------------------------------------------
# sharded page bank: per-shard LOCAL reads
#
# The functions above read the WHOLE bank through the page table.  The
# sharded paths below read it shard by shard instead: shard s of a mesh
# axis of N shards holds local pages [s*L, (s+1)*L) of the bank (L =
# NP/N; here a view of the one bank tensor), recovers its local index as
# ``table - s*L``, reads and writes ONLY the entries it owns, and the
# per-shard unnormalized flash partials (acc, m, l) merge with one
# pmax/psum.  The merged softmax is mathematically the global one, but
# the reduction ORDER differs, so local-read outputs are allclose to the
# global-read path, not bitwise equal.  Out-of-slice writes land in the
# shard's own reserved local page 0 (``ShardedPagePool`` never allocates
# any shard's local page 0), so no write crosses shards either.
# ---------------------------------------------------------------------------

def _local_pages(tables, num_local: int, shard: int):
    """Shard ``shard``'s view of the (B, P) page table -> (local_table,
    owned): ``owned`` marks the entries whose page lives on this shard,
    ``local_table`` holds their local indices (every other entry points
    at the shard's local park page 0)."""
    lt = tables.long() - shard * num_local
    owned = (lt >= 0) & (lt < num_local)
    return torch.where(owned, lt, torch.full_like(lt, PARK_PAGE)), owned


def _bank_slice(cache: PagedKV, shard: int, num_local: int) -> PagedKV:
    """Shard ``shard``'s slice of every bank leaf: views, so writes
    through it land in the bank."""
    sl = slice(shard * num_local, (shard + 1) * num_local)
    return PagedKV(*(None if t is None else t[sl] for t in cache))


def _paged_partial(q, kg, vg, valid, scale):
    """Unnormalized flash partial over ONE gathered bank slice.

    q: (B, K, H, hd); kg/vg: (B, Hkv, S, hd); valid: (B, K, S) bool (or a
    broadcastable (B, 1, S)) -> (acc (B, Hkv, K, G, hd) f32, m, l (B,
    Hkv, K, G) f32).  ``NEG_INF`` is finite, so a fully masked row has
    ``m == NEG_INF`` and ``exp(s - m) == 1`` there: re-masking ``p`` (not
    just ``s``) keeps that row's l and acc at exactly 0, which the
    cross-shard merge then ignores."""
    B, K, H, hd = q.shape
    Hkv = kg.shape[1]
    G = H // Hkv
    qh = q.reshape(B, K, Hkv, G, hd).permute(0, 2, 1, 3, 4).float()
    s = torch.einsum("bnigd,bnsd->bnigs", qh, kg.float()) * scale
    vmask = valid[:, None, :, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(vmask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bnigs,bnsd->bnigd", p, vg.float())
    return acc, m, p.sum(dim=-1)


def _psum_partials(accs, ms, ls):
    """Merge per-shard flash partials (lists in shard order): rescale
    every shard's (acc, l) to the global running max, then sum.  Returns
    the still unnormalized (acc, m, l)."""
    mg = pmax(ms)
    ws = [torch.exp(m.to(mg.device) - mg) for m in ms]
    return (psum([a.to(mg.device) * w[..., None] for a, w in zip(accs, ws)]),
            mg, psum([l.to(mg.device) * w for l, w in zip(ls, ws)]))


def _fold_block(acc, m, l, qh, kb, vb, scale, tree):
    """Fold the verify block's own K keys/values -- the same for every
    shard -- into the merged cache partial, then normalize.  qh: (B, Hkv,
    K, G, hd) f32; kb/vb: (B, K, Hkv, hd); ``tree`` ((B, K) int32
    ancestor bitmasks) replaces the intra-block causal mask.  With
    ``_psum_partials`` this is ``verify_reference``'s joint softmax in
    another reduction order."""
    kbh = kb.float().transpose(1, 2)                     # (B, Hkv, K, hd)
    vbh = vb.float().transpose(1, 2)
    K = kbh.shape[2]
    s = torch.einsum("bnigd,bnjd->bnigj", qh, kbh) * scale
    ar = torch.arange(K, device=qh.device)
    if tree is None:
        keep = (ar[None, :] <= ar[:, None])[None, None, :, None, :]
    else:
        t = torch.as_tensor(tree, device=qh.device).to(torch.int32)
        keep = (((t[:, :, None] >> ar.to(torch.int32)) & 1)
                == 1)[:, None, :, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m2 = torch.maximum(m, s.amax(dim=-1))
    pb = torch.where(keep, torch.exp(s - m2[..., None]), torch.zeros_like(s))
    l2 = l * torch.exp(m - m2) + pb.sum(dim=-1)
    acc2 = (acc * torch.exp(m - m2)[..., None]
            + torch.einsum("bnigj,bnjd->bnigd", pb, vbh))
    return acc2 / torch.clamp(l2, min=1e-30)[..., None]


def _heads_out(out, dt):
    """(B, Hkv, K, G, hd) f32 merged attention -> (B, K, H, hd) in the
    activation dtype."""
    out = out.permute(0, 2, 1, 3, 4)
    return out.reshape(out.shape[0], out.shape[1], -1, out.shape[-1]).to(dt)


def attention_decode_pages_sharded(params, x, pos, cache: PagedKV, tables,
                                   cfg: ArchConfig, shard, wmask=None):
    """``attention_decode_pages`` over a bank sharded on mesh axis
    ``shard = (mesh, axis)``.  Each shard first writes the new token into
    its own slice (a token whose page it does not own parks in its local
    page 0), then the B5 partial (``paged_decode_partial``) reads only
    its slice; the shards' partials merge with one pmax/psum.  Allclose,
    not bitwise, to the global-read path.  Returns (out (B, 1, D),
    cache), the bank written IN PLACE."""
    mesh, axis = shard
    n = mesh.shape[axis]
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    positions = pos[:, None]
    q, k, v = _qkv(params, x, positions, cfg)              # q: (B, 1, H, hd)
    NP, _, page, _ = cache.k.shape
    L = NP // n
    P = tables.shape[1]
    pidx = torch.clamp(positions.long() // page, max=P - 1)
    wm = None if wmask is None else wmask[:, None]
    accs, ms, ls = [], [], []
    for s in range(n):
        lc = _bank_slice(cache, s, L)
        lt, owned = _local_pages(tables, L, s)
        own_tok = torch.gather(owned, 1, pidx)                   # (B, 1)
        _page_write(lc, k, v, lt, positions,
                    wmask=own_tok if wm is None else own_tok & wm)
        acc, m, l = paged_decode_partial(q[:, 0], lc.k, lc.v, tables, pos,
                                         s * L, k_scale=lc.ks,
                                         v_scale=lc.vs)
        accs.append(acc[:, :, None])
        ms.append(m[:, :, None])
        ls.append(l[:, :, None])
    accg, _, lg = _psum_partials(accs, ms, ls)
    out = accg / torch.clamp(lg, min=1e-30)[..., None]
    return _out(params, _heads_out(out, x.dtype).to(x.device), x), cache


def attention_verify_pages_sharded(params, x, pos, cache: PagedKV, tables,
                                   cfg: ArchConfig, shard, wmask=None,
                                   offsets=None, tree=None):
    """``attention_verify_pages`` over a bank sharded on mesh axis
    ``shard = (mesh, axis)``: each shard reads its slice as it stood
    before the block (plain partials, ``_paged_partial``; JAX has no
    kernel here either) and then writes the block's tokens it owns; the
    partials merge with one pmax/psum and the block's own keys fold in
    once (``_fold_block``).  Allclose, not bitwise, to the global-read
    path.  Returns (out (B, K, D), cache), the bank written IN PLACE."""
    mesh, axis = shard
    n = mesh.shape[axis]
    B, K, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    if offsets is None:
        offsets = torch.arange(K, dtype=torch.int32, device=x.device)
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=x.device)
    positions = pos[:, None] + offsets[None]
    q, k, v = _qkv(params, x, positions, cfg)              # q: (B, K, H, hd)
    NP, Hkv, page, hd = cache.k.shape
    L = NP // n
    P = tables.shape[1]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    dt = x.dtype
    pidx = torch.clamp(positions.long() // page, max=P - 1)
    cols = torch.arange(P * page, device=x.device)[None, :]
    accs, ms, ls = [], [], []
    for s in range(n):
        lc = _bank_slice(cache, s, L)
        lt, owned = _local_pages(tables, L, s)
        if lc.ks is not None:
            kg, vg = _gather_dequant(lc, lt, dt)
        else:
            kg, vg = gather_pages(lc.k, lt), gather_pages(lc.v, lt)
        own_pos = owned.repeat_interleave(page, dim=1)            # (B, S)
        valid = ((cols < pos[:, None]) & own_pos)[:, None, :]
        acc, m, l = _paged_partial(q, kg, vg, valid, scale)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
        own_tok = torch.gather(owned, 1, pidx)                   # (B, K)
        _page_write(lc, k, v, lt, positions,
                    wmask=own_tok if wmask is None else own_tok & wmask)
    accg, mg, lg = _psum_partials(accs, ms, ls)
    qh = (q.reshape(B, K, Hkv, -1, hd).permute(0, 2, 1, 3, 4).float()
          * scale)
    out = _fold_block(accg, mg, lg, qh, k, v, 1.0, tree)
    return _out(params, _heads_out(out, dt).to(x.device), x), cache


def insert_pages(cache: PagedKV, rows: KVCache, tables) -> PagedKV:
    """Admission: scatter freshly prefilled cache rows (B, Hkv, S, hd)
    into the shared pool through (B, P) page tables (S == P*page), IN
    PLACE.  Dead table entries point at the park page, so the
    unconditional all-P scatter parks the rows' zero tails instead of
    touching anyone's pages.  Only the named pages change."""
    B, Hkv, S, hd = rows.k.shape
    P = tables.shape[1]
    page = cache.k.shape[2]
    if S != P * page:
        raise ValueError(f"row length {S} != {P} pages x {page}")
    t = tables.long()

    def paged_view(r):                     # (B, P, Hkv, page, hd)
        return r.reshape(B, Hkv, P, page, hd).permute(0, 2, 1, 3, 4)

    kr, vr = paged_view(rows.k), paged_view(rows.v)
    if cache.ks is not None:             # int8 pool: quantize on insert
        kr, ksc = quantize_kv(kr)
        vr, vsc = quantize_kv(vr)
        cache.ks[t] = ksc
        cache.vs[t] = vsc
    cache.k[t] = kr.to(cache.k.dtype)
    cache.v[t] = vr.to(cache.v.dtype)
    return cache


def copy_pages(cache: PagedKV, src, dst) -> PagedKV:
    """Page copy on the device, IN PLACE: ``pool[dst[i]] = pool[src[i]]``
    for every leaf of the pool (codes AND scales of an int8 pool -- a
    byte copy, never a re-quantization).  src/dst: (n,) page ids.

    This is the copy-on-write primitive of prefix sharing: a request
    whose first write would land in a shared page gets a private copy of
    that page BEFORE the write, so shared pages are never mutated and
    every reader keeps seeing bitwise the values its cold admission
    would have produced.  Plain indexing (``index_select`` then
    ``index_copy_``), stream-ordered before the next program that reads
    the pool."""
    src = torch.as_tensor(src, device=cache.k.device).long()
    dst = torch.as_tensor(dst, device=cache.k.device).long()
    for pool in cache:
        if pool is not None:
            pool.index_copy_(0, dst, pool.index_select(0, src))
    return cache
