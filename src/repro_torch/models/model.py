"""Dense decoder LM of the port (``family="dense"``).

Parameters are a plain dict of tensors, not captured by the model, so
the context-switching server can hand a step the weights of whichever
slot is active:

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V) unless tied,
     "blocks": [{"norm1", "attn": {"wq", "wk", "wv", "wo"},
                 "norm2", "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

``blocks`` holds one dict per layer: the JAX package's ``lax.scan`` over
stacked layer parameters is a Python loop here (``repro_torch.bridge``
unstacks JAX weights into this layout).  Caches are lists with one entry
per layer (``layers.KVCache`` rows or ``layers.PagedKV`` pools) and are
updated in place.

Execution modes:
  * ``forward``           — logits over the full sequence
  * ``prefill``           — builds the row cache, returns last-position logits
  * ``decode_step``       — one token against the row cache
  * ``decode_step_pages`` — one token against the shared page pool
  * ``verify_step``       — K tokens per row against the row cache
  * ``prefill_chunk``     — a prompt chunk into named rows of the row cache
  * ``verify_step_pages`` / ``prefill_chunk_pages`` — K tokens per row
                            against the shared page pool (chunked prefill)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.env import resolve_device, torch_dtype
from repro_torch.models import layers
from repro_torch.models.common import PSpec, init_params


class LM:
    def __init__(self, cfg: ArchConfig, cache_dtype=torch.bfloat16,
                 device=None):
        if cfg.family != "dense" or cfg.moe is not None:
            raise NotImplementedError(
                f"family {cfg.family!r} is not yet ported to repro_torch "
                "(dense decoders only)")
        if cfg.sliding_window:
            raise NotImplementedError(
                "sliding-window ring caches are not yet ported to "
                "repro_torch")
        self.cfg = cfg
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)          # activations

    # ------------------------------------------------------------------ specs
    def _block_specs(self) -> dict:
        d = self.cfg.d_model
        return {"norm1": PSpec((d,), init="ones"),
                "attn": layers.attn_specs(self.cfg),
                "norm2": PSpec((d,), init="ones"),
                "mlp": layers.mlp_specs(d, self.cfg.d_ff,
                                        self.cfg.mlp_gated)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict[str, Any] = {
            "embed": PSpec((cfg.vocab_size, cfg.d_model), init="scaled",
                           scale=0.02),
            "final_norm": PSpec((cfg.d_model,), init="ones"),
            "blocks": [self._block_specs() for _ in range(cfg.num_layers)],
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = PSpec((cfg.d_model, cfg.vocab_size),
                                     init="scaled", scale=0.02)
        return specs

    def init(self, seed: int = 0, dtype=None, device=None) -> dict:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device), in ``cfg.param_dtype`` unless ``dtype`` says
        otherwise, on the model's device unless ``device`` says
        otherwise."""
        dev = self.device if device is None else resolve_device(device)
        dtype = dtype or torch_dtype(self.cfg.param_dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(self.param_specs(), gen, dtype, dev)

    # ------------------------------------------------------------ embeddings
    def _embed_in(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return params["embed"][tokens].to(self.dtype)

    def _head(self, params, x):
        x = layers.rmsnorm(x, params["final_norm"].to(x.dtype),
                           self.cfg.norm_eps)
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["lm_head"])
        return (x @ w.to(x.dtype)).float()

    # --------------------------------------------------------------- blocks
    def _block(self, p, x, mix):
        """One block: ``mix(attn_params, h) -> a`` is the mode's attention
        (with its cache handling) applied to the normed input."""
        cfg = self.cfg
        h = layers.rmsnorm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
        x = x + mix(p["attn"], h)
        h2 = layers.rmsnorm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
        return x + layers.mlp({k: w.to(x.dtype)
                               for k, w in p["mlp"].items()}, h2)

    def _positions(self, x):
        B, S = x.shape[:2]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)

    # ---------------------------------------------------------------- modes
    def forward(self, params, tokens):
        """Logits (B, S, V) f32 over the whole sequence."""
        x = self._embed_in(params, tokens)
        positions = self._positions(x)
        for p in params["blocks"]:
            x = self._block(p, x, lambda ap, h: layers.attention(
                ap, h, positions, self.cfg))
        return self._head(params, x)

    def prefill(self, params, tokens, max_len: int):
        """Populate a fresh row cache.  Returns (last-position logits
        (B, 1, V), caches: one ``KVCache`` (B, Hkv, max_len, hd) per
        layer)."""
        x = self._embed_in(params, tokens)
        positions = self._positions(x)
        caches = []

        def mix(ap, h):
            a, c = layers.attention_prefill(ap, h, positions, self.cfg,
                                            max_len, self.cache_dtype)
            caches.append(c)
            return a

        for p in params["blocks"]:
            x = self._block(p, x, mix)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, caches, tokens, pos):
        """One decode step.  tokens: (B, 1) int; pos: scalar (whole batch
        at one position) or (B,) int32.  Writes the caches in place;
        returns (logits (B, 1, V), caches)."""
        x = self._embed_in(params, tokens)
        for p, c in zip(params["blocks"], caches):
            x = self._block(p, x, lambda ap, h, c=c: layers.attention_decode(
                ap, h, pos, c, self.cfg)[0])
        return self._head(params, x), caches

    def verify_step(self, params, caches, tokens, pos, wmask=None,
                    need_logits: bool = True):
        """Score K tokens per row in one pass.  tokens: (B, K) int at
        cache positions ``pos .. pos+K-1`` (pos: scalar or (B,) int32).
        Returns (logits (B, K, V), caches): ``logits[:, i]`` is what the
        i-th of K sequential ``decode_step`` calls would give, since each
        token reads the cache before the block plus the block's earlier
        tokens.  ``wmask`` ((B, K) bool, optional) keeps False tokens'
        k/v out of the cache; the logits are None when ``need_logits`` is
        False."""
        x = self._embed_in(params, tokens)
        for p, c in zip(params["blocks"], caches):
            x = self._block(p, x, lambda ap, h, c=c: layers.attention_verify(
                ap, h, pos, c, self.cfg, wmask=wmask)[0])
        return (self._head(params, x) if need_logits else None), caches

    def prefill_chunk(self, params, caches, tokens, pos, slots, wmask=None,
                      need_logits: bool = True):
        """Chunked prefill on the row cache: score a (b, C) prompt chunk
        at per-row offsets ``pos .. pos+C-1`` ((b,) int32) and write its
        k/v into batch rows ``slots`` ((b,) int) of ``caches``.  The
        named rows are gathered, rows at ``pos == 0`` zeroed (chunk 0
        starts from the blank row a fresh ``prefill`` makes: a recycled
        slot's stale row must not leak into the new request), the
        chunk runs through ``verify_step``, and the rows are written
        back: only the named rows change.  ``wmask`` keeps a final
        chunk's pad tokens out of the cache.  Returns (logits (b, C, V)
        f32, or None when ``need_logits`` is False, caches)."""
        dev = self.device
        slots = torch.as_tensor(slots, device=dev).long()
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        fresh = (pos == 0).view(-1, 1, 1, 1)
        sub = [layers.KVCache(k=c.k[slots].masked_fill_(fresh, 0),
                              v=c.v[slots].masked_fill_(fresh, 0))
               for c in caches]
        logits, _ = self.verify_step(params, sub, tokens, pos, wmask,
                                     need_logits)
        for c, r in zip(caches, sub):
            c.k[slots] = r.k
            c.v[slots] = r.v
        return logits, caches

    # ------------------------------------------------------------- row cache
    def init_cache(self, batch: int, max_len: int) -> list:
        return [layers.init_kv_cache(self.cfg, batch, max_len,
                                     self.cache_dtype, self.device)
                for _ in range(self.cfg.num_layers)]

    def insert_cache_rows(self, caches, rows, slots):
        """Per-slot cache admission, in place: write ``rows`` (per-layer
        caches of b requests) into batch rows ``slots`` ((b,) int) of
        ``caches``.  Only the named rows change -- a freed slot is
        recycled by overwriting it with a fresh prefill, so admission
        never disturbs in-flight requests."""
        slots = torch.as_tensor(slots, device=self.device).long()
        for c, r in zip(caches, rows):
            c.k[slots] = r.k.to(c.k.dtype)
            c.v[slots] = r.v.to(c.v.dtype)
        return caches

    # ------------------------------------------------------- paged slot pool
    def init_page_pool(self, num_pages: int, page: int,
                       quantized: bool = False) -> list:
        """Shared-page decode cache: one ``layers.PagedKV`` pool (NP, Hkv,
        page, hd) per layer.  Page 0 is the PARK page; the page table is
        shared across layers -- page id p is the same position range of
        its owning row in every layer's pool.  ``quantized`` stores int8
        codes plus (NP, Hkv, page) f32 scales: about half the bytes per
        page of a bf16 pool."""
        return [layers.init_page_pool(self.cfg, num_pages, page,
                                      self.cache_dtype, self.device,
                                      quantized=quantized)
                for _ in range(self.cfg.num_layers)]

    def insert_cache_pages(self, caches, rows, tables):
        """Admission into the page pool, in place: scatter prefilled rows
        (per-layer ``KVCache`` (b, Hkv, S, hd)) through the admitted rows'
        (b, P) page tables, quantizing them for an int8 pool.  Only the
        named pages (and the park page) change."""
        tables = torch.as_tensor(tables, device=self.device)
        for c, r in zip(caches, rows):
            layers.insert_pages(c, r, tables)
        return caches

    def decode_step_pages(self, params, caches, tokens, pos, tables,
                          live=None):
        """One decode step against the shared page pool.  tokens: (B, 1)
        int; pos: (B,) int32; tables: (B, P) int32; ``live`` ((B,) bool,
        optional) routes non-live rows' cache writes to the park page.
        Returns (logits (B, 1, V), caches)."""
        x = self._embed_in(params, tokens)
        for p, c in zip(params["blocks"], caches):
            x = self._block(
                p, x, lambda ap, h, c=c: layers.attention_decode_pages(
                    ap, h, pos, c, tables, self.cfg, wmask=live)[0])
        return self._head(params, x), caches

    def verify_step_pages(self, params, caches, tokens, pos, tables,
                          wmask=None, need_logits: bool = True,
                          offsets=None, tree=None):
        """K tokens per row against the shared page pool: the (b, K)
        block at per-row offsets ``pos .. pos+K-1`` through the rows'
        (b, P) page tables, k/v written into the rows' own pages (False
        ``wmask`` tokens to the park page).  Unlike ``prefill_chunk`` no
        whole row moves and nothing is zeroed: a recycled page is
        rewritten before any of its positions is read.  ``offsets`` /
        ``tree`` select tree verification (see
        ``layers.attention_verify_pages``).  Returns (logits (b, K, V) f32
        or None, caches)."""
        tables = torch.as_tensor(tables, device=self.device)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        x = self._embed_in(params, tokens)
        for p, c in zip(params["blocks"], caches):
            x = self._block(
                p, x, lambda ap, h, c=c: layers.attention_verify_pages(
                    ap, h, pos, c, tables, self.cfg, wmask=wmask,
                    offsets=offsets, tree=tree)[0])
        return (self._head(params, x) if need_logits else None), caches

    # chunked admission is the verify pass pointed at the page pool
    prefill_chunk_pages = verify_step_pages


def build_model(cfg: ArchConfig, cache_dtype=torch.bfloat16,
                device=None) -> LM:
    return LM(cfg, cache_dtype=cache_dtype, device=device)
