"""Decoder LM of the port: the dense family, sliding-window MoE
(``mixtral-8x7b``), the Mamba + MoE hybrid (``jamba-v0.1-52b``) and the
recurrent xLSTM (``xlstm-125m``).

Every architecture is a *period* of block kinds (``block_pattern``):
dense and MoE models one (attention + MLP or MoE FFN), jamba eight
(attention at index 4, Mamba elsewhere; MoE at odd indices, MLP at even
ones), xLSTM ``slstm_every`` (mLSTM blocks, the last one sLSTM; no FFN
after the mixer).  Parameters are a plain dict of tensors, not captured
by the model, so the context-switching server can hand a step the
weights of whichever slot is active:

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V) unless tied,
     "blocks": [{"norm1", "attn" | "mamba" | "mlstm" | "slstm": {...},
                 "norm2", "mlp" | "moe": {...} unless the ffn is none},
                ...]}

``blocks`` holds one dict per layer, layer l of kind ``pattern[l % P]``:
the JAX package's ``lax.scan`` over stacked period parameters is a
Python loop here (``repro_torch.bridge`` unstacks JAX weights into this
layout).  Caches are lists with one entry per layer (``layers.KVCache``
rows -- a ring for a sliding window --, ``ssm.SSMState`` for a Mamba
layer, ``xlstm.MLSTMState`` / ``xlstm.SLSTMState`` for an xLSTM layer,
or ``layers.PagedKV`` pools) and are updated in place.

Execution modes:
  * ``forward``           — logits over the full sequence
  * ``hidden``            — the final normed states over the full sequence
  * ``prefill``           — builds the row cache, returns last-position logits
  * ``decode_step``       — one token against the row cache
  * ``decode_step_pages`` — one token against the shared page pool
  * ``decode_multi_step`` / ``decode_multi_step_pages`` — T decode steps
                            in one device program, no host sync inside
  * ``verify_step``       — K tokens per row against the row cache (a
                            recurrent layer scans them from its carried
                            state)
  * ``prefill_chunk``     — a prompt chunk into named rows of the row cache
  * ``verify_step_pages`` / ``prefill_chunk_pages`` — K tokens per row
                            against the shared page pool (chunked prefill)
Chunked prefill and the page pool take all-attention, full-attention
models only (the JAX engine's rule).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.env import resolve_device, torch_dtype
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.common import PSpec, init_params

_FAMILIES = ("dense", "moe", "hybrid", "ssm")   # families the port serves


def block_pattern(cfg: ArchConfig) -> list[tuple[str, str]]:
    """The period of (mixer, ffn) block kinds: mixer ``attn``, ``mamba``,
    ``mlstm`` or ``slstm``, ffn ``mlp``, ``moe`` or ``none``."""
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return [("slstm" if cfg.is_slstm_layer(i) else "mlstm", "none")
                for i in range(cfg.xlstm.slstm_every)]
    if cfg.family == "hybrid":
        period = cfg.attn_every
        if cfg.moe is not None:
            period = math.lcm(cfg.attn_every, cfg.moe.every)
        return [("attn" if cfg.is_attention_layer(i) else "mamba",
                 "moe" if cfg.is_moe_layer(i) else "mlp")
                for i in range(period)]
    return [("attn", "moe" if cfg.moe is not None else "mlp")]


def _block_specs(cfg: ArchConfig, typ: tuple[str, str]) -> dict:
    mixer, ffn = typ
    d = cfg.d_model
    out: dict[str, Any] = {"norm1": PSpec((d,), init="ones")}
    out[mixer] = {"attn": layers.attn_specs, "mamba": ssm_mod.ssm_specs,
                  "mlstm": xl.mlstm_specs, "slstm": xl.slstm_specs}[mixer](cfg)
    if ffn == "none":
        return out
    out["norm2"] = PSpec((d,), init="ones")
    if ffn == "mlp":
        out["mlp"] = layers.mlp_specs(d, cfg.d_ff, cfg.mlp_gated)
    else:
        out["moe"] = moe_mod.moe_specs(cfg)
    return out


class LM:
    """``mlstm_mode`` picks the mLSTM form of ``forward`` and ``prefill``:
    ``auto`` (``_mlstm_train_mode``), ``parallel`` or ``chunkwise``.
    ``mesh`` (a ``repro_torch.distributed.mesh.Mesh``) and
    ``moe_strategy`` pick the MoE layers' strategy as
    ``moe.moe_apply`` does: with ``auto``, expert-parallel over a mesh of
    several shards when the experts and the sequence split over it,
    tensor-parallel when they do not, the dense reference without a
    mesh.  The mesh's shards must share the model's device."""

    def __init__(self, cfg: ArchConfig, cache_dtype=torch.bfloat16,
                 device=None, mlstm_mode: str = "auto", mesh=None,
                 moe_strategy: str = "auto"):
        if (cfg.family not in _FAMILIES
                or (cfg.family == "ssm") != (cfg.xlstm is not None)
                or cfg.frontend.kind != "none"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not yet ported to repro_torch "
                f"(ported: {', '.join(_FAMILIES)}, the ssm family as "
                "xLSTM only, without a modality frontend)")
        if mlstm_mode not in ("auto", "parallel", "chunkwise"):
            raise ValueError(f"unknown mlstm_mode {mlstm_mode!r}")
        self.cfg = cfg
        self.mlstm_mode = mlstm_mode
        self.pattern = block_pattern(cfg)
        if cfg.num_layers % len(self.pattern):
            raise ValueError(
                f"num_layers {cfg.num_layers} is not a whole number of "
                f"{len(self.pattern)}-layer periods")
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)          # activations
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh {mesh} lies on {mesh.device}, the "
                             f"model on {self.device}")
        self.mesh = mesh
        self.moe_strategy = moe_strategy

    def kind(self, layer: int) -> tuple[str, str]:
        """(mixer, ffn) of layer ``layer``."""
        return self.pattern[layer % len(self.pattern)]

    # ------------------------------------------------------------------ specs
    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict[str, Any] = {
            "embed": PSpec((cfg.vocab_size, cfg.d_model), init="scaled",
                           scale=0.02),
            "final_norm": PSpec((cfg.d_model,), init="ones"),
            "blocks": [_block_specs(cfg, self.kind(i))
                       for i in range(cfg.num_layers)],
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
    def _mlstm_train_mode(self, L: int) -> str:
        """The mLSTM form of a forward or prefill over L tokens: chunkwise
        (the kernel) once L is a whole number of two or more chunks,
        else the quadratic parallel form."""
        if self.mlstm_mode != "auto":
            return self.mlstm_mode
        c = self.cfg.xlstm.chunk_size
        return "chunkwise" if (L % c == 0 and L > c) else "parallel"

    def _recurrent(self, mixer, p, h, mode, cache, commit=None):
        """A Mamba, mLSTM or sLSTM mixer.  Forward and prefill start from
        no history and return the final state; decode and verify run the
        L tokens recurrently from ``cache`` and write it in place --
        unless ``commit`` (a () bool tensor) is False: then every state
        leaf is written back as it was (a fused step that does not
        commit must leave the states alone; attention writes need no
        gate, since a frozen step rewrites the same k/v at the same
        position)."""
        cfg = self.cfg
        if mode not in ("decode", "verify"):
            if mixer == "mamba":
                return ssm_mod.mamba_forward(p["mamba"], h, cfg)
            if mixer == "mlstm":
                return xl.mlstm_block(p["mlstm"], h, cfg,
                                      mode=self._mlstm_train_mode(h.shape[1]))
            return xl.slstm_block(p["slstm"], h, cfg)
        if mixer == "mamba":
            a, st = ssm_mod.mamba_decode(p["mamba"], h, cache, cfg)
        elif mixer == "mlstm":
            a, st = xl.mlstm_block(p["mlstm"], h, cfg, mode="recurrent",
                                   state=cache)
        else:
            a, st = xl.slstm_block(p["slstm"], h, cfg, state=cache)
        for dst, src in zip(cache, st):
            dst.copy_(src if commit is None
                      else torch.where(commit, src, dst))
        return a, cache

    def _mixer(self, i, p, h, mode, cache, pos=None, positions=None,
               max_len=None, wmask=None, tables=None, offsets=None,
               tree=None, shard=None, commit=None):
        """Layer ``i``'s mixer on the normed input ``h`` under ``mode``
        (forward | prefill | decode | verify) -> (out, cache).  Prefill
        returns the layer's fresh cache; decode and verify write
        ``cache`` in place.  A recurrent layer runs the same call for
        decode and verify (L == K block tokens after the carried state);
        ``tables`` switches attention to the page pool and ``shard``
        (``(mesh, axis)``) to per-shard local reads of it; ``commit``
        gates a recurrent layer's state write (``_recurrent``)."""
        cfg = self.cfg
        mixer = self.kind(i)[0]
        if mixer != "attn":
            return self._recurrent(mixer, p, h, mode, cache, commit)
        ap = p["attn"]
        if mode == "forward":
            return layers.attention(ap, h, positions, cfg), None
        if mode == "prefill":
            return layers.attention_prefill(ap, h, positions, cfg, max_len,
                                            self.cache_dtype)
        if tables is not None:
            if mode == "decode":
                return layers.attention_decode_pages(ap, h, pos, cache,
                                                     tables, cfg,
                                                     wmask=wmask,
                                                     shard=shard)
            return layers.attention_verify_pages(ap, h, pos, cache, tables,
                                                 cfg, wmask=wmask,
                                                 offsets=offsets, tree=tree,
                                                 shard=shard)
        if mode == "decode":
            return layers.attention_decode(ap, h, pos, cache, cfg)
        return layers.attention_verify(ap, h, pos, cache, cfg, wmask=wmask)

    def _run(self, params, x, mode, caches=None, **kw):
        """Every layer in order: x + mixer(norm1(x)), then x +
        ffn(norm2(x)) unless the layer has no FFN.  -> (x, the mixers'
        caches, one per layer).  The MoE aux loss is a training term and
        is dropped here, as the JAX package's serving modes drop it."""
        cfg = self.cfg
        out = []
        for i, p in enumerate(params["blocks"]):
            h = layers.rmsnorm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
            a, c = self._mixer(i, p, h, mode,
                               None if caches is None else caches[i], **kw)
            out.append(c)
            x = x + a
            if "norm2" not in p:                   # xLSTM: no FFN
                continue
            h2 = layers.rmsnorm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
            if "moe" in p:
                f, _ = moe_mod.moe_apply(p["moe"], h2, cfg, self.mesh,
                                         self.moe_strategy)
            else:
                f = layers.mlp({k: w.to(x.dtype)
                                for k, w in p["mlp"].items()}, h2)
            x = x + f
        return x, out

    def _positions(self, x):
        B, S = x.shape[:2]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)

    # ---------------------------------------------------------------- modes
    def forward(self, params, tokens):
        """Logits (B, S, V) f32 over the whole sequence."""
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "forward",
                         positions=self._positions(x))
        return self._head(params, x)

    def hidden(self, params, tokens):
        """Final hidden states (B, S, d) before the head, in the
        activation dtype: the Super-Sub classifiers pool them.  The JAX
        package's ``hidden`` also returns the MoE aux loss, a training
        term; ``_run`` drops it, so only the states come back."""
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "forward",
                         positions=self._positions(x))
        return layers.rmsnorm(x, params["final_norm"].to(x.dtype),
                              self.cfg.norm_eps)

    def prefill(self, params, tokens, max_len: int):
        """Populate a fresh row cache.  Returns (last-position logits
        (B, 1, V), caches: per layer a ``KVCache`` (B, Hkv, S, hd) --
        S = max_len, or a ring's min(max_len, window) -- or a recurrent
        layer's state)."""
        x = self._embed_in(params, tokens)
        x, caches = self._run(params, x, "prefill",
                              positions=self._positions(x),
                              max_len=max_len)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, caches, tokens, pos, commit=None):
        """One decode step.  tokens: (B, 1) int; pos: scalar (whole batch
        at one position) or (B,) int32.  Writes the caches in place
        (recurrent states only where ``commit``, a () bool tensor, is
        True, when given); returns (logits (B, 1, V), caches)."""
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "decode", caches, pos=pos,
                         commit=commit)
        return self._head(params, x), caches

    def verify_step(self, params, caches, tokens, pos, wmask=None,
                    need_logits: bool = True):
        """Score K tokens per row in one pass.  tokens: (B, K) int at
        cache positions ``pos .. pos+K-1`` (pos: scalar or (B,) int32).
        Returns (logits (B, K, V), caches): ``logits[:, i]`` is what the
        i-th of K sequential ``decode_step`` calls would give, since each
        token reads the cache before the block plus the block's earlier
        tokens (across a ring's wrap too), and a recurrent layer scans
        the K tokens from its carried state.  ``wmask`` ((B, K) bool,
        optional) keeps False tokens' k/v out of an attention cache; the
        logits are None when ``need_logits`` is False."""
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "verify", caches, pos=pos, wmask=wmask)
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
        chunk's pad tokens out of the cache.  All-attention, full
        attention models only (every engine refuses the others).
        Returns (logits (b, C, V) f32, or None when ``need_logits`` is
        False, caches)."""
        if (any(mix != "attn" for mix, _ in self.pattern)
                or self.cfg.sliding_window):
            raise NotImplementedError(
                "chunked prefill of ring and recurrent models is not yet "
                "ported to repro_torch (the engines refuse it)")
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
        """Per layer a zero ``KVCache`` (a ring of min(max_len, window)
        slots for a sliding window), ``SSMState``, ``MLSTMState`` or
        ``SLSTMState``; recurrent states are f32 but for their conv
        inputs, which take ``cache_dtype``."""
        cfg, dt, dev = self.cfg, self.cache_dtype, self.device

        def one(mixer):
            if mixer == "attn":
                return layers.init_kv_cache(cfg, batch, max_len, dt, dev)
            if mixer == "mamba":
                return ssm_mod.init_ssm_state(cfg, batch, dt, dev)
            if mixer == "mlstm":
                return xl.init_mlstm_state(cfg, batch, dt, dev)
            return xl.init_slstm_state(cfg, batch, dev)
        return [one(self.kind(i)[0]) for i in range(cfg.num_layers)]

    def insert_cache_rows(self, caches, rows, slots):
        """Per-slot cache admission, in place: write ``rows`` (per-layer
        caches of b requests) into batch rows ``slots`` ((b,) int) of
        ``caches``, every leaf (k/v, or a recurrent state's), cast to the
        leaf's own dtype (f32 stays f32).  Only the named rows change --
        a freed slot is recycled by overwriting it with a fresh prefill,
        so admission never disturbs in-flight requests."""
        slots = torch.as_tensor(slots, device=self.device).long()
        for c, r in zip(caches, rows):
            for dst, src in zip(c, r):
                dst[slots] = src.to(dst.dtype)
        return caches

    # ------------------------------------------------------- paged slot pool
    def _require_paged_support(self):
        if any(mix != "attn" for mix, _ in self.pattern):
            raise ValueError(
                "the paged page pool needs an all-attention model "
                "(recurrent mixers keep per-row state, not pages)")
        if self.cfg.sliding_window:
            raise ValueError(
                "the paged page pool needs full (non-ring) attention: "
                "ring slots alias positions a page table cannot express")

    def init_page_pool(self, num_pages: int, page: int,
                       quantized: bool = False) -> list:
        """Shared-page decode cache: one ``layers.PagedKV`` pool (NP, Hkv,
        page, hd) per layer.  Page 0 is the PARK page; the page table is
        shared across layers -- page id p is the same position range of
        its owning row in every layer's pool.  ``quantized`` stores int8
        codes plus (NP, Hkv, page) f32 scales: about half the bytes per
        page of a bf16 pool."""
        self._require_paged_support()
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

    def copy_cache_pages(self, caches, src, dst):
        """Copy-on-write support, in place: duplicate pool pages ``src[i]``
        into ``dst[i]`` in every layer's pool (all leaves -- int8 codes
        and their scales move together).  The page table is shared by
        the layers, so one (src, dst) pair names the same position range
        in every pool; nothing outside ``dst`` changes."""
        for c in caches:
            layers.copy_pages(c, src, dst)
        return caches

    def decode_step_pages(self, params, caches, tokens, pos, tables,
                          live=None, shard=None, commit=None):
        """One decode step against the shared page pool.  tokens: (B, 1)
        int; pos: (B,) int32; tables: (B, P) int32; ``live`` ((B,) bool,
        optional) routes non-live rows' cache writes to the park page.
        ``shard`` (``(mesh, axis)``) makes each mesh shard read and write
        only its slice of the pool, merging the shards' partial softmaxes
        (``layers.attention_decode_pages_sharded``).  ``commit`` as in
        ``decode_step``.  Returns (logits (B, 1, V), caches)."""
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "decode", caches, pos=pos,
                         tables=tables, wmask=live, shard=shard,
                         commit=commit)
        return self._head(params, x), caches

    def verify_step_pages(self, params, caches, tokens, pos, tables,
                          wmask=None, need_logits: bool = True,
                          offsets=None, tree=None, shard=None):
        """K tokens per row against the shared page pool: the (b, K)
        block at per-row offsets ``pos .. pos+K-1`` through the rows'
        (b, P) page tables, k/v written into the rows' own pages (False
        ``wmask`` tokens to the park page).  Unlike ``prefill_chunk`` no
        whole row moves and nothing is zeroed: a recycled page is
        rewritten before any of its positions is read.  ``offsets`` /
        ``tree`` select tree verification (see
        ``layers.attention_verify_pages``); ``shard`` per-shard local
        reads, as in ``decode_step_pages``.  Returns (logits (b, K, V)
        f32 or None, caches)."""
        tables = torch.as_tensor(tables, device=self.device)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        x = self._embed_in(params, tokens)
        x, _ = self._run(params, x, "verify", caches, pos=pos,
                         tables=tables, wmask=wmask, offsets=offsets,
                         tree=tree, shard=shard)
        return (self._head(params, x) if need_logits else None), caches

    # chunked admission is the verify pass pointed at the page pool
    prefill_chunk_pages = verify_step_pages

    # ------------------------------------------------------ multi-step decode
    def _decode_multi(self, params, caches, tokens, pos, steps, sample_fn,
                      stop_fn, live=None, pos_cap=None, tables=None,
                      shard=None, commit=None):
        """``steps`` decode steps in ONE device program, with no host sync
        (``StepEngine(multi_step=T)`` captures it as one CUDA graph).

        Each step runs the SAME ``decode_step`` / ``decode_step_pages``
        body a single-step engine runs, then ``nxt = sample_fn(last
        logits, pos, i)`` (the engine's own sampling rule) and ``stop =
        stop_fn(nxt, advanced pos, i)``, a () bool that is True the
        moment ANY slot would change occupancy.  JAX's loop exits there;
        a graph cannot leave its loop, so every step runs and a device
        flag ``active`` decides which commit: step i commits while no
        earlier step raised ``stop`` (step 0 always, unless ``commit``,
        a () bool, is False: then none does).  A step that does not
        commit leaves every state as it was: tok and pos stay frozen, so
        its attention writes rewrite the same k/v at the same position
        (row, ring, bf16 and int8 pages alike), and the recurrent states
        are gated by ``active``.

        ``pos_cap`` clamps the advanced positions (the single-step
        engine's run-off guard); ``stop_fn`` sees them unclamped.
        Returns ``(out (B, steps) int32, n () int32, caches, tok (B, 1),
        pos (B,))``, all on the device: only ``out[:, :n]`` is
        meaningful, and tok and pos are those after the n committed
        steps."""
        dev = self.device
        active = (torch.ones((), dtype=torch.bool, device=dev)
                  if commit is None else commit)
        tok = torch.as_tensor(tokens, device=dev).to(torch.int32)
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        n = torch.zeros((), dtype=torch.int32, device=dev)
        outs = []
        for i in range(steps):
            if tables is None:
                logits, caches = self.decode_step(params, caches, tok, pos,
                                                  commit=active)
            else:
                logits, caches = self.decode_step_pages(
                    params, caches, tok, pos, tables, live=live,
                    shard=shard, commit=active)
            nxt = sample_fn(logits[:, -1], pos, i)
            posr = pos + 1 if live is None else torch.where(live, pos + 1,
                                                            pos)
            stop = stop_fn(nxt, posr, i)
            if pos_cap is not None:
                posr = torch.clamp(posr, max=pos_cap)
            outs.append(nxt)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
            pos = torch.where(active, posr, pos)
            n = n + active.to(torch.int32)
            active = active & ~stop
        return torch.stack(outs, dim=1), n, caches, tok, pos

    def decode_multi_step(self, params, caches, tokens, pos, steps,
                          sample_fn, stop_fn, live=None, pos_cap=None,
                          commit=None):
        """Row-cache multi-step decode; see ``_decode_multi``."""
        return self._decode_multi(params, caches, tokens, pos, steps,
                                  sample_fn, stop_fn, live=live,
                                  pos_cap=pos_cap, commit=commit)

    def decode_multi_step_pages(self, params, caches, tokens, pos, tables,
                                steps, sample_fn, stop_fn, live=None,
                                pos_cap=None, shard=None, commit=None):
        """Paged multi-step decode; see ``_decode_multi``.  ``tables``
        stays as it is over the steps: occupancy changes only at a
        ``stop``, after which nothing commits."""
        return self._decode_multi(params, caches, tokens, pos, steps,
                                  sample_fn, stop_fn, live=live,
                                  pos_cap=pos_cap,
                                  tables=torch.as_tensor(tables,
                                                         device=self.device),
                                  shard=shard, commit=commit)


def build_model(cfg: ArchConfig, cache_dtype=torch.bfloat16,
                device=None, mesh=None) -> LM:
    return LM(cfg, cache_dtype=cache_dtype, device=device, mesh=mesh)
