"""Context-switching serving — the paper's architecture applied to the
serving tier.

``SwitchableServer`` keeps N model contexts behind a ``ContextSwitchEngine``:
the active model serves batched requests while the next model's weights
stream into the shadow slot; switching models is an O(1) activation flip.
Which context loads/evicts when is decided by the engine's shared
``ReconfigPolicy`` — the same object the analytical simulator runs.

One ``ServingEngine`` is cached per context and one ``StepEngine`` per
(context, pool shape); sampling threads a fresh per-request seed so
temperature>0 requests are independent draws.  Shared page banks
(``shared_bank``) put one page pool, prefix index and cache behind every
engine of one context's cache content, and one ``SpecEngine`` is cached
per (target, draft, configuration).  The JAX package's state snapshots
are not ported yet.

For request-level scheduling (queueing, coalescing, shadow-slot prefetch
under mixed traffic) see ``repro_torch.serve.scheduler``.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.context import ContextDescriptor, ContextSwitchEngine
from repro_torch.core.policy import ReconfigPolicy
from repro_torch.distributed.mesh import shard_count
from repro_torch.models.model import LM
from repro_torch.serve.engine import (EngineKey, GumbelDraws, ServingEngine,
                                      StepEngine, _sample)
from repro_torch.serve.pool import PagePool, SharedBank, ShardedPagePool
from repro_torch.serve.speculative import SpecEngine, SpecKey
from repro_torch.serve.telemetry import Telemetry


@dataclass
class ServedModel:
    name: str
    model: LM
    weights_fn: Callable[[], Any]
    max_len: int = 256
    temperature: float = 0.0


class SwitchableServer:
    def __init__(self, num_slots: int = 2, device=None,
                 policy: Optional[ReconfigPolicy] = None,
                 telemetry: Optional[Telemetry] = None):
        # one shared registry/tracer/clock for the whole serving stack:
        # the context engine writes ``ctx.*``, each pooled engine gets
        # ``eng.<i>.*``, schedulers write ``sched.*``, and request-level
        # histograms land unprefixed — one snapshot sees every layer
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.engine = ContextSwitchEngine(num_slots=num_slots, device=device,
                                          policy=policy,
                                          telemetry=self.telemetry)
        self.device = self.engine.device
        self._served: dict[str, ServedModel] = {}
        self._engines: dict[str, ServingEngine] = {}   # one per context
        # shared page banks, keyed by CONTENT -- (context name, page_size,
        # quantize_kv) -- never by pool shape: every engine whose pages
        # would hold the same bytes (any batch size) resolves to the same
        # bank, so a prefix one engine indexed is a hit for all of them
        self._banks: dict[tuple, SharedBank] = {}
        self._step_engines: dict[EngineKey, StepEngine] = {}
        self._spec_engines: dict[SpecKey, SpecEngine] = {}
        self._eng_seq = itertools.count()   # telemetry namespace ids
        self._req_seq = itertools.count()
        self.log: list[dict] = []

    # ------------------------------------------------------------------
    def register(self, sm: ServedModel):
        if sm.model.device != self.device:
            raise ValueError(f"model {sm.name!r} lives on "
                             f"{sm.model.device}, the server on "
                             f"{self.device}")
        self._served[sm.name] = sm

        def apply_fn(params, tokens, seed):
            """One-token service: prefill + the first token, sampled from
            the same draw a fresh engine's t=0 admission makes."""
            logits, _ = sm.model.prefill(params, tokens, sm.max_len)
            last = logits[:, -1]
            g = None
            if sm.temperature > 0.0:
                draws = GumbelDraws(sm.model.device)
                draws.reset(seed)
                g = draws.field(draws.admit_key(), tuple(last.shape))
            return _sample(last, sm.temperature, g).cpu().numpy()

        self.engine.register(ContextDescriptor(
            name=sm.name, apply_fn=apply_fn, weights_fn=sm.weights_fn))

    def served(self) -> list[str]:
        return list(self._served)

    def preload(self, name: str, block: bool = False):
        return self.engine.preload(name, block=block)

    def next_seed(self) -> int:
        """Monotonic per-request sampling seed (identical prompts at
        temperature>0 must be independent draws, not clones)."""
        return next(self._req_seq)

    def _serving_engine(self, name: str, params) -> ServingEngine:
        """Per-context ServingEngine cache: reused across every request
        and every switch — only the params pointer is refreshed (the slot
        may have been evicted and reloaded since)."""
        eng = self._engines.get(name)
        if eng is None:
            sm = self._served[name]
            eng = ServingEngine(sm.model, params, sm.max_len, sm.temperature,
                                telemetry=self.telemetry.scoped(
                                    f"eng.{next(self._eng_seq)}."))
            self._engines[name] = eng
        else:
            eng.params = params
        return eng

    def shared_bank(self, name: str, page_size: int,
                    quantize_kv: Optional[str] = None,
                    num_pages: Optional[int] = None,
                    num_shards: int = 1) -> SharedBank:
        """Get-or-create the shared page bank of one cache content --
        ``(context name, page_size, quantize_kv)``.  The first caller
        sizes the pool (``num_pages``, and ``num_shards`` > 1 for a
        sharded bank); later callers allocate from it whatever their
        batch size, and all of them see one ``PrefixIndex`` over those
        pages and one set of cache tensors (made by the first engine's
        reset)."""
        key = (name, int(page_size), quantize_kv)
        bank = self._banks.get(key)
        if bank is None:
            if num_pages is None:
                raise ValueError(
                    f"shared bank {key} does not exist yet: the first "
                    "caller must size it (num_pages)")
            tel = self.telemetry.scoped(f"eng.{next(self._eng_seq)}.")
            pool = (ShardedPagePool(num_pages, num_shards, telemetry=tel)
                    if num_shards > 1 else PagePool(num_pages,
                                                   telemetry=tel))
            bank = SharedBank(pool)
            self._banks[key] = bank
        elif num_shards != bank.pool.num_shards:
            raise ValueError(
                f"shared bank {key} has {bank.pool.num_shards} shard(s); "
                f"requested {num_shards}")
        return bank

    def step_engine(self, name: str, batch_size: int,
                    prefill_chunk: Optional[int] = None,
                    paged: bool = False, page_size: int = 256,
                    quantize_kv: Optional[str] = None,
                    shards: Optional[int] = None,
                    mesh=None, multi_step: int = 1,
                    prefix_cache: bool = False,
                    num_pages: Optional[int] = None,
                    share_bank: bool = False) -> StepEngine:
        """Per-context continuous-batching engine (one per configuration).
        Its decode state — slot-pooled KV rows or pages, positions,
        free-list — persists across context switches, so a paused context
        resumes exactly where its last step left off; weights are NOT
        captured (every call runs against the engine slot's current
        buffers via the scheduler's runner hook).  Every engine knob is a
        field of the frozen ``EngineKey``: chunked and one-shot, int8 and
        full-precision engines of one context are different engines.
        ``shards``/``mesh`` split the engine's page bank,
        ``multi_step`` fuses up to that many decode steps into each tick,
        ``prefix_cache`` shares written prompt pages across admissions
        (see ``StepEngine``).  ``share_bank`` allocates from the
        context's shared bank (``shared_bank``), which the first such
        engine sizes: ``num_pages``, or by default one worst-case row per
        slot plus the park page(s), as a private bank is sized."""
        sm = self._served[name]
        eff_ps = min(page_size, sm.max_len) if paged else None
        n_shards = shard_count(shards, mesh)
        key = EngineKey(name=name, batch_size=batch_size,
                        prefill_chunk=prefill_chunk, page_size=eff_ps,
                        quantize_kv=quantize_kv, prefix_cache=prefix_cache,
                        shared_bank=share_bank, shards=n_shards,
                        multi_step=multi_step)
        eng = self._step_engines.get(key)
        if eng is None:
            bank = None
            if share_bank:
                if not paged:
                    raise ValueError("share_bank needs paged=True")
                need = batch_size * (sm.max_len // eff_ps)
                default_np = (n_shards * (-(-need // n_shards) + 1)
                              if n_shards > 1 else need + 1)
                bank = self.shared_bank(
                    name, eff_ps, quantize_kv,
                    num_pages=(num_pages if num_pages is not None
                               else default_np),
                    num_shards=n_shards)
            eng = StepEngine(sm.model, batch_size, sm.max_len,
                             temperature=sm.temperature,
                             prefill_chunk=prefill_chunk, paged=paged,
                             page_size=page_size, quantize_kv=quantize_kv,
                             prefix_cache=prefix_cache,
                             num_pages=num_pages, bank=bank,
                             shards=shards, mesh=mesh,
                             multi_step=multi_step,
                             telemetry=self.telemetry.scoped(
                                 f"eng.{next(self._eng_seq)}."))
            self._step_engines[key] = eng
        return eng

    def spec_engine(self, name: str, draft: str, batch_size: int,
                    k: int = 4, tree_width: int = 1,
                    page_size: Optional[int] = None,
                    num_pages: Optional[int] = None,
                    prefill_chunk: Optional[int] = None,
                    prefix_cache: bool = False,
                    quantize_kv: Optional[str] = None,
                    share_bank: bool = False) -> SpecEngine:
        """Per-(target, draft) speculative engine (one per configuration).
        Like ``step_engine``, decode state persists across context
        switches and weights are never captured — every draft / target
        program runs against the matching context slot via the
        scheduler's runner hook.  ``k`` is the engine's K_MAX: adaptive
        schedulers move ``eng.set_k`` under it without changing which
        engine serves the pair.  With ``share_bank`` the TARGET column
        allocates from (and indexes prefixes into) the context's shared
        bank, so prompts cached by a plain paged engine of ``name`` are
        prefix hits here and vice versa; the draft column always stays
        private (different bytes)."""
        sm, dm = self._served[name], self._served[draft]
        eff_ps = (min(page_size, sm.max_len) if page_size is not None
                  else math.gcd(sm.max_len, 256))
        key = SpecKey(name=name, draft=draft, batch_size=batch_size,
                      k=k, tree_width=tree_width, page_size=eff_ps,
                      quantize_kv=quantize_kv, prefix_cache=prefix_cache,
                      prefill_chunk=prefill_chunk, shared_bank=share_bank)
        eng = self._spec_engines.get(key)
        if eng is None:
            bank = None
            if share_bank:
                ppr = sm.max_len // eff_ps
                bank = self.shared_bank(
                    name, eff_ps, quantize_kv,
                    num_pages=(num_pages if num_pages is not None
                               else batch_size * ppr + 1))
            eng = SpecEngine(dm.model, sm.model, batch_size, sm.max_len,
                             k=k, temperature=sm.temperature,
                             tree_width=tree_width, page_size=eff_ps,
                             num_pages=num_pages,
                             prefill_chunk=prefill_chunk,
                             prefix_cache=prefix_cache,
                             quantize_kv=quantize_kv, bank=bank,
                             telemetry=self.telemetry.scoped(
                                 f"eng.{next(self._eng_seq)}."))
            self._spec_engines[key] = eng
        return eng

    # ------------------------------------------------------------------
    def serve_batch(self, name: str, tokens, steps: int = 1,
                    seed: Optional[int] = None) -> np.ndarray:
        """Serve one batch on `name`, switching contexts if needed.

        The switch is O(1) when `name` is resident (paper case 2); if it is
        still loading, the visible stall is only the *remaining* load time
        (paper case 3 — reconfiguration partially hidden).
        """
        t0 = self.telemetry.clock()
        if seed is None:
            seed = self.next_seed()
        active = self.engine.active
        if active is not None and active.name == name:
            sw = 0.0                         # already selected: no flip
        else:
            self.engine.preload(name)        # no-op if resident
            sw = self.engine.switch(name, wait=True)
        slot = self.engine.active
        tokens = np.asarray(tokens)
        if steps == 1:
            out = self.engine.run(tokens, seed)
        else:
            eng = self._serving_engine(name, slot.buffers)
            out = eng.generate(tokens, steps, seed=seed)
        self.log.append({"name": name, "switch_s": sw,
                         "total_s": self.telemetry.clock() - t0,
                         "batch": int(tokens.shape[0]),
                         "steps": steps, "seed": seed})
        return out

    def serve_stream(self, requests: list[tuple[str, Any]],
                     lookahead: bool = True) -> list[np.ndarray]:
        """Serve a stream of (model_name, batch) requests.

        With ``lookahead`` the policy streams the next needed model into
        the shadow slot while the current batch executes — the paper's
        dynamic reconfiguration (victim choice and all, via
        ``engine.prefetch``; no inline slot logic here).
        """
        outs = []
        for i, (name, toks) in enumerate(requests):
            self.engine.preload(name)
            self.engine.switch(name, wait=True)
            if lookahead:
                self.engine.prefetch([n for n, _ in requests[i + 1:]],
                                     limit=1)   # hidden behind this batch
            outs.append(self.serve_batch(name, toks))
        return outs

    def shutdown(self):
        self.engine.shutdown()
