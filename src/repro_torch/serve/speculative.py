"""Speculative cascade decode on the paged slot pool.

The paper's Super-Sub cascade (Fig 6a, S1a) runs the small network while
the big network's context streams into the shadow slot — load hidden
behind execution.  ``SpecEngine`` is the LLM-serving analogue at token
granularity: a cheap *draft* context proposes tokens, the *target*
context scores them all in ONE multi-token verify pass
(``LM.verify_step_pages``, the paged verify kernel), and exact
speculative sampling accepts a prefix and draws one continuation — so
the committed stream is distributed exactly as target-only sampling, and
greedy output is token for token the target's greedy stream (tested
bitwise on the CPU in float32; on a bf16 card the draft's decode kernel
and the target's verify kernel round apart, so it need not be).

The engine keeps TWO cache columns over paged pools (one per model):
each admitted request owns only the pages its own lifetime needs in each
column, addressed through per-slot page tables (``SpecState.d_table`` /
``t_table``).  Admission gates on free slots AND free pages in both
pools (``can_admit``), retirement releases pages, and the target column
can share one ``SharedBank`` — allocator, prefix index and device pages
— with the plain paged engines serving the same context, so a prompt one
engine indexed is a prefix hit for the speculative target too.

Proposal shapes:

  * ``tree_width=1`` (default) — the flat strip: K draft tokens verified
    under the intra-block causal mask (``speculative_accept``).
  * ``tree_width=W>1`` — a *sausage tree*: every depth carries W sibling
    candidates (the chain = sibling 0), all ``1 + K*W`` nodes verified in
    ONE pass with per-node depth offsets and an ancestor bitmask as the
    kernel's intra-block mask (``tree_speculative_accept``).  When the
    chain token dies at depth i but a sibling survives, the round still
    commits i+1 tokens where the flat strip would stop at i.

``k`` is *adaptive*: ``set_k`` moves the current depth within
``[1, k_max]`` (one pair of round programs per depth, built once), and
the continuous scheduler drives it from a measured-acceptance EWMA.

Rollback stays positional: a rejected proposal's stale page writes are
masked by the row's committed position and overwritten later.  That
works for full attention caches only, so both models must be
all-attention with no sliding window.

The draws follow the JAX engine's schedule, with the sampler's ``fold``
(``_mix``) for ``fold_in``: a round with key ``key`` at counter ``t``
rolls from ``base = fold(key, t)`` (draft step i's gumbel field from
``fold(base, i)``), verifies with ``vkey = fold(base, 2**20)`` (the
uniforms of ``vkey``, the residual field of ``fold(vkey, 1)`` and the
tree's bonus field of ``fold(vkey, 2)``), then ``key := fold(key, t); t
+= 1``.  Admission draws and the instant-retire salt are the step
engine's (``GumbelDraws.admit_key`` / ``salt``).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serve.engine import GumbelDraws, StepEngine, _sample
from repro_torch.serve.pool import (Generation, PagePool, PrefixIndex,
                                    SharedBank, SlotPool)
from repro_torch.serve.telemetry import Telemetry, safe_ratio

__all__ = ["SPEC_ACCEPT_BUCKETS", "SpecEngine", "SpecKey", "SpecState",
           "speculative_accept", "tree_speculative_accept"]

# committed tokens per row per round lands in [1, K+1]; buckets cover
# the practical K range (the histogram is cumulative-bucket style)
SPEC_ACCEPT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0)


def _take(x, idx):
    """``x[b, idx[b]]`` for x (B, N, ...) and idx (B,) -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _residual(r, q, p):
    """The renormalized leftover mass ``max(r - q, 0)``, or ``p`` where
    nothing is left."""
    rm = torch.clamp(r - q, min=0.0)
    rs = rm.sum(dim=-1, keepdim=True)
    return torch.where(rs > 0, rm / torch.clamp(rs, min=1e-30), p)


def speculative_accept(proposals, draft_logits, target_logits,
                       temperature: float, u=None, gumbel=None):
    """Exact speculative sampling: accept/reject K proposals, draw the
    continuation.

    proposals: (B, K) int — draft tokens d_1..d_K; draft_logits: (B, K,
    V) — the distributions each d_i was sampled from; target_logits: (B,
    K+1, V) — target distributions for block-relative positions 1..K+1;
    ``u`` ((B, K) uniforms) and ``gumbel`` ((B, V) gumbel field): the
    draws, needed at temperature > 0 only.  Returns (tokens (B, K+1)
    int32, n_accepted (B,) int32): ``tokens[:, :n]`` are the accepted
    proposals, entry n is the residual draw (n < K) or the bonus token
    from the target's last distribution (n == K); entries past n are 0.

    Greedy (temperature == 0): accept while d_i equals the target argmax;
    the continuation is the target argmax."""
    B, K = proposals.shape
    dev = proposals.device
    proposals = proposals.long()
    cols = torch.arange(K + 1, device=dev)[None, :]
    if temperature <= 0.0:
        tgt = torch.argmax(target_logits, dim=-1)
        acc = proposals == tgt[:, :K]
        n = torch.cumprod(acc.int(), dim=1).sum(dim=1)
        nxt = _take(tgt, n)
    else:
        p_all = torch.softmax(target_logits.float() / temperature, dim=-1)
        q_all = torch.softmax(draft_logits.float() / temperature, dim=-1)
        pd = p_all[:, :K].gather(-1, proposals[..., None])[..., 0]
        qd = q_all.gather(-1, proposals[..., None])[..., 0]
        acc = u * qd <= pd            # accept w.p. min(1, p/q); p==q -> 1
        n = torch.cumprod(acc.int(), dim=1).sum(dim=1)
        # residual at the rejection point: r ∝ max(p - q, 0); all-accepted
        # rows pad q with zeros so the "residual" is the bonus draw from p
        q_pad = torch.cat([q_all, torch.zeros_like(q_all[:, :1])], dim=1)
        pn = _take(p_all, n)
        r = _residual(pn, _take(q_pad, n), pn)
        nxt = torch.argmax(torch.log(r + 1e-30) + gumbel, dim=-1)
    props_pad = torch.cat([proposals, proposals[:, :1]], dim=1)
    n2 = n[:, None]
    tokens = torch.where(cols < n2, props_pad,
                         torch.where(cols == n2, nxt[:, None],
                                     torch.zeros_like(props_pad)))
    return tokens.to(torch.int32), n.to(torch.int32)


def tree_speculative_accept(cand, draft_logits, target_logits,
                            temperature: float, u=None, gres=None,
                            gbon=None):
    """Recursive-rejection acceptance over a sausage token tree.

    Node layout (depths i in 1..K, siblings w in 0..W-1): node 0 is the
    last committed token; node ``1 + (i-1)*W + w`` is candidate w at
    depth i; sibling 0 is the *chain* (the path the draft rolled its own
    cache along).  ``cand``: (B, K, W) int candidates — the W draws at
    each depth were sampled i.i.d. from the SAME chain draft distribution
    ``draft_logits[:, i-1]`` ((B, K, V)).  ``target_logits``: (B, 1+K*W,
    V), one distribution per tree node.  At temperature > 0 the draws:
    ``u`` ((B, K, W) uniforms), ``gres`` and ``gbon`` ((B, V) gumbel
    fields, the residual's and the bonus's).

    Per depth the W siblings run SpecInfer-style recursive rejection
    against the parent node's target distribution: candidate w is
    accepted with probability ``min(1, r/q)``, where r starts at p and
    renormalizes to ``max(r - q, 0)`` after each rejection; the first
    accepted sibling wins.  Sibling 0 accepted -> descend the chain.  A
    later sibling accepted -> commit the chain prefix, the sibling, AND a
    bonus token from the sibling's own verified distribution (the round
    ends there).  All W rejected -> commit the residual draw.  At
    temperature 0 the committed token at depth i is always the parent
    node's target argmax.

    Returns ``(tokens (B, K+1), n (B,), alt_depth (B,), alt_tok (B,))``,
    int32: ``tokens[:, :n+1]`` is the committed block; rows with
    ``alt_depth > 0`` committed a non-chain sibling ``alt_tok`` at that
    depth, whose k/v the caches hold for the *chain* candidate — the
    engine repairs that one position with a masked decode step."""
    B, K, W = cand.shape
    dev = cand.device
    cand = cand.long()

    def chain(i):                                  # chain node at depth i
        return 1 + (i - 1) * W

    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    zeros = torch.zeros((B,), dtype=torch.long, device=dev)
    n, alt_depth, alt_tok = zeros.clone(), zeros.clone(), zeros.clone()
    toks = torch.zeros((B, K + 1), dtype=torch.long, device=dev)

    if temperature <= 0.0:
        tgt = torch.argmax(target_logits, dim=-1)
        for i in range(1, K + 1):
            parent = 0 if i == 1 else chain(i - 1)
            t_i = tgt[:, parent]
            # chain hit, alt hit (first matching sibling), or residual —
            # the committed token at depth i is t_i in every case
            toks[:, i - 1] = torch.where(alive, t_i, toks[:, i - 1])
            chain_hit = cand[:, i - 1, 0] == t_i
            alt_hit = torch.zeros_like(alive)
            alt_node = zeros.clone()
            for w in range(1, W):
                hw = ~alt_hit & (cand[:, i - 1, w] == t_i)
                alt_node = torch.where(hw, chain(i) + w, alt_node)
                alt_hit = alt_hit | hw
            alt_hit = alt_hit & ~chain_hit
            n = torch.where(alive & (chain_hit | alt_hit), i, n)
            bonus = _take(tgt, alt_node)
            sel = alive & alt_hit
            toks[:, i] = torch.where(sel, bonus, toks[:, i])
            alt_depth = torch.where(sel, i, alt_depth)
            alt_tok = torch.where(sel, t_i, alt_tok)
            alive = alive & chain_hit
        toks[:, K] = torch.where(alive, tgt[:, chain(K)], toks[:, K])
    else:
        p_all = torch.softmax(target_logits.float() / temperature, dim=-1)
        q_all = torch.softmax(draft_logits.float() / temperature, dim=-1)
        for i in range(1, K + 1):
            parent = 0 if i == 1 else chain(i - 1)
            p = p_all[:, parent]                              # (B, V)
            q = q_all[:, i - 1]
            r = p
            acc = torch.zeros_like(alive)
            acc_alt = torch.zeros_like(alive)
            acc_tok, acc_node = zeros.clone(), zeros.clone()
            for w in range(W):
                tw = cand[:, i - 1, w]
                qt = q.gather(1, tw[:, None])[:, 0]
                rt = r.gather(1, tw[:, None])[:, 0]
                aw = ~acc & (u[:, i - 1, w] * qt <= rt)
                acc_tok = torch.where(aw, tw, acc_tok)
                acc_node = torch.where(aw, chain(i) + w, acc_node)
                acc_alt = acc_alt | (aw & (w > 0))
                acc = acc | aw
                if w < W - 1:
                    # rejected w: renormalized leftover target mass (p
                    # where nothing is left, like the flat rule)
                    r = torch.where(acc[:, None], r, _residual(r, q, p))
            # all W rejected: residual draw from the final leftover mass
            r = _residual(r, q, p)
            residual = torch.argmax(torch.log(r + 1e-30) + gres, dim=-1)
            tok_i = torch.where(acc, acc_tok, residual)
            toks[:, i - 1] = torch.where(alive, tok_i, toks[:, i - 1])
            n = torch.where(alive & acc, i, n)
            bl = _take(p_all, acc_node)                       # (B, V)
            bonus = torch.argmax(torch.log(bl + 1e-30) + gbon, dim=-1)
            sel = alive & acc_alt
            toks[:, i] = torch.where(sel, bonus, toks[:, i])
            alt_depth = torch.where(sel, i, alt_depth)
            alt_tok = torch.where(sel, acc_tok, alt_tok)
            alive = alive & (acc & ~acc_alt)
        blK = p_all[:, chain(K)]
        bonusK = torch.argmax(torch.log(blK + 1e-30) + gbon, dim=-1)
        toks[:, K] = torch.where(alive, bonusK, toks[:, K])
    return tuple(x.to(torch.int32) for x in (toks, n, alt_depth, alt_tok))


def _top_w(logits, W: int):
    """The W largest entries' indices of each row, ties to the lowest
    index (``jax.lax.top_k``'s order), so that sibling 0 is the row's
    ``argmax``; a stable sort makes that order on every device."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :W]


def sausage_tree(K: int, W: int):
    """The sausage tree of depth K and width W over its ``1 + K*W``
    nodes (node 0 the committed token, candidate w at depth i node
    ``1 + (i-1)*W + w``, the chain its sibling 0) as numpy arrays: each
    node's depth offset (int32), its ancestor bitmask (int32: itself,
    node 0 and the chain at every shallower depth) and whether it
    writes k/v (bool: node 0 and the chain; siblings park)."""
    Kt = 1 + K * W
    chain = [1 + (i - 1) * W for i in range(1, K + 1)]
    offsets = np.concatenate(
        [[0], np.repeat(np.arange(1, K + 1), W)]).astype(np.int32)
    mask = np.zeros((Kt,), np.int32)
    mask[0] = 1                                      # node 0 sees itself
    writer = np.zeros((Kt,), bool)
    writer[0] = True                                 # committed tok at pos
    for i in range(1, K + 1):
        anc = 1                                      # bit 0: committed tok
        for d in range(1, i):
            anc |= 1 << chain[d - 1]
        for w in range(W):
            j = chain[i - 1] + w
            mask[j] = anc | (1 << j)
        writer[chain[i - 1]] = True                  # chain k/v at pos+i
    return offsets, mask, writer


class SpecKey(NamedTuple):
    """Frozen cache key for ONE speculative-engine configuration — the
    SpecEngine counterpart of ``EngineKey``.  ``k`` is the engine's
    K_MAX: adaptive K moves ``eng.k`` underneath it without changing
    which engine serves the context."""
    name: Optional[str] = None          # target context
    draft: Optional[str] = None         # draft context
    batch_size: int = 1
    k: int = 4                          # constructor k == adaptive ceiling
    tree_width: int = 1
    page_size: Optional[int] = None     # resolved (never None in practice)
    quantize_kv: Optional[str] = None
    prefix_cache: bool = False
    prefill_chunk: Optional[int] = None
    shared_bank: bool = False           # target column on a SharedBank


@dataclass
class SpecState:
    """Device half of the speculative pool, written in place.

    One slot pool, two PAGED cache columns: at every round boundary both
    columns hold exactly the committed prefix (positions <= pos-1,
    addressed through the per-slot page tables) and ``tok`` is the last
    committed token at position ``pos`` — the invariant
    ``decode_step_pages`` keeps, so draft and target stay
    interchangeable views of one sequence.  The draw key and round
    counter are the engine's ``sampler``'s."""
    d_caches: Any            # draft page pool, per layer (NP, ...)
    t_caches: Any            # target page pool (the bank's when shared)
    tok: torch.Tensor        # (B, 1) int32 — last committed token a slot
    pos: torch.Tensor        # (B,) int32  — its cache position
    d_table: torch.Tensor    # (B, P) int32 — draft-column page tables
    t_table: torch.Tensor    # (B, P) int32 — target-column page tables


@dataclass
class _SpecPending:
    """One admitted-but-still-prefilling request (chunked admission):
    its slot and pages (both columns) are reserved, its prompt streams
    into both cache columns one chunk per engine tick."""
    tokens: np.ndarray                    # (b, S) full prompt, int32
    gens: list                            # Generation handles (slots set)
    t_tables: np.ndarray                  # (b, P) target page tables
    d_tables: np.ndarray                  # (b, P) draft page tables
    done: int = 0                         # prompt tokens already chunked
    started: bool = False                 # first chunk has executed


class SpecEngine(SlotPool):
    """Speculative continuous-batching engine for one draft/target pair,
    on paged KV columns.

    Host surface is the shared ``SlotPool`` base ``StepEngine`` also
    builds on (slots, free-list, ``admit``, ``step``, ``drain``), so the
    continuous scheduler drives either; one ``step()`` is a full
    speculative ROUND — a K+1 draft rollout plus one multi-token verify —
    committing between 1 and K+1 tokens per live row.

    Each column is a paged pool (``PagePool`` + per-slot page table):
    admission takes ``pages_needed`` pages per column (gated by
    ``can_admit`` on slots AND both pools), retirement releases them.
    The target column accepts a ``SharedBank``, so its allocator, prefix
    index and device pages are the SAME objects a plain paged
    ``StepEngine`` over the same context uses.  ``prefix_cache=True``
    maps a new prompt's indexed pages read-only into the target table and
    prefills only the un-cached suffix (one-shot single-row admissions;
    the draft column always prefills cold — its pages are private).

    ``prefill_chunk=C`` streams admission: each engine tick runs one
    (b, C) chunk into BOTH columns before the round.

    ``tree_width=W>1`` widens each draft depth to W sibling candidates
    verified in one tree pass (see ``tree_speculative_accept``).  ``k``
    is the CURRENT depth, adjustable per round via ``set_k`` within [1,
    k_max] (k_max = the constructor ``k``); admission always reserves
    ``k_max`` slack so a depth change never overruns a row's pages.

    ``params`` per call is ``(draft_params, target_params)``, or ``None``
    when ``runner`` is set: the scheduler's runner receives ``(which, fn,
    *args)`` with ``which`` in {"draft", "target"} and runs the program
    against the right context slot — the engine never captures weights.
    Every program runs eagerly and writes the caches, tables, tok and
    pos in place; a flat round reads its results back once, a tree round
    twice (the draft repair is gated on the first read).  ``sampler``
    holds the draws, as ``StepEngine``'s."""

    def __init__(self, draft: LM, target: LM, batch_size: int, max_len: int,
                 k: int = 4, temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 tree_width: int = 1,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 bank: Optional[SharedBank] = None,
                 quantize_kv: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None,
                 sampler: Optional[GumbelDraws] = None):
        for m, role in ((draft, "draft"), (target, "target")):
            if any(mix != "attn" for mix, _ in m.pattern):
                raise ValueError(
                    f"speculative decode needs an all-attention {role} "
                    "(recurrent state cannot rewind a rejected proposal)")
            if m.cfg.sliding_window:
                raise ValueError(
                    f"speculative decode needs a full-cache {role} (ring "
                    "writes wrap onto slots a rollback must preserve)")
            m._require_paged_support()
        if draft.cfg.vocab_size != target.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if tree_width < 1:
            raise ValueError(f"tree_width must be >= 1, got {tree_width}")
        if tree_width > 1 and 1 + k * tree_width > 31:
            raise ValueError(
                f"tree of depth {k} x width {tree_width} has "
                f"{1 + k * tree_width} nodes; the ancestor bitmask holds "
                "at most 31 (int32)")
        if quantize_kv not in (None, "int8"):
            raise ValueError(f"quantize_kv must be None or 'int8', got "
                             f"{quantize_kv!r}")
        if draft.device != target.device:
            raise ValueError(f"draft on {draft.device}, target on "
                             f"{target.device}: both columns live on one "
                             "device")
        self.draft_model = draft
        self.target_model = target
        self.device = target.device
        self.batch_size = batch_size
        self.max_len = max_len
        self.k = k                  # CURRENT depth (set_k moves it)
        self.k_max = k              # admission slack + program-cache cap
        self.tree_width = tree_width
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.quantize_kv = quantize_kv
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.sampler = sampler if sampler is not None else GumbelDraws(
            self.device)

        telemetry = telemetry if telemetry is not None else Telemetry()

        # ---- paged columns: one pool per model (the target may share)
        if page_size is None:
            page_size = math.gcd(max_len, 256)
        page_size = min(page_size, max_len)
        if max_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_len {max_len}: a "
                "row's virtual space is a whole number of pages")
        self.page_size = page_size
        self.pages_per_row = max_len // page_size
        if num_pages is None:
            num_pages = batch_size * self.pages_per_row + 1
        if num_pages < self.pages_per_row + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot hold one worst-case row "
                f"({self.pages_per_row} pages) plus the park page")
        self.num_pages = num_pages
        # scoped pool telemetry so the two free_pages gauges don't collide
        self._d_pages = PagePool(num_pages,
                                 telemetry=telemetry.scoped("draft."))
        self._bank = bank
        if bank is not None:
            if bank.pool.total_pages < self.pages_per_row + 1:
                raise ValueError(
                    f"shared bank of {bank.pool.total_pages} pages cannot "
                    f"hold one worst-case row ({self.pages_per_row} pages)")
            self._t_pages = bank.pool
        else:
            self._t_pages = PagePool(num_pages,
                                     telemetry=telemetry.scoped("target."))
        self.prefix_cache = prefix_cache
        if prefix_cache:
            if bank is not None:
                if bank.index is None:
                    bank.index = PrefixIndex(page_size,
                                             namespace=quantize_kv or "fp16")
                self._prefix = bank.index
            else:
                self._prefix = PrefixIndex(page_size,
                                           namespace=quantize_kv or "fp16")
        else:
            self._prefix = None
        # the prefix machinery reads/writes the TARGET column only
        self._pages = self._t_pages
        self.paged = True
        self._fns: dict = {}        # depth k -> {"roll", "verify"}

        # Execution hook: when set, every device program runs as
        # ``runner(which, fn, *args)`` with which in {"draft", "target"} —
        # the continuous scheduler activates the matching context slot and
        # prefetches the other into the shadow slot before each call.
        self.runner = None

        self.state: Optional[SpecState] = None
        self._pending: deque = deque()
        self._d_owned: dict = {}    # slot -> draft-column pages owned
        self._pool_init(batch_size, telemetry=telemetry)
        # speculative accounting rides the shared pool counters; the tick
        # counters stay 0 — a round is not a decode round-trip and must
        # not skew the steps-per-tick aggregate.
        self.stats.update({"rounds": 0, "row_rounds": 0, "draft_steps": 0,
                           "committed_tokens": 0, "admitted_tokens": 0,
                           "prefix_hits": 0, "prefix_pages_mapped": 0,
                           "cow_copies": 0, "cache_evictions": 0})
        reg = self.telemetry.registry
        reg.gauge(self.telemetry.prefix + "k_current", self.k,
                  doc="current adaptive speculation depth")
        reg.gauge(self.telemetry.prefix + "tree_width", self.tree_width,
                  doc="draft candidates per speculation depth")
        self.reset()

    # -------------------------------------------------------- round programs
    def set_k(self, k: int):
        """Move the current speculation depth within [1, k_max] (adaptive
        K: the scheduler calls this from its acceptance EWMA).  Programs
        for each depth are built once; admission slack always reserves
        ``k_max`` so a later rise never overruns pages already granted."""
        k = max(1, min(int(k), self.k_max))
        if k != self.k:
            self.k = k
            self.telemetry.registry.gauge(
                self.telemetry.prefix + "k_current", k,
                doc="current adaptive speculation depth")

    def _programs(self, k: int):
        fns = self._fns.get(k)
        if fns is None:
            fns = self._build_round_programs(k)
            self._fns[k] = fns
        return fns

    def _build_round_programs(self, k: int):
        draft, target = self.draft_model, self.target_model
        B, T, K, W = self.batch_size, self.temperature, k, self.tree_width
        V = target.cfg.vocab_size
        dev, max_len, draws = self.device, self.max_len, self.sampler

        def commit(toks, n, live, remaining):
            """Commit m = min(n + 1, remaining) tokens a live row: the new
            last token and position, in place.  Stale page writes past
            pos + m are masked by position and overwritten later."""
            st = self.state
            m = torch.where(live, torch.minimum(n + 1, remaining),
                            torch.zeros_like(n))
            last = toks.gather(1, torch.clamp(m - 1, 0, K)[:, None].long())
            st.tok.copy_(torch.where(m[:, None] > 0, last, st.tok))
            st.pos.copy_(torch.clamp(st.pos + m, max=max_len - 1))
            return m

        if W == 1:
            def _roll(dparams, live, base):
                """K+1 draft decode steps from the committed token:
                iteration i feeds block token i at pos+i, sampling
                proposal d_{i+1}.  The extra iteration feeds d_K so its
                k/v lands in the draft pages (needed when the whole block
                is accepted); its sample is discarded.  Dead rows' writes
                park.  -> (props (B, K) int32, dlogits (B, K, V))."""
                st = self.state
                tok, props, dl = st.tok, [], []
                for i in range(K + 1):
                    logits, _ = draft.decode_step_pages(
                        dparams, st.d_caches, tok, st.pos + i, st.d_table,
                        live=live)
                    last = logits[:, -1]
                    g = (draws.field(draws.fold(base, i), (B, V))
                         if T > 0.0 else None)
                    nxt = _sample(last, T, g)
                    if i < K:
                        props.append(nxt)
                        dl.append(last)
                    tok = nxt[:, None]
                return torch.stack(props, 1), torch.stack(dl, 1)

            def _verify(tparams, props, dlogits, live, remaining, base):
                """One multi-token target pass over [t0, d_1..d_K]
                through the target page tables + exact accept/reject;
                commits m = min(n_accepted+1, remaining) tokens per live
                row.  Dead rows write-mask the whole block.  -> (toks
                (B, K+1), m (B,))."""
                st = self.state
                block = torch.cat([st.tok, props], dim=1)
                wmask = live[:, None].expand(block.shape)
                logits, _ = target.verify_step_pages(
                    tparams, st.t_caches, block, st.pos, st.t_table,
                    wmask=wmask)
                u = g = None
                if T > 0.0:
                    vkey = draws.fold(base, 1 << 20)
                    u = draws.uniform(vkey, (B, K))
                    g = draws.field(draws.fold(vkey, 1), (B, V))
                toks, n = speculative_accept(props, dlogits, logits, T, u, g)
                return toks, commit(toks, n, live, remaining)

            return {"roll": _roll, "verify": _verify}

        # ---- sausage tree: W candidates per depth, one verify pass; its
        # depth offsets, ancestor bitmasks and writer mask, built once
        Kt = 1 + K * W
        offsets_np, mask_np, writer_np = sausage_tree(K, W)
        offsets = torch.from_numpy(offsets_np).to(dev)
        tree = torch.from_numpy(mask_np).to(dev).expand(B, Kt).contiguous()
        writer = torch.from_numpy(writer_np).to(dev)

        def _roll_tree(dparams, live, base):
            """K+1 draft steps along the CHAIN (sibling 0), sampling W
            i.i.d. candidates per depth from the chain distribution
            (greedy: the top W, sibling 0 the argmax).  Only the chain's
            k/v enters the draft pages.  -> (cand (B, K, W) int32,
            dlogits (B, K, V))."""
            st = self.state
            tok, cands, dl = st.tok, [], []
            for i in range(K + 1):
                logits, _ = draft.decode_step_pages(
                    dparams, st.d_caches, tok, st.pos + i, st.d_table,
                    live=live)
                last = logits[:, -1]                         # (B, V)
                if T > 0.0:
                    g = draws.field(draws.fold(base, i), (B, W, V))
                    c = torch.argmax(last[:, None, :] / T + g, dim=-1)
                else:
                    c = _top_w(last, W)
                c = c.to(torch.int32)                        # (B, W)
                if i < K:
                    cands.append(c)
                    dl.append(last)
                tok = c[:, :1]
            return torch.stack(cands, 1), torch.stack(dl, 1)

        def _verify_tree(tparams, cand, dlogits, live, remaining, base):
            """ONE target pass over all 1+K*W tree nodes: per-node depth
            offsets place queries and writes at pos+depth, the ancestor
            bitmask replaces the intra-block causal mask, and only the
            chain nodes write k/v (siblings park).  Tree acceptance picks
            the committed block; where a non-chain sibling won, the
            target's chain k/v at that depth is repaired in place with
            one masked decode step (always run, parked when no row needs
            it; a clipped-out sibling's repair lands past the new pos,
            where later rounds overwrite).  -> (toks, m, alt_depth,
            alt_tok, rpos)."""
            st = self.state
            block = torch.cat([st.tok, cand.reshape(B, K * W)], dim=1)
            wmask = live[:, None] & writer[None, :]
            logits, _ = target.verify_step_pages(
                tparams, st.t_caches, block, st.pos, st.t_table,
                wmask=wmask, offsets=offsets, tree=tree)
            u = gres = gbon = None
            if T > 0.0:
                vkey = draws.fold(base, 1 << 20)
                u = draws.uniform(vkey, (B, K, W))
                gres = draws.field(draws.fold(vkey, 1), (B, V))
                gbon = draws.field(draws.fold(vkey, 2), (B, V))
            toks, n, alt_depth, alt_tok = tree_speculative_accept(
                cand, dlogits, logits, T, u, gres, gbon)
            alt_live = live & (alt_depth > 0)
            rpos = st.pos + alt_depth
            target.decode_step_pages(tparams, st.t_caches, alt_tok[:, None],
                                     rpos, st.t_table, live=alt_live)
            m = commit(toks, n, live, remaining)
            return toks, m, alt_depth, alt_tok, rpos

        return {"roll": _roll_tree, "verify": _verify_tree,
                "offsets": offsets, "tree": tree, "writer": writer}

    # ----------------------------------------------------- admission programs
    def _admit_draw(self, last, slots):
        """First-token draw from prefill logits — the target's draw: the
        committed stream must be target-distributed from token one.  Row r
        of one (B, V) field of the admission key, indexed by slot (the
        step engine's draw: past t=0 the key is salted, so an admission
        never reuses a round's field)."""
        g = None
        if self.temperature > 0.0:
            g = self.sampler.field(self.sampler.admit_key(),
                                   (self.batch_size, last.shape[-1]))[slots]
        return _sample(last, self.temperature, g)

    def _admit_target_fn(self, tparams, tokens, slots, tables):
        """Target prefill scattered into the rows' own pages + the first
        token draw."""
        st = self.state
        logits, rows = self.target_model.prefill(tparams, tokens,
                                                 self.max_len)
        first = self._admit_draw(logits[:, -1], slots)
        self.target_model.insert_cache_pages(st.t_caches, rows, tables)
        st.tok[slots] = first[:, None]
        st.pos[slots] = tokens.shape[1]
        st.t_table[slots] = tables
        return first

    def _admit_draft_fn(self, dparams, tokens, slots, tables):
        """Draft prefill into the draft column's pages (its logits are
        unused — the draft only needs the prompt's k/v)."""
        st = self.state
        _, rows = self.draft_model.prefill(dparams, tokens, self.max_len)
        self.draft_model.insert_cache_pages(st.d_caches, rows, tables)
        st.d_table[slots] = tables

    def _last_real(self, logits, nvalid):
        return logits[torch.arange(logits.shape[0], device=self.device),
                      nvalid.long() - 1]

    @staticmethod
    def _wmask(chunk, nvalid):
        return (torch.arange(chunk.shape[1], device=chunk.device)[None, :]
                < nvalid[:, None])

    def _admit_t_hit_fn(self, tparams, suffix, pos, slots, tables, nvalid):
        """Prefix-hit target admission: only the prompt's un-cached
        suffix runs, as one verify chunk through the page tables (matched
        pages were mapped read-only by the host); the last real token's
        logits draw the first token under the cold admission's rules."""
        st = self.state
        logits, _ = self.target_model.verify_step_pages(
            tparams, st.t_caches, suffix, pos, tables,
            wmask=self._wmask(suffix, nvalid))
        first = self._admit_draw(self._last_real(logits, nvalid), slots)
        st.tok[slots] = first[:, None]
        st.pos[slots] = pos + nvalid
        st.t_table[slots] = tables
        return first

    def _chunk_d_fn(self, dparams, chunk, pos, tables, nvalid):
        """One streaming draft prefill chunk through the draft page
        tables (pad positions write-masked; no logits)."""
        self.draft_model.prefill_chunk_pages(
            dparams, self.state.d_caches, chunk, pos, tables,
            wmask=self._wmask(chunk, nvalid), need_logits=False)

    def _chunk_t_fn(self, tparams, chunk, pos, tables, nvalid):
        """One streaming target prefill chunk (non-final: no logits, no
        sampling)."""
        self.target_model.prefill_chunk_pages(
            tparams, self.state.t_caches, chunk, pos, tables,
            wmask=self._wmask(chunk, nvalid), need_logits=False)

    def _chunk_t_final_fn(self, tparams, chunk, pos, slots, tables, nvalid):
        """Final target chunk: write the tail, sample the first token from
        the last real token's logits (the one-shot admission draw), and
        arm the rows' tok/pos."""
        st = self.state
        logits, _ = self.target_model.prefill_chunk_pages(
            tparams, st.t_caches, chunk, pos, tables,
            wmask=self._wmask(chunk, nvalid))
        first = self._admit_draw(self._last_real(logits, nvalid), slots)
        st.tok[slots] = first[:, None]
        st.pos[slots] = pos + nvalid
        return first

    def _copy_t_fn(self, params, src, dst):
        """Copy-on-write a shared target page before the diverging row's
        first write (``params`` is unused; it keeps the runner's
        ``fn(params, *args)`` convention)."""
        del params
        self.target_model.copy_cache_pages(self.state.t_caches, src, dst)

    def _repair_d_fn(self, dparams, tok, rpos, alive):
        """Tree repair, draft column: the round committed a non-chain
        sibling, so the draft cache holds the CHAIN candidate's k/v at
        the sibling's position — one masked decode step feeding the
        committed sibling overwrites it with what a sequential draft
        decode would have written.  Logits are discarded."""
        self.draft_model.decode_step_pages(
            dparams, self.state.d_caches, tok, rpos, self.state.d_table,
            live=alive)

    # the prefix-cache and page-allocation machinery is StepEngine's,
    # pointed at the TARGET column (``self._pages`` aliases the target
    # pool; the draft column never shares pages)
    _reclaim = StepEngine._reclaim
    _make_room = StepEngine._make_room
    _prefix_plan = StepEngine._prefix_plan
    _route_prefix = StepEngine._route_prefix
    _take_prefix_pages = StepEngine._take_prefix_pages
    _drop_prefix_pages = StepEngine._drop_prefix_pages
    _index_prompt = StepEngine._index_prompt
    _take_pages = StepEngine._take_pages
    _note_chunk = StepEngine._note_chunk

    # ------------------------------------------------------------- lifecycle
    def reset(self, seed: Optional[int] = None):
        """Empty pool + restarted draw schedule.  The cache pools are
        reused once they exist (a freed page is rewritten before any of
        its positions is read)."""
        B, dev = self.batch_size, self.device
        # give the target column's pages back before the host pools reset:
        # a private pool just resets; a shared bank keeps serving the
        # OTHER engines, so only this engine's own rows release
        if self._bank is not None:
            own = []
            for g in self.slots:
                if g is not None and g.pages:
                    own += g.pages
                    g.pages = None
            for ps in self._pending:
                for g in ps.gens:
                    if g.pages:
                        own += g.pages
                        g.pages = None
            if own:
                self._t_pages.release(own)
        else:
            self._t_pages.reset()
            if self._prefix is not None:
                self._prefix.clear()   # its pages just left the allocator
        self._d_pages.reset()
        self._d_owned = {}
        self._pending.clear()

        d_caches = t_caches = None
        if self.state is not None:
            d_caches, t_caches = self.state.d_caches, self.state.t_caches
        if self._bank is not None and self._bank.caches is not None:
            t_caches = self._bank.caches   # the bank's tree is the one
        if d_caches is None:
            d_caches = self.draft_model.init_page_pool(
                self.num_pages, self.page_size,
                quantized=self.quantize_kv is not None)
        if t_caches is None:
            t_caches = self.target_model.init_page_pool(
                self._t_pages.total_pages, self.page_size,
                quantized=self.quantize_kv is not None)
        if self._bank is not None:
            self._bank.caches = t_caches
        P = self.pages_per_row

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        # every table entry must be a valid pool index; park (0) is the
        # safe default — empty slots read/write garbage space
        self.state = SpecState(d_caches=d_caches, t_caches=t_caches,
                               tok=zeros(B, 1), pos=zeros(B),
                               d_table=zeros(B, P), t_table=zeros(B, P))
        self.sampler.reset(self.seed if seed is None else seed)
        self._pool_reset()

    def _call(self, which: str, fn, params, *args):
        if self.runner is not None:
            return self.runner(which, fn, *args)
        dp, tp = params
        return fn(dp if which == "draft" else tp, *args)

    # The JAX engine's ``_bank_pull``/``_bank_push`` adopt and publish the
    # bank's target pages around each call, because its jitted programs
    # donate buffers.  Here the programs write the bank's one cache tree
    # in place (``SharedBank.caches`` is never replaced), so there is
    # nothing to hand over: the two reduce to this identity check.
    def _bank_check(self):
        if self._bank is not None and (self._bank.caches
                                       is not self.state.t_caches):
            raise RuntimeError("the shared bank's caches were replaced")

    # -------------------------------------------------------------- queries
    @property
    def accepted_per_round(self) -> float:
        """Mean committed tokens per row per verify pass, in [1, K+1]
        (> 1 means speculation is paying)."""
        return safe_ratio(self.stats["committed_tokens"],
                          self.stats["row_rounds"])

    def pending_slots(self) -> int:
        return sum(len(ps.gens) for ps in self._pending)

    def free_pages(self) -> int:
        """Admission headroom is the TIGHTER column."""
        return min(self._d_pages.free_pages(), self._t_pages.free_pages())

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages one row needs per column: a round's block writes run up
        to ``k_max`` positions past the last committed token, and the
        admission bound ``prompt + max_new + k_max <= max_len``
        guarantees that slack exists inside the row's virtual space."""
        return max(1, -(-(prompt_len + max_new + self.k_max - 1)
                        // self.page_size))

    def can_admit(self, tokens, max_new: int) -> bool:
        if not SlotPool.can_admit(self, tokens, max_new):
            return False
        tokens = np.asarray(tokens)
        b, S = (1, tokens.shape[0]) if tokens.ndim == 1 else tokens.shape
        needed = b * self.pages_needed(S, max_new)
        if needed > self._d_pages.free_pages():
            self.last_admit_block = "pages"
            return False               # the draft column has no cache to
        #                                reclaim from — pages or nothing
        t_needed = needed
        protect = []
        if self.prefix_cache and b == 1 and self.prefill_chunk is None:
            plan = self._prefix_plan(tokens.reshape(1, S), max_new,
                                     peek=True)
            if plan is not None:
                retained, cow_src, _, owned = plan
                t_needed = owned       # shared pages cost nothing
                protect = retained + ([cow_src] if cow_src is not None
                                      else [])
        if t_needed <= self._t_pages.free_pages():
            return True
        self._reclaim(t_needed - self._t_pages.free_pages(),
                      protect=protect)
        ok = t_needed <= self._t_pages.free_pages()
        if not ok:
            self.last_admit_block = "pages"
        return ok

    # ------------------------------------------------------ page allocation
    def _take_d_pages(self, b: int, npages: int):
        """Allocate the draft column's pages and build the (b, P) tables
        (unused tail entries point at the park page)."""
        pages = self._d_pages.take(b * npages)
        tables = np.full((b, self.pages_per_row), PagePool.PARK, np.int32)
        for i in range(b):
            tables[i, :npages] = pages[i * npages:(i + 1) * npages]
        return tables, pages

    def _dev(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------- admission
    def admit(self, params, tokens, max_new: int,
              metas: Optional[list] = None,
              seeds: Optional[list] = None,
              submitted_at: Optional[float] = None) -> list[Generation]:
        """Admit (b, S) prompt rows into b free slots (both columns).

        Needs ``k_max`` extra cache slack beyond ``max_new``: a round's
        block writes run up to K positions past the last committed token
        (and adaptive K may rise back to ``k_max`` at any round)."""
        if seeds and any(s is not None for s in seeds):
            raise ValueError("SpecEngine does not honor per-request seeds; "
                             "route seeded requests to a plain context")
        tokens, _, _ = self._admit_args(tokens, metas, seeds)
        b, S = tokens.shape
        if S + max_new + self.k_max > self.max_len:
            raise ValueError(
                f"prompt {S} + {max_new} new + {self.k_max} speculative "
                f"slack exceeds max_len {self.max_len}")
        self._bank_check()
        if self.prefill_chunk is not None:
            return self._admit_chunked(tokens, max_new, metas, submitted_at)
        plan = (self._prefix_plan(tokens, max_new)
                if self.prefix_cache else None)
        if plan is not None:
            return self._admit_prefix_hit(params, tokens, max_new, metas,
                                          plan, submitted_at)
        return self._admit_cold(params, tokens, max_new, metas,
                                submitted_at)

    def _admit_cold(self, params, tokens, max_new, metas, submitted_at):
        """One-shot cold admission: whole-prompt prefill into both
        columns' freshly taken pages."""
        b, S = tokens.shape
        slots = self._take_slots(b)
        npages = self.pages_needed(S, max_new)
        t_pages = []
        try:
            t_tables, t_pages = self._take_pages(b, S, max_new)
            d_tables, d_pages = self._take_d_pages(b, npages)
        except BaseException:
            self._restore_slots(slots)
            if t_pages:
                self._t_pages.restore(t_pages)
            raise
        try:
            tk, sl = self._dev(tokens), self._dev(slots, torch.long)
            first = self._call("target", self._admit_target_fn, params, tk,
                               sl, self._dev(t_tables))
            self._call("draft", self._admit_draft_fn, params, tk, sl,
                       self._dev(d_tables))
            first = first.cpu().numpy()
        except BaseException:
            self._restore_slots(slots)   # failed admit must not leak slots
            self._t_pages.restore(t_pages)   # nor either column's pages
            self._d_pages.restore(d_pages)
            raise
        gens = self._register(slots, S, max_new, metas, first=first,
                              submitted_at=submitted_at)
        for i, g in enumerate(gens):
            g.pages = t_pages[i * npages:(i + 1) * npages]
            self._d_owned[g.slot] = d_pages[i * npages:(i + 1) * npages]
            self._index_prompt(tokens[i], g.pages)
        self.stats["admitted_tokens"] += b
        if self._retire_done(gens):
            # same-boundary re-admission of an instantly retired slot must
            # not reuse this draw field (salt disjoint from round folds)
            self._salt_admit_key()
        return gens

    def _admit_prefix_hit(self, params, tokens, max_new, metas, plan,
                          submitted_at):
        """One-shot admission on a target-column prefix hit: the matched
        pages map read-only into the new row's target table, the boundary
        page is copied on write when the divergence lands inside one, and
        only the prompt's un-cached suffix runs through the target.  The
        draft column prefills the whole prompt cold into its own pages."""
        b, S = tokens.shape
        retained, cow_src, d, owned = plan
        slots = self._take_slots(b)
        npages = self.pages_needed(S, max_new)
        try:
            t_table, t_pages, fresh = self._take_prefix_pages(plan, S,
                                                              max_new)
        except BaseException:
            self._restore_slots(slots)
            raise
        try:
            d_tables, d_pages = self._take_d_pages(b, npages)
        except BaseException:
            self._restore_slots(slots)
            self._drop_prefix_pages(plan, fresh)
            raise
        sl = self._dev(slots, torch.long)
        try:
            if cow_src is not None:
                self._call("target", self._copy_t_fn, params, [cow_src],
                           [fresh[0]])
            first = self._call(
                "target", self._admit_t_hit_fn, params,
                self._dev(tokens[:, d:]), self._dev(np.full((b,), d)), sl,
                self._dev(t_table), self._dev(np.full((b,), S - d)))
            self._call("draft", self._admit_draft_fn, params,
                       self._dev(tokens), sl, self._dev(d_tables))
            first = first.cpu().numpy()
        except BaseException:
            self._restore_slots(slots)
            self._drop_prefix_pages(plan, fresh)
            self._d_pages.restore(d_pages)
            raise
        if cow_src is not None:
            self._t_pages.release([cow_src])     # copy done: pin drops
        gens = self._register(slots, S, max_new, metas, first=first,
                              submitted_at=submitted_at)
        gens[0].pages = t_pages
        self._d_owned[gens[0].slot] = d_pages
        self._index_prompt(tokens[0], t_pages)
        self.stats["admitted_tokens"] += b
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_mapped"] += len(retained)
        if cow_src is not None:
            self.stats["cow_copies"] += 1
        if self._trace.enabled:
            self._trace.instant(
                f"prefix-hit:{gens[0].rid}", f"{self.telemetry.prefix}eng",
                args={"mapped": len(retained), "cow": cow_src is not None})
        if self._retire_done(gens):
            self._salt_admit_key()
        return gens

    def _admit_chunked(self, tokens, max_new, metas, submitted_at):
        """Reserve slots + pages in both columns and queue the prompt;
        each engine tick streams one (b, C) chunk into BOTH columns.
        Pending rows are not live, so every round-program write they
        would make goes to the park page."""
        b, S = tokens.shape
        slots = self._take_slots(b)
        npages = self.pages_needed(S, max_new)
        t_pages = []
        try:
            t_tables, t_pages = self._take_pages(b, S, max_new)
            d_tables, d_pages = self._take_d_pages(b, npages)
        except BaseException:
            self._restore_slots(slots)
            if t_pages:
                self._t_pages.restore(t_pages)
            raise
        # tables go live at reserve time: the rounds that run while the
        # prompt streams in don't read them (dead rows park), the chunk
        # programs write through an explicit arg, and the final chunk's
        # row needs them next round
        sl = self._dev(slots, torch.long)
        self.state.t_table[sl] = self._dev(t_tables)
        self.state.d_table[sl] = self._dev(d_tables)
        gens = self._register(slots, S, max_new, metas,
                              submitted_at=submitted_at)
        for i, g in enumerate(gens):
            g.pages = t_pages[i * npages:(i + 1) * npages]
            self._d_owned[g.slot] = d_pages[i * npages:(i + 1) * npages]
        self._pending.append(_SpecPending(
            tokens=np.asarray(tokens, np.int32), gens=gens,
            t_tables=t_tables, d_tables=d_tables))
        return gens

    def prefill_tick(self, params) -> list[Generation]:
        """Run at most ONE chunk tick — one (b, C) chunk into EACH column
        — the admission budget per round.  Returns generations that
        finished at this boundary (a final chunk can instant-retire:
        steps==1, or EOS as the first token)."""
        if not self._pending:
            return []
        C = self.prefill_chunk
        ps = self._pending[0]
        b, S = ps.tokens.shape
        start = ps.done
        end = min(start + C, S)
        nvalid = end - start
        chunk = np.zeros((b, C), np.int32)
        chunk[:, :nvalid] = ps.tokens[:, start:end]
        pos = self._dev(np.full((b,), start))
        nv = self._dev(np.full((b,), nvalid))
        jchunk = self._dev(chunk)
        t0 = self.telemetry.clock()
        try:
            self._call("draft", self._chunk_d_fn, params, jchunk, pos,
                       self._dev(ps.d_tables), nv)
            if end < S:
                self._call("target", self._chunk_t_fn, params, jchunk, pos,
                           self._dev(ps.t_tables), nv)
                ps.done = end
                self._note_chunk(ps, t0, start, end, final=False)
                return []
            slots = self._dev([g.slot for g in ps.gens], torch.long)
            first = self._call("target", self._chunk_t_final_fn, params,
                               jchunk, pos, slots, self._dev(ps.t_tables),
                               nv).cpu().numpy()
        except BaseException:
            # a failed chunk abandons the whole request: release its rows
            # so the pool keeps serving (the caller fails the futures).
            # Each column's pages restore in ONE call, in their original
            # take order — per-gen restores would break FIFO determinism.
            self._pending.popleft()
            t_pg, d_pg = [], []
            for g in ps.gens:
                self.slots[g.slot] = None
                t_pg += g.pages or []
                g.pages = None
                d_pg += self._d_owned.pop(g.slot, [])
            if t_pg:
                self._t_pages.restore(t_pg)
            if d_pg:
                self._d_pages.restore(d_pg)
            self._restore_slots([g.slot for g in ps.gens])
            raise
        self._pending.popleft()
        self._note_chunk(ps, t0, start, end, final=True)
        tok_now = self.telemetry.clock()
        for i, g in enumerate(ps.gens):
            g.tokens.append(int(first[i]))
            self._live[g.slot] = True
            self.stats["tokens_out"] += 1
            self._note_first_token(g, tok_now)
        self.stats["admitted_tokens"] += b
        for i, g in enumerate(ps.gens):
            # the prompt is now fully written into the target column: its
            # whole pages become indexable (BEFORE retirement, so an
            # instant retire still populates the cache)
            self._index_prompt(ps.tokens[i], g.pages)
        finished = self._retire_done(ps.gens)
        if finished:
            self._salt_admit_key()
        return finished

    # ----------------------------------------------------------- retirement
    def _retire_done(self, gens: list[Generation]) -> list[Generation]:
        """Retire finished rows AND release both columns' pages (FIFO: to
        the back of each free-list).  The retired slot stops being live,
        so its writes route to the park page from the next round on."""
        finished = SlotPool._retire_done(self, gens)
        for g in finished:
            if g.pages:
                self._t_pages.release(g.pages)
                g.pages = None
            d = self._d_owned.pop(g.slot, None)
            if d:
                self._d_pages.release(d)
        return finished

    # ----------------------------------------------------------------- round
    def step(self, params=None) -> list[Generation]:
        """One engine tick: at most one chunk tick (chunked admission),
        then one speculative round for every live slot — K+1 draft steps,
        one verify pass, 1..K+1 committed tokens per row.  Returns the
        generations that finished at this boundary."""
        self._bank_check()
        finished = self.prefill_tick(params) if self._pending else []
        if not self._live.any():
            return finished
        remaining = np.zeros(self.batch_size, np.int32)
        for s, g in enumerate(self.slots):
            if g is not None and self._live[s]:
                remaining[s] = g.remaining
        live_np = self._live.copy()
        live = self._dev(live_np, torch.bool)
        fns = self._programs(self.k)
        base = self.sampler.fold(self.sampler.key, self.sampler.t)
        t0 = self.telemetry.clock()
        props, dlogits = self._call("draft", fns["roll"], params, live, base)
        out = self._call("target", fns["verify"], params, props, dlogits,
                         live, self._dev(remaining), base)
        if self.tree_width > 1:
            # the target column repaired itself inside the verify
            # program; the draft column repairs here, host-gated (the
            # common all-chain rounds skip the extra draft step)
            toks, m, alt_depth, alt_tok, rpos = out
            alt_live = live_np & (alt_depth.cpu().numpy() > 0)
            if alt_live.any():
                self._call("draft", self._repair_d_fn, params,
                           alt_tok[:, None], rpos,
                           self._dev(alt_live, torch.bool))
                self.stats["draft_steps"] += 1
        else:
            toks, m = out
        self.sampler.advance()            # the key moves once per round
        res = torch.cat([toks.reshape(-1), m]).cpu().numpy()
        toks = res[:-self.batch_size].reshape(self.batch_size, -1)
        m = res[-self.batch_size:]
        now = self.telemetry.clock()
        stepped = []
        committed = 0
        reg = self.telemetry.registry
        for s in range(self.batch_size):
            g = self.slots[s]
            if g is None or not live_np[s]:
                continue              # empty, or reserved mid-prefill
            new = [int(x) for x in toks[s, :m[s]]]
            if self.eos_id is not None and self.eos_id in new:
                new = new[:new.index(self.eos_id) + 1]
            g.tokens.extend(new)
            committed += len(new)
            reg.observe("spec_accept_len", float(len(new)),
                        buckets=SPEC_ACCEPT_BUCKETS,
                        doc="tokens committed per row per "
                            "speculative round")
            stepped.append(g)
        self.stats["rounds"] += 1
        self.stats["row_rounds"] += len(stepped)
        self.stats["draft_steps"] += self.k + 1
        self.stats["committed_tokens"] += committed
        self.stats["tokens_out"] += committed
        # per-token latency: the round amortizes over the tokens each row
        # committed (1..K+1); the round itself is not a decode tick
        self._note_tick(t0, now, safe_ratio(committed, len(stepped)),
                        len(stepped))
        if self._trace.enabled:
            self._trace.instant(
                "spec-round", f"{self.telemetry.prefix}eng", ts=now,
                args={"committed": committed, "rows": len(stepped),
                      "k": self.k, "tree_width": self.tree_width,
                      "accepted": [int(x) for x in m if x]})
        return finished + self._retire_done(stepped)
