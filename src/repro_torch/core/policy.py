"""Unified reconfiguration policy — the single source of truth for slot
allocation, LRU eviction, and lookahead prefetch.

The paper's dual-slot fabric needs three decisions made over and over:

  * which slot a context load may claim (never the ACTIVE one),
  * which resident context to evict when every slot is occupied (LRU,
    never the active one, never a load in flight — a queued load is a
    commitment on the single configuration port and cannot be cancelled),
  * which upcoming contexts to stream into shadow slots while the active
    one executes (lookahead prefetch, the self-loading next-configuration
    fetch of LUTstructions applied to model weights).

Before this module those decisions were re-implemented inline in the
discrete-event simulator, the live runner, the streaming server, and the
launcher — four copies that could (and did) drift.  ``ReconfigPolicy`` is
the one implementation: a pure, deterministic state machine with no clocks
and no threads.  The simulator and the live ``ContextSwitchEngine`` feed it
the same events and perform the actions it returns on their own substrate
("simulate what you fly"); the property tests in ``tests/test_policy.py``
assert that both callers produce identical action traces.

State model (mirrors the engine's slot states):

  * ``resident``  — contexts whose weights are in a slot, LRU order
                    (least-recent first); evictable unless active
  * ``pending``   — contexts queued/streaming on the configuration port;
                    pinned until ``complete`` moves them to resident
  * ``active``    — the context the select signal points at; never evicted

Invariant: ``len(resident) + len(pending) <= num_slots``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Sequence


@dataclass(frozen=True)
class EnsureDecision:
    """What must happen so `net` can occupy a slot.

    ``evictions`` are performed first (in order), then — iff ``load`` —
    a load is issued on the configuration port.  ``load=False`` means the
    net is already resident or pending (nothing to do).
    """
    net: str
    evictions: tuple[str, ...] = ()
    load: bool = False


class ReconfigPolicy:
    """Deterministic LRU + lookahead-prefetch slot policy.

    Pure bookkeeping: callers perform the physical work (device transfers,
    slot flips) and report events back.  Every decision is appended to
    ``trace`` so independent callers can be compared action-for-action.
    """

    def __init__(self, num_slots: int = 2,
                 lookahead: Optional[int] = None):
        assert num_slots >= 2, "dynamic reconfiguration needs >= 2 slots"
        self.num_slots = num_slots
        self.lookahead = lookahead          # None = unbounded window
        self.resident: list[str] = []       # LRU order, most-recent last
        self.pending: list[str] = []        # issue order on the config port
        self.active: Optional[str] = None
        self.trace: list[tuple[str, str]] = []

    # ------------------------------------------------------------- queries
    def occupied(self) -> int:
        return len(self.resident) + len(self.pending)

    def is_resident(self, net: str) -> bool:
        return net in self.resident

    def is_pending(self, net: str) -> bool:
        return net in self.pending

    def holds(self, net: str) -> bool:
        return net in self.resident or net in self.pending

    # ----------------------------------------------------------- decisions
    def ensure(self, net: str, active: Optional[str] = None,
               protect: Iterable[str] = ()) -> Optional[EnsureDecision]:
        """Decide how `net` gets a slot; apply the decision to bookkeeping.

        ``active`` protects that context from eviction (pass ``None`` at a
        quiescent point — e.g. between runs — when even the previously
        active context may be overwritten).  ``protect`` shields further
        contexts (prefetch passes the ones needed *sooner* than `net`, so
        lookahead never cannibalizes its own earlier fetches).  Returns
        ``None`` when infeasible right now: every slot is pinned.
        Infeasibility never mutates state, so callers may simply retry
        later (the engine defers, the simulator stops prefetching).
        """
        if self.holds(net):
            return EnsureDecision(net=net)
        protect = set(protect)
        need = self.occupied() - self.num_slots + 1
        victims: tuple[str, ...] = ()
        if need > 0:
            candidates = [n for n in self.resident
                          if n != active and n not in protect]
            if len(candidates) < need:
                return None
            victims = tuple(candidates[:need])      # LRU first
        for v in victims:
            self.resident.remove(v)
            if v == self.active:
                self.active = None
            self.trace.append(("evict", v))
        self.pending.append(net)
        self.trace.append(("load", net))
        return EnsureDecision(net=net, evictions=victims, load=True)

    def prefetch(self, upcoming: Sequence[str],
                 active: Optional[str] = None,
                 limit: Optional[int] = None) -> list[EnsureDecision]:
        """Plan shadow-slot loads for the upcoming contexts (in need order)
        while `active` executes — the paper's hidden reconfiguration.

        Applies each decision to bookkeeping; the caller performs the
        physical evictions/loads in order.  A context needed sooner is
        protected from being evicted for one needed later; planning stops
        at the first infeasible target (the configuration port serves
        nearer needs first)."""
        order: list[str] = []
        seen: set[str] = set()
        for n in upcoming:
            if n not in seen:
                seen.add(n)
                order.append(n)
        out: list[EnsureDecision] = []
        if limit is None:
            limit = self.lookahead
        for j, net in enumerate(order):
            if limit is not None and len(out) >= limit:
                break
            if self.holds(net):
                continue
            dec = self.ensure(net, active=active, protect=order[:j])
            if dec is None:
                break
            out.append(dec)
        return out

    def rank_contexts(self, pressure: Mapping[str, float],
                      load_cost: Optional[Mapping[str, float]] = None,
                      cost_weight: float = 1.0) -> list[str]:
        """Order contexts by serving priority (highest first).

        ``pressure`` is queue pressure per context (e.g. queued request
        count, optionally age-boosted by the caller for starvation
        freedom); ``load_cost`` the estimated seconds to make a context
        resident (0 for resident/pending ones — switching is O(1)).
        Score = pressure − cost_weight·load_cost: a busy resident context
        beats a slightly busier cold one, amortizing switches.  Ties break
        by name for determinism.
        """
        load_cost = load_cost or {}

        def score(net: str) -> tuple:
            cost = 0.0 if self.holds(net) else float(load_cost.get(net, 0.0))
            return (-(pressure[net] - cost_weight * cost), net)

        return sorted((n for n, p in pressure.items() if p > 0), key=score)

    # -------------------------------------------------------------- events
    def complete(self, net: str):
        """A load finished: the context is resident (most-recently used)."""
        if net in self.pending:
            self.pending.remove(net)
        if net not in self.resident:
            self.resident.append(net)
            self.trace.append(("complete", net))

    def activate(self, net: str) -> Optional[str]:
        """The select signal flipped to `net`; returns the previous active.

        A still-pending net is completed first (the caller just blocked on
        its load).  Bumps `net` to most-recently-used.
        """
        if net in self.pending:
            self.complete(net)
        if net not in self.resident:
            raise KeyError(f"activate({net!r}): not resident")
        self.resident.remove(net)
        self.resident.append(net)
        prev, self.active = self.active, net
        self.trace.append(("activate", net))
        return prev

    def abort(self, net: str):
        """A queued/streaming load failed: free its commitment."""
        if net in self.pending:
            self.pending.remove(net)

    def release(self, net: str):
        """The context was evicted outside a policy decision (explicit
        ``engine.evict`` / conventional-baseline teardown)."""
        if net == self.active:
            self.active = None
        if net in self.resident:
            self.resident.remove(net)
            self.trace.append(("evict", net))

    def deactivate(self):
        """Park the select signal (slot stays resident)."""
        self.active = None

    # ---------------------------------------------------------------- misc
    def reset(self):
        self.resident.clear()
        self.pending.clear()
        self.active = None
        self.trace.clear()

    def actions(self, kinds: Iterable[str] = ("load", "evict",
                                              "activate")) -> list[tuple]:
        """Trace filtered to the decision kinds callers must agree on."""
        want = set(kinds)
        return [t for t in self.trace if t[0] in want]

    def snapshot(self) -> dict:
        return {"resident": list(self.resident),
                "pending": list(self.pending), "active": self.active}

    def __repr__(self):
        return (f"ReconfigPolicy(slots={self.num_slots}, "
                f"resident={self.resident}, pending={self.pending}, "
                f"active={self.active!r})")
