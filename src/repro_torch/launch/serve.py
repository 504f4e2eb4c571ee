"""Serving launcher of the port: context-switching inference over N
registered models, with the JAX launcher's flags and JSON report.

``python -m repro_torch.launch.serve --archs supersub-super,supersub-sub --steps 4``

Four modes:

  * ``--mode queue`` (default) — the async ``SwitchScheduler``: requests
    for all models are submitted up front; the scheduler coalesces
    same-model requests into streaks, ranks the next model by queue
    pressure + load cost, and streams it into the shadow slot while the
    active streak executes.
  * ``--mode continuous`` — the token-granular ``ContinuousScheduler``:
    requests join/leave a persistent slot-pooled step engine at every
    decode step (``--pool`` sets the slot-pool width); ``--paged
    --page-size N`` gives each context a paged slot pool;
    ``--prefill-chunk C`` admits prompts in C-token chunks, one per step;
    ``--multi-step T`` fuses up to T decode steps into each tick (one
    CUDA graph replay on the card); ``--quantize-kv int8`` (with ``--paged``) stores the page pools in
    int8 with per-token-per-head scales; ``--shards N`` (with
    ``--paged``) splits each page bank into N per-shard free-lists, over
    a mesh of N devices only when every shard lies on the model's device
    (``--platform cpu --host-devices N`` makes N logical CPU devices);
    otherwise, on one card or several, the bank shards logically
    (``serving_mesh``); ``--prefix-cache`` (with ``--paged``) maps a
    request's already written whole-page prompt prefix read-only and
    prefills only its suffix.
  * ``--mode speculative`` — continuous batching with speculative cascade
    decode: ``--draft NAME`` names the draft context; every other
    registered context becomes a verify target whose requests run on a
    ``SpecEngine`` (draft proposes ``--spec-k`` tokens per round, the
    target scores them in one multi-token verify pass; ``--spec-tree W``
    verifies W candidates a depth as one token tree; ``--spec-adaptive``
    walks K from the measured acceptance).  Draft/target hand-offs are
    O(1) select flips with the other side prefetched into the shadow
    slot — the paper's Super-Sub cascade as a serving mode.
  * ``--mode sync`` — the synchronous round-robin loop (the baseline the
    paper compares against).

Models are the reduced (CPU-sized) configs unless ``--full`` asks for the
published widths.  ``--platform cpu`` runs the plain PyTorch path on the
CPU; by default the port runs on the CUDA card and fails without one.
Flags of the JAX launcher whose features are not ported yet exit with an
argparse error that names them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, override, reduced as make_reduced
from repro_torch.core import env
from repro_torch.core.env import resolve_device, torch_dtype
from repro_torch.distributed.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.serve.scheduler import ContinuousScheduler, SwitchScheduler
from repro_torch.serve.switching import ServedModel, SwitchableServer
from repro_torch.serve.telemetry import Telemetry


def build_server(names: list[str], slots: int, max_len: int,
                 temperature: float = 0.0,
                 load_delay_s: float = 0.0,
                 arch_overrides: dict | None = None,
                 telemetry: Telemetry | None = None,
                 reduce: bool = True, device=None
                 ) -> tuple[SwitchableServer, dict]:
    """Register `names` (reduced configs unless ``reduce=False``) behind
    one SwitchableServer on ``device``.

    Weights are made from seed i for the i-th name on the device, then
    kept in pinned host memory: ``weights_fn`` hands the loader host
    tensors, so every context load is a real host->device copy.
    ``load_delay_s`` sleeps in each ``weights_fn`` to emulate a slower
    link.  ``arch_overrides`` are extra config fields (e.g. float32
    dtypes for tests that compare two execution paths bitwise); the KV
    cache takes the activation dtype."""
    dev = resolve_device(device)
    server = SwitchableServer(num_slots=slots, device=dev,
                              telemetry=telemetry)
    cfgs = {}
    over = arch_overrides or {}
    for i, name in enumerate(names):
        cfg = get_arch(name)
        cfg = make_reduced(cfg, **over) if reduce else override(cfg, **over)
        cfgs[name] = cfg
        model = build_model(cfg, cache_dtype=torch_dtype(cfg.dtype),
                            device=dev)
        params = _to_host(model.init(seed=i))

        def weights_fn(p=params):
            if load_delay_s:
                time.sleep(load_delay_s)
            return p
        server.register(ServedModel(name=name, model=model,
                                    weights_fn=weights_fn,
                                    max_len=max_len,
                                    temperature=temperature))
    return server, cfgs


def _to_host(tree):
    """Device weight tree -> host tree (pinned when a card is present)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    t = tree.cpu()
    return t.pin_memory() if torch.cuda.is_available() else t


def request_stream(names, cfgs, n_requests, batch, seq, seed):
    """Round-robin mixed-model traffic (worst case for switching)."""
    rng = np.random.default_rng(seed)
    for r in range(n_requests):
        name = names[r % len(names)]
        toks = rng.integers(0, cfgs[name].vocab_size, (batch, seq))
        yield name, toks


# JAX launcher flags whose features the port does not have yet, with the
# value that means "off"
_NOT_PORTED = {"x64": False}


def visible_devices(platform: str | None, host_devices: int | None):
    """The devices a mesh may take, as JAX counts them: on the CPU
    platform ``host_devices`` logical CPU devices (JAX's forced host
    device count; 1 by default), else the visible CUDA cards."""
    if platform == "cpu":
        return [torch.device("cpu")] * (host_devices or 1)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def serving_mesh(shards: int | None, devices, model_device):
    """The mesh a ``--paged --shards N`` run gives its page bank, or None.

    As in JAX, a mesh needs N visible devices; the port adds that every
    shard must lie on the model's device, since placing shards on several
    distinct cards is not ported yet.  So the CPU platform's N logical
    devices get ``Mesh((cpu,) * N)``, and a machine with one card, or with
    N or more distinct cards, gets None: the bank shards logically (one
    free-list per shard over one bank), as on a one-card machine."""
    if shards is None or shards <= 1 or len(devices) < shards:
        return None
    devices = [torch.device(d) for d in devices[:shards]]
    if any(d != torch.device(model_device) for d in devices):
        return None
    return make_mesh((shards,), ("model",), devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", default="supersub-super,supersub-sub")
    ap.add_argument("--mode",
                    choices=("queue", "continuous", "speculative", "sync"),
                    default="queue")
    ap.add_argument("--pool", type=int, default=8,
                    help="continuous/speculative mode: slot-pool width")
    ap.add_argument("--draft", default=None,
                    help="speculative mode: draft context name (must be "
                         "one of --archs; the remaining archs become "
                         "verify targets)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative mode: draft tokens per round (the "
                         "adaptive ceiling when --spec-adaptive is set)")
    ap.add_argument("--spec-tree", type=int, default=1,
                    help="speculative mode: sibling candidates per draft "
                         "depth — 1 is the flat chain; W>1 verifies a "
                         "token tree so a rejected chain can still "
                         "commit an accepted sibling (needs "
                         "1 + K*W <= 31 tree nodes)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="speculative mode: let the scheduler walk each "
                         "engine's K inside [1, --spec-k] from the "
                         "measured acceptance rate (EWMA, hysteresis)")
    ap.add_argument("--paged", action="store_true",
                    help="continuous mode: paged slot pool — per-slot "
                         "page tables over one shared KV page bank")
    ap.add_argument("--page-size", type=int, default=256,
                    help="paged mode: tokens per KV page (must divide "
                         "the serving max_len)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous mode: admit prompts in fixed-size "
                         "chunks of this many tokens, one chunk per step "
                         "(admission latency for live rows bounded by one "
                         "chunk)")
    ap.add_argument("--multi-step", type=int, default=1, metavar="T",
                    help="continuous mode: fuse up to T decode steps into "
                         "one device program per scheduler tick (one CUDA "
                         "graph replay on the card; the host's "
                         "rank/drain/admit bookkeeping amortizes over up "
                         "to T tokens; streams stay bitwise those of T "
                         "single steps)")
    ap.add_argument("--quantize-kv", choices=("none", "int8"),
                    default="none",
                    help="paged mode: store the shared KV page pool in "
                         "int8 with per-token-per-head scales — about "
                         "half the bytes per page (outputs are "
                         "tolerance-close, not bitwise)")
    ap.add_argument("--shards", type=int, default=None,
                    help="paged mode: split each engine's KV page bank "
                         "into this many shards with one free-list each; "
                         "admission puts a request's pages on the "
                         "least-loaded shard.  The bank gets a mesh only "
                         "when every shard lies on the model's device "
                         "(--platform cpu --host-devices N); otherwise it "
                         "shards logically")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged mode: share already written prompt pages "
                         "across admissions — a request whose prompt "
                         "starts with a cached whole-page run maps those "
                         "pages read-only and prefills only the "
                         "divergent suffix (copy-on-write on the "
                         "boundary page); cached pages are evicted "
                         "LRU-first under page pressure")
    ap.add_argument("--host-devices", type=int, default=None,
                    metavar="N",
                    help="with --platform cpu: N logical CPU devices, for "
                         "a --shards mesh without hardware")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="cpu: the plain PyTorch path on the CPU; gpu "
                         "(the default): the CUDA card")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths instead of the "
                         "reduced configs (needs the card)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-request lifecycle spans and export "
                         "Chrome trace-event JSON here on exit")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    metavar="SECONDS",
                    help="while requests are in flight, print a metric "
                         "registry snapshot (one JSON line to stderr) "
                         "every SECONDS; 0 disables")
    # flags of the JAX launcher that are not ported yet (rejected below)
    ap.add_argument("--x64", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    asked = ["--" + k.replace("_", "-") for k, off in _NOT_PORTED.items()
             if getattr(args, k) != off]
    if asked:
        ap.error(f"{', '.join(asked)}: not yet ported to repro_torch")
    if args.multi_step < 1:
        ap.error("--multi-step must be >= 1")
    if args.shards is not None and (args.shards < 1 or not args.paged):
        ap.error("--shards needs --paged and a positive shard count")
    if args.host_devices is not None and args.host_devices < 1:
        ap.error(f"host device count must be >= 1, got "
                 f"{args.host_devices}")
    if args.quantize_kv != "none" and not args.paged \
            and args.mode != "speculative":
        ap.error("--quantize-kv targets the shared page bank: it "
                 "requires --paged (or --mode speculative, whose cache "
                 "columns are always paged)")
    if args.prefix_cache and not args.paged \
            and args.mode != "speculative":
        ap.error("--prefix-cache shares pages of the pooled bank: it "
                 "requires --paged (or --mode speculative, whose target "
                 "column is always paged)")
    if args.spec_k < 1:
        ap.error("--spec-k must be >= 1 (one drafted token per round is "
                 "the minimum speculative step)")
    if args.spec_tree < 1:
        ap.error("--spec-tree must be >= 1 (1 is the flat chain)")
    if args.mode == "speculative":
        if args.draft is None:
            ap.error("--mode speculative requires --draft: name the "
                     "context that proposes tokens (the remaining "
                     "--archs become verify targets)")
        if 1 + args.spec_k * args.spec_tree > 31:
            ap.error(f"--spec-k {args.spec_k} with --spec-tree "
                     f"{args.spec_tree} needs 1 + K*W <= 31 tree nodes "
                     "(ancestor masks live in an int32 bitmask); lower "
                     "one of them")
    else:
        if args.draft is not None:
            ap.error("--draft only applies to --mode speculative")
        if args.spec_tree != 1:
            ap.error("--spec-tree only applies to --mode speculative")
        if args.spec_adaptive:
            ap.error("--spec-adaptive only applies to --mode speculative")
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    names = args.archs.split(",")
    slack = args.spec_k if args.mode == "speculative" else 0
    max_len = args.seq + args.steps + slack + 8
    if args.paged:
        # a paged pool's row space is a whole number of pages
        ps = min(args.page_size, max_len)
        max_len = -(-max_len // ps) * ps
    telemetry = Telemetry(trace=args.trace_out is not None)
    server, cfgs = build_server(names, args.slots, max_len,
                                telemetry=telemetry, reduce=not args.full,
                                device=device)
    stats_stop = None
    if args.stats_interval > 0:
        import threading
        stats_stop = threading.Event()

        def _stats_loop():
            while not stats_stop.wait(args.stats_interval):
                print(json.dumps(telemetry.registry.snapshot(),
                                 default=str), file=sys.stderr)
        threading.Thread(target=_stats_loop, daemon=True,
                         name="stats-reporter").start()
    draft_map = {}
    if args.mode == "speculative":
        if args.draft not in names:
            ap.error(f"--draft {args.draft!r} must be one of "
                     f"--archs {names}")
        targets = [n for n in names if n != args.draft]
        draft_map = {t: args.draft for t in targets}
        reqs = list(request_stream(targets, cfgs, args.requests,
                                   args.batch, args.seq, args.seed))
    else:
        reqs = list(request_stream(names, cfgs, args.requests, args.batch,
                                   args.seq, args.seed))
    mesh = serving_mesh(args.shards,
                        visible_devices(args.platform, args.host_devices),
                        device)

    t0 = time.perf_counter()
    if args.mode in ("queue", "continuous", "speculative"):
        sched_cls = (SwitchScheduler if args.mode == "queue" else
                     lambda s: ContinuousScheduler(
                         s, batch_size=args.pool, draft=draft_map,
                         spec_k=args.spec_k, spec_tree=args.spec_tree,
                         spec_adaptive=args.spec_adaptive,
                         prefill_chunk=args.prefill_chunk,
                         paged=args.paged, page_size=args.page_size,
                         quantize_kv=(None if args.quantize_kv == "none"
                                      else args.quantize_kv),
                         shards=args.shards, mesh=mesh,
                         multi_step=args.multi_step,
                         prefix_cache=args.prefix_cache))
        with sched_cls(server) as sched:
            futs = [(sched.submit(n, t, steps=args.steps),
                     time.perf_counter()) for n, t in reqs]
            lat = []
            for f, t_in in futs:
                f.result()
                lat.append(time.perf_counter() - t_in)
        extra = {**sched.snapshot()}
        if lat:
            extra["latency_p50_s"] = round(float(np.percentile(lat, 50)), 4)
            extra["latency_p99_s"] = round(float(np.percentile(lat, 99)), 4)
    else:
        for i, (name, toks) in enumerate(reqs):
            server.engine.preload(name)
            server.engine.switch(name, wait=True)
            server.engine.prefetch([n for n, _ in reqs[i + 1:]], limit=1)
            server.serve_batch(name, toks, steps=args.steps)
        extra = {}
    wall = time.perf_counter() - t0

    stats = server.engine.stats
    report = {
        "mode": args.mode,
        "wall_s": round(wall, 3),
        "requests_per_s": round(args.requests / wall, 2) if wall else 0.0,
        "switches": stats["switches"],
        "context_changes": stats["context_changes"],
        "mean_switch_us": round(1e6 * stats["switch_seconds"]
                                / max(stats["switches"], 1), 1),
        "loads": stats["loads"],
        "mean_load_ms": round(1e3 * stats["load_seconds"]
                              / max(stats["loads"], 1), 2),
        "bytes_loaded": stats["bytes_loaded"],
        "hidden_load_fraction": round(
            server.engine.hidden_load_fraction(), 3),
        **extra,
        "env": env.describe(device),
        "log_tail": server.log[-3:],
    }
    if stats_stop is not None:
        stats_stop.set()
    if args.trace_out:
        report["trace_out"] = telemetry.tracer.export(args.trace_out)
        report["trace_events"] = len(telemetry.tracer)
    print(json.dumps(report, indent=1, default=str))
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
