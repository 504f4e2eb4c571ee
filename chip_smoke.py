#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

  1. setup    — the card's name and power limit (nvidia-smi), then every
                hand-written kernel built from the sources in this
                checkout (one nvcc per source, all in parallel), and the
                count of wgmma (HGMMA) and TMA-load (UTMALDG) instructions
                in the SASS of the flash, gmm, paged and verify libraries,
                of mma.sync (HMMA) and cp.async (LDGSTS) in the decode,
                paged, partial and mLSTM libraries, and of cp.async in the
                scan library (nonzero).
  2. kernels  — each kernel body at the main path's shapes against its
                plain PyTorch version on the card, timed with CUDA events
                beside its plain version, one PyTorch call for the same
                work where there is one (timed only; the port never calls
                it) and its bound.  tinyllama-1.1b attention (H=32,
                Hkv=4, hd=64, bf16; verify at chunk width 128, the tree
                mask at 8), bf16 within 2e-2, the verify records also each
                score row within 2**-7 relative L2, a limit shown to catch
                the cache/block boundary or the causal diagonal one key
                late and one tree bit cleared, and flash again at
                mixtral-8x7b's prefill (H=32, Hkv=8, hd=128, one
                4160-token prompt, window 4096, the model's transposed
                views; its library call SDPA under the same mask; each
                query row within 2**-7 relative L2 of the plain one, a
                limit that a window edge off by one key tile or by one
                key is shown to leave); the decode records (row, paged,
                int8, and ``paged_decode_attention_long``: 8 rows at
                positions 1000-4000 through page-256 tables) and ring
                decode also each row within 2**-7 relative L2, a limit
                shown to catch one split's run of keys missing and one
                key past pos, with their kernel time beside SDPA's; the
                ring bodies at
                mixtral-8x7b's (H=32, Hkv=8, hd=128, a 4096-slot ring),
                each element within 1e-4 + 2**-7 of the plain value, a
                limit that a one-slot mask fault is shown to leave (ring
                verify also each score row within 2**-7).  The
                selective scan at jamba-v0.1-52b's (d_in=8192, N=16, f32,
                B=2, L=512, and L=8 from a carried state; and as
                ``ssm_scan_serving`` at B=1 and jamba's first prompt of
                the hybrid pass) within 1e-4 of the plain version's
                largest value, a limit shown to catch one lane group's
                state or one time tile's carry dropped.  The chunkwise
                mLSTM at xlstm-125m's (H=4, dh=384, chunk 256, f32, B=2,
                L=512; and as ``mlstm_chunk_serving`` at B=1, L=768):
                h, C and n within 5e-4, m within 1e-5, each times
                max(1, the plain version's largest value), limits shown
                to catch one chunk's carried state dropped or read one
                chunk late.  The scan and mLSTM records log their kernel
                time and their bound at their route's rate (the
                exponentials' rate; 3xTF32 on the tensor cores).  One shard's
                decode partial (B5) at tinyllama-1.1b's attention over a
                bank split into 4 slices, every base, rows that own no
                page, bf16 and int8: acc, m and l each within 1e-4 times
                max(1, the plain output's largest value), the merged
                partials against one paged decode (bit for bit, in the
                rows whose pages lie on one shard).  The grouped matmul
                (B7) at mixtral-8x7b's expert shapes after a 4-shard
                all_to_all, (2, 320, 4096) @ (2, 4096, 14336) and the
                down product (2, 320, 14336) @ (2, 14336, 4096), within
                one bf16 ulp.  Flash, gmm, the decode and the verify
                records also log their device kernel time
                (torch.profiler), the decode and verify records beside
                their SDPA call's.  The paged verify also at the
                speculative passes' shapes (8 rows over 3-page tables of
                256: the flat passes' 5 tokens under the causal mask, and
                the tree route over 13 nodes of a depth-4, width-3
                sausage tree, fp and int8), each score row within 2**-7,
                a limit shown to catch the cache/block boundary or the
                causal diagonal one key late and one tree bit cleared.
  3. reference — each served model at full width, cut to one layer, on
                the card (kernels, bf16), held against the plain path on
                the CPU in float32 on the same weights: the dense models'
                ``forward``, row, paged and int8 decode, chunked prefill
                on the row cache and a page pool; mixtral-8x7b's forward,
                prefill, ring decode and a ring verify that wraps; one
                jamba-v0.1-52b Mamba block's prefill, decode and 8-token
                verify from its state; one xlstm-125m mLSTM block's
                512-token chunkwise prefill, decode and 4-token verify
                from its state, and one sLSTM block's.  Then, logged
                only, how far an int8 pool moves the full-depth
                tinyllama-1.1b's logits.  Then tinyllama-1.1b's
                speculative engine at one layer: a tree round's verify
                (13 nodes) and a flat one against the CPU float32 path,
                the greedy accept rules on the card's logits bitwise the
                CPU's; one tree round with a sibling hit planted (the
                draft's top two candidates swapped), which must commit
                the sibling and repair both columns' k/v at its
                position, against an unplanted twin; and an aligned
                draft's acceptance at 1-8 layers, which at one layer
                must reach 3 tokens a round and 0.9 agreement with the
                plain engine (deeper, logged).
  4. serving  — the port's ``SwitchableServer`` with tinyllama-1.1b and
                supersub-super at their published widths, requests
                alternating contexts, through ContinuousScheduler(paged),
                ContinuousScheduler(row), SwitchScheduler, and
                ContinuousScheduler with chunked prefill (C=128) on the
                row cache, on a page pool and on an int8 page pool, and
                ContinuousScheduler(paged) and (row) again with fused
                decode (``multi_step=8``: each tick one CUDA graph replay
                of 8 steps), whose streams must be bitwise those of their
                single-step twins; then
                ``continuous_row_moe_hybrid``: mixtral-8x7b (4 layers)
                and jamba-v0.1-52b (8 layers) at published widths through
                ContinuousScheduler(row), one mixtral prompt past the
                window; then ``continuous_row_xlstm``: xlstm-125m (all
                12 layers) and tinyllama-1.1b at published widths through
                ContinuousScheduler(row), prompts of 300, 512 and 768
                tokens (the two longer ones prefill through the chunkwise
                mLSTM kernel); each of these two served again on the
                same weights with fused decode (``multi_step=8``),
                bitwise the single-step streams;
                ``continuous_paged_sharded``, the paged
                pass again with shards=4 (logical), whose streams must
                be bitwise those of ``continuous_paged``;
                ``sharded_local_read``: a full tinyllama-1.1b StepEngine
                over Mesh((cuda:0,) * 4) with local reads (B5), bf16,
                int8 and chunked, its decode logits within 1e-2 rel L2
                of the global read; ``moe_ep_mesh``: mixtral-8x7b (4
                layers) under the same mesh, a 2 x 512 prefill through
                moe_ep (B7, 48 launches) and 4 decode steps through
                moe_tp, one full-width MoE layer against the CPU in
                float32; ``prefix_*``: the prefix cache on a full
                tinyllama-1.1b StepEngine with bench_prefix.py's traffic
                (10 requests, a 2048-token shared preamble and a
                32-token tail each, 16 new tokens), cache off and on,
                one-shot (also int8, ``multi_step=8`` and ``shards=4``)
                and chunked (C=256, fp and int8, and with local reads
                over Mesh((cuda:0,) * 4)): 9 hits of 8 mapped pages
                each, B4 launched by the one-shot prefix engine at the
                hit's shape and by the chunked ones at the chunk's (both
                also kernel records, fp and int8), the fused and sharded
                passes bitwise the one-shot prefix pass, each chunked
                prefix pass bitwise its cold chunked twin, and a
                copy-on-write hit that leaves every indexed
                page bitwise unchanged; logged: hit vs cold greedy
                agreement, time to first token, decode tokens/s on and
                off, peak rows at 19 pages; ``spec_*``: speculative
                decoding of tinyllama-1.1b through ContinuousScheduler
                (8 requests, 2 weight slots, pages of 256): a plain
                twin, flat K=4 with an aligned draft (B4 at the flat
                record's shape), the same on a
                SharedBank (bitwise the flat pass), a K=4, W=3 tree with
                a noised draft (B4's tree route) and that tree on chunked
                int8 columns, each logged with its tokens/s, accepted
                tokens a round, rounds and greedy agreement beside the
                twin's.  Every request must resolve
                with the right shape, and each kernel route's launch
                count (zeroed right before a pass) must rise in the pass
                that uses it.
  5. profile  — steady decode steps of a full tinyllama-1.1b step engine
                (row and paged, 8 rows): step wall time, device kernel
                time and busy share, top kernels (torch.profiler); the
                same engines fused (``multi_step=8``), per committed
                step, with their graph captures and capture seconds,
                which must take less wall time a step than the single
                steps; ``generate_fused`` bitwise ``generate``.
  6. supersub — the paper's Super-Sub workload and its reconfiguration
                model on ``ContextSwitchEngine``:
                ``cascade_reference``, the router classifier
                (supersub-super cut to one layer, mean-pooled, a
                (256, 4) head) on 64 sequences of 256 tokens of
                ``HierarchicalTask`` (4 superclasses of 3 subclasses,
                vocab 512), each row of pooled logits within REF_TOL
                relative L2 of the CPU float32 path; ``cascade_pipelined``,
                the likelihood router, a supersub-super generalist (12
                classes) and four supersub-sub specialists (3 classes)
                at published widths on two slots, 8 single-subclass
                batches of 64 x 256: the pipelined cascade bitwise the
                sequential one on a fresh engine, some specialist load
                hidden, the same predictions on three slots (hidden
                load logged), flash launched at the cascade's shape (also a
                kernel record), static and dynamic accuracy logged;
                ``context_delta``, a head-only delta over tinyllama-1.1b's
                backbone (``base=``): exactly the head's bytes moved,
                every backbone tensor the base slot's, logits bitwise a
                full load's, both loads' ms logged; ``schedule_live``,
                tinyllama-1.1b, supersub-super and supersub-sub on two
                slots through ``run_schedule_live``, the paper's case 2
                (two preloaded nets alternating) and case 3 (three nets,
                dynamic), each faster dynamic than conventional (the
                median of three alternating pairs), the
                simulators' savings from the measured times logged
                beside the measured ones.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
port's sources beside this script, it exits non-zero and prints neither.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 2e-2                   # bf16 kernel vs plain version on the card
# the ring bodies, elementwise: |kernel - plain| <= RING_ATOL + RING_RTOL *
# |plain|.  Both round an f32 result to bf16, so they differ by at most
# one bf16 ulp (2**-7 of the value); at 4096 live keys a typical output
# is only about 0.03, so the flat TOL would pass a one-slot mask fault
RING_ATOL, RING_RTOL = 1e-4, 2.0 ** -7
# windowed flash, per query row: |kernel - plain|_2 <= ROW_RTOL * |plain|_2.
# The kernel rounds P to bf16 before P.V, so where a row's few terms cancel
# an element may miss the ring rule, but a row stays within one bf16 ulp
# (2**-7) relative; a key tile dropped behind the window moves a row by
# about 10-20%, a single key by up to about 10% (check_window_rows)
ROW_RTOL = 2.0 ** -7
SCAN_RTOL = 1e-4             # f32 scan: max abs error / max |plain|
# f32 chunkwise mLSTM, times max(1, max |plain|): test_kernels.py's limits
MLSTM_TOL, MLSTM_M_TOL = 5e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12          # H100 SXM dense TF32 tensor-core peak
F32_FLOPS = 67e12            # H100 SXM f32 peak outside the tensor cores
# f32 products taken in 3xTF32 (three TF32 products each) on the tensor
# cores: the mLSTM kernel's route
TF32X3_FLOPS = TF32_FLOPS / 3
# exponentials: 16 a clock on each of the H100 SXM's 132 SMs' special
# function units, at its 1980 MHz boost clock
EXP_PER_S = 132 * 16 * 1.98e9
H, HKV, HD = 32, 4, 64       # tinyllama-1.1b attention
MH, MHKV, MHD = 32, 8, 128   # mixtral-8x7b / jamba-v0.1-52b attention
RING = 4096                  # mixtral-8x7b's window: ring slots
PROMPT_LENS = (128, 512)     # serving prompt range
NEW_TOKENS = 32
N_REQUESTS = 8
CHUNK = 128                  # chunked-prefill width of the serving passes
MULTI_STEP = 8               # fused decode steps a tick (multi_step passes)
SPEC_K, SPEC_W = 4, 3        # speculative depth and tree width (13 nodes)
# the Super-Sub cascade (supersub-super / supersub-sub: H=Hkv=8, hd=32):
# batches of 64 sequences of 256 tokens, its flash record at that shape
CASCADE_B, CASCADE_S, CASCADE_BATCHES = 64, 256, 8
CASCADE_FLASH_SHAPE = (CASCADE_B, 8, 8, CASCADE_S, 32, 0)
SPEC_PAGE, SPEC_P = 256, 3   # the speculative passes' pages: 768 slots


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events
    around each launch), after 3 warm-ups; ``flush()`` runs between
    launches, outside the timed window, to start each one with a cold L2
    the way the serving loop finds it (22 layers of cache > 50 MB)."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def kernel_us(prof) -> dict:
    """Device time (us) of each kernel name in a ``torch.profiler``
    trace, kernels only: a CPU op's device time repeats its kernels'."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        per[e.key] = per.get(e.key, 0.0) + us
    return per


def device_ms(fn, iters: int = 10, flush=None):
    """Mean device kernel time of one ``fn()`` call from
    ``torch.profiler`` (the kernels' own time summed, host dispatch and
    launch gaps left out; ``time_ms`` counts them), after 3 warm-ups;
    ``flush()`` runs between calls, outside the traced window.  "not
    measured" where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total += sum(kernel_us(prof).values())
    return total / iters / 1e3 if total else "not measured"


def limit_ratio(got, ref, atol: float, rtol: float) -> float:
    """Largest ``|got - ref| / (atol + rtol * |ref|)`` over the elements:
    at most 1 where ``got`` is within its limit of ``ref``."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def masked_attention(q, k, v, mask):
    """Plain float32 attention under an explicit mask, rounded to q's
    dtype: q (B, H, Q, hd); k/v (B, Hkv, T, hd); mask (B, 1, Q, T)."""
    import torch
    G = q.shape[1] // k.shape[1]
    k, v = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhtd->bhqt", q.float(), k) / q.shape[-1] ** 0.5
    s = s.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqt,bhtd->bhqd", torch.softmax(s, dim=-1), v)
    return out.to(q.dtype)


def check_sensitivity(name, q, k, v, mask, fault) -> None:
    """The ring records' limit must catch a one-slot mask fault: in every
    row where ``fault`` differs from ``mask`` (one key too many or too
    few), the attention under ``fault`` must leave the limit around the
    attention under ``mask``.  Logs the weakest such row's ratio."""
    good = masked_attention(q, k, v, mask).float()
    bad = masked_attention(q, k, v, fault).float()
    ratio = ((bad - good).abs() / (RING_ATOL + RING_RTOL * good.abs()))
    rows = (mask != fault).flatten(1).any(dim=1)
    weakest = ratio.flatten(1).amax(dim=1)[rows].min().item()
    log(f"kernel {name}: a one-slot mask fault moves the output to "
        f"{weakest:.3f} times the limit in the least moved of its "
        f"{int(rows.sum())} rows")
    if not weakest > 1.0:
        raise AssertionError(f"{name}: the limit does not catch a one-slot "
                             "mask fault")


def row_error(got, ref):
    """Relative L2 error of each query row of (B, H, S, hd) attention
    outputs -> (B, H, S)."""
    ref = ref.float()
    return ((got.float() - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30))


def check_window_rows(name, got, ref, run, W, tile) -> None:
    """The windowed flash record's row limit, and that it catches a
    window edge off by one key tile or by one key: ``run(w)`` is the
    kernel under window ``w``, held against the plain version under
    ``W``.  A tile shift must move every row that loses a whole tile out
    of the limit, a one-key shift at least one row (either fails the
    record).  Logs the correct kernel's worst row and each fault's."""
    import torch
    worst = row_error(got, ref).max().item()
    log(f"kernel {name}: worst row relative L2 error {worst:.3e} (limit "
        f"{ROW_RTOL:.3e}; ratio {worst / ROW_RTOL:.3f})")
    if not worst <= ROW_RTOL:
        raise AssertionError(f"{name}: a row's relative L2 error {worst} "
                             f"passes its limit {ROW_RTOL}")
    S = got.shape[2]
    t = torch.arange(S, device=got.device)
    for shift, whole in ((-tile, t >= W - 1), (-1, None)):
        bad = row_error(run(W + shift), ref) / ROW_RTOL
        rows = t >= W + shift               # rows whose key set changed
        most = bad[..., rows].max().item()
        msg = (f"kernel {name}: window {W}{shift:+d} (a fault) moves the "
               f"rows it changes to at most {most:.3f} times the limit")
        ok = most > 1.0
        if whole is not None:
            least = bad[..., whole].min().item()
            msg += (f", every row that loses a whole tile to at least "
                    f"{least:.3f}")
            ok = ok and least > 1.0
        log(msg)
        if not ok:
            raise AssertionError(f"{name}: the row limit does not catch a "
                                 f"window off by {-shift} keys")


def check_verify_rows(name, got, ref, q, k, v, mask, faults) -> None:
    """A verify record's row limit, and that it catches planted mask
    faults (a decode record's too, through ``check_decode_rows``).  ``got``/``ref``: the kernel's and the plain version's (B, H,
    K, hd) outputs, each score row within ``ROW_RTOL`` relative L2.  Each
    fault ``(label, fmask)`` is the record's (B, 1, K, T) mask over (q
    (B, H, K, hd), keys k/v (B, Hkv, T, hd)) with one planted fault: the
    plain attention under it is held against the plain attention under
    ``mask``, and the fault must move some changed row past the limit (so
    it fails the record).  Logs the kernel's worst row and, for each
    fault, its least and most moved changed rows."""
    worst = row_error(got, ref).max().item()
    log(f"kernel {name}: worst score row relative L2 error {worst:.3e} "
        f"(limit {ROW_RTOL:.3e}; ratio {worst / ROW_RTOL:.3f})")
    if not worst <= ROW_RTOL:
        raise AssertionError(f"{name}: a score row's relative L2 error "
                             f"{worst} passes its limit {ROW_RTOL}")
    good = masked_attention(q, k, v, mask)
    for label, fmask in faults:
        bad = masked_attention(q, k, v, fmask)
        ratio = row_error(bad, good) / ROW_RTOL             # (B, H, K)
        rows = (fmask != mask).any(dim=-1)                  # (B, 1, K)
        moved = ratio[rows.expand_as(ratio)]
        log(f"kernel {name}: fault '{label}' moves its {int(rows.sum())} "
            f"changed rows (x {q.shape[1]} heads) to {moved.min().item():.3f}"
            f"-{moved.max().item():.3f} times the row limit")
        if not moved.max().item() > 1.0:
            raise AssertionError(f"{name}: the row limit does not catch the "
                                 f"fault '{label}'")


def check_decode_rows(name, got, ref, q, k, v, mask, pos) -> None:
    """A decode record's row limit (``check_verify_rows`` on its one query
    a row) and two faults planted on the plain side that it must catch:
    one split's run of keys missing (in each row, the last block of its
    cluster that holds live keys, where that is not the first) and one
    key past pos.  ``got``/``ref`` (B, H, hd); q (B, H, hd); k/v (B, Hkv,
    T, hd), the T slots the kernel reads as a row's keys; ``mask`` (B, 1,
    1, T) the live ones; pos (B,)."""
    import torch
    from repro_torch import kernels
    B, Hkv, T = k.shape[0], k.shape[1], k.shape[2]
    splits = kernels.decode_splits(T)
    n = torch.clamp(pos.long(), max=T - 1) + 1                  # (B,)
    idx = torch.arange(T, device=q.device)[None, :]
    lost = torch.zeros(B, T, dtype=torch.bool, device=q.device)
    for lo, hi in kernels.decode_runs(T, splits)[1:]:
        run = (idx >= lo) & (idx < hi) & (lo < n)[:, None]
        lost = torch.where((lo < n)[:, None], run, lost)  # the last one
    live = mask[:, 0, 0]
    past = live | ((idx == n[:, None]) & (n < T)[:, None])
    faults = [("one split's run of keys missing",
               (live & ~lost)[:, None, None]),
              ("one key past pos", past[:, None, None])]
    log(f"kernel {name}: {splits} blocks a cluster, runs "
        f"{kernels.decode_runs(T, splits)}")
    check_verify_rows(name, got[:, :, None], ref[:, :, None], q[:, :, None],
                      k, v, mask, faults)


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def kernel_phase(dev) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         mha_reference)
    from repro_torch.kernels.verify_attention.ops import (verify_attention,
                                                          verify_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = []

    def record(name, source, replaces, got, ref, t_k, t_p, t_l, nbytes,
               flops, peak=BF16_FLOPS, tol=TOL, rtol=0.0, outputs=None):
        """One kernel record; ``got``/``ref`` may be tuples of outputs
        (the error is the largest over them), ``t_l`` None where no
        library call computes the same function.  Each element must lie
        within ``tol + rtol * |plain|`` of the plain version (``tol`` a
        tuple: one limit per output, each output's error/limit logged
        under its name in ``outputs``)."""
        pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got,
                                                                     ref)]
        tols = tol if isinstance(tol, tuple) else (tol,) * len(pairs)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in pairs)
        ratios = [limit_ratio(g, r, t, rtol)
                  for (g, r), t in zip(pairs, tols)]
        ratio = max(ratios)
        if outputs:
            log(f"kernel {name}: error/limit per output " + ", ".join(
                f"{o} {r:.3f} (limit {t:.3e})"
                for o, r, t in zip(outputs, ratios, tols)))
        tol = max(tols)
        bms, by = bound_ms(nbytes, flops, peak)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": t_k, "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
               "library_ms": t_l}
        lib = "none" if t_l is None else f"{t_l:.4f}"
        limit = f"{tol:.3e}" + (f" + {rtol:.3e}|plain|" if rtol else "")
        log(f"kernel {name}: max_abs_err={err:.3e} (limit {limit}; "
            f"worst error/limit {ratio:.3f}) ms={t_k:.4f} "
            f"plain_ms={t_p:.4f} library_ms={lib} bound_ms={bms:.4f} ({by})")
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: error {ratio} times its limit "
                                 f"{limit}")
        out.append(rec)
        return rec

    # flash prefill: B=4, S=512
    B, S = 4, 512
    q, k, v = rn(B, H, S, HD), rn(B, HKV, S, HD), rn(B, HKV, S, HD)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = mha_reference(q, k, v)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * HD * B * H * S * (S + 1) / 2          # causal pairs only
    record("flash_attention",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", got, ref,
           time_ms(lambda: flash_attention(q, k, v), flush=flush),
           time_ms(lambda: mha_reference(q, k, v), flush=flush),
           time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True), flush=flush),
           nbytes, flops)
    log_kernel_time("flash_attention", lambda: flash_attention(q, k, v),
                    flush)

    # flash at the Super-Sub cascade's batches (64 x 256 tokens, H=Hkv=8,
    # hd=32), on the model's (B, S, H, hd) projections seen as (B, H, S,
    # hd) views, as the attention layer passes them
    B, S = CASCADE_B, CASCADE_S
    q, k, v = (rn(B, S, 8, 32).transpose(1, 2) for _ in range(3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    record("flash_attention_cascade",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", got,
           mha_reference(q, k, v),
           time_ms(lambda: flash_attention(q, k, v), flush=flush),
           time_ms(lambda: mha_reference(q, k, v), flush=flush),
           time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True), flush=flush),
           2 * 4 * q.numel(), 4 * 32 * B * 8 * S * (S + 1) / 2)
    log_kernel_time("flash_attention_cascade",
                    lambda: flash_attention(q, k, v), flush)

    # windowed flash prefill at mixtral-8x7b's: one 4160-token prompt,
    # window 4096, on the model's (B, S, H, hd) projections seen as (B, H,
    # S, hd) views, as the attention layer passes them; bytes and
    # operations count only the pairs inside the window
    B, S, W = 1, LONG_PROMPT, RING
    q = rn(B, S, MH, MHD).transpose(1, 2)
    k, v = (rn(B, S, MHKV, MHD).transpose(1, 2) for _ in range(2))
    got = flash_attention(q, k, v, window=W)
    torch.cuda.synchronize()
    ref = mha_reference(q, k, v, window=W)
    check_window_rows("flash_attention_window", got, ref,
                      lambda w: flash_attention(q, k, v, window=w), W, 128)
    i = torch.arange(S, device=dev)
    wmask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
    pairs = sum(min(t + 1, W) for t in range(S))
    record("flash_attention_window",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", got, ref,
           time_ms(lambda: flash_attention(q, k, v, window=W), flush=flush),
           time_ms(lambda: mha_reference(q, k, v, window=W), iters=5,
                   flush=flush),
           time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=wmask, enable_gqa=True), flush=flush),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4 * MHD * B * MH * pairs)
    log_kernel_time("flash_attention_window",
                    lambda: flash_attention(q, k, v, window=W), flush)
    # the library yardsticks' kernel time: SDPA under the window mask (the
    # record's library call) runs off its flash backend; causal SDPA with
    # no window is a flash kernel over the same pairs and 64 rows' more
    # (99.95% of the causal pairs lie inside the window)
    masked = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=wmask, enable_gqa=True), flush=flush)
    causal = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush=flush)
    log(f"kernel flash_attention_window: SDPA kernel time ms under the "
        f"window mask={masked}, causal without the window={causal} "
        f"(window pairs / causal pairs {pairs / (S * (S + 1) // 2):.6f})")
    del q, k, v, got, ref, wmask

    decode_records(dev, gen, rn, flush, record)

    # verify (chunked prefill): B=4 rows, a K=128 chunk each at positions
    # 0, mid-page, a page boundary and mid second page; pages of 256
    B, K, page = 4, CHUNK, 256
    vpos = torch.tensor([0, 100, 256, 384], dtype=torch.int32, device=dev)
    P = 3
    S = P * page                                             # 768 slots
    NP = B * P + 1
    ids = torch.randperm(NP - 1, generator=gen, device=dev)[:B * P] + 1
    vtable = ids.reshape(B, P).to(torch.int32)
    dead = torch.arange(P, device=dev)[None, :] * page >= vpos[:, None] + K
    vtable = torch.where(dead, torch.zeros_like(vtable), vtable).contiguous()
    fp, q8 = (verify_pool(gen, rn, NP, page, int8) for int8 in (False, True))
    tree8 = torch.randint(0, 1 << 30, (B, 8), generator=gen, device=dev,
                          dtype=torch.int32)
    bit = torch.ones(8, device=dev, dtype=torch.int32) << torch.arange(
        8, device=dev, dtype=torch.int32)
    tree8 = ((tree8 & (bit - 1)) | bit).contiguous()   # self + ancestors
    for name, Kb, tree, pool in (
            ("paged_verify_attention", K, None, fp),
            ("paged_verify_attention_tree", 8, tree8, fp),
            ("paged_verify_attention_int8", K, None, q8)):
        paged_verify_record(record, flush, rn, name, pool, vtable, vpos, Kb,
                            tree)

    # the row verify at the same rows over a (B, Hkv, S, hd) row cache
    kr, vr = rn(B, HKV, S, HD), rn(B, HKV, S, HD)
    qv = rn(B, K, H, HD)
    bk, bv = rn(B, K, HKV, HD), rn(B, K, HKV, HD)
    got = verify_attention(qv, kr, vr, bk, bv, vpos)
    ref = verify_reference(qv, kr, vr, bk, bv, vpos)
    vmask, faults, pairs = verify_masks(vpos, S, K)
    qt = qv.transpose(1, 2)
    kall, vall = (torch.cat([c, b.transpose(1, 2)], dim=2)
                  for c, b in ((kr, bk), (vr, bv)))
    check_verify_rows("verify_attention", got.transpose(1, 2),
                      ref.transpose(1, 2), qt, kall, vall, vmask, faults)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kall, vall,
                                              attn_mask=vmask,
                                              enable_gqa=True)

    record("verify_attention",
           "src/repro_torch/kernels/verify_attention/csrc/"
           "verify_attention.cu",
           "src/repro/kernels/verify_attention/kernel.py:113", got, ref,
           time_ms(lambda: verify_attention(qv, kr, vr, bk, bv, vpos),
                   flush=flush),
           time_ms(lambda: verify_reference(qv, kr, vr, bk, bv, vpos),
                   flush=flush),
           time_ms(sdpa, flush=flush),
           2 * 2 * qv.numel() + 2 * 2 * bk.numel() + 4 * B
           + 2 * 2 * HD * int(vpos.sum()) * HKV, 4 * HD * H * pairs)
    log_kernel_time("verify_attention",
                    lambda: verify_attention(qv, kr, vr, bk, bv, vpos), flush,
                    sdpa)
    ring_verify_record(dev, rn, flush, record)
    prefix_verify_records(gen, rn, flush, record)
    spec_verify_records(gen, rn, flush, record)
    scan_record(dev, gen, flush, record)
    mlstm_record(dev, gen, flush, record)
    partial_records(dev, gen, rn, flush, record)
    gmm_record(dev, gen, flush, record)
    del l2
    return out


def decode_cases(dev, gen, rn) -> dict:
    """The decode records' inputs and calls, by record name: the row
    decode at tinyllama-1.1b's heads (H=32, Hkv=4, hd=64: 8 rows at
    positions 5 to 640 of 768 slots), the bf16 and int8 paged decode of
    the same rows through shuffled page-256 tables (entries past a row's
    position on the park page 0), ``paged_decode_attention_long`` (8
    rows at positions 1000 to 4000 through tables of 16 pages: the
    decode's bytes start to count) and the ring decode at mixtral-8x7b's
    heads (H=32, Hkv=8, hd=128: 8 rows at positions 100 to 9000 of a
    4096-slot ring).  Each case is a dict: ``fn`` (the port's call),
    ``plain`` (its plain version) and ``sdpa`` (the library call, one
    masked SDPA over the same keys, gathered or dequantized untimed) take
    no argument; ``q``, ``k``, ``v`` (the keys a row reads, in key
    order), ``mask`` and ``pos`` serve the row checks, ``nbytes`` and
    ``flops`` the bound; the ring case also carries its planted
    ``fault`` and its one-ulp ``tol``.  The wrappers are imported here,
    so ``tools/kernel_times.py`` times any tree's through the same
    cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_reference)
    from repro_torch.kernels.paged_attention.ops import (
        gather_pages, paged_decode_attention, paged_decode_reference)
    from repro_torch.models.layers import PagedKV, _gather_dequant

    def sdpa(q, k, v, mask):
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

    def key_mask(pos, T):
        return (torch.arange(T, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]

    def tables(B, P, page, pos):
        NP = B * P + 1
        ids = torch.randperm(NP - 1, generator=gen, device=dev)[:B * P] + 1
        table = ids.reshape(B, P).to(torch.int32)
        dead = torch.arange(P, device=dev)[None, :] * page > pos[:, None]
        return torch.where(dead, torch.zeros_like(table), table).contiguous()

    row_src = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
    paged_src = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
    row_tpu = "src/repro/kernels/decode_attention/kernel.py:75"
    paged_tpu = "src/repro/kernels/paged_attention/kernel.py:130"
    cases = {}
    B, S, page, P = 8, 768, 256, 3
    pos = torch.tensor([5, 77, 130, 255, 256, 400, 511, 640],
                       dtype=torch.int32, device=dev)
    q, k, v = rn(B, H, HD), rn(B, HKV, S, HD), rn(B, HKV, S, HD)
    mask = key_mask(pos, S)
    live = int((pos + 1).sum())
    flops = 4 * live * H * HD
    qb = 2 * 2 * q.numel() + 4 * B                  # q in, out, pos
    cases["decode_attention"] = dict(
        fn=lambda: decode_attention(q, k, v, pos),
        plain=lambda: decode_reference(q, k, v, pos), sdpa=sdpa(q, k, v, mask),
        q=q, k=k, v=v, mask=mask, pos=pos, src=row_src, replaces=row_tpu,
        nbytes=qb + 2 * 2 * live * HKV * HD, flops=flops)

    NP = B * P + 1
    table = tables(B, P, page, pos)
    kp, vp = rn(NP, HKV, page, HD), rn(NP, HKV, page, HD)
    kg, vg = gather_pages(kp, table), gather_pages(vp, table)
    cases["paged_decode_attention"] = dict(
        fn=lambda: paged_decode_attention(q, kp, vp, table, pos),
        plain=lambda: paged_decode_reference(q, kp, vp, table, pos),
        sdpa=sdpa(q, kg, vg, mask), q=q, k=kg, v=vg, mask=mask, pos=pos,
        src=paged_src, replaces=paged_tpu,
        nbytes=qb + 4 * B * P + 2 * 2 * live * HKV * HD, flops=flops)

    kq, vq = (torch.randint(-127, 128, (NP, HKV, page, HD), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((NP, HKV, page), generator=gen, device=dev) / 64
              for _ in range(2))
    i8 = dict(k_scale=ks, v_scale=vs)
    kd, vd = _gather_dequant(PagedKV(kq, vq, ks, vs), table, torch.bfloat16)
    cases["paged_decode_attention_int8"] = dict(
        fn=lambda: paged_decode_attention(q, kq, vq, table, pos, **i8),
        plain=lambda: paged_decode_reference(q, kq, vq, table, pos, **i8),
        sdpa=sdpa(q, kd, vd, mask), q=q, k=kd, v=vd, mask=mask, pos=pos,
        src=paged_src, replaces=paged_tpu,
        nbytes=qb + 4 * B * P + 2 * (HD + 4) * live * HKV,  # codes + scale
        flops=flops)

    LP = PAGED_LONG_SHAPE[3]
    lpos = torch.linspace(1000, 4000, B, device=dev).to(torch.int32)
    ltable = tables(B, LP, page, lpos)
    lkp, lvp = rn(B * LP + 1, HKV, page, HD), rn(B * LP + 1, HKV, page, HD)
    lkg, lvg = gather_pages(lkp, ltable), gather_pages(lvp, ltable)
    lmask = key_mask(lpos, LP * page)
    llive = int((lpos + 1).sum())
    cases["paged_decode_attention_long"] = dict(
        fn=lambda: paged_decode_attention(q, lkp, lvp, ltable, lpos),
        plain=lambda: paged_decode_reference(q, lkp, lvp, ltable, lpos),
        sdpa=sdpa(q, lkg, lvg, lmask), q=q, k=lkg, v=lvg, mask=lmask,
        pos=lpos, src=paged_src, replaces=paged_tpu,
        nbytes=qb + 4 * B * LP + 2 * 2 * llive * HKV * HD,
        flops=4 * llive * H * HD)

    rpos = torch.tensor([100, 1000, 2047, 4095, 4096, 5000, 8191, 9000],
                        dtype=torch.int32, device=dev)
    rq, rk, rv = rn(B, MH, MHD), rn(B, MHKV, RING, MHD), rn(B, MHKV, RING,
                                                            MHD)
    idx = torch.arange(RING, device=dev)[None, :]
    rmask = (idx <= (rpos % RING)[:, None]) | (rpos >= RING)[:, None]
    rlive = int(rmask.sum())
    # the fault: slot (pos+1) % S flipped -- a wrapped row loses its
    # oldest key, a row below S reads one slot past pos
    fault = rmask ^ (idx == ((rpos + 1) % RING)[:, None])
    rmask, fault = rmask[:, None, None, :], fault[:, None, None, :]
    cases["decode_attention_ring"] = dict(
        fn=lambda: decode_attention(rq, rk, rv, rpos, ring=True),
        plain=lambda: decode_reference(rq, rk, rv, rpos),
        sdpa=sdpa(rq, rk, rv, rmask), q=rq, k=rk, v=rv, mask=rmask,
        pos=rpos, src=row_src, replaces=row_tpu, fault=fault,
        tol=dict(tol=RING_ATOL, rtol=RING_RTOL),
        nbytes=2 * 2 * rq.numel() + 4 * B + 2 * 2 * rlive * MHKV * MHD,
        flops=4 * rlive * MH * MHD)
    return cases


def decode_records(dev, gen, rn, flush, record) -> None:
    """The decode records (``decode_cases``): each against its plain
    version, each row also within ``ROW_RTOL`` with its two planted
    faults (``check_decode_rows``), the ring first against its one-slot
    mask fault at its one-ulp limit (``check_sensitivity``); timed with
    CUDA events beside the plain version and SDPA, and by the profiler
    beside SDPA's kernel time."""
    import torch
    for name, c in decode_cases(dev, gen, rn).items():
        got = c["fn"]()
        torch.cuda.synchronize()
        ref = c["plain"]()
        if "fault" in c:
            check_sensitivity(name, c["q"][:, :, None], c["k"], c["v"],
                              c["mask"], c["fault"])
        check_decode_rows(name, got, ref, c["q"], c["k"], c["v"], c["mask"],
                          c["pos"])
        record(name, c["src"], c["replaces"], got, ref,
               time_ms(c["fn"], flush=flush), time_ms(c["plain"], flush=flush),
               time_ms(c["sdpa"], flush=flush), c["nbytes"], c["flops"],
               **c.get("tol", {}))
        log_kernel_time(name, c["fn"], flush, c["sdpa"])


def ring_verify_record(dev, rn, flush, record) -> None:
    """Ring verify at mixtral-8x7b's shapes (H=32, Hkv=8, hd=128) over a
    ring of 4096 slots (its window): 4 rows with a 128-token block at 0,
    2000, 4096 and 6000.  The library call is one masked SDPA over the
    cache plus block.  (Ring decode is one of ``decode_cases``.)"""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.verify_attention.ops import (verify_attention,
                                                          verify_reference)

    S, G = RING, MH // MHKV
    K = 128
    vpos = torch.tensor([0, 2000, 4096, 6000], dtype=torch.int32, device=dev)
    B = vpos.numel()
    qv = rn(B, K, MH, MHD)
    bk, bv = rn(B, K, MHKV, MHD), rn(B, K, MHKV, MHD)
    kc, vc = rn(B, MHKV, S, MHD), rn(B, MHKV, S, MHD)
    got = verify_attention(qv, kc, vc, bk, bv, vpos, ring=True)
    torch.cuda.synchronize()
    ref = verify_reference(qv, kc, vc, bk, bv, vpos, ring=True)
    pb = vpos[:, None, None]                                   # (B, 1, 1)
    cols = torch.arange(S, device=dev)[None, None, :]
    i = torch.arange(K, device=dev)[None, :, None]
    p = (pb - 1) - torch.remainder(pb - 1 - cols, S)
    cvis = (p >= 0) & (p > pb + i - S)                         # (B, K, S)
    ar = torch.arange(K, device=dev)
    bvis = (ar[None, :] <= ar[:, None])[None].expand(B, K, K)
    vmask = torch.cat([cvis, bvis], dim=-1)[:, None]
    kall = torch.cat([kc, bk.transpose(1, 2)], dim=2)
    vall = torch.cat([vc, bv.transpose(1, 2)], dim=2)
    qt = qv.transpose(1, 2)
    # the fault: p(s) >= pos+i-S for p(s) > pos+i-S -- each query of a
    # wrapped row sees one key older than its window
    fvis = torch.cat([(p >= 0) & (p >= pb + i - S), bvis], dim=-1)[:, None]
    check_sensitivity("verify_attention_ring", qt, kall, vall, vmask, fvis)
    check_verify_rows("verify_attention_ring", got.transpose(1, 2),
                      ref.transpose(1, 2), qt, kall, vall, vmask,
                      [("window one key wide", fvis)])
    pairs = int(cvis.sum()) + int(bvis.sum())
    cache_keys = int(torch.clamp(vpos, max=S).sum())
    record("verify_attention_ring",
           "src/repro_torch/kernels/verify_attention/csrc/"
           "verify_attention.cu",
           "src/repro/kernels/verify_attention/kernel.py:113", got, ref,
           time_ms(lambda: verify_attention(qv, kc, vc, bk, bv, vpos,
                                            ring=True), flush=flush),
           time_ms(lambda: verify_reference(qv, kc, vc, bk, bv, vpos,
                                            ring=True), flush=flush),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kall, vall, attn_mask=vmask, enable_gqa=True),
               flush=flush),
           2 * 2 * qv.numel() + 2 * 2 * bk.numel() + 4 * B
           + 2 * 2 * MHD * cache_keys * MHKV, 4 * MHD * G * MHKV * pairs,
           tol=RING_ATOL, rtol=RING_RTOL)
    log_kernel_time("verify_attention_ring",
                    lambda: verify_attention(qv, kc, vc, bk, bv, vpos,
                                             ring=True), flush,
                    lambda: F.scaled_dot_product_attention(
                        qt, kall, vall, attn_mask=vmask, enable_gqa=True))


PAGED_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
VERIFY_TILE = 128            # cache keys of one key tile of the verify body


def verify_masks(vpos, S, Kb, tree=None, lost_tile=None) -> tuple:
    """A verify record's visibility mask, (B, 1, Kb, S + Kb) over a row's
    S cache slots and its Kb block keys: the slots before ``vpos`` (B,)
    and the block causally, or under the ancestor bitmasks ``tree`` (B,
    Kb).  With it the faults ``check_verify_rows`` plants on the plain
    side: the cache/block boundary one key late (each row reads slot pos
    too); the causal diagonal one key late (query i sees block key i +
    1), or one tree bit cleared (each query's lowest ancestor other than
    itself); with ``lost_tile``, that key tile of the cache missing.
    -> (mask, faults, the (query, key) pairs the mask keeps)."""
    import torch
    B, dev = vpos.shape[0], vpos.device
    ar = torch.arange(Kb, device=dev)
    slots = torch.arange(S, device=dev)[None, None, :]
    cols = slots < vpos[:, None, None]
    if tree is None:
        vis = (ar[None, :] <= ar[:, None])[None].expand(B, Kb, Kb)
    else:
        vis = ((tree[:, :, None] >> ar[None, None, :]) & 1) == 1

    def mask(cache, block):
        return torch.cat([cache.expand(B, Kb, S), block.expand(B, Kb, Kb)],
                         dim=-1)[:, None]

    faults = [("cache/block boundary +1 key",
               mask(slots < vpos[:, None, None] + 1, vis))]
    if tree is None:
        faults.append(("causal diagonal +1 key",
                       mask(cols, (ar[None, :] <= ar[:, None] + 1)[None])))
    else:
        anc = tree & ~(torch.ones_like(tree) << ar.to(torch.int32))
        low = anc & -anc                          # lowest ancestor bit
        cut = ((tree & ~low)[:, :, None] >> ar[None, None, :]) & 1 == 1
        faults.append(("one tree bit cleared", mask(cols, cut)))
    if lost_tile is not None:
        lo = lost_tile * VERIFY_TILE
        faults.append((f"key tile {lost_tile} missing", mask(
            cols & ((slots < lo) | (slots >= lo + VERIFY_TILE)), vis)))
    return mask(cols, vis), faults, Kb * int(vpos.sum()) + int(vis.sum())


def verify_pool(gen, rn, NP: int, page: int, int8: bool) -> tuple:
    """A random page pool of NP pages of ``page`` slots at
    tinyllama-1.1b's kv heads: bf16 k/v, or int8 codes with f32 scales
    in [0, 1/64).  -> ((k, v), the wrapper's scale keywords)."""
    import torch
    if not int8:
        return (rn(NP, HKV, page, HD), rn(NP, HKV, page, HD)), {}
    codes = [torch.randint(-127, 128, (NP, HKV, page, HD), generator=gen,
                           device=gen.device, dtype=torch.int8)
             for _ in range(2)]
    sc = [torch.rand((NP, HKV, page), generator=gen, device=gen.device) / 64
          for _ in range(2)]
    return tuple(codes), dict(k_scale=sc[0], v_scale=sc[1])


def paged_verify_record(record, flush, rn, name, pool, table, vpos, Kb,
                        tree=None, lost_tile=None) -> None:
    """One record of the paged verify (B4) at tinyllama-1.1b's heads: B
    rows at positions ``vpos`` through page tables ``table`` (B, P) over
    ``pool`` (``verify_pool``), Kb block queries a row, causal or under
    ``tree``.  Held to the plain version within 2e-2 and each score row
    within 2**-7 relative L2, with ``verify_masks``' faults shown to
    leave that limit; timed beside the plain version and the library
    call, one masked SDPA over the gathered cache plus block."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (
        gather_pages, paged_verify_attention, paged_verify_reference)
    from repro_torch.models.layers import PagedKV, _gather_dequant

    (kp, vp), scales = pool
    B, P = table.shape
    page = kp.shape[2]
    if scales:
        cache = _gather_dequant(PagedKV(kp, vp, scales["k_scale"],
                                        scales["v_scale"]), table,
                                torch.bfloat16)
        kv_bytes = 2 * (HD + 4)          # k and v: codes and an f32 scale
    else:
        cache = gather_pages(kp, table), gather_pages(vp, table)
        kv_bytes = 2 * 2 * HD
    qv = rn(B, Kb, H, HD)
    bk, bv = rn(B, Kb, HKV, HD), rn(B, Kb, HKV, HD)
    args = (qv, kp, vp, bk, bv, table, vpos)
    kw = dict(tree=tree, **scales)
    got = paged_verify_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_verify_reference(*args, **kw)
    vmask, faults, pairs = verify_masks(vpos, P * page, Kb, tree, lost_tile)
    qt = qv.transpose(1, 2)
    kall, vall = (torch.cat([c, b.transpose(1, 2)], dim=2)
                  for c, b in zip(cache, (bk, bv)))
    check_verify_rows(name, got.transpose(1, 2), ref.transpose(1, 2), qt,
                      kall, vall, vmask, faults)
    nbytes = (2 * 2 * qv.numel() + 2 * 2 * bk.numel() + 4 * B + 4 * B * P
              + kv_bytes * int(vpos.sum()) * HKV
              + (0 if tree is None else 4 * tree.numel()))

    def kernel():
        return paged_verify_attention(*args, **kw)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kall, vall,
                                              attn_mask=vmask,
                                              enable_gqa=True)

    record(name, PAGED_SRC, "src/repro/kernels/paged_attention/kernel.py:315",
           got, ref, time_ms(kernel, flush=flush),
           time_ms(lambda: paged_verify_reference(*args, **kw), flush=flush),
           time_ms(sdpa, flush=flush), nbytes, 4 * HD * H * pairs)
    log_kernel_time(name, kernel, flush, sdpa)


def prefix_verify_records(gen, rn, flush, record) -> None:
    """Paged verify (B4) at the shapes the ``prefix_*`` passes give it
    (``PREFIX_VERIFY``), fp and int8 pools: one row at position 2048
    over tinyllama-1.1b's 9-page table of 256 (the 8 pages of a hit's
    preamble and the row's own), with a one-shot hit's 32-token tail or
    a chunked pass's 256-token chunk.  The 2048 cached keys are 16 key
    tiles of 128, so the kernel's 3-stage pipeline wraps five times; a
    third fault drops key tile 3, the first to reuse a stage."""
    import torch
    page, P, pos = PREFIX_PAGE, PREFIX_MAX_LEN // PREFIX_PAGE, PREFIX_LEN
    NP = PREFIX_REQUESTS * P + 1                 # the passes' pool
    dev = gen.device
    table = (torch.randperm(NP - 1, generator=gen, device=dev)[:P]
             + 1).to(torch.int32)[None].contiguous()
    vpos = torch.tensor([pos], dtype=torch.int32, device=dev)
    pools = {int8: verify_pool(gen, rn, NP, page, int8)
             for int8 in (False, True)}
    for name, (Kb, int8) in PREFIX_VERIFY.items():
        paged_verify_record(record, flush, rn, name, pools[int8], table,
                            vpos, Kb, lost_tile=3)


def spec_verify_shape(tree: bool, int8: bool) -> tuple:
    """A speculative pass's verify launch as its wrapper's
    ``launches_by_shape`` counts it, (B, Hkv, G, Kb, P, page, hd, int8):
    8 rows of K + 1 = 5 tokens (flat) or 1 + K*W = 13 tree nodes over
    tinyllama-1.1b's 3-page tables of 256."""
    return (N_REQUESTS, HKV, H // HKV,
            1 + SPEC_K * SPEC_W if tree else SPEC_K + 1, SPEC_P, SPEC_PAGE,
            HD, int8)


# the paged verify records at the speculative passes' shapes -> (tree
# mask, int8 pool)
SPEC_VERIFY = {"paged_verify_attention_flat_spec": (False, False),
               "paged_verify_attention_tree_spec": (True, False),
               "paged_verify_attention_tree_spec_int8": (True, True)}


def spec_verify_records(gen, rn, flush, record) -> None:
    """Paged verify (B4) at the speculative passes' shapes
    (``spec_verify_shape``): 8 rows at positions 130-540 over shuffled
    3-page tables of 256 (pages past a row's block on the park page),
    the flat passes' K + 1 = 5 tokens a row under the causal mask, and
    the tree passes' 13 nodes under the engine's sausage mask of depth 4
    and width 3 (``sausage_tree``), fp and int8 pools."""
    import torch
    from repro_torch.serve.speculative import sausage_tree

    B, page, P = N_REQUESTS, SPEC_PAGE, SPEC_P
    NP = B * P + 1
    dev = gen.device
    vpos = torch.tensor([130, 200, 255, 256, 300, 400, 511, 540],
                        dtype=torch.int32, device=dev)
    ids = torch.randperm(NP - 1, generator=gen, device=dev)[:B * P] + 1
    table = ids.reshape(B, P).to(torch.int32)
    dead = (torch.arange(P, device=dev)[None, :] * page
            >= vpos[:, None] + SPEC_K + 1)
    table = torch.where(dead, torch.zeros_like(table), table).contiguous()
    pools = {int8: verify_pool(gen, rn, NP, page, int8)
             for int8 in (False, True)}
    mask = torch.from_numpy(sausage_tree(SPEC_K, SPEC_W)[1]).to(dev)
    tree = mask[None].expand(B, mask.shape[0]).contiguous()
    for name, (is_tree, int8) in SPEC_VERIFY.items():
        Kb = spec_verify_shape(is_tree, int8)[3]
        paged_verify_record(record, flush, rn, name, pools[int8], table,
                            vpos, Kb, tree if is_tree else None)


SCAN_D_IN, SCAN_N = 8192, 16        # jamba-v0.1-52b's Mamba scan
SCAN_TILE = 32                       # time steps of a scan kernel tile
MLSTM_H, MLSTM_DH, MLSTM_C = 4, 384, 256   # xlstm-125m's mLSTM


def scan_cases(dev, gen) -> dict:
    """The scan records' inputs at jamba-v0.1-52b's d_in and N, f32:
    ``ssm_scan`` a 512-token prefill of 2 rows from a zero state (timed)
    and an 8-token verify block from a carried state (checked too);
    ``ssm_scan_serving`` the hybrid pass's first jamba prompt, one row
    from a zero state.  -> name -> list of argument tuples, the first
    timed."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    A = -torch.exp(rn(SCAN_D_IN, SCAN_N) * 0.5)
    D = rn(SCAN_D_IN)

    def case(B, L, init):
        u, Bm, Cm = rn(B, L, SCAN_D_IN), rn(B, L, SCAN_N), rn(B, L, SCAN_N)
        dt = torch.nn.functional.softplus(rn(B, L, SCAN_D_IN) - 2.0)
        return (u, dt, Bm, Cm, A, D,
                rn(B, SCAN_D_IN, SCAN_N) if init else None)

    return {"ssm_scan": [case(2, 512, False), case(2, 8, True)],
            "ssm_scan_serving": [case(*scan_serving_shape()[:2], False)]}


def mlstm_cases(dev, gen) -> dict:
    """The mLSTM records' inputs at xlstm-125m's heads (H = 4, dh = 384,
    chunk 256), f32, drawn as ``tests/test_kernels.py`` draws them:
    ``mlstm_chunk`` a 512-token prefill of 2 rows, ``mlstm_chunk_serving``
    the xlstm pass's 768-token prompt, one row.  -> name -> (q, k, v,
    li, lf)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def case(B, L):
        q, k, v = (rn(B, MLSTM_H, L, MLSTM_DH) for _ in range(3))
        li = rn(B, MLSTM_H, L) * 0.5
        lf = torch.nn.functional.logsigmoid(rn(B, MLSTM_H, L) + 1.0)
        return (q, k, v, li, lf)

    return {"mlstm_chunk": case(2, 512),
            "mlstm_chunk_serving": case(*MLSTM_SERVING_SHAPE[0:3:2])}


def scan_record(dev, gen, flush, record) -> None:
    """The selective scan at jamba-v0.1-52b's shapes (``scan_cases``), f32,
    within ``SCAN_RTOL`` of the plain version's largest value.  No single
    library call computes the scan.  The bound counts 7 operations per
    (row, step, channel, state) and 3 per (row, step, channel) at the f32
    rate outside the tensor cores; the log adds the exponentials' bound
    (one a (row, step, channel, state) at ``EXP_PER_S``) and shows that
    the limit catches one lane group's state and one time tile's carry
    dropped at a tile boundary (``scan_faults``)."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import (selective_scan_reference,
                                                  ssm_scan)

    for name, cases in scan_cases(dev, gen).items():
        got, ref = [], []
        for args in cases:
            got += ssm_scan(*args)
            torch.cuda.synchronize()
            ref += selective_scan_reference(*args)
        tol = SCAN_RTOL * max(float(r.abs().max()) for r in ref)
        timed = cases[0]
        B, L, d_in = timed[0].shape
        N = timed[2].shape[-1]
        nbytes = 4 * (3 * B * L * d_in + 2 * B * L * N + d_in * N + d_in
                      + B * d_in * N)
        ops = B * L * d_in * (7 * N + 3)
        rec = record(
            name, "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan/kernel.py:64", tuple(got),
            tuple(ref), time_ms(lambda: ssm_scan(*timed), flush=flush),
            time_ms(lambda: selective_scan_reference(*timed), iters=5,
                    flush=flush),
            None, nbytes, ops, peak=F32_FLOPS, tol=tol)
        exp_ms = 1e3 * B * L * d_in * N / EXP_PER_S
        log(f"kernel {name}: exp bound ms={exp_ms:.4f} beside bound_ms="
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        log_kernel_time(name, lambda: ssm_scan(*timed), flush)
        if name == "ssm_scan":
            scan_faults(timed, ref[0], tol)


def scan_faults(args, want, tol) -> None:
    """The plain scan with one planted fault at the tile boundary t = 256
    (of ``args``, from a zero state): the states of one lane group (the
    second 4 of each channel's N) dropped, and the whole carry dropped
    (the tile restarts from zero).  Each must leave the record's limit
    ``tol``: logs its largest error over the limit, fails at or under 1."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import selective_scan_reference

    u, dt, Bm, Cm, A, D, s0 = args
    T = 8 * SCAN_TILE
    head = [t[:, :T] for t in (u, dt, Bm, Cm)]
    tail = [t[:, T:] for t in (u, dt, Bm, Cm)]
    y1, s = selective_scan_reference(*head, A, D, s0)
    lane = s.clone()
    lane[..., 4:8] = 0.0
    for fault, s_in in (("one lane group's state dropped", lane),
                        ("one time tile's carry dropped",
                         torch.zeros_like(s))):
        y2, _ = selective_scan_reference(*tail, A, D, s_in)
        ratio = float((torch.cat([y1, y2], dim=1) - want).abs().max()) / tol
        log(f"kernel ssm_scan: planted fault '{fault}' at step {T}: "
            f"error/limit {ratio:.1f}")
        if not ratio > 1.0:
            raise AssertionError(f"ssm_scan: the limit does not catch "
                                 f"{fault}")


def mlstm_record(dev, gen, flush, record) -> None:
    """The chunkwise mLSTM at xlstm-125m's shapes (``mlstm_cases``), f32,
    from no history.  No single library call computes it.  The bound
    counts, per chunk and (row, head), the scores and the intra-chunk
    product over the causal pairs s <= l only, 2 c(c+1) dh, the state
    update 2c dh^2, and the inter-chunk product 2c dh^2 for every chunk
    but the first (which has no carried state), at the rate of the
    kernel's route, 3xTF32 on the tensor cores (``TF32X3_FLOPS``); the
    bytes are q, k, v, li, lf read and h, C, n, m written.  The log adds
    the bound at the f32 rate outside the tensor cores, the largest |g|
    (the within-chunk cumulative log forget gate, on whose rounding m's
    error rests), m's distance from the float64 recurrent form (the
    ground truth, which m must also hold within ``MLSTM_M_TOL``) beside
    that of ``torch.cumsum``'s order, and the planted faults of
    ``mlstm_faults``."""
    import torch
    from repro_torch.kernels.mlstm_chunk.ops import (
        mlstm_chunk, mlstm_chunk_reference, mlstm_recurrent_reference)

    c = MLSTM_C
    for name, args in mlstm_cases(dev, gen).items():
        q, lf = args[0], args[4]
        B, Hx, L, dh = q.shape
        h, fin = mlstm_chunk(*args, chunk=c)
        torch.cuda.synchronize()
        wh, wfin = mlstm_chunk_reference(*args, c)
        got, ref = (h, *fin), (wh, *wfin)
        tols = tuple(t * max(1.0, float(r.abs().max()))
                     for t, r in zip((MLSTM_TOL,) * 3 + (MLSTM_M_TOL,), ref))
        nbytes = 4 * (4 * B * Hx * L * dh + 2 * B * Hx * L
                      + B * Hx * dh * dh + B * Hx * dh + B * Hx)
        nc = L // c
        ops = B * Hx * (nc * (2 * c * (c + 1) * dh + 2 * c * dh * dh)
                        + (nc - 1) * 2 * c * dh * dh)
        g_max = float(lf.reshape(B, Hx, nc, c).cumsum(-1).abs().max())
        m64 = mlstm_recurrent_reference(*(t.double() for t in args))[1][2]
        m_truth = float((got[3].double() - m64).abs().max()) / MLSTM_M_TOL
        log(f"{name}: largest |g| {g_max:.3f}, largest |m| "
            f"{float(ref[3].abs().max()):.3f}, m bitwise the plain "
            f"version's: {bool(torch.equal(got[3], ref[3]))}; |m - m of "
            f"the float64 recurrent form| / MLSTM_M_TOL: kernel "
            f"{m_truth:.3f}, torch.cumsum's order "
            f"{m_cumsum_error(args, c, m64) / MLSTM_M_TOL:.3f}")
        if not m_truth <= 1.0:
            raise AssertionError(f"{name}: m is {m_truth:.3f} x MLSTM_M_TOL "
                                 f"from the float64 recurrent form")
        record(name,
               "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
               "src/repro/kernels/mlstm_chunk/kernel.py:95", got, ref,
               time_ms(lambda: mlstm_chunk(*args, chunk=c), flush=flush),
               time_ms(lambda: mlstm_chunk_reference(*args, c), flush=flush),
               None, nbytes, ops, peak=TF32X3_FLOPS, tol=tols,
               outputs=("h", "C", "n", "m"))
        log(f"kernel {name}: bound at the f32 rate outside the tensor "
            f"cores ms={bound_ms(nbytes, ops, F32_FLOPS)[0]:.4f}")
        log_kernel_time(name, lambda: mlstm_chunk(*args, chunk=c), flush)
        mlstm_faults(name, args, c, ref, tols)


def m_cumsum_error(args, c, m64) -> float:
    """Largest |m - m64| of the stabilizer chain m' = max(gT + m_p,
    max_s(gT - g_s + li_s)) over ``args``' chunks of ``c``, in f32 with g
    summed by ``torch.cumsum`` (whose order on the card follows the
    tensor's shape): the yardstick beside the kernel's fixed order."""
    import torch
    from repro_torch.models.xlstm import NEG_INF

    li, lf = args[3], args[4]
    m = torch.full(li.shape[:2], NEG_INF, dtype=torch.float32,
                   device=li.device)
    for t0 in range(0, li.shape[2], c):
        g = torch.cumsum(lf[..., t0:t0 + c], dim=-1)
        gT = g[..., -1:]
        m = torch.maximum(gT[..., 0] + m,
                          (gT - g + li[..., t0:t0 + c]).amax(dim=-1))
    return float((m.double() - m64).abs().max())


def mlstm_faults(name, args, c, want, tols) -> None:
    """The plain chunkwise mLSTM run chunk by chunk with one planted fault
    in the carried state: chunk 1 starting from no history (its carried
    state dropped) and, with three or more chunks, chunk 2 starting from
    the state after chunk 0 (read one chunk late).  Each must leave the
    record's limits ``tols`` (h, C, n, m): logs its largest error over the
    limit per output, fails where none passes 1."""
    import torch
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk_reference

    L = args[0].shape[2]
    nc = L // c
    faults = {"carried state dropped": lambda j, st: None if j == 1 else st[j]}
    if nc >= 3:
        faults["carried state read one chunk late"] = (
            lambda j, st: st[j - 1] if j == 2 else st[j])
    for fault, carry in faults.items():
        states, hs = [None], []
        for j in range(nc):
            part = [t[:, :, j * c:(j + 1) * c] for t in args]
            h, st = mlstm_chunk_reference(*part, c, state=carry(j, states))
            hs.append(h)
            states.append(st)
        got = (torch.cat(hs, dim=2), *states[-1])
        ratios = [float((g - w).abs().max()) / t
                  for g, w, t in zip(got, want, tols)]
        log(f"kernel {name}: planted fault '{fault}': error/limit h "
            f"{ratios[0]:.1f}, C {ratios[1]:.1f}, n {ratios[2]:.1f}, m "
            f"{ratios[3]:.1f}")
        if not max(ratios) > 1.0:
            raise AssertionError(f"{name}: the limits do not catch {fault}")


SHARDS = 4                   # logical shards of the sharded passes
# one shard's decode partial, f32: each of acc, m, l within PARTIAL_TOL
# times max(1, the plain output's largest finite magnitude)
PARTIAL_TOL = 1e-4


def partial_records(dev, gen, rn, flush, record) -> None:
    """Kernel B5, one shard's unnormalized decode partial, at
    tinyllama-1.1b's attention (H=32, Hkv=4, hd=64, bf16): the 8 decode
    rows of the paged record (positions 5 to 640, page 256, 3 pages a
    row) over a bank split into 4 slices of 7 pages (local page 0 of each
    reserved).  Rows 0-4 keep their pages on one shard each, rows 5-7
    span shards, so every shard has rows that own nothing and rows that
    own part; the records run all four bases 0, 7, 14, 21 (acc, m and l
    concatenated over the shards, each against its own limit), full
    precision and int8.  Timed: the four shards' launches of one decode
    step.  No single library call returns (acc, m, l); the log sets the
    four partials merged (pmax/psum, then normalized) beside one SDPA
    over the same rows, and in rows 0-4 the merged partials must be the
    paged decode kernel's output bit for bit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (
        gather_pages, paged_decode_attention, paged_decode_partial,
        paged_decode_partial_reference, paged_decode_reference)
    from repro_torch.models.layers import (PagedKV, _gather_dequant,
                                           _psum_partials)

    B, page, P, Lp = 8, 256, 3, 7
    NP = SHARDS * Lp
    pos = torch.tensor([5, 77, 130, 255, 256, 400, 511, 640],
                       dtype=torch.int32, device=dev)
    # global ids; shard s owns [7s, 7s+7), 7s itself reserved.  Dead
    # entries (first position past pos) park on page 0.
    table = torch.tensor([[1, 0, 0], [8, 0, 0], [15, 0, 0], [22, 0, 0],
                          [2, 3, 0], [9, 16, 0], [23, 4, 0], [10, 17, 24]],
                         dtype=torch.int32, device=dev)
    q = rn(B, H, HD)
    G = H // HKV
    live = int((pos + 1).sum())
    mask = (torch.arange(P * page, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    kp, vp = rn(NP, HKV, page, HD), rn(NP, HKV, page, HD)
    codes = [torch.randint(-127, 128, (NP, HKV, page, HD), generator=gen,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((NP, HKV, page), generator=gen, device=dev) / 64
              for _ in range(2)]
    src = "src/repro_torch/kernels/paged_attention/csrc/paged_partial.cu"
    for name, pool, sc, kv_bytes in (
            ("paged_decode_partial", (kp, vp), None, 2 * HD),
            ("paged_decode_partial_int8", tuple(codes), scales, HD + 4)):
        def shard_args(s):
            sl = slice(s * Lp, (s + 1) * Lp)
            kw = {} if sc is None else dict(k_scale=sc[0][sl],
                                            v_scale=sc[1][sl])
            return (q, pool[0][sl], pool[1][sl], table, pos, s * Lp), kw

        def run(fn):
            return [fn(*a, **kw) for a, kw in map(shard_args,
                                                  range(SHARDS))]

        got = run(paged_decode_partial)
        torch.cuda.synchronize()
        ref = run(paged_decode_partial_reference)
        got_c = tuple(torch.cat(t) for t in zip(*got))
        ref_c = tuple(torch.cat(t) for t in zip(*ref))
        tols = tuple(PARTIAL_TOL * max(1.0, float(r[r > -1e29].abs().max()))
                     for r in ref_c)
        empty = sum(int((m == -1e30).all(-1).sum()) for _, m, _ in got)
        log(f"kernel {name}: {empty} of {SHARDS * B * HKV} (shard, row, kv "
            "head) partials own no page")
        if not empty:
            raise AssertionError(f"{name}: no row that owns nothing")
        nbytes = SHARDS * (2 * q.numel() + 4 * B * P + 4 * B
                           + 4 * (B * HKV * G * HD + 2 * B * HKV * G)) \
            + 2 * kv_bytes * live * HKV
        rec = record(name, src,
                     "src/repro/kernels/paged_attention/kernel.py:488",
                     got_c, ref_c,
                     time_ms(lambda: run(paged_decode_partial), flush=flush),
                     time_ms(lambda: run(paged_decode_partial_reference),
                             flush=flush),
                     None, nbytes, 4 * live * H * HD, tol=tols,
                     outputs=("acc", "m", "l"))
        # ``ms`` spans the four wrapper calls, host dispatch included;
        # the profiler's kernel time is the device's share of it
        rec["device_ms"] = device_ms(lambda: run(paged_decode_partial),
                                     flush=flush)

        def merged():
            acc, _, l = _psum_partials(
                *zip(*[(a[:, :, None], m[:, :, None], ll[:, :, None])
                       for a, m, ll in run(paged_decode_partial)]))
            return (acc / l[..., None]).reshape(B, H, HD)

        kw = {} if sc is None else dict(k_scale=sc[0], v_scale=sc[1])
        whole = paged_decode_reference(q, *pool, table, pos, **kw)
        err = (merged().float() - whole.float()).abs().max().item()
        if sc is None:
            kg, vg = gather_pages(kp, table), gather_pages(vp, table)
        else:
            kg, vg = _gather_dequant(PagedKV(*pool, *sc), table,
                                     torch.bfloat16)
        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)

        log(f"kernel {name}: the {SHARDS} launches' kernel time "
            f"(torch.profiler) ms={rec['device_ms']}, events ms="
            f"{rec['ms']:.4f}")
        log(f"kernel {name}: the {SHARDS} partials merged vs one paged "
            f"decode of the whole bank: max_abs_err={err:.3e} (limit "
            f"{TOL}); merged ms={time_ms(merged, flush=flush):.4f} "
            f"(kernel time {device_ms(merged, flush=flush)}), SDPA over "
            f"the same rows ms={time_ms(sdpa, flush=flush):.4f} (kernel "
            f"time {device_ms(sdpa, flush=flush)})")
        if not err <= TOL:
            raise AssertionError(f"{name}: merged partials {err} from the "
                                 "paged decode")
        # rows whose live pages all lie on one shard: bit for bit the
        # global paged decode kernel's output
        live_pg = torch.arange(P, device=dev)[None, :] * page <= pos[:, None]
        shard_of = torch.where(live_pg, table // Lp, table[:, :1] // Lp)
        one = (shard_of == shard_of[:, :1]).all(1)
        glob = paged_decode_attention(q, *pool, table, pos, **kw)
        same = torch.equal(merged().to(torch.bfloat16)[one], glob[one])
        log(f"kernel {name}: {int(one.sum())} rows on one shard, merged "
            f"partials bitwise the paged decode's: {same}")
        if not same:
            raise AssertionError(f"{name}: merged partials of rows on one "
                                 "shard differ from the paged decode")


def gmm_record(dev, gen, flush, record) -> None:
    """Kernel B7, the grouped matmul, at mixtral-8x7b's expert shapes
    after the 4-shard all_to_all: 2 experts a shard, capacity 80 from
    each of 4 shards (C = 320), bf16; ``gmm`` the gate and up products,
    (2, 320, 4096) @ (2, 4096, 14336), ``gmm_down`` the down product,
    (2, 320, 14336) @ (2, 14336, 4096).  Each output element within one
    bf16 ulp of the plain version (f32 einsum rounded to bf16), the ring
    records' limit.  Library call: one ``torch.bmm`` on the same bf16
    operands."""
    import torch
    from repro_torch.kernels.gmm.ops import gmm, gmm_reference

    for name, (E, C, D, Fo) in (("gmm", (2, 320, 4096, 14336)),
                                ("gmm_down", GMM_DOWN_SHAPE)):
        x = torch.randn((E, C, D), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn((E, D, Fo), generator=gen, device=dev)
             / D ** 0.5).to(torch.bfloat16)
        got = gmm(x, w)
        torch.cuda.synchronize()
        ref = gmm_reference(x, w)
        record(name, "src/repro_torch/kernels/gmm/csrc/gmm.cu",
               "src/repro/kernels/gmm/kernel.py:46", got, ref,
               time_ms(lambda: gmm(x, w), flush=flush),
               time_ms(lambda: gmm_reference(x, w), iters=5, flush=flush),
               time_ms(lambda: torch.bmm(x, w), flush=flush),
               2 * (x.numel() + w.numel() + E * C * Fo), 2 * E * C * D * Fo,
               tol=RING_ATOL, rtol=RING_RTOL)
        log_kernel_time(name, lambda: gmm(x, w), flush)
        del x, w, got, ref


def log_kernel_time(name, fn, flush, library=None) -> None:
    """Logs the device kernel time of one call (``torch.profiler``),
    which leaves out the host's time to launch it; the records' ``ms``
    (CUDA events) include whatever of it the card waits for.  With
    ``library``, the library call's kernel time beside it."""
    msg = f"kernel {name}: kernel time ms={device_ms(fn, flush=flush)}"
    if library is not None:
        msg += f", library kernel time ms={device_ms(library, flush=flush)}"
    log(msg)


# the instructions each library's SASS must hold: wgmma (HGMMA) and TMA
# loads (UTMALDG) in the flash, gmm and verify bodies; mma.sync (HMMA) and
# cp.async (LDGSTS) in the decode body (the row and paged decode and the
# shard partial) and the mLSTM's 3xTF32 products; cp.async in the scan
SASS_OPS = {"flash_attention": ("HGMMA", "UTMALDG"),
            "gmm": ("HGMMA", "UTMALDG"),
            "paged_attention": ("HGMMA", "UTMALDG", "HMMA", "LDGSTS"),
            "verify_attention": ("HGMMA", "UTMALDG"),
            "decode_attention": ("HMMA", "LDGSTS"),
            "paged_partial": ("HMMA", "LDGSTS"),
            "mlstm_chunk": ("HMMA", "LDGSTS"),
            "ssm_scan": ("LDGSTS",)}


def sass_counts() -> None:
    """The tensor-core kernels compile to Hopper's own instructions: logs
    the count of each of ``SASS_OPS`` in its library's SASS
    (``cuobjdump -sass``) and fails where one is 0."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, ops in SASS_OPS.items():
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sass.count(op) for op in ops}
        log(f"sass {name}: " + json.dumps(counts))
        if not all(counts.values()):
            raise AssertionError(f"{name}: an instruction of {ops} is "
                                 "missing from its SASS")


# ---------------------------------------------------------------------------
# phase 3: reference check
# ---------------------------------------------------------------------------

REF_LAYERS = 1      # depth of the reference check (full width)
REF_TOL = 0.1       # relative L2 error of bf16 logits vs float32


def reference_phase(dev) -> None:
    """Each served model at full width, cut to ``REF_LAYERS`` layer, run
    on the card (bf16 activations, kernels) and on the CPU through the
    plain path in float32 on the same weights.  Six card paths are held
    against the CPU forward's logits: ``forward`` (flash kernel); one
    decode step after a 47-token prefill through the row cache (decode
    kernel), through a page pool with shuffled tables (paged kernel) and
    through an int8 page pool (its int8 body); and the 48-token prompt
    streamed in 16-token chunks into the row cache (verify kernel) and
    into the page pool (paged verify kernel), every chunk's logits
    compared.  Each must be finite, of the expected shape, and within
    ``REF_TOL`` relative L2 error.  Why one layer: with random weights,
    bf16 rounding of the activations grows several-fold per layer, so a
    deeper check would measure the weights' conditioning, not the
    port."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.models.model import build_model

    rng = np.random.default_rng(1)
    S, page = 48, 16
    for name in ("supersub-super", "tinyllama-1.1b"):
        cfg = override(get_arch(name), param_dtype="bfloat16",
                       num_layers=REF_LAYERS)
        gpu = build_model(cfg, device=dev)
        params = gpu.init(seed=7)
        toks = rng.integers(0, cfg.vocab_size, (2, S))
        cpu = build_model(override(cfg, dtype="float32",
                                   param_dtype="float32"),
                          cache_dtype=torch.float32, device="cpu")
        ref = cpu.forward(_tree(lambda t: t.float().cpu(), params), toks)

        fwd = gpu.forward(params, toks)
        _, rows = gpu.prefill(params, toks[:, :S - 1], max_len=4 * page)
        pool = gpu.init_page_pool(num_pages=9, page=page)
        tables = (torch.randperm(8, generator=torch.Generator().manual_seed(
            3)) + 1).reshape(2, 4).to(torch.int32).to(dev)
        gpu.insert_cache_pages(pool, rows, tables)
        pos = torch.full((2,), S - 1, dtype=torch.int32, device=dev)
        last = toks[:, S - 1:]
        pool8 = gpu.init_page_pool(num_pages=9, page=page, quantized=True)
        gpu.insert_cache_pages(pool8, rows, tables)
        row, _ = gpu.decode_step(params, rows, last, pos)
        paged, _ = gpu.decode_step_pages(params, pool, last, pos, tables)
        int8, _ = gpu.decode_step_pages(params, pool8, last, pos, tables)
        crow, cpaged = [], []
        rows = gpu.init_cache(2, 4 * page)
        pool = gpu.init_page_pool(num_pages=9, page=page)
        slots = torch.arange(2, device=dev)
        for start in range(0, S, 16):
            chunk = toks[:, start:start + 16]
            p = torch.full((2,), start, dtype=torch.int32, device=dev)
            crow.append(gpu.prefill_chunk(params, rows, chunk, p, slots)[0])
            cpaged.append(gpu.prefill_chunk_pages(params, pool, chunk, p,
                                                  tables)[0])
        for label, got, want in (("forward", fwd, ref),
                                 ("decode_row", row[:, 0], ref[:, -1]),
                                 ("decode_paged", paged[:, 0], ref[:, -1]),
                                 ("decode_paged_int8", int8[:, 0],
                                  ref[:, -1]),
                                 ("chunked_row", torch.cat(crow, 1), ref),
                                 ("chunked_paged", torch.cat(cpaged, 1),
                                  ref)):
            _rel_check(f"{name} {label} ({REF_LAYERS} layer)", got, want)


def _rel_check(label, got, want) -> None:
    """``got`` (card) finite, of ``want``'s (CPU float32) shape and
    within ``REF_TOL`` relative L2 error of it."""
    import torch
    got = got.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    rel = ((got - want.float()).norm() / want.float().norm()).item()
    log(f"reference {label}: rel_l2={rel:.4e}")
    if not rel <= REF_TOL:
        raise AssertionError(f"{label}: card vs CPU float32 reference rel "
                             f"L2 {rel} > {REF_TOL}")


def moe_hybrid_reference(dev) -> None:
    """mixtral-8x7b at full width cut to one layer (ring attention, MoE
    FFN) and one jamba-v0.1-52b Mamba block at full width, on the card
    (kernels, bf16) against the same calls on the CPU in float32 on the
    same weights, each within ``REF_TOL`` relative L2 error.

    mixtral: ``forward`` over 48 tokens (flash kernel, window 4096); a
    41-token prefill with ``max_len`` 44, which makes the ring 44 slots
    (min(max_len, window)); one decode step (ring decode kernel) and an
    8-token ``verify_step`` that wraps the ring (ring verify kernel).
    jamba's MoE FFN runs mixtral's code.  The Mamba block: a 40-token
    ``mamba_forward`` (selective-scan kernel), one ``mamba_decode`` token
    (the plain step, as in JAX) and an 8-token block from the carried
    state (the kernel with an initial state); outputs and final states
    compared."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.models import ssm
    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_model

    rng = np.random.default_rng(2)
    cfg = override(get_arch("mixtral-8x7b"), param_dtype="bfloat16",
                   num_layers=REF_LAYERS)
    gpu = build_model(cfg, device=dev)
    params = gpu.init(seed=8)
    cpu = build_model(override(cfg, dtype="float32", param_dtype="float32"),
                      cache_dtype=torch.float32, device="cpu")
    cparams = _tree(lambda t: t.float().cpu(), params)
    toks = rng.integers(0, cfg.vocab_size, (2, 50))
    P0, K, max_len = 41, 8, 44
    pos = np.full((2,), P0, np.int32)
    results = []
    for model, p in ((gpu, params), (cpu, cparams)):
        d = model.device
        fwd = model.forward(p, toks[:, :48])
        pre, caches = model.prefill(p, toks[:, :P0], max_len)
        dec, _ = model.decode_step(p, caches, toks[:, P0:P0 + 1],
                                   torch.from_numpy(pos).to(d))
        ver, _ = model.verify_step(p, caches, toks[:, P0 + 1:P0 + 1 + K],
                                   torch.from_numpy(pos + 1).to(d))
        results.append((fwd, pre, dec, ver))
    for label, got, want in zip(("forward", "prefill", "decode_ring",
                                 "verify_ring"), *results):
        _rel_check(f"mixtral-8x7b {label} ({REF_LAYERS} layer)", got, want)
    del gpu, params, cpu, cparams, results

    jcfg = override(get_arch("jamba-v0.1-52b"), param_dtype="bfloat16")
    specs = ssm.ssm_specs(jcfg)
    mp = init_params(specs, torch.Generator(device=dev).manual_seed(9),
                     torch.bfloat16, dev)
    cmp_ = _tree(lambda t: t.float().cpu(), mp)
    x = torch.randn((2, 49, jcfg.d_model),
                    generator=torch.Generator().manual_seed(10))
    results = []
    for p, xx in ((mp, x.to(dev, torch.bfloat16)), (cmp_, x)):
        f, st = ssm.mamba_forward(p, xx[:, :40], jcfg)
        d1, st = ssm.mamba_decode(p, xx[:, 40:41], st, jcfg)
        v8, st = ssm.mamba_decode(p, xx[:, 41:49], st, jcfg)
        results.append((f, d1, v8, st.ssm, st.conv))
    for label, got, want in zip(("prefill", "decode", "verify_state",
                                 "final_ssm_state", "final_conv_state"),
                                *results):
        _rel_check(f"jamba-v0.1-52b mamba block {label}", got, want)


def xlstm_reference(dev) -> None:
    """One xlstm-125m mLSTM block and one sLSTM block at full width (bf16
    weights from a seed) on the card against the same calls on the CPU
    in float32 on the same weights, each output and final state within
    ``REF_TOL`` relative L2 error.  mLSTM: a 512-token chunkwise prefill
    (the kernel: two chunks of 256), one recurrent decode token and a
    4-token verify block from the carried state.  sLSTM: a 64-token
    prefill and one decode token from its state."""
    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.models import xlstm
    from repro_torch.models.common import init_params

    cfg = override(get_arch("xlstm-125m"), param_dtype="bfloat16")
    x = torch.randn((2, 517, cfg.d_model),
                    generator=torch.Generator().manual_seed(11))

    def mlstm(p, xx):
        y, st = xlstm.mlstm_block(p, xx[:, :512], cfg, mode="chunkwise")
        d1, st = xlstm.mlstm_block(p, xx[:, 512:513], cfg, mode="recurrent",
                                   state=st)
        v4, st = xlstm.mlstm_block(p, xx[:, 513:517], cfg, mode="recurrent",
                                   state=st)
        return {"prefill_chunkwise": y, "decode": d1, "verify4": v4,
                "final_C": st.C, "final_n": st.n, "final_m": st.m}

    def slstm(p, xx):
        y, st = xlstm.slstm_block(p, xx[:, :64], cfg)
        d1, st = xlstm.slstm_block(p, xx[:, 64:65], cfg, state=st)
        return {"prefill": y, "decode": d1, "final_h": st.h, "final_c": st.c,
                "final_n": st.n, "final_m": st.m}

    for name, run, specs, seed in (("mlstm", mlstm, xlstm.mlstm_specs, 12),
                                   ("slstm", slstm, xlstm.slstm_specs, 13)):
        gp = init_params(specs(cfg),
                         torch.Generator(device=dev).manual_seed(seed),
                         torch.bfloat16, dev)
        got = run(gp, x.to(dev, torch.bfloat16))
        want = run(_tree(lambda t: t.float().cpu(), gp), x)
        for label in got:
            _rel_check(f"xlstm-125m {name} block {label}", got[label],
                       want[label])


def int8_drift(dev, steps: int = 8) -> None:
    """Logged, not gated: how far an int8 page pool moves the logits of
    the full-depth tinyllama-1.1b (random bf16 weights).  One prefill of
    two 256-token prompts goes into a bf16 and an int8 pool; the bf16
    greedy stream is teacher-forced through both for ``steps`` decode
    steps.  Reports the worst logit error over the logit spread and the
    steps whose greedy picks agree (``test_int8_logit_divergence_bounded``
    at full size)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.models.model import build_model

    cfg = override(get_arch("tinyllama-1.1b"), param_dtype="bfloat16")
    model = build_model(cfg, device=dev)
    params = model.init(seed=5)
    B, L, page, P = 2, 256, 256, 2
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, L))
    logits, rows = model.prefill(params, toks, P * page)
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32,
                          device=dev).reshape(B, P)
    pools = [model.insert_cache_pages(
        model.init_page_pool(1 + B * P, page, quantized=q), rows, tables)
        for q in (False, True)]
    tok = logits[:, -1].argmax(-1)
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    worst, same = 0.0, 0
    for _ in range(steps):
        lf, lq = (model.decode_step_pages(params, pool, tok[:, None], pos,
                                          tables)[0][:, -1]
                  for pool in pools)
        rel = (lf - lq).abs().amax(-1) / (lf.amax(-1) - lf.amin(-1))
        worst = max(worst, float(rel.max()))
        same += int((lf.argmax(-1) == lq.argmax(-1)).all())
        tok, pos = lf.argmax(-1), pos + 1
    log(f"reference tinyllama-1.1b int8 pool, teacher-forced "
        f"({cfg.num_layers} layers, logged only): worst logit error / "
        f"spread={worst:.4e}, greedy agreement {same}/{steps} steps")
    del model, params, rows, pools


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# phase 4: serving at full width
# ---------------------------------------------------------------------------

def _launch_counters() -> dict:
    """One launch count per kernel body or route (the int8 bodies and the
    ring routes count apart), and the launches of flash, gmm, the paged
    decode, the scan and the mLSTM at the shapes of their second
    records (flash also at the Super-Sub cascade's), and of the paged
    verify at the prefix passes' and the speculative passes' shapes."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_partial, paged_verify_attention)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.verify_attention.ops import verify_attention
    verify_shapes = paged_verify_attention.launches_by_shape
    counts = {name: functools.partial(verify_shapes.__getitem__,
                                      prefix_verify_shape(*kq))
              for name, kq in PREFIX_VERIFY.items()}
    counts.update({name: functools.partial(verify_shapes.__getitem__,
                                           spec_verify_shape(*ti))
                   for name, ti in SPEC_VERIFY.items()})
    return {**counts,
            "flash_attention": lambda: flash_attention.launches,
            "decode_attention": lambda: decode_attention.launches,
            "decode_attention_ring": lambda: decode_attention.launches_ring,
            "paged_decode_attention":
                lambda: paged_decode_attention.launches,
            "paged_decode_attention_int8":
                lambda: paged_decode_attention.launches_int8,
            "paged_decode_attention_long":
                lambda: paged_decode_attention.launches_by_shape[
                    PAGED_LONG_SHAPE],
            "verify_attention": lambda: verify_attention.launches,
            "verify_attention_ring": lambda: verify_attention.launches_ring,
            "paged_verify_attention":
                lambda: paged_verify_attention.launches,
            "paged_verify_attention_int8":
                lambda: paged_verify_attention.launches_int8,
            "paged_verify_attention_tree":
                lambda: paged_verify_attention.launches_tree,
            "ssm_scan": lambda: ssm_scan.launches,
            "ssm_scan_serving":
                lambda: ssm_scan.launches_by_shape[scan_serving_shape()],
            "mlstm_chunk": lambda: mlstm_chunk.launches,
            "mlstm_chunk_serving":
                lambda: mlstm_chunk.launches_by_shape[MLSTM_SERVING_SHAPE],
            "paged_decode_partial": lambda: paged_decode_partial.launches,
            "paged_decode_partial_int8":
                lambda: paged_decode_partial.launches_int8,
            "gmm": lambda: gmm.launches,
            "flash_attention_window":
                lambda: flash_attention.launches_by_shape[FLASH_WINDOW_SHAPE],
            "flash_attention_cascade":
                lambda: flash_attention.launches_by_shape[CASCADE_FLASH_SHAPE],
            "gmm_down": lambda: gmm.launches_by_shape[GMM_DOWN_SHAPE]}


def run_pass(dev, label, server, cfgs, reqs, make_sched, used,
             keep_server: bool = False, report=None) -> tuple:
    """Serve ``reqs`` ((name, (1, S) prompt) pairs) through one scheduler
    on ``server``, with every launch count zeroed just before.  Each
    request must resolve to NEW_TOKENS in-vocabulary tokens and every
    kernel in ``used`` must have launched.  Logs the pass's report;
    returns (launch counts, outputs), and puts the report in
    ``report`` when given.  Shuts the server down unless ``keep_server``
    (a twin pass follows on the same weights)."""
    import torch
    from repro_torch import kernels

    fns = _launch_counters()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with make_sched(server) as sched:
            futs = [sched.submit(n, t, steps=NEW_TOKENS) for n, t in reqs]
            outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: count() for n, count in fns.items()}
        for (name, toks), o in zip(reqs, outs):
            assert o.shape == (1, NEW_TOKENS), (label, o.shape)
            assert ((o >= 0) & (o < cfgs[name].vocab_size)).all(), label
        for n in used:
            if counts[n] <= 0:
                raise AssertionError(f"{label}: kernel {n} was not "
                                     "launched on the serving path")
        st = server.engine.stats
        rep = {"pass": label, "requests": len(outs),
               "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
               "wall_s": wall,
               "hidden_load_fraction": server.engine.hidden_load_fraction(),
               "loads": st["loads"], "context_changes": st["context_changes"],
               "mean_switch_us": 1e6 * st["switch_seconds"]
               / max(st["switches"], 1),
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "launches": counts}
        snap = sched.snapshot()
        for key in ("spec_rounds", "spec_committed_tokens",
                    "accepted_tokens_per_round", "spec_acceptance_rate"):
            if key in snap:
                rep[key] = snap[key]
        fused = [e for k, e in server._step_engines.items()
                 if k.multi_step > 1]
        if fused:                       # the pass's CUDA graphs of a tick
            rep["graph_captures"] = sum(e.graph_captures for e in fused)
            rep["graph_capture_s"] = sum(e.graph_capture_s for e in fused)
            rep["steps_per_tick"] = sum(
                e.stats["device_steps"] for e in fused) / max(1, sum(
                    e.stats["host_ticks"] for e in fused))
        log("serving " + json.dumps(rep))
        if report is not None:
            report.update(rep)
        return counts, outs
    finally:
        if not keep_server:
            server.shutdown()


def require_bitwise(label, got, want,
                    twin: str = "the single-step twin") -> None:
    """A pass's streams against its twin's (a fused pass's, its
    single-step twin's): the same tokens, every one, or the pass
    fails."""
    import numpy as np
    if len(got) != len(want) or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        same = sum(int((a == b).sum()) for a, b in zip(got, want))
        raise AssertionError(
            f"{label}: streams differ from {twin}'s "
            f"({same} of {sum(b.size for b in want)} tokens agree)")
    log(f"serving {label}: streams bitwise equal to {twin}'s")


def serving_phase(dev) -> dict:
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_server
    from repro_torch.serve.scheduler import ContinuousScheduler, SwitchScheduler

    names = ["tinyllama-1.1b", "supersub-super"]
    page = 256
    max_len = -(-(PROMPT_LENS[1] + NEW_TOKENS) // page) * page      # 768
    rng = np.random.default_rng(0)
    reqs = []
    for r in range(N_REQUESTS):                    # contexts alternate
        name = names[r % 2]
        S = int(rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
        reqs.append((name, rng.integers(0, get_arch(name).vocab_size,
                                        (1, S))))

    passes = [
        ("continuous_paged", lambda s: ContinuousScheduler(
            s, batch_size=8, paged=True, page_size=page),
         {"flash_attention", "paged_decode_attention"}),
        ("continuous_paged_sharded", lambda s: ContinuousScheduler(
            s, batch_size=8, paged=True, page_size=page, shards=SHARDS),
         {"flash_attention", "paged_decode_attention"}),
        ("continuous_row", lambda s: ContinuousScheduler(s, batch_size=8),
         {"flash_attention", "decode_attention"}),
        ("switch_scheduler", SwitchScheduler,
         {"flash_attention", "decode_attention"}),
        ("continuous_row_chunked", lambda s: ContinuousScheduler(
            s, batch_size=8, prefill_chunk=CHUNK),
         {"verify_attention", "decode_attention"}),
        ("continuous_paged_chunked", lambda s: ContinuousScheduler(
            s, batch_size=8, paged=True, page_size=page,
            prefill_chunk=CHUNK),
         {"paged_verify_attention", "paged_decode_attention"}),
        ("continuous_paged_chunked_int8", lambda s: ContinuousScheduler(
            s, batch_size=8, paged=True, page_size=page,
            prefill_chunk=CHUNK, quantize_kv="int8"),
         {"paged_verify_attention_int8", "paged_decode_attention_int8"}),
        ("continuous_paged_multistep", lambda s: ContinuousScheduler(
            s, batch_size=8, paged=True, page_size=page,
            multi_step=MULTI_STEP),
         {"flash_attention", "paged_decode_attention"}),
        ("continuous_row_multistep", lambda s: ContinuousScheduler(
            s, batch_size=8, multi_step=MULTI_STEP),
         {"flash_attention", "decode_attention"}),
    ]
    totals = {n: 0 for n in _launch_counters()}
    outputs = {}
    for label, make_sched, used in passes:
        server, cfgs = build_server(
            names, slots=2, max_len=max_len, reduce=False, device=dev,
            arch_overrides={"param_dtype": "bfloat16"})
        counts, outputs[label] = run_pass(dev, label, server, cfgs, reqs,
                                          make_sched, used)
        for n in totals:
            totals[n] += counts[n]

    def agree(a, b):
        same = sum(int((x == y).sum()) for x, y in zip(a, b))
        return same / (N_REQUESTS * NEW_TOKENS)

    # logical shards change only page ids: the streams must be bitwise
    sharded, unsharded = (outputs["continuous_paged_sharded"],
                          outputs["continuous_paged"])
    if not all(np.array_equal(a, b) for a, b in zip(sharded, unsharded)):
        raise AssertionError(
            "continuous_paged_sharded: streams differ from continuous_paged "
            f"(agreement {agree(sharded, unsharded)})")
    log("serving continuous_paged_sharded: streams bitwise equal to "
        "continuous_paged")
    for layout in ("paged", "row"):
        require_bitwise(f"continuous_{layout}_multistep",
                        outputs[f"continuous_{layout}_multistep"],
                        outputs[f"continuous_{layout}"])

    # logged only: bf16 rounding differs between the paths, and int8 is
    # tolerance-close by design
    log("serving greedy agreement: " + json.dumps({
        "paged_vs_row": agree(outputs["continuous_paged"],
                              outputs["continuous_row"]),
        "switch_vs_row": agree(outputs["switch_scheduler"],
                               outputs["continuous_row"]),
        "chunked_vs_one_shot_row": agree(outputs["continuous_row_chunked"],
                                         outputs["continuous_row"]),
        "chunked_paged_vs_chunked_row": agree(
            outputs["continuous_paged_chunked"],
            outputs["continuous_row_chunked"]),
        "int8_vs_fp_paged": agree(outputs["continuous_paged_chunked_int8"],
                                  outputs["continuous_paged_chunked"])}))
    for extra in (moe_hybrid_pass, xlstm_pass, sharded_local_read_pass,
                  moe_ep_mesh_pass, prefix_pass, spec_pass):
        counts = extra(dev)
        for n in totals:
            totals[n] += counts[n]
    return totals


# records whose launches are a route's or a shape's of a kernel body also
# carry the body's launches: no engine verifies a ring yet, so that route
# launches no time on the main path; the speculative tree passes verify
# the tree route; the speculative records at their shapes, the windowed
# and the cascade's flash, the down product, the long paged decode, the
# scan's and mLSTM's serving records and the prefix passes' verify
# records count the launches at their record's shape
ROUTE_BODY = {"paged_verify_attention_tree": "paged_verify_attention",
              "paged_verify_attention_flat_spec": "paged_verify_attention",
              "paged_verify_attention_tree_spec":
                  "paged_verify_attention_tree",
              "paged_verify_attention_tree_spec_int8":
                  "paged_verify_attention_tree",
              "verify_attention_ring": "verify_attention",
              "flash_attention_window": "flash_attention",
              "flash_attention_cascade": "flash_attention",
              "gmm_down": "gmm",
              "paged_decode_attention_long": "paged_decode_attention",
              "ssm_scan_serving": "ssm_scan",
              "mlstm_chunk_serving": "mlstm_chunk",
              "paged_verify_attention_hit": "paged_verify_attention",
              "paged_verify_attention_hit_int8":
                  "paged_verify_attention_int8",
              "paged_verify_attention_chunk": "paged_verify_attention",
              "paged_verify_attention_chunk_int8":
                  "paged_verify_attention_int8"}
MOE_DEPTH = {"mixtral-8x7b": 4, "jamba-v0.1-52b": 8}   # layers served
LONG_PROMPT = 4160           # > mixtral's 4096-token window: wraps its ring
# the shapes of the windowed flash and down-product records, as counted
# by the wrappers' launches_by_shape: mixtral-8x7b's long prefill, (B, H,
# Hkv, S, hd, window), and its down product after the 4-shard all_to_all,
# (E, C, D, F)
FLASH_WINDOW_SHAPE = (1, MH, MHKV, LONG_PROMPT, MHD, RING)
GMM_DOWN_SHAPE = (2, 320, 14336, 4096)
# and the long paged decode's, (B, Hkv, G, P, page, hd): tinyllama-1.1b's
# heads over 8 rows of 16 pages of 256
PAGED_LONG_SHAPE = (8, HKV, H // HKV, 16, 256, HD)


def hybrid_prompts() -> list:
    """The requests of ``continuous_row_moe_hybrid``: (name, (1, S)
    prompt) pairs alternating mixtral-8x7b and jamba-v0.1-52b, prompts of
    128-512 tokens from a seed, except the third (mixtral's), of
    ``LONG_PROMPT``."""
    import numpy as np
    from repro_torch.configs import get_arch

    names = list(MOE_DEPTH)
    rng = np.random.default_rng(1)
    reqs = []
    for r in range(N_REQUESTS):
        name = names[r % 2]
        S = LONG_PROMPT if r == 2 else int(
            rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
        reqs.append((name, rng.integers(0, get_arch(name).vocab_size,
                                        (1, S))))
    return reqs


def scan_serving_shape() -> tuple:
    """(B, L, d_in, N) of ``ssm_scan_serving``: the hybrid pass admits
    each jamba prompt alone (its prompts differ in length), so its scans
    run at B = 1, 7 layers a prompt; the first jamba prompt's."""
    S = next(p.shape[1] for n, p in hybrid_prompts()
             if n == "jamba-v0.1-52b")
    return (1, S, SCAN_D_IN, SCAN_N)


def moe_hybrid_pass(dev) -> dict:
    """``continuous_row_moe_hybrid``: ContinuousScheduler, row cache, 2
    batch slots and 2 weight slots, 8 requests alternating mixtral-8x7b
    (4 layers) and jamba-v0.1-52b (one 8-layer period) at their published
    widths, random bf16 weights from a seed, pinned in host memory like
    ``build_server``'s.  Prompts of 128-512 tokens, except one mixtral
    prompt of 4160 tokens whose decode runs on the wrapped ring; 32 new
    tokens each, max_len 4224.  Flash (also at the windowed record's
    shape, the 4160-token prefill), decode (jamba's attention layer), ring
    decode (mixtral) and the selective scan (jamba's prefills) must each
    launch, the scan also at its serving record's shape.  Then the same
    requests on the same server and weights with fused decode
    (``multi_step=MULTI_STEP``), whose streams must be bitwise the
    first's.  -> launch counts of both."""
    import gc

    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.launch.serve import _to_host
    from repro_torch.models.model import build_model
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.switching import ServedModel, SwitchableServer

    gc.collect()
    torch.cuda.empty_cache()
    names = list(MOE_DEPTH)
    max_len = LONG_PROMPT + 64
    server = SwitchableServer(num_slots=2, device=dev)
    cfgs = {}
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        cfg = override(get_arch(name), param_dtype="bfloat16",
                       num_layers=MOE_DEPTH[name])
        cfgs[name] = cfg
        model = build_model(cfg, device=dev)
        host = _to_host(model.init(seed=i))
        server.register(ServedModel(name=name, model=model,
                                    weights_fn=lambda p=host: p,
                                    max_len=max_len))
    log(f"serving continuous_row_moe_hybrid: weights made and pinned in "
        f"{time.perf_counter() - t0:.2f} s")
    reqs = hybrid_prompts()
    used = {"flash_attention", "flash_attention_window", "decode_attention",
            "decode_attention_ring", "ssm_scan", "ssm_scan_serving"}
    counts, want = run_pass(
        dev, "continuous_row_moe_hybrid", server, cfgs, reqs,
        lambda s: ContinuousScheduler(s, batch_size=2), used,
        keep_server=True)
    fused, got = run_pass(
        dev, "continuous_row_moe_hybrid_multistep", server, cfgs, reqs,
        lambda s: ContinuousScheduler(s, batch_size=2,
                                      multi_step=MULTI_STEP), used)
    require_bitwise("continuous_row_moe_hybrid_multistep", got, want)
    counts = {n: counts[n] + fused[n] for n in counts}
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return counts


XLSTM_PROMPTS = (300, 512, 768)   # 512 and 768: chunkwise; 300: parallel
# (B, H, L, dh, chunk) of mlstm_chunk_serving: the xlstm pass's 768-token
# prompt, admitted alone, through each of its 9 mLSTM layers
MLSTM_SERVING_SHAPE = (1, MLSTM_H, max(XLSTM_PROMPTS), MLSTM_DH, MLSTM_C)


def xlstm_pass(dev) -> dict:
    """``continuous_row_xlstm``: ContinuousScheduler, row cache, 2 batch
    slots and 2 weight slots, 8 requests alternating xlstm-125m (all 12
    layers) and tinyllama-1.1b at their published widths, bf16 weights
    from a seed.  Prompt lengths cycle through ``XLSTM_PROMPTS``, so
    xlstm-125m gets 300, 768, 512 and 300 tokens: the two that are a
    whole number of two or more 256-token chunks prefill through the
    chunkwise mLSTM kernel in each of the 9 mLSTM layers; 32 new tokens
    each.  The mLSTM kernel, flash and decode (tinyllama) must each
    launch.  Then the same requests on the same server with fused decode
    (``multi_step=MULTI_STEP``), bitwise the first streams.  -> launch
    counts of both."""
    import gc

    import numpy as np
    import torch
    from repro_torch.launch.serve import build_server
    from repro_torch.serve.scheduler import ContinuousScheduler

    names = ["xlstm-125m", "tinyllama-1.1b"]
    server, cfgs = build_server(
        names, slots=2, max_len=max(XLSTM_PROMPTS) + NEW_TOKENS,
        reduce=False, device=dev, arch_overrides={"param_dtype": "bfloat16"})
    rng = np.random.default_rng(3)
    reqs = [(names[r % 2], rng.integers(
        0, cfgs[names[r % 2]].vocab_size,
        (1, XLSTM_PROMPTS[r % len(XLSTM_PROMPTS)])))
        for r in range(N_REQUESTS)]
    used = {"mlstm_chunk", "mlstm_chunk_serving", "flash_attention",
            "decode_attention"}
    counts, want = run_pass(
        dev, "continuous_row_xlstm", server, cfgs, reqs,
        lambda s: ContinuousScheduler(s, batch_size=2), used,
        keep_server=True)
    fused, got = run_pass(
        dev, "continuous_row_xlstm_multistep", server, cfgs, reqs,
        lambda s: ContinuousScheduler(s, batch_size=2,
                                      multi_step=MULTI_STEP), used)
    require_bitwise("continuous_row_xlstm_multistep", got, want)
    counts = {n: counts[n] + fused[n] for n in counts}
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return counts


LOCAL_READ_TOL = 1e-2        # rel L2, local-read vs global-read logits
SPAN_PROMPT = 1600           # 7 pages of 256 with its 32 new tokens: more
#                              than a shard's 6 allocatable, so it spans
SPAN_DEPTHS = (1, 2, 4, 8, 22)   # depths of the spanning-bank sweep


def _drive(eng, params, prompts, max_new) -> tuple:
    """Admit ``prompts`` ((1, S) each) into ``eng`` as room allows and
    step until every request is done -> (the token lists, how many rows
    were given pages on more than one shard)."""
    per = getattr(eng._pages, "pages_per_shard", None)
    pending, gens, spanning = list(prompts), [], 0
    while pending or eng.live_slots():
        while pending and eng.can_admit(pending[0], max_new):
            new = eng.admit(params, pending.pop(0), max_new=max_new)
            if per is not None:
                spanning += sum(len({p // per for p in g.pages}) > 1
                                for g in new)
            gens += new
        eng.step(params)
    return [list(g.tokens) for g in gens], spanning


def _matching(toks, twin) -> float:
    """Share of stream tokens equal, request by request, position by
    position."""
    return sum(a == b for x, y in zip(toks, twin) for a, b in zip(x, y)) \
        / sum(len(x) for x in toks)


def sharded_local_read_pass(dev) -> dict:
    """``sharded_local_read``, the path of kernel B5: a full tinyllama-1.1b
    ``StepEngine`` (paged, page 256, 8 rows, max_len 2048, greedy, bf16
    weights from a seed) with its 28-page bank split over
    ``Mesh((cuda:0,) * 4)`` (6 allocatable pages a shard) and
    ``local_read=True``: each shard writes and reads only its slice and
    the decode partials merge with pmax/psum.  8 requests, 32 new tokens
    each: seven of 128-512 prompt tokens, which the pool routes whole to
    one shard each, and one of ``SPAN_PROMPT`` tokens, whose 7 pages
    span shards, so the merge combines real partials in every decode
    step.  Served three times: a bf16 bank, an int8 bank (B5's int8
    body) and a bf16 bank with chunked prefill (C=128; the sharded
    verify is plain torch, as in JAX).  The unsharded engine serves them
    too, with the same options; how many stream tokens match it is
    logged, and, as a yardstick for bf16 rounding alone, how many of
    the unsharded chunked engine's match the unsharded one-shot's.
    Then, at model level: 8 teacher-forced ``decode_step_pages`` steps
    with ``shard=`` against the same steps without it, on copies of the
    engine's bank (relative L2 of the logits); and a depth sweep
    (``SPAN_DEPTHS``) on a bank whose every row spans the shards: one
    128-token chunk through the sharded verify and 8 decode steps, each
    against the global read, beside two yardsticks of how a
    rounding-sized change grows with depth: the global read with 1% of
    the cached values moved by one bf16 ulp, and the chunk's last logits
    from the paged verify kernel against flash prefill of the prompt and
    chunk together.  Rows on one shard of the engine's bank and the
    one-layer cut are held to ``LOCAL_READ_TOL``; the rest is logged.
    -> launch counts of the three sharded runs."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch, override
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.layers import PagedKV
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import StepEngine

    cfg = override(get_arch("tinyllama-1.1b"), param_dtype="bfloat16")
    model = build_model(cfg, device=dev)
    params = model.init(seed=6)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (1, int(S))) for S in
               rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)]
    prompts[-1] = rng.integers(0, cfg.vocab_size, (1, SPAN_PROMPT))
    mesh = Mesh((dev,) * SHARDS)
    base = dict(batch_size=8, max_len=2048, paged=True, page_size=256,
                num_pages=SHARDS * 7)
    fns = _launch_counters()
    totals = {n: 0 for n in fns}
    streams = {}
    local = dict(mesh=mesh, local_read=True)
    for label, kw, used in (
            ("unsharded", {}, "paged_decode_attention"),
            ("sharded_local_read", local, "paged_decode_partial"),
            ("unsharded_int8", dict(quantize_kv="int8"),
             "paged_decode_attention_int8"),
            ("sharded_local_read_int8", dict(local, quantize_kv="int8"),
             "paged_decode_partial_int8"),
            ("unsharded_chunked", dict(prefill_chunk=CHUNK),
             "paged_verify_attention"),
            ("sharded_local_read_chunked", dict(local, prefill_chunk=CHUNK),
             "paged_decode_partial")):
        eng = StepEngine(model, **base, **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks, spanning = _drive(eng, params, prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: count() for n, count in fns.items()}
        for t in toks:
            assert len(t) == NEW_TOKENS and all(
                0 <= x < cfg.vocab_size for x in t), label
        if counts[used] <= 0:
            raise AssertionError(f"{label}: kernel {used} was not launched")
        rep = {"pass": label, "requests": len(toks),
               "tokens_per_s": len(toks) * NEW_TOKENS / wall, "wall_s": wall}
        if label.startswith("sharded"):
            if not spanning:
                raise AssertionError(f"{label}: no row spans the shards")
            rep["rows_spanning_shards"] = spanning
            for n in totals:
                totals[n] += counts[n]
            rep["tokens_matching_unsharded"] = _matching(
                toks, streams[label.replace("sharded_local_read",
                                            "unsharded")])
        elif label == "unsharded_chunked":
            rep["tokens_matching_one_shot"] = _matching(
                toks, streams["unsharded"])
        streams[label] = toks
        log("serving " + json.dumps({**rep, "launches": counts}))
        del eng
        gc.collect()

    def rel_l2(got, want, what):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"sharded_local_read: non-finite {what}")
        return ((got - want).norm() / want.norm()).item()

    def copies(bank):
        return [bank, [PagedKV(*(None if t is None else t.clone()
                                 for t in c)) for c in bank]]

    def decode8(m, p, banks, tok, pos, table, live=None, groups=None):
        """Worst rel L2 over 8 teacher-forced steps, for each group of
        rows in ``groups`` (default: every live row)."""
        if groups is None:
            groups = {"rows": slice(None) if live is None else live}
        worst = dict.fromkeys(groups, 0.0)
        for _ in range(8):
            got, want = (m.decode_step_pages(p, b, tok, pos, table,
                                             live=live, shard=sh)[0][:, -1]
                         for b, sh in zip(banks, shards))
            for g, rows in groups.items():
                worst[g] = max(worst[g], rel_l2(got[rows], want[rows],
                                                "logits"))
            tok = want.argmax(-1)[:, None]
            pos = pos + (1 if live is None else live.to(pos.dtype))
        return worst

    # (1) the full model on the bank the engine filled: decode_step_pages
    # with shard= against the same steps without it, teacher-forced, on
    # two copies of the bank.  Rows on one shard are held to the limit;
    # the spanning row is logged and read against the sweep below
    shards = ((mesh, mesh.axis_names[0]), None)
    eng = StepEngine(model, **base, **local)
    for p in prompts:
        if eng.can_admit(p, NEW_TOKENS):
            eng.admit(params, p, max_new=NEW_TOKENS)
    st = eng.state
    per = eng._pages.pages_per_shard
    spans = np.array([len({int(x) // per for x in row if x}) > 1
                      for row in st.table]) & eng._live
    if not spans.any():
        raise AssertionError("sharded_local_read: no row of the engine's "
                             "bank spans the shards")
    full = decode8(model, params, copies(st.caches),
                   torch.from_numpy(st.tok[:, None]).to(dev),
                   torch.from_numpy(st.pos).to(dev), st.table_dev,
                   torch.from_numpy(eng._live.copy()).to(dev),
                   groups={g: torch.from_numpy(m).to(dev) for g, m in (
                       ("one_shard", eng._live & ~spans),
                       ("spanning", spans))})
    del eng, st
    log(f"reference sharded_local_read vs the global read, rel_l2: "
        f"{cfg.num_layers} layers on the engine's bank, worst of 8 decode "
        f"steps: rows on one shard {full['one_shard']:.4e} (limit "
        f"{LOCAL_READ_TOL}), the row that spans the shards "
        f"{full['spanning']:.4e}")

    # (2) depth sweep on a bank whose rows all span the shards (row r's
    # page j on shard (r + j) % 4): the local read's gap to the global
    # read beside the growth of a one-ulp change and of a kernel change
    P, page, Lp = 3, 256, 7
    nxt = [1] * SHARDS
    table = torch.zeros((N_REQUESTS, P), dtype=torch.int32)
    for r in range(N_REQUESTS):
        for j in range(P):
            sh = (r + j) % SHARDS
            table[r, j] = sh * Lp + nxt[sh]
            nxt[sh] += 1
    table = table.to(dev)
    short = prompts[:-1] + [prompts[-1][:, :PROMPT_LENS[1]]]
    pos = torch.tensor([p.shape[1] for p in short], dtype=torch.int32,
                       device=dev)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (N_REQUESTS, CHUNK))).to(dev)
    sweep = {}
    for depth in SPAN_DEPTHS:
        cut = build_model(override(cfg, num_layers=depth), device=dev)
        cut_p = {**params, "blocks": params["blocks"][:depth]}
        bank = cut.init_page_pool(SHARDS * Lp, page)
        for r, p in enumerate(short):
            _, rows = cut.prefill(cut_p, p, P * page)
            cut.insert_cache_pages(bank, rows, table[r:r + 1])
        banks = copies(bank)
        got, want = (cut.prefill_chunk_pages(cut_p, b, chunk, pos, table,
                                             shard=sh)[0]
                     for b, sh in zip(banks, shards))
        flash = torch.cat([cut.prefill(
            cut_p, torch.cat([torch.from_numpy(p).to(dev),
                              chunk[r:r + 1]], dim=1), P * page)[0]
            for r, p in enumerate(short)])
        gen = torch.Generator(device=dev).manual_seed(depth)
        nudged = [c._replace(k=c.k.clone(), v=torch.where(
            torch.rand(c.v.shape, generator=gen, device=dev) < 0.01,
            (c.v.float() * (1 + 2 ** -7)).to(c.v.dtype), c.v))
            for c in bank]
        ulp = cut.prefill_chunk_pages(cut_p, nudged, chunk, pos, table)[0]
        sweep[depth] = {
            "chunk": rel_l2(got, want, "chunk logits"),
            "one_ulp_v": rel_l2(ulp, want, "nudged logits"),
            "verify_vs_flash": rel_l2(want[:, -1:], flash, "flash logits"),
            "decode": decode8(cut, cut_p, banks,
                              want[:, -1].argmax(-1)[:, None], pos + CHUNK,
                              table)["rows"]}
        del banks, bank, nudged, cut
    log("reference sharded_local_read depth sweep, rel_l2 on a bank whose "
        f"{N_REQUESTS} rows span the {SHARDS} shards (chunk: local vs "
        "global read of a 128-token chunk; decode: worst of 8 steps; "
        "one_ulp_v: the global read of the chunk with 1% of the cached "
        "values moved by one bf16 ulp, vs without; "
        "verify_vs_flash: the chunk's last logits from the global paged "
        "verify vs flash prefill): " + json.dumps(sweep))
    worst = max(full["one_shard"], sweep[1]["chunk"], sweep[1]["decode"])
    if not worst <= LOCAL_READ_TOL:
        raise AssertionError(f"sharded_local_read: local-read logits rel L2 "
                             f"{worst} > {LOCAL_READ_TOL}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _dropped(p, x, cfg, mesh) -> int:
    """(token, choice) pairs ``moe_ep`` drops for capacity on ``x``."""
    import math

    from repro_torch.models.moe import _dispatch_local, router
    n = mesh.size
    Sl = x.shape[1] // n
    out = 0
    for s in range(n):
        xt = x[:, s * Sl:(s + 1) * Sl].reshape(-1, x.shape[-1])
        top_p, top_i, _ = router(p, xt, cfg.moe)
        cap = max(int(math.ceil(xt.shape[0] * cfg.moe.top_k
                                / cfg.moe.num_experts
                                * cfg.moe.capacity_factor)), 1)
        out += int((~_dispatch_local(xt, top_p, top_i, cfg.moe.num_experts,
                                     cap)[2]).sum())
    return out


def moe_ep_mesh_pass(dev) -> dict:
    """``moe_ep_mesh``, the path of kernel B7: mixtral-8x7b at published
    widths cut to 4 of 32 layers (bf16 weights from a seed, about 12 GB,
    on the card), ``LM(mesh=Mesh((cuda:0,) * 4))``.  A prefill of B=2,
    S=512 runs ``moe_ep`` in every layer (each shard routes its 256
    tokens at capacity 80, two all_to_alls, 3 grouped matmuls a shard:
    48 launches), then 4 greedy decode steps run ``moe_tp`` (S = 1 does
    not split).  Then one full-width MoE layer under the 4-shard mesh on
    2 x 256 tokens, on the card in bf16 against the port's plain path in
    float32 on the CPU on the same weights, within ``REF_TOL`` relative
    L2; the pairs each side drops are logged.  -> launch counts of the
    prefill and decode."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch, override
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_ep

    gc.collect()
    torch.cuda.empty_cache()
    cfg = override(get_arch("mixtral-8x7b"), param_dtype="bfloat16",
                   num_layers=MOE_DEPTH["mixtral-8x7b"])
    mesh = Mesh((dev,) * SHARDS)
    model = build_model(cfg, device=dev, mesh=mesh)
    params = model.init(seed=9)
    B, S, steps = 2, 512, 4
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))
    fns = _launch_counters()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, toks, S + steps)
    out = [logits[:, -1]]
    for i in range(steps):
        logits, _ = model.decode_step(
            params, caches, out[-1].argmax(-1)[:, None],
            torch.full((B,), S + i, dtype=torch.int32, device=dev))
        out.append(logits[:, -1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: count() for n, count in fns.items()}
    want = 3 * SHARDS * cfg.num_layers
    for o in out:
        if o.shape != (B, cfg.vocab_size) or not torch.isfinite(o).all():
            raise AssertionError("moe_ep_mesh: bad logits")
    if (counts["gmm"], counts["gmm_down"]) != (want, want // 3):
        raise AssertionError(f"moe_ep_mesh: gmm launched {counts['gmm']} "
                             f"times, {counts['gmm_down']} at the down "
                             f"product, expected {want} and {want // 3}")
    log("serving " + json.dumps({
        "pass": "moe_ep_mesh", "prefill_tokens": B * S, "decode_steps": steps,
        "wall_s": wall, "max_memory_allocated":
            torch.cuda.max_memory_allocated(dev), "launches": counts}))

    p = params["blocks"][0]["moe"]
    x = torch.randn((B, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(10))
    x = x.to(torch.bfloat16)
    got, _ = moe_ep(p, x.to(dev), cfg, mesh)
    cp = {k: v.float().cpu() for k, v in p.items()}
    cmesh = Mesh(("cpu",) * SHARDS)
    ref, _ = moe_ep(cp, x.float(), cfg, cmesh)
    log(f"reference mixtral-8x7b moe_ep layer: dropped (token, choice) "
        f"pairs card {_dropped(p, x.to(dev), cfg, mesh)}, CPU "
        f"{_dropped(cp, x.float(), cfg, cmesh)} of "
        f"{B * 256 * cfg.moe.top_k}")
    _rel_check("mixtral-8x7b moe_ep layer (4 shards)", got, ref)
    del model, params, caches, cp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


PREFIX_PAGE = 256
PREFIX_LEN = 2048            # the shared preamble: 8 pages of 256
PREFIX_SUFFIX = 32           # each request's own tail
PREFIX_NEW = 16              # new tokens a request
PREFIX_REQUESTS = 10
PREFIX_MAX_LEN = 2304        # 9 pages: the prompt and its new tokens
PREFIX_BUDGET = 19           # pages of the peak-rows runs: 2 cold rows


def prefix_verify_shape(Kb: int, int8: bool) -> tuple:
    """A ``prefix_*`` pass's paged verify launch as its wrapper's
    ``launches_by_shape`` counts it, (B, Hkv, G, Kb, P, page, hd, int8):
    one row over tinyllama-1.1b's 9-page table of 256."""
    return (1, HKV, H // HKV, Kb, PREFIX_MAX_LEN // PREFIX_PAGE,
            PREFIX_PAGE, HD, int8)


# the paged verify records at those shapes -> (Kb, int8): a one-shot
# hit's 32-token tail, and a chunked (C=256) pass's chunk
PREFIX_VERIFY = {"paged_verify_attention_hit": (PREFIX_SUFFIX, False),
                 "paged_verify_attention_hit_int8": (PREFIX_SUFFIX, True),
                 "paged_verify_attention_chunk": (PREFIX_PAGE, False),
                 "paged_verify_attention_chunk_int8": (PREFIX_PAGE, True)}


def _prefix_requests(vocab: int) -> list:
    """``benchmarks/bench_prefix.py``'s traffic: PREFIX_REQUESTS prompts,
    one shared PREFIX_LEN-token preamble and PREFIX_SUFFIX tokens of
    their own each."""
    import numpy as np
    rng = np.random.default_rng(0)
    pre = rng.integers(0, vocab, (1, PREFIX_LEN))
    return [np.concatenate([pre, rng.integers(0, vocab, (1, PREFIX_SUFFIX))],
                           axis=1) for _ in range(PREFIX_REQUESTS)]


def _prefix_drive(eng, params, reqs) -> tuple:
    """The first request alone until its first token (a chunked prompt
    is indexed only then), then the others as room allows, stepping until
    every request is done -> (token lists, peak live rows)."""
    first = eng.admit(params, reqs[0], max_new=PREFIX_NEW)
    while not first[0].tokens:
        eng.step(params)
    gens, pending, peak = list(first), list(reqs[1:]), 1
    while pending or eng.live_slots():
        while pending and eng.can_admit(pending[0], PREFIX_NEW):
            gens += eng.admit(params, pending.pop(0), max_new=PREFIX_NEW)
        peak = max(peak, eng.live_slots())
        if eng.live_slots():
            eng.step(params)
    return [list(g.tokens) for g in gens], peak


def prefix_pass(dev) -> dict:
    """``prefix_*``: the prefix cache on a full tinyllama-1.1b
    ``StepEngine`` (paged, page 256, 10 rows, max_len 2304, greedy, bf16
    weights from a seed) with ``benchmarks/bench_prefix.py``'s traffic:
    10 requests, a 2048-token shared preamble (8 pages) and a 32-token
    tail each, 16 new tokens.  The first request is admitted alone; its
    prompt's 8 whole pages are indexed, and each of the other 9 maps them
    and runs only its 32-token tail, as one final chunk through the
    paged verify kernel (B4), on the one-shot engine too.  Served with
    the cache off and on, one-shot (also int8, fused with
    ``multi_step=8`` and on ``shards=4`` logical shards) and chunked
    (C=256, fp and int8, and over ``Mesh((cuda:0,) * 4)`` with local
    reads, whose decode runs B5).  Required: 9 hits of 8 mapped pages in
    every prefix pass; B4 launched by the one-shot prefix engine, at the
    hit's shape (``PREFIX_VERIFY``), and by the chunked engines at the
    chunk's; the fused and sharded passes bitwise the one-shot prefix
    pass; each chunked prefix pass bitwise its cold chunked twin (a hit
    resumes at a page boundary, so its final chunk is the cold one's,
    over pages the same chunk programs wrote; under local reads its
    pages lie on its anchor's shard); and a full-prefix hit (the bare
    preamble, whose last token is recomputed inside a shared page)
    makes one copy-on-write and leaves every indexed page bitwise as it
    was, on every leaf.  Logged only: the one-shot hit's greedy agreement with
    the cold streams (flash prefill and the verify kernel round apart),
    admit-to-first-token time of a hit and a cold admission (best of 3)
    and the device kernel time of one of each (``torch.profiler``),
    decode tokens/s with the cache on and off, and peak admitted rows at
    a budget of 19 pages, prefix and cold.  -> launch counts of the
    passes."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch, override
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import StepEngine

    cfg = override(get_arch("tinyllama-1.1b"), param_dtype="bfloat16")
    model = build_model(cfg, device=dev)
    params = model.init(seed=7)
    reqs = _prefix_requests(cfg.vocab_size)
    base = dict(batch_size=PREFIX_REQUESTS, max_len=PREFIX_MAX_LEN,
                paged=True, page_size=PREFIX_PAGE)
    on = dict(prefix_cache=True)
    chunked = dict(prefill_chunk=PREFIX_PAGE)
    int8 = dict(quantize_kv="int8")
    local = dict(mesh=Mesh((dev,) * SHARDS), local_read=True)
    hit = ("paged_verify_attention", "paged_verify_attention_hit")
    chunk = ("paged_verify_attention", "paged_verify_attention_chunk")
    chunk8 = ("paged_verify_attention_int8",
              "paged_verify_attention_chunk_int8")
    passes = (              # (label, engine options, kernels it must launch)
        ("prefix_cold", {}, ("paged_decode_attention",)),
        ("prefix_on", on, hit),
        ("prefix_on_multistep", dict(on, multi_step=MULTI_STEP), hit),
        ("prefix_on_sharded", dict(on, shards=SHARDS), hit),
        ("prefix_on_int8", dict(on, **int8),
         ("paged_verify_attention_int8", "paged_verify_attention_hit_int8")),
        ("prefix_chunked_cold", chunked, chunk),
        ("prefix_chunked", dict(chunked, **on), chunk),
        ("prefix_chunked_cold_int8", dict(chunked, **int8), chunk8),
        ("prefix_chunked_int8", dict(chunked, **on, **int8), chunk8),
        ("prefix_chunked_local_read_cold", dict(chunked, **local),
         ("paged_decode_partial",)),
        ("prefix_chunked_local_read", dict(chunked, **on, **local),
         ("paged_decode_partial",)))
    fns = _launch_counters()
    totals = {n: 0 for n in fns}
    streams, kept = {}, {}
    for label, kw, used in passes:
        eng = StepEngine(model, **base, **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks, _ = _prefix_drive(eng, params, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: count() for n, count in fns.items()}
        for n in totals:
            totals[n] += counts[n]
        for t in toks:
            assert len(t) == PREFIX_NEW and all(
                0 <= x < cfg.vocab_size for x in t), label
        for name in used:
            if counts[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was not "
                                     "launched")
        sharing = {k: eng.stats[k] for k in (
            "prefix_hits", "prefix_pages_mapped", "cow_copies",
            "cache_evictions")}
        if kw.get("prefix_cache") and (
                sharing["prefix_hits"], sharing["prefix_pages_mapped"],
                sharing["cow_copies"]) != (PREFIX_REQUESTS - 1,
                                           8 * (PREFIX_REQUESTS - 1), 0):
            raise AssertionError(f"{label}: sharing {sharing}, expected 9 "
                                 "hits of 8 mapped pages")
        streams[label] = toks
        log("serving " + json.dumps({
            "pass": label, "requests": len(toks),
            "tokens_per_s": len(toks) * PREFIX_NEW / wall, "wall_s": wall,
            **sharing, "graph_captures": eng.graph_captures,
            "launches": counts}))
        if label in ("prefix_cold", "prefix_on"):
            kept[label] = eng
        del eng
        gc.collect()
    for label, twin in (("prefix_on_multistep", "prefix_on"),
                        ("prefix_on_sharded", "prefix_on"),
                        ("prefix_chunked", "prefix_chunked_cold"),
                        ("prefix_chunked_int8", "prefix_chunked_cold_int8"),
                        ("prefix_chunked_local_read",
                         "prefix_chunked_local_read_cold")):
        if streams[label] != streams[twin]:
            raise AssertionError(
                f"{label}: streams differ from {twin}'s (matching "
                f"{_matching(streams[label], streams[twin])})")
        log(f"serving {label}: streams bitwise equal to {twin}'s")

    cold, hot = kept["prefix_cold"], kept["prefix_on"]

    def ttft(eng, req) -> float:
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = eng.admit(params, req, max_new=PREFIX_NEW)[0]
            best = min(best, time.perf_counter() - t0)   # first token read
            assert g.tokens
            eng.drain(params)
        return best

    def admit_kernel_ms(eng, req):
        """Device kernel time of one admission (``torch.profiler``: the
        kernels' own time, host dispatch left out)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.admit(params, req, max_new=PREFIX_NEW)
            torch.cuda.synchronize()
        eng.drain(params)
        per = kernel_us(prof)
        return sum(per.values()) / 1e3 if per else "not measured"

    def decode_tps(eng) -> float:
        eng.reset(keep_prefix=True)
        gens = [eng.admit(params, r, max_new=PREFIX_NEW)[0] for r in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.drain(params)
        torch.cuda.synchronize()
        return sum(len(g.tokens) - 1 for g in gens) / (
            time.perf_counter() - t0)

    t_cold, t_hit = ttft(cold, reqs[1]), ttft(hot, reqs[1])
    k_cold, k_hit = admit_kernel_ms(cold, reqs[2]), admit_kernel_ms(
        hot, reqs[2])
    tps = {"cold": decode_tps(cold), "prefix": decode_tps(hot)}
    # copy-on-write: the bare preamble hits all 8 pages, so its last
    # token (position 2047) is recomputed inside the 8th shared page
    idx = torch.as_tensor(sorted(hot._prefix.pages()), device=dev)
    leaves = [t for c in hot.state.caches for t in c if t is not None]
    before = [t[idx].clone() for t in leaves]
    cows = hot.stats["cow_copies"]
    hot.admit(params, reqs[0][:, :PREFIX_LEN], max_new=PREFIX_NEW)
    hot.drain(params)
    torch.cuda.synchronize()
    if hot.stats["cow_copies"] != cows + 1:
        raise AssertionError("prefix_on: the full-prefix hit made "
                             f"{hot.stats['cow_copies'] - cows} copies")
    if not all(torch.equal(b, t[idx]) for b, t in zip(before, leaves)):
        raise AssertionError("prefix_on: an indexed page changed under a "
                             "copy-on-write hit")
    log(f"serving prefix_on: one copy-on-write, {len(idx)} indexed pages "
        f"bitwise unchanged on all {len(leaves)} leaves")
    del kept, cold, hot, before, leaves
    gc.collect()
    peak = {}
    for name, kw in (("cold", {}), ("prefix", on)):
        eng = StepEngine(model, **dict(base, num_pages=PREFIX_BUDGET), **kw)
        peak[name] = _prefix_drive(eng, params, reqs)[1]
        del eng
        gc.collect()
    log("serving prefix " + json.dumps({
        "hit_vs_cold_greedy_agreement": _matching(streams["prefix_on"],
                                                  streams["prefix_cold"]),
        "int8_hit_vs_fp_hit_agreement": _matching(
            streams["prefix_on_int8"], streams["prefix_on"]),
        "chunked_vs_one_shot_agreement": _matching(
            streams["prefix_chunked"], streams["prefix_on"]),
        "local_read_vs_global_chunked_agreement": _matching(
            streams["prefix_chunked_local_read"], streams["prefix_chunked"]),
        "ttft_s": {"cold": t_cold, "hit": t_hit,
                   "hit_over_cold": t_hit / t_cold},
        "admit_kernel_ms": {"cold": k_cold, "hit": k_hit},
        "decode_tokens_per_s": {**tps,
                                "prefix_over_cold": tps["prefix"]
                                / tps["cold"]},
        "peak_rows_at_19_pages": peak}))
    return totals


# ---------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# ---------------------------------------------------------------------------

def _profile_window(eng, params, ticks: int) -> tuple:
    """``ticks`` engine ticks under ``torch.profiler`` -> (device kernel
    ms summed by kernel name, decode steps committed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    d0 = eng.stats["device_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step(params)
        torch.cuda.synchronize()
    return ({k: us / 1e3 for k, us in kernel_us(prof).items()},
            eng.stats["device_steps"] - d0)


def _timed_ticks(eng, params, ticks: int) -> tuple:
    """Wall ms of ``ticks`` engine ticks (host clock, ending in a
    synchronize) -> (ms, decode steps committed)."""
    import torch
    torch.cuda.synchronize()
    d0 = eng.stats["device_steps"]
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step(params)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), eng.stats["device_steps"] - d0


def _replay_ms(eng, iters: int = 5) -> float:
    """The device span of one replay of ``eng``'s tick graph (CUDA events
    around the replay alone, its kernels and the gaps between them; the
    tick's host work left out), mean of ``iters``.  The replays repeat
    the engine's last tick on its static inputs, which rewrites the same
    tokens' k/v at the same positions: a dense model's caches and the
    engine's host state stay as they were."""
    import torch
    (g,) = eng._graphs.values()
    total = 0.0
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def profile_phase(dev, steps: int = 8) -> None:
    """A full tinyllama-1.1b ``StepEngine`` (8 rows admitted with 256- to
    512-token prompts), row and paged: the wall time of ``steps`` steady
    decode steps (host clock, ending in a synchronize), then, from
    ``torch.profiler`` over ``steps`` more, the device's kernel time
    per step, its busy share of the unprofiled wall time and the five
    kernels that take the most of it.  Then the same engines fused
    (``multi_step=MULTI_STEP``): per committed step, over 4 steady ticks
    and 2 profiled ones, the same numbers, with the graph captures and
    their seconds and the device span of a replay alone (its kernels and
    the gaps between them, without the tick's host work); the fused
    engine must take less wall time per committed step than the
    single-step one.  Then ``generate_fused``
    (prefill, then 15 decode steps as one graph replay) against
    ``generate`` on two 256-token prompts: the same tokens.  Runs after
    the serving passes, so none of its launches enters the kernels'
    counts."""
    import numpy as np
    from repro_torch.configs import get_arch, override
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine, StepEngine

    cfg = override(get_arch("tinyllama-1.1b"), param_dtype="bfloat16")
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (1, int(S)))
               for S in rng.integers(256, 513, 8)]

    def report(engine, wall_ms, per, nsteps, extra):
        per = {k: ms / nsteps for k, ms in per.items()}
        dev_ms = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
        log("profile " + json.dumps({
            "engine": engine, "rows": 8, "step_wall_ms": wall_ms, **extra,
            "device_kernel_ms_per_step":
                dev_ms if per else "not measured",
            "device_busy_share": dev_ms / wall_ms if per else "not measured",
            "top_kernels_ms_per_step": {k[:80]: v for k, v in top}}))

    single = {}
    for paged in (False, True):
        name = "paged" if paged else "row"
        eng = StepEngine(model, batch_size=8, max_len=768, paged=paged,
                         page_size=256)
        for p in prompts:
            eng.admit(params, p, max_new=2 * steps + 8)
        for _ in range(4):                                  # warm-up
            eng.step(params)
        ms, n = _timed_ticks(eng, params, steps)
        single[name] = ms / n
        per, n_prof = _profile_window(eng, params, steps)
        report(name, single[name], per, n_prof, {})
        del eng
    for paged in (False, True):
        name = "paged" if paged else "row"
        eng = StepEngine(model, batch_size=8, max_len=768, paged=paged,
                         page_size=256, multi_step=MULTI_STEP)
        for p in prompts:                   # 2 + 4 + 2 ticks of 8 steps
            eng.admit(params, p, max_new=8 * MULTI_STEP + 1)
        t0 = time.perf_counter()
        eng.step(params)                    # capture, then the first replay
        first_tick_s = time.perf_counter() - t0
        eng.step(params)
        ms, n = _timed_ticks(eng, params, 4)
        per, n_prof = _profile_window(eng, params, 2)
        report(f"{name}_multistep", ms / n, per, n_prof, {
            "multi_step": MULTI_STEP, "tick_wall_ms": ms / 4,
            "single_step_wall_ms": single[name],
            "graph_replay_ms_per_step": _replay_ms(eng) / MULTI_STEP,
            "graph_captures": eng.graph_captures,
            "graph_capture_s": eng.graph_capture_s,
            "first_tick_s": first_tick_s})
        if eng.graph_captures != 1 or ms / n >= single[name]:
            raise AssertionError(
                f"profile {name}_multistep: {eng.graph_captures} captures, "
                f"{ms / n:.3f} ms a committed step against "
                f"{single[name]:.3f} single-step")
        del eng

    se = ServingEngine(model, params, max_len=768)
    toks = rng.integers(0, cfg.vocab_size, (2, 256))
    want = se.generate(toks, 16)
    t0 = time.perf_counter()
    got = se.generate_fused(toks, 16)
    fused_s = time.perf_counter() - t0
    if got.shape != (2, 16) or not np.array_equal(got, want):
        raise AssertionError("generate_fused: tokens differ from generate's")
    eng = se.step_engine(2, multi_step=15)
    log("profile generate_fused " + json.dumps({
        "equal_to_generate": True, "steps": 16, "wall_s": fused_s,
        "host_ticks": eng.stats["host_ticks"],
        "graph_captures": eng.graph_captures,
        "graph_capture_s": eng.graph_capture_s}))


SPEC_DRAFT = "tinyllama-1.1b:draft"
SPEC_PERTURB = 2e-3          # the tree passes' draft: weights + 2e-3 N(0, 1)


def spec_server(dev, max_len: int, perturb: float) -> tuple:
    """tinyllama-1.1b at its published width (bf16 weights from a seed,
    pinned in host memory, as ``build_server`` makes them) and a draft
    context ``SPEC_DRAFT`` of the same model: the target's own weights
    (an aligned draft, as ``benchmarks/bench_speculative.py`` has it) or,
    with ``perturb``, those weights plus ``perturb`` times a standard
    normal draw (seed 9), which disagree with the target now and then."""
    import torch
    from repro_torch.launch.serve import _to_host, build_server
    from repro_torch.serve.switching import ServedModel

    server, cfgs = build_server(["tinyllama-1.1b"], slots=2, max_len=max_len,
                                reduce=False, device=dev,
                                arch_overrides={"param_dtype": "bfloat16"})
    sm = server._served["tinyllama-1.1b"]
    params = sm.weights_fn()
    if perturb:
        gen = torch.Generator(device=dev).manual_seed(9)

        def noised(t):
            d = t.to(dev).float()
            d += perturb * torch.randn(d.shape, generator=gen, device=dev)
            return d.to(t.dtype)
        params = _to_host(_tree(noised, params))
    server.register(ServedModel(name=SPEC_DRAFT, model=sm.model,
                                weights_fn=lambda p=params: p,
                                max_len=max_len))
    cfgs[SPEC_DRAFT] = cfgs["tinyllama-1.1b"]
    return server, cfgs


def spec_pass(dev) -> dict:
    """``spec_*``: speculative decoding through ``ContinuousScheduler``
    at tinyllama-1.1b's published width (bf16, 2 weight slots, 8 slots
    of paged columns, pages of 256), 8 requests of 128-512 prompt tokens
    and NEW_TOKENS new ones, greedy: ``spec_plain_twin`` (the same
    requests on a plain paged engine), ``spec_flat`` (K=4, an aligned
    draft), ``spec_flat_shared_bank`` (the same, the target column on a
    ``SharedBank``: bitwise ``spec_flat``), ``spec_tree`` (K=4, W=3, a
    perturbed draft: the tree route of B4, at the tree records' shape)
    and ``spec_tree_int8_chunked`` (the same on int8 columns, prompts in
    CHUNK-token chunks).  Logged beside each: accepted tokens a round,
    rounds, the twin's tokens/s and the greedy agreement with it."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.serve.scheduler import ContinuousScheduler

    target = "tinyllama-1.1b"
    max_len = SPEC_P * SPEC_PAGE
    rng = np.random.default_rng(2)
    vocab = get_arch(target).vocab_size
    reqs = [(target, rng.integers(0, vocab, (1, int(rng.integers(
        PROMPT_LENS[0], PROMPT_LENS[1] + 1))))) for _ in range(N_REQUESTS)]

    def sched(**kw):
        return lambda s: ContinuousScheduler(
            s, batch_size=N_REQUESTS, paged=True, page_size=SPEC_PAGE, **kw)

    spec = dict(draft={target: SPEC_DRAFT}, spec_k=SPEC_K)
    tree = dict(spec, spec_tree=SPEC_W)
    paged = {"flash_attention", "paged_decode_attention"}
    flat = paged | {"paged_verify_attention",
                    "paged_verify_attention_flat_spec"}
    runs = [(0.0, [
        ("spec_plain_twin", sched(), paged),
        ("spec_flat", sched(**spec), flat),
        ("spec_flat_shared_bank", sched(**spec, share_bank=True), flat)]),
        (SPEC_PERTURB, [
            ("spec_tree", sched(**tree),
             paged | {"paged_verify_attention_tree",
                      "paged_verify_attention_tree_spec"}),
            ("spec_tree_int8_chunked",
             sched(**tree, prefill_chunk=CHUNK, quantize_kv="int8"),
             {"paged_verify_attention_int8", "paged_decode_attention_int8",
              "paged_verify_attention_tree",
              "paged_verify_attention_tree_spec_int8"})])]
    totals = {n: 0 for n in _launch_counters()}
    outs, reports = {}, {}
    for perturb, passes in runs:
        server, cfgs = spec_server(dev, max_len, perturb)
        try:
            for label, make, used in passes:
                reports[label] = {}
                counts, outs[label] = run_pass(
                    dev, label, server, cfgs, reqs, make, used,
                    keep_server=True, report=reports[label])
                for n in totals:
                    totals[n] += counts[n]
        finally:
            server.shutdown()
    require_bitwise("spec_flat_shared_bank", outs["spec_flat_shared_bank"],
                    outs["spec_flat"], twin="spec_flat")
    twin = reports["spec_plain_twin"]
    for label in ("spec_flat", "spec_tree", "spec_tree_int8_chunked"):
        rep = reports[label]
        log(f"serving {label}: " + json.dumps({
            "tokens_per_s": rep["tokens_per_s"],
            "accepted_tokens_per_round": rep["accepted_tokens_per_round"],
            "spec_rounds": rep["spec_rounds"],
            "spec_acceptance_rate": rep["spec_acceptance_rate"],
            "twin_tokens_per_s": twin["tokens_per_s"],
            "greedy_agreement_with_twin": _matching(
                [list(o[0]) for o in outs[label]],
                [list(o[0]) for o in outs["spec_plain_twin"]])}))
    return totals


def spec_reference(dev) -> None:
    """tinyllama-1.1b at full width cut to one layer, two prompts (200
    and 333 tokens) admitted into a ``SpecEngine`` (K=4, W=3, pages of
    256) on the card (bf16, kernels) and on the CPU in float32 on the
    same weights: the same page tables and positions, then one tree
    round's verify pass (13 nodes, the engine's depth offsets and
    ancestor masks) and one flat verify (5 tokens), each within
    ``REF_TOL`` of the CPU's logits.  The greedy accept rules
    (``tree_speculative_accept``, ``speculative_accept``) on the card's
    logits, run on the card and on the CPU, must agree bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, override
    from repro_torch.models.model import build_model
    from repro_torch.serve.speculative import (
        SpecEngine, speculative_accept, tree_speculative_accept)

    K, W = SPEC_K, SPEC_W
    cfg = override(get_arch("tinyllama-1.1b"), param_dtype="bfloat16",
                   num_layers=REF_LAYERS)
    gpu = build_model(cfg, device=dev)
    params = gpu.init(seed=7)
    cpu = build_model(override(cfg, dtype="float32", param_dtype="float32"),
                      cache_dtype=torch.float32, device="cpu")
    cparams = _tree(lambda t: t.float().cpu(), params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (200, 333)]
    engs = []
    for model, p in ((gpu, params), (cpu, cparams)):
        eng = SpecEngine(model, model, batch_size=2, max_len=768, k=K,
                         tree_width=W, page_size=SPEC_PAGE)
        for prompt in prompts:
            eng.admit((p, p), prompt, max_new=8)
        engs.append(eng)
    for key in ("pos", "t_table", "tok"):
        a, b = (getattr(e.state, key).cpu() for e in engs)
        log(f"reference spec {key}: card {a.flatten().tolist()[:8]} cpu "
            f"{b.flatten().tolist()[:8]}")
        if key != "tok" and not torch.equal(a, b):
            raise AssertionError(f"spec reference: {key} differs")
    fns = engs[0]._programs(K)
    Kt = 1 + K * W
    block = rng.integers(0, cfg.vocab_size, (2, Kt))
    logits = []
    for (model, p), eng in zip(((gpu, params), (cpu, cparams)), engs):
        dv = eng.device
        st = eng.state
        tree_l, _ = model.verify_step_pages(
            p, st.t_caches, torch.as_tensor(block, device=dv), st.pos,
            st.t_table, wmask=fns["writer"].to(dv)[None].expand(2, Kt),
            offsets=fns["offsets"].to(dv), tree=fns["tree"].to(dv))
        flat_l, _ = model.verify_step_pages(
            p, st.t_caches, torch.as_tensor(block[:, :K + 1], device=dv),
            st.pos, st.t_table)
        logits.append((tree_l, flat_l))
    (tree_g, flat_g), (tree_c, flat_c) = logits
    _rel_check(f"tinyllama-1.1b spec tree verify ({REF_LAYERS} layer)",
               tree_g, tree_c)
    _rel_check(f"tinyllama-1.1b spec flat verify ({REF_LAYERS} layer)",
               flat_g, flat_c)
    tgt = tree_g.argmax(-1).cpu().numpy()
    cand = rng.integers(0, cfg.vocab_size, (2, K, W))
    for i in range(K):                # hits on the chain and on siblings
        parent = 0 if i == 0 else 1 + (i - 1) * W
        cand[0, i, i % W] = tgt[0, parent]
        cand[1, i, (i + 1) % W] = tgt[1, parent]
    props = tgt[:, :K].copy()
    props[1, 2] = (props[1, 2] + 1) % cfg.vocab_size
    dl = torch.randn((2, K, cfg.vocab_size), device=dev)
    for label, fn, args in (
            ("tree_speculative_accept", tree_speculative_accept,
             (cand, dl, tree_g)),
            ("speculative_accept", speculative_accept,
             (props, dl, flat_g))):
        on_card = fn(*(torch.as_tensor(a, device=dev) for a in args), 0.0)
        on_cpu = fn(*(torch.as_tensor(a).cpu() for a in args), 0.0)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
        log(f"reference spec {label} on the card's logits: n card "
            f"{on_card[1].tolist()} cpu {on_cpu[1].tolist()}, bitwise "
            f"{same}")
        if not same:
            raise AssertionError(f"{label}: card and CPU disagree on the "
                                 "card's logits")
    spec_planted_sibling(gpu, params, prompts)
    spec_depth_sweep(dev, prompts)


def spec_planted_sibling(m, params, prompts) -> None:
    """One greedy tree round on the card with a sibling hit planted.
    Two ``SpecEngine``s (K=4, W=3) over ``m`` drafted by itself admit
    ``prompts``; in the planted one's round the draft's top two
    candidates swap at every depth, so the chain carries the runner-up
    (whose k/v the draft writes at pos+1) and the draft's argmax sits at
    sibling 1 of depth 1.  That round must commit the sibling and the
    bonus after it on every row, the tokens of the unplanted twin's
    round, repair the draft column at pos+1 on every row, and leave both
    columns' k/v there within 2**-7 relative L2 of the twin's, a limit
    the draft column's k/v before its repair (the runner-up's) must
    leave."""
    import torch
    import repro_torch.serve.speculative as spec

    def kv_at(eng, column, at):             # -> (layers, B, Hkv, 2 hd)
        st = eng.state
        caches, table = ((st.d_caches, st.d_table) if column == "draft"
                         else (st.t_caches, st.t_table))
        rows = torch.arange(at.shape[0], device=at.device)
        pages = table[rows, (at // SPEC_PAGE).long()].long()
        slot = (at % SPEC_PAGE).long()
        return torch.stack([torch.cat([c.k[pages, :, slot],
                                       c.v[pages, :, slot]], -1).float()
                            for c in caches])

    pp = (params, params)
    engs = []
    for _ in range(2):
        eng = spec.SpecEngine(m, m, batch_size=2, max_len=768, k=SPEC_K,
                              tree_width=SPEC_W, page_size=SPEC_PAGE)
        engs.append((eng, [eng.admit(pp, t, max_new=8)[0] for t in prompts]))
    (planted, pgens), (twin, tgens) = engs
    at = planted.state.pos + 1
    seen = {}
    repair, top_w = planted._repair_d_fn, spec._top_w

    def watched(dparams, tok, rpos, alive):
        seen.update(rpos=rpos.clone(), alive=alive.clone(),
                    before=kv_at(planted, "draft", rpos))
        return repair(dparams, tok, rpos, alive)

    planted._repair_d_fn = watched
    spec._top_w = lambda logits, w: top_w(logits, w)[:, [1, 0,
                                                         *range(2, w)]]
    try:
        planted.step(pp)
    finally:
        spec._top_w = top_w
        del planted._repair_d_fn
    twin.step(pp)
    got = [[int(x) for x in g.tokens] for g in pgens]
    twins = [[int(x) for x in g.tokens] for g in tgens]
    want = [t[:len(x)] for t, x in zip(twins, got)]
    errs = {c: row_error(kv_at(planted, c, at), kv_at(twin, c, at)).max()
            .item() for c in ("target", "draft")}
    fault = row_error(seen["before"], kv_at(twin, "draft", at)).amin(
        dim=(0, 2)) if seen else None
    log("reference spec planted sibling: " + json.dumps({
        "tokens": got, "twin_tokens": twins,
        "draft_repair_rows": seen["alive"].tolist() if seen else None,
        "kv_rel_l2_vs_twin": errs, "row_limit": ROW_RTOL,
        "unrepaired_draft_kv_rel_l2": None if fault is None
        else fault.tolist()}))
    if not seen or not bool(seen["alive"].all()) or not torch.equal(
            seen["rpos"].long(), at.long()):
        raise AssertionError("spec planted sibling: the draft repair did "
                             "not run at pos+1 on every row")
    if [len(t) for t in got] != [3] * len(prompts) or got != want:
        raise AssertionError("spec planted sibling: the round did not "
                             "commit the sibling and its bonus, the twin's "
                             "tokens")
    if not max(errs.values()) <= ROW_RTOL:
        raise AssertionError(f"spec planted sibling: k/v at the sibling's "
                             f"position {errs} off the twin's")
    if not fault.min().item() > ROW_RTOL:
        raise AssertionError("spec planted sibling: the limit does not "
                             "catch an unrepaired draft column")


SPEC_DEPTHS = (1, 2, 4, 8)   # depths of the aligned-draft sweep
SPEC_MIN_ACCEPTED = 3.0      # its one-layer point: tokens a round, at least
SPEC_MIN_AGREEMENT = 0.9     # and agreement with the plain engine


def spec_depth_sweep(dev, prompts) -> None:
    """An aligned draft (the target's own weights) at tinyllama-1.1b's
    width cut to 1-8 layers, two prompts and 24 new tokens each through
    a ``SpecEngine`` (K=4, flat, greedy) and through a plain paged
    ``StepEngine`` on the card: accepted tokens a round and the streams'
    agreement.  At one layer the draft must be accepted at
    ``SPEC_MIN_ACCEPTED`` tokens a round or more and the streams agree
    on ``SPEC_MIN_AGREEMENT`` of their tokens; deeper, logged only: the
    draft proposes through the decode kernel (B3), the target scores
    through the verify kernel (B4), they round apart in bf16, and with
    random weights the gap grows with depth (``sharded_local_read``'s
    sweep measures the same growth for another pair of routes)."""
    from repro_torch.configs import get_arch, override
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import StepEngine
    from repro_torch.serve.speculative import SpecEngine

    for depth in SPEC_DEPTHS:
        m = build_model(override(get_arch("tinyllama-1.1b"),
                                 param_dtype="bfloat16", num_layers=depth),
                        device=dev)
        p = m.init(seed=7)
        spec = SpecEngine(m, m, batch_size=2, max_len=768, k=SPEC_K,
                          page_size=SPEC_PAGE)
        plain = StepEngine(m, batch_size=2, max_len=768, paged=True,
                           page_size=SPEC_PAGE)
        got = [spec.admit((p, p), t, max_new=24)[0] for t in prompts]
        spec.drain((p, p))
        want = [plain.admit(p, t, max_new=24)[0] for t in prompts]
        plain.drain(p)
        same = _matching([g.tokens for g in got], [g.tokens for g in want])
        log(f"reference spec depth {depth}: accepted tokens a round "
            f"{spec.accepted_per_round:.3f} over {spec.stats['rounds']} "
            f"rounds, agreement with the plain engine {same:.4f}")
        if depth == 1 and not (spec.accepted_per_round >= SPEC_MIN_ACCEPTED
                               and same >= SPEC_MIN_AGREEMENT):
            raise AssertionError(
                f"spec depth 1: an aligned draft accepted "
                f"{spec.accepted_per_round} tokens a round (at least "
                f"{SPEC_MIN_ACCEPTED}) and agreed with the plain engine on "
                f"{same} (at least {SPEC_MIN_AGREEMENT})")
        del m, p, spec, plain



# ---------------------------------------------------------------------------
# phase 6: the paper's Super-Sub workload and reconfiguration
# ---------------------------------------------------------------------------

def _counted(label, fn, used) -> dict:
    """Run ``fn`` with every launch count zeroed just before it; read the
    counts just after and require each of ``used`` above 0."""
    import torch
    from repro_torch import kernels
    fns = _launch_counters()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = {n: count() for n, count in fns.items()}
    for n in used:
        if counts[n] <= 0:
            raise AssertionError(f"{label}: kernel {n} was not launched")
    log(f"{label} launches " + json.dumps({n: counts[n] for n in used}))
    return counts


def _bf16_arch(name: str, **kw):
    from repro_torch.configs import get_arch, override
    return override(get_arch(name), param_dtype="bfloat16", **kw)


def _head(dev, d: int, classes: int, seed: int):
    """A classifier head (d, classes), bf16, from ``seed``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.02 * torch.randn(d, classes, generator=g, device=dev)).to(
        torch.bfloat16)


def _cascade_task():
    from repro_torch.train.data import HierarchicalTask
    return HierarchicalTask(num_super=4, subs_per_super=3, vocab=512,
                            seq_len=CASCADE_S)


def _cascade_batches(task, dev, seed0: int) -> list:
    """CASCADE_BATCHES batches of CASCADE_B sequences, each of one
    subclass (``benchmarks/figS1_pipeline.py``'s), on the card; -> (tokens,
    subclasses) pairs."""
    import numpy as np
    out = []
    for b in range(CASCADE_BATCHES):
        x, sub, _ = task.sample(CASCADE_B, seed=seed0 + b,
                                subclasses=np.array([3 * (b % 4)]))
        out.append((x.to(dev), sub))
    return out


def cascade_reference(dev, task) -> None:
    """The cascade's router classifier: the supersub-super backbone at
    full width cut to ``REF_LAYERS`` layer (as ``reference_phase`` cuts
    the served models, for the reason given there), mean-pooled, with a
    (256, 4) head, on 64 sequences of 256 tokens of the task: on the card
    (bf16, the flash kernel at the cascade's shape) against the plain
    path on the CPU in float32 on the same weights, each row of pooled
    logits within ``REF_TOL`` relative L2."""
    import torch
    from repro_torch.configs import override
    from repro_torch.core.cascade import classifier_logits
    from repro_torch.models.model import build_model

    cfg = _bf16_arch("supersub-super", num_layers=REF_LAYERS)
    gpu = build_model(cfg, device=dev)
    params = {"backbone": gpu.init(seed=21),
              "head": _head(dev, cfg.d_model, task.num_super, 22)}
    x = task.sample(CASCADE_B, seed=0)[0]
    got = classifier_logits(gpu, params, x.to(dev)).cpu()
    cpu = build_model(override(cfg, dtype="float32", param_dtype="float32"),
                      cache_dtype=torch.float32, device="cpu")
    want = classifier_logits(cpu, _tree(lambda t: t.float().cpu(), params),
                             x)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"cascade_reference: shape {tuple(got.shape)}"
                             f" (want {tuple(want.shape)}) or non-finite")
    rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"cascade_reference ({REF_LAYERS} layer): worst row rel_l2="
        f"{rel:.4e} (limit {REF_TOL}), argmax agreement {same:.4f}")
    if not rel <= REF_TOL:
        raise AssertionError(f"cascade_reference: a row's rel L2 {rel} > "
                             f"{REF_TOL}")


def _likelihood_super(task):
    """The cascade's router as ``benchmarks/_members.py`` builds it, in
    plain torch: the task's log-likelihood tables (pinned host memory),
    each sequence's token counts against them, the subclass posteriors
    summed per superclass."""
    import numpy as np
    import torch
    from repro_torch.core.cascade import CascadeMember
    from repro_torch.launch.serve import _to_host
    host = _to_host({
        "logd": torch.from_numpy(np.log(task.dists + 1e-9).astype(
            np.float32)),
        "sup_of": torch.from_numpy(task.sub_of_super)})

    def apply(p, x):
        x = x.long()
        c = torch.zeros(x.shape[0], task.vocab, device=x.device).scatter_add_(
            1, x, torch.ones(x.shape, device=x.device))
        return torch.zeros(x.shape[0], task.num_super,
                           device=x.device).index_add_(
            1, p["sup_of"], torch.softmax(c @ p["logd"].T, -1))
    return CascadeMember("super", apply, lambda: host)


def _classifier(dev, name, arch, classes, seed, covers=None):
    """A cascade member at ``arch``'s published width: its backbone from
    ``seed`` and a (d, classes) head, pinned in host memory."""
    from repro_torch.core.cascade import CascadeMember, classifier_logits
    from repro_torch.launch.serve import _to_host
    from repro_torch.models.model import build_model
    m = build_model(_bf16_arch(arch), device=dev)
    host = _to_host({"backbone": m.init(seed=seed),
                     "head": _head(dev, m.cfg.d_model, classes, seed + 1)})
    return CascadeMember(name, lambda p, x: classifier_logits(m, p, x),
                         lambda: host, covers=covers)


def cascade_pipelined(dev, task) -> dict:
    """One cascade at published width on ``ContextSwitchEngine(num_slots
    =2)``: the likelihood router, the generalist (supersub-super, 12
    classes) and four specialists (supersub-sub, 3 classes each), random
    weights from distinct seeds.  ``dynamic_infer_pipelined`` over 8
    single-subclass batches of 64 x 256 tokens must give, batch for
    batch, the predictions of ``dynamic_infer`` on a fresh engine,
    bitwise, and hide some specialist load behind execution; the same
    on three slots (where each load is issued before the previous
    batch's specialist pass) gives the same predictions, its hidden
    load logged beside the two-slot run's; then
    ``evaluate`` (static and dynamic accuracy) on 8 more batches, logged.
    One batch through a scratch engine first pays the first calls, so
    the two walls compare.  Counted: flash at the cascade's shape must
    launch."""
    import numpy as np
    import torch
    from repro_torch.core.cascade import SuperSubCascade
    from repro_torch.core.context import ContextSwitchEngine

    sup = _likelihood_super(task)
    gen = _classifier(dev, "generalist", "supersub-super", task.num_sub, 31)
    specs = [_classifier(dev, f"spec{g}", "supersub-sub",
                         task.subs_per_super, 41 + 2 * g, covers=g)
             for g in range(task.num_super)]
    batches = [x for x, _ in _cascade_batches(task, dev, 0)]
    runs = {}
    warm = ContextSwitchEngine(num_slots=2, device=dev)   # first calls
    SuperSubCascade(warm, sup, specs, gen, task.sub_of_super).dynamic_infer(
        batches[0])
    warm.shutdown()

    def drive():
        for mode in ("pipelined", "pipelined3", "sequential"):
            eng = ContextSwitchEngine(num_slots=3 if mode == "pipelined3"
                                      else 2, device=dev)
            cas = SuperSubCascade(eng, sup, specs, gen, task.sub_of_super)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (cas.dynamic_infer_pipelined(batches)
                   if mode.startswith("pipelined")
                   else [cas.dynamic_infer(x) for x in batches])
            torch.cuda.synchronize()
            runs[mode] = (out, time.perf_counter() - t0, dict(eng.stats),
                          eng.hidden_load_fraction())
            if mode == "sequential":
                accs = [cas.evaluate(x, sub, batch=CASCADE_B)
                        for x, sub in _cascade_batches(task, dev, 100)]
                runs["accuracy"] = {k: float(np.mean([a[k] for a in accs]))
                                    for k in accs[0]}
            eng.shutdown()

    counts = _counted("cascade_pipelined", drive, ["flash_attention_cascade"])
    (pipe, wall, st, frac), (seq, swall, sst, _) = (runs["pipelined"],
                                                     runs["sequential"])
    pipe3, wall3, st3, frac3 = runs["pipelined3"]
    for i, (a, b, c) in enumerate(zip(pipe, seq, pipe3)):
        if not (a["super"] == b["super"] == c["super"]
                and np.array_equal(a["sub"], b["sub"])
                and np.array_equal(c["sub"], b["sub"])):
            raise AssertionError(f"cascade_pipelined: batch {i} differs "
                                 "from the sequential cascade's")
    log("cascade_pipelined " + json.dumps({
        "batches": len(pipe), "equal_to_sequential": len(pipe) == len(seq),
        "wall_s": wall, "loads": st["loads"],
        "load_seconds": st["load_seconds"],
        "hidden_load_seconds": st["hidden_load_seconds"],
        "hidden_load_fraction": frac, "context_changes":
            st["context_changes"], "sequential_wall_s": swall,
        "sequential_loads": sst["loads"], "three_slots": {
            "wall_s": wall3, "loads": st3["loads"],
            "load_seconds": st3["load_seconds"],
            "hidden_load_seconds": st3["hidden_load_seconds"],
            "hidden_load_fraction": frac3},
        "superclasses": [r["super"] for r in pipe],
        **runs["accuracy"]}))
    if (len(pipe) != len(batches) or len(pipe3) != len(batches)
            or not st["hidden_load_seconds"] > 0):
        raise AssertionError(f"cascade_pipelined: {len(pipe)} results, "
                             f"hidden load {st['hidden_load_seconds']} s")
    return counts


def _tiny_host(dev):
    """tinyllama-1.1b at its published width: (model, bf16 weights from
    seed 0 pinned in host memory)."""
    from repro_torch.launch.serve import _to_host
    from repro_torch.models.model import build_model
    m = build_model(_bf16_arch("tinyllama-1.1b"), device=dev)
    return m, _to_host(m.init(seed=0))


def context_delta(dev, tiny) -> dict:
    """Partial reconfiguration at tinyllama-1.1b's width: a base context
    (the backbone and a (2048, 12) head) and a specialist registered with
    ``base=`` whose weights are a head-only delta.  The delta load must
    move exactly the head's bytes, every backbone tensor of its slot
    must be the base slot's (same ``data_ptr``), and its pooled logits
    on an (8, 256) batch must be bitwise those of a full-load twin of the
    same weights.  Logs the delta load's ms beside the full load's."""
    import torch
    from repro_torch.core.cascade import classifier_logits
    from repro_torch.core.context import (ContextDescriptor,
                                          ContextSwitchEngine, _leaves)
    from repro_torch.launch.serve import _to_host
    m, backbone = tiny
    d = m.cfg.d_model
    base_head, head = (_to_host(_head(dev, d, 12, s)) for s in (61, 62))
    x = torch.randint(0, m.cfg.vocab_size, (8, 256), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(63))
    out, ms = {}, {}

    def drive():
        eng = ContextSwitchEngine(num_slots=3, device=dev)

        def apply(p, t):
            return classifier_logits(m, p, t)
        for name, fn, base in (
                ("base", lambda: {"backbone": backbone, "head": base_head},
                 None),
                ("spec", lambda: {"head": head}, "base"),
                ("full", lambda: {"backbone": backbone, "head": head},
                 None)):
            eng.register(ContextDescriptor(name, apply, fn, base=base))
        for name in ("base", "spec", "full"):
            b0 = eng.stats["bytes_loaded"]
            t0 = time.perf_counter()
            slot = eng.preload(name, block=True).result()
            ms[name] = 1e3 * (time.perf_counter() - t0)
            ms[name + "_bytes"] = eng.stats["bytes_loaded"] - b0
            if name == "spec":
                base = eng._find_slot("base").buffers["backbone"]
                shared = [a.data_ptr() == b.data_ptr() for a, b in zip(
                    _leaves(slot.buffers["backbone"]), _leaves(base))]
                if not (shared and all(shared)):
                    raise AssertionError(
                        f"context_delta: {shared.count(False)} backbone "
                        "tensors of the delta slot are not the base's")
                ms["shared_tensors"] = len(shared)
        for name in ("spec", "full"):
            eng.switch(name)
            out[name] = eng.run(x)
        eng.shutdown()

    counts = _counted("context_delta", drive, ["flash_attention"])
    log("context_delta " + json.dumps({
        "delta_load_ms": ms["spec"], "full_load_ms": ms["full"],
        "base_load_ms": ms["base"], "delta_bytes": ms["spec_bytes"],
        "head_bytes": head.nbytes, "full_bytes": ms["full_bytes"],
        "backbone_tensors_shared": ms["shared_tensors"],
        "logits_bitwise_full_load": torch.equal(out["spec"],
                                                out["full"])}))
    if ms["spec_bytes"] != head.nbytes:
        raise AssertionError(f"context_delta: the delta moved "
                             f"{ms['spec_bytes']} bytes, the head is "
                             f"{head.nbytes}")
    if not torch.equal(out["spec"], out["full"]):
        raise AssertionError("context_delta: the delta context's logits "
                             "differ from the full load's")
    return counts


# the order of each (dynamic, conventional) pair of live schedule runs
LIVE_ORDERS = ((True, False), (False, True), (True, False))


def schedule_live(dev, tiny) -> dict:
    """The paper's reconfiguration case studies, live: ``forward`` of
    tinyllama-1.1b, supersub-super and supersub-sub (published widths)
    on one (8, 256) batch, three contexts on two slots.  Each context's
    load and run is timed (median of 3); then ``run_schedule_live``
    drives case 2 (tinyllama-1.1b and supersub-super alternating x3,
    both preloaded) and case 3 (the three nets cycled twice, the two
    small ones run R times, R about tinyllama's load over a run of
    supersub-sub), each ``dynamic=True`` against ``dynamic=False`` in
    three pairs of alternating order (``LIVE_ORDERS``): the runs are
    host-bound and a single pair's totals differ by about as much as
    case 3 can save.  Dynamic's median total must be below
    conventional's in both cases; every run's total is logged, and the
    simulators' savings from the measured times beside the measured
    ones (of the median runs)."""
    import math
    import statistics
    import torch
    from repro_torch.core.context import ContextDescriptor, ContextSwitchEngine
    from repro_torch.core.scheduler import (Run, run_schedule_live,
                                            simulate_conventional,
                                            simulate_dynamic,
                                            simulate_preloaded, time_saving)
    from repro_torch.launch.serve import _to_host
    from repro_torch.models.model import build_model
    nets = {"tinyllama-1.1b": tiny}
    for i, name in enumerate(("supersub-super", "supersub-sub")):
        m = build_model(_bf16_arch(name), device=dev)
        nets[name] = (m, _to_host(m.init(seed=71 + i)))
    x = torch.randint(0, 512, (8, 256), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(72))
    inputs = {n: (x,) for n in nets}
    res = {}

    def engine():
        eng = ContextSwitchEngine(num_slots=2, device=dev)
        for n, (m, host) in nets.items():
            eng.register(ContextDescriptor(
                n, lambda p, t, m=m: m.forward(p, t), lambda h=host: h))
        return eng

    def drive():
        eng = engine()
        loads, execs = {}, {}
        for n in nets:
            lt, et = [], []
            for _ in range(3):
                eng.deactivate()
                eng.evict(n)
                t0 = time.perf_counter()
                eng.preload(n, block=True)
                lt.append(time.perf_counter() - t0)
                eng.switch(n)
                eng.run(x)                          # warm
                t0 = time.perf_counter()
                eng.run(x)
                et.append(time.perf_counter() - t0)
            loads[n], execs[n] = statistics.median(lt), statistics.median(et)
        eng.shutdown()
        tiny_n, a, b = list(nets)
        reps = max(1, min(50, math.ceil(loads[tiny_n] / execs[b])))
        cases = {
            "case2": [Run(tiny_n, execs[tiny_n]), Run(a, execs[a])] * 3,
            "case3": [Run(tiny_n, execs[tiny_n]), Run(a, execs[a], reps),
                      Run(b, execs[b], reps)] * 2}
        for case, sched in cases.items():
            runs = {True: [], False: []}
            for order in LIVE_ORDERS:             # pairs, alternating
                for dynamic in order:
                    eng = engine()
                    if dynamic and case == "case2":  # preloaded, off clock
                        for n in (tiny_n, a):
                            eng.preload(n, block=True)
                    r = run_schedule_live(eng, sched, inputs,
                                          dynamic=dynamic)
                    runs[dynamic].append({**r, "loads": eng.stats["loads"]})
                    eng.shutdown()
            # each mode's run of median total
            out = {d: sorted(rs, key=lambda r: r["total"])[len(rs) // 2]
                   for d, rs in runs.items()}
            conv = simulate_conventional(sched, loads)
            ours = (simulate_preloaded(sched, loads) if case == "case2"
                    else simulate_dynamic(sched, loads, num_slots=2))
            res[case] = {
                "schedule": [(r.net, r.repeat) for r in sched],
                "dynamic_s": out[True]["total"],
                "conventional_s": out[False]["total"],
                "dynamic_visible_stalls_s": out[True]["visible_stalls"],
                "conventional_visible_stalls_s":
                    out[False]["visible_stalls"],
                "dynamic_runs_s": [r["total"] for r in runs[True]],
                "conventional_runs_s": [r["total"] for r in runs[False]],
                "loads_dynamic": out[True]["loads"],
                "loads_conventional": out[False]["loads"],
                "measured_saving": time_saving(out[False]["total"],
                                               out[True]["total"]),
                "predicted_saving": time_saving(conv, ours),
                "predicted_dynamic_s": ours,
                "predicted_conventional_s": conv}
        res["load_s"], res["exec_s"] = loads, execs

    counts = _counted("schedule_live", drive, ["flash_attention"])
    log("schedule_live " + json.dumps(res))
    for case in ("case2", "case3"):
        r = res[case]
        if not r["dynamic_s"] < r["conventional_s"]:
            raise AssertionError(
                f"schedule_live {case}: dynamic {r['dynamic_s']} s is not "
                f"below conventional {r['conventional_s']} s")
    return counts


def supersub_phase(dev) -> dict:
    """Phase 6: the cascade's reference check, then the counted passes
    (``cascade_pipelined``, ``context_delta``, ``schedule_live``); ->
    their launch counts, summed."""
    task = _cascade_task()
    cascade_reference(dev, task)
    tiny = _tiny_host(dev)
    totals = cascade_pipelined(dev, task)
    for more in (context_delta(dev, tiny), schedule_live(dev, tiny)):
        for n in totals:
            totals[n] += more[n]
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import kernels

    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernel build seconds: {time.perf_counter() - t0:.2f}")
    sass_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    records = kernel_phase(dev)
    reference_phase(dev)
    moe_hybrid_reference(dev)
    xlstm_reference(dev)
    int8_drift(dev)
    spec_reference(dev)
    totals = serving_phase(dev)
    profile_phase(dev)
    t0 = time.perf_counter()
    for n, c in supersub_phase(dev).items():
        totals[n] += c
    log(f"supersub phase seconds: {time.perf_counter() - t0:.1f}")
    for rec in records:
        rec["launches"] = totals[rec["name"]]
        if rec["name"] in ROUTE_BODY:
            rec["body_launches"] = totals[ROUTE_BODY[rec["name"]]]
    log(f"chip_smoke total seconds: {time.perf_counter() - start:.1f}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
