#!/usr/bin/env python3
"""Times of the port's kernels on one card, at the shapes of
``chip_smoke.py``'s records (the same inputs and calls), for the port tree
given, so that two trees can be held side by side in one run on one card:

    python3 tools/kernel_times.py
        --records decode|scan|backward|scan_backward|mlstm_backward
        [--src DIR] [--label NAME]
    python3 tools/kernel_times.py --ptxas KERNEL [--src DIR]

``--records decode`` times the one-token decode records
(``decode_cases``), ``--records scan`` the selective-scan and
chunkwise-mLSTM records (``scan_cases`` and ``mlstm_cases``),
``--records backward`` B1's backward records (``BWD_SHAPES``, through
``backward_case``), ``--records scan_backward`` B8's backward records
(``SCAN_BWD_SHAPES``, through ``scan_bwd_inputs``) as the training step
calls them: the backward (from the forward's checkpoints where the tree's
forward saves them) and, as ``<record>_forward``, the forward that
precedes it (with its checkpoint output where the tree has one), plus a
digest of the serving forward's y and final state (``serving_digest``,
the same in two trees whose serving bits agree); ``--records
mlstm_backward`` B9's backward records (``MLSTM_BWD_SHAPES``, through
``mlstm_bwd_call``: the backward alone on a graph kept from one
forward).  ``--src``
is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's).  Prints one JSON line: the card's name and power limit, the
label, and for each record its profiler kernel time (``kernel_ms``, every
kernel of one call summed), its CUDA-event time (``events_ms``), each a
mean over calls that start from a flushed L2, its host time (``host_ms``,
calls enqueued back to back), and the warps each kernel
of one call launched (``warps``, its grid times its block from the
profiler's trace) and its kernel time by kernel (``kernel_ms_by_name``);
a decode or backward record adds SDPA's time over the same keys and mask,
by the profiler (``sdpa_kernel_ms``) and by events (``sdpa_events_ms``).
Needs a CUDA card.  ``--ptxas``
compiles one kernel library's source as the port builds it, with
``-Xptxas -v``, and prints each entry function's registers and spill
bytes (needs ``nvcc``, no card).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def short_name(kernel: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name.removeprefix("void "))[0]


def kernel_ms_by_name(cs, fn, flush, iters: int = 20) -> dict:
    """Kernel name -> mean device ms of one ``fn()`` call (the profiler's
    kernel time, as ``chip_smoke.device_ms``, split by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    per = {}
    for _ in range(iters):
        flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for name, us in cs.kernel_us(prof).items():
            key = short_name(name)
            per[key] = per.get(key, 0.0) + us / iters / 1e3
    return per


def host_ms(fn, iters: int = 200) -> float:
    """Mean host time of one ``fn()`` call, ms: ``iters`` calls enqueued
    back to back with no synchronize between them (the wrapper's Python
    and C work and the launches' enqueue; 200 calls stay within the
    launch queue, so the card does not hold the host back)."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def ptxas_report(kernel: str) -> dict:
    """Entry function -> registers and spill bytes of ``kernel``'s library
    source, compiled with the port's flags and ``-Xptxas -v``."""
    from repro_torch.kernels import _build
    src = _build._PKG / _build.SOURCES[kernel]
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", str(Path(tmp) / "k.so"), str(src)],
                           capture_output=True, text=True, check=True)
    out, entry = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            if shutil.which("c++filt"):
                entry = subprocess.run(["c++filt", entry],
                                       capture_output=True, text=True
                                       ).stdout.strip() or entry
            entry = entry.replace("(anonymous namespace)::", "")
            entry = re.sub(r"\(.*\)$", "", entry.removeprefix("void "))
            out[entry] = {}
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[entry]["spill_stores"] = int(m.group(1))
                out[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[entry]["registers"] = int(m.group(1))
    return out


def launch_warps(fn) -> dict:
    """Kernel name -> warps launched by one ``fn()`` call, summed over its
    launches of that kernel, read from the grid and block that
    ``torch.profiler``'s trace records for each launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    warps = {}
    for e in events:
        a = e.get("args", {})
        if e.get("cat") != "kernel" or "grid" not in a or "block" not in a:
            continue
        name = short_name(e["name"])
        n = math.prod(a["grid"]) * -(-math.prod(a["block"]) // 32)
        warps[name] = warps.get(name, 0) + n
    return warps


def scan_backward_cases(cs, dev, gen) -> tuple:
    """B8's backward records as the tree's training step calls them: record
    name -> (call, None), and -> the serving forward's call."""
    import functools

    from repro_torch.kernels.ssm_scan import ops
    calls, serving = {}, {}
    for name, shape in cs.SCAN_BWD_SHAPES.items():
        args = cs.scan_bwd_inputs(dev, gen, shape)
        fwd = args[:7]
        if hasattr(ops, "ssm_scan_checkpointed"):   # the forward saves them
            ck = ops.ssm_scan_checkpointed(*fwd)[2]
            calls[name] = (functools.partial(ops.ssm_scan_backward, *args,
                                             checkpoints=ck), None)
            calls[name + "_forward"] = (
                functools.partial(ops.ssm_scan_checkpointed, *fwd), None)
        else:                                       # the backward makes them
            calls[name] = (functools.partial(ops.ssm_scan_backward, *args),
                           None)
            calls[name + "_forward"] = (functools.partial(ops.ssm_scan, *fwd),
                                        None)
        serving[name] = functools.partial(ops.ssm_scan, *fwd)
    return calls, serving


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def cases(records: str, cs, dev, gen) -> dict:
    """Record name -> (the port's call, SDPA's call or None)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    if records == "decode":
        return {name: (c["fn"], c["sdpa"])
                for name, c in cs.decode_cases(dev, gen, rn).items()}
    if records == "backward":
        calls = {}
        for name, shape in cs.BWD_SHAPES.items():
            c = cs.backward_case(dev, rn, shape)
            calls[name] = (c["fn"], c["sdpa"])
        return calls
    if records == "mlstm_backward":
        return {name: (cs.mlstm_bwd_call(cs.mlstm_bwd_inputs(dev, gen, shape),
                                         shape[4]), None)
                for name, shape in cs.MLSTM_BWD_SHAPES.items()}
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    calls = {name: (lambda a=c[0]: ssm_scan(*a), None)
             for name, c in cs.scan_cases(dev, gen).items()}
    calls.update({name: (lambda a=a: mlstm_chunk(*a, chunk=cs.MLSTM_C), None)
                  for name, a in cs.mlstm_cases(dev, gen).items()})
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records",
                    choices=("decode", "scan", "backward", "scan_backward",
                             "mlstm_backward"))
    ap.add_argument("--ptxas", metavar="KERNEL")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if (args.records is None) == (args.ptxas is None):
        ap.error("give one of --records and --ptxas")
    sys.path.insert(0, str(ROOT))
    if args.ptxas:
        sys.path.insert(0, str(Path(args.src).resolve()))
        print(json.dumps({"kernel": args.ptxas,
                          "entries": ptxas_report(args.ptxas)}), flush=True)
        return 0
    import torch

    import chip_smoke as cs          # the cases and timing helpers
    sys.path.insert(0, str(Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    kernels.build_all()
    out, serving = {}, {}
    if args.records == "scan_backward":
        calls, serving = scan_backward_cases(cs, dev, gen)
    else:
        calls = cases(args.records, cs, dev, gen)
    for name, (fn, sdpa) in calls.items():
        fn()
        torch.cuda.synchronize()
        by_name = kernel_ms_by_name(cs, fn, flush)
        out[name] = {"kernel_ms": sum(by_name.values()) or "not measured",
                     "kernel_ms_by_name": by_name,
                     "events_ms": cs.time_ms(fn, flush=flush),
                     "host_ms": host_ms(fn),
                     "warps": launch_warps(fn)}
        if sdpa is not None:
            out[name]["sdpa_kernel_ms"] = cs.device_ms(sdpa, iters=20,
                                                       flush=flush)
            out[name]["sdpa_events_ms"] = cs.time_ms(sdpa, flush=flush)
    for name, fn in serving.items():
        with torch.no_grad():
            out[name]["serving_digest"] = digest(fn())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "label": args.label, "records": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
