#!/usr/bin/env python3
"""Times of the port's kernels on one card, at the shapes of
``chip_smoke.py``'s records (the same inputs and calls), for the port tree
given, so that two trees can be held side by side in one run on one card:

    python3 tools/kernel_times.py --records decode|scan [--src DIR]
                                  [--label NAME]

``--records decode`` times the one-token decode records
(``decode_cases``), ``--records scan`` the selective-scan and
chunkwise-mLSTM records (``scan_cases`` and ``mlstm_cases``).  ``--src``
is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's).  Prints one JSON line: the card's name and power limit, the
label, and for each record its profiler kernel time (``kernel_ms``, every
kernel of one call summed), its CUDA-event time (``events_ms``), each a
mean over calls that start from a flushed L2, and the warps each kernel
of one call launched (``warps``, its grid times its block from the
profiler's trace); a decode record adds SDPA's kernel time over the same
keys and mask (``sdpa_kernel_ms``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
        name = e["name"].replace("(anonymous namespace)::", "")
        name = re.split(r"[(<]", name.removeprefix("void "))[0]
        n = math.prod(a["grid"]) * -(-math.prod(a["block"]) // 32)
        warps[name] = warps.get(name, 0) + n
    return warps


def cases(records: str, cs, dev, gen) -> dict:
    """Record name -> (the port's call, SDPA's call or None)."""
    import torch
    if records == "decode":
        def rn(*shape):
            return torch.randn(shape, generator=gen,
                               device=dev).to(torch.bfloat16)
        return {name: (c["fn"], c["sdpa"])
                for name, c in cs.decode_cases(dev, gen, rn).items()}
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    calls = {name: (lambda a=c[0]: ssm_scan(*a), None)
             for name, c in cs.scan_cases(dev, gen).items()}
    calls.update({name: (lambda a=a: mlstm_chunk(*a, chunk=cs.MLSTM_C), None)
                  for name, a in cs.mlstm_cases(dev, gen).items()})
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", choices=("decode", "scan"), required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
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
    out = {}
    for name, (fn, sdpa) in cases(args.records, cs, dev, gen).items():
        fn()
        torch.cuda.synchronize()
        out[name] = {"kernel_ms": cs.device_ms(fn, iters=20, flush=flush),
                     "events_ms": cs.time_ms(fn, flush=flush),
                     "warps": launch_warps(fn)}
        if sdpa is not None:
            out[name]["sdpa_kernel_ms"] = cs.device_ms(sdpa, iters=20,
                                                       flush=flush)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "label": args.label, "records": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
