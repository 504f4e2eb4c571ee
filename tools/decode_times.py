#!/usr/bin/env python3
"""Times of the port's one-token decode kernels on one card, at the shapes
of ``chip_smoke.py``'s decode records (its ``decode_cases``, the same
inputs and calls), for the port tree given, so that two trees can be held
side by side in one run on one card:

    python3 tools/decode_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's).  Prints one JSON line: the card's name and power limit,
the label, and for each record its profiler kernel time (``kernel_ms``),
its CUDA-event time (``events_ms``) and SDPA's kernel time over the same
keys and mask (``sdpa_kernel_ms``), each a mean over launches that start
from a flushed L2.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs          # the cases and timing helpers
    sys.path.insert(0, str(Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("decode_times: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kernels.build_all()
    out = {}
    for name, c in cs.decode_cases(dev, gen, rn).items():
        c["fn"]()
        torch.cuda.synchronize()
        out[name] = {"kernel_ms": cs.device_ms(c["fn"], iters=20,
                                               flush=flush),
                     "events_ms": cs.time_ms(c["fn"], flush=flush),
                     "sdpa_kernel_ms": cs.device_ms(c["sdpa"], iters=20,
                                                    flush=flush)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "label": args.label, "records": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
