#!/usr/bin/env python3
"""B8's backward kernel (``ssm_scan_bwd.cu``) built at other block widths
and cluster sizes, each timed at ``chip_smoke.py``'s first
``SCAN_BWD_SHAPES`` record (jamba-v0.1-52b's training shape) from the
forward's checkpoints, on one card:

    python3 tools/scan_bwd_variant_times.py [--threads 128,256]
                                            [--clusters 1,2,4,8]

Each variant is the source with its ``THREADS`` (and the launch bound
that keeps 128 registers a thread) and ``MAX_CLUSTER`` replaced, built
with the port's ``nvcc`` flags and ``-Xptxas -v`` into
``build/scan_bwd_variants/`` and loaded with ``ctypes``.  Prints one
JSON line: the card's name and power limit, and for each variant its
registers and spill bytes (the N = 16 instantiation), the worst error
over ``chip_smoke.SCAN_BWD_RTOL`` against the plain backward (outputs
filled with NaN first), and its CUDA-event and profiler kernel times
(each call from a flushed L2, as ``chip_smoke.time_ms`` and
``device_ms`` take them).  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu"
OUT = ROOT / "build" / "scan_bwd_variants"


def variant(src: str, threads: int, cluster: int) -> str:
    """The source at ``threads`` a block (2 blocks an SM at 256, 4 at 128:
    128 registers a thread either way) and clusters of ``cluster``."""
    for pat, new in ((r"constexpr int THREADS = \d+;",
                      f"constexpr int THREADS = {threads};"),
                     (r"constexpr int MAX_CLUSTER = \d+;",
                      f"constexpr int MAX_CLUSTER = {cluster};"),
                     (r"__launch_bounds__\(THREADS, \d+\)",
                      f"__launch_bounds__(THREADS, {512 // threads})")):
        src, n = re.subn(pat, new, src)
        if n != 1:
            raise RuntimeError(f"{pat!r} is not in {SRC.name} once")
    return src


def registers(ptxas: str) -> tuple:
    """(registers, spill store bytes) of the N = 16 kernel."""
    for part in ptxas.split("Compiling entry function")[1:]:
        if "ssm_scan_bwd_kernelILi16E" in part.split("\n")[0]:
            r = re.search(r"Used (\d+) registers", part)
            sp = re.search(r"(\d+) bytes spill stores", part)
            return (int(r.group(1)) if r else None,
                    int(sp.group(1)) if sp else None)
    return None, None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="128,256")
    ap.add_argument("--clusters", default="1,2,4,8")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops
    if not torch.cuda.is_available():
        print("scan_bwd_variant_times: no CUDA device is visible",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    jobs = {}
    for t in (int(x) for x in args.threads.split(",")):
        for c in (int(x) for x in args.clusters.split(",")):
            name = f"threads{t}_cluster{c}"
            cu = OUT / f"{name}.cu"
            cu.write_text(variant(src, t, c))
            jobs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(OUT / f"{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, job in jobs.items():
        text = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"{name} did not build:\n{text[-3000:]}")
        built[name] = registers(text)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = cs.SCAN_BWD_SHAPES["ssm_scan_backward"]
    B, L, d_in, N = shape[:4]
    a = cs.scan_bwd_inputs(dev, gen, shape)
    ref = ops.selective_scan_backward_reference(*a)
    ck = ops.ssm_scan_checkpointed(*a[:7])[2]
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    for name, (regs, spill) in built.items():
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        ws_fn = lib.ssm_scan_bwd_workspace
        ws_fn.argtypes, ws_fn.restype = [I] * 4, ctypes.c_longlong
        fn = lib.ssm_scan_bwd_f32
        fn.argtypes = [P] * 17 + [I] * 4 + [ctypes.c_longlong, P]
        fn.restype = I
        n_ws = ws_fn(B, L, d_in, N)
        ws = torch.empty(n_ws, device=dev)
        u, dt, Bm, Cm, A, D, _, dy, ds = a
        grads = [torch.full_like(t, float("nan"))
                 for t in (u, u, Bm, Cm, A, D, ref[6])]

        def call():
            rc = fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), A.data_ptr(), D.data_ptr(), ck.data_ptr(),
                    dy.data_ptr(), None if ds is None else ds.data_ptr(),
                    ws.data_ptr(), *(g.data_ptr() for g in grads), B, L,
                    d_in, N, n_ws, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError {rc}")
        call()
        torch.cuda.synchronize()
        out[name] = {"registers": regs, "spill_bytes": spill,
                     "worst_error_over_limit": cs.scan_bwd_ratio(grads, ref),
                     "events_ms": cs.time_ms(call, flush=l2.zero_),
                     "kernel_ms": cs.device_ms(call, iters=10,
                                               flush=l2.zero_)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "shape": [B, L, d_in, N],
                      "variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
