#!/usr/bin/env python3
"""Where the live reconfiguration schedule's time goes, on one card: the
schedules of ``chip_smoke.py``'s ``schedule_live`` (built by
``chip_smoke.live_setup``) driven by ``run_schedule_live``, dynamic
against conventional in alternating pairs, with the engine's tracer on:

    python3 tools/live_schedule_times.py [--pairs 20] [--cases case2,case3]
                                         [--check-pairs 5,15,25]

Prints one JSON line: the card's name and power limit, each context's
load and run time (median of 3) and, for each case, every run's total,
each mode's median, the median of the pairs' differences (dynamic less
conventional) and how many pairs dynamic won, and for each step of the
schedule and each mode the mean (over the runs) of its runs' sum, of its
first run and of its later runs (from the ``run:`` spans), and the mean
duration of each of its loads (the ``load:`` spans, in the order they
began), and for each of ``--check-pairs`` the share of 20000 draws of
that many of the measured pairs (with replacement, seed 0) whose dynamic
median is not below the conventional one: how often ``chip_smoke.py``'s
check, on that many pairs, would fail on this card's spread.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _mean(xs):
    return statistics.mean(xs) if xs else None


def _steps(spans, sched) -> list[dict]:
    """The ``run:`` spans of one run, cut into the schedule's steps."""
    runs = sorted((e for e in spans if e["name"].startswith("run:")),
                  key=lambda e: e["t0"])
    out, i = [], 0
    for r in sched:
        d = [e["dur"] for e in runs[i:i + r.repeat]]
        i += r.repeat
        out.append({"sum": sum(d), "first": d[0],
                    "later": _mean(d[1:])})
    return out


def _fail_share(dyn, conv, pairs: int, draws: int = 20000) -> float:
    rng = random.Random(0)
    fails = 0
    for _ in range(draws):
        idx = [rng.randrange(len(dyn)) for _ in range(pairs)]
        if not (statistics.median(dyn[i] for i in idx)
                < statistics.median(conv[i] for i in idx)):
            fails += 1
    return fails / draws


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--cases", default="case2,case3")
    ap.add_argument("--check-pairs", default="5,15,25")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.core.scheduler import run_schedule_live
    from repro_torch.core.telemetry import Telemetry
    if not torch.cuda.is_available():
        print("live_schedule_times: no CUDA device is visible",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    engine, x, loads, execs, cases = cs.live_setup(dev, cs._tiny_host(dev))
    inputs = {n: (x,) for n in loads}
    tiny_n, a = list(loads)[:2]
    report = {"card": smi, "pairs": args.pairs, "load_s": loads,
              "exec_s": execs, "cases": {}}
    for case in args.cases.split(","):
        sched = cases[case]
        totals = {True: [], False: []}
        steps = {True: [], False: []}
        load_ms = {True: [], False: []}
        for p in range(args.pairs):
            for dynamic in ((True, False) if p % 2 == 0 else (False, True)):
                tel = Telemetry(trace=True)
                eng = engine(telemetry=tel)
                if dynamic and case == "case2":      # preloaded, off clock
                    for n in (tiny_n, a):
                        eng.preload(n, block=True)
                    tel.tracer.clear()
                r = run_schedule_live(eng, sched, inputs, dynamic=dynamic)
                eng.shutdown()
                spans = tel.tracer.events()
                totals[dynamic].append(r["total"])
                steps[dynamic].append(_steps(spans, sched))
                load_ms[dynamic].append(
                    [(e["name"][5:], e["dur"] * 1e3) for e in sorted(
                        (e for e in spans if e["name"].startswith("load:")),
                        key=lambda e: e["t0"])])
        diffs = [d - c for d, c in zip(totals[True], totals[False])]
        out = {"schedule": [(r.net, r.repeat) for r in sched],
               "dynamic_s": totals[True], "conventional_s": totals[False],
               "dynamic_median_s": statistics.median(totals[True]),
               "conventional_median_s": statistics.median(totals[False]),
               "paired_diff_median_s": statistics.median(diffs),
               "dynamic_won_pairs": sum(d < 0 for d in diffs),
               "check_fail_share": {
                   n: _fail_share(totals[True], totals[False], int(n))
                   for n in args.check_pairs.split(",")}}
        for dynamic, mode in ((True, "dynamic"), (False, "conventional")):
            out[f"{mode}_steps_ms"] = [
                {k: round(1e3 * _mean([s[i][k] for s in steps[dynamic]]), 3)
                 for k in ("sum", "first", "later")
                 if steps[dynamic][0][i][k] is not None}
                for i in range(len(sched))]
            out[f"{mode}_loads_ms"] = [
                (ls[j][0], round(_mean([l[j][1] for l in load_ms[dynamic]
                                        if len(l) > j]), 3))
                for ls in load_ms[dynamic][:1] for j in range(len(ls))]
        report["cases"][case] = out
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
