"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]``, with the JAX launcher's flags.

Trains on one CUDA card (``cuda:0``) unless ``--device cpu`` is given;
there is no fallback to the CPU.  ``--reduced`` (the default) trains the
smoke-scale variant of the arch, ``--full`` its published widths.  One
JSON line of metrics is printed every ``--log-every`` steps (loss, ce,
aux, grad_norm, lr, step, sec_per_step), checkpoints go to
``--checkpoint-dir`` every ``--checkpoint-every`` steps, and a rerun of
the same command resumes from the directory's newest valid checkpoint
and runs what is left of the ``--steps`` (the JAX launcher runs
``--steps`` more, past its schedule's end, where the learning rate is
0).  ``--dp``
and ``--tp`` other than 1 need several cards and raise
``MultiCardTrainingNotPorted``.  On the card every family trains (the
dense, MoE, hybrid and xLSTM ones: ``--arch xlstm-125m --full`` through
the chunkwise mLSTM's backward kernel).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from repro_torch.configs import get_arch, reduced as make_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig)
from repro_torch.core.context import tree_leaves
from repro_torch.core.env import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=0,
                    help="0 = all devices: one card here")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-std", type=float, default=None,
                    help="draw every weight matrix from N(0, this) (llama's "
                         "published recipe: 0.02) instead of the model's "
                         "own init")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)

    run_cfg = RunConfig(
        arch=cfg.name, shape="custom", seed=args.seed,
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 10, 1)),
        parallel=ParallelConfig(dp=args.dp or 1, tp=args.tp,
                                microbatches=args.microbatches,
                                remat=args.remat),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every)

    model = build_model(cfg, device=dev)
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch,
                           seed=args.seed, device=dev)
    trainer = Trainer(model, run_cfg, data)

    state = trainer.init_or_restore(args.seed, args.init_std)
    n = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n / 1e6:.1f}M device={dev} "
          f"start_step={trainer.start_step}", flush=True)
    t0 = time.perf_counter()
    steps = max(args.steps - trainer.start_step, 0)
    state = trainer.train(state, steps,
                          log_cb=lambda m: print(json.dumps(m), flush=True))
    dt = time.perf_counter() - t0
    toks = steps * args.batch * args.seq
    print(f"done: {steps} steps, {toks / dt:.0f} tok/s, "
          f"final loss {trainer.metrics_log[-1]['loss']:.4f}"
          if trainer.metrics_log else f"done in {dt:.1f}s", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
