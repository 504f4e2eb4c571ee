"""Training loop of the port: loss, train-step factory, ``Trainer``.

The JAX package's ``train/trainer.py`` for one device:
  * microbatch gradient accumulation (a loop; each microbatch's gradient
    added in f32, over ``A``, as JAX's scan does)
  * remat: each layer under ``torch.utils.checkpoint`` (``LM._run``)
  * chunked cross-entropy: each chunk's head matmul and log-sum-exp under
    ``torch.utils.checkpoint``, recomputed in the backward pass, so the
    (B, S, V) f32 logits are never kept
  * mixed precision: f32 master parameters, bf16 activations (the model
    casts at use; ``cast_bf16`` casts every f32 parameter first)
  * fault tolerance: ``CheckpointManager`` auto-resume, the data cursor
    in the checkpoint, a stateless data source

On the card attention differentiates through the flash kernel's backward
(``kernels/flash_attention``), the Mamba layers through the selective
scan's (``kernels/ssm_scan``) and the mLSTM layers through the chunkwise
mLSTM's (``kernels/mlstm_chunk``); the MoE layers of a model without a
mesh run the dense reference, plain matmuls.  So the dense, MoE, hybrid
and xLSTM families train on one card.  The grouped matmul that a meshed
model's MoE layers run has no backward yet: on the card
``make_train_step`` refuses such a model before the first step
(``MissingBackwardKernel``); on the CPU every family trains, through the
plain versions, as in JAX.  ``Trainer`` donates the state
to each step, as JAX's jitted step does (``make_train_step(donate=
True)``: parameters and moments updated in place).  The int8
error-feedback compression across a ``pod`` axis and the sharded state
need several cards: asking for them raises
``MultiCardTrainingNotPorted``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import RunConfig
from repro_torch.core.context import tree_leaves, tree_map
from repro_torch.kernels import MissingBackwardKernel
from repro_torch.models.model import LM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         make_schedule)


class MultiCardTrainingNotPorted(NotImplementedError):
    """A training feature that needs several cards (ROADMAP §A item 6)."""



# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """logits (..., V) f32, labels (...) int; mean over unmasked."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_loss(h, head_w, y, m):
    logits = (h @ head_w.to(h.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    m = m.float()
    return ((logz - gold) * m).sum(), m.sum()


def chunked_lm_loss(hidden, head_w, labels, mask, chunk: int = 1024):
    """CE over the vocab without keeping full logits.

    hidden: (B, S, D); head_w: (D, V); labels/mask: (B, S).  Each chunk's
    head matmul and log-sum-exp are recomputed in the backward pass."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:            # fall back: irregular lengths (tests)
        logits = (hidden @ head_w.to(hidden.dtype)).float()
        return softmax_xent(logits, labels, mask)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        s, c = torch.utils.checkpoint.checkpoint(
            _chunk_loss, hidden[:, i:i + chunk], head_w,
            labels[:, i:i + chunk], mask[:, i:i + chunk],
            use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss_fn(model: LM, params, batch, run_cfg: RunConfig,
               chunked: bool | None = None):
    """Next-token loss -> (ce + moe weight x aux, {"ce", "aux"})."""
    cfg = model.cfg
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    if batch.get("patch_embeds") is not None:
        raise NotImplementedError("modality frontends are not yet ported "
                                  "to repro_torch")
    remat = run_cfg.parallel.remat != "none"
    labels = tokens[:, 1:]
    if chunked is None:
        chunked = cfg.vocab_size >= 32_000
    hidden, aux = model.hidden(params, tokens, remat=remat)
    h = hidden[:, :-1]                  # predict token t+1 from hidden t
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    head_w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if chunked:
        ce = chunked_lm_loss(h, head_w, labels, mask)
    else:
        logits = (h @ head_w.to(h.dtype)).float()
        ce = softmax_xent(logits, labels, mask)
    moe_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return ce + moe_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# train step factory
# ---------------------------------------------------------------------------

def value_and_grad(fn, params):
    """``fn(params) -> (loss, metrics dict)`` and the gradient of the loss
    with respect to every leaf of ``params`` -> (loss, metrics, grads),
    all detached; grads has params' structure (a leaf the loss does not
    reach gets zeros, as in JAX).  ``params`` is left as it was."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    with torch.enable_grad():
        loss, m = fn(tree_map(lambda _: next(it), params))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in m.items()},
            tree_map(lambda _: next(it), params))


def normal_init(params, seed: int, std: float):
    """``params`` with every matrix (a leaf of two or more dimensions)
    redrawn from N(0, std) (a ``torch.Generator`` from ``seed`` on its
    device, in its dtype); the norm scales (vectors) are kept."""
    leaves = tree_leaves(params)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)

    def draw(p):
        if p.dim() < 2:
            return p
        return (std * torch.randn(p.shape, generator=gen, device=p.device,
                                  dtype=torch.float32)).to(p.dtype)
    return tree_map(draw, params)


def init_state(model: LM, seed: int, run_cfg: RunConfig,
               init_std: float | None = None) -> dict:
    """Parameters from ``seed`` on the model's device, a fresh AdamW state
    and step 0 (an int32 tensor).  The parameters are the model's own
    init (the JAX package's stds), or with ``init_std`` every matrix
    drawn from N(0, init_std) (``normal_init``: llama's published recipe
    is 0.02 everywhere)."""
    params = model.init(seed)
    if init_std is not None:
        params = normal_init(params, seed, init_std)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if run_cfg.parallel.grad_compression == "int8_ef":
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def check_trainable(model: LM, run_cfg: RunConfig) -> None:
    """Raise before any step what this run cannot do: a meshed model's
    MoE layers, whose kernel has no backward on the card
    (``MissingBackwardKernel``), or a multi-card feature
    (``MultiCardTrainingNotPorted``)."""
    pcfg = run_cfg.parallel
    if pcfg.grad_compression == "int8_ef" and pcfg.pods > 1:
        raise MultiCardTrainingNotPorted(
            "int8 error-feedback gradient compression across a pod axis "
            f"(pods={pcfg.pods}) needs several cards: not yet ported to "
            "repro_torch (ROADMAP §A item 6)")
    if max(pcfg.dp, pcfg.tp, pcfg.pods) > 1:
        raise MultiCardTrainingNotPorted(
            f"data/tensor/pod parallel training (dp={pcfg.dp}, "
            f"tp={pcfg.tp}, pods={pcfg.pods}) needs several cards: not "
            "yet ported to repro_torch (ROADMAP §A item 6)")
    if model.device.type != "cuda":
        return
    cfg = model.cfg
    if model.mesh is not None and any(
            model.kind(i)[1] == "moe" for i in range(cfg.num_layers)):
        raise MissingBackwardKernel(
            f"{cfg.name}: under a mesh its MoE layers run expert-parallel "
            "through gmm (B7), whose backward kernel is not ported yet; "
            "train it on one card without a mesh, where they run the "
            "dense reference (ROADMAP §A item 6)")


def make_train_step(model: LM, run_cfg: RunConfig,
                    donate: bool = False) -> Callable:
    """-> ``train_step(state, batch) -> (new state, metrics)``: the
    gradient of ``lm_loss_fn`` over ``microbatches`` slices of the batch,
    then one ``adamw_update``.  Functional, as JAX's: the input state is
    left as it was; with ``donate`` (JAX's ``donate_argnums``) the input
    state's parameters and moments are updated in place and belong to
    the new state, the same numbers in the memory of one state.  Metrics:
    loss, ce, aux (the last microbatch's), grad_norm, lr, as () tensors
    on the device."""
    check_trainable(model, run_cfg)
    pcfg = run_cfg.parallel
    ocfg = run_cfg.optimizer
    sched = make_schedule(ocfg)

    def loss_and_grads(params, mb):
        def loss_fn(p):
            if pcfg.cast_bf16:
                p = tree_map(lambda t: t.to(torch.bfloat16)
                             if t.dtype == torch.float32 else t, p)
            return lm_loss_fn(model, p, mb, run_cfg)
        return value_and_grad(loss_fn, params)

    def accum_grads(params, batch):
        A = pcfg.microbatches
        if A <= 1:
            return loss_and_grads(params, batch)
        n = batch["tokens"].shape[0]
        if n % A:
            raise ValueError(f"batch {n} is not a multiple of "
                             f"microbatches {A}")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        ltot = 0.0
        for i in range(A):
            mb = {k: v[i * (n // A):(i + 1) * (n // A)]
                  for k, v in batch.items()}
            loss, m, grads = loss_and_grads(params, mb)
            acc = tree_map(lambda a, g: a + g.float() / A, acc, grads)
            ltot = ltot + loss / A
        return ltot, m, acc

    def train_step(state, batch):
        loss, m, grads = accum_grads(state["params"], batch)
        new_p, new_opt, om = adamw_update(grads, state["opt"],
                                          state["params"], ocfg, sched,
                                          donate=donate)
        out = {"params": new_p, "opt": new_opt, "step": state["step"] + 1}
        if "ef" in state:
            out["ef"] = state["ef"]
        return out, {"loss": loss, **m, **om}
    return train_step


# ---------------------------------------------------------------------------
# Trainer orchestration (checkpoint/restart, logging, stragglers)
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """Thin holder for the live state dict + bookkeeping."""
    state: dict
    step: int = 0


class Trainer:
    """Steps a state over ``data.batch_at(i)``, logs every ``log_every``
    steps (``metrics_log``: loss, ce, aux, grad_norm, lr, step,
    sec_per_step) and checkpoints every ``checkpoint_every`` steps and at
    the end (JAX's saves the last step twice when it falls on a
    checkpoint step; the port once), unless ``train(checkpoint=False)``;
    ``init_or_restore`` resumes from the newest valid checkpoint.  Each
    step takes the state donated, as JAX's jitted step does: the state
    passed to ``train`` is updated in place.
    Refuses before any step what ``check_trainable`` refuses."""

    def __init__(self, model: LM, run_cfg: RunConfig, data):
        self.model = model
        self.run_cfg = run_cfg
        self.data = data
        self.ckpt = CheckpointManager(run_cfg.checkpoint_dir,
                                      keep=run_cfg.keep_checkpoints)
        self.metrics_log: list[dict] = []
        self.start_step = 0
        self._step = make_train_step(model, run_cfg, donate=True)

    def init_or_restore(self, seed: int,
                        init_std: float | None = None) -> dict:
        state = init_state(self.model, seed, self.run_cfg, init_std)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, extra = self.ckpt.restore(like=state)
            self.start_step = int(extra.get("step", latest))
        else:
            self.start_step = 0
        return state

    def train(self, state: dict, steps: int, log_cb: Callable | None = None,
              checkpoint: bool = True):
        rc = self.run_cfg
        dev = self.model.device
        t0 = time.perf_counter()
        step = self.start_step
        for i in range(step, step + steps):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in self.data.batch_at(i).items()}
            state, metrics = self._step(state, batch)
            if (i + 1) % rc.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["sec_per_step"] = (time.perf_counter() - t0) / (i + 1 - step)
                self.metrics_log.append(m)
                if log_cb:
                    log_cb(m)
            if checkpoint and (i + 1) % rc.checkpoint_every == 0:
                self.ckpt.save(i + 1, state, extra={"step": i + 1,
                                                    "cursor": i + 1})
        end = step + steps
        if checkpoint and steps and end % rc.checkpoint_every:  # else above
            self.ckpt.save(end, state, extra={"step": end, "cursor": end})
        self.ckpt.wait()
        return state


__all__ = ["MultiCardTrainingNotPorted", "TrainState", "Trainer",
           "check_trainable", "chunked_lm_loss", "init_state",
           "normal_init",
           "lm_loss_fn", "make_train_step", "softmax_xent",
           "value_and_grad"]
