"""Fault-tolerant checkpoints of a training state.

The JAX package's ``CheckpointManager`` (step-numbered files
``step_XXXXXXXX.ckpt``, ``keep`` the newest, asynchronous save,
``latest_step``, ``restore`` that skips a corrupt or partial file and
falls back to the previous step) in the port's own file format: the one
``ContextStore`` writes (``core.context.save_tree``: a ``torch.save`` of
the state's tensors keyed by path, a blake2b digest each, the tree's
skeleton, an atomic replace).  The checkpoint's extras (step, data
cursor) go in the same file.  It does not read the JAX package's
msgpack + zstandard files.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

from repro_torch.core.context import load_tree, save_tree, tree_map


class CheckpointManager:
    """Step-numbered checkpoints with retention, async save, auto-resume."""

    STEP_RE = re.compile(r"step_(\d+)\.ckpt$")

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.ckpt")

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            m = self.STEP_RE.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def wait(self):
        """Join the pending save; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any, extra: dict | None = None):
        """Copy the state to host memory now (the caller may go on
        updating its tensors), write the file in the background (or now,
        without ``async_save``), then prune to the ``keep`` newest.  A
        card's tensors go to pinned host memory, all copies in flight at
        once, and the card's stream is waited for once."""
        self.wait()
        cards = set()

        def to_host(t):
            t = t.detach()
            if t.device.type == "cpu":
                return t.clone()
            cards.add(t.device)
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t, non_blocking=True)
        host = tree_map(to_host, state)
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        extra = {"step": step, **(extra or {})}

        def _write():
            try:
                save_tree(self._path(step), host, extra=extra)
                self._prune()
            except BaseException as e:          # re-raised by wait()
                self._error = e
        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self.wait()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def restore(self, like: Any = None, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Restore ``step`` (or the newest *valid* checkpoint) -> (state,
        extra).  Corrupted or partial files are skipped: a crash during a
        save never bricks a run.  With ``like`` (a state of the same
        structure) each leaf takes the shape, dtype and device of
        ``like``'s (a mismatch counts as a bad file); without it the
        leaves stay on the CPU as saved."""
        self.wait()
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        last_err: Exception | None = None
        for s in candidates:
            try:
                tree, extra = load_tree(self._path(s))
                if like is not None:
                    tree = _like(tree, like)
                return tree, extra
            except (IOError, KeyError, IndexError, ValueError,
                    TypeError) as e:
                last_err = e
        raise FileNotFoundError(
            f"no valid checkpoint in {self.dir}: {last_err}")


def _like(tree, like):
    """``tree``'s leaves in ``like``'s structure, dtypes and devices; a
    missing key or another shape raises."""
    def one(want, got):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {tuple(got.shape)} where the "
                             f"state has {tuple(want.shape)}")
        return got.to(device=want.device, dtype=want.dtype)
    return tree_map(one, like, tree)


__all__ = ["CheckpointManager"]
