"""The port's ``CheckpointManager`` (the JAX package's manager in the
port's file format, ``core.context.save_tree``): round trip with dtypes
kept (bf16 and int32 included), pruning to ``keep``, a corrupt or partial
newest file skipped for the previous step, a state of another structure
refused, and a resumed ``Trainer`` bit for bit an uninterrupted one, as
``tests/test_trainer.py::test_trainer_resume_exact`` holds JAX's.  The
checkpoint's extras (step, cursor) travel in the same file."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.data import SyntheticTokens  # noqa: E402
from repro_torch.core.context import tree_leaves  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "blocks": [{"b": torch.randn(5, generator=g).to(
                           torch.bfloat16)} for _ in range(2)]},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_keeps_dtypes_and_extras(tmp_path, async_save):
    cm = CheckpointManager(str(tmp_path), async_save=async_save)
    state = _tree()
    cm.save(7, state, extra={"cursor": 7})
    cm.wait()
    assert cm.latest_step() == 7
    got, extra = cm.restore()
    assert _equal(got, state)
    assert got["params"]["blocks"][1]["b"].dtype == torch.bfloat16
    assert extra == {"step": 7, "cursor": 7}
    like, _ = cm.restore(like=_tree(1))
    assert _equal(like, state)


def test_prune_keeps_the_newest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    cm.wait()
    assert cm.all_steps() == [3, 4]


@pytest.mark.parametrize("damage", ["flip", "truncate", "empty"])
def test_corrupt_newest_falls_back(tmp_path, damage):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, _tree(1))
    cm.save(2, _tree(2))
    path = os.path.join(str(tmp_path), "step_00000002.ckpt")
    raw = bytearray(open(path, "rb").read())
    if damage == "flip":              # a tensor's bytes: a digest mismatch
        w = _tree(2)["params"]["w"].numpy().tobytes()
        at = bytes(raw).index(w)
        raw[at + 5] ^= 0xFF
    elif damage == "truncate":        # a partial write
        raw = raw[:len(raw) // 3]
    else:
        raw = b""
    open(path, "wb").write(bytes(raw))
    got, extra = cm.restore()
    assert extra["step"] == 1 and _equal(got, _tree(1))
    # a leftover temporary file of a killed writer is never a checkpoint
    open(os.path.join(str(tmp_path), "step_00000003.ckpt.tmp"), "wb").write(
        b"partial")
    assert cm.latest_step() == 2
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        cm.restore(step=2)


def test_restore_refuses_another_structure(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, _tree())
    other = _tree()
    other["params"]["w"] = torch.zeros(3, 4)
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        cm.restore(like=other)
    del other["params"]["w"]
    other["params"]["v"] = torch.zeros(4, 3)
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        cm.restore(like=other)


def test_trainer_resume_exact(tmp_path):
    """Kill/restart: the resumed run is bit for bit the uninterrupted one
    (stateless data, the step in the checkpoint)."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    model = build_model(cfg, device="cpu")
    data = SyntheticTokens(cfg.vocab_size, 32, 4, seed=0, device="cpu")

    def run_cfg(d):
        return RunConfig(optimizer=OptimizerConfig(lr=1e-3, total_steps=100,
                                                   warmup_steps=5),
                         parallel=ParallelConfig(), checkpoint_dir=str(d),
                         checkpoint_every=3, log_every=1)

    tr = Trainer(model, run_cfg(tmp_path / "a"), data)
    whole = tr.train(tr.init_or_restore(0), 6)

    t1 = Trainer(model, run_cfg(tmp_path / "b"), data)
    t1.train(t1.init_or_restore(0), 3)
    t2 = Trainer(model, run_cfg(tmp_path / "b"), data)  # a new process
    s2 = t2.init_or_restore(0)
    assert t2.start_step == 3 and int(s2["step"]) == 3
    resumed = t2.train(s2, 3)
    assert _equal(whole, resumed)
    np.testing.assert_array_equal(
        [m["loss"] for m in tr.metrics_log[3:]],
        [m["loss"] for m in t2.metrics_log])
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3, 6]
