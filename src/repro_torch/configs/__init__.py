"""Architecture registry of the PyTorch port.

A copy of the JAX package's registry restricted to the models the port
serves so far: the dense ``supersub-super``, ``supersub-sub`` and
``tinyllama-1.1b``, the sliding-window MoE ``mixtral-8x7b``, the
Mamba + MoE hybrid ``jamba-v0.1-52b`` and the mLSTM + sLSTM recurrent
``xlstm-125m``; every other architecture of the
JAX package raises ``KeyError(... not yet ported)``.  ``base.py`` is a
verbatim copy of the JAX package's stdlib-only config module: the port
imports nothing of ``repro``.
"""
from __future__ import annotations

import importlib
import math

from repro_torch.configs.base import (
    ArchConfig, FrontendConfig, MoEConfig, SSMConfig, XLSTMConfig, override,
)

_ARCH_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "tinyllama-1.1b": "tinyllama_11b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    # the paper's own application config (Super-Sub cascade members)
    "supersub-super": "supersub",
    "supersub-sub": "supersub",
}

# architectures of the JAX package the port does not serve yet
_NOT_PORTED = ("codeqwen1.5-7b", "starcoder2-7b",
               "deepseek-7b", "musicgen-medium", "qwen3-moe-235b-a22b",
               "pixtral-12b")


def get_arch(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.get(name) if hasattr(mod, "get") else mod.CONFIG


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def reduced(cfg: ArchConfig, **extra) -> ArchConfig:
    """A smoke-test-sized config of the same family (CPU-runnable); the
    JAX package's ``reduced`` cut: a hybrid keeps one whole period
    (``lcm(attn_every, moe.every)`` layers), xLSTM one ``slstm_every``
    period with chunks of 16, MoE drops to 4 experts of width 64 (top-2
    at most) and the SSM state to 8."""
    period = 1
    if cfg.xlstm is not None:
        period = cfg.xlstm.slstm_every
    elif cfg.family == "hybrid":
        period = math.lcm(cfg.attn_every, cfg.moe.every if cfg.moe else 1)
    kw = dict(
        num_layers=min(cfg.num_layers, max(2, period)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.moe is not None:
        kw["moe"] = override(cfg.moe, num_experts=4,
                             top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.ssm is not None:
        kw["ssm"] = override(cfg.ssm, d_state=8)
    if cfg.xlstm is not None:
        kw["xlstm"] = override(cfg.xlstm, chunk_size=16)
    kw.update(extra)
    return override(cfg, name=cfg.name + "-reduced", **kw)


__all__ = ["ArchConfig", "FrontendConfig", "MoEConfig", "SSMConfig",
           "XLSTMConfig", "get_arch", "list_archs", "override", "reduced"]
