"""Config system: architecture + shape + run configs.

Plain dataclasses (constructed from dicts/JSON via the stdlib-only
``from_dict`` below so launchers can override any field from the CLI).  One
``ArchConfig`` per assigned architecture lives in ``repro_torch/configs/<id>.py``;
the registry in ``repro_torch/configs/__init__.py`` resolves ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0          # per-expert FFN hidden size
    every: int = 1                # MoE layer every `every` layers (jamba: 2)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM block parameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4          # one sLSTM block per `slstm_every` blocks
    mlstm_expand: int = 2         # mLSTM inner expansion
    chunk_size: int = 256         # chunkwise-parallel chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB parameters (audio codec frames / vision patches).

    The frontend itself is not implemented (per assignment: ``input_specs()``
    provides precomputed frame/patch embeddings); this only sizes the stub
    inputs and the projection layer in the backbone.
    """
    kind: str = "none"            # none | audio_codec | vision_patches
    embed_dim: int = 0            # incoming precomputed-embedding dim
    num_positions: int = 0        # patches/frames prepended to the sequence


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention details
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 -> full attention
    attn_every: int = 1           # hybrid: attention layer every `attn_every`
                                  # layers (jamba: 8); others: 1
    # sub-family configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    mlp_gated: bool = True        # False -> 2-matrix GELU MLP (starcoder2)
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # citation per assignment
    source: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ---- derived quantities ------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attention_layer(self, i: int) -> bool:
        """Hybrid interleave: jamba puts attention at 1-of-`attn_every`."""
        if self.family != "hybrid":
            return True
        return i % self.attn_every == (self.attn_every // 2)

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every) == (self.moe.every - 1)

    def is_slstm_layer(self, i: int) -> bool:
        if self.xlstm is None:
            return False
        return i % self.xlstm.slstm_every == (self.xlstm.slstm_every - 1)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: recurrent state or bounded (sliding) KV."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    # ---- parameter counting (for roofline MODEL_FLOPS) ---------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; `active_only` counts top-k experts only."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for i in range(L):
            n += 2 * d                                # norms
            if self.family == "ssm" and self.xlstm is not None:
                n += self._xlstm_block_params(i)
                continue
            if self.is_attention_layer(i):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif self.ssm is not None:                # mamba block
                n += self._mamba_block_params()
            if self.is_moe_layer(i):
                m = self.moe
                experts = m.top_k if active_only else m.num_experts
                n += d * m.num_experts                # router (always live)
                n += experts * (3 * d * m.d_ff_expert)
            elif self.d_ff > 0:
                n += (3 if self.mlp_gated else 2) * d * self.d_ff
        return n

    def _mamba_block_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        dt_rank = s.dt_rank or -(-self.d_model // 16)
        n = self.d_model * 2 * d_in                  # in_proj (x, z)
        n += d_in * s.d_conv                          # conv
        n += d_in * (dt_rank + 2 * s.d_state)         # x -> dt, B, C
        n += dt_rank * d_in                           # dt proj
        n += d_in * s.d_state + d_in                  # A_log, D
        n += d_in * self.d_model                      # out proj
        return n

    def _xlstm_block_params(self, i: int) -> int:
        x = self.xlstm
        d = self.d_model
        if self.is_slstm_layer(i):
            # sLSTM: 4 gates (i,f,z,o) from input + recurrent, + gated FFN 4/3
            h = d
            n = 8 * d * h
            dff = int(4 * d * 2 / 3)
            n += 3 * d * dff
            return n
        d_in = x.mlstm_expand * d
        n = d * 2 * d_in                              # up proj (x, z)
        n += 3 * d_in * d_in // 1                     # q,k,v projections
        n += d_in * x.conv_width                      # causal conv
        n += 3 * d_in                                 # i,f,o gate biases/proj
        n += d_in * d                                 # down proj
        return n


# ---------------------------------------------------------------------------
# Input-shape cells (assignment-fixed)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(arch: "ArchConfig", shape: ShapeConfig) -> tuple[bool, str]:
    """Applicability of a (arch x shape) cell, per DESIGN.md skip rules."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, ("pure full-attention arch: 500k dense-KV decode skipped "
                       "(sub-quadratic attention required; see DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# Run config (training/serving hyperparams; not part of the arch identity)
# ---------------------------------------------------------------------------

@dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | linear | constant


@dataclass
class ParallelConfig:
    dp: int = 1                   # data axis
    tp: int = 1                   # model axis
    pods: int = 1                 # pod axis (pure DP over DCN)
    fsdp: bool = True             # shard params over the data axis
    seq_shard_kv: bool = False    # decode SP: shard KV seq over model axis
    grad_compression: str = "none"   # none | int8_ef
    microbatches: int = 1         # gradient accumulation
    remat: str = "none"           # none | full | dots
    cast_bf16: bool = False       # cast f32 master params to bf16 pre-gather


@dataclass
class RunConfig:
    arch: str = "tinyllama-1.1b"
    shape: str = "train_4k"
    seed: int = 0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    use_pallas: bool = False      # True on TPU; CPU paths use the jnp ref


def _unwrap_optional(tp):
    """Optional[X] -> (X, True); anything else -> (tp, False)."""
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _build(tp, value, path: str):
    """Recursively construct `tp` from plain dicts/lists (stdlib only).

    Strict: unknown dataclass keys raise, like dacite's strict mode did
    (typos in CLI/JSON overrides must not pass silently)."""
    tp, is_opt = _unwrap_optional(tp)
    if value is None:
        if is_opt:
            return None
        raise ValueError(f"{path}: None not allowed for {tp!r}")
    if dataclasses.is_dataclass(tp):
        if dataclasses.is_dataclass(value):        # already constructed
            return value
        if not isinstance(value, dict):
            raise TypeError(f"{path}: expected dict for {tp.__name__}, "
                            f"got {type(value).__name__}")
        hints = typing.get_type_hints(tp)
        names = {f.name for f in dataclasses.fields(tp) if f.init}
        unknown = set(value) - names
        if unknown:
            raise ValueError(
                f"{path}: unknown key(s) {sorted(unknown)} for {tp.__name__}")
        kwargs = {k: _build(hints[k], v, f"{path}.{k}")
                  for k, v in value.items()}
        return tp(**kwargs)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: expected a sequence for {tp!r}, "
                            f"got {type(value).__name__}")
        args = typing.get_args(tp) or (Any,)
        built = [_build(args[0], v, f"{path}[{i}]")
                 for i, v in enumerate(value)]
        return tuple(built) if origin is tuple else built
    if origin is dict:
        if not isinstance(value, dict):
            raise TypeError(f"{path}: expected a dict for {tp!r}, "
                            f"got {type(value).__name__}")
        _, vt = typing.get_args(tp) or (Any, Any)
        return {k: _build(vt, v, f"{path}[{k!r}]") for k, v in value.items()}
    if tp is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)                        # JSON has no int/float split
    if (origin is None and isinstance(tp, type) and tp is not Any
            and not isinstance(value, tp)):
        raise TypeError(f"{path}: expected {tp.__name__}, "
                        f"got {type(value).__name__}")
    return value


def from_dict(cls, d: dict[str, Any]):
    return _build(cls, d, cls.__name__)


def override(cfg, **kw):
    """Functional override for (frozen) dataclasses."""
    return dataclasses.replace(cfg, **kw)
