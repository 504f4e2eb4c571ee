"""The paper's own application configs: Super-Sub cascade members (Fig 6a).

Small decoder/classifier-sized transformers: a generalist "super" network and
per-superclass "sub" specialists; sized to train on CPU in the examples while
exercising the full framework stack.
"""
from repro_torch.configs.base import ArchConfig

_SUPER = ArchConfig(
    name="supersub-super",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=1_024,
    vocab_size=512,
    tie_embeddings=True,
    source="paper Fig 6(a) generalist",
)

_SUB = ArchConfig(
    name="supersub-sub",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=1_024,
    vocab_size=512,
    tie_embeddings=True,
    source="paper Fig 6(a) specialist",
)


def get(name: str) -> ArchConfig:
    return _SUPER if name.endswith("super") else _SUB
