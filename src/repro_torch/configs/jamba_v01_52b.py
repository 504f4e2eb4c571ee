"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887; hf].

Jamba period-8 block: attention at 1 of 8 layers (the rest Mamba);
MoE MLP every other layer (period 2).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,                 # dense-MLP layers (non-MoE positions)
    vocab_size=65_536,
    attn_every=8,                # 1 attention layer per 8 (1:7 with mamba)
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14_336, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887; hf",
)
