"""mixtral-8x7b — 8 experts top-2, sliding-window attn [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,                      # all FFNs are MoE (d_ff_expert below)
    vocab_size=32_000,
    sliding_window=4_096,        # SWA => bounded KV => long_500k runnable
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14_336, every=1),
    source="arXiv:2401.04088; hf",
)
