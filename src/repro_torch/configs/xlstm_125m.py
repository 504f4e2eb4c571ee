"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # no separate FFN: mLSTM blocks carry gating
    vocab_size=50_304,
    head_dim=768 // 4,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
