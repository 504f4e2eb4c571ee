"""Flash-attention kernel (causal prefill, optional sliding window)."""
