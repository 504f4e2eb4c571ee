"""Grouped (per-expert) matmul: the expert FFN of expert-parallel MoE."""
