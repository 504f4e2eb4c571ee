"""K-query verify attention over a row KV cache (chunked prefill)."""
