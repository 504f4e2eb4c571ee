"""One-token flash-decode over a row KV cache."""
