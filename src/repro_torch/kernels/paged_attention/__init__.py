"""One-token flash-decode through a page table over a shared pool."""
