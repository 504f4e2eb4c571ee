"""Data sources of the port (the paper's Super-Sub task)."""
