"""Mamba selective scan with a carried state."""
