"""Chunkwise mLSTM (xLSTM) with the final (C, n, m) state."""
