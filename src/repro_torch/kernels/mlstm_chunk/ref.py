"""Plain PyTorch version of the chunkwise-mLSTM kernel: the model's
chunkwise form, which the kernel computes, and its fully recurrent form,
the ground truth both are held to.

Layout: q/k/v (B, H, L, dh) f32; li/lf (B, H, L) f32 log gates; L a
multiple of ``chunk``.  Returns h (B, H, L, dh) and the final state (C
(B, H, dh, dh), n (B, H, dh), m (B, H)).
"""
from __future__ import annotations

from repro_torch.models.xlstm import (
    mlstm_chunkwise as mlstm_chunk_reference,
    mlstm_recurrent as mlstm_recurrent_reference)

__all__ = ["mlstm_chunk_reference", "mlstm_recurrent_reference"]
