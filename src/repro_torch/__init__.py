"""PyTorch/CUDA port of the context-switching serving stack.

The JAX package ``repro`` is the reference this package is held
against; this package imports ``torch`` and nothing of ``repro`` or
``jax``.  Entry points take ``device=``: left out, they run on ``cuda``
and raise when no card is visible (``repro_torch.core.env``).
"""
