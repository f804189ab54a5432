"""PyTorch/CUDA port of the Q-GaLore serving path (``repro`` is the JAX
reference). Imports ``torch`` and numpy only, never ``jax`` or ``repro``.

Layout mirrors ``repro``: ``config``/``configs`` (model shapes),
``core.quant`` (block-wise INT8/INT4 quantizer), ``kernels`` (hand-written
CUDA kernels with their plain PyTorch versions), ``models`` (dense LLaMA
decoder) and ``serve`` (prefill/decode engine and slot scheduler).
"""
