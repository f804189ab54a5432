"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the model-facing wrappers (``ops``).

``LAUNCHES`` counts, per name, the calls that reached a kernel or a plain
version on the model path, so a run can show which one it went through:
``"int8_matmul"`` (the CUDA kernel, counted by its wrapper where it
launches), ``"int8_matmul_ref"`` and ``"deq_matmul"`` (plain versions).
"""
from collections import Counter

LAUNCHES: Counter = Counter()
