"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the model-facing wrappers (``ops``).

``LAUNCHES`` counts, per name, the calls that reached a kernel or a plain
version, so a run can show which one it went through. Kernels (counted by
their wrappers where they launch): ``"int8_matmul"``, ``"int8_matmul_t"``,
``"fused_qgalore_update"``, ``"flash_attention"``, ``"sr_requant"``,
``"int4_matmul"``, ``"blockwise_quant"``. Plain versions: the same names
with ``"_ref"`` appended, and the CPU model path's ``"deq_matmul"`` and
``"deq_matmul_t"``.
"""
from collections import Counter

LAUNCHES: Counter = Counter()
