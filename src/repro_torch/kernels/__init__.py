"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the model-facing wrappers (``ops``).

``LAUNCHES`` counts, per name, the calls that reached a kernel or a plain
version, so a run can show which one it went through. Kernels (counted by
their wrappers where they launch): ``"int8_matmul"``, ``"int8_matmul_t"``,
their expert-batched launches ``"int8_matmul_batched"`` and
``"int8_matmul_t_batched"`` (one a call, all experts),
``"fused_qgalore_update"``, ``"flash_attention"``, ``"sr_requant"``,
``"int4_matmul"``, ``"blockwise_quant"``. Plain versions: the same names
with ``"_ref"`` appended, and the CPU model path's ``"deq_matmul"``,
``"deq_matmul_t"`` and their batched ``"deq_matmul_batched"`` and
``"deq_matmul_t_batched"``.
"""
from collections import Counter

LAUNCHES: Counter = Counter()
