"""Model-facing wrappers of the kernels: the counterpart of
``repro/kernels/ops.py``.

* :func:`quantized_dense` — ``x @ deq(W)`` with W consumed as INT8 codes.
  A plain ``QTensor`` weight (serving) has no weight gradient; a ``QVirtual``
  weight (training) is a ``torch.autograd.Function`` whose backward streams
  the same INT8 blocks for ``dL/dx`` (``int8_matmul_t``) and puts
  ``dL/dW = x^T g`` (float32, a library matmul, as the JAX package leaves
  it to XLA) on the shadow.
* :func:`fused_qgalore_update` — the fused optimizer step for one weight:
  pads its operands to the kernel's layout and crops the results.

On a CUDA tensor each op launches its kernel; on a CPU tensor it runs the
JAX package's CPU path: dequantize, then one float32 matmul
(``ref.deq_matmul``, ``ref.deq_matmul_t``), and the fused update's plain
version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor, QVirtual
from repro_torch.kernels import fused_update as _fused
from repro_torch.kernels import int8_matmul as _i8mm
from repro_torch.kernels import ref


def _check_weight(qt: QTensor) -> None:
    if not isinstance(qt, QTensor) or qt.bits != 8 or qt.zero is not None:
        raise TypeError("need a symmetric INT8 QTensor weight")
    if qt.ndim != 2:
        raise ValueError(f"need a 2-D weight, got {qt.shape}")


def _fwd(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x2 (M, K) @ deq(qt)[:, :orig] → (M, orig) float32."""
    if x2.device.type == "cpu":
        return ref.deq_matmul(x2, qt.q, qt.scale, qt.block, qt.orig_last)
    return _i8mm.int8_matmul(x2.contiguous(), qt.q, qt.scale,
                             qt.block)[:, : qt.orig_last]


def _dx(g2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """g2 (M, orig) @ deq(qt)[:, :orig]^T → (M, K) float32."""
    if g2.device.type == "cpu":
        return ref.deq_matmul_t(g2, qt.q, qt.scale, qt.block)
    pad = qt.q.shape[1] - g2.shape[1]
    if pad:     # padded weight columns dequantize to zero
        g2 = F.pad(g2, (0, pad))
    return _i8mm.int8_matmul_t(g2.contiguous(), qt.q, qt.scale, qt.block)


class _QDense(torch.autograd.Function):
    """``x2 @ deq(W)`` with ``dL/dW`` routed onto ``shadow``
    (``repro/kernels/ops.py`` ``_qdense_core``)."""

    @staticmethod
    def forward(ctx, x2, shadow, qt):
        ctx.save_for_backward(x2)
        ctx.qt = qt
        return _fwd(x2, qt)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        qt = ctx.qt
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx(g, qt).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2.to(torch.float32).T, g.to(torch.float32))
        return dx, dw, None


def quantized_dense(x: torch.Tensor, w, dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """``x (..., K) @ deq(W (K, N))`` with W consumed as INT8 codes: a
    float32 result cast to ``dtype`` (``repro/kernels/ops.py:323``). ``w``
    is a QTensor (no weight gradient; ``dL/dx`` still streams the INT8
    blocks) or a QVirtual (``dL/dW`` lands on its shadow)."""
    qt = w.qt if isinstance(w, QVirtual) else w
    _check_weight(qt)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if isinstance(w, QVirtual):
        out = _QDense.apply(x2, w.shadow, qt)
    elif torch.is_grad_enabled() and x.requires_grad:
        out = _QDense.apply(x2, None, qt)
    else:
        out = _fwd(x2, qt)
    return out.reshape(*lead, qt.orig_last).to(dtype)


def fused_qgalore_update(param: QTensor, low_g: torch.Tensor,
                         m32: torch.Tensor, v32: torch.Tensor, proj: QTensor,
                         count: int, lr: float, u01: torch.Tensor, *,
                         side: str, gscale: float, beta1: float = 0.9,
                         beta2: float = 0.999, eps: float = 1e-8,
                         weight_decay: float = 0.0):
    """One fused Q-GaLore step for a single 2-D weight
    (``repro/kernels/ops.py:487``).

    ``param``: symmetric INT8 QTensor ``(m, n)``; ``low_g``, ``m32``,
    ``v32``: ``(m, r)`` (right) or ``(r, n)`` (left) float32; ``proj``:
    INT4 QTensor ``(d, r)``; ``u01``: uniforms shaped like ``param.q``.
    Returns ``(new_param, m', v')`` with the moments in float32.
    """
    if not (isinstance(param, QTensor) and param.bits == 8
            and param.zero is None):
        raise TypeError("need a symmetric INT8 weight")
    if not (isinstance(proj, QTensor) and proj.bits == 4
            and proj.zero is not None):
        raise TypeError("need an INT4 projection")
    q2, ws = param.q, param.scale
    n_pad = q2.shape[-1]
    r_pad = proj.q.shape[-1] * 2
    r = low_g.shape[-1] if side == "right" else low_g.shape[-2]
    low, m_, v_ = (t.to(torch.float32) for t in (low_g, m32, v32))
    pq, ps, pz = proj.q, proj.scale, proj.zero
    if side == "right":
        # pad the rank to the packed rank; P rows span n (real) — pad them
        # to the padded n with zero scale and zero point, so the padded
        # update columns are exactly zero
        low, m_, v_ = (F.pad(t, (0, r_pad - r)) for t in (low, m_, v_))
        rows = n_pad - pq.shape[0]
        pq, ps, pz = (F.pad(t, (0, 0, 0, rows)) for t in (pq, ps, pz))
    else:
        # pad the rank (rows) and the columns up to the padded n
        cols = n_pad - low.shape[1]
        low, m_, v_ = (F.pad(t, (0, cols, 0, r_pad - r))
                       for t in (low, m_, v_))
    qn, sn, mn, vn = _fused.fused_qgalore_update(
        low.contiguous(), m_.contiguous(), v_.contiguous(), pq.contiguous(),
        ps.contiguous(), pz.contiguous(), q2, ws, u01, count, lr, side=side,
        pblock=proj.block, wblock=param.block, beta1=beta1, beta2=beta2,
        eps=eps, gscale=gscale, wd=weight_decay)
    if side == "right":
        mn, vn = mn[:, :r], vn[:, :r]
    else:
        mn, vn = mn[:r, : low_g.shape[1]], vn[:r, : low_g.shape[1]]
    new_param = QTensor(qn, sn, None, param.bits, param.block,
                        param.orig_last, param.dtype)
    return new_param, mn, vn
