"""Model-facing wrappers of the kernels: the counterpart of
``repro/kernels/ops.py``.

* :func:`quantized_dense` — ``x @ deq(W)`` with W consumed as INT8 codes.
  A plain ``QTensor`` weight (serving) has no weight gradient; a ``QVirtual``
  weight (training) is a ``torch.autograd.Function`` whose backward streams
  the same INT8 blocks for ``dL/dx`` (``int8_matmul_t``, g in the
  activation dtype) and puts
  ``dL/dW = x^T g`` (float32, a library matmul, as the JAX package leaves
  it to XLA) on the shadow.
* :func:`fused_qgalore_update` — the fused optimizer step for one weight:
  pads its operands to the kernel's layout and crops the results.
* :func:`flash_attention` — online-softmax attention with native GQA (the
  prefill route of ``models.attention.chunked_attention(flash=True)``).
* :func:`int4_project`, :func:`sr_requant_update`, :func:`quantize_int8` —
  the standalone kernels of the unfused update, chained by
  :func:`unfused_qgalore_update` in the per-leaf order the fused kernel
  replaced, and the one-pass INT8 quantizer.

On a CUDA tensor each op launches its kernel; on a CPU tensor it runs the
JAX package's CPU path: dequantize, then one float32 matmul
(``ref.deq_matmul``, ``ref.deq_matmul_t``), and the other kernels' plain
versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import projector
from repro_torch.core.adam8bit import bias_correction
from repro_torch.core.quant import QTensor, QVirtual, dtype_name
from repro_torch.kernels import blockwise_quant as _bq
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_update as _fused
from repro_torch.kernels import int4_matmul as _i4mm
from repro_torch.kernels import int8_matmul as _i8mm
from repro_torch.kernels import ref
from repro_torch.kernels import sr_requant as _sr


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
    """``x2 @ deq(W)`` cast to ``dtype``, with ``dL/dW`` routed onto
    ``shadow`` (``repro/kernels/ops.py`` ``_qdense_core``). The cast sits
    inside the Function, so the backward receives g in the activation
    dtype: a bf16 g is one tensor-core pass of ``int8_matmul_t``, and
    half the bytes of the f32 gradient of an outside cast (the same
    values)."""

    @staticmethod
    def forward(ctx, x2, shadow, qt, dtype):
        ctx.save_for_backward(x2)
        ctx.qt = qt
        return _fwd(x2, qt).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        qt = ctx.qt
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dx(g, qt).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2.to(torch.float32).T, g.to(torch.float32))
        return dx, dw, None, None


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
        out = _QDense.apply(x2, w.shadow, qt, dtype)
    elif torch.is_grad_enabled() and x.requires_grad:
        out = _QDense.apply(x2, None, qt, dtype)
    else:
        out = _fwd(x2, qt).to(dtype)
    return out.reshape(*lead, qt.orig_last)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``q (B, S, H, d)``, ``k (B, S, KH, d)``, ``v (B, S, KH, dv)`` →
    ``(B, S, H, dv)`` in q's type (``repro/kernels/ops.py:472``). GQA is
    native: the kv heads are not repeated."""
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal)


def int4_project(g: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The GaLore projection ``g (..., K) @ deq_int4(qt (K, R))`` →
    ``(..., orig_last)`` float32 (``repro/kernels/ops.py:402``). The kernel
    masks ragged rows itself, so M is not padded; R is cropped to the
    projection's real rank."""
    if not (isinstance(qt, QTensor) and qt.bits == 4
            and qt.zero is not None):
        raise TypeError("need an INT4 QTensor projection")
    lead, K = g.shape[:-1], g.shape[-1]
    g2 = g.reshape(-1, K).contiguous()
    out = _i4mm.int4_matmul(g2, qt.q, qt.scale, qt.zero, qt.block)
    return out[:, : qt.orig_last].reshape(*lead, qt.orig_last)


def sr_requant_update(qt: QTensor, update: torch.Tensor,
                      u01: torch.Tensor) -> QTensor:
    """``W' = SR_quant(deq(W) + update)`` (``repro/kernels/ops.py:429``):
    the update's columns are zero-padded to the codes' padded width.
    ``u01``: uniforms shaped like ``qt.q`` (the reference draws them inside
    from a key; here the caller draws them)."""
    if not (isinstance(qt, QTensor) and qt.bits == 8 and qt.zero is None):
        raise TypeError("need a symmetric INT8 QTensor")
    C = qt.q.shape[-1]
    q2 = qt.q.reshape(-1, C)
    s2 = qt.scale.reshape(q2.shape[0], -1)
    upd = update.to(torch.float32).reshape(q2.shape[0], -1)
    if upd.shape[1] != C:
        upd = F.pad(upd, (0, C - upd.shape[1]))
    q_new, s_new = _sr.sr_requant(q2.contiguous(), s2.contiguous(),
                                  upd.contiguous(),
                                  u01.reshape(q2.shape).contiguous(),
                                  qt.block)
    return QTensor(q_new.reshape(qt.q.shape), s_new.reshape(qt.scale.shape),
                   None, qt.bits, qt.block, qt.orig_last, qt.dtype)


def quantize_int8(x: torch.Tensor, block: int = 256) -> QTensor:
    """Symmetric block-wise INT8 quantization along the last axis, zero-
    padded to a multiple of ``block`` (``repro/kernels/ops.py:454``)."""
    orig_last = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, orig_last)
    if orig_last % block:
        x2 = F.pad(x2, (0, -orig_last % block))
    q, s = _bq.blockwise_quant(x2.contiguous(), block)
    return QTensor(q.reshape(*x.shape[:-1], x2.shape[-1]),
                   s.reshape(*x.shape[:-1], x2.shape[-1] // block), None, 8,
                   block, orig_last, dtype_name(x.dtype))


def unfused_qgalore_update(param: QTensor, grad: torch.Tensor,
                           m32: torch.Tensor, v32: torch.Tensor,
                           proj: QTensor, count: int, lr: float,
                           u01: torch.Tensor, *, gscale: float,
                           beta1: float = 0.9, beta2: float = 0.999,
                           eps: float = 1e-8):
    """One Q-GaLore step for a right-side weight (m >= n) through the
    standalone kernels, in the per-leaf order the fused kernel replaced
    (the unfused baseline of ``benchmarks/kernels_bench.py``):
    ``int4_project`` → f32 Adam → back-projection onto the dequantized P
    (a library matmul) → ``sr_requant_update``.

    ``param``: INT8 QTensor ``(m, n)``; ``grad``: full-rank ``(m, n)``;
    ``m32``, ``v32``: ``(m, r)`` float32; ``proj``: INT4 QTensor ``(n, r)``;
    ``u01``: uniforms shaped like ``param.q``. Returns
    ``(new_param, m', v')``.
    """
    if grad.shape[-2] < grad.shape[-1]:
        raise ValueError(f"the unfused chain covers right-side weights "
                         f"(m >= n), got {tuple(grad.shape)}")
    low = int4_project(grad, proj)
    m_new = beta1 * m32 + (1 - beta1) * low
    v_new = beta2 * v32 + (1 - beta2) * low * low
    dirn = (m_new / bias_correction(beta1, count)) \
        / (torch.sqrt(v_new / bias_correction(beta2, count)) + eps)
    upd = gscale * projector.project_back(
        dirn, projector.maybe_dequantize(proj), "right")
    return sr_requant_update(param, -lr * upd, u01), m_new, v_new
