"""Model-facing wrappers of the kernels: the counterpart of
``repro/kernels/ops.py``.

* :func:`quantized_dense` — ``x @ deq(W)`` with W consumed as INT8 codes.
  A plain ``QTensor`` weight (serving) has no weight gradient; a ``QVirtual``
  weight (training) is a ``torch.autograd.Function`` whose backward streams
  the same INT8 blocks for ``dL/dx`` (``int8_matmul_t``, g in the
  activation dtype) and puts
  ``dL/dW = x^T g`` (float32, a library matmul, as the JAX package leaves
  it to XLA) on the shadow.
* :func:`quantized_dense_t` — ``x @ deq(W)^T`` over the same stored
  blocks (the tied-embedding head): its forward is ``int8_matmul_t``, its
  ``dL/dx`` ``int8_matmul``, and ``dL/dW = g^T x`` lands on the shadow.
* :func:`quantized_dense_batched` — ``x (E, C, K) @ deq(W (E, K, N))``,
  an MoE layer's expert stacks: one ``int8_matmul_batched`` launch
  forward, one ``int8_matmul_t_batched`` launch for ``dL/dx``, and
  ``dL/dW`` (float32, a library batched matmul) on the ``(E, K, N)``
  shadow.
* :func:`fused_qgalore_update` — the fused optimizer step for one weight:
  pads its operands to the kernel's layout and crops the results.
* :func:`flash_attention` — online-softmax attention with native GQA (the
  prefill route of ``models.attention.chunked_attention(flash=True)``).
* :func:`int4_project`, :func:`sr_requant_update`, :func:`quantize_int8` —
  the standalone kernels of the unfused update, chained by
  :func:`unfused_qgalore_update` in the per-leaf order the fused kernel
  replaced, and the one-pass INT8 quantizer.
* :func:`int8_matmul` — ``x @ deq(W)`` on a QTensor outside the model's
  layers (the reference's direct op).

On a CUDA tensor each op launches its kernel; on a CPU tensor it runs the
JAX package's CPU path: dequantize, then one float32 matmul
(``ref.deq_matmul``, ``ref.deq_matmul_t`` and their batched forms), and
the other kernels' plain versions. Inside ``profile.recording()`` each
call is counted under its op name (``kernels/profile.py``).
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
from repro_torch.kernels import profile, ref
from repro_torch.kernels import sr_requant as _sr


def _check_weight(qt: QTensor, ndim: int = 2) -> None:
    if not isinstance(qt, QTensor) or qt.bits != 8 or qt.zero is not None:
        raise TypeError("need a symmetric INT8 QTensor weight")
    if qt.ndim != ndim:
        raise ValueError(f"need a {ndim}-D weight, got {qt.shape}")


def _ran(kernel: str, t: torch.Tensor) -> str:
    """The ``LAUNCHES`` name of what a call on ``t`` runs: ``kernel`` on
    the card, its plain version on the CPU."""
    return kernel + ("_ref" if t.device.type == "cpu" else "")


def _record_i8(op: str, x2: torch.Tensor, qt: QTensor,
               transposed: bool) -> None:
    """Count one INT8 matmul call (``kernels/profile.py``). The 2-D sites
    take the reference's count (``repro/kernels/ops.py:191, 212``: the
    forward's roles in both directions); the expert-batched ones take
    ``profile.batched_cost``."""
    K, N = qt.q.shape[-2:]
    M, item = x2.shape[-2], x2.element_size()
    cpu = x2.device.type == "cpu"
    name = ("deq_" if cpu else "int8_") + "matmul" \
        + ("_t" if transposed else "")
    if x2.ndim == 3:
        E = x2.shape[0]
        flops, nbytes = profile.batched_cost(E, M, K, N, item, transposed,
                                             qt.block)
        profile.record(op.replace("quantized_dense", "quantized_dense_"
                                  "batched"), nbytes=nbytes, flops=flops,
                       kernel=name + "_batched",
                       meta={"shape": [E, M, K, N]})
        return
    flops, nbytes = profile.int8_matmul_cost(M, K, N, item, qt.block)
    profile.record(op, nbytes=nbytes, flops=flops, kernel=name,
                   meta={"shape": [M, K, N]})


def _fwd(x2: torch.Tensor, qt: QTensor, op: str = "quantized_dense/fwd"
         ) -> torch.Tensor:
    """x2 (M, K) @ deq(qt)[:, :orig] → (M, orig) float32; with an expert
    axis, x2 (E, M, K) against qt (E, K, N), all experts in one call.
    ``op``: the name a recording counts the call under."""
    batched = x2.ndim == 3
    if profile.enabled():
        _record_i8(op, x2, qt, transposed=False)
    if x2.device.type == "cpu":
        fn = ref.deq_matmul_batched if batched else ref.deq_matmul
        return fn(x2, qt.q, qt.scale, qt.block, qt.orig_last)
    fn = _i8mm.int8_matmul_batched if batched else _i8mm.int8_matmul
    return fn(x2.contiguous(), qt.q, qt.scale, qt.block)[..., : qt.orig_last]


def _dx(g2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """g2 (M, orig) @ deq(qt)[:, :orig]^T → (M, K) float32 (the forward of
    :func:`quantized_dense_t` too); with an expert axis as :func:`_fwd`."""
    batched = g2.ndim == 3
    if profile.enabled():
        _record_i8("quantized_dense/dx", g2, qt, transposed=True)
    if g2.device.type == "cpu":
        fn = ref.deq_matmul_t_batched if batched else ref.deq_matmul_t
        return fn(g2, qt.q, qt.scale, qt.block)
    pad = qt.q.shape[-1] - g2.shape[-1]
    if pad:     # padded weight columns dequantize to zero
        g2 = F.pad(g2, (0, pad))
    fn = _i8mm.int8_matmul_t_batched if batched else _i8mm.int8_matmul_t
    return fn(g2.contiguous(), qt.q, qt.scale, qt.block)


class _QDense(torch.autograd.Function):
    """``x2 @ deq(W)`` cast to ``dtype``, with ``dL/dW`` routed onto
    ``shadow`` (``repro/kernels/ops.py`` ``_qdense_core``). The cast sits
    inside the Function, so the backward receives g in the activation
    dtype: a bf16 g is one tensor-core pass of ``int8_matmul_t``, and
    half the bytes of the f32 gradient of an outside cast (the same
    values). With an expert axis (x2 (E, M, K), W (E, K, N)) each
    direction is one batched launch and ``dL/dW`` is per expert."""

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
            dw = torch.matmul(x2.to(torch.float32).transpose(-1, -2),
                              g.to(torch.float32))
        return dx, dw, None, None


class _QDenseT(torch.autograd.Function):
    """``x2 @ deq(W)^T`` cast to ``dtype``, the mirror of :class:`_QDense`
    (``repro/kernels/ops.py`` ``_qdense_t_core``): the forward streams the
    codes through ``int8_matmul_t``, ``dL/dx`` through ``int8_matmul``, and
    ``dL/dW = g^T x2`` (float32) lands on ``shadow``."""

    @staticmethod
    def forward(ctx, x2, shadow, qt, dtype):
        ctx.save_for_backward(x2)
        ctx.qt = qt
        return _dx(x2, qt).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        qt = ctx.qt
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _fwd(g, qt).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(g.to(torch.float32).T, x2.to(torch.float32))
        return dx, dw, None, None


def int8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x (..., K) @ deq(qt (K, N))`` → ``(..., orig_last)`` float32, the
    reference's direct op (``repro/kernels/ops.py:135``): no gradient, and
    counted as ``int8_matmul``, not as a model layer's
    ``quantized_dense/fwd``."""
    _check_weight(qt)
    lead, K = x.shape[:-1], x.shape[-1]
    return _fwd(x.reshape(-1, K), qt, "int8_matmul").reshape(
        *lead, qt.orig_last)


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


def quantized_dense_t(x: torch.Tensor, w, dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """``x (..., D) @ deq(W (V, D))^T`` → ``(..., V)`` in ``dtype``, the
    tied-embedding head (``repro/kernels/ops.py:347``): the contraction
    runs along the quant axis of the same stored blocks, x zero-padded to
    the codes' padded width. ``w`` is a QTensor or a QVirtual, as for
    :func:`quantized_dense`."""
    qt = w.qt if isinstance(w, QVirtual) else w
    _check_weight(qt)
    if x.shape[-1] != qt.orig_last:
        raise ValueError(f"x has D={x.shape[-1]}, the weight "
                         f"{tuple(qt.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QVirtual):
        out = _QDenseT.apply(x2, w.shadow, qt, dtype)
    elif torch.is_grad_enabled() and x.requires_grad:
        out = _QDenseT.apply(x2, None, qt, dtype)
    else:
        out = _dx(x2, qt).to(dtype)
    return out.reshape(*lead, qt.q.shape[0])


def quantized_dense_batched(x: torch.Tensor, w,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """``x (E, ..., K) @ deq(W (E, K, N))`` → ``(E, ..., N)`` in ``dtype``
    with W consumed as INT8 codes (``repro/kernels/ops.py:368``): the MoE
    expert stacks, all E experts in one kernel launch a direction. ``w`` is
    a 3-D QTensor (no weight gradient) or QVirtual (``dL/dW`` lands on its
    ``(E, K, N)`` shadow)."""
    qt = w.qt if isinstance(w, QVirtual) else w
    _check_weight(qt, 3)
    E, K = x.shape[0], x.shape[-1]
    if E != qt.q.shape[0]:
        raise ValueError(f"x has {E} experts, the weight {tuple(qt.shape)}")
    mid = x.shape[1:-1]
    x3 = x.reshape(E, -1, K)
    if isinstance(w, QVirtual):
        out = _QDense.apply(x3, w.shadow, qt, dtype)
    elif torch.is_grad_enabled() and x.requires_grad:
        out = _QDense.apply(x3, None, qt, dtype)
    else:
        out = _fwd(x3, qt).to(dtype)
    return out.reshape(E, *mid, qt.orig_last)


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
    if profile.enabled():
        # the reference's count (repro/kernels/ops.py:558): the triple
        # padded on the rank alone, P unpadded
        low_n = q2.shape[0] * r_pad if side == "right" \
            else r_pad * low_g.shape[1]
        profile.record(
            "fused_qgalore_update",
            nbytes=profile.fused_update_bytes(
                low_n, proj.q.numel(), proj.scale.numel(), q2.numel(),
                ws.numel(), q2.numel()),
            flops=4 * q2.shape[0] * n_pad * r_pad,
            kernel=_ran("fused_qgalore_update", q2),
            meta={"shape": [q2.shape[0], n_pad], "rank": r_pad})
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
    if profile.enabled():
        B, S, H, d = q.shape
        KH, dv = k.shape[2], v.shape[3]
        flops, nbytes = profile.flash_cost(B, S, H, KH, d, dv, causal,
                                           q.element_size())
        profile.record("flash_attention", nbytes=nbytes, flops=flops,
                       kernel=_ran("flash_attention", q),
                       meta={"shape": [B, S, H, KH, d, dv],
                             "causal": causal})
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
    if profile.enabled():
        flops, nbytes = profile.int4_matmul_cost(
            g2.shape[0], K, qt.q.shape[-1] * 2, qt.block, g.element_size(),
            qt.orig_last)
        profile.record("int4_project", nbytes=nbytes, flops=flops,
                       kernel=_ran("int4_matmul", g),
                       meta={"shape": [g2.shape[0], K, qt.orig_last]})
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
    if profile.enabled():
        profile.record("sr_requant_update",
                       nbytes=profile.sr_requant_bytes(q2.shape[0], C,
                                                       qt.block),
                       kernel=_ran("sr_requant", q2),
                       meta={"shape": [q2.shape[0], C]})
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
    if profile.enabled():
        profile.record("quantize_int8",
                       nbytes=profile.blockwise_quant_bytes(*x2.shape, block),
                       kernel=_ran("blockwise_quant", x2),
                       meta={"shape": list(x2.shape)})
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
