"""Mixture-of-experts FFN with sort-based capacity dispatch (the
counterpart of ``repro/models/moe.py``).

Token→expert routing is a stable sort by expert and a scatter into
per-expert buffers of fixed capacity ``C``, followed by the batched expert
FFN ``(E, C, d) × (E, d, f)``: three ``layers.dense_batched`` calls, each
one kernel launch for all E experts when the stacks are INT8. Tokens past
an expert's capacity fall into a garbage row and contribute zero.

The combine adds each token's kept contributions in float32, starting
from zero, in ascending expert order: the order in which the reference's
scatter-add over the stably sorted list reaches them. It uses no atomics,
so a run gives the same bits every time.

Top-k takes, among equal probabilities, the lower expert index first, as
``jax.lax.top_k`` does: it is a stable descending sort (``torch.topk``
promises no order among ties).

Expert parallelism (:func:`moe_apply_ep`, :func:`moe_ep_sharded`): each
of n ranks holds E/n experts' stacks; its tokens' send buffer ``(E, C,
d)`` goes out in one all-to-all to ``(E/n, n·C, d)``, the three batched
matmuls run on the local stacks (E/n on the kernels' expert grid axis),
and the reverse all-to-all brings the results back to the same combine.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.core.quant import QTensor, true_div
from repro_torch.distributed import tp as tp_lib
from repro_torch.models import layers
from repro_torch.models.layers import dense, dense_init

DROP_FREE_TK = 4096     # T·k up to which every token keeps its experts
# experts an expert stack is drawn at a time in a by-layer draw: 32 of
# deepseek-v3's (7168, 2048) matrices are 1.9 GB of float32
EXPERT_SLICE = 32


class ExpertSlices:
    """An expert stack of ``num`` experts not drawn yet: iterating draws
    it ``step`` experts at a time and yields ``(first expert, slice)``, so
    one slice is all of it that exists as float (``transformer.
    _draw_by_layer`` maps and writes each slice before the next)."""

    def __init__(self, draw, num: int, step: int):
        self.draw, self.num, self.step = draw, num, step

    def __iter__(self):
        for e0 in range(0, self.num, self.step):
            yield e0, self.draw(min(self.step, self.num - e0))


def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             num: Optional[int] = None, device="cpu",
             expert_slice: Optional[int] = None) -> dict:
    """Router (d, E), expert stacks (E, d, f), (E, d, f), (E, f, d) and
    the optional shared experts, in the reference's distributions; ``num``
    stacks a layer axis in front. ``expert_slice`` (one layer, ``num``
    None) leaves each expert stack undrawn, an :class:`ExpertSlices` of
    that many experts a draw."""
    mc: MoEConfig = cfg.moe
    d, f, E = cfg.d_model, mc.expert_ff, mc.num_experts
    lead = () if num is None else (num,)

    def expert_stack(din, dout):
        def draw(n_e):
            w = torch.empty(lead + (n_e, din, dout), dtype=torch.float32,
                            device=device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            return w.mul_(1.0 / math.sqrt(din))
        if expert_slice:
            return ExpertSlices(draw, E, expert_slice)
        return draw(E)

    p = {
        "router": dense_init(gen, d, E, scale=1.0 / math.sqrt(d), num=num,
                             device=device),
        "experts_wi": expert_stack(d, f),
        "experts_wg": expert_stack(d, f),
        "experts_wd": expert_stack(f, d),
    }
    if mc.num_shared_experts:
        p["shared"] = layers.ffn_init(gen, d, f * mc.num_shared_experts,
                                      num=num, device=device)
    return p


def _route(router_w, x: torch.Tensor, mc: MoEConfig):
    """Top-k routing: x (T, d) → (weights (T, k) in x's dtype, experts
    (T, k), the Switch load-balance loss)."""
    logits = dense(x, router_w, torch.float32)            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: descending, the lower index first among ties
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = top[:, : mc.top_k], idx[:, : mc.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    E = logits.shape[-1]
    density = F.one_hot(experts[:, 0], E).to(torch.float32).mean(0)
    aux = torch.sum(density * probs.mean(0)) * E * mc.router_aux_coef
    return weights.to(x.dtype), experts, aux


def capacity_for(T: int, mc: MoEConfig, capacity_factor: float = 1.25,
                 capacity: Optional[int] = None) -> int:
    """The per-expert buffer rows: ``capacity`` when given (decode passes
    ``B·S``, drop-free), all T tokens while ``T·k <= 4096``, else
    ``ceil(T·k/E · capacity_factor)`` (``repro/models/moe.py:83-88``)."""
    if capacity is not None:
        return capacity
    if T * mc.top_k <= DROP_FREE_TK:
        return T
    return max(1, int(math.ceil(T * mc.top_k / mc.num_experts
                                * capacity_factor)))


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: float = 1.25,
              capacity: Optional[int] = None,
              dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out (B, S, d), aux_loss 0-d float32). ``capacity``
    overrides the factor-derived buffer (:func:`capacity_for`)."""
    return _moe(p, x, cfg, capacity_factor, capacity, dtype, None)


def _experts(p: dict, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """The batched expert FFN on ``(E', C', d)`` buffers (INT8 stacks: one
    launch a matrix)."""
    h = F.silu(layers.dense_batched(expert_in, p["experts_wg"], dtype)) \
        * layers.dense_batched(expert_in, p["experts_wi"], dtype)
    return layers.dense_batched(h, p["experts_wd"], dtype)


def _moe(p: dict, x: torch.Tensor, cfg: ModelConfig, capacity_factor,
         capacity, dtype, comm):
    """The MoE layer; ``comm`` (a ``Comm``) makes it expert-parallel: the
    buffers of every expert are exchanged with their owners around the
    expert FFN."""
    mc: MoEConfig = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mc.num_experts, mc.top_k
    xt = x.reshape(T, d)
    dev = x.device

    weights, experts, aux = _route(p["router"], xt, mc)
    # capacity from this rank's own tokens (``repro/models/moe.py:158``)
    C = capacity_for(T, mc, capacity_factor, capacity)

    # ---- sort-based dispatch (stable: the kept set is the reference's) ----
    e_flat = experts.reshape(-1)                         # (T*k,) t-major
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    group_start = torch.searchsorted(
        e_sorted, torch.arange(E, dtype=e_sorted.dtype, device=dev),
        side="left")
    pos_in_group = torch.arange(T * k, device=dev) - group_start[e_sorted]
    keep = pos_in_group < C
    slot = torch.where(keep, e_sorted * C + pos_in_group,
                       torch.full_like(pos_in_group, E * C))  # garbage row

    # each (token, choice) row of x, in sorted order; the garbage row E·C
    # takes every dropped one and is cut off
    xk = xt[:, None].expand(T, k, d).reshape(T * k, d)[order].to(dtype)
    buf = torch.zeros((E * C + 1, d), dtype=dtype, device=dev)
    buf = buf.index_put((slot,), xk)
    expert_in = buf[: E * C].reshape(E, C, d)

    if comm is None:
        expert_out = _experts(p, expert_in, dtype)               # (E, C, d)
    else:
        # (E, C, d) → (n, E/n, C, d) → this rank's E/n experts, every
        # rank's C rows each: (E/n, n·C, d); and back after the FFN
        n = comm.world
        e_loc = E // n
        recv = tp_lib.all_to_all(expert_in.contiguous(), comm)
        recv = recv.reshape(n, e_loc, C, d).transpose(0, 1) \
            .reshape(e_loc, n * C, d)
        out_loc = _experts(p, recv, dtype)
        out_loc = out_loc.reshape(e_loc, n, C, d).transpose(0, 1) \
            .reshape(E, C, d)
        expert_out = tp_lib.all_to_all(out_loc.contiguous(), comm)

    # ---- combine: no atomics, each token's sum in ascending expert order --
    out_flat = expert_out.reshape(E * C, d)
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot                                # back to (t, j)
    slot_tk = slot_tk.reshape(T, k)
    by_expert = torch.argsort(experts, dim=-1)           # distinct experts
    slot_tk = torch.gather(slot_tk, 1, by_expert)
    w_tk = torch.gather(weights, 1, by_expert).to(torch.float32)
    kept = slot_tk < E * C
    rows = out_flat[torch.clamp_max(slot_tk, E * C - 1)]  # (T, k, d)
    contrib = torch.where(kept[..., None], rows, torch.zeros((), dtype=dtype,
                                                             device=dev))
    contrib = contrib.to(torch.float32) * w_tk[..., None]
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    out = y.to(dtype)

    if mc.num_shared_experts:
        out = out + layers.ffn_apply(p["shared"], xt, cfg.ffn_activation,
                                     dtype)
    return out.reshape(B, S, d), aux


def moe_apply_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, comm, *,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on one rank of ``comm`` (the reference's
    ``moe_apply_ep``): ``x`` this rank's tokens (B, S, d), ``p`` its
    router (whole), shared experts (whole) and expert stacks (its E/n
    experts, ``[rank·E/n, (rank+1)·E/n)``). Each rank routes its tokens
    against all E experts, sends each expert's buffer to its owner in one
    all-to-all, runs the FFN on its stacks, gets the results back in a
    second, and combines them as :func:`moe_apply` does. The capacity
    comes from this rank's tokens; the aux loss is this rank's. An expert
    stack's gradient then lies on its owner alone."""
    E = cfg.moe.num_experts
    if E % comm.world:
        raise ValueError(f"{E} experts do not split over {comm.world} ranks")
    return _moe(p, x, cfg, capacity_factor, None, dtype, comm)


def expert_slice(p: dict, rank: int, world: int) -> dict:
    """A rank's MoE leaves: its E/n experts of each stack (axis -3, after
    any layer axis), the router and shared experts whole."""
    def one(k, v):
        if not k.startswith("experts_"):
            return v
        cut = lambda t: t.narrow(t.ndim - 3, rank * (t.shape[-3] // world),
                                 t.shape[-3] // world)
        return v.map(cut) if isinstance(v, QTensor) else cut(v)
    return {k: one(k, v) for k, v in p.items()}


def moe_ep_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig, comm, *,
                   capacity_factor: float = 1.25, dtype=torch.bfloat16
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-level expert-parallel entry (the reference's
    ``moe_ep_sharded``): ``p`` the whole layer (every expert), ``x`` this
    rank's tokens; the rank keeps its experts' stacks
    (:func:`expert_slice`), runs :func:`moe_apply_ep`, and averages the
    aux loss over the ranks."""
    out, aux = moe_apply_ep(expert_slice(p, comm.rank, comm.world), x, cfg,
                            comm, capacity_factor=capacity_factor,
                            dtype=dtype)
    return out, true_div(tp_lib.reduce(aux, comm), comm.world)


def moe_ref(p: dict, x: torch.Tensor, cfg: ModelConfig,
            dtype=torch.float32) -> torch.Tensor:
    """Oracle: a dense per-token loop over each token's experts (no
    capacity drops, the weights dequantized), as the reference's
    ``moe_ref``; the choices are summed in top-k order."""
    mc: MoEConfig = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    weights, experts, _ = _route(p["router"], xt, mc)
    wi = layers.materialize(p["experts_wi"], dtype)
    wg = layers.materialize(p["experts_wg"], dtype)
    wd = layers.materialize(p["experts_wd"], dtype)
    xv = xt.to(dtype)
    ws = weights.to(dtype)
    out = 0
    for i in range(mc.top_k):
        e = experts[:, i]
        h = F.silu(torch.einsum("td,tdf->tf", xv, wg[e])) \
            * torch.einsum("td,tdf->tf", xv, wi[e])
        out = out + ws[:, i, None] * torch.einsum("tf,tfd->td", h, wd[e])
    if mc.num_shared_experts:
        out = out + layers.ffn_apply(p["shared"], xt, cfg.ffn_activation,
                                     dtype)
    return out.reshape(B, S, d)
