"""Gradient-subspace computation and projection (GaLore core, paper
§3.2-3.3): the counterpart of ``repro/core/projector.py``.

For a gradient ``G (m, n)`` GaLore projects into a rank-``r`` subspace:

* ``m >= n`` → "right": ``P = V_r (n, r)``; low-rank ``G @ P`` is ``(m, r)``;
  back-projection ``L @ P^T``.
* ``m < n``  → "left":  ``P = U_r (m, r)``; low-rank ``P^T @ G`` is
  ``(r, n)``; back-projection ``P @ L``.

The subspace comes from an exact SVD (``torch.linalg.svd``, a library call
as in the JAX package, which leaves it to XLA). Singular vectors keep the
solver's column signs; nothing canonicalises them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.quant import QTensor


def galore_side(shape: Tuple[int, ...]) -> str:
    """'right' when m >= n else 'left' (GaLore convention)."""
    m, n = shape[-2], shape[-1]
    return "right" if m >= n else "left"


def proj_dim(shape: Tuple[int, ...]) -> int:
    """The dimension the projection matrix lives on (rows of P)."""
    m, n = shape[-2], shape[-1]
    return n if m >= n else m


def lowrank_shape(shape: Tuple[int, ...], rank: int) -> Tuple[int, ...]:
    m, n = shape[-2], shape[-1]
    lead = tuple(shape[:-2])
    if m >= n:
        return lead + (m, rank)
    return lead + (rank, n)


def random_orthonormal(gen: torch.Generator, d: int, r: int, batch: int = 0,
                       device="cpu") -> torch.Tensor:
    """Random orthonormal frame(s) ``(batch?, d, r)``: the cold-start
    projection (the controller forces a real refresh at step 0)."""
    b = max(batch, 1)
    g = torch.randn((b, d, r), generator=gen, dtype=torch.float32,
                    device=device)
    q = torch.linalg.qr(g)[0]
    return q if batch else q[0]


def compute_subspace(G: torch.Tensor, rank: int, side: Optional[str] = None,
                     method: str = "svd") -> torch.Tensor:
    """Top-r subspace of ``G (..., m, n)`` → P ``(..., d, r)``; leading
    dims are a batch of independent problems."""
    if method != "svd":
        raise NotImplementedError(
            f"subspace_method={method!r} is not ported; only 'svd' is")
    side = side or galore_side(G.shape)
    rank = min(rank, min(G.shape[-2], G.shape[-1]))
    U, _, Vh = torch.linalg.svd(G.to(torch.float32), full_matrices=False)
    if side == "right":
        return Vh[..., :rank, :].transpose(-1, -2)
    return U[..., :rank]


def project(G: torch.Tensor, P: torch.Tensor, side: str) -> torch.Tensor:
    """Full-rank grad → low-rank. Batched over leading dims of both."""
    if side == "right":
        return torch.matmul(G, P)
    return torch.matmul(P.transpose(-1, -2), G)


def project_back(L: torch.Tensor, P: torch.Tensor, side: str) -> torch.Tensor:
    """Low-rank update → full-rank."""
    if side == "right":
        return torch.matmul(L, P.transpose(-1, -2))
    return torch.matmul(P, L)


def subspace_similarity(P_old: torch.Tensor, P_new: torch.Tensor
                        ) -> torch.Tensor:
    """``||P_old^T P_new||_F^2 / r`` in [0, 1]; 1 for identical subspaces
    (rotation- and sign-invariant). Batched over leading dims."""
    M = torch.matmul(P_old.to(torch.float32).transpose(-1, -2),
                     P_new.to(torch.float32))
    return (M * M).sum(dim=(-2, -1)) / P_new.shape[-1]


def quantize_projection(P: torch.Tensor, bits: int, block: int) -> QTensor:
    """Quantize P (d, r) along the r axis, asymmetric (block <= r, even)."""
    eff_block = min(block, max(2, P.shape[-1]))
    if eff_block % 2:
        eff_block += 1
    return quant.quantize_blockwise(P, bits=bits, block=eff_block,
                                    symmetric=False)


def maybe_dequantize(P, dtype=torch.float32) -> torch.Tensor:
    if isinstance(P, QTensor):
        return quant.dequantize(P, dtype)
    return P.to(dtype)
