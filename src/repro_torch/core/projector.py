"""Gradient-subspace computation and projection (GaLore core, paper
§3.2-3.3): the counterpart of ``repro/core/projector.py``.

For a gradient ``G (m, n)`` GaLore projects into a rank-``r`` subspace:

* ``m >= n`` → "right": ``P = V_r (n, r)``; low-rank ``G @ P`` is ``(m, r)``;
  back-projection ``L @ P^T``.
* ``m < n``  → "left":  ``P = U_r (m, r)``; low-rank ``P^T @ G`` is
  ``(r, n)``; back-projection ``P @ L``.

Two subspace methods, both library calls as in the JAX package (which
leaves them to XLA):

* ``svd``: an exact ``torch.linalg.svd``.
* ``randomized``: the Halko-style range finder with ``iters`` power
  iterations against a Gaussian ``omega (k, p)``, ``p = r + 8``: matmuls,
  QR, and one SVD of a small ``(p, k)`` matrix. ``omega`` is an input
  (the reference draws it from ``jax.random``, which torch cannot
  reproduce), as the stochastic rounding's uniforms are.

Singular vectors keep the solvers' column signs; nothing canonicalises
them.
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


OVERSAMPLE = 8       # the range finder's extra columns


def omega_shape(shape: Tuple[int, ...], rank: int,
                side: Optional[str] = None) -> Tuple[int, int]:
    """``(k, p)`` of the Gaussian test matrix the randomized method takes
    for a gradient of ``shape``: ``k`` is the contracted dimension of the
    range ``A`` (``G`` left, ``G^T`` right), ``p = min(r + 8, k)``."""
    side = side or galore_side(shape)
    m, n = shape[-2], shape[-1]
    k = n if side == "left" else m
    rank = min(rank, min(m, n))
    return k, min(rank + OVERSAMPLE, k)


def _topr_randomized(G: torch.Tensor, rank: int, side: str,
                     omega: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Randomized range finder for the top-r left/right singular subspace
    (the reference's ``_topr_randomized``, batched over leading dims)."""
    A = G if side == "left" else G.transpose(-1, -2)     # range(A): (d, k)
    Y = torch.matmul(A, omega)                            # (d, p)
    for _ in range(iters):
        Y = torch.linalg.qr(Y)[0]
        Y = torch.matmul(A, torch.matmul(A.transpose(-1, -2), Y))
    Q = torch.linalg.qr(Y)[0]                             # (d, p)
    # Rayleigh-Ritz: order the directions by singular value
    B = torch.matmul(Q.transpose(-1, -2), A)              # (p, k)
    Ub = torch.linalg.svd(B, full_matrices=False)[0]
    return torch.matmul(Q, Ub)[..., :rank]                # (d, r)


def compute_subspace(G: torch.Tensor, rank: int, side: Optional[str] = None,
                     method: str = "svd", omega: Optional[torch.Tensor] = None,
                     iters: int = 2) -> torch.Tensor:
    """Top-r subspace of ``G (..., m, n)`` → P ``(..., d, r)``; leading
    dims are a batch of independent problems. ``method="randomized"``
    needs ``omega (..., k, p)`` (:func:`omega_shape`), one per problem."""
    side = side or galore_side(G.shape)
    rank = min(rank, min(G.shape[-2], G.shape[-1]))
    Gf = G.to(torch.float32)
    if method == "randomized":
        want = omega_shape(G.shape, rank, side)
        if omega is None or tuple(omega.shape[-2:]) != want:
            raise ValueError(
                f"the randomized method needs omega of shape (..., "
                f"{want[0]}, {want[1]}), got "
                f"{None if omega is None else tuple(omega.shape)}")
        return _topr_randomized(Gf, rank, side, omega.to(torch.float32),
                                iters)
    if method != "svd":
        raise ValueError(f"unknown subspace method {method!r}; "
                         "'svd' or 'randomized'")
    U, _, Vh = torch.linalg.svd(Gf, full_matrices=False)
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


def explained_ratio(G: torch.Tensor, P: torch.Tensor, side: str
                    ) -> torch.Tensor:
    """Cumulative explained-variance profile of ``G`` under ``P``, shape
    ``(..., r)``: entry ``k`` is the energy of ``G`` in the first ``k + 1``
    columns of ``P`` over ``||G||_F^2`` (the rank-adaptation signal; for
    singular-value-ordered columns, the top-(k+1) share)."""
    Gf = G.to(torch.float32)
    low = project(Gf, P.to(torch.float32), side)
    axis = -2 if side == "right" else -1
    energies = (low * low).sum(dim=axis)                  # (..., r)
    total = (Gf * Gf).sum(dim=(-2, -1))
    return torch.cumsum(energies, dim=-1) \
        / torch.clamp_min(total, 1e-30)[..., None]


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
