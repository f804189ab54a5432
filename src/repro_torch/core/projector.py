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
them (but :func:`sharded_subspace`'s eigenvectors, as the reference's).
The tensor-parallel shard helpers place P and the low-rank state on a
weight's shards (the table below).
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


# ---------------------------------------------------------------------------
# Tensor-parallel shard helpers (``repro/core/projector.py:179-340``)
#
# A TP-sharded weight splits one of its two matrix dims over the model group
# (``shard_dim``: 0 = row m, 1 = col n). Where that shard lands on the
# GaLore state follows from the side:
#
#   side   shard_dim   P (d, r)             low-rank / moments
#   right  0 (m)       replicated           sharded on m  (local project)
#   right  1 (n)       sliced on d = n      replicated    (psum on low)
#   left   0 (m)       sliced on d = m      replicated    (psum on low)
#   left   1 (n)       replicated           sharded on n  (local project)
#
# ``quantize_projection`` blocks along the r axis only, so slicing P on its
# d axis commutes bit-exactly with INT4 quantization: a shard's codes and
# scales are row slices of the replicated quantization's.
# ---------------------------------------------------------------------------

def proj_dim_sharded(side: str, shard_dim: Optional[int]) -> bool:
    """True when a weight shard on matrix dim ``shard_dim`` lands on the
    projection dim d (the rows of P): the projected-away dim is n for
    "right" and m for "left". False: the shard lands on the low-rank
    moments' surviving dim, and P stays replicated."""
    if shard_dim is None:
        return False
    return (side == "right") == (shard_dim == 1)


def _slice_dim(x: torch.Tensor, axis: int, index: int, world: int
               ) -> torch.Tensor:
    size = x.shape[axis] // world
    return x.narrow(axis, index * size, size)


def shard_matrix(G: torch.Tensor, shard_dim: int, index: int,
                 world: int) -> torch.Tensor:
    """The TP rank-``index`` slice of a (batch..., m, n) weight or
    gradient (a view)."""
    return _slice_dim(G, G.ndim - 2 + shard_dim, index, world)


def shard_projection(P, side: str, shard_dim: Optional[int], index: int,
                     world: int):
    """Rank ``index``'s slice of a projection, consistent with the
    weight's shard dim: P whole where the shard lands on the surviving dim
    (``not proj_dim_sharded``); otherwise the d axis (dim -2 of P, codes
    and per-block scales and zeros alike) sliced, bit-exact against the
    replicated quantization because INT4 blocks run along r."""
    if not proj_dim_sharded(side, shard_dim):
        return P
    slice_d = lambda x: _slice_dim(x, x.ndim - 2, index, world)
    if isinstance(P, QTensor):
        return P.map(slice_d)
    return slice_d(P)


def reassemble_projection(shards, side: str, shard_dim: Optional[int]):
    """Inverse of :func:`shard_projection`: the ranks' slices concatenated
    on d (codes and scales). With a surviving-dim shard every entry is the
    whole P already."""
    if not proj_dim_sharded(side, shard_dim):
        return shards[0]
    cat = lambda xs: torch.cat(xs, dim=xs[0].ndim - 2)
    if isinstance(shards[0], QTensor):
        p0 = shards[0]
        return QTensor(cat([s.q for s in shards]),
                       cat([s.scale for s in shards]),
                       None if p0.zero is None
                       else cat([s.zero for s in shards]),
                       p0.bits, p0.block, p0.orig_last, p0.dtype)
    return cat(list(shards))


def project_sharded(G: torch.Tensor, P, side: str,
                    shard_dim: Optional[int], psum) -> torch.Tensor:
    """The low-rank projection from a rank's shards: the local product,
    and one ``psum`` of it only where the shard dim is the contracted
    (projected-away) one. ``psum``: any reducer over the model group
    (``Comm.all_reduce_sum``, or ``sum`` over a host-side list in tests).
    No full-rank tensor crosses the group."""
    low = project(G.to(torch.float32), maybe_dequantize(P), side)
    if proj_dim_sharded(side, shard_dim):
        return psum(low)
    return low


def explained_ratio_sharded(G: torch.Tensor, P, side: str,
                            shard_dim: Optional[int], psum) -> torch.Tensor:
    """:func:`explained_ratio` of the whole gradient from a rank's shards.
    A contracted-dim shard sums the low-rank product before squaring; a
    surviving-dim shard's per-direction energies are sums of squares over
    the sharded axis, so the partials sum directly. The Frobenius mass
    sums in both cases. What crosses the group is (r,)-sized, and the
    low-rank product in the contracted case."""
    Gf = G.to(torch.float32)
    low = project(Gf, maybe_dequantize(P), side)
    axis = -2 if side == "right" else -1
    total = psum((Gf * Gf).sum(dim=(-2, -1)))
    if proj_dim_sharded(side, shard_dim):
        low = psum(low)
        energies = (low * low).sum(dim=axis)
    else:
        energies = psum((low * low).sum(dim=axis))
    return torch.cumsum(energies, dim=-1) \
        / torch.clamp_min(total, 1e-30)[..., None]


def randomized_sharded(G_shard: torch.Tensor, rank: int, side: str,
                       shard_dim: int, omega: torch.Tensor, index: int,
                       psum, gather, iters: int = 2) -> torch.Tensor:
    """:func:`compute_subspace`'s randomized method for a weight sharded on
    the surviving dim (``not proj_dim_sharded``: P is replicated), from
    rank ``index``'s shard alone. The range ``A`` (``G`` left, ``G^T``
    right) is split on its columns, the dim the range finder contracts:
    each product with ``A`` is the rank's partial product summed over the
    group (``psum``, on ``(d, p)`` blocks), and the small ``B = Q^T A`` is
    gathered along its columns (``gather``) for the one SVD. ``omega``:
    the whole ``(..., k, p)`` test matrix; the rank takes its rows. The
    one-device method's operations, up to the order of each sum; no
    full-rank tensor crosses the group."""
    if proj_dim_sharded(side, shard_dim):
        raise ValueError("randomized_sharded takes a shard on the surviving "
                         "dim (P replicated)")
    A = (G_shard if side == "left" else G_shard.transpose(-1, -2)) \
        .to(torch.float32)                                # (d, k/t)
    k_loc = A.shape[-1]
    om = omega.to(torch.float32).narrow(-2, index * k_loc, k_loc)
    Y = psum(torch.matmul(A, om))
    for _ in range(iters):
        Y = torch.linalg.qr(Y)[0]
        Y = psum(torch.matmul(A, torch.matmul(A.transpose(-1, -2), Y)))
    Q = torch.linalg.qr(Y)[0]
    B = gather(torch.matmul(Q.transpose(-1, -2), A))      # (p, k)
    Ub = torch.linalg.svd(B, full_matrices=False)[0]
    return torch.matmul(Q, Ub)[..., :rank]


def _canonical_signs(W: torch.Tensor) -> torch.Tensor:
    """A deterministic sign per column: its largest-|entry| coordinate made
    positive (ties to the lowest index, as ``argmax``)."""
    pick = torch.gather(W, -2, W.abs().argmax(dim=-2, keepdim=True))
    return W * torch.where(pick >= 0, 1.0, -1.0)


def sharded_subspace(G_shard: torch.Tensor, rank: int, side: str,
                     shard_dim: int, psum, eps: float = 1e-12
                     ) -> torch.Tensor:
    """The exact top-``rank`` subspace of the whole gradient from a rank's
    shard, without gathering it: the Gram matrix over the unsharded matrix
    dim (one psum of a (d, d) block), its eigendecomposition (replicated:
    every rank gets the same factors from the same summed Gram), and this
    rank's piece of P:

    * surviving-dim shard: the Gram dim is the projection dim, and the
      top eigenvectors (signs canonicalised) are the whole P;
    * contracted-dim shard: the Gram dim is the surviving one, and the
      rank's slice of P is ``G_shard^T U_r / sigma_r`` (right) or
      ``G_shard V_r / sigma_r`` (left).

    Eigen and SVD numerics differ at float32 noise: compare subspaces
    (:func:`subspace_similarity`), not entries. The training step's
    distributed refresh re-tiles stacked leaves over their layers instead
    and runs the per-layer decomposition; this is the per-matrix
    alternative."""
    Gf = G_shard.to(torch.float32)
    sliced = proj_dim_sharded(side, shard_dim)
    if (side == "right") == (not sliced):
        C = psum(torch.einsum("...mn,...mk->...nk", Gf, Gf))   # G^T G
    else:
        C = psum(torch.einsum("...mn,...kn->...mk", Gf, Gf))   # G G^T
    lam, W = torch.linalg.eigh(C)                # ascending
    lam = lam.flip(-1)[..., :rank]
    W = _canonical_signs(W.flip(-1)[..., :rank])
    if not sliced:
        return W
    inv_sigma = torch.rsqrt(torch.clamp_min(lam, eps))
    if side == "right":
        return torch.einsum("...mn,...mr->...nr", Gf, W) \
            * inv_sigma[..., None, :]
    return torch.einsum("...mn,...nr->...mr", Gf, W) \
        * inv_sigma[..., None, :]


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
